"""Checkpoint files of the port (evo_tpu_torch/checkpoint.py) against the
JAX package, on the CPU at the tiny config.

Snapshots cross in both directions through files: the JAX package's writer
-> the port's reader, the port's writer -> the JAX package's reader (the
`safetensors` package). Tensors must be bit-equal; scores through
`Evo(checkpoint_path=)` agree within rtol 1e-5 (float32, the bound of
tests/test_golden.py).
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from evo_tpu import checkpoint as jax_ckpt
from evo_tpu import model as jax_model
from evo_tpu.config import tiny_config as jax_tiny_config
from evo_tpu.models import Evo as JaxEvo
from evo_tpu.scoring import score_sequences as jax_score_sequences
from evo_tpu_torch import checkpoint as ckpt
from evo_tpu_torch import model as model_lib
from evo_tpu_torch import models
from evo_tpu_torch.config import cli_tiny_overrides, tiny_config
from evo_tpu_torch.models import Evo
from evo_tpu_torch.scoring import score_sequences

torch.set_num_threads(2)
SEQS = ['ACGTTGCAAC', 'ACG', 'TTGACCAGTAGGCA']


def _bits(a):
    """A numpy array or torch tensor as numpy, bf16 as its int16 bits."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16) if a.dtype == torch.bfloat16
                else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == 'bfloat16' else a


def _jax_params(dtype='float32', seed=0, **overrides):
    jcfg = jax_tiny_config(param_dtype=dtype, compute_dtype=dtype,
                           **overrides)
    return jax_model.init_params(jax.random.PRNGKey(seed), jcfg), jcfg


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('num_shards', [1, 3])
def test_port_reads_jax_snapshots(tmp_path, dtype, num_shards):
    params, jcfg = _jax_params(dtype)
    jax_ckpt.write_reference_snapshot(params, jcfg, str(tmp_path),
                                      num_shards=num_shards)
    names = sorted(os.listdir(tmp_path))
    assert ('model.safetensors.index.json' in names) == (num_shards > 1)
    want = jax_ckpt.export_state_dict(params, jcfg)
    raw = ckpt.read_safetensors_state_dict(str(tmp_path))
    assert all(k.startswith('backbone.') for k in raw)
    got = ckpt.strip_backbone_prefix(raw)
    assert set(got) == set(want)
    for k, t in got.items():
        assert tuple(t.shape) == np.shape(want[k]), k
        np.testing.assert_array_equal(_bits(t), _bits(want[k]), err_msg=k)
    # the rotary buffers are in the file and are ignored, not loaded
    cfg = tiny_config(param_dtype=dtype, compute_dtype=dtype)
    report = ckpt.validate_state_dict(got, cfg)
    assert report['ok'] and len(report['ignored_buffers']) == 1
    model = ckpt.load_reference_checkpoint(str(tmp_path), cfg, 'cpu')
    back = ckpt.state_dict(model)
    assert set(back) == set(want) - set(report['ignored_buffers'])
    for k, t in back.items():
        np.testing.assert_array_equal(_bits(t), _bits(want[k]), err_msg=k)
    if num_shards == 1:      # a single file is also a valid path
        one = ckpt.read_safetensors_state_dict(
            str(tmp_path / 'model.safetensors'))
        assert set(one) == set(raw)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('num_shards', [1, 4])
def test_jax_reads_port_snapshots(tmp_path, dtype, num_shards):
    cfg = tiny_config(param_dtype=dtype, compute_dtype=dtype)
    model = model_lib.random_init(cfg, torch.Generator().manual_seed(3),
                                  'cpu')
    ckpt.write_reference_snapshot(model, str(tmp_path),
                                  num_shards=num_shards)
    want = ckpt.state_dict(model)
    got = jax_ckpt.strip_backbone_prefix(
        jax_ckpt.read_safetensors_state_dict(str(tmp_path)))
    assert set(got) == set(want)
    for k, a in got.items():
        np.testing.assert_array_equal(_bits(a), _bits(want[k]), err_msg=k)
    if num_shards > 1:
        with open(tmp_path / 'model.safetensors.index.json') as f:
            index = json.load(f)
        assert set(index['weight_map']) == {'backbone.' + k for k in want}
        assert index['metadata']['total_size'] == sum(
            t.numel() * t.element_size() for t in want.values())
    # and the JAX package converts it to its own tree without complaint
    jcfg = jax_tiny_config(param_dtype=dtype, compute_dtype=dtype)
    params = jax_ckpt.convert_state_dict(got, jcfg)
    assert jax_model.param_count(params) == model_lib.param_count(model)


def test_safetensors_types_and_bare_directory(tmp_path):
    """Every type the format names here crosses bit-equal with the
    `safetensors` package, in both directions; a directory of loose
    .safetensors files is read whole; broken files raise."""
    from safetensors.numpy import load_file, save_file
    rng = np.random.default_rng(0)
    arrays = {
        'f32': rng.standard_normal((3, 5)).astype(np.float32),
        'f16': rng.standard_normal((7,)).astype(np.float16),
        'i8': rng.integers(-128, 128, (4, 2, 3)).astype(np.int8),
        'i32': rng.integers(-9, 9, (6,)).astype(np.int32),
        'i64': rng.integers(-9, 9, (2, 2)).astype(np.int64),
        'scalar': np.array(2.5, np.float32),
        'empty': np.zeros((0, 4), np.float32),
    }
    theirs, ours = tmp_path / 'theirs', tmp_path / 'ours'
    theirs.mkdir()
    ours.mkdir()
    save_file(arrays, str(theirs / 'a.safetensors'))
    save_file({'other': arrays['f32'] * 2}, str(theirs / 'b.safetensors'))
    got = ckpt.read_safetensors_state_dict(str(theirs))    # bare directory
    assert set(got) == set(arrays) | {'other'}
    for k, a in arrays.items():
        assert got[k].shape == a.shape
        np.testing.assert_array_equal(got[k].numpy(), a, err_msg=k)
    tensors = {k: torch.from_numpy(np.array(a)) for k, a in arrays.items()}
    tensors['bf16'] = torch.from_numpy(arrays['f32']).bfloat16()
    tensors['strided'] = torch.from_numpy(arrays['f32']).T   # not contiguous
    ckpt._write_safetensors_file(tensors, str(ours / 'model.safetensors'))
    back = load_file(str(ours / 'model.safetensors'))
    for k, t in tensors.items():
        np.testing.assert_array_equal(_bits(back[k]), _bits(t.contiguous()),
                                      err_msg=k)
    with pytest.raises(FileNotFoundError, match='model.safetensors'):
        ckpt.read_safetensors_state_dict(str(tmp_path))
    bad = tmp_path / 'bad.safetensors'
    bad.write_bytes(b'\xff' * 8 + b'{}')
    with pytest.raises(ValueError, match='header length'):
        ckpt.read_safetensors_state_dict(str(bad))
    (tmp_path / 'orbax').mkdir()
    (tmp_path / 'orbax' / 'evo_tpu_checkpoint.json').write_text('{}')
    with pytest.raises(FileNotFoundError, match='orbax'):
        ckpt.read_safetensors_state_dict(str(tmp_path / 'orbax'))


def test_validation_and_inference_reports_equal_jax(tmp_path):
    """A snapshot whose inner width, depth and attention placement differ
    from the registry config: both packages infer the same overrides and
    give the same validation report, before and after adapting."""
    params, jcfg = _jax_params(num_layers=5, attn_layer_idxs=(2, 4),
                               hyena_layer_idxs=(0, 1, 3), inner_mlp_size=96,
                               state_size=2)
    jax_ckpt.write_reference_snapshot(params, jcfg, str(tmp_path),
                                      num_shards=2)
    jsd = jax_ckpt.strip_backbone_prefix(
        jax_ckpt.read_safetensors_state_dict(str(tmp_path)))
    sd = ckpt.strip_backbone_prefix(
        ckpt.read_safetensors_state_dict(str(tmp_path)))
    ovr = ckpt.infer_config_overrides(sd, tiny_config())
    assert ovr == jax_ckpt.infer_config_overrides(jsd, jax_tiny_config())
    assert ovr == {'num_layers': 5, 'attn_layer_idxs': (2, 4),
                   'hyena_layer_idxs': (0, 1, 3), 'inner_mlp_size': 96,
                   'state_size': 2}
    for cfg, jc in ((tiny_config(), jax_tiny_config()),
                    (tiny_config().replace(**ovr), jcfg)):
        report = ckpt.validate_state_dict(sd, cfg)
        jreport = jax_ckpt.validate_state_dict(jsd, jc)
        # the notes on the reconstructed layouts are worded by each package
        assert set(report.pop('reconstructed_layouts')) == set(
            jreport.pop('reconstructed_layouts'))
        assert report == jreport
        assert ckpt.expected_state_dict_spec(cfg) == \
            jax_ckpt.expected_state_dict_spec(jc)
        text = ckpt.format_validation_report(report)
        assert text.splitlines()[0] == \
            jax_ckpt.format_validation_report(report).splitlines()[0]
        assert ('FAILED' in text) == (not report['ok'])
    assert report['ok']
    with pytest.raises(ValueError, match='hidden_size'):
        ckpt.infer_config_overrides(sd, tiny_config(hidden_size=128,
                                                    num_filters=128))
    # both squeezed layouts are tolerated, by the validator and the loader
    squeezed = dict(sd)
    for k in sd:
        if k.endswith(('filter.poles', 'filter.residues')):
            squeezed[k] = sd[k][:, :, 0]
        if k.endswith('short_filter_weight'):
            squeezed[k] = sd[k][:, 0]
    cfg = tiny_config().replace(**ovr)
    assert ckpt.validate_state_dict(squeezed, cfg)['ok']
    a = ckpt.state_dict(ckpt.params_from_state_dict(squeezed, cfg, 'cpu'))
    b = ckpt.state_dict(ckpt.params_from_state_dict(dict(sd), cfg, 'cpu'))
    assert all(torch.equal(a[k], b[k]) for k in b)
    # the adaptive loader applies the overrides and refuses a bad schema
    model, adapted = ckpt.load_reference_checkpoint_adaptive(
        str(tmp_path), tiny_config(), 'cpu', verbose=False)
    assert adapted == cfg and len(model.blocks) == 5
    broken = dict(sd)
    del broken['norm.scale']
    broken['blocks.0.mlp.l9.weight'] = sd['norm.scale']
    ckpt._write_safetensors_file(broken, str(tmp_path / 'x.safetensors'))
    with pytest.raises(ValueError, match='missing: norm.scale'):
        ckpt.load_reference_checkpoint_adaptive(
            str(tmp_path / 'x.safetensors'), cfg, 'cpu')


def _mislaid(sd, cfg, which):
    """The state dict that, read under the right layout, gives what the
    right state dict gives under the named wrong one (the variants of
    `evo_tpu.checkpoint.convert_state_dict(debug_mislayout=)`)."""
    D, H, Dh = cfg.hidden_size, cfg.num_attention_heads, cfg.head_dim
    out = dict(sd)
    for k, t in sd.items():
        if which == 'hyena_stream_order' and k.endswith(
                ('projections.weight', 'projections.bias',
                 'short_filter_weight', 'short_filter_bias')):
            out[k] = t.reshape(3, D, *t.shape[1:])[[1, 0, 2]].reshape(t.shape)
        if which == 'qkv_interleave' and k.endswith('Wqkv.weight'):
            out[k] = (t.T.reshape(D, H, 3, Dh).permute(0, 2, 1, 3)
                      .reshape(D, 3 * D).T.contiguous())
        if which == 'poles_layout' and k.endswith(('poles', 'residues')):
            out[k] = t.flip(-1)
    return out


@pytest.mark.parametrize('which', sorted(ckpt.RECONSTRUCTED_LAYOUTS))
def test_fingerprint_flags_each_wrong_layout(which):
    """Every wrong layout passes the shape validator and must not pass the
    fingerprint: same norms, another `proj`."""
    params, jcfg = _jax_params()
    cfg = tiny_config()
    sd = {k: torch.from_numpy(np.array(v)) for k, v in
          jax_ckpt.export_state_dict(params, jcfg,
                                     include_buffers=False).items()}
    wrong_sd = _mislaid(sd, cfg, which)
    assert ckpt.validate_state_dict(wrong_sd, cfg)['ok']
    want = ckpt.fingerprint_params(ckpt.params_from_state_dict(
        dict(sd), cfg, 'cpu'))
    again = ckpt.fingerprint_params(ckpt.params_from_state_dict(
        dict(sd), cfg, 'cpu'))
    assert ckpt.compare_fingerprints(again, want) == []
    got = ckpt.fingerprint_params(ckpt.params_from_state_dict(
        wrong_sd, cfg, 'cpu'))
    problems = ckpt.compare_fingerprints(got, want)
    assert problems and all('LAYOUT error' in p for p in problems), problems
    assert not any(k.startswith('embedding') for k in problems)
    # the stats are those of the JAX package on the same leaf
    jfp = jax_ckpt.fingerprint_params({'embedding': params['embedding']})
    for stat in ('l2', 'mean', 'proj'):
        np.testing.assert_allclose(want['embedding'][stat],
                                   jfp["['embedding']"][stat], rtol=1e-9)
    assert want['embedding']['shape'] == jfp["['embedding']"]['shape']
    assert want['embedding']['dtype'] == jfp["['embedding']"]['dtype']
    short = dict(want)
    del short['embedding']
    assert ckpt.compare_fingerprints(short, want) == [
        'embedding: missing from converted tree']


def test_native_save_load_and_reconcile(tmp_path):
    adapted = tiny_config(inner_mlp_size=96, num_layers=3,
                          attn_layer_idxs=(0,), hyena_layer_idxs=(1, 2))
    model = model_lib.random_init(adapted, torch.Generator().manual_seed(5),
                                  'cpu')
    path = str(tmp_path / 'native')
    assert not ckpt.is_native_checkpoint(path)
    ckpt.save_native(model, path, adapted, num_shards=2)
    assert ckpt.is_native_checkpoint(path)
    assert ckpt.native_config(path) == adapted
    # the saved architecture wins, the caller's runtime fields stay
    asked = tiny_config(kv_quant='int8', weight_quant='int8')
    cfg = ckpt.reconcile_native_config(path, asked)
    assert cfg == adapted.replace(kv_quant='int8', weight_quant='int8')
    assert ckpt.reconcile_native_config(str(tmp_path), asked) is asked
    loaded = ckpt.load_params_auto(path, cfg, 'cpu')
    a, b = ckpt.state_dict(model), ckpt.state_dict(loaded)
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    # native files carry no backbone prefix; a marker without a config
    # leaves the caller's config alone
    assert 'norm.scale' in ckpt.read_safetensors_state_dict(path)
    ckpt.save_native(model, str(tmp_path / 'bare'))
    assert ckpt.native_config(str(tmp_path / 'bare')) is None
    assert set(ckpt._ARCH_FIELDS) == set(jax_ckpt._ARCH_FIELDS)
    # through the front door: the registry config is reconciled, then the
    # weights are quantized after the load
    evo = Evo('evo-1-8k-base', 'cpu', checkpoint_path=path,
              config_overrides=dict(cli_tiny_overrides(),
                                    weight_quant='int4'))
    assert evo.config.inner_mlp_size == 96 and evo.config.num_layers == 3
    assert evo.model.module.blocks[0].attn.wo.mode == 'int4'


def test_evo_from_a_jax_snapshot_scores_as_jax_evo(tmp_path):
    """`Evo(checkpoint_path=<snapshot written by the JAX package>)`: the
    same scores from both packages (rtol 1e-5), with the inner width
    taken from the snapshot and not from the registry config."""
    ov = dict(cli_tiny_overrides())
    params, jcfg = _jax_params(seed=7, inner_mlp_size=80)
    jax_ckpt.write_reference_snapshot(params, jcfg, str(tmp_path),
                                      num_shards=2)
    jevo = JaxEvo('evo-1-8k-base', checkpoint_path=str(tmp_path),
                  config_overrides=dict(ov, use_pallas='never'))
    evo = Evo('evo-1-8k-base', 'cpu', checkpoint_path=str(tmp_path),
              config_overrides=ov)
    assert evo.config.inner_mlp_size == jevo.config.inner_mlp_size == 80
    want = jax_score_sequences(SEQS, jevo.model, jevo.tokenizer)
    got = score_sequences(SEQS, evo.model, evo.tokenizer)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_snapshot_download_is_guarded(monkeypatch):
    """Without `huggingface_hub` a load with no path raises the error that
    points at the offline ways in; nothing reaches for the network."""
    monkeypatch.setitem(sys.modules, 'huggingface_hub', None)
    with pytest.raises(RuntimeError, match='checkpoint_path=.*random_init'):
        models.snapshot_download('evo-1-8k-base')
    with pytest.raises(RuntimeError, match='huggingface_hub is not '
                                           'installed'):
        Evo('evo-1-131k-base', 'cpu')
    assert models.hf_revision('evo-1-8k-base') == '1.1_fix'
    assert models.hf_revision('evo-1-131k-base') == '1.1_fix'
    assert models.hf_revision('evo-1.5-8k-base') == 'main'
    assert models.HF_MODEL_NAME_MAP['evo-1-8k-crispr'] == \
        'evo-design/evo-1-8k-crispr'
    with pytest.raises(ValueError, match='Invalid model name'):
        Evo('evo-2', 'cpu', random_init=True)
