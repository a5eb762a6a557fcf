"""The fused-mixer configuration of the PyTorch port (`hyena_fused_mixer`,
`hyena_pallas_prefix`) and the fused MLP gate against the JAX package, on
the CPU at tiny widths, inputs from numpy seeds.

On CPU tensors the port's wrappers take their plain versions; the JAX side
runs its Pallas kernels in interpret mode, as its own tests do
(`tests/test_pallas_{hyena,prefix,mlp}.py`), at the tolerances stated
there.
"""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import evo_tpu.ops.pallas_attention as jax_pallas_attention
import evo_tpu.ops.pallas_hyena as jax_pallas_hyena
import evo_tpu.ops.pallas_prefix as jax_pallas_prefix
from evo_tpu import checkpoint as jax_ckpt
from evo_tpu import model as jax_model
from evo_tpu.config import tiny_config as jax_tiny_config
from evo_tpu.ops import fftconv as jax_fftconv
from evo_tpu.ops.pallas_mlp import fused_gate_pallas
from evo_tpu_torch import checkpoint as ckpt
from evo_tpu_torch.checkpoint import params_from_state_dict
from evo_tpu_torch.config import ModelConfig, cli_tiny_overrides, tiny_config
from evo_tpu_torch.generation import Generator
from evo_tpu_torch.layers import hyena
from evo_tpu_torch.models import Evo, EvoModel
from evo_tpu_torch.ops import fftconv
from evo_tpu_torch.ops import modal_prefix as prefix_ops
from evo_tpu_torch.ops.hyena_mixer import (hyena_mixer, hyena_mixer_plain,
                                           hyena_mixer_supported)
from evo_tpu_torch.ops.mlp_gate import fused_gate, fused_gate_plain
from evo_tpu_torch.scoring import (score_sequences,
                                   score_sequences_segmented)
from evo_tpu_torch.tokenizer import CharLevelTokenizer

torch.set_num_threads(2)
CHUNK = 16
# the JAX tests' own tolerance for the fused mixer and for the conv with
# the prefix kernel against their unfused oracles, in float32
FUSED_TOL = dict(rtol=2e-4, atol=2e-4)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


def _both(a, dtype=np.float32):
    a = np.asarray(a, np.float32)
    if dtype == 'bfloat16':
        return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).bfloat16()
    return jnp.asarray(a), torch.from_numpy(a)


def _modal(rng, C, S):
    """Stable random poles and residues, (C, S, 2) float32."""
    mag = rng.uniform(0.5, 0.98, (C, S))
    ang = rng.uniform(-np.pi, np.pi, (C, S))
    poles = np.stack([mag * np.cos(ang), mag * np.sin(ang)], -1)
    return (poles.astype(np.float32),
            (rng.standard_normal((C, S, 2)) * 0.3).astype(np.float32))


def _mixer_inputs(rng, B, C, L, S, bias, dtype=np.float32):
    """((JAX arguments), (port arguments)) of the mixer, one set of
    values."""
    poles, residues = _modal(rng, C, S)
    arrays = [_both(rng.standard_normal((B, 3, C, L)), dtype),
              _both(rng.standard_normal((3, C, 3)) * 0.5),
              _both(rng.standard_normal((3, C)) * 0.1) if bias
              else (None, None),
              _both(poles), _both(residues),
              _both(rng.standard_normal(C))]
    return tuple(zip(*arrays))


# -- kernel 6: the fused mixer ------------------------------------------------

@pytest.mark.parametrize('B,C,L,chunk,bias', [
    (2, 8, 32, 8, True),
    (1, 16, 64, 16, False),
    (1, 8, 128, 8, True),
    (2, 8, 7, 16, True),          # L < chunk: one chunk of odd width
])
def test_hyena_mixer_plain_matches_jax_kernel(B, C, L, chunk, bias):
    jargs, targs = _mixer_inputs(np.random.default_rng(L), B, C, L, 4, bias)
    assert hyena_mixer_supported(targs[0].shape, chunk, 4, 3)
    assert jax_pallas_hyena.hyena_mixer_supported(jargs[0].shape, chunk)
    y_j, iir_j, fir_j = jax_pallas_hyena.hyena_mixer_pallas(
        *jargs, chunk=chunk, interpret=True)
    y, iir, fir = hyena_mixer_plain(*targs, chunk=chunk)
    assert y.shape == (B, C, L) and iir.shape == (B, C, 4, 2)
    assert fir.shape == (B, 3, C, 2) and iir.dtype == torch.float32
    _close(y, y_j, **FUSED_TOL)
    _close(iir, iir_j, **FUSED_TOL)
    _close(fir, fir_j, rtol=1e-6, atol=1e-6)
    # a CPU tensor takes the plain version
    for a, b in zip(hyena_mixer(*targs, chunk=chunk), (y, iir, fir)):
        assert torch.equal(a, b)


def test_hyena_mixer_plain_bf16_matches_jax_kernel():
    """bf16 activations round at the same points (FIR output, conv
    output), so the two agree to bf16 noise: the JAX test's 3e-2."""
    jargs, targs = _mixer_inputs(np.random.default_rng(3), 1, 16, 64, 4,
                                 False, 'bfloat16')
    y_j, iir_j, fir_j = jax_pallas_hyena.hyena_mixer_pallas(
        *jargs, chunk=16, interpret=True)
    y, iir, fir = hyena_mixer_plain(*targs, chunk=16)
    assert y.dtype == torch.bfloat16 and fir.dtype == torch.bfloat16
    _close(y.float(), y_j, rtol=3e-2, atol=3e-2)
    _close(iir, iir_j, rtol=3e-2, atol=3e-2)
    _close(fir.float(), fir_j, rtol=0, atol=0)


def test_hyena_mixer_segment_continuation():
    """Two halves with the carried (fir, iir) state equal one pass, in
    the port and against the JAX kernel seeded the same way."""
    B, C, L, chunk = 1, 8, 64, 8
    jargs, targs = _mixer_inputs(np.random.default_rng(2), B, C, L, 4, True)
    y_full, iir_full, fir_full = hyena_mixer_plain(*targs, chunk=chunk)
    h = L // 2
    y1, iir1, fir1 = hyena_mixer_plain(targs[0][..., :h], *targs[1:],
                                       chunk=chunk)
    y2, iir2, fir2 = hyena_mixer_plain(targs[0][..., h:], *targs[1:],
                                       chunk=chunk, state=(fir1, iir1))
    _close(torch.cat([y1, y2], -1), y_full, **FUSED_TOL)
    _close(iir2, iir_full, **FUSED_TOL)
    _close(fir2, fir_full, rtol=1e-6, atol=1e-6)
    y2_j, iir2_j, fir2_j = jax_pallas_hyena.hyena_mixer_pallas(
        jargs[0][..., h:], *jargs[1:], chunk=chunk,
        state=(jnp.asarray(fir1.numpy()), jnp.asarray(iir1.numpy())),
        interpret=True)
    _close(y2, y2_j, **FUSED_TOL)
    _close(iir2, iir2_j, **FUSED_TOL)
    _close(fir2, fir2_j, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('shape,chunk,S,Kf,want', [
    ((1, 3, 4096, 8192), 64, 8, 3, True),
    # C must be a multiple of 8, as the JAX package's own rule asks
    # (`evo_tpu.ops.pallas_hyena._pick_blocks`: a channel block of a
    # multiple of 8 that divides C)
    ((2, 3, 5, 4096), 64, 8, 3, False),
    ((1, 3, 8, 37), 64, 8, 3, True),        # L < chunk: one chunk
    ((1, 3, 8, 3809), 64, 8, 3, False),     # ragged
    ((1, 3, 8, 256), 128, 8, 3, False),     # a chunk above 64
    ((1, 3, 8, 64), 64, 16, 3, False),      # more than 8 states
    ((1, 3, 8, 64), 64, 8, 7, False),       # a FIR of 7 taps
    ((1, 3, 8, 64), 64, 8, 4, False),       # or of any length but 3
    ((1, 3, 8, 64), 64, 8, 2, False),
    ((1, 2, 8, 64), 64, 8, 3, False),
])
def test_hyena_mixer_support_rule(shape, chunk, S, Kf, want):
    assert hyena_mixer_supported(shape, chunk, S, Kf) is want


# -- kernel 7: the cross-chunk prefix -----------------------------------------

@pytest.mark.parametrize('B,D,K,S,C', [
    (1, 64, 128, 8, 64), (2, 32, 16, 4, 32), (1, 16, 48, 8, 64),
    (1, 8, 2, 2, 128)])
def test_modal_prefix_plain_matches_jax_kernel(B, D, K, S, C):
    rng = np.random.default_rng(K)
    inj_r, inj_i = (_both(rng.standard_normal((B, D, K, S)))
                    for _ in range(2))
    logmag = _both(np.log(rng.uniform(0.5, 0.98, (D, S))))
    theta = _both(rng.uniform(-3.1, 3.1, (D, S)))
    assert prefix_ops.modal_prefix_supported((B, D, K, S))
    want = jax_pallas_prefix.modal_prefix_pallas(
        inj_r[0], inj_i[0], logmag[0], theta[0], C, interpret=True)
    got = prefix_ops.modal_prefix_plain(inj_r[1], inj_i[1], logmag[1],
                                        theta[1], C)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w, rtol=2e-5, atol=2e-5)       # the JAX test's own
    for g, p in zip(prefix_ops.modal_prefix(inj_r[1], inj_i[1], logmag[1],
                                            theta[1], C), got):
        assert torch.equal(g, p)
    assert not prefix_ops.modal_prefix_supported((B, D, 1, S))


@pytest.mark.parametrize('with_state', [False, True])
def test_conv_matmul_chunked_prefix_flag(monkeypatch, with_state):
    """`pallas_prefix=True` against False in both packages. With a carried
    state the JAX package keeps its loop; the port's prefix serves it too,
    the state's terms being added outside."""
    monkeypatch.setattr(
        jax_pallas_prefix, 'modal_prefix_pallas',
        functools.partial(jax_pallas_prefix.modal_prefix_pallas,
                          interpret=True))
    calls = []
    orig = prefix_ops.modal_prefix
    monkeypatch.setattr(prefix_ops, 'modal_prefix',
                        lambda *a: calls.append(1) or orig(*a))
    rng = np.random.default_rng(3)
    B, D, L, S, chunk = 2, 24, 512, 8, 64
    u = _both(rng.standard_normal((B, D, L)))
    poles, residues = (_both(a) for a in _modal(rng, D, S))
    d_skip = _both(rng.standard_normal(D))
    st = _both(rng.standard_normal((B, D, S, 2))) if with_state \
        else (None, None)
    y0, s0 = fftconv.conv_matmul_chunked(u[1], poles[1], residues[1], chunk,
                                         state=st[1], d_skip=d_skip[1])
    assert not calls
    y1, s1 = fftconv.conv_matmul_chunked(u[1], poles[1], residues[1], chunk,
                                         state=st[1], d_skip=d_skip[1],
                                         pallas_prefix=True)
    assert len(calls) == 1
    y_j, s_j = jax_fftconv.conv_matmul_chunked(
        u[0], poles[0], residues[0], chunk, state=st[0], d_skip=d_skip[0],
        pallas_prefix=True)
    _close(y1, y0, **FUSED_TOL)
    _close(s1, s0, **FUSED_TOL)
    _close(y1, y_j, **FUSED_TOL)
    _close(s1, s_j, **FUSED_TOL)
    # one chunk: nothing to take a prefix over, the flag changes nothing
    fftconv.conv_matmul_chunked(u[1][..., :64], poles[1], residues[1], chunk,
                                pallas_prefix=True)
    assert len(calls) == 1


# -- kernel 9: the fused MLP gate ---------------------------------------------

@pytest.mark.parametrize('shape,D,I,act,blocks', [
    ((64,), 128, 176, 'gelu', (128, 128, 128)),
    ((300,), 256, 336, 'gelu', (128, 128, 128)),
    ((128,), 384, 128, 'gelu', (128, 128, 128)),
    ((2, 40), 128, 144, 'silu', (64, 128, 128)),     # leading batch dims
    ((3,), 128, 48, 'gelu_tanh', (8, 128, 128)),
    ((3,), 128, 48, 'relu', (8, 128, 128)),
    ((3,), 128, 48, 'identity', (8, 128, 128)),
])
def test_fused_gate_plain_matches_jax_kernel(shape, D, I, act, blocks):
    rng = np.random.default_rng(I)
    x = _both(rng.standard_normal(shape + (D,)))
    w1, w2 = (_both(rng.standard_normal((D, I)) * 0.05) for _ in range(2))
    bm, bn, bk = blocks
    want = fused_gate_pallas(x[0], w1[0], w2[0], activation=act, bm=bm,
                             bn=bn, bk=bk, interpret=True)
    got = fused_gate_plain(x[1], w1[1], w2[1], act)
    assert tuple(got.shape) == shape + (I,) == want.shape
    _close(got, want, rtol=2e-5, atol=2e-5)          # the JAX test's own
    assert torch.equal(fused_gate(x[1], w1[1], w2[1], act), got)


def test_fused_gate_plain_bf16_sums_in_float32():
    """bf16 inputs, float32 sums, one rounding: against the JAX kernel
    and against the float32 result, at the JAX test's 3e-2."""
    rng = np.random.default_rng(2)
    x = _both(rng.standard_normal((32, 512)), 'bfloat16')
    w1, w2 = (_both(rng.standard_normal((512, 128)) * 0.05, 'bfloat16')
              for _ in range(2))
    want = fused_gate_pallas(x[0], w1[0], w2[0], bm=32, bn=128, bk=128,
                             interpret=True)
    got = fused_gate_plain(x[1], w1[1], w2[1])
    assert got.dtype == torch.bfloat16
    _close(got.float(), want, rtol=3e-2, atol=3e-2)
    exact = fused_gate_plain(x[1].float(), w1[1].float(), w2[1].float())
    assert torch.equal(got, exact.bfloat16())
    with pytest.raises(ValueError, match='unknown activation'):
        fused_gate(x[1], w1[1], w2[1], 'swish')


# -- the slice as a whole ------------------------------------------------------

@pytest.fixture
def interpret_kernels(monkeypatch):
    """The JAX package's mixer, flash and buffer kernels in interpret mode
    wherever its layers call them."""
    for mod, name in ((jax_pallas_hyena, 'hyena_mixer_pallas'),
                      (jax_pallas_attention, 'flash_attention_causal'),
                      (jax_pallas_attention, 'flash_attention_buffer')):
        monkeypatch.setattr(mod, name, functools.partial(
            getattr(mod, name), interpret=True))


@pytest.fixture(scope='module', params=['all_hyena', 'striped'])
def setup(request):
    """(port model with the fused mixer, port model without, JAX params,
    JAX config with the fused mixer) on one set of weights."""
    ov = dict(hyena_matmul_chunk=CHUNK)
    if request.param == 'all_hyena':
        ov['attn_layer_idxs'] = ()
    jcfg = jax_tiny_config(**ov)
    params = jax_model.init_params(jax.random.PRNGKey(0), jcfg)
    sd = jax_ckpt.export_state_dict(params, jcfg)
    cfg = tiny_config(**ov)
    module = params_from_state_dict(sd, cfg, 'cpu')
    plain = EvoModel(cfg, module)
    fused_cfg = cfg.replace(hyena_fused_mixer=True)
    fused = EvoModel(fused_cfg, params_from_state_dict(sd, fused_cfg, 'cpu'))
    return fused, plain, params, jcfg.replace(use_pallas='always',
                                              hyena_fused_mixer=True)


def test_fused_forward_prefill_decode_match_jax(setup, interpret_kernels):
    """Forward, prefill and the first decode step (the seam: the fused
    prefill's state continues under the plain decode step) against the
    JAX package with its fused kernel, and against the port's unfused
    path. 128 rows, so the JAX norms stay off their Pallas kernel."""
    fused, plain, params, jcfg = setup
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 512, (2, 64)).astype(np.int32)
    tok = rng.integers(0, 512, (2,)).astype(np.int32)
    want = jax_model.forward(params, jcfg, jnp.asarray(ids))
    got, _ = fused(ids)
    _close(got, want, **FUSED_TOL)
    _close(got, plain(ids)[0], **FUSED_TOL)

    jcache = jax_model.init_cache(jcfg, 2, 80)
    want, jcache = jax_model.prefill(params, jcfg, jnp.asarray(ids), jcache)
    caches = [m.initialize_inference_params(2, 80) for m in (fused, plain)]
    got, caches[0] = fused(ids, inference_params_dict=caches[0])
    ref, caches[1] = plain(ids, inference_params_dict=caches[1])
    _close(got, want, **FUSED_TOL)
    _close(got, ref, **FUSED_TOL)
    want, _ = jax_model.decode_step(params, jcfg, jnp.asarray(tok), jcache)
    got, _ = fused(tok[:, None], inference_params_dict=caches[0])
    ref, _ = plain(tok[:, None], inference_params_dict=caches[1])
    _close(got[:, 0], want, **FUSED_TOL)
    _close(got, ref, **FUSED_TOL)


def test_fused_resumed_segment_matches_jax(setup, interpret_kernels):
    """A second, chunk-aligned segment continues the first through the
    fused branch with its carried state, in both packages."""
    fused, _, params, jcfg = setup
    ids = np.random.default_rng(1).integers(0, 512, (2, 64)).astype(np.int32)
    jcache = jax_model.init_cache(jcfg, 2, 128)
    cache = fused.initialize_inference_params(2, 128)
    for s, e in ((0, 32), (32, 64)):
        want, jcache = jax_model.prefill(params, jcfg,
                                         jnp.asarray(ids[:, s:e]), jcache,
                                         resume=s > 0)
        got, cache = fused(ids[:, s:e], inference_params_dict=cache,
                           resume=s > 0)
        _close(got, want, **FUSED_TOL)


def _seqs(rng, *lengths):
    return [''.join(rng.choice(list('ACGT'), n)) for n in lengths]


@pytest.mark.parametrize('fields', [
    dict(hyena_fused_mixer=True), dict(hyena_pallas_prefix=True),
    dict(hyena_fused_mixer=True, hyena_pallas_prefix=True)],
    ids=['fused', 'prefix', 'both'])
def test_scores_and_generation_match_unfused(setup, fields):
    """`score_sequences`, `score_sequences_segmented` with a segment
    length that is a multiple of the chunk (32: the aligned segments take
    the fused branch with a carried state) and one that is not (25: they
    fall through), and greedy generation, against the unfused port."""
    _, plain, _, _ = setup
    tok = CharLevelTokenizer(512)
    # the same weights under another config: a shallow copy of the module
    module = copy.copy(plain.module)
    module.config = plain.config.replace(**fields)
    model = EvoModel(module.config, module)
    seqs = _seqs(np.random.default_rng(4), 95, 63, 40)
    np.testing.assert_allclose(score_sequences(seqs, model, tok),
                               score_sequences(seqs, plain, tok), rtol=1e-4)
    ref = [score_sequences([s], plain, tok)[0] for s in seqs]
    for segment_len in (32, 25):
        got = score_sequences_segmented(seqs, model, tok,
                                        segment_len=segment_len)
        np.testing.assert_allclose(got, ref, rtol=1e-4)
    prompt = _seqs(np.random.default_rng(6), 48)[0]
    want, want_scores, _ = Generator(plain, tok, top_k=1).generate(
        prompt, num_tokens=12)
    for kw in ({}, {'prefill_segment_len': 32}):
        got, scores, _ = Generator(model, tok, top_k=1).generate(
            prompt, num_tokens=12, **kw)
        assert torch.equal(got, want)
        _close(scores, want_scores, **FUSED_TOL)


# -- which branch `hyena_full` takes -------------------------------------------

@pytest.fixture
def counted(monkeypatch):
    """Counts of the calls `hyena_full` makes to the fused mixer, the
    FIR + gate op and the prefix op (each still runs)."""
    counts = {'hyena_mixer': 0, 'fir_gate': 0, 'modal_prefix': 0}

    def counting(name, fn):
        def wrapper(*a, **kw):
            counts[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(hyena, 'hyena_mixer',
                        counting('hyena_mixer', hyena.hyena_mixer))
    monkeypatch.setattr(hyena, 'fir_gate',
                        counting('fir_gate', hyena.fir_gate))
    monkeypatch.setattr(prefix_ops, 'modal_prefix',
                        counting('modal_prefix', prefix_ops.modal_prefix))
    return counts


@pytest.mark.parametrize('fused,prefix,L,carried,want', [
    # (mixer, fir_gate, modal_prefix) calls
    (True, False, 32, False, (1, 0, 0)),    # a multiple of the chunk
    (True, False, 32, True, (1, 0, 0)),     # the same, continued
    (True, False, 40, False, (0, 1, 0)),    # ragged: falls through
    (True, False, 40, True, (0, 1, 0)),     # ragged, continued: the split
    (True, False, 7, False, (1, 0, 0)),     # L < chunk: one chunk of 7
    (True, False, 7, True, (1, 0, 0)),
    (True, False, 2, True, (0, 0, 0)),      # L < short_filter_length
    (True, True, 32, False, (1, 0, 0)),     # both: the fused branch wins
    (True, True, 40, False, (0, 1, 1)),     # and the prefix falls through
    (True, True, 40, True, (0, 1, 1)),      # 2 chunks + a tail of 8
    (False, True, 32, False, (0, 1, 1)),
    (False, True, 32, True, (0, 1, 1)),     # the port's prefix also resumes
    (False, True, 7, False, (0, 1, 0)),     # one chunk: no prefix
    (False, False, 32, False, (0, 1, 0)),
])
def test_hyena_full_dispatch(counted, fused, prefix, L, carried, want):
    cfg = tiny_config(hyena_matmul_chunk=CHUNK)
    g = torch.Generator().manual_seed(0)
    from evo_tpu_torch import model as model_lib
    p = model_lib.random_init(cfg, g, 'cpu').blocks[0].hyena
    x = torch.randn(2, 24 + L, cfg.hidden_size, generator=g)
    state = None
    if carried:
        _, state = hyena.hyena_full(p, cfg, x[:, :24], collect_state=True)
    ref, ref_state = hyena.hyena_full(p, cfg, x[:, 24:], collect_state=True,
                                      state=state)
    for k in counted:
        counted[k] = 0
    flagged = cfg.replace(hyena_fused_mixer=fused, hyena_pallas_prefix=prefix)
    got, got_state = hyena.hyena_full(p, flagged, x[:, 24:],
                                      collect_state=True, state=state)
    assert (counted['hyena_mixer'], counted['fir_gate'],
            counted['modal_prefix']) == want
    _close(got, ref, rtol=1e-5, atol=1e-5)
    _close(got_state.iir, ref_state.iir, rtol=1e-5, atol=1e-5)
    assert torch.equal(got_state.fir, ref_state.fir)
    assert hyena.hyena_full(p, flagged, x[:, 24:], state=state)[1] is None


# -- the two fields through the public entry points ----------------------------

def test_config_fields_reach_the_model_and_the_checkpoint(tmp_path):
    assert not ModelConfig().hyena_fused_mixer
    assert not ModelConfig().hyena_pallas_prefix
    ov = dict(cli_tiny_overrides(), hyena_fused_mixer=True,
              hyena_pallas_prefix=True)
    evo = Evo('evo-1-8k-base', 'cpu', random_init=True, config_overrides=ov)
    assert evo.config.hyena_fused_mixer and evo.config.hyena_pallas_prefix
    assert evo.model.module.config == evo.config
    ckpt.save_native(evo.model.module, str(tmp_path), evo.config)
    saved = ckpt.native_config(str(tmp_path))
    assert saved == evo.config
    # the fields are the caller's, not the checkpoint's: a snapshot's
    # shapes never set them, and a load keeps what the caller asked for
    sd = ckpt.strip_backbone_prefix(ckpt.state_dict(evo.model.module))
    base = dataclasses.replace(evo.config, hyena_fused_mixer=False,
                               hyena_pallas_prefix=False)
    assert ckpt.infer_config_overrides(sd, base) == {}
    again = Evo('evo-1-8k-base', 'cpu', checkpoint_path=str(tmp_path),
                config_overrides=dict(cli_tiny_overrides(),
                                      hyena_fused_mixer=True))
    assert again.config.hyena_fused_mixer
    assert not again.config.hyena_pallas_prefix
    tok = evo.tokenizer
    seqs = ['ACGT' * 20]
    np.testing.assert_allclose(score_sequences(seqs, again.model, tok),
                               score_sequences(seqs, evo.model, tok),
                               rtol=1e-5)
