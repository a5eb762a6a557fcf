"""The port's context parallelism (the cp axis of evo_tpu_torch/parallel/,
ops/ulysses_attention.py, ops/ring_attention.py and the cp branches of the
layers, the engine and the CLIs) against the JAX package's, on the CPU in
float32 at the tiny config, as tests/test_parallel.py:107-172 builds it
(`hyena_matmul_chunk=8`).

In this process (no ranks):
  * `zigzag_indices` and `_online_update` against the JAX package's;
  * each rank's block of channels and heads under (dp, cp, tp) against the
    shard the JAX package's ('tp', 'cp') layout puts on that device, and
    the local decode-cache shapes against its `cache_shardings`;
  * `cp_attn` validation, as in the JAX config.

In gloo processes on the CPU, this file run as a script (it imports no JAX
then), once as cp = 2 on 2 ranks and once as cp = 2, tp = 2 on 4 (and as
dp = 2, cp = 2 on 4 for the forward, the seam and the golden files):
  * logits under 'ulysses', 'ring' and 'zigzag' at L = 64 against the
    JAX forward unsharded and under the same make_mesh(dp=1, cp=2, tp=...)
    virtual mesh (rtol = atol = 2e-4, tests/test_parallel.py:131-133), and
    the ring again in query-row blocks of one row; under Ulysses also the
    FFT long-conv backend (`hyena_conv_backend='fft'`, monolithic and with
    `hyena_fft_chunk=16`) against the JAX FFT forward unsharded;
  * a ragged L = 61 under Ulysses against JAX; 'ring' and 'zigzag'
    raising the JAX package's ValueError on it (and 'zigzag' on 62);
  * the prefill + one decode step seam of tests/test_parallel.py:135-161;
  * scores and logits against tests/golden/tiny_scores.npz, greedy
    generation token-exact against tests/golden/tiny_greedy.npz with the
    bf16 and the int8 KV cache;
  * a segmented score and a generation prefilled in segments and resumed
    (bf16 and int8 KV; int8 weights, with and without int8 activations)
    against the single process's; the Ulysses fallback where cp does not
    divide a shard's heads; int8 weights against JAX under the same mesh;
    every rank's results bit-equal;
  * `python -m evo_tpu_torch.cli.score --cp 2 --tiny --device cpu`: the TSV
    against the single-process CLI's; `cli.generate --cp 2`'s sample and
    score against the single-process CLI's.
"""

import os
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FASTA = ROOT / 'examples' / 'example_seqs.fasta'
GOLDEN = ROOT / 'tests' / 'golden'
MODES = ('ulysses', 'ring', 'zigzag')
L = 64
RAGGED = 61
# launch -> (dp, cp, tp); dp2cp2 runs the forward, the seam and the
# golden files only
RUNS = {'cp2': (1, 2, 1), 'cp2tp2': (1, 2, 2), 'dp2cp2': (2, 2, 1)}
FULL = ('cp2', 'cp2tp2')


def _ranks(run):
    dp, cp, tp = RUNS[run]
    return dp * cp * tp


# ---------------------------------------------------------------------------
# The worker: `python tests/test_torch_context_parallel.py <run> <dir>` as
# one rank of a launch (torchrun's environment); reads dir/ref.npz, writes
# dir/<run>_rank<r>.npz
# ---------------------------------------------------------------------------

def _port_model(sd, cfg, mesh):
    from evo_tpu_torch.checkpoint import params_from_state_dict
    from evo_tpu_torch.models import EvoModel
    from evo_tpu_torch.quant import quantize_params
    module = params_from_state_dict(dict(sd), cfg, 'cpu', mesh)
    if cfg.weight_quant != 'none':
        module = quantize_params(module, free_source=True,
                                 mode=cfg.weight_quant)
    return EvoModel(cfg, module)


def _generate(model, tok):
    """Greedy generation as the golden file holds it, and a generation
    prefilled in segments of 8 and resumed from its cache."""
    from evo_tpu_torch.generation import Generator, generate
    gen, scores = generate(['ACGTACGT'], model, tok, n_tokens=16, top_k=1,
                           temperature=1.0, verbose=0)
    g = Generator(model, tok, top_k=1)
    toks, _, cache = g.generate('ACGT' * 10, num_tokens=4,
                                prefill_segment_len=8)
    more, logits, _ = g.generate(input_ids=toks[:, -1:], num_tokens=4,
                                 inference_params_dict=cache)
    return gen[0], scores[0], np.concatenate([toks.numpy(), more.numpy()],
                                             axis=1), logits.numpy()


def _worker(run: str, d: str) -> None:
    from evo_tpu_torch.config import tiny_config
    from evo_tpu_torch.io.fasta import read_fasta
    from evo_tpu_torch.ops import ring_attention
    from evo_tpu_torch.parallel import distributed
    from evo_tpu_torch.parallel.mesh import make_mesh
    from evo_tpu_torch.scoring import (score_sequences,
                                       score_sequences_segmented)
    from evo_tpu_torch.tokenizer import CharLevelTokenizer

    torch.set_num_threads(1)
    distributed.initialize_distributed(device='cpu')
    dp, cp, tp = RUNS[run]
    mesh = make_mesh(dp=dp, cp=cp, tp=tp)
    ref = np.load(os.path.join(d, 'ref.npz'))
    sd = {k[3:]: ref[k] for k in ref.files if k.startswith('sd/')}
    ids = ref['ids']
    tok = CharLevelTokenizer(512)
    cfg = tiny_config(hyena_matmul_chunk=8)
    out = {}
    for attn in (MODES if run in FULL else MODES[:1]):
        m = _port_model(sd, cfg.replace(cp_attn=attn), mesh)
        out[f'logits_{attn}'] = m(ids)[0].numpy()
        if run not in FULL:
            continue
        for n in (RAGGED, RAGGED + 1):
            try:
                out[f'logits_{attn}_{n}'] = m(ids[:, :n])[0].numpy()
            except ValueError as e:
                out[f'error_{attn}_{n}'] = np.asarray(str(e))
        if attn == 'ulysses':
            # the FFT long conv on the rank's channel block over the whole
            # sequence, fresh and chunked (hyena_fft_chunk 16 < L)
            for chunk in (0, 16):
                out[f'logits_fft_{chunk}'] = _port_model(sd, cfg.replace(
                    hyena_conv_backend='fft', hyena_fft_chunk=chunk),
                    mesh)(ids)[0].numpy()
        if attn == 'ring':
            keep = ring_attention.SCORE_BYTES
            ring_attention.SCORE_BYTES = 1      # one query row a block
            out['logits_ring_rows'] = m(ids)[0].numpy()
            ring_attention.SCORE_BYTES = keep
    # the prefill + decode seam, and the cache it leaves
    m = _port_model(sd, cfg, mesh)
    cache = m.initialize_inference_params(ids.shape[0], L + 4)
    logits, cache = m(ids, inference_params_dict=cache)
    out['seam_prefill'] = logits.numpy()
    step, cache = m(torch.as_tensor(ref['seam_tok'])[:, None],
                    inference_params_dict=cache)
    out['seam_step'] = step[:, 0].numpy()
    for i, layer in enumerate(cache['layers']):
        for name, t in (layer.items() if isinstance(layer, dict)
                        else layer._asdict().items()):
            out[f'cache/{i}/{name}'] = np.asarray(t.shape)
    _, seqs = read_fasta(str(FASTA))
    if run not in FULL:
        m0 = _port_model(sd, tiny_config(), mesh)
        out['scores'] = np.asarray(score_sequences(seqs, m0, tok))
        out['greedy'] = np.asarray(_generate(m0, tok)[0])
        np.savez(os.path.join(d, f'{run}_rank{mesh.rank}.npz'), **out)
        return
    m8 = _port_model(sd, cfg.replace(weight_quant='int8'), mesh)
    out['logits_int8'] = m8(ids)[0].numpy()
    # Ulysses where cp does not divide a tp shard's heads (one a shard):
    # the sequence gathered, against the same weights in one process
    from evo_tpu_torch import model as model_lib
    from evo_tpu_torch.models import EvoModel
    c1 = cfg.replace(num_attention_heads=tp)
    for where, msh in (('', mesh), ('single_', None)):
        module = model_lib.random_init(c1, torch.Generator().manual_seed(0),
                                       'cpu', msh)
        out[f'{where}logits_heads'] = EvoModel(c1, module)(ids)[0].numpy()
    # the golden files, the segmented score and the resumed generation,
    # against the same calls of the single process; generation under int8
    # weights, without and with int8 activations (a decode step's row
    # blocks of w_out / wo, and their row maxima over tp and cp)
    for label, c in (('', tiny_config()),
                     ('_int8kv', tiny_config(kv_quant='int8')),
                     ('_w8', tiny_config(weight_quant='int8')),
                     ('_w8a8', tiny_config(weight_quant='int8',
                                           act_quant='int8'))):
        for where, mm in (('', _port_model(sd, c, mesh)),
                          ('single_', _port_model(sd, c, None))):
            g, s, resumed, last = _generate(mm, tok)
            out[f'{where}greedy{label}'] = np.asarray(g)
            out[f'{where}greedy_score{label}'] = np.asarray(s)
            out[f'{where}resumed{label}'] = resumed
            out[f'{where}resumed_logits{label}'] = last
            if label:
                continue
            out[f'{where}scores'] = np.asarray(score_sequences(seqs, mm, tok))
            out[f'{where}logits0'] = mm(tok.tokenize(seqs[0])[None])[
                0].numpy()
            out[f'{where}segmented'] = np.asarray(score_sequences_segmented(
                ['ACGT' * 25 + 'ACG', seqs[1]], mm, tok, segment_len=16))
    np.savez(os.path.join(d, f'{run}_rank{mesh.rank}.npz'), **out)


# ---------------------------------------------------------------------------
# JAX references (this process)
# ---------------------------------------------------------------------------

def _launch(argv, d, nprocs, timeout=240):
    from evo_tpu_torch.parallel.distributed import launch_local
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        [str(ROOT)] + ([env['PYTHONPATH']] if env.get('PYTHONPATH') else []))
    env.pop('XLA_FLAGS', None)
    env['OMP_NUM_THREADS'] = '1'      # ranks beside the other test workers
    return launch_local(argv, nprocs, env=env, timeout=timeout,
                        log_dir=str(d))


def _jax_mesh(cp, tp, dp=1):
    import jax
    from evo_tpu.parallel.mesh import make_mesh
    return make_mesh(dp=dp, cp=cp, tp=tp, devices=jax.devices()[:dp * cp * tp])


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The JAX package's results on the tiny config's PRNGKey(0) weights
    (which tests/golden/ holds), computed while both launches run."""
    import functools

    import jax
    import jax.numpy as jnp
    from evo_tpu import checkpoint as jax_ckpt
    from evo_tpu import model as jax_model
    from evo_tpu.config import tiny_config
    from evo_tpu.ops import ring_attention as jax_ring
    from evo_tpu.parallel.sharding import shard_params
    from evo_tpu.quant import quantize_params

    d = tmp_path_factory.mktemp('cp')
    cfg0 = tiny_config()
    params = jax.jit(jax_model.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), cfg0)
    cfg = tiny_config(hyena_matmul_chunk=8, state_prefill_chunk=8)
    ids = np.random.default_rng(3).integers(0, 512, (2, L)).astype(np.int32)

    def fwd(p, c, x, m=None):
        run = jax.jit(functools.partial(jax_model.forward, cfg=c, mesh=m))
        return np.asarray(run(p if m is None else shard_params(p, c, m),
                              ids=jnp.asarray(x)))

    want = {'ids': ids, 'logits': fwd(params, cfg, ids)}
    want['seam_tok'] = want['logits'][:, -1].argmax(-1).astype(np.int32)
    for k, v in jax_ckpt.export_state_dict(params, cfg0).items():
        want['sd/' + k] = np.asarray(v)
    np.savez(d / 'ref.npz', **want)
    got, errors = {}, []

    def launch(run):
        try:
            _launch([__file__, run, str(d)], d, _ranks(run))
            got[run] = [dict(np.load(d / f'{run}_rank{r}.npz'))
                        for r in range(_ranks(run))]
        except Exception as e:      # raised again in the test process
            errors.append(e)
    threads = [threading.Thread(target=launch, args=(r,)) for r in RUNS]
    for t in threads:
        t.start()
    want['logits_ragged'] = fwd(params, cfg, ids[:, :RAGGED])
    for chunk in (0, 16):
        want[f'logits_fft_{chunk}'] = fwd(params, cfg.replace(
            hyena_conv_backend='fft', hyena_fft_chunk=chunk), ids)
    want['seam_step'] = fwd(params, cfg, np.concatenate(
        [ids, want['seam_tok'][:, None]], axis=1))[:, -1]
    q8 = quantize_params(params)
    for run in FULL:
        _, cp, tp = RUNS[run]
        mesh = _jax_mesh(cp, tp)
        for attn in MODES:
            want[f'{run}/logits_{attn}'] = fwd(
                params, cfg.replace(cp_attn=attn), ids, mesh)
        want[f'{run}/logits_int8'] = fwd(q8, cfg.replace(weight_quant='int8'),
                                         ids, mesh)
        q = jnp.zeros((2, RAGGED, 4, 16), jnp.float32)
        for fn, n in ((jax_ring.ring_attention, RAGGED),
                      (jax_ring.zigzag_ring_attention, RAGGED),
                      (jax_ring.zigzag_ring_attention, RAGGED + 1)):
            x = jnp.zeros((2, n, 4, 16), jnp.float32) if n != RAGGED else q
            try:
                fn(x, x, x, mesh, axis_name='cp', head_axis='tp')
            except ValueError as e:
                name = 'ring' if fn is jax_ring.ring_attention else 'zigzag'
                want[f'{run}/error_{name}_{n}'] = str(e)
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return want, got


@pytest.mark.parametrize('run,attn', [(r, a) for r in FULL for a in MODES]
                         + [('dp2cp2', 'ulysses')])
def test_logits_match_jax(runs, run, attn):
    """Each cp_attn against the JAX forward unsharded and under the same
    virtual mesh (dp = 2: unsharded), within tests/test_parallel.py's
    2e-4."""
    want, got = runs
    refs = [want['logits']] + ([want[f'{run}/logits_{attn}']]
                               if run in FULL else [])
    for r in got[run]:
        for ref in refs:
            np.testing.assert_allclose(r[f'logits_{attn}'], ref, rtol=2e-4,
                                       atol=2e-4)


@pytest.mark.parametrize('run,chunk', [(r, c) for r in FULL for c in (0, 16)])
def test_fft_backend_matches_jax(runs, run, chunk):
    """hyena_conv_backend='fft' under cp (Ulysses): each rank's logits
    against the JAX FFT forward unsharded, within 2e-4, and against the
    matmul backend's under the same mesh."""
    want, got = runs
    for r in got[run]:
        np.testing.assert_allclose(r[f'logits_fft_{chunk}'],
                                   want[f'logits_fft_{chunk}'], rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(r[f'logits_fft_{chunk}'],
                                   r['logits_ulysses'], rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize('run', FULL)
def test_ring_in_query_row_blocks(runs, run):
    """The ring's core in blocks of one query row gives its one-block
    result (the online softmax is row by row)."""
    for r in runs[1][run]:
        np.testing.assert_allclose(r['logits_ring_rows'], r['logits_ring'],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('run', FULL)
def test_ragged_length(runs, run):
    """Ulysses pads a length cp does not divide inside the model and
    matches JAX's forward at that length; 'ring' raises the JAX package's
    ValueError on it, 'zigzag' on a length 2 cp does not divide."""
    want, got = runs
    for r in got[run]:
        np.testing.assert_allclose(r[f'logits_ulysses_{RAGGED}'],
                                   want['logits_ragged'], rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(r[f'logits_ulysses_{RAGGED + 1}'],
                                   want['logits'][:, :RAGGED + 1], rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(r[f'logits_ring_{RAGGED + 1}'],
                                   want['logits'][:, :RAGGED + 1], rtol=2e-4,
                                   atol=2e-4)
        for key in (f'error_ring_{RAGGED}', f'error_zigzag_{RAGGED}',
                    f'error_zigzag_{RAGGED + 1}'):
            assert str(r[key]) == want[f'{run}/{key}']


@pytest.mark.parametrize('run', list(RUNS))
def test_prefill_decode_seam(runs, run):
    """A cp prefill fills the (tp, cp)-sharded cache; its logits and one
    decode step from it match the dense JAX forwards."""
    want, got = runs
    for r in got[run]:
        np.testing.assert_allclose(r['seam_prefill'], want['logits'],
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(r['seam_step'], want['seam_step'],
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize('run', list(RUNS))
def test_golden_scores_and_greedy(runs, run):
    """Scores and logits of the golden file at tests/test_golden.py's
    tolerances; greedy generation token-exact with the bf16 and the int8
    KV cache (dp = 2: scores and bf16 greedy)."""
    scores = np.load(GOLDEN / 'tiny_scores.npz')
    greedy = np.load(GOLDEN / 'tiny_greedy.npz')
    for r in runs[1][run]:
        np.testing.assert_allclose(r['scores'], scores['scores'], rtol=1e-5,
                                   atol=1e-6)
        for label in ('', '_int8kv') if run in FULL else ('',):
            assert str(r[f'greedy{label}']) == bytes(greedy['seq']).decode()
        if run not in FULL:
            continue
        np.testing.assert_allclose(r['logits0'], scores['logits0'],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(r['greedy_score'], float(greedy['score']),
                                   rtol=1e-5)


@pytest.mark.parametrize('run', FULL)
def test_segmented_and_resumed_match_the_single_process(runs, run):
    """A segmented score, and a generation prefilled in segments then
    resumed from its cache (bf16 and int8 KV; int8 weights, without and
    with int8 activations), against the same calls in one process."""
    for r in runs[1][run]:
        np.testing.assert_allclose(r['segmented'], r['single_segmented'],
                                   rtol=1e-5, atol=1e-6)
        for label in ('', '_int8kv', '_w8', '_w8a8'):
            np.testing.assert_array_equal(r[f'greedy{label}'],
                                          r[f'single_greedy{label}'])
            np.testing.assert_array_equal(r[f'resumed{label}'],
                                          r[f'single_resumed{label}'])
            np.testing.assert_allclose(r[f'resumed_logits{label}'],
                                       r[f'single_resumed_logits{label}'],
                                       rtol=2e-4, atol=2e-4)
            np.testing.assert_allclose(r[f'greedy_score{label}'],
                                       r[f'single_greedy_score{label}'],
                                       rtol=1e-5)


@pytest.mark.parametrize('run', FULL)
def test_ulysses_gathers_where_heads_do_not_divide(runs, run):
    """One head a tp shard, which cp = 2 does not divide: Ulysses gathers
    the sequence (the JAX package's dense fallback) and matches one
    process."""
    for r in runs[1][run]:
        np.testing.assert_allclose(r['logits_heads'], r['single_logits_heads'],
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize('run', FULL)
def test_int8_weights_match_jax_mesh(runs, run):
    want, got = runs
    for r in got[run]:
        np.testing.assert_allclose(r['logits_int8'],
                                   want[f'{run}/logits_int8'], rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize('run', list(RUNS))
def test_ranks_bit_equal(runs, run):
    ranks = runs[1][run]
    for r in ranks[1:]:
        assert set(r) == set(ranks[0])
        for k, v in ranks[0].items():
            if k.startswith('cache/'):
                continue           # each rank's own block
            np.testing.assert_array_equal(r[k], v, err_msg=k)


@pytest.mark.parametrize('run', list(RUNS))
def test_cache_shapes_after_prefill(runs, run):
    """The cache a cp prefill leaves holds H/(tp cp) heads and C/(tp cp)
    channels on every rank."""
    from evo_tpu_torch.config import tiny_config
    dp, cp, tp = RUNS[run]
    cfg = tiny_config()
    B = 2 // dp
    H, C = cfg.num_attention_heads // (cp * tp), cfg.hidden_size // (cp * tp)
    for r in runs[1][run]:
        assert list(r['cache/1/k']) == [B, L + 4, H, cfg.head_dim]
        assert list(r['cache/0/fir']) == [B, 3, C,
                                          cfg.short_filter_length - 1]
        assert list(r['cache/0/iir']) == [B, C, cfg.state_size, 2]


def test_score_cli_cp2_matches_the_single_process(tmp_path):
    from evo_tpu_torch.cli import score as score_cli
    single = tmp_path / 'single.tsv'
    score_cli.main(['--tiny', '--device', 'cpu', '--input-fasta', str(FASTA),
                    '--output-tsv', str(single)])
    out = tmp_path / 'cp.tsv'
    logs = _launch(['-m', 'evo_tpu_torch.cli.score', '--cp', '2', '--tiny',
                    '--device', 'cpu', '--input-fasta', str(FASTA),
                    '--output-tsv', str(out), '--batch-size', '2'],
                   tmp_path, 2)
    assert 'Wrote' in logs[0] and 'Wrote' not in logs[1]

    def read(p):
        return [ln.split('\t') for ln in p.read_text().splitlines()]
    want, got = read(single), read(out)
    assert [r[0] for r in got] == [r[0] for r in want]
    np.testing.assert_allclose([float(r[1]) for r in got[1:]],
                               [float(r[1]) for r in want[1:]], rtol=1e-5)


def test_generate_cli_cp2_matches_the_single_process(tmp_path, capsys):
    """`cli.generate --cp 2` on two ranks: rank 0 prints the single
    process's greedy sample and score, rank 1 prints nothing."""
    from evo_tpu_torch.cli import generate as generate_cli
    args = ['--tiny', '--device', 'cpu', '--prompt', 'ACGTACGT',
            '--n-samples', '1', '--n-tokens', '8', '--temperature', '0',
            '--top-k', '1']
    generate_cli.main(args)
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if 'Output:' in ln]
    logs = _launch(['-m', 'evo_tpu_torch.cli.generate', '--cp', '2'] + args,
                   tmp_path, 2)
    got = [ln for ln in logs[0].splitlines() if 'Output:' in ln]
    assert len(want) == 1 and 'Output:' not in logs[1]
    assert got[0].split('Score:')[0] == want[0].split('Score:')[0]
    np.testing.assert_allclose(float(got[0].split('Score:')[1]),
                               float(want[0].split('Score:')[1]), rtol=1e-5)


# ---------------------------------------------------------------------------
# One process: the ring's parts, the layouts, the config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('L_,R', [(8, 2), (64, 2), (24, 3), (64, 4), (40, 5)])
def test_zigzag_indices_match_jax(L_, R):
    from evo_tpu.ops.ring_attention import zigzag_indices as jax_zigzag
    from evo_tpu_torch.ops.ring_attention import zigzag_indices
    for got, want in zip(zigzag_indices(L_, R), jax_zigzag(L_, R)):
        np.testing.assert_array_equal(got, want)


def test_online_update_matches_jax():
    import jax.numpy as jnp
    from evo_tpu.ops.ring_attention import _online_update as jax_update
    from evo_tpu_torch.ops.ring_attention import _online_update
    rng = np.random.default_rng(0)
    B, H, Lq, Lk, Dh = 2, 3, 5, 7, 4
    m = rng.standard_normal((B, H, Lq)).astype(np.float32)
    m[0, 0, 0] = -np.inf
    l = rng.random((B, H, Lq)).astype(np.float32)
    acc = rng.standard_normal((B, H, Lq, Dh)).astype(np.float32)
    s = rng.standard_normal((B, H, Lq, Lk)).astype(np.float32)
    s[1, 2, 3, :4] = -1e30
    v = rng.standard_normal((B, Lk, H, Dh)).astype(np.float32)
    got = _online_update(*(torch.from_numpy(a) for a in (m, l, acc, s, v)))
    want = jax_update(*(jnp.asarray(a) for a in (m, l, acc, s, v)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


MESHES = [(1, 2, 1), (1, 2, 2), (2, 2, 2), (2, 2, 1), (1, 4, 2)]


@pytest.mark.parametrize('dp,cp,tp', MESHES)
def test_channel_blocks_match_jax(dp, cp, tp):
    """Rank (d, c, t) mixes the channels and heads that JAX's ('tp', 'cp')
    layout puts on device (d, c, t); has_cp and channel_axes agree."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from evo_tpu.parallel import mesh as jax_mesh
    from evo_tpu_torch.parallel import mesh as port_mesh
    jm = _jax_mesh(cp, tp, dp)
    n = 64
    placed = jax.device_put(np.arange(n), NamedSharding(
        jm, P(jax_mesh.channel_axes(jm))))
    where = {s.device: np.asarray(s.data) for s in placed.addressable_shards}
    for rank, dev in enumerate(jm.devices.ravel()):
        pm = port_mesh.Mesh(dp, cp, tp, rank=rank)
        local = n // tp
        start, size = port_mesh.channel_block(pm, local)
        start += pm.index('tp') * local
        np.testing.assert_array_equal(where[dev],
                                      np.arange(start, start + size))
        assert port_mesh.has_cp(pm) == jax_mesh.has_cp(jm)
        assert port_mesh.channel_axes(pm) == jax_mesh.channel_axes(jm)
    assert port_mesh.axis_groups(0, dp, cp, tp)[port_mesh.CHANNEL] == [
        [(d * cp + c) * tp + t for t in range(tp) for c in range(cp)]
        for d in range(dp)]


@pytest.mark.parametrize('kv_quant', ['none', 'int8'])
@pytest.mark.parametrize('dp,cp,tp', MESHES[:4])
def test_cache_shapes_match_jax(dp, cp, tp, kv_quant):
    """Each layer's local cache under (dp, cp, tp): the shard JAX's
    `cache_shardings` puts on a device (its stacked layer axis dropped);
    a head count tp cp does not divide raises."""
    import jax
    from evo_tpu import model as jax_model
    from evo_tpu.config import tiny_config as jax_tiny
    from evo_tpu.parallel.sharding import cache_shardings as jax_shardings
    from evo_tpu_torch.config import tiny_config
    from evo_tpu_torch.parallel.mesh import Mesh
    from evo_tpu_torch.parallel.sharding import cache_shardings
    B, T = 4, 96
    jm = _jax_mesh(cp, tp, dp)
    jcfg = jax_tiny(kv_quant=kv_quant)
    shapes = jax.eval_shape(lambda: jax_model.init_cache(jcfg, B, T))
    shards = jax_shardings(jcfg, jm)
    want = []
    for (kind, idxs), sh, sp in zip(jcfg.layer_segments(), shapes['layers'],
                                    shards['layers']):
        for i in range(len(idxs)):
            names = sh.keys() if kind == 'attn' else sh._fields
            want.append({n: tuple(_get(sp, n).shard_shape(_get(sh, n).shape))
                         [0 if kind == 'attn' else 1:] for n in names})
    got = cache_shardings(tiny_config(kv_quant=kv_quant),
                          Mesh(dp, cp, tp), B, T)
    assert [{n: s for n, (s, _) in layer.items()} for layer in got] == want
    with pytest.raises(ValueError, match='heads do not divide'):
        cache_shardings(tiny_config(), Mesh(1, 8, 1), B, T)


def _get(tree, name):
    return tree[name] if isinstance(tree, dict) else getattr(tree, name)


def test_cp_attn_validation():
    """The three algorithms of the JAX config, and its assertion on any
    other."""
    from evo_tpu.config import tiny_config as jax_tiny
    from evo_tpu_torch.config import tiny_config
    for make in (jax_tiny, tiny_config):
        assert make().cp_attn == 'ulysses'
        for attn in MODES:
            assert make(cp_attn=attn).cp_attn == attn
        with pytest.raises(AssertionError):
            make(cp_attn='tree')


if __name__ == '__main__':
    sys.path.insert(0, str(ROOT))
    _worker(sys.argv[1], sys.argv[2])
