"""The port's parallel execution (evo_tpu_torch/parallel/, the mesh branches
of the layers, the engine, the loaders, the train step and the CLIs)
against the JAX package's, on the CPU in float32 at the tiny config.

In this process (no ranks):
  * the sharding table leaf by leaf against `evo_tpu.parallel.sharding.
    param_specs`, bf16 and int8 (int4 raises in both), and each rank's
    `shard_params` against the shard JAX's puts on that rank's device;
  * `has_cp` and `channel_axes` against the JAX package's;
  * the finetune CLI's per-rank batch (`rank_batch_size`);
  * the mesh arithmetic and its errors against `evo_tpu.parallel.mesh.
    make_mesh` on the conftest's virtual CPU devices;
  * `split_for_process` and the shard manifest, byte for byte, against
    the JAX functions, and a fingerprint mismatch raising in both;
  * the refusals that remain: int4 under a mesh, a size tp does not
    divide; the mesh flags of the score and serve CLIs want ranks of
    their own in one process; the sharded and the LoRA train steps build
    on a one-process cp mesh (serving, speculation and LoRA under a
    mesh: tests/test_torch_mesh_serving.py; cp = 2: tests/
    test_torch_context_parallel.py; training under cp: tests/
    test_torch_cp_training.py).

In two gloo processes on the CPU, this file run as a script (it imports
no JAX then):
  * tp = 2: logits against the JAX forward unsharded and under a
    make_mesh(dp=1, tp=2) virtual mesh (tests/test_golden.py's
    tolerances, rtol = atol = 1e-4), scores and the first sequence's
    logits against tests/golden/tiny_scores.npz, greedy generation
    token-exact against tests/golden/tiny_greedy.npz, int8 weights and
    the int8 KV cache against JAX under the same mesh, act_quant='int8'
    with and without the MAX reduce of the row scales (the latter must
    miss the JAX logits), and both ranks' results equal;
  * dp = 2: scores and logits against JAX; `allgather_to_all_hosts`;
  * make_sharded_train_step at (dp 2, tp 1) and (dp 1, tp 2), 2 steps,
    against JAX make_train_step on the same batch: losses rtol 1e-5, the
    masters (shards gathered) 99.9 % within rtol 1e-5, atol 2e-6 and
    every element within 6 lr, as tests/test_torch_training.py holds
    them; replicated masters bit-equal across ranks; per-rank train-state
    files that refuse another mesh;
  * score_fasta_sharded: the merged CSV against single-process scores, a
    run killed as each process starts its second shard, then resumed;
  * `python -m evo_tpu_torch.cli.score --dp 2 --tiny --device cpu`: the
    TSV against the single-process CLI's, and again after one shard's
    files are deleted, which only that shard's rank scores again;
  * `python -m evo_tpu_torch.cli.finetune --tiny` under --dp 2 and --tp 2:
    the lead's log, per-rank train-state files, a serving checkpoint.
"""

import csv
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FASTA = ROOT / 'examples' / 'example_seqs.fasta'
GOLDEN = ROOT / 'tests' / 'golden'
TRAIN_LR = 1e-3


# ---------------------------------------------------------------------------
# The worker: `python tests/test_torch_parallel.py <mode> <dir>` as one rank
# of a launch (torchrun's environment); reads dir/ref.npz, writes
# dir/<mode>_rank<r>.npz
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


def _train(sd, cfg, mesh, ref, out):
    """Two sharded steps on this dp rank's rows; the masters by name."""
    from evo_tpu_torch import training
    model = _port_model(sd, cfg, mesh)
    rows = slice(mesh.index('dp'), mesh.index('dp') + 1) if mesh.dp > 1 \
        else slice(None)
    opt = training.make_optimizer(learning_rate=TRAIN_LR)
    state = training.init_train_state(model, opt)
    step = training.make_sharded_train_step(model, opt, mesh)
    losses = []
    for _ in range(2):
        state, loss = step(state, ref['train_ids'][rows],
                           ref['train_mask'][rows])
        losses.append(float(loss))
    out['train_losses'] = np.asarray(losses)
    for n, m in state.params.items():
        out['m/' + n] = m.numpy()
    # per-rank train-state files: a round trip, and another mesh refused
    d = os.path.join(os.environ['WORK_DIR'], f'state_{mesh.tp}')
    training.save_train_state(state, d, mesh)
    again = training.load_train_state(d, training.init_train_state(
        model, opt), mesh)
    out['state_round_trip'] = np.asarray(all(
        torch.equal(again.params[n], m) for n, m in state.params.items())
        and again.step == 2)
    from evo_tpu_torch.parallel.mesh import Mesh
    swapped = Mesh(mesh.tp, 1, mesh.dp, rank=mesh.rank)
    for key, other in (('state_no_mesh', None), ('state_other_mesh',
                                                 swapped)):
        try:
            training.load_train_state(d, state, other)
            out[key] = np.asarray('loaded')
        except ValueError as e:
            out[key] = np.asarray(str(e))


def _worker(mode: str, d: str) -> None:
    import torch.distributed as dist

    from evo_tpu_torch.config import tiny_config
    from evo_tpu_torch.generation import generate
    from evo_tpu_torch.io.fasta import read_fasta
    from evo_tpu_torch.parallel import distributed
    from evo_tpu_torch.parallel.mesh import make_mesh
    from evo_tpu_torch.scoring import score_sequences
    from evo_tpu_torch.tokenizer import CharLevelTokenizer

    torch.set_num_threads(1)
    os.environ['WORK_DIR'] = d
    distributed.initialize_distributed(device='cpu')
    rank = dist.get_rank()
    ref = np.load(os.path.join(d, 'ref.npz'))
    sd = {k[3:]: ref[k] for k in ref.files if k.startswith('sd/')}
    tok = CharLevelTokenizer(512)
    _, seqs = read_fasta(str(FASTA))
    cfg = tiny_config()
    out = {}
    if mode in ('crash', 'resume'):
        model = _port_model(sd, cfg, None)
        calls = []

        def score_fn(batch):
            calls.append(len(batch))
            with open(os.path.join(d, f'calls_p{rank}.log'), 'a') as f:
                f.write(f'{len(batch)}\n')
            if mode == 'crash' and len(calls) == 2:
                dist.barrier()      # both have finished their first shard
                os._exit(17)
            return score_sequences(batch, model, tok)

        distributed.score_fasta_sharded(os.path.join(d, 'eight.fasta'),
                                        os.path.join(d, 'job'), score_fn,
                                        num_shards=4, batch_size=64)
        return
    mesh = make_mesh(dp=2, tp=1) if mode == 'dp' else make_mesh(dp=1, tp=2)
    model = _port_model(sd, cfg, mesh)
    out['contiguous'] = np.asarray(all(
        p.is_contiguous() for p in model.module.parameters()))
    out['logits'] = model(ref['ids'])[0].numpy()
    out['scores'] = np.asarray(score_sequences(seqs, model, tok))
    out['logits0'] = model(tok.tokenize(seqs[0])[None])[0].numpy()
    gen, scores = generate(['ACGTACGT'], model, tok, n_tokens=16, top_k=1,
                           temperature=1.0, verbose=0)
    out['greedy'], out['greedy_score'] = np.asarray(gen[0]), scores[0]
    if mode == 'dp':
        out['allgather_np'] = distributed.allgather_to_all_hosts(
            np.arange(6).reshape(2, 3) + 10 * rank)
        out['allgather_torch'] = distributed.allgather_to_all_hosts(
            torch.full((1, 2), float(rank))).numpy()
        # one replica over both ranks: they score the same shards, each
        # its rows of every batch
        distributed.score_fasta_sharded(
            str(FASTA), os.path.join(d, 'sharded'),
            lambda b: score_sequences(b, model, tok), batch_size=2,
            mesh=mesh)
        _train(sd, cfg, mesh, ref, out)
    else:
        from evo_tpu_torch import quant
        cfg8 = tiny_config(weight_quant='int8', kv_quant='int8')
        m8 = _port_model(sd, cfg8, mesh)
        out['logits_int8'] = m8(ref['ids'])[0].numpy()
        gen, scores = generate(['ACGTACGT'], m8, tok, n_tokens=16, top_k=1,
                               temperature=1.0, verbose=0)
        out['greedy_int8'], out['greedy_int8_score'] = (np.asarray(gen[0]),
                                                        scores[0])
        cfga = tiny_config(weight_quant='int8', act_quant='int8')
        ma = _port_model(sd, cfga, mesh)
        out['logits_act'] = ma(ref['ids'])[0].numpy()
        # without the MAX reduce each rank quantizes its half-rows with
        # their own scales: another function than the JAX package's
        quant.all_reduce_max = lambda x, mesh, axis='tp': x
        out['logits_act_nomax'] = ma(ref['ids'])[0].numpy()
        _train(sd, cfg, mesh, ref, out)
    np.savez(os.path.join(d, f'{mode}_rank{rank}.npz'), **out)


# ---------------------------------------------------------------------------
# JAX references (this process)
# ---------------------------------------------------------------------------

def _by_port_name(tree, cfg):
    """A JAX parameter tree as {port parameter name: numpy}, the Hyena
    runs unstacked."""
    from evo_tpu import model as jax_model
    out = {'embedding': np.asarray(tree['embedding'])}
    if 'final_norm' in tree:
        out['final_norm.weight'] = np.asarray(tree['final_norm'])
    for i, blk in enumerate(jax_model.layer_blocks(tree, cfg)):
        for norm in ('pre_norm', 'post_norm'):
            out[f'blocks.{i}.{norm}.weight'] = np.asarray(blk[norm])
        for sub in ('attn', 'hyena', 'mlp'):
            for k, v in blk.get(sub, {}).items():
                out[f'blocks.{i}.{sub}.{k}'] = np.asarray(v)
    return out


@pytest.fixture(scope='module')
def jax_params():
    """The JAX package's tiny config and its PRNGKey(0) weights, which
    tests/golden/ holds."""
    import jax
    from evo_tpu import model as jax_model
    from evo_tpu.config import tiny_config
    cfg = tiny_config()
    return cfg, jax.jit(jax_model.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), cfg)


@pytest.fixture(scope='module')
def jax_ref(tmp_path_factory, jax_params):
    """The JAX package's results on the tiny config's PRNGKey(0) weights,
    and those weights as a state dict."""
    import functools

    import jax
    import jax.numpy as jnp
    from evo_tpu import checkpoint as jax_ckpt
    from evo_tpu import model as jax_model
    from evo_tpu import training as jax_training
    from evo_tpu.generation import generate
    from evo_tpu.models import EvoModel
    from evo_tpu.parallel.mesh import make_mesh
    from evo_tpu.parallel.sharding import shard_params
    from evo_tpu.quant import quantize_params
    from evo_tpu.tokenizer import CharLevelTokenizer

    d = tmp_path_factory.mktemp('parallel')
    cfg, params = jax_params
    mesh = make_mesh(dp=1, tp=2, devices=jax.devices()[:2])
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 512, (3, 40)).astype(np.int32)
    ref = {'ids': ids,
           'train_ids': rng.integers(0, 64, (2, 24)).astype(np.int32),
           'train_mask': (rng.random((2, 24)) < 0.8).astype(np.float32)}

    def fwd(p, c, m=None):
        run = jax.jit(functools.partial(jax_model.forward, cfg=c, mesh=m))
        return np.asarray(run(p if m is None else shard_params(p, c, m),
                              ids=jnp.asarray(ids)))

    ref['logits'] = fwd(params, cfg)
    ref['logits_mesh'] = fwd(params, cfg, mesh)
    cfg8 = cfg.replace(weight_quant='int8', kv_quant='int8')
    q = quantize_params(params)
    ref['logits_int8_mesh'] = fwd(q, cfg8, mesh)
    gen, scores = generate(['ACGTACGT'], EvoModel(
        cfg8, shard_params(q, cfg8, mesh), mesh=mesh),
        CharLevelTokenizer(512), n_tokens=16, top_k=1, temperature=1.0,
        verbose=0)
    ref['greedy_int8'], ref['greedy_int8_score'] = gen[0], scores[0]
    cfga = cfg.replace(weight_quant='int8', act_quant='int8')
    ref['logits_act_mesh'] = fwd(q, cfga, mesh)
    opt = jax_training.make_optimizer(learning_rate=TRAIN_LR)
    state = jax_training.init_train_state(params, opt)
    step = jax.jit(jax_training.make_train_step(cfg, opt))
    losses = []
    for _ in range(2):
        state, loss = step(state, jnp.asarray(ref['train_ids']),
                           jnp.asarray(ref['train_mask']))
        losses.append(float(loss))
    ref['train_losses'] = np.asarray(losses)
    masters = _by_port_name(state.params, cfg)
    from evo_tpu.io.fasta import write_fasta
    write_fasta(str(d / 'eight.fasta'), [f'seq{i}' for i in range(8)],
                ['ACGT' * (i + 3) for i in range(8)])
    for k, v in jax_ckpt.export_state_dict(params, cfg).items():
        ref['sd/' + k] = np.asarray(v)
    np.savez(d / 'ref.npz', **ref)
    return d, ref, masters


def _launch(argv, d, nprocs=2, timeout=240):
    from evo_tpu_torch.parallel.distributed import launch_local
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        [str(ROOT)] + ([env['PYTHONPATH']] if env.get('PYTHONPATH') else []))
    env.pop('XLA_FLAGS', None)
    env['OMP_NUM_THREADS'] = '1'      # ranks beside the other test workers
    return launch_local(argv, nprocs, env=env, timeout=timeout,
                        log_dir=str(d))


@pytest.fixture(scope='module')
def tp_run(jax_ref):
    d = jax_ref[0]
    _launch([__file__, 'tp', str(d)], d)
    return [dict(np.load(d / f'tp_rank{r}.npz')) for r in (0, 1)]


@pytest.fixture(scope='module')
def dp_run(jax_ref):
    d = jax_ref[0]
    _launch([__file__, 'dp', str(d)], d)
    return [dict(np.load(d / f'dp_rank{r}.npz')) for r in (0, 1)]


def _golden():
    return (np.load(GOLDEN / 'tiny_scores.npz'),
            np.load(GOLDEN / 'tiny_greedy.npz'))


@pytest.mark.parametrize('mode', ['tp', 'dp'])
def test_forward_scores_and_greedy_match_jax(mode, jax_ref, request):
    """Logits against the JAX forward (unsharded, and under the virtual
    tp=2 mesh), scores and logits of the golden file, greedy generation
    token for token; both ranks alike."""
    _, ref, _ = jax_ref
    runs = request.getfixturevalue(f'{mode}_run')
    scores, greedy = _golden()
    for got in runs:
        assert bool(got['contiguous'])
        for want in (ref['logits'], ref['logits_mesh']):
            np.testing.assert_allclose(got['logits'], want, rtol=1e-4,
                                       atol=1e-4)
        np.testing.assert_allclose(got['scores'], scores['scores'],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got['logits0'], scores['logits0'],
                                   rtol=1e-4, atol=1e-4)
        assert str(got['greedy']) == bytes(greedy['seq']).decode()
        np.testing.assert_allclose(got['greedy_score'],
                                   float(greedy['score']), rtol=1e-5)
    for k in ('logits', 'scores', 'greedy', 'greedy_score'):
        np.testing.assert_array_equal(runs[0][k], runs[1][k])


def test_tp_int8_weights_and_kv_cache_match_jax_mesh(jax_ref, tp_run):
    _, ref, _ = jax_ref
    for got in tp_run:
        np.testing.assert_allclose(got['logits_int8'],
                                   ref['logits_int8_mesh'], rtol=1e-4,
                                   atol=1e-4)
        assert str(got['greedy_int8']) == str(ref['greedy_int8'])
        # a mean log-prob moves at most twice as far as its logits (1e-4):
        # tp's other order of float32 sums can move a K / V code by one
        # step, which the same limit covers
        np.testing.assert_allclose(got['greedy_int8_score'],
                                   float(ref['greedy_int8_score']),
                                   rtol=0, atol=2e-4)


def test_tp_act_quant_needs_the_row_max_over_tp(jax_ref, tp_run):
    """With the all-reduce MAX the int8 x int8 path is the JAX package's
    function under the mesh; with each rank's own half-row scales it is
    not."""
    _, ref, _ = jax_ref
    want = ref['logits_act_mesh']
    for got in tp_run:
        np.testing.assert_allclose(got['logits_act'], want, rtol=1e-4,
                                   atol=1e-4)
        assert np.abs(got['logits_act_nomax'] - want).max() > 1e-3


@pytest.mark.parametrize('mode', ['tp', 'dp'])
def test_sharded_train_step_matches_jax(mode, jax_ref, request):
    from evo_tpu_torch.parallel.sharding import tp_axis
    _, ref, want = jax_ref
    runs = request.getfixturevalue(f'{mode}_run')
    close = []
    for name, w in want.items():
        shards = [r['m/' + name] for r in runs]
        axis = tp_axis(name) if mode == 'tp' else None
        if axis is None:
            # replicated: bit-equal across ranks
            np.testing.assert_array_equal(shards[0], shards[1], name)
            m = shards[0]
        else:
            m = np.concatenate(shards, axis=axis)
        err = np.abs(m - w)
        assert err.max() <= 6 * TRAIN_LR, (name, err.max())
        close.append((err <= 2e-6 + 1e-5 * np.abs(w)).ravel())
    assert np.concatenate(close).mean() >= 0.999
    for r in runs:
        np.testing.assert_allclose(r['train_losses'], ref['train_losses'],
                                   rtol=1e-5)
        assert bool(r['state_round_trip'])
        assert 'saved under mesh' in str(r['state_other_mesh'])
        assert 'no train state of evo_tpu_torch for mesh None' in str(
            r['state_no_mesh'])


def _read_csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_score_fasta_sharded_merges_in_input_order(jax_ref, dp_run):
    d = jax_ref[0]
    scores = _golden()[0]['scores']
    rows = _read_csv(d / 'sharded' / 'scores.csv')
    assert [int(r['index']) for r in rows] == list(range(len(scores)))
    np.testing.assert_allclose([float(r['score']) for r in rows], scores,
                               rtol=1e-5, atol=1e-6)


def test_score_fasta_sharded_crash_then_resume(jax_ref):
    d = jax_ref[0]
    with pytest.raises(RuntimeError, match='exited with code 17'):
        _launch([__file__, 'crash', str(d)], d)
    job = d / 'job'
    assert sorted(p.name for p in job.glob('shard_*.done')) == [
        'shard_0.done', 'shard_2.done']
    assert not (job / 'scores.csv').exists()
    _launch([__file__, 'resume', str(d)], d)
    for r in (0, 1):
        calls = (d / f'calls_p{r}.log').read_text().split()
        assert len(calls) == 3, calls      # 2 before the crash, 1 after
    rows = _read_csv(job / 'scores.csv')
    assert [r['name'] for r in rows] == [f'seq{i}' for i in range(8)]
    from evo_tpu_torch.checkpoint import params_from_state_dict
    from evo_tpu_torch.config import tiny_config
    from evo_tpu_torch.models import EvoModel
    from evo_tpu_torch.scoring import score_sequences
    from evo_tpu_torch.tokenizer import CharLevelTokenizer
    ref = jax_ref[1]
    sd = {k[3:]: ref[k] for k in ref if k.startswith('sd/')}
    cfg = tiny_config()
    model = EvoModel(cfg, params_from_state_dict(sd, cfg, 'cpu'))
    want = score_sequences(['ACGT' * (i + 3) for i in range(8)], model,
                           CharLevelTokenizer(512))
    np.testing.assert_allclose([float(r['score']) for r in rows], want,
                               rtol=1e-5, atol=1e-6)


def test_score_cli_two_ranks_and_resume(tmp_path):
    """The CLI's multi-process branch against its single-process run;
    deleting one shard's files makes only its rank score again."""
    from evo_tpu_torch.cli import score as score_cli
    single = tmp_path / 'single.tsv'
    score_cli.main(['--tiny', '--device', 'cpu', '--input-fasta', str(FASTA),
                    '--output-tsv', str(single)])
    out = tmp_path / 'two.tsv'
    argv = ['-m', 'evo_tpu_torch.cli.score', '--dp', '2', '--tiny',
            '--device', 'cpu', '--input-fasta', str(FASTA), '--output-tsv',
            str(out), '--batch-size', '2']
    logs = _launch(argv, tmp_path)
    assert 'Wrote' in logs[0] and 'Wrote' not in logs[1]

    def read(p):
        return [ln.split('\t') for ln in p.read_text().splitlines()]
    want, first = read(single), read(out)
    assert [r[0] for r in first] == [r[0] for r in want]
    np.testing.assert_allclose([float(r[1]) for r in first[1:]],
                               [float(r[1]) for r in want[1:]], rtol=1e-5)
    work = Path(str(out) + '.work')
    (work / 'shard_1.csv').unlink()
    (work / 'shard_1.done').unlink()
    logs = _launch(argv, tmp_path)
    assert 'shard 0: done before, skipped' in logs[0]
    assert 'shard 1: scored' in logs[1]
    assert read(out) == first


def test_allgather_to_all_hosts_matches_jax(dp_run):
    """Every rank's array tiled along axis 0 on every rank, numpy or
    tensor; on one process x itself, as the JAX package's returns it."""
    from evo_tpu.parallel import distributed as jax_dist
    from evo_tpu_torch.parallel import distributed
    for got in dp_run:
        np.testing.assert_array_equal(got['allgather_np'], np.concatenate(
            [np.arange(6).reshape(2, 3) + 10 * r for r in (0, 1)]))
        np.testing.assert_array_equal(got['allgather_torch'],
                                      [[0.0, 0.0], [1.0, 1.0]])
    x = np.arange(6, dtype=np.float32).reshape(3, 2)
    np.testing.assert_array_equal(distributed.allgather_to_all_hosts(x),
                                  np.asarray(jax_dist.allgather_to_all_hosts(
                                      x)))


@pytest.mark.parametrize('flags', [['--dp', '2'], ['--tp', '2']],
                         ids=['dp2', 'tp2'])
def test_finetune_cli_two_ranks(tmp_path, flags):
    """cli/finetune.py on two ranks: --batch-size windows a host a step
    (under --dp 2 each rank reads half of them, from its half of the
    records), per-rank train-state files, and a serving checkpoint that
    loads in one process."""
    from evo_tpu_torch.io.dataset import PackedFastaDataset
    from evo_tpu_torch.models import Evo
    from evo_tpu_torch.tokenizer import CharLevelTokenizer
    save = tmp_path / 'ft'
    argv = ['-m', 'evo_tpu_torch.cli.finetune', '--tiny', '--device', 'cpu',
            '--input-fasta', str(FASTA), '--seq-len', '8', '--batch-size',
            '2', '--steps', '2', '--log-every', '1', '--save-dir',
            str(save)] + flags
    logs = _launch(argv, tmp_path)
    dp = 2 if flags[0] == '--dp' else 1
    ds = PackedFastaDataset([str(FASTA)], CharLevelTokenizer(512),
                            seq_len=8, batch_size=2 // dp, seed=0,
                            process_index=0, process_count=dp)
    assert f'{ds.steps_per_epoch()} steps/epoch/host' in logs[0]
    assert 'step 2  loss' in logs[0] and 'done: 2 steps' in logs[0]
    assert 'loss' not in logs[1]
    assert sorted(p.name for p in (save / 'train_state').iterdir()) == [
        f'train_state.rank{r}.{ext}' for r in (0, 1)
        for ext in ('json', 'safetensors')]
    evo = Evo('evo-1-8k-base', 'cpu', checkpoint_path=str(save / 'serving'))
    logits = evo.model(torch.tensor([[1, 65, 67, 71]]))[0]
    assert bool(torch.isfinite(logits).all())


def test_finetune_rank_batch_size():
    from evo_tpu_torch.cli.finetune import rank_batch_size
    from evo_tpu_torch.parallel.mesh import Mesh
    assert rank_batch_size(8, None) == 8
    assert rank_batch_size(8, Mesh(2, 1, 2)) == 4
    assert rank_batch_size(8, Mesh(1, 1, 4)) == 8
    assert rank_batch_size(2, Mesh(4, 1, 1), hosts=2) == 1
    with pytest.raises(ValueError, match='--dp 4 does not divide'):
        rank_batch_size(2, Mesh(4, 1, 1))


# ---------------------------------------------------------------------------
# One process: tables, arithmetic, manifests, refusals
# ---------------------------------------------------------------------------

def _jax_specs_by_kind(tree):
    """{(scope, leaf[, q|s]): set of tp axes} of a JAX PartitionSpec tree,
    the stacked layer axis dropped."""
    import jax
    from jax.sharding import PartitionSpec as P
    out = {}
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    for path, spec in leaves:
        keys = [str(getattr(k, 'key', getattr(k, 'idx', ''))) for k in path]
        spec = tuple(spec)
        if 'stack' in keys:
            spec = spec[1:]
        scope = next((s for s in ('attn', 'hyena', 'mlp') if s in keys), '')
        tail = keys[-2:] if keys[-1] in ('q', 's') else keys[-1:]
        axis = spec.index('tp') if 'tp' in spec else None
        out.setdefault((scope, *tail), set()).add(axis)
    return out


def _port_specs_by_kind(specs):
    out = {}
    for name, axis in specs.items():
        parts = name.split('.')
        if parts[-1] == 'weight':
            parts = parts[:-1]
        scope = next((s for s in ('attn', 'hyena', 'mlp') if s in parts), '')
        tail = parts[-2:] if parts[-1] in ('q', 's') else parts[-1:]
        out.setdefault((scope, *tail), set()).add(axis)
    return out


@pytest.mark.parametrize('quant', ['none', 'int8'])
def test_sharding_table_matches_jax(quant):
    from evo_tpu.config import tiny_config as jax_tiny
    from evo_tpu.parallel import sharding as jax_sharding
    from evo_tpu_torch.config import tiny_config
    from evo_tpu_torch.parallel import sharding
    want = _jax_specs_by_kind(jax_sharding.param_specs(
        jax_tiny(weight_quant=quant)))
    got = _port_specs_by_kind(sharding.param_specs(
        tiny_config(weight_quant=quant)))
    assert got == want


def test_sharding_int4_raises_in_both():
    from evo_tpu.config import tiny_config as jax_tiny
    from evo_tpu.parallel import sharding as jax_sharding
    from evo_tpu_torch.config import tiny_config
    from evo_tpu_torch.parallel import sharding
    with pytest.raises(NotImplementedError, match='int4'):
        jax_sharding.param_specs(jax_tiny(weight_quant='int4'))
    with pytest.raises(NotImplementedError, match='int4'):
        sharding.param_specs(tiny_config(weight_quant='int4'))


@pytest.mark.parametrize('n,dp,tp,cp', [
    (8, 1, None, 1), (8, 2, None, 1), (8, -1, 2, 1), (8, -1, 4, 2),
    (8, 2, 2, 2), (8, 3, None, 1), (8, 2, 3, 1), (4, 1, 4, 1),
    (2, 2, 1, 1), (6, 4, 2, 1)])
def test_mesh_arithmetic_matches_jax(n, dp, tp, cp):
    import jax
    from evo_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from evo_tpu_torch.parallel.mesh import plan_mesh
    devices = jax.devices()[:n]
    try:
        m = jax_make_mesh(dp=dp, tp=tp, cp=cp, devices=devices)
        want = (m.shape['dp'], m.shape['cp'], m.shape['tp'])
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            plan_mesh(n, dp, tp, cp, what='len(devices)')
        assert str(got.value) == str(e)
        return
    assert plan_mesh(n, dp, tp, cp) == want


def test_shard_params_matches_jax_shards(jax_ref, jax_params):
    """`shard_params` on a model and on a dict of full tensors gives tp
    rank r the shard that the JAX package's `shard_params` puts on device
    r of a virtual (dp 1, tp 2) mesh, bit for bit, as contiguous tensors;
    the dict is emptied as it goes; a size tp does not divide raises
    naming the parameter and axis."""
    import jax
    from evo_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from evo_tpu.parallel.sharding import shard_params as jax_shard_params
    from evo_tpu_torch.checkpoint import params_from_state_dict
    from evo_tpu_torch.config import tiny_config
    from evo_tpu_torch.parallel.mesh import Mesh
    from evo_tpu_torch.parallel.sharding import shard_params
    jcfg, params = jax_params
    ref = jax_ref[1]
    sd = {k[3:]: ref[k] for k in ref if k.startswith('sd/')}
    cfg = tiny_config()
    jmesh = jax_make_mesh(dp=1, tp=2, devices=jax.devices()[:2])
    placed = jax_shard_params(params, jcfg, jmesh)
    for r, dev in enumerate(jmesh.devices.ravel()):
        want = _by_port_name(jax.tree_util.tree_map(
            lambda a: next(np.asarray(s.data) for s in a.addressable_shards
                           if s.device == dev), placed), jcfg)
        mesh = Mesh(1, 1, 2, rank=r)
        module = shard_params(params_from_state_dict(sd, cfg, 'cpu'), cfg,
                              mesh)
        full = {n: p.detach() for n, p in params_from_state_dict(
            sd, cfg, 'cpu').named_parameters()}
        from_dict = shard_params(full, cfg, mesh)
        assert full == {}
        for got in (dict(module.named_parameters()), from_dict):
            assert set(got) == set(want)
            for n, t in got.items():
                assert t.is_contiguous(), n
                np.testing.assert_array_equal(t.numpy(), want[n], err_msg=n)
        assert all(m.mesh is mesh for m in module.modules()
                   if hasattr(m, 'mesh'))
    with pytest.raises(ValueError, match=r'w_in: axis 2 of size 64 does '
                       r'not divide over tp=3'):
        shard_params(params_from_state_dict(sd, cfg, 'cpu'), cfg,
                     Mesh(1, 1, 3))


@pytest.mark.parametrize('dp,cp,tp', [(1, 1, 1), (1, 1, 2), (2, 1, 2),
                                      (1, 2, 2), (2, 2, 1)])
def test_has_cp_and_channel_axes_match_jax(dp, cp, tp):
    import jax
    from evo_tpu.parallel import mesh as jax_mesh
    from evo_tpu_torch.parallel import mesh as port_mesh
    jm = jax_mesh.make_mesh(dp=dp, cp=cp, tp=tp,
                            devices=jax.devices()[:dp * cp * tp])
    pm = port_mesh.Mesh(dp, cp, tp)
    for j, p in ((jm, pm), (None, None)):
        assert port_mesh.has_cp(p) == jax_mesh.has_cp(j)
        assert port_mesh.channel_axes(p) == jax_mesh.channel_axes(j)


def test_mesh_coordinates_and_refusals():
    from evo_tpu_torch.parallel.mesh import (Mesh, axis_groups, coords_of,
                                             local_mesh, make_mesh)
    # tp innermost: tp groups are contiguous ranks
    assert axis_groups(0, 2, 1, 2)['tp'] == [[0, 1], [2, 3]]
    assert axis_groups(4, 2, 1, 2)['dp'] == [[4, 6], [5, 7]]
    assert [coords_of(r, 2, 1, 2) for r in range(4)] == [
        (0, 0, 0), (0, 0, 1), (1, 0, 0), (1, 0, 1)]
    m = make_mesh()          # one process, no group
    assert (m.dp, m.cp, m.tp, m.groups) == (1, 1, 1, {})
    assert isinstance(m, Mesh)
    # cp > 1 is ported; in one process a cp = 2 mesh does not fit the
    # world, as the JAX package's make_mesh says of one device
    for make, what in ((make_mesh, 'device_count'),
                       (local_mesh, 'local world size')):
        with pytest.raises(ValueError,
                           match=rf'dp\*cp\*tp = 1\*2\*0 != {what} 1'):
            make(cp=2)


def test_split_and_manifest_match_jax(tmp_path):
    from evo_tpu.parallel import distributed as jax_dist
    from evo_tpu_torch.parallel import distributed
    items = list(range(11))
    for pc in (1, 2, 3, 4):
        for pi in range(pc):
            assert distributed.split_for_process(items, pi, pc) == \
                jax_dist.split_for_process(items, pi, pc)
    names = [f'seq{i}' for i in range(7)] + ['seq0']
    for nshards in (1, 3):
        a, b = tmp_path / f'jax{nshards}', tmp_path / f'port{nshards}'
        want = jax_dist.write_shard_manifest(str(a), names, nshards, 'f0')
        got = distributed.write_shard_manifest(str(b), names, nshards, 'f0')
        assert got == want
        assert (b / 'manifest.json').read_bytes() == \
            (a / 'manifest.json').read_bytes()
        for fn, d in ((jax_dist.write_shard_manifest, a),
                      (distributed.write_shard_manifest, b)):
            with pytest.raises(ValueError, match='fingerprint'):
                fn(str(d), names, nshards, 'f1')
    # the fingerprint of score_fasta_sharded: the JAX package's sha1
    import hashlib
    from evo_tpu_torch.io.fasta import read_fasta
    n, s = read_fasta(str(FASTA))
    h = hashlib.sha1()
    for a_, b_ in zip(n, s):
        h.update(a_.encode() + b'\0' + b_.encode() + b'\0')
    assert distributed.fasta_fingerprint(n, s) == h.hexdigest()


def test_refusals_under_a_mesh(tmp_path):
    from evo_tpu_torch import lora
    from evo_tpu_torch.cli import score as score_cli
    from evo_tpu_torch.cli import serve as serve_cli
    from evo_tpu_torch.config import cli_tiny_overrides, tiny_config
    from evo_tpu_torch.model import StripedHyena
    from evo_tpu_torch.models import Evo
    from evo_tpu_torch.parallel.collectives import copy_to_tp, reduce_from_tp
    from evo_tpu_torch.parallel.mesh import Mesh
    from evo_tpu_torch.serving import GenerationServer
    from evo_tpu_torch.speculative import generate_speculative
    one = Mesh(1, 1, 1)
    x = torch.ones(3)
    assert copy_to_tp(x, None) is x and reduce_from_tp(x, one) is x
    with pytest.raises(ValueError, match='int4 is single-chip only'):
        Evo('evo-1-8k-base', 'cpu', random_init=True, mesh=one,
            config_overrides=dict(cli_tiny_overrides(), weight_quant='int4'))
    with pytest.raises(ValueError, match=r'w_in: axis 2 of size 64 does '
                       r'not divide over tp=3'):
        StripedHyena(tiny_config(), 'cpu', Mesh(1, 1, 3))
    evo = Evo('evo-1-8k-base', 'cpu', random_init=True, mesh=one,
              config_overrides=cli_tiny_overrides())
    assert evo.model.mesh is one
    # serving, speculation and LoRA take a mesh (tests/
    # test_torch_mesh_serving.py): on a one-rank mesh, as without one
    server = GenerationServer(evo.model, evo.tokenizer, max_slots=1,
                              max_len=16)
    rid = server.submit(prompt='ACGT', num_tokens=2)
    assert server.lead and len(server.run()[rid].token_ids) == 2
    toks, _, _ = generate_speculative(evo.model, evo.tokenizer,
                                      prompt='ACGT', num_tokens=2)
    assert len(toks) == 2
    assert lora.lora_rank(lora.init_lora(torch.Generator(), evo.model,
                                         2)) == 2
    # the mesh flags of the serve CLI want ranks in one process
    for flag in ('--dp', '--tp', '--cp'):
        with pytest.raises(ValueError, match='one process a rank'):
            serve_cli.build_server(serve_cli.build_parser().parse_args(
                ['--tiny', '--device', 'cpu', flag, '2']))
    # the train steps under cp, full and LoRA, build on a one-process cp
    # mesh (they run on ranks: tests/test_torch_cp_training.py)
    from evo_tpu_torch import training
    cp_mesh = Mesh(1, 2, 1)
    cp_evo = Evo('evo-1-8k-base', 'cpu', random_init=True, mesh=cp_mesh,
                 config_overrides=cli_tiny_overrides())
    opt = training.make_optimizer(learning_rate=1e-3)
    for make in (lambda: training.make_sharded_train_step(
            cp_evo.model, opt, cp_mesh),
                 lambda: lora.make_lora_train_step(cp_evo.model, opt)):
        assert callable(make())
    # --cp is ported: in one process it wants ranks, as --dp / --tp do
    with pytest.raises(ValueError, match='one process a rank'):
        score_cli.main(['--tiny', '--device', 'cpu', '--cp', '2',
                        '--input-fasta', str(FASTA), '--output-tsv',
                        str(tmp_path / 'x.tsv')])
    with pytest.raises(ValueError, match='one process a rank'):
        score_cli.main(['--tiny', '--device', 'cpu', '--tp', '2',
                        '--input-fasta', str(FASTA), '--output-tsv',
                        str(tmp_path / 'x.tsv')])


if __name__ == '__main__':
    sys.path.insert(0, str(ROOT))
    _worker(sys.argv[1], sys.argv[2])
