"""Serving, speculative decoding and LoRA of the port under a mesh (the mesh
branches of evo_tpu_torch/serving.py, speculative.py, lora.py,
layers/adapters.py and the serve and finetune CLIs) against the JAX
package's, on the CPU in float32 at the tiny config (`hyena_matmul_chunk=
16`, as tests/test_torch_serving.py builds it).

In gloo processes on the CPU, this file run as a script (it imports no JAX
then), one launch of two ranks a mesh, tp = 2, dp = 2 and cp = 2, each
running every part at once:
  * `serve_requests` of three ragged greedy prompts on 2 slots against the
    JAX package's `serve_requests` under the same make_mesh(...) virtual
    mesh (it runs all three), token for token, and the recorded log-probs
    against the port's single process (rtol = atol = 1e-4);
  * a driven schedule on 3 slots (which dp = 2 does not divide: 2 rows a
    rank, one of them a pad), prompts in chunks of 4 and batched fills of
    2: staggered arrival, a sampled request, a batched fill, a prefix-cache
    hit and a cancel, against the port's single process driven alike
    (the JAX server keeps other sampling streams): tokens exact, log-probs
    within 1e-4, the same number of fills; each rank's decode rows;
  * a `ServerLoop` on rank 0, idle through several heartbeats, then one
    request, then `close()`, which ends the other rank's `follow()`;
  * greedy `generate_speculative` at g = 3 against the JAX package's on the
    tp = 2 mesh (token for token), and with an oracle drafter (full and
    partial acceptance, replays) against the single process's tokens;
  * LoRA from the JAX package's adapters (`checkpoint.lora_from_jax`): the
    attached forward and the merged model's logits against JAX's (1e-4);
    on tp = 2 and dp = 2, two `make_lora_train_step` steps against JAX
    `make_lora_train_step(..., mesh=)` on the (1, 2) and (2, 1) virtual
    meshes (losses rtol 1e-5; adapters 99.9 % within rtol 1e-5, atol 2e-6,
    tests/test_torch_training.py's thresholds), the base weights
    unchanged, `save_lora`'s npz bit-equal to the single process's before
    training and within the same thresholds after;
  * every rank's results bit-equal.
And in launches of their own: `cli.serve --tp 2` over JSONL against the
one-process CLI, and `cli.finetune --lora-rank 2` under --tp 2 (adapters
against the one-process CLI's) and --dp 2.
"""

import json
import os
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FASTA = ROOT / 'examples' / 'example_seqs.fasta'
# launch -> (dp, cp, tp)
RUNS = {'tp2': (1, 1, 2), 'dp2': (2, 1, 1), 'cp2': (1, 2, 1)}
TRAIN = ('tp2', 'dp2')
PROMPTS = ['ACGTACGTAC', 'TTGGCCAATT', 'GATTACA']
N_NEW = 7
SPEC_PROMPT = 'ACGTTGCAACGTTGCAACGT'
ALPHA, RANK, LR = 8.0, 2, 1e-3


# ---------------------------------------------------------------------------
# The worker: `python tests/test_torch_mesh_serving.py <run> <dir>` as one
# rank of a launch (torchrun's environment); reads dir/ref.npz, writes
# dir/<run>_rank<r>.npz
# ---------------------------------------------------------------------------

def _config():
    from evo_tpu_torch.config import tiny_config
    return tiny_config(hyena_matmul_chunk=16)


def _port_model(sd, mesh):
    from evo_tpu_torch.checkpoint import params_from_state_dict
    from evo_tpu_torch.models import EvoModel
    cfg = _config()
    return EvoModel(cfg, params_from_state_dict(dict(sd), cfg, 'cpu', mesh))


class _FillCount:
    """The model, counting the fills (prefills) the server runs through
    it."""

    def __init__(self, model):
        self._model, self.fills = model, 0

    def __getattr__(self, name):
        return getattr(self._model, name)

    def __call__(self, ids, **kw):
        self.fills += 1
        return self._model(ids, **kw)


def _schedule(model, tok, out, where):
    """Staggered arrival, a sampled request, a batched fill of two, a
    prefix-cache hit and a cancel, on 3 slots; the lead drives, the other
    ranks follow its `run()`."""
    from evo_tpu_torch.serving import GenerationServer
    spy = _FillCount(model)
    server = GenerationServer(spy, tok, max_slots=3, max_len=64,
                              steps_per_sync=4, prompt_chunk=4,
                              prefill_batch=2, seed=5)
    hits, real = [0], server._insert_from

    def insert(*a, **k):
        hits[0] += server._fill is None      # no fill ran: the prefix cache
        return real(*a, **k)
    server._insert_from = insert
    if server.lead:
        rids = [server.submit(prompt='ACGTACGTAC', num_tokens=6),
                server.submit(prompt='TTGGCC', num_tokens=9,
                              temperature=1.0, top_k=4, seed=11),
                server.submit(prompt='GATTAC', num_tokens=5),
                server.submit(prompt='CCCCCCCAAA', num_tokens=7)]
        server.step()
        server.step()
        rids.append(server.submit(prompt='GGGAAATTTCCCA', num_tokens=6))
        server.step()
        # the same prompt as the last B=1 fill: the prefix cache
        rids.append(server.submit(prompt='GGGAAATTTCCCA', num_tokens=4,
                                  temperature=1.0, seed=3))
        rids.append(server.submit(prompt='TACGATCGATCGTTAG',
                                  num_tokens=30))
        server.step()
        server.step()
        assert server.cancel(rids[-1])
        results = server.run()
    else:
        results = server.run()
        rids = sorted(results)
    out[f'{where}sched/rids'] = np.asarray(rids)
    for i, rid in enumerate(rids):
        res = results[rid]
        out[f'{where}sched/{i}/tokens'] = res.token_ids
        out[f'{where}sched/{i}/logps'] = res.logps
        out[f'{where}sched/{i}/cancelled'] = np.asarray(res.cancelled)
    out[f'{where}sched/fills'] = np.asarray(spy.fills)
    out[f'{where}sched/rows'] = np.asarray(server._cache['offset'].shape[0])
    out[f'{where}sched/prefix_hits'] = np.asarray(hits[0])


def _loop(model, tok, out):
    """A ServerLoop on the lead, idle through heartbeats, then a request;
    the other ranks follow until its close() stops them."""
    from evo_tpu_torch import serving
    serving.HEARTBEAT = 0.2
    server = serving.GenerationServer(model, tok, max_slots=2, max_len=64,
                                      steps_per_sync=4)
    steps = [0]
    real = server.step

    def counted():
        steps[0] += 1
        return real()
    server.step = counted
    if server.lead:
        loop = serving.ServerLoop(server)
        time.sleep(1.0)
        out['loop/idle_steps'] = np.asarray(steps[0])
        rid = loop.submit(prompt=PROMPTS[0], num_tokens=N_NEW)
        res = loop.wait(rid, timeout=120)
        loop.close()
    else:
        server.follow()
        res = server.result(0)
        out['loop/idle_steps'] = np.asarray(-1)
    out['loop/tokens'] = res.token_ids
    out['loop/steps'] = np.asarray(steps[0])


def _speculative(model, single, tok, out):
    from evo_tpu_torch.speculative import generate_speculative
    from evo_tpu_torch.tools.spec_agreement import OracleDrafter
    for where, m in (('', model), ('single_', single)):
        toks, logps, stats = generate_speculative(
            m, tok, prompt=SPEC_PROMPT, num_tokens=16, gamma=3)
        out[f'{where}spec/tokens'] = toks
        out[f'{where}spec/logps'] = np.asarray(logps)
    oracle = OracleDrafter(model, tok, len(SPEC_PROMPT), [3, 1, 3, 0, 2])
    with oracle.installed():
        toks, logps, stats = generate_speculative(
            model, tok, prompt=SPEC_PROMPT, num_tokens=20, gamma=3)
    out['spec_oracle/tokens'] = toks
    out['spec_oracle/logps'] = np.asarray(logps)
    out['spec_oracle/accepted'] = np.asarray(stats.accepted)
    out['spec_oracle/cycles'] = np.asarray(stats.cycles)


def _adapters(ref, model):
    """The JAX package's adapters (carried across by lora_from_jax in the
    test process) on a template of the port's own."""
    from evo_tpu_torch import lora
    ad = lora.init_lora(torch.Generator().manual_seed(0), model, RANK)
    with torch.no_grad():
        for name, t in lora.named_adapters(ad).items():
            t.copy_(torch.from_numpy(ref['lora/' + name]))
    return ad


def _lora(sd, ref, run, mesh, d, out):
    from evo_tpu_torch import lora, training
    ids = torch.as_tensor(ref['lora_ids']).long()
    for where, msh in (('', mesh), ('single_', None)):
        model = _port_model(sd, msh)
        ad = _adapters(ref, model)
        lora.attach_lora(model, ad, ALPHA)
        out[f'{where}lora/attached'] = model(ids)[0].numpy()
        lora.detach_lora(model)
        merged = lora.merge_lora(model, ad, ALPHA)
        out[f'{where}lora/merged'] = merged(ids)[0].numpy()
        lora.save_lora(ad, os.path.join(d, f'{where}lora_init_{run}_rank'
                                        f'{mesh.rank}.npz'), ALPHA)
        if run not in TRAIN:
            continue
        before = {n: p.clone() for n, p in model.module.named_parameters()}
        opt = training.make_optimizer(learning_rate=LR)
        state = lora.init_lora_train_state(ad, opt)
        step = lora.make_lora_train_step(model, opt, alpha=ALPHA)
        rows = (slice(mesh.index('dp'), mesh.index('dp') + 1)
                if msh is not None and mesh.dp > 1 else slice(None))
        losses = []
        for _ in range(2):
            state, loss = step(state, ref['train_ids'][rows],
                               ref['train_mask'][rows])
            losses.append(float(loss))
        out[f'{where}lora/losses'] = np.asarray(losses)
        out[f'{where}lora/base_unchanged'] = np.asarray(all(
            torch.equal(p, before[n])
            for n, p in model.module.named_parameters()))
        for n, t in lora.named_adapters(state.lora).items():
            out[f'{where}lora/trained/{n}'] = t.numpy()
        lora.save_lora(state.lora, os.path.join(
            d, f'{where}lora_trained_{run}_rank{mesh.rank}.npz'), ALPHA)


def _worker(run: str, d: str) -> None:
    from evo_tpu_torch.parallel import distributed
    from evo_tpu_torch.parallel.mesh import make_mesh
    from evo_tpu_torch.serving import serve_requests
    from evo_tpu_torch.tokenizer import CharLevelTokenizer

    torch.set_num_threads(1)
    distributed.initialize_distributed(device='cpu')
    dp, cp, tp = RUNS[run]
    mesh = make_mesh(dp=dp, cp=cp, tp=tp)
    ref = np.load(os.path.join(d, 'ref.npz'))
    sd = {k[3:]: ref[k] for k in ref.files if k.startswith('sd/')}
    tok = CharLevelTokenizer(512)
    model, single = _port_model(sd, mesh), _port_model(sd, None)
    out = {}
    for where, m in (('', model), ('single_', single)):
        for i, res in enumerate(serve_requests(m, tok, PROMPTS,
                                               num_tokens=N_NEW, max_slots=2,
                                               steps_per_sync=4)):
            out[f'{where}serve/{i}/tokens'] = res.token_ids
            out[f'{where}serve/{i}/logps'] = res.logps
        _schedule(m, tok, out, where)
    _loop(model, tok, out)
    _speculative(model, single, tok, out)
    _lora(sd, ref, run, mesh, d, out)
    np.savez(os.path.join(d, f'{run}_rank{mesh.rank}.npz'), **out)


# ---------------------------------------------------------------------------
# JAX references (this process)
# ---------------------------------------------------------------------------

def _launch(argv, d, nprocs=2, timeout=300):
    from evo_tpu_torch.parallel.distributed import launch_local
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        [str(ROOT)] + ([env['PYTHONPATH']] if env.get('PYTHONPATH') else []))
    env.pop('XLA_FLAGS', None)
    env['OMP_NUM_THREADS'] = '1'      # ranks beside the other test workers
    return launch_local(argv, nprocs, env=env, timeout=timeout,
                        log_dir=str(d))


REQUESTS = [{'prompt': 'ACGTACGTAC', 'num_tokens': 6},
            {'prompt': 'TTGGCCAATTGG', 'num_tokens': 9, 'id': 'b'},
            {'prompt': 'GATTACA', 'num_tokens': 5},
            {'prompt': 'CCCCAAAA', 'num_tokens': 8}]
SERVE = ['--tiny', '--device', 'cpu', '--max-slots', '2', '--max-len', '64',
         '--steps-per-sync', '4', '--prompt-chunk', '4']
FINETUNE = ['--tiny', '--device', 'cpu', '--input-fasta', str(FASTA),
            '--seq-len', '8', '--batch-size', '2', '--steps', '2',
            '--log-every', '1', '--lora-rank', '2', '--lr-schedule',
            'constant', '--lr', str(LR)]


def _cli_launches(d, got, errors):
    """The serve CLI under --tp 2 and the finetune CLI's LoRA branch under
    --tp 2 and --dp 2, each a launch of two ranks, in threads."""
    (d / 'requests.jsonl').write_text(
        ''.join(json.dumps(r) + '\n' for r in REQUESTS))
    jobs = {
        'serve': ['-m', 'evo_tpu_torch.cli.serve', '--tp', '2'] + SERVE + [
            '--requests-jsonl', str(d / 'requests.jsonl'), '--output-jsonl',
            str(d / 'serve_tp2.jsonl')],
        'finetune_tp2': ['-m', 'evo_tpu_torch.cli.finetune', '--tp', '2']
        + FINETUNE + ['--save-dir', str(d / 'ft_tp2')],
        'finetune_dp2': ['-m', 'evo_tpu_torch.cli.finetune', '--dp', '2']
        + FINETUNE + ['--save-dir', str(d / 'ft_dp2')]}

    def launch(name):
        try:
            got[name] = _launch(jobs[name], d / name)
        except Exception as e:      # raised again in the test process
            errors.append(e)
    return [threading.Thread(target=launch, args=(n,)) for n in jobs]


def _jax_mesh(dp, cp, tp):
    import jax
    from evo_tpu.parallel.mesh import make_mesh
    return make_mesh(dp=dp, cp=cp, tp=tp, devices=jax.devices()[:dp * cp * tp])


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The JAX package's results on the tiny config's PRNGKey(0) weights,
    computed while the launches run; then every launch's results."""
    import jax
    import jax.numpy as jnp
    from evo_tpu import checkpoint as jax_ckpt
    from evo_tpu import lora as jax_lora
    from evo_tpu import model as jax_model
    from evo_tpu import training as jax_training
    from evo_tpu.config import tiny_config
    from evo_tpu.models import EvoModel
    from evo_tpu.parallel.sharding import shard_params
    from evo_tpu.serving import serve_requests
    from evo_tpu.speculative import generate_speculative
    from evo_tpu.tokenizer import CharLevelTokenizer
    from evo_tpu_torch import lora
    from evo_tpu_torch.checkpoint import lora_from_jax

    d = tmp_path_factory.mktemp('mesh_serving')
    jcfg = tiny_config(hyena_matmul_chunk=16)
    params = jax.jit(jax_model.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)

    @jax.jit
    def make_adapters(params):
        adapters = jax_lora.init_lora(jax.random.PRNGKey(1), params, jcfg,
                                      rank=RANK)
        leaves, treedef = jax.tree_util.tree_flatten(adapters)
        keys = jax.random.split(jax.random.PRNGKey(7), len(leaves))
        return jax.tree_util.tree_unflatten(treedef, [
            x + 0.05 * jax.random.normal(k, x.shape, x.dtype)
            for x, k in zip(leaves, keys)])
    adapters = make_adapters(params)
    rng = np.random.default_rng(16)
    want = {'lora_ids': rng.integers(0, 512, (2, 24)).astype(np.int32),
            'train_ids': rng.integers(0, 64, (2, 24)).astype(np.int32),
            'train_mask': (rng.random((2, 24)) < 0.8).astype(np.float32)}
    for k, v in jax_ckpt.export_state_dict(params, jcfg).items():
        want['sd/' + k] = np.asarray(v)
    cfg = _config()
    for name, t in lora.named_adapters(lora_from_jax(
            adapters, cfg, 'cpu')).items():
        want['lora/' + name] = t.numpy()
    np.savez(d / 'ref.npz', **want)
    got, errors = {}, []

    def launch(run):
        try:
            _launch([__file__, run, str(d)], d / run)
            got[run] = [dict(np.load(d / f'{run}_rank{r}.npz'))
                        for r in (0, 1)]
        except Exception as e:      # raised again in the test process
            errors.append(e)
    threads = [threading.Thread(target=launch, args=(r,)) for r in RUNS]
    threads += _cli_launches(d, got, errors)
    for t in threads:
        t.start()
    tok = CharLevelTokenizer(512)
    meshes = {run: _jax_mesh(*shape) for run, shape in RUNS.items()}
    models = {run: EvoModel(jcfg, shard_params(params, jcfg, m), mesh=m)
              for run, m in meshes.items()}
    for run, m in models.items():
        want[f'{run}/serve'] = [
            r.token_ids for r in serve_requests(
                m, tok, PROMPTS, num_tokens=N_NEW, max_slots=2,
                steps_per_sync=4)]
    want['spec'], _, _ = generate_speculative(
        models['tp2'], tok, prompt=SPEC_PROMPT, num_tokens=16, gamma=3)
    ids = jnp.asarray(want['lora_ids'])
    want['lora/attached'] = np.asarray(jax_model.forward(
        jax_lora.attach_lora(params, adapters, ALPHA), jcfg, ids))
    want['lora/merged'] = np.asarray(jax_model.forward(
        jax_lora.merge_lora(params, adapters, ALPHA), jcfg, ids))
    opt = jax_training.make_optimizer(learning_rate=LR)
    for run in TRAIN:
        state = jax_lora.init_lora_train_state(adapters, opt)
        step = jax.jit(jax_lora.make_lora_train_step(
            jcfg, opt, alpha=ALPHA, mesh=meshes[run]))
        losses = []
        for _ in range(2):
            state, loss = step(state, models[run].params,
                               jnp.asarray(want['train_ids']),
                               jnp.asarray(want['train_mask']))
            losses.append(float(loss))
        want[f'{run}/lora_losses'] = np.asarray(losses)
        want[f'{run}/lora_trained'] = {
            n: t.numpy() for n, t in lora.named_adapters(lora_from_jax(
                jax.device_get(state.lora), cfg, 'cpu')).items()}
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return d, want, got


def _assert_adapters_close(got, want):
    """tests/test_torch_training.py's thresholds: 99.9 % of all elements
    within rtol 1e-5, atol 2e-6, and every one within 6 lr."""
    close = []
    for name, w in want.items():
        err = np.abs(got[name] - w)
        assert err.max() <= 6 * LR, (name, err.max())
        close.append((err <= 2e-6 + 1e-5 * np.abs(w)).ravel())
    assert np.concatenate(close).mean() >= 0.999


@pytest.mark.parametrize('run', list(RUNS))
def test_serve_requests_match_jax_mesh(runs, run):
    """The JAX package's server under the same mesh, token for token; the
    recorded log-probs against the port's single process."""
    _, want, got = runs
    for r in got[run]:
        for i, w in enumerate(want[f'{run}/serve']):
            np.testing.assert_array_equal(r[f'serve/{i}/tokens'], w)
            np.testing.assert_array_equal(r[f'single_serve/{i}/tokens'], w)
            np.testing.assert_allclose(r[f'serve/{i}/logps'],
                                       r[f'single_serve/{i}/logps'],
                                       rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('run', list(RUNS))
def test_schedule_matches_the_single_process(runs, run):
    """Staggered arrival, a sampled request, a batched fill, a prefix-cache
    hit and a cancel on 3 slots: the same tokens, log-probs and fills as
    the single process; under dp each rank decodes its 2 rows of the 3
    slots (the JAX server draws its samples from other streams)."""
    _, _, got = runs
    dp = RUNS[run][0]
    for r in got[run]:
        np.testing.assert_array_equal(r['sched/rids'], r['single_sched/rids'])
        n = len(r['sched/rids'])
        assert n == 7
        for i in range(n):
            np.testing.assert_array_equal(r[f'sched/{i}/tokens'],
                                          r[f'single_sched/{i}/tokens'])
            np.testing.assert_allclose(r[f'sched/{i}/logps'],
                                       r[f'single_sched/{i}/logps'],
                                       rtol=1e-4, atol=1e-4)
            assert bool(r[f'sched/{i}/cancelled']) == (i == n - 1)
        assert len(r[f'sched/{n - 1}/tokens']) < 30
        assert int(r['sched/fills']) == int(r['single_sched/fills'])
        assert int(r['sched/prefix_hits']) == 1
        assert int(r['sched/rows']) == (2 if dp == 2 else 3)
        assert int(r['single_sched/rows']) == 3


@pytest.mark.parametrize('run', list(RUNS))
def test_server_loop_heartbeats_and_stop(runs, run):
    """An idle ServerLoop keeps the other rank stepping (heartbeats), and
    its close() ends that rank's follow()."""
    _, want, got = runs
    lead, follower = got[run]
    for r in got[run]:
        np.testing.assert_array_equal(r['loop/tokens'],
                                      want[f'{run}/serve'][0])
    # 1 s idle at 0.2 s a heartbeat, then the request's steps; the other
    # rank steps as often, and once more for the stop
    assert int(lead['loop/idle_steps']) >= 1
    assert int(follower['loop/steps']) == int(lead['loop/steps']) + 1


@pytest.mark.parametrize('run', list(RUNS))
def test_speculative_matches_jax_mesh(runs, run):
    """Greedy speculation at g = 3 against the JAX package's on the tp = 2
    mesh, token for token; with an oracle drafter (cycles accepted in
    full and in part) the single process's greedy stream."""
    _, want, got = runs
    for r in got[run]:
        np.testing.assert_array_equal(r['spec/tokens'], want['spec'])
        np.testing.assert_array_equal(r['single_spec/tokens'], want['spec'])
        np.testing.assert_allclose(r['spec/logps'], r['single_spec/logps'],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(r['spec_oracle/tokens'][:16],
                                      want['spec'])
        np.testing.assert_allclose(r['spec_oracle/logps'][:16],
                                   r['single_spec/logps'], rtol=1e-4,
                                   atol=1e-4)
        assert 0 < int(r['spec_oracle/accepted']) < 3 * int(
            r['spec_oracle/cycles'])


@pytest.mark.parametrize('run', list(RUNS))
def test_lora_forward_and_merge_match_jax(runs, run):
    """The JAX package's adapters attached and merged under the mesh: the
    logits against JAX's (1e-4); the adapter file bit-equal to the single
    process's."""
    d, want, got = runs
    for rank, r in enumerate(got[run]):
        for key in ('attached', 'merged'):
            np.testing.assert_allclose(r[f'lora/{key}'], want[f'lora/{key}'],
                                       rtol=1e-4, atol=1e-4)
        with np.load(d / f'lora_init_{run}_rank{rank}.npz') as a, \
                np.load(d / f'single_lora_init_{run}_rank{rank}.npz') as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize('run', TRAIN)
def test_lora_train_steps_match_jax_mesh(runs, run):
    """Two LoRA steps under (1, 2) and (2, 1) against JAX's under the same
    virtual mesh: losses, adapters; the base weights unchanged; the npz
    within the same thresholds of the single process's."""
    d, want, got = runs
    for rank, r in enumerate(got[run]):
        np.testing.assert_allclose(r['lora/losses'],
                                   want[f'{run}/lora_losses'], rtol=1e-5)
        trained = {k[len('lora/trained/'):]: v for k, v in r.items()
                   if k.startswith('lora/trained/')}
        _assert_adapters_close(trained, want[f'{run}/lora_trained'])
        assert bool(r['lora/base_unchanged'])
        with np.load(d / f'lora_trained_{run}_rank{rank}.npz') as a, \
                np.load(d / f'single_lora_trained_{run}_rank{rank}.npz') as b:
            assert sorted(a.files) == sorted(b.files)
            _assert_adapters_close({k: a[k] for k in a.files},
                                   {k: b[k] for k in b.files})


@pytest.mark.parametrize('run', list(RUNS))
def test_ranks_bit_equal(runs, run):
    d, _, got = runs
    r0, r1 = got[run]
    assert set(r0) == set(r1)
    for k in r0:
        if k in ('loop/steps', 'loop/idle_steps'):
            continue
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    kinds = ('init', 'trained') if run in TRAIN else ('init',)
    for kind in kinds:
        with np.load(d / f'lora_{kind}_{run}_rank0.npz') as a, \
                np.load(d / f'lora_{kind}_{run}_rank1.npz') as b:
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])


def test_serve_cli_tp2_matches_one_process(runs):
    """`cli.serve --tp 2` over JSONL: rank 0 writes the one-process CLI's
    lines (scores within 1e-4), the other rank writes nothing."""
    from evo_tpu_torch.cli import serve as serve_cli
    d, _, _ = runs
    single = d / 'serve_single.jsonl'
    serve_cli.main(SERVE + ['--requests-jsonl', str(d / 'requests.jsonl'),
                            '--output-jsonl', str(single)])
    want = [json.loads(ln) for ln in single.read_text().splitlines()]
    got = [json.loads(ln) for ln in
           (d / 'serve_tp2.jsonl').read_text().splitlines()]
    assert [g['id'] for g in got] == [0, 'b', 2, 3]
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != 'score'} == \
            {k: v for k, v in w.items() if k != 'score'}
        assert g['score'] == pytest.approx(w['score'], rel=1e-4, abs=1e-4)


@pytest.mark.parametrize('flag', ['tp2', 'dp2'])
def test_finetune_cli_lora_two_ranks(runs, flag):
    """`cli.finetune --lora-rank 2` under --tp 2 and --dp 2: the lead's log,
    one adapters.npz, per-rank train-state files, a serving checkpoint
    that loads in one process; under --tp 2 (the same windows as one
    process) the adapters within the training thresholds of the
    one-process CLI's."""
    from evo_tpu_torch.cli import finetune as finetune_cli
    from evo_tpu_torch.models import Evo
    d, _, got = runs
    logs = got[f'finetune_{flag}']
    assert 'step 2  loss' in logs[0] and 'done: 2 steps' in logs[0]
    assert 'loss' not in logs[1]
    save = d / f'ft_{flag}'
    assert sorted(p.name for p in (save / 'train_state').iterdir()) == [
        f'train_state.rank{r}.{ext}' for r in (0, 1)
        for ext in ('json', 'safetensors')]
    evo = Evo('evo-1-8k-base', 'cpu', checkpoint_path=str(save / 'serving'))
    logits = evo.model(torch.tensor([[1, 65, 67, 71]]))[0]
    assert bool(torch.isfinite(logits).all())
    one = d / 'ft_single'
    if not one.exists():
        finetune_cli.main(FINETUNE + ['--save-dir', str(one)])
    with np.load(save / 'adapters.npz') as a, \
            np.load(one / 'adapters.npz') as b:
        assert sorted(a.files) == sorted(b.files)
        if flag == 'tp2':
            _assert_adapters_close({k: a[k] for k in a.files},
                                   {k: b[k] for k in b.files})


if __name__ == '__main__':
    sys.path.insert(0, str(ROOT))
    _worker(sys.argv[1], sys.argv[2])
