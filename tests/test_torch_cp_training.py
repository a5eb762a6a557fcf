"""Training under context parallelism (the full and the LoRA train steps of
evo_tpu_torch/training.py and lora.py on a mesh with cp > 1; the autograd
of the cp collectives in parallel/collectives.py and of ops/
ring_attention.py) against the JAX package's `jax.value_and_grad`, on the
CPU in float32 at the tiny config with `hyena_matmul_chunk=8`, L = 64, as
tests/test_parallel.py:107-117 builds it.

In gloo processes on the CPU, this file run as a script (it imports no JAX
then), once as cp = 2 on 2 ranks, once as cp = 2, tp = 2 on 4 and once as
dp = 2, cp = 2 on 4, against the JAX package unsharded on the same weights
(the tiny config's PRNGKey(0)) and batch:
  * under each cp_attn ('ulysses', 'ring', 'zigzag'), two
    `make_sharded_train_step` steps: the first loss (rtol 1e-5) against
    `jax.value_and_grad(next_token_loss)`, every parameter's gradient as
    the step sums it (tp shards gathered) within the scaled error of
    tests/test_torch_training.py (largest |difference| over largest |JAX
    gradient|) of 1e-4, both losses (rtol 1e-5) and the masters against
    JAX `make_train_step` by tests/test_torch_training.py's criterion (99.9
    % within rtol 1e-5, atol 2e-6, every element within 6 lr);
  * two `make_lora_train_step` steps under each cp_attn against JAX
    `make_lora_train_step` on adapters carried by `checkpoint.
    lora_from_jax`, with tests/test_torch_mesh_serving.py's thresholds;
  * a ragged L = 61 under Ulysses with remat: loss and gradients against
    JAX, and the Hyena long conv and the attention core run over the 61
    real positions alone, in the forward and in the recompute (the remat
    call passes the block's `seq_len`);
  * the gathered Ulysses fallback where cp does not divide a shard's heads
    (one head a tp shard): the gradients against JAX's at that config;
  * the ring and the zigzag ring's dq, dk, dv (and the ring's in query-row
    blocks of one row) against autograd through a dense causal attention
    over the whole sequence, in float64;
  * the adjoint identity <A x, y> = <x, A^T y> summed over the ranks for
    the all-to-all, `seq_to_heads` / `heads_to_seq` at B = 2 and
    `gather_seq` (whose adjoint is a reduce-scatter), in float64;
  * replicated masters and adapters bit-equal across the ranks that hold
    them; per-rank train-state files under the cp mesh that refuse
    another mesh.
"""

import os
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
MODES = ('ulysses', 'ring', 'zigzag')
L = 64
RAGGED = 61
LR = 1e-3
ALPHA, RANK = 8.0, 2
# launch -> (dp, cp, tp)
RUNS = {'cp2': (1, 2, 1), 'cp2tp2': (1, 2, 2), 'dp2cp2': (2, 2, 1)}
# the ring Functions' float64 probe: (B, L, H, Dh)
RING_SHAPE = (2, 16, 2, 4)


def _ranks(run):
    dp, cp, tp = RUNS[run]
    return dp * cp * tp


def _config(**kw):
    from evo_tpu_torch.config import tiny_config
    return tiny_config(hyena_matmul_chunk=8, **kw)


# ---------------------------------------------------------------------------
# The worker: `python tests/test_torch_cp_training.py <run> <dir>` as one
# rank of a launch (torchrun's environment); reads dir/ref.npz, writes
# dir/<run>_rank<r>.npz
# ---------------------------------------------------------------------------

def _port_model(sd, cfg, mesh):
    from evo_tpu_torch.checkpoint import params_from_state_dict
    from evo_tpu_torch.models import EvoModel
    return EvoModel(cfg, params_from_state_dict(dict(sd), cfg, 'cpu', mesh))


def _rows(ref, mesh, n=L):
    """This dp rank's rows of the batch, cut to n positions."""
    rows = (slice(mesh.index('dp'), mesh.index('dp') + 1) if mesh.dp > 1
            else slice(None))
    return ref['ids'][rows, :n], ref['mask'][rows, :n]


def _full_steps(sd, cfg, mesh, ref, out, key, n=L, steps=2):
    """`steps` sharded steps on this dp rank's rows: the losses, the first
    step's gradients as the step sums them, the masters after."""
    from evo_tpu_torch import training
    from evo_tpu_torch.tools.cp_train_smoke import Recording
    model = _port_model(sd, cfg, mesh)
    opt = Recording(learning_rate=LR)
    state = training.init_train_state(model, opt)
    step = training.make_sharded_train_step(model, opt, mesh)
    ids, mask = _rows(ref, mesh, n)
    losses = []
    for _ in range(steps):
        state, loss = step(state, ids, mask)
        losses.append(float(loss))
    out[f'{key}/losses'] = np.asarray(losses)
    for name, g in opt.grads.items():
        out[f'{key}/g/{name}'] = g.numpy()
    for name, m in state.params.items():
        out[f'{key}/m/{name}'] = m.numpy()
    return model, opt, state


def _lora_steps(sd, ref, cfg, mesh, out, key):
    from evo_tpu_torch import lora, training
    model = _port_model(sd, cfg, mesh)
    adapters = lora.init_lora(torch.Generator().manual_seed(0), model, RANK)
    with torch.no_grad():
        for name, t in lora.named_adapters(adapters).items():
            t.copy_(torch.from_numpy(ref['lora/' + name]))
    before = {n: p.clone() for n, p in model.module.named_parameters()}
    opt = training.make_optimizer(learning_rate=LR)
    state = lora.init_lora_train_state(adapters, opt)
    step = lora.make_lora_train_step(model, opt, alpha=ALPHA)
    ids, mask = _rows(ref, mesh)
    losses = []
    for _ in range(2):
        state, loss = step(state, ids, mask)
        losses.append(float(loss))
    out[f'{key}/losses'] = np.asarray(losses)
    out[f'{key}/base_unchanged'] = np.asarray(all(
        torch.equal(p, before[n]) for n, p in model.module.named_parameters()))
    for name, t in lora.named_adapters(state.lora).items():
        out[f'{key}/a/{name}'] = t.numpy()


def _ragged_remat(sd, mesh, ref, out):
    """Ulysses at L = 61 under remat, with the lengths the Hyena long conv
    and the attention core ran over."""
    from evo_tpu_torch.layers import attention as attention_layer
    from evo_tpu_torch.ops import fftconv
    seen = []
    conv, core = fftconv.conv_matmul_chunked, \
        attention_layer.flash_attention_causal

    def conv_spy(u, *a, **k):
        seen.append(u.shape[-1])
        return conv(u, *a, **k)

    def core_spy(q, k, v):
        seen.append(q.shape[1])
        return core(q, k, v)
    fftconv.conv_matmul_chunked = conv_spy
    attention_layer.flash_attention_causal = core_spy
    try:
        _full_steps(sd, _config(remat=True), mesh, ref, out, 'ragged',
                    n=RAGGED, steps=1)
    finally:
        fftconv.conv_matmul_chunked = conv
        attention_layer.flash_attention_causal = core
    out['ragged/lengths'] = np.asarray(seen)


def _ring_grads(mesh, out):
    """dq, dk, dv of this rank's rows through the ring Functions, float64."""
    from evo_tpu_torch.ops import ring_attention
    from evo_tpu_torch.parallel.collectives import split_seq
    rng = np.random.default_rng(5)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(RING_SHAPE))
                  for _ in range(4))
    n = RING_SHAPE[1]
    for name, fn, score_bytes in (
            ('ring', ring_attention.ring_attention, None),
            ('ring_rows', ring_attention.ring_attention, 1),
            ('zigzag', ring_attention.zigzag_ring_attention, None)):
        keep = ring_attention.SCORE_BYTES
        if score_bytes is not None:
            ring_attention.SCORE_BYTES = score_bytes   # one query row a block
        try:
            leaves = [split_seq(t, mesh).clone().requires_grad_()
                      for t in (q, k, v)]
            y = fn(*leaves, mesh, n)
            grads = torch.autograd.grad(y, leaves, split_seq(g, mesh))
        finally:
            ring_attention.SCORE_BYTES = keep
        out[f'fn/{name}/out'] = y.detach().numpy()
        for label, t in zip(('dq', 'dk', 'dv'), grads):
            out[f'fn/{name}/{label}'] = t.numpy()


def _adjoints(mesh, out):
    """<A x, y> and <x, A^T y>, each summed over the cp ranks, for the
    all-to-all, the Ulysses reshards at B = 2 and the sequence gather."""
    from evo_tpu_torch.parallel import collectives as c
    cp = mesh.cp
    rng = np.random.default_rng(100 + mesh.rank)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape))
    cases = (
        ('all_to_all', (cp, 2, 3, 4), (cp, 2, 3, 4),
         lambda x: c.all_to_all(x, mesh)),
        ('seq_to_heads', (2, 3, 2 * cp, 5), (2, 3 * cp, 2, 5),
         lambda x: c.seq_to_heads(x, mesh, 2)),
        ('heads_to_seq', (2, 3 * cp, 2, 5), (2, 3, 2 * cp, 5),
         lambda x: c.heads_to_seq(x, mesh, 2)),
        ('gather_seq', (2, 3, 4), (2, 3 * cp, 4),
         lambda x: c.gather_seq(x, mesh)))
    for name, xs, ys, fn in cases:
        x = randn(*xs).requires_grad_()
        y = randn(*ys)
        ax = fn(x)
        aty, = torch.autograd.grad(ax, x, y)
        pair = torch.stack([(ax * y).sum(), (x * aty).sum()]).detach()
        out[f'adjoint/{name}'] = c.all_reduce_sum(pair, mesh, 'cp').numpy()


def _state_files(state, model, mesh, d, out):
    from evo_tpu_torch import training
    from evo_tpu_torch.parallel.mesh import Mesh
    path = os.path.join(d, f'state_{mesh.dp}{mesh.cp}{mesh.tp}')
    training.save_train_state(state, path, mesh)
    # every rank's pair written before any rank reads the directory: the
    # refusal without a mesh lists the files it found
    torch.distributed.barrier()
    again = training.load_train_state(path, training.init_train_state(
        model, training.make_optimizer(learning_rate=LR)), mesh)
    out['state/round_trip'] = np.asarray(again.step == state.step and all(
        torch.equal(again.params[n], m) for n, m in state.params.items()))
    flat = Mesh(mesh.size, 1, 1, rank=mesh.rank)
    for key, other in (('state/no_mesh', None), ('state/other_mesh', flat)):
        try:
            training.load_train_state(path, state, other)
            out[key] = np.asarray('loaded')
        except ValueError as e:
            out[key] = np.asarray(str(e))


def _worker(run: str, d: str) -> None:
    from evo_tpu_torch.parallel import distributed
    from evo_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    distributed.initialize_distributed(device='cpu')
    dp, cp, tp = RUNS[run]
    mesh = make_mesh(dp=dp, cp=cp, tp=tp)
    ref = np.load(os.path.join(d, 'ref.npz'))
    sd = {k[3:]: ref[k] for k in ref.files if k.startswith('sd/')}
    out = {}
    for attn in MODES:
        model, _, state = _full_steps(sd, _config(cp_attn=attn), mesh, ref,
                                      out, attn)
        if attn == 'ulysses':
            _state_files(state, model, mesh, d, out)
        _lora_steps(sd, ref, _config(cp_attn=attn), mesh, out,
                    f'lora_{attn}')
    _ragged_remat(sd, mesh, ref, out)
    # Ulysses where cp does not divide a tp shard's heads (one a shard)
    heads = {k[len('sd_heads/'):]: ref[k] for k in ref.files
             if k.startswith('sd_heads/')}
    _full_steps(heads, _config(num_attention_heads=tp), mesh, ref, out,
                'heads', steps=1)
    _ring_grads(mesh, out)
    _adjoints(mesh, out)
    np.savez(os.path.join(d, f'{run}_rank{mesh.rank}.npz'), **out)


# ---------------------------------------------------------------------------
# JAX references (this process)
# ---------------------------------------------------------------------------

def _launch(argv, d, nprocs, timeout=300):
    from evo_tpu_torch.parallel.distributed import launch_local
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        [str(ROOT)] + ([env['PYTHONPATH']] if env.get('PYTHONPATH') else []))
    env.pop('XLA_FLAGS', None)
    env['OMP_NUM_THREADS'] = '1'      # ranks beside the other test workers
    return launch_local(argv, nprocs, env=env, timeout=timeout,
                        log_dir=str(d))


def _by_port_name(tree, cfg):
    """A JAX parameter (or gradient) tree as {port parameter name: numpy},
    the Hyena runs unstacked."""
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
def runs(tmp_path_factory):
    """The JAX package's losses, gradients and steps on the tiny config's
    PRNGKey(0) weights, computed while the launches run; then every
    launch's results."""
    import jax
    import jax.numpy as jnp
    from evo_tpu import checkpoint as jax_ckpt
    from evo_tpu import lora as jax_lora
    from evo_tpu import model as jax_model
    from evo_tpu import training as jax_training
    from evo_tpu.config import tiny_config
    from evo_tpu_torch import lora
    from evo_tpu_torch.checkpoint import lora_from_jax

    d = tmp_path_factory.mktemp('cp_training')
    jcfg = tiny_config(hyena_matmul_chunk=8, use_pallas='never')
    params = jax.jit(jax_model.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    hcfg = {tp: jcfg.replace(num_attention_heads=tp)
            for tp in {t for _, _, t in RUNS.values()}}
    hparams = {tp: jax.jit(jax_model.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), c) for tp, c in hcfg.items()}

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
    rng = np.random.default_rng(17)
    want = {'ids': rng.integers(0, 512, (2, L)).astype(np.int32),
            'mask': (rng.random((2, L)) < 0.8).astype(np.float32)}
    for k, v in jax_ckpt.export_state_dict(params, jcfg).items():
        want['sd/' + k] = np.asarray(v)
    for name, t in lora.named_adapters(lora_from_jax(
            adapters, _config(), 'cpu')).items():
        want['lora/' + name] = t.numpy()
    launches = {}
    for run in RUNS:
        _, _, tp = RUNS[run]
        ref = dict(want)
        for k, v in jax_ckpt.export_state_dict(hparams[tp],
                                               hcfg[tp]).items():
            ref['sd_heads/' + k] = np.asarray(v)
        os.makedirs(d / run)
        np.savez(d / run / 'ref.npz', **ref)
    got, errors = {}, []

    def launch(run):
        try:
            _launch([__file__, run, str(d / run)], d / run, _ranks(run))
            got[run] = [dict(np.load(d / run / f'{run}_rank{r}.npz'))
                        for r in range(_ranks(run))]
        except Exception as e:      # raised again in the test process
            errors.append(e)
    threads = [threading.Thread(target=launch, args=(r,)) for r in RUNS]
    for t in threads:
        t.start()

    def loss_and_grads(p, c, n=L):
        fn = jax.jit(jax.value_and_grad(
            lambda p, ids, mask: jax_training.next_token_loss(p, c, ids,
                                                              mask)))
        loss, grads = fn(p, jnp.asarray(want['ids'][:, :n]),
                         jnp.asarray(want['mask'][:, :n]))
        return float(loss), _by_port_name(grads, c)

    want['loss'], want['grads'] = loss_and_grads(params, jcfg)
    want['ragged_loss'], want['ragged_grads'] = loss_and_grads(
        params, jcfg, RAGGED)
    for tp in hcfg:
        want[f'heads{tp}_loss'], want[f'heads{tp}_grads'] = loss_and_grads(
            hparams[tp], hcfg[tp])
    opt = jax_training.make_optimizer(learning_rate=LR)
    state = jax_training.init_train_state(params, opt)
    step = jax.jit(jax_training.make_train_step(jcfg, opt))
    losses = []
    for _ in range(2):
        state, loss = step(state, jnp.asarray(want['ids']),
                           jnp.asarray(want['mask']))
        losses.append(float(loss))
    want['losses'] = np.asarray(losses)
    want['masters'] = _by_port_name(state.params, jcfg)
    lstate = jax_lora.init_lora_train_state(adapters, opt)
    lstep = jax.jit(jax_lora.make_lora_train_step(jcfg, opt, alpha=ALPHA))
    losses = []
    for _ in range(2):
        lstate, loss = lstep(lstate, params, jnp.asarray(want['ids']),
                             jnp.asarray(want['mask']))
        losses.append(float(loss))
    want['lora_losses'] = np.asarray(losses)
    want['lora_trained'] = {
        n: t.numpy() for n, t in lora.named_adapters(lora_from_jax(
            jax.device_get(lstate.lora), _config(), 'cpu')).items()}
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return want, got


def _scaled(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _whole(ranks, run, key, name):
    """A tensor of the first dp and cp rank's tp group, shards gathered."""
    from evo_tpu_torch.parallel.sharding import tp_axis
    _, _, tp = RUNS[run]
    shards = [ranks[t][f'{key}/{name}'] for t in range(tp)]
    axis = tp_axis(name) if tp > 1 else None
    return shards[0] if axis is None else np.concatenate(shards, axis=axis)


def _assert_close(got, want):
    """tests/test_torch_training.py's thresholds: 99.9 % of all elements
    within rtol 1e-5, atol 2e-6, and every one within 6 lr."""
    close = []
    for name, w in want.items():
        err = np.abs(got[name] - w)
        assert err.max() <= 6 * LR, (name, err.max())
        close.append((err <= 2e-6 + 1e-5 * np.abs(w)).ravel())
    assert np.concatenate(close).mean() >= 0.999


@pytest.mark.parametrize('run,attn', [(r, a) for r in RUNS for a in MODES])
def test_first_loss_and_gradients_match_jax(runs, run, attn):
    """The first step's loss against `jax.value_and_grad`, and every
    parameter's gradient as the step sums it over cp (and dp), tp shards
    gathered, within the scaled error 1e-4."""
    want, got = runs
    for r in got[run]:
        np.testing.assert_allclose(r[f'{attn}/losses'][0], want['loss'],
                                   rtol=1e-5)
    grads = want['grads']
    assert {k[len(f'{attn}/g/'):] for k in got[run][0]
            if k.startswith(f'{attn}/g/')} == set(grads)
    for name, w in grads.items():
        assert _scaled(_whole(got[run], run, f'{attn}/g', name), w) <= 1e-4, \
            name


@pytest.mark.parametrize('run,attn', [(r, a) for r in RUNS for a in MODES])
def test_two_steps_match_jax(runs, run, attn):
    """Two sharded steps against JAX `make_train_step`: both losses and the
    masters after (shards gathered)."""
    want, got = runs
    for r in got[run]:
        np.testing.assert_allclose(r[f'{attn}/losses'], want['losses'],
                                   rtol=1e-5)
    _assert_close({n: _whole(got[run], run, f'{attn}/m', n)
                   for n in want['masters']}, want['masters'])


@pytest.mark.parametrize('run,attn', [(r, a) for r in RUNS for a in MODES])
def test_lora_steps_match_jax(runs, run, attn):
    """Two LoRA steps against JAX `make_lora_train_step` on the same
    adapters: losses, adapters; the base weights unchanged."""
    want, got = runs
    key = f'lora_{attn}'
    for r in got[run]:
        np.testing.assert_allclose(r[f'{key}/losses'], want['lora_losses'],
                                   rtol=1e-5)
        assert bool(r[f'{key}/base_unchanged'])
        _assert_close({n: r[f'{key}/a/{n}'] for n in want['lora_trained']},
                      want['lora_trained'])


@pytest.mark.parametrize('run', list(RUNS))
def test_ragged_length_under_remat(runs, run):
    """L = 61 under Ulysses with remat (padded to 62 inside the model):
    loss and gradients against JAX at 61, and the long conv and the
    attention core ran over the 61 real positions, forward and
    recompute."""
    want, got = runs
    for r in got[run]:
        np.testing.assert_allclose(r['ragged/losses'][0], want['ragged_loss'],
                                   rtol=1e-5)
        lengths = r['ragged/lengths']
        assert len(lengths) and set(lengths.tolist()) == {RAGGED}, lengths
    for name, w in want['ragged_grads'].items():
        assert _scaled(_whole(got[run], run, 'ragged/g', name), w) <= 1e-4, \
            name


@pytest.mark.parametrize('run', list(RUNS))
def test_ulysses_fallback_gradients_match_jax(runs, run):
    """One head a tp shard, which cp = 2 does not divide: Ulysses gathers
    the sequence, and the gather's reduce-scatter adjoint gives JAX's
    gradients."""
    want, got = runs
    tp = RUNS[run][2]
    for r in got[run]:
        np.testing.assert_allclose(r['heads/losses'][0],
                                   want[f'heads{tp}_loss'], rtol=1e-5)
    for name, w in want[f'heads{tp}_grads'].items():
        assert _scaled(_whole(got[run], run, 'heads/g', name), w) <= 1e-4, \
            name


def _dense_grads(q, k, v, g):
    """Causal attention's output and its dq, dk, dv by autograd, float64."""
    q, k, v = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    s = torch.einsum('blhd,bmhd->bhlm', q, k) / np.sqrt(q.shape[-1])
    n = q.shape[1]
    s = s.masked_fill(torch.ones(n, n, dtype=torch.bool).triu(1),
                      float('-inf'))
    y = torch.einsum('bhlm,bmhd->blhd', torch.softmax(s, dim=-1), v)
    return (y.detach().numpy(),
            *(t.numpy() for t in torch.autograd.grad(
                y, (q, k, v), torch.from_numpy(g))))


@pytest.mark.parametrize('run', list(RUNS))
def test_ring_functions_match_dense_autograd(runs, run):
    """The ring's and the zigzag ring's hand-written backward (the ring's
    also in query-row blocks of one row): each cp rank's rows of dq, dk,
    dv against autograd through a dense causal attention over the whole
    sequence, float64."""
    rng = np.random.default_rng(5)
    q, k, v, g = (rng.standard_normal(RING_SHAPE) for _ in range(4))
    want = dict(zip(('out', 'dq', 'dk', 'dv'), _dense_grads(q, k, v, g)))
    _, cp, tp = RUNS[run]
    n = RING_SHAPE[1] // cp
    for rank, r in enumerate(runs[1][run]):
        c = (rank // tp) % cp
        for name in ('ring', 'ring_rows', 'zigzag'):
            for key, w in want.items():
                np.testing.assert_allclose(
                    r[f'fn/{name}/{key}'], w[:, c * n:(c + 1) * n],
                    rtol=1e-10, atol=1e-12, err_msg=f'{name} {key}')


@pytest.mark.parametrize('run', list(RUNS))
def test_collectives_adjoint_identity(runs, run):
    """<A x, y> = <x, A^T y> summed over the cp ranks for the all-to-all,
    the Ulysses reshards and the sequence gather."""
    for r in runs[1][run]:
        for name in ('all_to_all', 'seq_to_heads', 'heads_to_seq',
                     'gather_seq'):
            lhs, rhs = r[f'adjoint/{name}']
            assert lhs != 0.0
            np.testing.assert_allclose(lhs, rhs, rtol=1e-12, err_msg=name)


@pytest.mark.parametrize('run', list(RUNS))
def test_replicas_bit_equal(runs, run):
    """Every master and adapter after the steps, and every summed
    gradient, bit-equal on the ranks that hold the same tp shard (all cp
    and dp ranks of a tp index)."""
    ranks = runs[1][run]
    tp = RUNS[run][2]
    for rank, r in enumerate(ranks):
        first = ranks[rank % tp]
        assert set(r) == set(first)
        for k, v in first.items():
            if k.split('/')[0] not in ('fn', 'adjoint'):   # each rank's own
                np.testing.assert_array_equal(r[k], v, err_msg=k)


@pytest.mark.parametrize('run', list(RUNS))
def test_train_state_files_per_rank(runs, run):
    for r in runs[1][run]:
        assert bool(r['state/round_trip'])
        assert 'saved under mesh' in str(r['state/other_mesh'])
        assert 'no train state of evo_tpu_torch for mesh None' in str(
            r['state/no_mesh'])


if __name__ == '__main__':
    sys.path.insert(0, str(ROOT))
    _worker(sys.argv[1], sys.argv[2])
