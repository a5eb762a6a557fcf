"""The port's training (evo_tpu_torch/training.py) against the JAX
package's (evo_tpu/training.py), on the CPU in float32 at a small config,
on the weights of `evo_tpu.model.init_params` carried across by the
reference-named state dict, and the gradients of kernels 1-3:

  * next_token_loss with and without a mask (rtol 1e-5);
  * the gradient of every parameter against jax.grad (scaled error, the
    largest |difference| over the largest |JAX gradient| of the tensor,
    <= 1e-4);
  * the masters after 3 train steps against JAX's, with a constant rate
    and with warmup_cosine: 99.9 % of all elements within rtol 1e-5, atol
    2e-6 (a few float32 steps of the 1e-3 updates), and every element
    within 6x the peak rate (Adam's first updates are g / (|g| + eps) ~
    sign(g): where a gradient is near eps, float32 noise in it can turn an
    element's update around, by at most 2 lr a step);
  * warmup_cosine at every step and the global-norm clip below, at and
    above the norm against optax (rtol 1e-6), the decay mask by name
    against JAX's;
  * remat: the forward and the gradients bit-equal to the plain ones;
  * a saved train state resumes to the same next step, bit for bit;
  * the autograd Functions of kernels 1-3, built with the plain forward in
    the kernel's place: torch.autograd.gradcheck in float64, the
    attention backward over several row blocks, and on the kernel route
    (forced here with plain stand-ins that count their launches) a train
    step with its launches, under remat too, against the plain route (the
    masters' criterion above: the two routes add the same gradients in
    another order).
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from evo_tpu import checkpoint as jax_ckpt
from evo_tpu import model as jax_model
from evo_tpu import training as jax_training
from evo_tpu.config import tiny_config as jax_tiny_config
from evo_tpu_torch import model as model_lib
from evo_tpu_torch import training
from evo_tpu_torch.checkpoint import params_from_state_dict
from evo_tpu_torch.config import tiny_config
from evo_tpu_torch.ops import _build, fftconv
from evo_tpu_torch.ops import attention as attention_ops
from evo_tpu_torch.ops import fir_gate as fir_ops
from evo_tpu_torch.ops import rmsnorm as rmsnorm_ops
from evo_tpu_torch.ops.attention import (FlashAttentionFunction,
                                         attention_plain)
from evo_tpu_torch.ops.fir_gate import FirGateFunction, fir_gate_plain
from evo_tpu_torch.ops.rmsnorm import RMSNormFunction, rmsnorm_plain

torch.set_num_threads(2)
SMALL = dict(num_layers=3, hidden_size=32, num_attention_heads=2,
             attn_layer_idxs=(1,), hyena_layer_idxs=(0, 2),
             inner_mlp_size=48)


def by_port_name(tree, cfg):
    """A JAX parameter (or gradient) tree as {port parameter name: numpy},
    the Hyena runs unstacked."""
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


def assert_masters_close(got, want, peak):
    """Masters after a few Adam steps, by name: every element within 6x the
    peak rate and 99.9 % of all within rtol 1e-5, atol 2e-6 (see above)."""
    close = []
    for name, m in got.items():
        m = np.asarray(m, np.float32)
        w = np.asarray(want[name], np.float32)
        err = np.abs(m - w)
        assert err.max() <= 6 * peak, (name, err.max())
        close.append((err <= 2e-6 + 1e-5 * np.abs(w)).ravel())
    assert np.concatenate(close).mean() >= 0.999


def scaled(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope='module')
def small():
    jcfg = jax_tiny_config(**SMALL)
    params = jax.jit(jax_model.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 64, (2, 24)).astype(np.int32)
    mask = (rng.random((2, 24)) < 0.8).astype(np.float32)
    return jcfg, params, ids, mask


def port_model(jcfg, params, **overrides):
    cfg = tiny_config(**SMALL, **overrides)
    return params_from_state_dict(jax_ckpt.export_state_dict(params, jcfg),
                                  cfg, 'cpu')


@pytest.mark.parametrize('masked', [False, True], ids=['all', 'mask'])
def test_next_token_loss_matches_jax(small, masked):
    jcfg, params, ids, mask = small
    m = mask if masked else None
    want = jax_training.next_token_loss(params, jcfg, jnp.asarray(ids),
                                        None if m is None else jnp.asarray(m))
    got = training.next_token_loss(port_model(jcfg, params), None, ids, m)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_gradients_match_jax(small):
    """Every parameter's gradient, through an EvoModel-free module."""
    jcfg, params, ids, mask = small
    want = by_port_name(jax.jit(jax.grad(
        lambda p: jax_training.next_token_loss(
            p, jcfg, jnp.asarray(ids), jnp.asarray(mask))))(params), jcfg)
    model = port_model(jcfg, params)
    params_t = dict(model.named_parameters())
    training.set_trainable(params_t.values(), True)
    training.next_token_loss(model, None, ids, mask).backward()
    assert set(params_t) == set(want)
    for name, p in params_t.items():
        assert scaled(p.grad.numpy(), want[name]) <= 1e-4, name


@pytest.fixture(scope='module')
def jax_steps(small):
    """Masters after 3 JAX train steps, constant rate and warmup_cosine."""
    jcfg, params, ids, mask = small
    out = {}
    for label, lr in (('constant', 1e-3),
                      ('cosine', jax_training.warmup_cosine(
                          2e-3, total_steps=6, warmup_steps=2))):
        opt = jax_training.make_optimizer(learning_rate=lr)
        state = jax_training.init_train_state(params, opt)
        step = jax.jit(jax_training.make_train_step(jcfg, opt))
        losses = []
        for _ in range(3):
            state, loss = step(state, jnp.asarray(ids), jnp.asarray(mask))
            losses.append(float(loss))
        out[label] = (by_port_name(state.params, jcfg), losses)
    return out


@pytest.mark.parametrize('schedule', ['constant', 'cosine'])
def test_train_steps_match_jax(small, jax_steps, schedule):
    jcfg, params, ids, mask = small
    want, want_losses = jax_steps[schedule]
    lr = (1e-3 if schedule == 'constant' else
          training.warmup_cosine(2e-3, total_steps=6, warmup_steps=2))
    model = port_model(jcfg, params)
    opt = training.make_optimizer(learning_rate=lr)
    state = training.init_train_state(model, opt)
    step = training.make_train_step(model, opt)
    losses = []
    for _ in range(3):
        state, loss = step(state, ids, mask)
        losses.append(float(loss))
    assert state.step == 3
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    assert all(m.dtype == torch.float32 for m in state.params.values())
    assert_masters_close(state.params, want,
                         2e-3 if schedule == 'cosine' else 1e-3)
    # the model serves the masters between steps
    serving = training.serving_params(state, model)
    for name, p in model.named_parameters():
        assert torch.equal(p, state.params[name])
        assert torch.equal(serving[name], p) and serving[name].dtype == \
            p.dtype
    assert all(not p.requires_grad for p in model.parameters())


@pytest.mark.parametrize('total,warmup,frac', [
    (100, 10, 0.1), (5, None, 0.1), (37, 4, 0.0), (2, 5, 0.5)])
def test_warmup_cosine_matches_optax(total, warmup, frac):
    want = jax_training.warmup_cosine(1e-3, total, warmup, frac)
    got = training.warmup_cosine(1e-3, total, warmup, frac)
    assert got(0) == 0.0
    # optax evaluates in float32: near the end of a decay to 0 the cosine
    # loses relative precision there, so the floor is float32's at the peak
    for t in range(total + 3):
        np.testing.assert_allclose(got(t), float(want(t)), rtol=1e-6,
                                   atol=1e-6 * 1e-3, err_msg=str(t))


@pytest.mark.parametrize('where', ['below', 'at', 'above'])
def test_global_norm_clip_matches_optax(where):
    rng = np.random.default_rng(4)
    grads = [rng.normal(size=s).astype(np.float32)
             for s in ((3, 4), (5,), (2, 2, 2))]
    norm = float(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                             for g in grads)))
    max_norm = {'below': 2 * norm, 'at': np.float32(norm),
                'above': norm / 3}[where]
    clip = optax.clip_by_global_norm(float(max_norm))
    want, _ = clip.update([jnp.asarray(g) for g in grads], clip.init(None))
    got = [torch.from_numpy(g.copy()) for g in grads]
    n = training.clip_by_global_norm_(got, float(max_norm))
    np.testing.assert_allclose(float(n), norm, rtol=1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    if where == 'below':
        assert all(np.array_equal(g.numpy(), w) for g, w in zip(got, grads))


def test_decay_mask_matches_jax(small):
    """By name: poles and residues never decay; the 1-D tensors of a Hyena
    block decay because the JAX package stacks its runs."""
    jcfg, params, _, _ = small
    jmask = jax_training._decay_mask(params)
    want = {'embedding': jmask['embedding'],
            'final_norm.weight': jmask['final_norm']}
    for (kind, idxs), seg in zip(jcfg.layer_segments(), jmask['segments']):
        blk = seg['stack'] if kind == 'hyena' else seg
        for i in idxs:       # a stacked run has one flag a tensor
            for k in ('pre_norm', 'post_norm'):
                want[f'blocks.{i}.{k}.weight'] = blk[k]
            for sub in ('attn', 'hyena', 'mlp'):
                for k, v in blk.get(sub, {}).items():
                    want[f'blocks.{i}.{sub}.{k}'] = v
    masters = training.init_train_state(
        port_model(jcfg, params), training.make_optimizer()).params
    got = training.decay_mask(masters, tiny_config(**SMALL))
    assert got == {n: bool(v) for n, v in want.items()}
    assert not got['blocks.0.hyena.poles'] and got['blocks.0.hyena.d_skip']
    assert not got['blocks.1.attn.bo'] and got['blocks.1.attn.bqkv']
    assert not got['final_norm.weight'] and got['embedding']


def test_remat_forward_and_grads_equal_plain(small):
    jcfg, params, ids, mask = small
    model = port_model(jcfg, params)
    ps = list(model.parameters())
    out = []
    for remat in (False, True):
        cfg = model.config.replace(remat=remat)
        training.set_trainable(ps, True)
        logits = model_lib.forward(model, torch.as_tensor(ids).long(), cfg)
        logits.square().mean().backward()
        training.set_trainable(ps, False)
        out.append((logits.detach(), [p.grad for p in ps]))
        for p in ps:
            p.grad = None
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)
    with torch.no_grad():
        assert torch.equal(model_lib.forward(
            model, torch.as_tensor(ids).long(),
            model.config.replace(remat=True)), out[0][0])


def test_train_state_save_resume(small, tmp_path):
    """Save after step 1, restore into a fresh state and model, and the
    next step matches an uninterrupted run bit for bit."""
    jcfg, params, ids, mask = small
    opt = training.make_optimizer(learning_rate=1e-3)
    model = port_model(jcfg, params)
    step = training.make_train_step(model, opt)
    s1, _ = step(training.init_train_state(model, opt), ids, mask)
    training.save_train_state(s1, str(tmp_path))
    s2, loss = step(s1, ids, mask)
    fresh = port_model(jcfg, params)
    s1_re = training.load_train_state(
        str(tmp_path), training.init_train_state(fresh, opt))
    assert s1_re.step == 1
    s2_re, loss_re = training.make_train_step(fresh, opt)(s1_re, ids, mask)
    assert float(loss_re) == float(loss)
    for name in s2.params:
        assert torch.equal(s2.params[name], s2_re.params[name]), name
    with pytest.raises(ValueError, match='orbax'):
        training.load_train_state(str(tmp_path / 'nothing'), s1)


def test_train_step_guards(small):
    """Quantized models refuse; the kernels without a backward are turned
    off inside a step (a fused-mixer model trains as the plain one)."""
    from evo_tpu_torch.quant import quantize_params
    jcfg, params, ids, mask = small
    opt = training.make_optimizer()
    with pytest.raises(ValueError, match='float weights'):
        training.make_train_step(quantize_params(port_model(jcfg, params)),
                                 opt)
    from evo_tpu_torch.parallel.mesh import Mesh
    with pytest.raises(ValueError, match='not built on this mesh'):
        training.make_sharded_train_step(port_model(jcfg, params), opt,
                                         Mesh(1, 1, 1))
    losses = []
    for fused in (False, True):
        model = port_model(jcfg, params, hyena_fused_mixer=fused,
                           hyena_pallas_prefix=fused)
        state = training.init_train_state(model, opt)
        _, loss = training.make_train_step(model, opt)(state, ids, mask)
        losses.append(float(loss))
        assert model.config.hyena_fused_mixer == fused
    assert losses[0] == losses[1]


# ---------------------------------------------------------------------------
# The gradient Functions of kernels 1-3
# ---------------------------------------------------------------------------

def _f64(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g, dtype=torch.float64)


def test_rmsnorm_function_gradcheck():
    x, w = _f64(3, 5, 8).requires_grad_(), _f64(8, seed=1).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a, b: RMSNormFunction.apply(a, b, 1e-6, rmsnorm_plain),
        (x, w))


@pytest.mark.parametrize('tail', [False, True])
def test_fir_gate_function_gradcheck(tail):
    """z as the view of a (B, L, 3, C) tensor, as the kernel reads it; the
    taps, both biases and the tail."""
    B, L, C = 2, 6, 4
    zl = _f64(B, L, 3, C).requires_grad_()
    w, b, b_in = (_f64(3, C, 3, seed=1).requires_grad_(),
                  _f64(3, C, seed=2).requires_grad_(),
                  _f64(3, C, seed=3).requires_grad_())
    t = _f64(B, 3, C, 2, seed=4).requires_grad_() if tail else None
    inputs = (zl, w, b, b_in) + ((t,) if tail else ())

    def fn(zl, w, b, b_in, t=None):
        return FirGateFunction.apply(zl.permute(0, 2, 3, 1), w, b, t, b_in,
                                     fir_gate_plain)
    assert torch.autograd.gradcheck(fn, inputs)


def test_attention_function_gradcheck_over_row_blocks(monkeypatch):
    """The backward goes block of rows by block of rows; shrunk blocks (3
    rows of 11) take it over four of them, the last one ragged."""
    B, L, H, Dh = 1, 11, 2, 4
    monkeypatch.setattr(attention_ops, '_PLAIN_SCORE_BYTES', 4 * B * H * L * 3)
    assert attention_ops._block_rows(B, H, L) == 3
    qkv = _f64(B, L, 3, H, Dh).requires_grad_()

    def fn(qkv):
        return FlashAttentionFunction.apply(qkv[:, :, 0], qkv[:, :, 1],
                                            qkv[:, :, 2], attention_plain)
    assert torch.autograd.gradcheck(fn, (qkv,))
    g = _f64(B, L, H, Dh, seed=5)
    q, k, v = (qkv[:, :, i].detach() for i in range(3))
    want = torch.autograd.grad(attention_plain(*(
        t.requires_grad_() for t in (q, k, v))), (q, k, v), g)
    got = attention_ops.attention_plain_grads(q, k, v, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


@pytest.fixture
def kernel_route(monkeypatch):
    """Make the CPU take the kernel route of kernels 1-3 (their Functions
    under autograd), with the plain versions, run without autograd, in the
    kernels' place, each call counted as a launch."""
    counts = {}

    def stand_in(name, plain):
        def launch(*args):
            counts[name] = counts.get(name, 0) + 1
            with torch.no_grad():
                return plain(*args)
        return launch

    monkeypatch.setattr(_build, 'check_device',
                        lambda t, what: t.device.type == 'cpu')
    monkeypatch.setattr(rmsnorm_ops, 'rmsnorm_kernel',
                        stand_in('rmsnorm', rmsnorm_plain))
    monkeypatch.setattr(fir_ops, 'fir_gate_kernel',
                        stand_in('fir_gate', fir_gate_plain))
    monkeypatch.setattr(attention_ops, 'flash_attention_kernel',
                        stand_in('flash_attention', attention_plain))
    return counts


def test_kernel_wrappers_carry_gradients(kernel_route):
    """On the kernel route a wrapper's output has a grad_fn exactly when
    an input requires grad; the kernels without a backward refuse such an
    input."""
    from evo_tpu_torch.ops.hyena_mixer import hyena_mixer
    x, w = torch.randn(4, 8), torch.randn(8)
    assert rmsnorm_ops.rmsnorm(x, w).grad_fn is None
    assert rmsnorm_ops.rmsnorm(x, w.requires_grad_()).grad_fn is not None
    zl = torch.randn(1, 5, 3, 8, requires_grad=True)
    x2, u = fir_ops.fir_gate(zl.permute(0, 2, 3, 1), torch.randn(3, 8, 3))
    assert x2.grad_fn is not None and u.grad_fn is not None
    qkv = torch.randn(1, 5, 3, 2, 4)
    assert attention_ops.flash_attention_causal(
        *qkv.unbind(2)).grad_fn is None
    qkv.requires_grad_()
    assert attention_ops.flash_attention_causal(
        *qkv.unbind(2)).grad_fn is not None
    assert kernel_route == {'rmsnorm': 2, 'fir_gate': 1,
                            'flash_attention': 2}
    with pytest.raises(RuntimeError, match='no backward'):
        hyena_mixer(zl.permute(0, 2, 3, 1), torch.randn(3, 8, 3), None,
                    torch.randn(8, 2, 2), torch.randn(8, 2, 2),
                    torch.ones(8), chunk=4)


@pytest.mark.parametrize('remat', [False, True])
def test_kernel_route_train_step(small, kernel_route, monkeypatch, remat):
    """A train step through the Functions: the launches of a forward (two
    norms a block and the final one, FIR + gate a Hyena layer, attention
    an attention layer) and, under remat, as many again for the blocks'
    recompute; the masters within float32 rounding of the plain route."""
    jcfg, params, ids, mask = small
    opt = training.make_optimizer(learning_rate=1e-3)
    states = []
    for route in ('kernel', 'plain'):
        if route == 'plain':
            monkeypatch.setattr(_build, 'check_device',
                                lambda t, what: False)
        model = port_model(jcfg, params, remat=remat)
        state = training.init_train_state(model, opt)
        kernel_route.clear()
        state, _ = training.make_train_step(model, opt)(state, ids, mask)
        states.append((state, dict(kernel_route)))
    n = 2 if remat else 1
    assert states[0][1] == {'rmsnorm': 7 + 6 * (n - 1),
                            'fir_gate': 2 * n, 'flash_attention': n}
    assert states[1][1] == {}
    assert_masters_close(states[0][0].params, states[1][0].params, 1e-3)


@pytest.mark.parametrize('setting', ['high', 'medium'])
def test_long_conv_backward_keeps_full_float32(setting):
    """The conv's gradients are taken at the 'highest' float32 precision
    whatever the global setting, as its forward is."""
    g = torch.Generator().manual_seed(7)
    u = torch.randn(2, 16, 128, generator=g)
    poles = torch.rand(16, 4, 2, generator=g) * 0.6
    residues = torch.randn(16, 4, 2, generator=g)
    d = torch.randn(16, generator=g)
    gy = torch.randn(2, 16, 128, generator=g)
    before = torch.get_float32_matmul_precision()
    grads = []
    try:
        for prec in ('highest', setting):
            torch.set_float32_matmul_precision(prec)
            leaves = [t.clone().requires_grad_() for t in
                      (u, poles, residues, d)]
            y, _ = fftconv.conv_matmul_chunked(*leaves[:3], 64,
                                               d_skip=leaves[3])
            grads.append(torch.autograd.grad(y, leaves, gy))
            assert torch.get_float32_matmul_precision() == prec
    finally:
        torch.set_float32_matmul_precision(before)
    for a, b in zip(*grads):
        assert torch.equal(a, b)
