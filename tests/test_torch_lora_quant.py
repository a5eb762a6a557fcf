"""LoRA over a quantized base (evo_tpu_torch/lora.py over quant.py) against
the JAX package's, on the CPU in float32 at a tiny config: the JAX
package's `quantize_params` in int8, in int8 with int8 activations
('int8x8') and in int4, its `attach_lora` and `next_token_loss` under
`value_and_grad`, and its `make_lora_train_step`; on the port's side the
same float32 weights through the reference-named state dict,
`quant.quantize_params`, the same adapters through
`checkpoint.lora_from_jax`, and `make_lora_train_step`.

Tolerances, by base, at 2 x 16 = 32 rows a projection:

  * int8 weight-only: both dequantize q * s in float32 and run float32
    products, so the loss agrees to 1e-5 relative and every adapter
    gradient to 1e-4 of its largest element (tests/test_torch_lora.py's
    bounds for a float base);
  * int8 x int8: the integer products are exact in both, the row scales
    equal, and x gets its gradient through the scales alone in both (the
    rounded codes carry none), so the same bounds;
  * int4: both round x to bf16 before the product. The JAX package on
    the CPU then dequantizes the weight to bf16 (q times the bf16 scale,
    rounded) before a float32-accumulated product; the port at up to 128
    rows takes kernel 8's plain version, which multiplies the codes by
    the float32 scale after each group's dot (the seam of ROADMAP §3,
    2e-2 at a projection). The gradient to x is rounded to bf16 at each
    int4 site in both, so a product a few 2^-9 apart turns roundings over
    and the adapters' gradients part by up to ~3e-2 of their largest
    element over the two layers: held to 6e-2; the loss to 1e-4.
    Above 128 rows (2 x 80) both dequantize to bf16 alike and a
    projection's gradient is bit-equal; the adapters' gradients then part
    only where a bf16 rounding of an activation turns over: 1e-2, the
    loss 1e-5.

The two AdamW steps run on the 2 x 80 batch in every mode, where all
bases agree closely: the losses to 1e-5 and the adapters as
tests/test_torch_lora.py holds them (every element within 6 lr, 99.9 %
within rtol 1e-5, atol 2e-6); int4's 95 % within the same (its
gradients part by up to 1e-2, as above, and the second Adam update
follows them).

Also: fresh adapters leave the loss bit-equal; the codes and scales are
bit-unchanged after the steps; `merge_lora` over a quantized base raises
and names the merge-then-quantize route; a decode step with adapters
attached raises and names it too; kernel 8's autograd Function (taken on
the CPU by patching the device check, the kernel replaced by its plain
version) gives the plain gradient and counts its launches.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from evo_tpu import checkpoint as jax_ckpt
from evo_tpu import lora as jax_lora
from evo_tpu import model as jax_model
from evo_tpu import quant as jax_quant
from evo_tpu import training as jax_training
from evo_tpu.config import tiny_config as jax_tiny_config
from evo_tpu_torch import lora, training
from evo_tpu_torch import model as model_lib
from evo_tpu_torch.checkpoint import lora_from_jax, params_from_state_dict
from evo_tpu_torch.config import tiny_config
from evo_tpu_torch.ops import _build
from evo_tpu_torch.ops import int4 as int4_ops
from evo_tpu_torch.quant import QuantizedWeight, quantize_params

torch.set_num_threads(2)
SMALL = dict(num_layers=2, attn_layer_idxs=(1,), hyena_layer_idxs=())
ALPHA = 8.0
LR = 1e-3
MODES = {'int8': dict(weight_quant='int8'),
         'int8x8': dict(weight_quant='int8', act_quant='int8'),
         'int4': dict(weight_quant='int4')}
# (loss rtol, gradient scaled error) at 32 rows: module docstring
TOL = {'int8': (1e-5, 1e-4), 'int8x8': (1e-5, 1e-4), 'int4': (1e-4, 6e-2)}


@pytest.fixture(scope='module')
def setup():
    jcfg = jax_tiny_config(**SMALL)
    params = jax.jit(jax_model.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)

    @jax.jit
    def make_adapters(params):
        adapters = jax_lora.init_lora(jax.random.PRNGKey(1), params, jcfg,
                                      rank=4)
        leaves, treedef = jax.tree_util.tree_flatten(adapters)
        keys = jax.random.split(jax.random.PRNGKey(7), len(leaves))
        return jax.tree_util.tree_unflatten(treedef, [
            x + 0.05 * jax.random.normal(k, x.shape, x.dtype)
            for x, k in zip(leaves, keys)])
    adapters = make_adapters(params)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 64, (2, 16)).astype(np.int32)
    mask = (rng.random((2, 16)) < 0.8).astype(np.float32)
    sd = jax_ckpt.export_state_dict(params, jcfg)
    return jcfg, params, adapters, sd, ids, mask


@pytest.fixture(scope='module')
def jax_runs(setup):
    """Per mode: the JAX first loss, adapter gradients and adapters after
    two train steps over the quantized base."""
    jcfg, params, adapters, _, ids, mask = setup
    long_ids, long_mask = _long_batch()
    out = {}
    for mode, ov in MODES.items():
        cfg = jcfg.replace(**ov)
        base = jax_quant.quantize_params(params, mode=ov['weight_quant'])
        loss, grads = jax.jit(jax.value_and_grad(
            lambda a, b: jax_training.next_token_loss(
                jax_lora.attach_lora(b, a, ALPHA), cfg, jnp.asarray(ids),
                jnp.asarray(mask))))(adapters, base)
        opt = jax_training.make_optimizer(learning_rate=LR)
        state = jax_lora.init_lora_train_state(adapters, opt)
        step = jax.jit(jax_lora.make_lora_train_step(cfg, opt, alpha=ALPHA))
        losses = []
        for _ in range(2):
            state, l = step(state, base, jnp.asarray(long_ids),
                            jnp.asarray(long_mask))
            losses.append(float(l))
        out[mode] = dict(loss=float(loss), grads=grads, losses=losses,
                         lora=state.lora)
    return out


def _long_batch():
    """2 x 80 tokens: 160 rows at every projection, past kernel 8's 128,
    where both packages dequantize int4 to bf16 before the product."""
    rng = np.random.default_rng(5)
    return (rng.integers(0, 64, (2, 80)).astype(np.int32),
            (rng.random((2, 80)) < 0.8).astype(np.float32))


def port(setup, mode):
    jcfg, _, adapters, sd, _, _ = setup
    cfg = tiny_config(**SMALL, **MODES[mode])
    model = params_from_state_dict(sd, cfg, 'cpu')
    model = quantize_params(model, free_source=True,
                            mode=MODES[mode]['weight_quant'])
    return model, lora_from_jax(adapters, cfg, 'cpu')


def scaled(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def codes(model):
    return {f'{n}.{b}': t.clone() for n, m in model.named_modules()
            if isinstance(m, QuantizedWeight)
            for b, t in m.named_buffers()}


@pytest.mark.parametrize('mode', list(MODES))
def test_logical_shapes_and_fresh_adapters(setup, mode):
    """init_lora reads the logical shapes of the quantized weights (the
    packed int4 codes pad the contraction to 256 rows), the adapters have
    the shapes of the float base's, and fresh ones (B = 0) leave the loss
    bit-equal."""
    jcfg, _, _, sd, ids, mask = setup
    model, _ = port(setup, mode)
    float_model = params_from_state_dict(sd, tiny_config(**SMALL), 'cpu')
    for blk, fblk in zip(model.blocks, float_model.blocks):
        for sub in ('mlp', 'attn', 'hyena'):
            for name, t in getattr(fblk, sub, torch.nn.Module()
                                   ).named_parameters():
                w = getattr(getattr(blk, sub), name)
                if isinstance(w, QuantizedWeight):
                    assert w.shape == tuple(t.shape), (sub, name)
    fresh = lora.init_lora(torch.Generator().manual_seed(3), model, rank=4)
    want = lora.init_lora(torch.Generator().manual_seed(3), float_model,
                          rank=4)
    for (n, a), (_, b) in zip(lora.named_adapters(fresh).items(),
                              lora.named_adapters(want).items()):
        assert torch.equal(a, b), n
    base = training.next_token_loss(model, None, ids, mask)
    lora.attach_lora(model, fresh, ALPHA)
    assert torch.equal(training.next_token_loss(model, None, ids, mask),
                       base)


@pytest.mark.parametrize('mode', list(MODES))
def test_loss_and_gradients_match_jax(setup, jax_runs, mode):
    _, _, _, _, ids, mask = setup
    loss_tol, grad_tol = TOL[mode]
    want_run = jax_runs[mode]
    model, ad = port(setup, mode)
    cfg = model.config
    named = lora.named_adapters(ad)
    training.set_trainable(named.values(), True)
    lora.attach_lora(model, ad, ALPHA)
    loss = training.next_token_loss(
        model, training.train_config(model, adapters=True), ids, mask)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want_run['loss'],
                               rtol=loss_tol)
    want = lora.named_adapters(lora_from_jax(want_run['grads'], cfg, 'cpu'))
    assert set(named) == set(want)
    for name, t in named.items():
        assert t.grad is not None and float(t.grad.abs().max()) > 0, name
        assert scaled(t.grad.numpy(), want[name].numpy()) <= grad_tol, name


@pytest.mark.parametrize('mode', list(MODES))
def test_train_steps_match_jax_and_leave_codes(setup, jax_runs, mode):
    ids, mask = _long_batch()
    want_run = jax_runs[mode]
    model, ad = port(setup, mode)
    before = codes(model)
    assert before and all(not t.requires_grad for t in before.values())
    opt = training.make_optimizer(learning_rate=LR)
    state = lora.init_lora_train_state(ad, opt)
    step = lora.make_lora_train_step(model, opt, alpha=ALPHA)
    losses = []
    for _ in range(2):
        state, loss = step(state, ids, mask)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, want_run['losses'], rtol=1e-5)
    after = codes(model)
    for n, t in before.items():
        assert torch.equal(t, after[n]), n
    assert not lora.attached(model)
    want = lora.named_adapters(lora_from_jax(want_run['lora'], model.config,
                                             'cpu'))
    close = []
    for name, m in lora.named_adapters(state.lora).items():
        err = np.abs(m.numpy() - want[name].numpy())
        assert err.max() <= 6 * LR, (name, err.max())
        close.append((err <= 2e-6 + 1e-5 * np.abs(want[name].numpy()))
                     .ravel())
    assert np.concatenate(close).mean() >= (0.95 if mode == 'int4'
                                            else 0.999)


def test_int4_above_128_rows_matches_jax_closely(setup):
    """At more than 128 rows both packages dequantize to bf16 before one
    float32-accumulated product: the float32 bounds hold."""
    jcfg, params, adapters, _, _, _ = setup
    ids, _ = _long_batch()
    cfg = jcfg.replace(weight_quant='int4')
    base = jax_quant.quantize_params(params, mode='int4')
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda a: jax_training.next_token_loss(
            jax_lora.attach_lora(base, a, ALPHA), cfg, jnp.asarray(ids))))(
        adapters)
    model, ad = port(setup, 'int4')
    named = lora.named_adapters(ad)
    training.set_trainable(named.values(), True)
    lora.attach_lora(model, ad, ALPHA)
    loss = training.next_token_loss(model, None, ids)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    want = lora.named_adapters(lora_from_jax(want_grads, model.config,
                                             'cpu'))
    for name, t in named.items():
        assert scaled(t.grad.numpy(), want[name].numpy()) <= 1e-2, name


@pytest.mark.parametrize('mode', ['int8', 'int4'])
def test_merge_and_decode_name_the_route(setup, mode):
    from evo_tpu_torch.generation import Generator
    from evo_tpu_torch.models import EvoModel
    from evo_tpu_torch.tokenizer import CharLevelTokenizer
    model, ad = port(setup, mode)
    with pytest.raises(ValueError, match='quantize_params'):
        lora.merge_lora(model, ad, ALPHA)
    with pytest.raises(ValueError, match='quantize_params'):
        lora.merge_lora(model, ad, ALPHA, donate=True)
    gen = Generator(EvoModel(model.config, model), CharLevelTokenizer(512),
                    top_k=1, temperature=0.0)
    lora.attach_lora(model, ad, ALPHA)
    with pytest.raises(RuntimeError, match='quantize_params'):
        gen.generate(input_ids=np.asarray([[65, 67, 71, 84]]), num_tokens=2)
    # the route that the messages name: merge into the float weights, then
    # quantize; the result decodes
    lora.detach_lora(model)
    float_model = params_from_state_dict(setup[3], tiny_config(**SMALL),
                                         'cpu')
    merged = quantize_params(lora.merge_lora(float_model, ad, ALPHA,
                                             donate=True), mode=mode)
    toks, logps, _ = Generator(EvoModel(model.config, merged),
                               CharLevelTokenizer(512), top_k=1,
                               temperature=0.0).generate(
        input_ids=np.asarray([[65, 67, 71, 84]]), num_tokens=2)
    assert tuple(toks.shape) == (1, 2) and np.isfinite(
        np.asarray(logps)).all()


def test_full_fine_tuning_still_refuses_a_quantized_base(setup):
    model, _ = port(setup, 'int8')
    with pytest.raises(ValueError, match='full fine-tuning'):
        training.make_train_step(model, training.make_optimizer())
    assert callable(lora.make_lora_train_step(model,
                                              training.make_optimizer()))


@pytest.fixture
def int4_kernel_route(monkeypatch):
    """The CPU on kernel 8's route: its device check accepts CPU tensors
    (the other kernels keep their plain versions) and the kernel is its
    plain version without autograd, each call counted under the counter
    it was given."""
    counts = {}

    def stand_in(x, packed, scales, out_dtype=torch.float32,
                 counter='int4_matmul'):
        counts[counter] = counts.get(counter, 0) + 1
        with torch.no_grad():
            return int4_ops.int4_matmul_plain(x, packed, scales, out_dtype)

    monkeypatch.setattr(_build, 'check_device',
                        lambda t, what: what == 'int4_matmul')
    monkeypatch.setattr(int4_ops, 'int4_matmul_kernel', stand_in)
    return counts


@pytest.mark.parametrize('M,K,out_dtype', [(1, 64, torch.float32),
                                           (2, 200, torch.bfloat16),
                                           (128, 256, torch.bfloat16)])
def test_int4_function_gives_the_plain_gradient(int4_kernel_route, M, K,
                                                out_dtype):
    from evo_tpu_torch.quant import quantize_weight_int4
    g = torch.Generator().manual_seed(M)
    qw = quantize_weight_int4(torch.randn(K, 48, generator=g), 1)
    x = torch.randn(M, K, generator=g).bfloat16().requires_grad_()
    gy = torch.randn(M, 48, generator=g).to(out_dtype)
    y = int4_ops.int4_matmul(x, qw.q4, qw.s4, out_dtype)
    assert int4_route_counts(int4_kernel_route) == (0, 1)
    assert y.grad_fn is not None
    (gx,) = torch.autograd.grad(y, x, gy)
    x2 = x.detach().requires_grad_()
    (want,) = torch.autograd.grad(int4_ops.int4_matmul_plain(
        x2, qw.q4, qw.s4, out_dtype), x2, gy)
    assert gx.dtype == torch.bfloat16 and torch.equal(gx, want)
    with torch.no_grad():
        int4_ops.int4_matmul(x, qw.q4, qw.s4, out_dtype)
    assert int4_route_counts(int4_kernel_route) == (1, 1)


def int4_route_counts(counts):
    return counts.get('int4_matmul', 0), counts.get('int4_matmul_grad', 0)


def test_int4_lora_step_on_the_kernel_route(setup, int4_kernel_route):
    """A LoRA step over int4 at 32 rows goes through kernel 8's Function
    at every int4 projection (no small grad batch is routed around the
    kernel), and trains as the plain route does."""
    _, _, _, _, ids, mask = setup
    model, ad = port(setup, 'int4')
    opt = training.make_optimizer(learning_rate=LR)
    state = lora.init_lora_train_state(ad, opt)
    state, loss = lora.make_lora_train_step(model, opt, alpha=ALPHA)(
        state, ids, mask)
    # 10 int4 projections over 2 layers, one launch each in the forward:
    # layer 0's in-projection reads the embedding, which needs no
    # gradient (the plain kernel), the other 9 read what the adapters
    # before them touched (the Function)
    assert int4_route_counts(int4_kernel_route) == (1, 9)
    plain_model, plain_ad = port(setup, 'int4')
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_build, 'check_device', lambda t, what: False)
        popt = training.make_optimizer(learning_rate=LR)
        pstate = lora.init_lora_train_state(plain_ad, popt)
        pstate, ploss = lora.make_lora_train_step(
            plain_model, popt, alpha=ALPHA)(pstate, ids, mask)
    assert torch.equal(loss, ploss)
    for (n, a), (_, b) in zip(lora.named_adapters(state.lora).items(),
                              lora.named_adapters(pstate.lora).items()):
        assert torch.equal(a, b), n
