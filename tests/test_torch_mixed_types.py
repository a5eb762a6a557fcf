"""Mixed parameter and activation types in the port: float32 weights
(`param_dtype='float32'`) under bf16 activations (`compute_dtype=
'bfloat16'`), against the JAX package with the same two fields, on the
CPU at the tiny config, the weights carried across by the reference-named
state dict (in float32).

Both packages keep every weight in float32, cast each projection weight
into bf16 at its site (`wcast`), round the attention and Hyena biases to
bf16 before adding them, read the RMSNorm gain, the FIR taps and bias and
d_skip in float32 inside kernels 1, 2 and 6 and their plain versions, and
make the caches in bf16. What is compared, and within what:

  * forward logits, prefill + decode logits, an int8-quantized forward:
    3e-2 absolute, the JAX tests' bf16 tolerance (the packages' float32
    sums run in other orders and bf16 roundings then fall apart; the
    all-bf16 port stands as far from the all-bf16 JAX package), with the
    argmax agreeing at >= 0.95 of the positions;
  * `score_sequences`: 2e-3 absolute (a mean of log-probs: the logits'
    noise averages out);
  * int8 codes from float32 weights: equal; scales within 1 ulp, as
    tests/test_torch_quant.py holds them;
  * one full train step (loss and masters) and one LoRA step (loss and
    adapters): loss rtol 2e-3; masters and adapters as
    tests/test_torch_training.py holds them, every element within the
    Adam update's 2 lr plus the masters' own rounding, 98 % within rtol
    1e-5, atol 2e-6 (in bf16 activations a gradient near zero may turn
    sign, and Adam's first update is ~lr sign(g));
  * kernels 1, 2 and 6 with float32 weights, the port's plain versions
    against the JAX Pallas kernels in interpret mode: RMSNorm 2e-2 (one
    bf16 step, tests/test_torch_kernels.py), FIR + gate bit-equal (both
    sum the float32 products in tap order and round once), the fused
    mixer 3e-2 (tests/test_torch_fused.py's bf16 tolerance), and that a
    float32 weight is read as stored, not rounded first;
  * float32 parameters holding bf16 values give logits bit-equal to the
    bf16 model's: every cast meets the same values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evo_tpu import checkpoint as jax_ckpt
from evo_tpu import lora as jax_lora
from evo_tpu import model as jax_model
from evo_tpu import quant as jax_quant
from evo_tpu import training as jax_training
from evo_tpu.config import tiny_config as jax_tiny_config
from evo_tpu.ops.pallas_fir import fir_gate_pallas
from evo_tpu.ops.pallas_hyena import hyena_mixer_pallas
from evo_tpu.ops.pallas_rmsnorm import rmsnorm_pallas
from evo_tpu_torch import checkpoint as ckpt
from evo_tpu_torch import lora, training
from evo_tpu_torch import model as model_lib
from evo_tpu_torch.config import tiny_config
from evo_tpu_torch.models import EvoModel
from evo_tpu_torch.ops.fir_gate import fir_gate_plain
from evo_tpu_torch.ops.hyena_mixer import hyena_mixer_plain
from evo_tpu_torch.ops.rmsnorm import rmsnorm_plain
from evo_tpu_torch.quant import quantize_params
from evo_tpu_torch.scoring import score_sequences
from evo_tpu_torch.tokenizer import CharLevelTokenizer

torch.set_num_threads(2)
MIXED = dict(param_dtype='float32', compute_dtype='bfloat16')
BF16 = dict(param_dtype='bfloat16', compute_dtype='bfloat16')
LOGIT_TOL = 3e-2
LR = 1e-3


@pytest.fixture(scope='module')
def setup():
    jcfg = jax_tiny_config(**MIXED)
    params = jax.jit(jax_model.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    sd = jax_ckpt.export_state_dict(params, jcfg)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 512, (2, 40)).astype(np.int32)
    return jcfg, params, sd, ids


def port(sd, **over):
    cfg = tiny_config(**MIXED, **over)
    return ckpt.params_from_state_dict(sd, cfg, 'cpu')


def fwd(model, ids):
    return model_lib.forward(model, torch.as_tensor(ids).long()).numpy()


def assert_logits_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.95


def test_weights_load_in_param_dtype_and_caches_in_compute_dtype(setup):
    jcfg, params, sd, _ = setup
    model = port(sd)
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert all(str(v.dtype) == 'float32' for v in sd.values())
    cache = model_lib.init_cache(model.config, 2, 16, 'cpu')
    jcache = jax_model.init_cache(jcfg, 2, 16)
    for got, want in zip(ckpt.cache_to_jax(cache, model.config)['layers'],
                         jcache['layers']):
        got = got.values() if isinstance(got, dict) else got
        want = want.values() if isinstance(want, dict) else want
        for g, w in zip(got, want):
            assert str(g.dtype) == str(w.dtype) and g.shape == w.shape
    assert cache['layers'][0].fir.dtype == torch.bfloat16


def test_forward_matches_jax(setup):
    jcfg, params, sd, ids = setup
    want = np.asarray(jax_model.forward(params, jcfg, jnp.asarray(ids)))
    got = fwd(port(sd), ids)
    assert_logits_close(got, want)


def test_score_sequences_match_jax(setup):
    from evo_tpu.scoring import score_sequences as jax_score
    from evo_tpu.models import EvoModel as JaxEvoModel
    from evo_tpu.tokenizer import CharLevelTokenizer as JaxTok
    jcfg, params, sd, _ = setup
    seqs = ['ACGTACGTTTGACA' * 3, 'GATTACA' * 5, 'ACG']
    want = jax_score(seqs, JaxEvoModel(jcfg, params), JaxTok(512))
    model = EvoModel(tiny_config(**MIXED), port(sd))
    got = score_sequences(seqs, model, CharLevelTokenizer(512))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)


def test_prefill_and_decode_match_jax(setup):
    jcfg, params, sd, ids = setup
    model = EvoModel(tiny_config(**MIXED), port(sd))
    steps = np.random.default_rng(1).integers(0, 512, (3, 2)).astype(
        np.int32)
    jcache = jax_model.init_cache(jcfg, 2, 48)
    want, jcache = jax_model.prefill(params, jcfg, jnp.asarray(ids), jcache)
    cache = model.initialize_inference_params(2, 48)
    got, cache = model(ids, inference_params_dict=cache)
    assert_logits_close(got.numpy(), np.asarray(want))
    for tok in steps:
        want, jcache = jax_model.decode_step(params, jcfg, jnp.asarray(tok),
                                             jcache)
        got, cache = model(tok[:, None], inference_params_dict=cache)
        assert_logits_close(got[:, 0].numpy(), np.asarray(want))


def test_int8_quantized_forward_matches_jax(setup):
    jcfg, params, sd, ids = setup
    jcfg8 = jcfg.replace(weight_quant='int8')
    q = jax_quant.quantize_params(params)
    want = np.asarray(jax_model.forward(q, jcfg8, jnp.asarray(ids)))
    model = quantize_params(port(sd, weight_quant='int8'), mode='int8')
    jax_w1 = jax_model.layer_blocks(q, jcfg)[0]['mlp']['w1']
    np.testing.assert_array_equal(model.blocks[0].mlp.w1.q.numpy(),
                                  np.asarray(jax_w1['q']))
    np.testing.assert_array_max_ulp(model.blocks[0].mlp.w1.s.numpy(),
                                    np.asarray(jax_w1['s']), maxulp=1)
    assert_logits_close(fwd(model, ids), want)


def test_float32_weights_with_bf16_values_are_bit_equal_to_bf16():
    jcfg16 = jax_tiny_config(**BF16)
    sd16 = jax_ckpt.export_state_dict(jax_model.init_params(
        jax.random.PRNGKey(3), jcfg16), jcfg16)
    m16 = ckpt.params_from_state_dict(sd16, tiny_config(**BF16), 'cpu')
    m32 = ckpt.params_from_state_dict(ckpt.state_dict(m16),
                                      tiny_config(**MIXED), 'cpu')
    ids = np.random.default_rng(4).integers(0, 512, (2, 37))
    assert np.array_equal(fwd(m32, ids), fwd(m16, ids))
    # and the weights are read as stored: moving one float32 gain by less
    # than half a bf16 step moves the logits
    with torch.no_grad():
        m32.final_norm.weight.mul_(1 + 2 ** -10)
    assert not np.array_equal(fwd(m32, ids), fwd(m16, ids))


def test_native_checkpoint_keeps_float32_weights(setup, tmp_path):
    _, _, sd, ids = setup
    model = port(sd)
    ckpt.save_native(model, str(tmp_path / 'ck'), model.config)
    back = ckpt.load_params_auto(str(tmp_path / 'ck'), model.config, 'cpu')
    for (n, a), (_, b) in zip(model.named_parameters(),
                              back.named_parameters()):
        assert b.dtype == torch.float32 and torch.equal(a, b), n
    assert np.array_equal(fwd(back, ids), fwd(model, ids))


def _by_port_name(tree, cfg):
    """A JAX parameter tree as {port parameter name: numpy}, the Hyena
    runs unstacked."""
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


def _masters_close(got, want, peak):
    close = []
    for name, m in got.items():
        err = np.abs(m.numpy() - want[name])
        assert err.max() <= peak, (name, err.max())
        close.append((err <= 2e-6 + 1e-5 * np.abs(want[name])).ravel())
    assert np.concatenate(close).mean() >= 0.98


def test_full_train_step_matches_jax(setup):
    jcfg, params, sd, _ = setup
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 64, (2, 24)).astype(np.int32)
    mask = (rng.random((2, 24)) < 0.8).astype(np.float32)
    jopt = jax_training.make_optimizer(learning_rate=LR)
    jstate = jax_training.init_train_state(params, jopt)
    jstate, jloss = jax.jit(jax_training.make_train_step(jcfg, jopt))(
        jstate, jnp.asarray(ids), jnp.asarray(mask))
    model = port(sd)
    opt = training.make_optimizer(learning_rate=LR)
    state = training.init_train_state(model, opt)
    state, loss = training.make_train_step(model, opt)(state, ids, mask)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-3)
    # the masters go into float32 parameters unrounded
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32 and torch.equal(p, state.params[n])
    served = training.serving_params(state, model)
    assert all(t.dtype == torch.float32 for t in served.values())
    _masters_close(state.params, _by_port_name(jstate.params, jcfg),
                   2 * LR + 1e-6)


def test_lora_step_matches_jax(setup):
    jcfg, params, sd, _ = setup
    rng = np.random.default_rng(6)
    ids = rng.integers(0, 64, (2, 24)).astype(np.int32)
    mask = (rng.random((2, 24)) < 0.8).astype(np.float32)
    adapters = jax_lora.init_lora(jax.random.PRNGKey(1), params, jcfg,
                                  rank=4)
    adapters = jax.tree_util.tree_map(
        lambda x: x + 0.05 * jnp.ones_like(x), adapters)
    jopt = jax_training.make_optimizer(learning_rate=LR)
    jstate = jax_lora.init_lora_train_state(adapters, jopt)
    jstate, jloss = jax.jit(jax_lora.make_lora_train_step(
        jcfg, jopt, alpha=8.0))(jstate, params, jnp.asarray(ids),
                                jnp.asarray(mask))
    model = port(sd)
    cfg = model.config
    opt = training.make_optimizer(learning_rate=LR)
    state = lora.init_lora_train_state(
        ckpt.lora_from_jax(adapters, cfg, 'cpu'), opt)
    state, loss = lora.make_lora_train_step(model, opt, alpha=8.0)(
        state, ids, mask)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-3)
    want = {n: t.numpy() for n, t in lora.named_adapters(
        ckpt.lora_from_jax(jstate.lora, cfg, 'cpu')).items()}
    _masters_close(lora.named_adapters(state.lora), want, 2 * LR + 1e-6)


# -- kernels 1, 2 and 6 with float32 weights ---------------------------------

def _bf16_pair(a):
    return (jnp.asarray(a, jnp.float32).astype(jnp.bfloat16),
            torch.from_numpy(np.asarray(a, np.float32)).bfloat16())


def _f32_pair(a):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def test_rmsnorm_float32_gain_matches_jax_kernel():
    rng = np.random.default_rng(7)
    x_j, x_t = _bf16_pair(rng.standard_normal((300, 64)))
    w_j, w_t = _f32_pair(rng.standard_normal(64))
    got = rmsnorm_plain(x_t, w_t)
    assert got.dtype == torch.bfloat16
    want = rmsnorm_pallas(x_j, w_j, eps=1e-6, block_rows=64, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-2)
    rounded = rmsnorm_plain(x_t, w_t.bfloat16())
    assert not torch.equal(got, rounded)


@pytest.mark.parametrize('bias', [False, True])
def test_fir_gate_float32_taps_match_jax_kernel(bias):
    rng = np.random.default_rng(8)
    z_j, z_t = _bf16_pair(rng.standard_normal((2, 3, 16, 40)))
    w_j, w_t = _f32_pair(rng.standard_normal((3, 16, 3)))
    b_j, b_t = (_f32_pair(rng.standard_normal((3, 16))) if bias
                else (None, None))
    x2, u = fir_gate_plain(z_t, w_t, b_t)
    x2_j, u_j = fir_gate_pallas(z_j, w_j, b_j, block_channels=8,
                                interpret=True)
    np.testing.assert_array_equal(_np(x2), _np(x2_j))
    np.testing.assert_array_equal(_np(u), _np(u_j))
    x2_r, _ = fir_gate_plain(z_t, w_t.bfloat16(),
                             None if b_t is None else b_t.bfloat16())
    assert not torch.equal(x2, x2_r)


def test_hyena_mixer_float32_weights_match_jax_kernel():
    rng = np.random.default_rng(9)
    B, C, L, S = 1, 16, 64, 4
    mag = rng.uniform(0.5, 0.98, (C, S))
    ang = rng.uniform(-np.pi, np.pi, (C, S))
    poles = np.stack([mag * np.cos(ang), mag * np.sin(ang)], -1)
    residues = rng.standard_normal((C, S, 2)) * 0.3
    z_j, z_t = _bf16_pair(rng.standard_normal((B, 3, C, L)))
    w_j, w_t = _f32_pair(rng.standard_normal((3, C, 3)) * 0.5)
    b_j, b_t = _f32_pair(rng.standard_normal((3, C)) * 0.1)
    p_j, p_t = _f32_pair(poles)
    r_j, r_t = _f32_pair(residues)
    d_j, d_t = _f32_pair(rng.standard_normal(C))
    y_j, iir_j, fir_j = hyena_mixer_pallas(z_j, w_j, b_j, p_j, r_j, d_j,
                                           chunk=16, interpret=True)
    y, iir, fir = hyena_mixer_plain(z_t, w_t, b_t, p_t, r_t, d_t, chunk=16)
    assert y.dtype == torch.bfloat16 and iir.dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(y_j), rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(_np(iir), _np(iir_j), rtol=3e-2, atol=3e-2)
    np.testing.assert_array_equal(_np(fir), _np(fir_j))
    y_r, _, _ = hyena_mixer_plain(z_t, w_t.bfloat16(), b_t.bfloat16(), p_t,
                                  r_t, d_t.bfloat16(), chunk=16)
    assert not torch.equal(y, y_r)
