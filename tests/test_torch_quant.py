"""The port's quantized modes (evo_tpu_torch/quant.py, ops/int4.py) against
the JAX package, on the CPU, inputs from a numpy seed.

Tolerances:
  * packing, codes: bit-equal; scales: 1 ulp (both divide and round half
    to even in float32);
  * `int4_matmul_plain` against the Pallas kernel in interpret mode: rtol
    and atol 2e-4, the bound of tests/test_int4.py (float32 sums in
    another order);
  * model level, float32 activations, identical codes in both packages,
    differences as fractions of the largest |logit| (a fault moves logits
    by about that range itself). int8 weight-only is continuous in its
    inputs: 1e-4. The other modes round activations (to bf16 before an
    int4 product, to int8 codes under act_quant), and where the two
    frameworks' float32 inputs differ in the last bits a rounding falls
    the other way: one such flip moves one input by 2^-8 (bf16) or 1/127
    (int8) of its size, and later layers carry it on. So the bulk must
    agree (mean difference <= 1e-3 for int4, 2e-3 for int8 x int8) and no
    element may be off by more than 1e-2 (int4) or 3e-2 (int8 x int8).
    A forward with more than 128 rows takes the dequantized bf16 product
    in both packages; prefill + decode with at most 128 rows takes the
    plain kernel arithmetic (scale after each group's dot) in the port and
    the dequantize-first product in the JAX package on the CPU, which
    tests/test_int4.py:242 holds to rtol and atol 2e-2: two functions
    that differ by a bf16 rounding of every dequantized weight. The same
    limit on the largest difference here, and 5e-3 on the mean.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evo_tpu import checkpoint as jax_ckpt
from evo_tpu import model as jax_model
from evo_tpu import quant as jax_quant
from evo_tpu.generation import generate as jax_generate
from evo_tpu.models import EvoModel as JaxEvoModel
from evo_tpu.models import config_for_model as jax_config_for_model
from evo_tpu.ops import pallas_int4
from evo_tpu_torch import quant
from evo_tpu_torch.checkpoint import (params_from_state_dict,
                                      quantized_layers_from_jax, state_dict)
from evo_tpu_torch.generation import generate
from evo_tpu_torch.models import EvoModel, config_for_model
from evo_tpu_torch.ops import int4
from evo_tpu_torch.tokenizer import CharLevelTokenizer

torch.set_num_threads(2)

# dims are multiples of 256, as in tests/test_int4.py:165-173, in float32
_DIMS = dict(hidden_size=256, num_filters=256, num_layers=4,
             attn_layer_idxs=(1,), hyena_layer_idxs=(0, 2, 3),
             num_attention_heads=4, state_size=4, inner_mlp_size=512,
             compute_dtype='float32', param_dtype='float32')
FAMILIES = {          # name -> (shape, contraction axes)
    'w1': ((256, 512), (0,)), 'w2': ((256, 512), (0,)),
    'w3': ((304, 256), (0,)),                  # K = 304 pads to 512
    'w_in': ((256, 3, 256), (0,)), 'w_out': ((256, 256), (0,)),
    'wqkv': ((256, 3, 4, 64), (0,)), 'wo': ((2, 64, 256), (0, 1)),
}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _bf16(a):
    """numpy float32 -> (torch bf16, jax bf16) of the same values."""
    t = torch.from_numpy(a).bfloat16()
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


# -- packing and the kernel's plain version -------------------------------

@pytest.mark.parametrize('Kp,N', [(256, 384), (1536, 40)])
def test_pack_unpack_bit_equal_to_jax(Kp, N):
    q = np.random.default_rng(0).integers(-8, 8, (Kp, N)).astype(np.int8)
    want = np.asarray(pallas_int4.pack_int4(jnp.asarray(q)))
    got = int4.pack_int4(_t(q))
    assert got.dtype == torch.int8 and got.shape == (Kp // 2, N)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(int4.unpack_int4(got).numpy(), q)
    np.testing.assert_array_equal(
        int4.unpack_int4(got).numpy(),
        np.asarray(pallas_int4.unpack_int4_jnp(jnp.asarray(want))))
    with pytest.raises(ValueError, match='256'):
        int4.pack_int4(_t(q[:128]))


@pytest.mark.parametrize('M,Kp,N', [
    (8, 256, 512), (1, 4096, 688), (16, 1536, 512), (128, 512, 1024)])
def test_int4_matmul_plain_matches_pallas_interpret(M, Kp, N):
    rng = np.random.default_rng(M + N)
    xt, xj = _bf16(rng.standard_normal((M, Kp)).astype(np.float32))
    q = rng.integers(-8, 8, (Kp, N)).astype(np.int8)
    s = rng.uniform(0.01, 0.1, (Kp // 128, N)).astype(np.float32)
    packed = int4.pack_int4(_t(q))
    want = np.asarray(pallas_int4.int4_matmul(
        xj, jnp.asarray(packed.numpy()), jnp.asarray(s), interpret=True))
    got = int4.int4_matmul(xt, packed, _t(s))      # CPU: the plain version
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_int4_matmul_shape_rules():
    assert int4.M_MAX == pallas_int4.M_MAX == 128
    for m, kp in ((1, 4096), (128, 11008), (129, 4096), (8, 4100),
                  (8, 4224)):
        assert int4.int4_matmul_supported(m, kp) == \
            pallas_int4.int4_matmul_supported(m, kp)
    x = torch.zeros(129, 256).bfloat16()
    with pytest.raises(ValueError, match='M <= 128'):
        int4.int4_matmul(x, torch.zeros(128, 8, dtype=torch.int8),
                         torch.ones(2, 8))
    with pytest.raises(ValueError, match='do not fit'):
        int4.int4_matmul(x[:4], torch.zeros(128, 8, dtype=torch.int8),
                         torch.ones(3, 8))


# -- quantizing one weight -------------------------------------------------

@pytest.mark.parametrize('name', sorted(FAMILIES))
@pytest.mark.parametrize('mode', ['int8', 'int4'])
def test_quantize_weight_matches_jax(name, mode):
    shape, axes = FAMILIES[name]
    w = (np.random.default_rng(len(name)).standard_normal(shape) * 0.05
         ).astype(np.float32)
    if mode == 'int8':
        want = jax_quant.quantize_weight(jnp.asarray(w), axes)
        got = quant.quantize_weight(_t(w), axes)
        codes, scales = (got.q, want['q']), (got.s, want['s'])
        assert quant.is_quantized(got) and not quant.is_int4(got)
    else:
        want = jax_quant.quantize_weight_int4(jnp.asarray(w), len(axes))
        got = quant.quantize_weight_int4(_t(w), len(axes))
        codes, scales = (got.q4, want['q4']), (got.s4, want['s4'])
        assert quant.is_int4(got) and not quant.is_quantized(got)
    assert codes[0].dtype == torch.int8
    assert tuple(scales[0].shape) == np.shape(scales[1])
    np.testing.assert_array_equal(codes[0].numpy(), np.asarray(codes[1]))
    np.testing.assert_array_max_ulp(scales[0].numpy(),
                                    np.asarray(scales[1]), maxulp=1)


# -- the products -----------------------------------------------------------

def _jax_int4_dot_through_kernel(x, leaf, nc):
    """`evo_tpu.quant.int4_dot` as it runs on a TPU: the same reshapes and
    padding around the Pallas kernel (here in interpret mode), where on the
    CPU it would take its dequantize-first fallback."""
    q4, s4 = leaf['q4'], leaf['s4']
    lead = x.shape[:-nc]
    x2 = x.reshape(int(np.prod(lead)), -1)
    x2 = jnp.pad(x2, ((0, 0), (0, 2 * q4.shape[0] - x2.shape[1])))
    y2 = pallas_int4.int4_matmul(x2, q4, s4.reshape(s4.shape[0], -1),
                                 interpret=True)
    return y2.reshape(lead + s4.shape[1:]).astype(x.dtype)


@pytest.mark.parametrize('name,lead', [('wqkv', (2, 5)), ('wo', (2, 5)),
                                       ('w3', (3,)), ('wo', (2, 70))])
def test_int4_dot_matches_jax(name, lead):
    """Several output axes (wqkv), nc=2 with a padded K (wo: K = 128 pads
    to 256, zero rows interleave with real ones across the two nibbles),
    a padded K of 304 (w3), and more than 128 rows (the dequantized
    product, against `evo_tpu.quant.int4_dot` itself)."""
    shape, axes = FAMILIES[name]
    nc = len(axes)
    rng = np.random.default_rng(2)
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    xt, xj = _bf16(rng.standard_normal(lead + shape[:nc]).astype(np.float32))
    leaf = jax_quant.quantize_weight_int4(jnp.asarray(w), nc)
    if int(np.prod(lead)) > int4.M_MAX:
        want = jax_quant.int4_dot(xj, leaf, nc=nc)
    else:
        want = _jax_int4_dot_through_kernel(xj, leaf, nc)
    got = quant.int4_dot(xt, quant.quantize_weight_int4(_t(w), nc), nc=nc)
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == want.shape == lead + shape[nc:]
    want = np.asarray(want.astype(jnp.float32))
    # bf16 outputs of float32 sums taken in another order: one rounding
    # step (2^-8 relative) of the value or of the outputs' typical size
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=2 ** -7 * float(np.abs(want).mean()))
    ref = np.tensordot(xt.float().numpy(), w, axes=nc)
    assert np.abs(got.float().numpy() - ref).mean() < 0.15 * np.abs(ref).mean()


@pytest.mark.parametrize('name,quantized', [('w1', True), ('wo', True),
                                            ('wqkv', True), ('w1', False)])
def test_qdot_int8x8_matches_jax(name, quantized):
    shape, axes = FAMILIES[name]
    nc = len(axes)
    rng = np.random.default_rng(3)
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    x = rng.standard_normal((2, 7) + shape[:nc]).astype(np.float32)
    wj, wt = jnp.asarray(w), _t(w)
    if quantized:
        wj, wt = (jax_quant.quantize_weight(wj, axes),
                  quant.quantize_weight(wt, axes))
    want = np.asarray(jax_quant.qdot(jnp.asarray(x), wj, nc=nc))
    got = quant.qdot(_t(x), wt, nc=nc)
    assert tuple(got.shape) == want.shape
    # the integer product is exact in both; the float32 rescale differs in
    # the last bit
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        quant.project(_t(x), wt, nc, act_quant=True).numpy(), got.numpy())


def test_int8_matmul_is_exact_past_float32():
    """127 * 127 * K passes 2^24 at K = 10928: the product must be an
    integer one."""
    a = torch.full((3, 10928), 127, dtype=torch.int8)
    b = torch.full((10928, 8), -127, dtype=torch.int8)
    got = quant._int8_matmul(a, b)
    assert got.dtype == torch.int32
    assert torch.equal(got, torch.full((3, 8), -127 * 127 * 10928,
                                       dtype=torch.int32))


def test_wcast_dequantizes_in_the_activation_type():
    w = _t(np.random.default_rng(4).standard_normal((256, 64))
           .astype(np.float32))
    qw = quant.quantize_weight(w, (0,))
    want = np.asarray(jax_quant.wcast(
        {'q': jnp.asarray(qw.q.numpy()), 's': jnp.asarray(qw.s.numpy())},
        jnp.bfloat16).astype(jnp.float32))
    got = quant.wcast(qw, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert quant.wcast(w, torch.float32) is w
    with pytest.raises(TypeError, match='int4'):
        quant.wcast(quant.quantize_weight_int4(w, 1), torch.float32)


# -- whole models -------------------------------------------------------------

@pytest.fixture(scope='module')
def setup():
    jcfg = jax_config_for_model('evo-1-8k-base').replace(use_pallas='never',
                                                         **_DIMS)
    cfg = config_for_model('evo-1-8k-base').replace(**_DIMS)
    params = jax_model.init_params(jax.random.PRNGKey(0), jcfg)
    sd = jax_ckpt.export_state_dict(params, jcfg)

    def fresh(**overrides):
        c = cfg.replace(**overrides)
        return params_from_state_dict(dict(sd), c, 'cpu'), c

    return jcfg, params, fresh


def _jax_leaves(qparams, jcfg):
    """(layer, submodule, weight name) -> the quantized leaf of that layer
    as numpy arrays, stacked runs split."""
    out = {}
    for (kind, idxs), seg in zip(jcfg.layer_segments(), qparams['segments']):
        for j, li in enumerate(idxs):
            tree = seg if kind == 'attn' else seg['stack']
            for sub in ('mlp', 'attn', 'hyena'):
                for name, leaf in tree.get(sub, {}).items():
                    if isinstance(leaf, dict) and name in FAMILIES:
                        out[li, sub, name] = {
                            k: np.asarray(v if kind == 'attn' else v[j])
                            for k, v in leaf.items()}
    return out


@pytest.mark.parametrize('mode', ['int8', 'int4'])
def test_quantize_params_matches_jax(setup, mode):
    jcfg, params, fresh = setup
    model, _ = fresh()
    before = quant.quantized_bytes(model)
    qmodel = quant.quantize_params(model, mode=mode)
    want = _jax_leaves(jax_quant.quantize_params(params, mode=mode), jcfg)
    names = ('q', 's') if mode == 'int8' else ('q4', 's4')
    seen = 0
    for li, blk in enumerate(qmodel.blocks):
        for sub, fams in quant._FAMILIES:
            for name in fams if hasattr(blk, sub) else ():
                got, ref = getattr(getattr(blk, sub), name), want[li, sub,
                                                                  name]
                assert isinstance(got, quant.QuantizedWeight)
                np.testing.assert_array_equal(
                    getattr(got, names[0]).numpy(), ref[names[0]])
                np.testing.assert_array_max_ulp(
                    getattr(got, names[1]).numpy(), ref[names[1]], maxulp=1)
                seen += 1
    assert seen == len(want) == 3 * 5 + 5
    # without free_source the source model stays whole and shares what was
    # not quantized
    assert isinstance(model.blocks[0].mlp.w1, torch.nn.Parameter)
    assert qmodel.blocks[0].hyena.poles is model.blocks[0].hyena.poles
    assert quant.quantized_bytes(model) == before
    after = quant.quantized_bytes(qmodel)
    assert after < (0.45 if mode == 'int8' else 0.3) * before
    assert after == jax_quant.quantized_bytes(
        jax_quant.quantize_params(params, mode=mode))


def test_quantize_params_modes_and_free_source(setup):
    _, _, fresh = setup
    model, _ = fresh()
    q8 = quant.quantize_params(model, free_source=True, mode='int8')
    assert q8 is model and quant.is_quantized(model.blocks[1].attn.wo)
    assert 'w1' not in dict(model.blocks[0].mlp.named_parameters())
    # the same mode again is a no-op, the other mode is refused loudly
    codes = model.blocks[0].mlp.w1.q
    assert quant.quantize_params(model, mode='int8').blocks[0].mlp.w1.q \
        is codes
    with pytest.raises(ValueError, match='different mode'):
        quant.quantize_params(model, mode='int4')
    with pytest.raises(ValueError, match='unknown quantization mode'):
        quant.quantize_params(model, mode='int2')
    with pytest.raises(ValueError, match='quantized'):
        state_dict(model)


def _pair(setup, mode, act_quant='none'):
    """The port's model and the JAX parameters on identical codes."""
    jcfg, params, fresh = setup
    jq = jax_quant.quantize_params(params, mode=mode)
    model, cfg = fresh(weight_quant=mode, act_quant=act_quant)
    quantized_layers_from_jax(model, jax.tree_util.tree_map(np.asarray, jq))
    return (EvoModel(cfg, model), jq,
            jcfg.replace(weight_quant=mode, act_quant=act_quant))


# (weight mode, act_quant, largest and mean difference allowed, as
# fractions of the largest |logit|)
MODES = [('int4', 'none', 1e-2, 1e-3), ('int8', 'none', 1e-4, 1e-5),
         ('int8', 'int8', 3e-2, 2e-3)]


def _close(got, want, max_tol, mean_tol):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max())
    diff = np.abs(got - want)
    assert diff.mean() <= mean_tol * scale, (diff.mean(), scale)
    if max_tol == 2e-2:       # int4 at few rows: tests/test_int4.py:242
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
    else:
        assert diff.max() <= max_tol * scale, (diff.max(), scale)


@pytest.mark.parametrize('mode,act,max_tol,mean_tol', MODES)
def test_model_forward_matches_jax(setup, mode, act, max_tol, mean_tol):
    model, jq, jcfg = _pair(setup, mode, act)
    ids = np.random.default_rng(0).integers(0, 256, (2, 80)).astype(np.int32)
    want = jax_model.forward(jq, jcfg, jnp.asarray(ids))
    got, _ = model(ids)                        # 160 rows: past M_MAX
    _close(got.numpy(), want, max_tol, mean_tol)


@pytest.mark.parametrize('mode,act,max_tol,mean_tol',
                         [('int4', 'none', 2e-2, 5e-3)] + MODES[1:])
def test_model_prefill_decode_matches_jax(setup, mode, act, max_tol,
                                          mean_tol):
    model, jq, jcfg = _pair(setup, mode, act)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 256, (2, 33)).astype(np.int32)
    steps = rng.integers(0, 256, (2, 2)).astype(np.int32)
    jcache = jax_model.init_cache(jcfg, 2, 64)
    want, jcache = jax_model.prefill(jq, jcfg, jnp.asarray(ids), jcache)
    cache = model.initialize_inference_params(2, 64)
    got, cache = model(ids, inference_params_dict=cache)   # 66 rows
    _close(got.numpy(), want, max_tol, mean_tol)
    for tok in steps:
        want, jcache = jax_model.decode_step(jq, jcfg, jnp.asarray(tok),
                                             jcache)
        got, cache = model(tok[:, None], inference_params_dict=cache)
        _close(got[:, 0].numpy(), want, max_tol, mean_tol)
    if mode == 'int4':
        # the seam inside the port: prefill + decode against one forward
        # (160 rows there, 2 here: dequantize-first against the kernel's
        # arithmetic)
        full, _ = model(np.concatenate([ids, steps.T], axis=1))
        np.testing.assert_allclose(got[:, 0].numpy(), full[:, -1].numpy(),
                                   rtol=2e-2, atol=2e-2)


def test_greedy_generation_token_exact_under_int8(setup):
    model, jq, jcfg = _pair(setup, 'int8')
    tok = CharLevelTokenizer(512)
    want, want_scores = jax_generate(
        ['ACGTACGT'], JaxEvoModel(jcfg, jq), tok, n_tokens=8, top_k=1,
        temperature=1.0, verbose=0)
    got, scores = generate(['ACGTACGT'], model, tok, n_tokens=8, top_k=1,
                           temperature=1.0, verbose=0)
    assert got == want
    np.testing.assert_allclose(scores, want_scores, rtol=1e-4)


def test_int4_logit_drift_is_bounded(setup):
    """int4 is lossy by design; the JAX tests allow a mean logit drift of
    0.15 at this size."""
    _, _, fresh = setup
    model, cfg = fresh()
    ids = np.random.default_rng(0).integers(0, 256, (2, 80)).astype(np.int32)
    ref, _ = EvoModel(cfg, model)(ids)
    q4 = quant.quantize_params(model, mode='int4')
    got, _ = EvoModel(cfg, q4)(ids)
    assert float((got - ref).abs().mean()) < 0.15
