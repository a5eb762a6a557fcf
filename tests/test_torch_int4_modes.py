"""Kernel 8's four modes in the PyTorch port (`int4_matmul(mode=...)`:
'unroll', 'dots', 'block', 'dots8') through their plain versions on the
CPU, held against the JAX package's `int4_matmul` with its Pallas kernel
in interpret mode, at the four shapes of tests/test_int4.py:76-81 and its
2e-4 ('dots8' quantizes x with IEEE divisions, as that test's oracle
does, where XLA's compiled division on the CPU is within two ulps and can
round a near-tie code the other way: such rows are held on the JAX
kernel's codes); the port's
'dots8' plain version in its kernel's order against the
same function summed group by group (1e-6 of the larger of the value and
its row's rms); an unknown mode raising; 'block' and 'dots8' refusing a
tensor that requires grad. The kernels themselves are held against these
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py
phase 2).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evo_tpu.ops import pallas_int4
from evo_tpu_torch.ops import _build, int4

torch.set_num_threads(2)

SHAPES = [(8, 256, 512), (1, 4096, 688), (16, 1536, 512), (128, 512, 1024)]


def _case(M, Kp, N):
    """x (M, Kp) bf16, the packed codes and the scales, as tests/test_int4
    draws them (from numpy here), in both packages."""
    rng = np.random.default_rng(M + N)
    x = torch.from_numpy(rng.standard_normal((M, Kp)).astype(np.float32)
                         ).bfloat16()
    q = torch.from_numpy(rng.integers(-8, 8, (Kp, N)).astype(np.int8))
    s = torch.from_numpy(rng.uniform(0.01, 0.1, (Kp // 128, N)).astype(
        np.float32))
    packed = int4.pack_int4(q)
    jargs = (jnp.asarray(x.float().numpy(), jnp.bfloat16),
             jnp.asarray(packed.numpy()), jnp.asarray(s.numpy()))
    return (x, packed, s), jargs


@functools.lru_cache(maxsize=None)
def _jax_kernel(M, Kp, N, mode):
    _, jargs = _case(M, Kp, N)
    return np.asarray(pallas_int4.int4_matmul(*jargs, interpret=True,
                                              mode=mode))


@jax.jit
def _jax_codes(x):
    """The 'dots8' branch's row quantization (`pallas_int4.py:121-124`) as
    XLA compiles it on the CPU, where the interpret-mode kernel runs it."""
    x32 = x.astype(jnp.float32)
    xs = jnp.maximum(jnp.max(jnp.abs(x32), axis=1, keepdims=True) / 127.0,
                     jnp.float32(1e-12))
    return jnp.clip(jnp.round(x32 / xs), -127, 127), xs


def _check_dots8_codes(x, jx):
    """The port's scale and codes come from IEEE divisions (as
    tests/test_int4.py's `_oracle_dots8` takes them); XLA's compiled
    division on the CPU is within two ulps of it, which can move a scale by
    an ulp and land a ratio next to a half-integer on the other side.
    Returns the JAX codes and scales, and a mask of the rows where the two
    quantizations give the same codes, after checking that every
    difference is such a tie, by one code."""
    codes, xs = int4.quantize_rows(x)
    jcodes, jxs = (np.asarray(a) for a in _jax_codes(jx))
    np.testing.assert_allclose(xs.numpy(), jxs, rtol=2.4e-7, atol=0)
    diff = codes.numpy() != jcodes
    ratio = np.abs(x.float().numpy() / xs.numpy())
    assert (np.abs(ratio[diff] % 1 - 0.5) < 1e-4).all()
    assert (np.abs(codes.numpy() - jcodes)[diff] == 1).all()
    assert diff.mean() < 1e-3
    return jcodes, jxs, ~diff.any(axis=1)


@pytest.mark.parametrize('M,Kp,N', SHAPES)
@pytest.mark.parametrize('mode', int4.MODES)
def test_plain_matches_jax_kernel(M, Kp, N, mode):
    """Each mode's plain version against the JAX kernel's same mode in
    interpret mode, at tests/test_int4.py's 2e-4; `int4_matmul` on a CPU
    tensor is that plain version, and its bf16 output the float32 one
    rounded once. 'dots8': every row whose codes the two quantizations
    give alike, and every row through the port's products on the JAX
    kernel's codes (`_check_dots8_codes`)."""
    targs, jargs = _case(M, Kp, N)
    got = int4.int4_matmul(*targs, mode=mode)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    want = _jax_kernel(M, Kp, N, mode)
    if mode == 'dots8':
        jcodes, jxs, same = _check_dots8_codes(targs[0], jargs[0])
        np.testing.assert_allclose(got.numpy()[same], want[same], rtol=2e-4,
                                   atol=2e-4)
        got = int4.dots8_products(torch.from_numpy(jcodes),
                                  torch.from_numpy(jxs), *targs[1:])
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    got = int4.int4_matmul(*targs, mode=mode)
    plain = {'unroll': int4.int4_matmul_plain, 'dots': int4.int4_matmul_plain,
             'block': int4.int4_matmul_block_plain,
             'dots8': int4.int4_matmul_dots8_plain}[mode]
    assert torch.equal(got, plain(*targs))
    assert torch.equal(int4.int4_matmul(*targs, torch.bfloat16, mode=mode),
                       got.bfloat16())


@pytest.mark.parametrize('M,K,Kp,N', [(3, 130, 256, 40), (9, 4000, 4096, 700),
                                      (1, 10928, 11008, 64)])
def test_plain_modes_read_x_of_k_columns(M, K, Kp, N):
    """x of K <= Kp columns reads as zeros past K in every mode, as the
    kernels take it: equal to the call on x padded to Kp."""
    targs, _ = _case(M, Kp, N)
    x, packed, s = targs
    for mode in int4.MODES:
        got = int4.int4_matmul(x[:, :K].contiguous(), packed, s, mode=mode)
        want = int4.int4_matmul(
            torch.nn.functional.pad(x[:, :K], (0, Kp - K)), packed, s,
            mode=mode)
        assert torch.equal(got, want), mode


@pytest.mark.parametrize('M,Kp,N', [(1, 4096, 12288), (9, 4096, 1024),
                                    (128, 11008, 512), (2, 256, 40)])
def test_dots8_order_against_group_sums(M, Kp, N):
    """The kernel's order of float32 sums (steps within a split, splits in
    order, `dots8_plan`) against the same integer dots summed group by
    group: one function, within 1e-6 of the larger of the value and its
    row's rms; and the row codes are the JAX kernel's quantization."""
    targs, _ = _case(M, Kp, N)
    x, packed, s = targs
    mt, splits, steps = int4.dots8_plan(M, Kp, N)
    assert mt in (1, 2, 4, 8) and splits * steps >= Kp // 256 > \
        (splits - 1) * steps
    got = int4.int4_matmul_dots8_plain(*targs)
    codes, xs = int4.quantize_rows(x)
    G = Kp // 128
    w = int4.unpack_int4(packed).double().reshape(G, 128, N)
    want = sum((codes.double().reshape(M, G, 128)[:, g] @ w[g])
               * s[g].double() for g in range(G)) * xs.double()
    rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    assert float(((got.double() - want).abs()
                  / want.abs().maximum(rms)).max()) <= 1e-6
    # the codes of tests/test_int4.py's `_oracle_dots8`, bit for bit
    x32 = x.float().numpy()
    xs_j = np.maximum(np.abs(x32).max(1, keepdims=True) / np.float32(127),
                      np.float32(1e-12))
    np.testing.assert_array_equal(xs.numpy(), xs_j)
    np.testing.assert_array_equal(
        codes.numpy(), np.clip(np.round(x32 / xs_j), -127, 127))


def test_unknown_mode_raises():
    targs, _ = _case(8, 256, 512)
    with pytest.raises(ValueError, match='unknown int4_matmul mode'):
        int4.int4_matmul(*targs, mode='unpack')


@pytest.mark.parametrize('mode', ['block', 'dots8'])
def test_block_and_dots8_refuse_grad(mode, monkeypatch):
    """No model path reaches these modes under grad, and they have no
    backward: a tensor that requires grad raises, on the CPU and before a
    launch on the card; under no_grad the same call runs."""
    targs, _ = _case(8, 256, 512)
    x = targs[0].float().requires_grad_()
    with pytest.raises(RuntimeError, match='no backward'):
        int4.int4_matmul(x, *targs[1:], mode=mode)
    monkeypatch.setattr(_build, 'check_device', lambda t, what: True)
    monkeypatch.setattr(_build, 'launch', lambda *a: pytest.fail('launched'))
    with pytest.raises(RuntimeError, match='no backward'):
        int4.int4_matmul(x, *targs[1:], mode=mode)
    monkeypatch.undo()
    with torch.no_grad():
        assert int4.int4_matmul(x, *targs[1:], mode=mode).shape == (8, 512)
    # 'unroll' and 'dots' keep their gradient
    for other in ('unroll', 'dots'):
        int4.int4_matmul(x, *targs[1:], mode=other).sum().backward()
        assert x.grad is not None
