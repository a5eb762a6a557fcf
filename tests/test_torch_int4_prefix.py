"""Kernels 8 (weight-only int4 matmul) and 7 (the modal prefix) of the
PyTorch port, through their plain versions on the CPU, held against the
JAX package with its Pallas kernels in interpret mode:

  * `int4_matmul_plain` on an x of K <= Kp columns (the rest read as
    zeros), in float32 and in bf16, against JAX `int4_matmul` on the
    zero-padded x, at evo-1's two contractions (4096; 10928 padded to
    11008);
  * `int4_dot`, which no longer pads x or casts y, bit-equal to the route
    that did;
  * `modal_prefix_plain` with a carried state s0 against the JAX Pallas
    prefix plus the a^k s0 terms that JAX `conv_matmul_chunked` adds;
  * the port's `conv_matmul_chunked(pallas_prefix=True, state=...)`, where
    the prefix takes the state, against the JAX one.

Tolerances are stated in each test.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evo_tpu.ops import fftconv as jax_fftconv
from evo_tpu.ops import pallas_int4
from evo_tpu.ops import pallas_prefix as jax_pallas_prefix
from evo_tpu_torch import quant
from evo_tpu_torch.ops import fftconv, int4
from evo_tpu_torch.ops import modal_prefix as prefix_ops

torch.set_num_threads(2)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


# -- kernel 8 ----------------------------------------------------------------

@pytest.mark.parametrize('M', [1, 2, 3])
@pytest.mark.parametrize('K,Kp,N', [(4096, 4096, 24), (10928, 11008, 16),
                                    (130, 256, 8)])     # K % 8 != 0
def test_int4_plain_unpadded_x_matches_jax_kernel(M, K, Kp, N):
    """x of K columns against the JAX kernel on x padded to Kp: float32
    within 2e-4 (the bound the older test of the padded call holds; the
    group sums run in another order), and the bf16 output the float32 one
    rounded once. (On the card a K off multiples of 8 goes to the wgmma
    design padded; the plain version pads every x.)"""
    rng = np.random.default_rng(M + K)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    x = x.bfloat16()
    q = rng.integers(-8, 8, (Kp, N)).astype(np.int8)
    s = rng.uniform(0.01, 0.1, (Kp // 128, N)).astype(np.float32)
    packed = int4.pack_int4(torch.from_numpy(q))
    xj = jnp.asarray(np.pad(x.float().numpy(), ((0, 0), (0, Kp - K))))
    want = np.asarray(pallas_int4.int4_matmul(
        xj.astype(jnp.bfloat16), jnp.asarray(packed.numpy()),
        jnp.asarray(s), interpret=True))
    got = int4.int4_matmul(x, packed, torch.from_numpy(s))
    assert got.dtype == torch.float32 and got.shape == (M, N)
    _close(got.numpy(), want, rtol=2e-4, atol=2e-4)
    got16 = int4.int4_matmul(x, packed, torch.from_numpy(s), torch.bfloat16)
    assert got16.dtype == torch.bfloat16
    assert torch.equal(got16, got.bfloat16())
    # the padded call computes the same sums: bit-equal
    xp = torch.nn.functional.pad(x, (0, Kp - K))
    assert torch.equal(int4.int4_matmul_plain(xp, packed,
                                              torch.from_numpy(s)), got)


def test_int4_matmul_refuses_a_longer_x():
    x = torch.zeros(2, 300).bfloat16()
    with pytest.raises(ValueError, match='K <= Kp'):
        int4.int4_matmul(x, torch.zeros(128, 8, dtype=torch.int8),
                         torch.ones(2, 8))
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        int4.int4_matmul(x[:, :256], torch.zeros(128, 8, dtype=torch.int8),
                         torch.ones(2, 8), torch.float16)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('shape,nc', [((3, 10928), 1), ((2, 5, 2, 64), 2)])
def test_int4_dot_without_pad_and_cast(shape, nc, dtype):
    """`int4_dot` hands the kernel x of K columns and asks for y in the
    caller's dtype; the route before it padded x by `torch.cat` and cast
    the float32 result: bit-equal."""
    g = torch.Generator().manual_seed(len(shape))
    K = int(np.prod(shape[-nc:]))
    out = 48
    w = torch.randn(*shape[-nc:], out, generator=g) * 0.05
    qw = quant.quantize_weight_int4(w, nc)
    x = torch.randn(*shape, generator=g).to(dtype)
    got = quant.int4_dot(x, qw, nc)
    Kp = 2 * qw.q4.shape[0]
    x2 = x.reshape(-1, K).bfloat16()
    x2 = torch.cat([x2, x2.new_zeros((x2.shape[0], Kp - K))], dim=1)
    want = int4.int4_matmul_plain(x2, qw.q4, qw.s4.reshape(Kp // 128, -1))
    want = want.reshape(*shape[:-nc], out).to(dtype)
    assert got.dtype == dtype and torch.equal(got, want)


# -- kernel 7 ----------------------------------------------------------------

def _prefix_inputs(B, D, K, S, seed):
    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal((B, D, K, S)),
            rng.standard_normal((B, D, K, S)),
            np.log(rng.uniform(0.5, 0.98, (D, S))),
            rng.uniform(-3.1, 3.1, (D, S)),
            rng.standard_normal((B, D, S, 2)))
    arrs = [np.asarray(a, np.float32) for a in arrs]
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a)
                                            for a in arrs]


def _jax_prefix_with_state(inj_r, inj_i, logmag, theta, s0, C):
    """The JAX package's prefix kernel (interpret mode) plus the carried
    state's terms as JAX `conv_matmul_chunked` adds them."""
    K = inj_r.shape[2]
    br, bi, fr, fi = jax_pallas_prefix.modal_prefix_pallas(
        inj_r, inj_i, logmag, theta, C, interpret=True)
    s0r, s0i = s0[..., 0], s0[..., 1]
    ak_r, ak_i = jax_fftconv._pole_pow_range(C * logmag, C * theta, K + 1)
    ak_r = jnp.moveaxis(ak_r, -1, 1)[None]
    ak_i = jnp.moveaxis(ak_i, -1, 1)[None]
    br = br + ak_r[:, :, :K] * s0r[:, :, None] - \
        ak_i[:, :, :K] * s0i[:, :, None]
    bi = bi + ak_r[:, :, :K] * s0i[:, :, None] + \
        ak_i[:, :, :K] * s0r[:, :, None]
    fr = ak_r[:, :, K] * s0r - ak_i[:, :, K] * s0i + fr
    fi = ak_r[:, :, K] * s0i + ak_i[:, :, K] * s0r + fi
    return br, bi, fr, fi


@pytest.mark.parametrize('B,D,K,S,C', [
    (1, 64, 128, 8, 64), (2, 32, 16, 4, 32), (1, 16, 48, 8, 64),
    (1, 8, 2, 2, 128)])
def test_modal_prefix_plain_with_state_matches_jax(B, D, K, S, C):
    """ent[0] = s0 exactly, and the rest within 2e-5 (the JAX test's own
    tolerance for kernel against loop) of the JAX Pallas prefix plus its
    state terms; the CPU wrapper is the plain version, bit for bit."""
    j, t = _prefix_inputs(B, D, K, S, K + S)
    want = _jax_prefix_with_state(*j, C)
    got = prefix_ops.modal_prefix_plain(t[0], t[1], t[2], t[3], C, t[4])
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w, rtol=2e-5, atol=2e-5)
    assert torch.equal(got[0][:, :, 0], t[4][..., 0])
    assert torch.equal(got[1][:, :, 0], t[4][..., 1])
    for a, b in zip(prefix_ops.modal_prefix(*t[:4], C, t[4]), got):
        assert torch.equal(a, b)
    # without a state the plain version is what it was
    for a, b in zip(prefix_ops.modal_prefix_plain(*t[:4], C),
                    jax_pallas_prefix.modal_prefix_pallas(
                        *j[:4], C, interpret=True)):
        _close(a, b, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize('B,D,L,S,chunk', [(2, 24, 512, 8, 64),
                                           (1, 16, 128, 4, 16)])
def test_conv_matmul_chunked_prefix_takes_the_state(monkeypatch, B, D, L, S,
                                                    chunk):
    """With `pallas_prefix` and a carried state the port's prefix takes the
    state (one call, the state passed on); y and the final state within
    1e-4 of the JAX `conv_matmul_chunked` with the same state (its jnp
    loop; the JAX package's own conv parity bound is 1e-3)."""
    monkeypatch.setattr(
        jax_pallas_prefix, 'modal_prefix_pallas',
        functools.partial(jax_pallas_prefix.modal_prefix_pallas,
                          interpret=True))
    calls = []
    orig = prefix_ops.modal_prefix
    monkeypatch.setattr(prefix_ops, 'modal_prefix',
                        lambda *a: calls.append(a[5] is not None) or orig(*a))
    rng = np.random.default_rng(L + S)
    u = rng.standard_normal((B, D, L)).astype(np.float32)
    mag = rng.uniform(0.5, 0.98, (D, S))
    ang = rng.uniform(-np.pi, np.pi, (D, S))
    poles = np.stack([mag * np.cos(ang), mag * np.sin(ang)],
                     -1).astype(np.float32)
    residues = (rng.standard_normal((D, S, 2)) * 0.3).astype(np.float32)
    d_skip = rng.standard_normal(D).astype(np.float32)
    st = rng.standard_normal((B, D, S, 2)).astype(np.float32)
    y, s = fftconv.conv_matmul_chunked(
        torch.from_numpy(u), torch.from_numpy(poles),
        torch.from_numpy(residues), chunk, state=torch.from_numpy(st),
        d_skip=torch.from_numpy(d_skip), pallas_prefix=True)
    assert calls == [True]
    y_j, s_j = jax_fftconv.conv_matmul_chunked(
        jnp.asarray(u), jnp.asarray(poles), jnp.asarray(residues), chunk,
        state=jnp.asarray(st), d_skip=jnp.asarray(d_skip),
        pallas_prefix=True)
    _close(y, y_j, rtol=1e-4, atol=1e-4)
    _close(s, s_j, rtol=1e-4, atol=1e-4)
    # the same call without the flag: the plain prefix with the state
    y0, s0 = fftconv.conv_matmul_chunked(
        torch.from_numpy(u), torch.from_numpy(poles),
        torch.from_numpy(residues), chunk, state=torch.from_numpy(st),
        d_skip=torch.from_numpy(d_skip))
    assert torch.equal(y0, y) and torch.equal(s0, s)
    assert len(calls) == 1


def test_jax_stays_on_the_cpu():
    assert jax.devices()[0].platform == 'cpu'
