"""The PyTorch port's kernel modules against the JAX package.

On the CPU each wrapper runs its plain PyTorch version; those are held
against the JAX oracles and the Pallas kernels in interpret mode, on the
same numpy-seeded inputs. The CUDA kernels themselves are held against the
plain versions by tests/test_torch_cuda.py, which skips without a card,
and by `chip_smoke.py` at full width.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evo_tpu.layers.attention import sdpa_causal
from evo_tpu.layers.norms import rmsnorm as jax_rmsnorm
from evo_tpu.ops import fftconv as jax_fftconv
from evo_tpu.ops.pallas_attention import flash_attention_causal as jax_flash
from evo_tpu.ops.pallas_fir import fir_gate_pallas
from evo_tpu.ops.pallas_rmsnorm import rmsnorm_pallas
from evo_tpu_torch.ops import _build
from evo_tpu_torch.ops.attention import (attention_plain,
                                         flash_attention_causal)
from evo_tpu_torch.ops.fir_gate import fir_gate, fir_gate_plain
from evo_tpu_torch.ops.rmsnorm import rmsnorm, rmsnorm_plain

torch.set_num_threads(2)

_DT = {'float32': (np.float32, jnp.float32, torch.float32),
       'bfloat16': (np.float32, jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jnp array and a torch tensor of `dtype` (both
    round float32 to nearest even for bf16, so the bits agree)."""
    _, jdt, tdt = _DT[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


# -- RMSNorm -----------------------------------------------------------------

@pytest.mark.parametrize('dtype,tol', [('float32', 1e-5), ('bfloat16', 2e-2)])
@pytest.mark.parametrize('shape', [(4, 128), (2, 9, 256), (300, 64)])
def test_rmsnorm_plain_matches_jax(shape, dtype, tol):
    rng = np.random.default_rng(0)
    x_j, x_t = _pair(rng.standard_normal(shape, np.float32), dtype)
    w_j, w_t = _pair(rng.standard_normal(shape[-1:], np.float32), dtype)
    got = rmsnorm(x_t, w_t, 1e-6)
    assert got.dtype == x_t.dtype and got.shape == x_t.shape
    for want in (jax_rmsnorm(x_j, w_j, eps=1e-6),
                 rmsnorm_pallas(x_j, w_j, eps=1e-6, block_rows=64,
                                interpret=True)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_rmsnorm_cpu_takes_plain_version():
    x = torch.randn(3, 64)
    w = torch.randn(64)
    before = _build.LAUNCHES['rmsnorm']
    assert torch.equal(rmsnorm(x, w), rmsnorm_plain(x, w))
    assert _build.LAUNCHES['rmsnorm'] == before


# -- FIR + gate --------------------------------------------------------------

@pytest.mark.parametrize('B,C,L,bias', [(2, 8, 32, True), (1, 16, 64, False),
                                        (1, 8, 5, True)])
def test_fir_gate_plain_matches_jax(B, C, L, bias):
    rng = np.random.default_rng(1)
    K = 3
    z_j, z_t = _pair(rng.standard_normal((B, 3, C, L), np.float32),
                     'float32')
    w_j, w_t = _pair(rng.standard_normal((3, C, K), np.float32), 'float32')
    if bias:
        b_j, b_t = _pair(rng.standard_normal((3, C), np.float32), 'float32')
    else:
        b_j = b_t = None
    x2, u = fir_gate(z_t, w_t, b_t)
    x2_p, u_p = fir_gate_pallas(z_j, w_j, b_j, block_channels=8,
                                interpret=True)
    zf, _ = jax_fftconv.fir_causal_conv(z_j, w_j, b_j)
    for got, wants in ((x2, (x2_p, zf[:, 0])),
                       (u, (u_p, zf[:, 1] * zf[:, 2]))):
        for want in wants:
            np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                       atol=1e-5)


def test_fir_gate_bf16_rounds_before_gate():
    """bf16: each stream is rounded before the gate, bit for bit as the
    JAX composition does it."""
    rng = np.random.default_rng(2)
    z_j, z_t = _pair(rng.standard_normal((1, 3, 8, 40), np.float32),
                     'bfloat16')
    w_j, w_t = _pair(rng.standard_normal((3, 8, 3), np.float32), 'bfloat16')
    b_j, b_t = _pair(rng.standard_normal((3, 8), np.float32), 'bfloat16')
    x2, u = fir_gate_plain(z_t, w_t, b_t)
    zf, _ = jax_fftconv.fir_causal_conv(z_j, w_j, b_j)
    np.testing.assert_array_equal(_np(x2), _np(zf[:, 0]))
    np.testing.assert_array_equal(_np(u), _np(zf[:, 1] * zf[:, 2]))


# -- causal attention --------------------------------------------------------

@pytest.mark.parametrize('L', [1, 7, 64, 200])
def test_attention_plain_matches_jax(L):
    rng = np.random.default_rng(3)
    B, H, Dh = 1, 2, 128
    q_j, q_t = _pair(rng.standard_normal((B, L, H, Dh), np.float32),
                     'float32')
    k_j, k_t = _pair(rng.standard_normal((B, L, H, Dh), np.float32),
                     'float32')
    v_j, v_t = _pair(rng.standard_normal((B, L, H, Dh), np.float32),
                     'float32')
    got = flash_attention_causal(q_t, k_t, v_t)
    assert got.shape == (B, L, H, Dh)
    for want in (sdpa_causal(q_j, k_j, v_j),
                 jax_flash(q_j, k_j, v_j, interpret=True)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-3,
                                   atol=2e-3)


def test_attention_plain_row_blocks(monkeypatch):
    """The plain version's row blocking (bounded score memory at long L)
    gives the same result as one block."""
    from evo_tpu_torch.ops import attention as attn_mod
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 50, 2, 16),
                                                    np.float32))
               for _ in range(3))
    whole = attention_plain(q, k, v)
    monkeypatch.setattr(attn_mod, '_PLAIN_SCORE_BYTES', 4 * 2 * 2 * 50 * 7)
    np.testing.assert_allclose(attention_plain(q, k, v).numpy(),
                               whole.numpy(), rtol=1e-6, atol=1e-6)
