"""The PyTorch port's CUDA kernels against their plain versions, on the
card. Without a CUDA device every test here skips.

This file imports neither JAX nor the JAX package, so it also runs on a
GPU machine that has neither (tests/conftest.py imports JAX; skip it):

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts= -q
"""

import pytest
import torch

from evo_tpu_torch.ops.attention import (attention_plain,
                                         flash_attention_causal)
from evo_tpu_torch.ops.fir_gate import fir_gate, fir_gate_plain
from evo_tpu_torch.ops.rmsnorm import rmsnorm, rmsnorm_plain

torch.set_num_threads(2)

# A string condition is evaluated when each test is set up, not while the
# module is imported, so every xdist worker collects the same tests.
pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif('not torch.cuda.is_available()',
                       reason='needs a CUDA device: the kernels build and '
                              'run only on the card'),
]


@pytest.fixture
def randn():
    g = torch.Generator(device='cuda').manual_seed(0)
    return lambda *shape: torch.randn(*shape, device='cuda',
                                      generator=g).bfloat16()


@pytest.mark.parametrize('rows', [1, 4, 8192])
def test_rmsnorm_kernel(randn, rows):
    x, w = randn(rows, 4096), randn(4096)
    got, want = rmsnorm(x, w).float(), rmsnorm_plain(x, w).float()
    torch.cuda.synchronize()
    # one bf16 rounding step apart at most (2^-7 relative), as the fp32 row
    # sums are taken in another order
    assert ((got - want).abs() / want.abs().clamp(min=1)).max() <= 1e-2


@pytest.mark.parametrize('B,L', [(1, 1), (1, 3), (2, 77), (1, 1000)])
@pytest.mark.parametrize('bias', [True, False])
def test_fir_gate_kernel(randn, B, L, bias):
    z, w = randn(B, 3, 4096, L), randn(3, 4096, 3)
    b = randn(3, 4096) if bias else None
    for got, want in zip(fir_gate(z, w, b), fir_gate_plain(z, w, b)):
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.parametrize('B,L', [(1, 1), (1, 63), (1, 64), (2, 1000)])
def test_flash_attention_kernel(randn, B, L):
    qkv = randn(B, L, 3, 32, 128)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    got = flash_attention_causal(q, k, v)
    torch.cuda.synchronize()
    assert got.is_contiguous() and got.shape == q.shape
    want = attention_plain(q, k, v).float()
    # Output rows shrink along the sequence, so each error is scaled by the
    # larger of |want| and its (position, head) row's rms. Output rounding
    # gives at most one bf16 step (2^-7) of that, the kernel's bf16 P a few
    # 2^-9; the limit is four bf16 steps.
    rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    scaled = (got.float() - want).abs() / want.abs().maximum(rms)
    assert scaled.max() <= 2 ** -5


def test_kernels_refuse_what_they_do_not_take(randn):
    q = randn(1, 8, 2, 64)
    with pytest.raises(ValueError, match='head_dim'):
        flash_attention_causal(q, q, q)
    q32 = randn(1, 8, 2, 128).float()
    with pytest.raises(TypeError):
        flash_attention_causal(q32, q32, q32)
    with pytest.raises(ValueError):
        rmsnorm(randn(2, 12), randn(12))
    with pytest.raises(TypeError):
        rmsnorm(randn(2, 16).float(), randn(16).float())
    with pytest.raises(TypeError):
        fir_gate(randn(1, 3, 8, 5).float(), randn(3, 8, 3).float())
