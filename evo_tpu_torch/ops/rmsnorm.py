"""RMSNorm: the CUDA kernel (`csrc/rmsnorm.cu`) and its plain version.

Port of `evo_tpu/ops/pallas_rmsnorm.py:rmsnorm_pallas`; the plain version
is `evo_tpu/layers/norms.py:rmsnorm`. Under autograd the kernel runs inside
`RMSNormFunction`, whose backward is the plain version's gradient
(`ops/_grad.py`).
"""

from __future__ import annotations

import torch

from evo_tpu_torch.ops import _build
from evo_tpu_torch.ops._grad import needs_grad, plain_vjp


def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """y = x * rsqrt(mean(x^2, -1) + eps) * w, statistics in float32 (or
    wider, for a float64 x), cast back."""
    acc = torch.promote_types(x.dtype, torch.float32)
    x32 = x.to(acc)
    ms = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps) * w.to(acc)).to(x.dtype)


def rmsnorm_kernel(x: torch.Tensor, w: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """Launch the kernel on CUDA tensors (raises on what it does not
    take). Its output has no autograd history."""
    D = x.shape[-1]
    if x.dtype != torch.bfloat16 or w.dtype != x.dtype:
        raise TypeError(f'rmsnorm kernel takes bf16 x and w, got {x.dtype} '
                        f'and {w.dtype}')
    if w.shape != (D,) or w.device != x.device:
        raise ValueError(f'rmsnorm: weight {tuple(w.shape)} on {w.device} '
                         f'for rows of {D} on {x.device}')
    if D % 8 or not x.is_contiguous() or not w.is_contiguous() \
            or x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError('rmsnorm kernel needs contiguous, 16-byte aligned '
                         'rows whose width is a multiple of 8')
    y = torch.empty_like(x)
    rows = x.numel() // D
    if rows:
        _build.launch('evo_rmsnorm_bf16', 'rmsnorm', x.data_ptr(),
                      w.data_ptr(), y.data_ptr(), rows, D, float(eps))
    return y


class RMSNormFunction(torch.autograd.Function):
    """`forward_impl(x, w, eps)` (the kernel) with the gradient of
    `rmsnorm_plain` to x and w, recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, x, w, eps, forward_impl):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return forward_impl(x, w, eps)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gx, gw = plain_vjp(lambda a, b: rmsnorm_plain(a, b, ctx.eps), (x, w),
                           ctx.needs_input_grad[:2], (gy,))
        return gx, gw, None, None


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis. A CUDA tensor launches the kernel (or
    raises on what it does not take), through `RMSNormFunction` when x or
    w requires grad; a CPU tensor takes the plain version."""
    if not _build.check_device(x, 'rmsnorm'):
        return rmsnorm_plain(x, w, eps)
    if needs_grad(x, w):
        return RMSNormFunction.apply(x, w, eps, rmsnorm_kernel)
    return rmsnorm_kernel(x, w, eps)
