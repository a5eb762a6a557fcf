"""Causal self-attention: the CUDA flash kernel (`csrc/flash_attention.cu`,
on the Hopper mainloop of `csrc/flash_sm90.cuh`) and its plain version.

Port of `evo_tpu/ops/pallas_attention.py:flash_attention_causal`; the
plain version is the dense float32-softmax `sdpa_causal` of
`evo_tpu/layers/attention.py`, evaluated in blocks of query rows so its
score matrix stays bounded at long L. Under autograd the kernel runs
inside `FlashAttentionFunction`, whose backward is the plain version's
gradient, recomputed block of rows by block of rows
(`attention_plain_grads`).
"""

from __future__ import annotations

import math

import torch

from evo_tpu_torch.ops import _build
from evo_tpu_torch.ops._grad import needs_grad

HEAD_DIM = 128              # the kernel's compiled head width
_PLAIN_SCORE_BYTES = 1 << 30


def _block_rows(B: int, H: int, L: int) -> int:
    """Query rows a block of the plain version takes: its float32 scores
    stay within `_PLAIN_SCORE_BYTES`."""
    return max(1, _PLAIN_SCORE_BYTES // (4 * B * H * L))


def _attend_rows(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 r0: int) -> torch.Tensor:
    """Query rows r0 .. r0 + R - 1 of causal attention: q (B, H, R, Dh)
    over the keys and values (B, H, r0 + R, Dh) before and at them, in
    q's type: scores, mask, softmax and P @ V."""
    r1 = r0 + q.shape[2]
    s = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    row = torch.arange(r0, r1, device=q.device)[:, None]
    col = torch.arange(r1, device=q.device)[None, :]
    s = s.masked_fill(col > row, float('-inf'))
    return torch.matmul(torch.softmax(s, dim=-1), v)


def attention_plain(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """q, k, v: (B, L, H, Dh) -> (B, L, H, Dh) in q.dtype; float32 (or,
    for float64 inputs, float64) scores, mask and softmax, and P @ V."""
    B, L, H, Dh = q.shape
    acc = torch.promote_types(q.dtype, torch.float32)
    q32 = q.to(acc).transpose(1, 2)                           # (B, H, L, Dh)
    k32 = k.to(acc).transpose(1, 2)
    v32 = v.to(acc).transpose(1, 2)
    rows = _block_rows(B, H, L)
    out = torch.empty_like(q32)
    for r0 in range(0, L, rows):
        r1 = min(L, r0 + rows)
        out[:, :, r0:r1] = _attend_rows(q32[:, :, r0:r1], k32[:, :, :r1],
                                        v32[:, :, :r1], r0)
    return out.transpose(1, 2).to(q.dtype)


def attention_plain_grads(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, grad_out: torch.Tensor,
                          needs=(True, True, True)):
    """The gradient of `attention_plain` to q, k and v for the output's
    gradient `grad_out`, one block of query rows at a time, as the plain
    version takes them: a block's scores and softmax are recomputed, its
    gradients taken and added into float32 (or float64) sums, and the
    block freed, so no more than one block's scores live at once (a whole
    sequence of 8,192 would hold 8.6 GB of float32 scores a layer, and as
    much again of probabilities). Returns (dq, dk, dv) in the inputs'
    types, None where `needs` says so."""
    B, L, H, Dh = q.shape
    acc = torch.promote_types(q.dtype, torch.float32)
    q32, k32, v32 = (t.detach().to(acc).transpose(1, 2) for t in (q, k, v))
    g32 = grad_out.to(acc).transpose(1, 2)
    sums = [torch.zeros_like(q32) for _ in range(3)]
    rows = _block_rows(B, H, L)
    for r0 in range(0, L, rows):
        r1 = min(L, r0 + rows)
        leaves = [q32[:, :, r0:r1].detach().requires_grad_(),
                  k32[:, :, :r1].detach().requires_grad_(),
                  v32[:, :, :r1].detach().requires_grad_()]
        with torch.enable_grad():
            out = _attend_rows(*leaves, r0)
        dq, dk, dv = torch.autograd.grad(out, leaves, g32[:, :, r0:r1])
        sums[0][:, :, r0:r1] += dq
        sums[1][:, :, :r1] += dk
        sums[2][:, :, :r1] += dv
        del out, dq, dk, dv, leaves
    return tuple(g.transpose(1, 2).to(t.dtype) if n else None
                 for g, t, n in zip(sums, (q, k, v), needs))


class FlashAttentionFunction(torch.autograd.Function):
    """`forward_impl(q, k, v)` (the kernel) with the gradient of
    `attention_plain` to q, k and v (views of one QKV tensor in the
    model), recomputed from the saved inputs block of rows by block of
    rows (`attention_plain_grads`)."""

    @staticmethod
    def forward(ctx, q, k, v, forward_impl):
        ctx.save_for_backward(q, k, v)
        return forward_impl(q, k, v)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        return (*attention_plain_grads(q, k, v, grad_out,
                                       ctx.needs_input_grad[:3]), None)


def flash_attention_causal(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """Causal attention, q, k, v (B, L, H, Dh) -> contiguous (B, L, H, Dh).
    A CUDA tensor launches the kernel (or raises on what it does not
    take), through `FlashAttentionFunction` when q, k or v requires grad;
    a CPU tensor takes the plain version.

    The kernel reads q, k and v by TMA through their strides (the model
    passes views of its fused QKV projection); the head axis must be
    contiguous and the other strides and the addresses 16-byte aligned."""
    if not _build.check_device(q, 'flash_attention_causal'):
        return attention_plain(q, k, v)
    if needs_grad(q, k, v):
        return FlashAttentionFunction.apply(q, k, v, flash_attention_kernel)
    return flash_attention_kernel(q, k, v)


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA tensors (raises on what it does not
    take). Its output has no autograd history."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f'flash_attention_causal: q {tuple(q.shape)}, k '
                         f'{tuple(k.shape)}, v {tuple(v.shape)}')
    B, L, H, Dh = q.shape
    if Dh != HEAD_DIM:
        raise ValueError(f'flash kernel is built for head_dim {HEAD_DIM}, '
                         f'got {Dh}')
    strides = []
    for t in (q, k, v):
        if t.dtype != torch.bfloat16 or t.device != q.device:
            raise TypeError('flash kernel takes bf16 q, k, v on one device')
        sb, sl, sh, sd = t.stride()
        if sd != 1 or sb % 8 or sl % 8 or sh % 8 or t.data_ptr() % 16:
            raise ValueError('flash kernel loads by TMA: it needs a '
                             'contiguous head axis, strides that are '
                             'multiples of 8 elements (16 bytes) and '
                             '16-byte aligned data, got strides '
                             f'{t.stride()} at address {t.data_ptr():#x}')
        strides += [sb, sl, sh]
    if B * H > 65535:
        raise ValueError(f'flash kernel grid: B*H={B * H} > 65535')
    o = torch.empty((B, L, H, Dh), dtype=q.dtype, device=q.device)
    if o.numel():
        _build.launch('evo_flash_attention_bf16', 'flash_attention',
                      q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                      B, L, H, *strides, 1.0 / math.sqrt(Dh))
    return o
