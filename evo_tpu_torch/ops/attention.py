"""Causal self-attention: the CUDA flash kernel (`csrc/flash_attention.cu`,
on the Hopper mainloop of `csrc/flash_sm90.cuh`) and its plain version.

Port of `evo_tpu/ops/pallas_attention.py:flash_attention_causal`; the
plain version is the dense float32-softmax `sdpa_causal` of
`evo_tpu/layers/attention.py`, evaluated in blocks of query rows so its
score matrix stays bounded at long L.
"""

from __future__ import annotations

import math

import torch

from evo_tpu_torch.ops import _build

HEAD_DIM = 128              # the kernel's compiled head width
_PLAIN_SCORE_BYTES = 1 << 30


def attention_plain(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """q, k, v: (B, L, H, Dh) -> (B, L, H, Dh) in q.dtype; float32 scores,
    mask and softmax, float32 P @ V."""
    B, L, H, Dh = q.shape
    scale = 1.0 / math.sqrt(Dh)
    q32 = q.float().transpose(1, 2)                           # (B, H, L, Dh)
    k32 = k.float().transpose(1, 2)
    v32 = v.float().transpose(1, 2)
    rows = max(1, _PLAIN_SCORE_BYTES // (4 * B * H * L))
    out = torch.empty_like(q32)
    for r0 in range(0, L, rows):
        r1 = min(L, r0 + rows)
        s = torch.matmul(q32[:, :, r0:r1], k32[:, :, :r1].transpose(-1, -2))
        s = s * scale
        row = torch.arange(r0, r1, device=q.device)[:, None]
        col = torch.arange(r1, device=q.device)[None, :]
        s = s.masked_fill(col > row, float('-inf'))
        out[:, :, r0:r1] = torch.matmul(torch.softmax(s, dim=-1),
                                        v32[:, :, :r1])
    return out.transpose(1, 2).to(q.dtype)


def flash_attention_causal(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """Causal attention, q, k, v (B, L, H, Dh) -> contiguous (B, L, H, Dh).
    A CUDA tensor launches the kernel (or raises on what it does not
    take); a CPU tensor takes the plain version.

    The kernel reads q, k and v by TMA through their strides (the model
    passes views of its fused QKV projection); the head axis must be
    contiguous and the other strides and the addresses 16-byte aligned."""
    if not _build.check_device(q, 'flash_attention_causal'):
        return attention_plain(q, k, v)
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
