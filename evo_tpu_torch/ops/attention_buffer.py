"""Attention of a query segment at an offset over a KV buffer: the CUDA
kernels (`csrc/flash_attention_buffer.cu`: bf16 buffers on the Hopper
mainloop of `csrc/flash_sm90.cuh`, int8 buffers on an `mma.sync` kernel)
and their plain version.

Port of `evo_tpu/ops/pallas_attention.py:flash_attention_buffer`; the plain
version is the chunked online softmax of `mha_full` in
`evo_tpu/layers/attention.py`. Query row r of batch row b is absolute
position `offset[b] + r` and attends the keys `col <= offset[b] + r`.

A masked key still meets `p = 0` in P @ V, and 0 * NaN is NaN: buffers hold
finite values everywhere (the cache is made of zeros, never left empty).
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch

from evo_tpu_torch.ops import _build
from evo_tpu_torch.ops.attention import HEAD_DIM

Offset = Union[int, torch.Tensor]


def _offsets(offset: Offset, B: int, device) -> torch.Tensor:
    """The offset as a (B,) int32 tensor on `device`. A tensor must
    already be one: nothing is read back to the host."""
    if isinstance(offset, torch.Tensor):
        if offset.shape != (B,) or offset.dtype != torch.int32 \
                or offset.device != device:
            raise ValueError(
                f'per-row offsets must be an int32 ({B},) tensor on '
                f'{device}, got {offset.dtype} {tuple(offset.shape)} on '
                f'{offset.device}')
        return offset
    return torch.full((B,), int(offset), dtype=torch.int32, device=device)


def _check_shapes(q, k_buf, v_buf, offset, ks, vs) -> int:
    """Raise on buffers that do not fit q; returns the buffer length T."""
    if (ks is None) != (vs is None):
        raise ValueError('ks and vs: both or neither')
    if q.dim() != 4 or k_buf.shape != v_buf.shape:
        raise ValueError(f'q {tuple(q.shape)}, k_buf {tuple(k_buf.shape)}, '
                         f'v_buf {tuple(v_buf.shape)}')
    B, Lq, H, Dh = q.shape
    if ks is None:
        T = k_buf.shape[1]
        want = (B, T, H, Dh)
    else:
        T = k_buf.shape[2]
        want = (B, H, T, Dh)
        if ks.shape != (B, H, T) or vs.shape != (B, H, T):
            raise ValueError(f'scales must be {(B, H, T)}, got '
                             f'{tuple(ks.shape)} and {tuple(vs.shape)}')
    if tuple(k_buf.shape) != want:
        raise ValueError(f'buffers must be {want} for q {tuple(q.shape)}, '
                         f'got {tuple(k_buf.shape)}')
    if not isinstance(offset, torch.Tensor) and not (
            0 <= offset and offset + Lq <= T):
        raise ValueError(f'positions [{offset}, {offset + Lq}) do not fit '
                         f'a buffer of length {T}')
    return T


def attention_buffer_plain(q: torch.Tensor, k_buf: torch.Tensor,
                           v_buf: torch.Tensor, offset: Offset,
                           ks: Optional[torch.Tensor] = None,
                           vs: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Online softmax over chunks of the buffer. q (B, Lq, H, Dh); buffers
    (B, T, H, Dh) in q's type or, with scales ks/vs (B, H, T) float32,
    int8 (B, H, T, Dh); returns (B, Lq, H, Dh) in q.dtype.

    Scores, mask, softmax state and both products' sums are float32 on
    values of q's type, and P is rounded to q's type before P @ V, as the
    JAX package does. An int8 chunk is dequantised as the kernel does it,
    `(float(code) * scale)` rounded once to q's type (the JAX chunked path
    rounds the scale first; the two are equal in float32). The chunk keeps
    the float32 scores of one step near 128 MB, and chunks past the last
    query's position are not visited."""
    T = _check_shapes(q, k_buf, v_buf, offset, ks, vs)
    B, L, H, Dh = q.shape
    quantized = ks is not None
    off = _offsets(offset, B, q.device)
    last = int(offset if not isinstance(offset, torch.Tensor)
               else off.max()) + L
    C = min(int(min(2048, max(256, (32 << 20) // max(1, B * H * L)))), T)
    scale = 1.0 / math.sqrt(Dh)
    q32 = q.float().transpose(1, 2)                           # (B, H, L, Dh)
    limit = (off[:, None] + torch.arange(L, device=q.device))[:, None, :,
                                                              None]
    m = torch.full((B, H, L), float('-inf'), device=q.device)
    l = torch.zeros((B, H, L), device=q.device)
    acc = torch.zeros((B, H, L, Dh), device=q.device)
    for c0 in range(0, min(T, last), C):
        c1 = min(T, c0 + C)
        if quantized:
            kc = (k_buf[:, :, c0:c1].float()
                  * ks[:, :, c0:c1, None]).to(q.dtype).float()
            vc = (v_buf[:, :, c0:c1].float()
                  * vs[:, :, c0:c1, None]).to(q.dtype).float()
        else:
            kc = k_buf[:, c0:c1].to(q.dtype).float().transpose(1, 2)
            vc = v_buf[:, c0:c1].to(q.dtype).float().transpose(1, 2)
        s = torch.matmul(q32, kc.transpose(-1, -2)) * scale   # (B, H, L, c)
        col = torch.arange(c0, c1, device=q.device)
        s = s.masked_fill(col > limit, float('-inf'))
        m_new = torch.maximum(m, s.amax(dim=-1))
        finite = torch.isfinite(m_new)
        m_safe = torch.where(finite, m_new, torch.zeros_like(m_new))
        p = torch.where(finite[..., None], torch.exp(s - m_safe[..., None]),
                        torch.zeros_like(s))
        alpha = torch.where(finite, torch.exp(m - m_safe),
                            torch.ones_like(m))
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(
            p.to(q.dtype).float(), vc)
        m = torch.where(finite, m_new, m)
    y = acc / l.clamp(min=1e-30)[..., None]
    return y.transpose(1, 2).to(q.dtype).contiguous()


def flash_attention_buffer(q: torch.Tensor, k_buf: torch.Tensor,
                           v_buf: torch.Tensor, offset: Offset,
                           ks: Optional[torch.Tensor] = None,
                           vs: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Causal attention of the segment q (B, Lq, H, Dh), at absolute
    positions [offset, offset + Lq), over KV buffers whose positions
    [0, offset + Lq) are written: bf16 (B, T, H, Dh), or with scales ks/vs
    (B, H, T) float32 head-major int8 (B, H, T, Dh). `offset` is a Python
    int or an int32 (B,) tensor of per-row offsets. Returns a contiguous
    (B, Lq, H, Dh) in q.dtype.

    A CUDA tensor launches the kernel (or raises on what it does not
    take); a CPU tensor takes the plain version."""
    if not _build.check_device(q, 'flash_attention_buffer'):
        return attention_buffer_plain(q, k_buf, v_buf, offset, ks, vs)
    T = _check_shapes(q, k_buf, v_buf, offset, ks, vs)
    B, Lq, H, Dh = q.shape
    quantized = ks is not None
    if Dh != HEAD_DIM:
        raise ValueError(f'buffer-attention kernel is built for head_dim '
                         f'{HEAD_DIM}, got {Dh}')
    buf_dtype = torch.int8 if quantized else torch.bfloat16
    if q.dtype != torch.bfloat16 or k_buf.dtype != buf_dtype \
            or v_buf.dtype != buf_dtype:
        raise TypeError(f'buffer-attention kernel takes bf16 q and '
                        f'{buf_dtype} buffers, got {q.dtype}, {k_buf.dtype} '
                        f'and {v_buf.dtype}')
    # element strides as (batch, position, head), 16-byte aligned: TMA
    # loads (bf16) or 16-byte loads (int8)
    buf = (16, 2) if quantized else (8, 1)
    strides = []
    for t, unit, t_axis in ((q, 8, 1), (k_buf, *buf), (v_buf, *buf)):
        if t.device != q.device:
            raise ValueError('q and the buffers must lie on one device')
        sb, sl, sh = t.stride(0), t.stride(t_axis), t.stride(3 - t_axis)
        if t.stride(3) != 1 or sb % unit or sl % unit or sh % unit \
                or t.data_ptr() % 16:
            raise ValueError(
                'buffer-attention kernel needs a contiguous head axis, '
                f'strides that are multiples of {unit} elements (16 bytes) '
                f'and 16-byte aligned data, got strides {t.stride()} at '
                f'address {t.data_ptr():#x}')
        strides += [sb, sl, sh]
    if B * H > 65535:
        raise ValueError(f'buffer-attention kernel grid: B*H={B * H} > '
                         f'65535')
    off = _offsets(offset, B, q.device)
    o = torch.empty((B, Lq, H, Dh), dtype=q.dtype, device=q.device)
    if not o.numel():
        return o
    scale = 1.0 / math.sqrt(Dh)
    if quantized:
        for s in (ks, vs):
            if s.dtype != torch.float32 or s.device != q.device \
                    or not s.is_contiguous():
                raise ValueError('scales must be contiguous float32 on '
                                 "q's device")
        _build.launch('evo_flash_attention_buffer_q8',
                      'flash_attention_buffer_q8', q.data_ptr(),
                      k_buf.data_ptr(), v_buf.data_ptr(), ks.data_ptr(),
                      vs.data_ptr(), off.data_ptr(), o.data_ptr(), B, Lq, T,
                      H, *strides, scale)
    else:
        _build.launch('evo_flash_attention_buffer_bf16',
                      'flash_attention_buffer', q.data_ptr(),
                      k_buf.data_ptr(), v_buf.data_ptr(), off.data_ptr(),
                      o.data_ptr(), B, Lq, T, H, *strides, scale)
    return o
