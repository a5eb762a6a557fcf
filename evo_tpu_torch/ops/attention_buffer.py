"""Attention of a query segment at an offset over a KV buffer: the CUDA
kernels (`csrc/flash_attention_buffer.cu`: bf16 and int8 buffers on the
Hopper mainloop of `csrc/flash_sm90.cuh`; int8 buffers at few query rows
on a split of the key range and a combine kernel) and their plain
versions.

Port of `evo_tpu/ops/pallas_attention.py:flash_attention_buffer`; the plain
version is the chunked online softmax of `mha_full` in
`evo_tpu/layers/attention.py`. Query row r of batch row b is absolute
position `offset[b] + r` and attends the keys `col <= offset[b] + r`.

A masked key still meets `p = 0` in P @ V, and 0 * NaN is NaN: buffers hold
finite values everywhere (the cache is made of zeros, never left empty).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch

from evo_tpu_torch.ops import _build
from evo_tpu_torch.ops._grad import refuse
from evo_tpu_torch.ops.attention import HEAD_DIM

Offset = Union[int, torch.Tensor]

# The int8 kernel's two regimes: up to this many query rows (decode, and
# the short tail of a resumed prompt) the key range is split across blocks
# and the partials are combined; above it the TMA + wgmma mainloop runs
# 128-row query tiles. At the end of a 131k buffer (chip_smoke.py phase 2,
# NVIDIA H100 80GB HBM3 at 700 W) the split takes 0.44, 0.48 and 0.70 ms
# at 1, 2 and 4 rows, the mainloop 1.97-1.98 ms at 1 to 8 rows: the split
# wins up to 4, the most rows it is compiled for (254 registers there).
SPLIT_MAX_ROWS = 4
SPLIT_STEP = 64           # keys a block of the split kernel takes a step


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


def _softmax_state(q, k_buf, v_buf, off, ks, vs, lo: int, hi: int):
    """The online-softmax state of every query row over the keys [lo, hi)
    of the buffer: (m (B, H, L) float32, the largest scaled score, -inf
    where the row sees no key there; l (B, H, L), the sum of
    exp(score - m); acc (B, H, L, Dh), the sum of exp(score - m) rounded
    to q's type times v). Chunks past the last query's position are not
    visited."""
    T = k_buf.shape[2 if ks is not None else 1]
    B, L, H, Dh = q.shape
    quantized = ks is not None
    last = int(off.max()) + L
    C = min(int(min(2048, max(256, (32 << 20) // max(1, B * H * L)))), T)
    scale = 1.0 / math.sqrt(Dh)
    q32 = q.float().transpose(1, 2)                           # (B, H, L, Dh)
    limit = (off[:, None] + torch.arange(L, device=q.device))[:, None, :,
                                                              None]
    m = torch.full((B, H, L), float('-inf'), device=q.device)
    l = torch.zeros((B, H, L), device=q.device)
    acc = torch.zeros((B, H, L, Dh), device=q.device)
    for c0 in range(lo, min(hi, T, last), C):
        c1 = min(hi, T, c0 + C)
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
    return m, l, acc


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
    _, l, acc = _softmax_state(q, k_buf, v_buf,
                               _offsets(offset, q.shape[0], q.device), ks,
                               vs, 0, T)
    y = acc / l.clamp(min=1e-30)[..., None]
    return y.transpose(1, 2).to(q.dtype).contiguous()


def attention_buffer_partials_plain(q: torch.Tensor, k_buf: torch.Tensor,
                                    v_buf: torch.Tensor, offset: Offset,
                                    bounds: Sequence[int],
                                    ks: Optional[torch.Tensor] = None,
                                    vs: Optional[torch.Tensor] = None):
    """The partials of the split key range: for the S ranges
    [bounds[i], bounds[i + 1]) the online-softmax state of
    `_softmax_state`, as the split kernel writes it: m, l (B, H, Lq, S)
    and acc (B, H, Lq, S, Dh), float32. A range wholly past a row's live
    prefix gives m = -inf, l = 0, acc = 0."""
    _check_shapes(q, k_buf, v_buf, offset, ks, vs)
    off = _offsets(offset, q.shape[0], q.device)
    parts = [_softmax_state(q, k_buf, v_buf, off, ks, vs, lo, hi)
             for lo, hi in zip(bounds[:-1], bounds[1:])]
    m, l, acc = (torch.stack(t, dim=3) for t in zip(*parts))
    return m, l, acc


def combine_partials_plain(m: torch.Tensor, l: torch.Tensor,
                           acc: torch.Tensor,
                           dtype: torch.dtype = torch.bfloat16
                           ) -> torch.Tensor:
    """Merge the partials m, l (B, H, Lq, S), acc (B, H, Lq, S, Dh) of a
    split key range: each is weighted by exp(m - max m), a partial with
    m = -inf by 0. Returns (B, Lq, H, Dh) in `dtype`, contiguous."""
    M = m.amax(dim=-1, keepdim=True)
    w = torch.where(torch.isfinite(m), torch.exp(m - torch.where(
        torch.isfinite(M), M, torch.zeros_like(M))), torch.zeros_like(m))
    L = (w * l).sum(dim=-1)
    y = (w[..., None] * acc).sum(dim=-2) / L.clamp(min=1e-30)[..., None]
    return y.transpose(1, 2).to(dtype).contiguous()


def combine_partials(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """`combine_partials_plain`; a CUDA tensor launches the combine kernel
    (bf16 output; or raises), a CPU tensor takes the plain version."""
    if not _build.check_device(m, 'combine_partials'):
        return combine_partials_plain(m, l, acc, dtype)
    B, H, Lq, S = m.shape
    if dtype != torch.bfloat16:
        raise TypeError(f'combine kernel writes bf16, not {dtype}')
    for t, shape in ((m, (B, H, Lq, S)), (l, (B, H, Lq, S)),
                     (acc, (B, H, Lq, S, HEAD_DIM))):
        if t.shape != shape or t.dtype != torch.float32 \
                or t.device != m.device or not t.is_contiguous():
            raise ValueError(f'partials must be contiguous float32 of '
                             f'{shape} on one device, got {t.dtype} '
                             f'{tuple(t.shape)}')
    o = torch.empty((B, Lq, H, HEAD_DIM), dtype=dtype, device=m.device)
    if o.numel():
        _build.launch('evo_combine_partials', 'combine_partials',
                      m.data_ptr(), l.data_ptr(), acc.data_ptr(),
                      o.data_ptr(), B, H, Lq, S)
    return o


def key_splits(n_keys: int, n_heads: int, n_sms: int):
    """(chunk, S): the split of [0, n_keys) into S ranges of `chunk` keys
    (a multiple of the split kernel's 64-key step) for `n_heads` (batch,
    head) pairs: about four blocks on each of `n_sms` SMs, and no more
    ranges than n_keys / 512 rounded up."""
    want = max(1, -(-4 * n_sms // n_heads))
    S = max(1, min(want, -(-n_keys // 512)))
    chunk = -(-n_keys // S)
    chunk = -(-chunk // SPLIT_STEP) * SPLIT_STEP
    return chunk, -(-n_keys // chunk)


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
    take): int8 buffers at up to SPLIT_MAX_ROWS query rows launch the
    split kernel and the combine kernel, counted apart. A CPU tensor takes
    the plain version."""
    if not _build.check_device(q, 'flash_attention_buffer'):
        return attention_buffer_plain(q, k_buf, v_buf, offset, ks, vs)
    refuse('flash_attention_buffer', q, k_buf, v_buf)
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
    # loads, and the split kernel's 16-byte loads
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
    if not q.numel():
        return torch.empty_like(q, memory_format=torch.contiguous_format)
    scale = 1.0 / math.sqrt(Dh)
    ptrs = (q.data_ptr(), k_buf.data_ptr(), v_buf.data_ptr())
    if quantized:
        for s in (ks, vs):
            if s.dtype != torch.float32 or s.device != q.device \
                    or not s.is_contiguous():
                raise ValueError('scales must be contiguous float32 on '
                                 "q's device")
        ptrs += (ks.data_ptr(), vs.data_ptr())
    if quantized and Lq <= SPLIT_MAX_ROWS:
        # keys past the live prefix need no block; with device offsets the
        # prefix is not known here, and blocks past a row's end drop out
        n_keys = min(T, offset + Lq) if isinstance(offset, int) else T
        chunk, S = key_splits(n_keys, B * H, _build.sm_count(
            q.device.index if q.device.index is not None
            else torch.cuda.current_device()))
        m = torch.empty((B, H, Lq, S), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
        acc = torch.empty((B, H, Lq, S, Dh), dtype=torch.float32,
                          device=q.device)
        _build.launch('evo_flash_attention_buffer_q8_split',
                      'flash_attention_buffer_q8', *ptrs, off.data_ptr(),
                      m.data_ptr(), l.data_ptr(), acc.data_ptr(), B, Lq, T,
                      H, *strides, chunk, S, scale)
        return combine_partials(m, l, acc)
    o = torch.empty((B, Lq, H, Dh), dtype=q.dtype, device=q.device)
    entry, counter = (
        ('evo_flash_attention_buffer_q8', 'flash_attention_buffer_q8')
        if quantized else
        ('evo_flash_attention_buffer_bf16', 'flash_attention_buffer'))
    _build.launch(entry, counter, *ptrs, off.data_ptr(), o.data_ptr(), B, Lq,
                  T, H, *strides, scale)
    return o
