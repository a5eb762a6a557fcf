"""Weight-only int4 matmul: the nibble packing, the CUDA kernel
(`csrc/int4_matmul.cu`) and its plain version.

Port of `evo_tpu/ops/pallas_int4.py` (`pack_int4`, `unpack_int4_jnp`,
`int4_matmul` in its default mode). Layout, kept because weights cross
between the two packages in it: the contraction axis is padded to a
multiple of 256; byte row j of the (Kp/2, N) packed array holds natural
row j in its low nibble, stored as value + 8, and natural row Kp/2 + j in
its high nibble in two's complement. Scales are float32, one per (group
of 128 natural rows, output column):

    y[m, n] = sum_g scales[g, n] * (x[m, 128g:128(g+1)] @ w[128g:128(g+1), n])

with bf16 products summed in float32 and the scale applied in float32
after each group's dot. x may stop at the weight's natural contraction K
(columns K..Kp-1 count as zeros, so no padded copy is made), and y comes
out in float32 or, rounded once, in bf16. Under autograd (LoRA over an
int4 base) the kernel runs inside `Int4MatmulFunction`, whose backward is
the plain version's gradient to x (`ops/_grad.py`).
"""

from __future__ import annotations

import torch

from evo_tpu_torch.ops import _build
from evo_tpu_torch.ops._grad import needs_grad, plain_vjp

# the kernel keeps all rows of x in one block's tiles: decode and
# forced-token batches are far below this, a batch prefill is not
M_MAX = 128
# up to this many rows (a decode step's batch) the kernel streams the
# weight with float32 FMAs; more rows take its mma.sync design, the faster
# one from 5 rows on (PERF.md, kernel 8)
GEMV_M_MAX = 4


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(Kp, N) int4 values in int8 storage -> (Kp/2, N) packed bytes; Kp a
    multiple of 256. Byte j = ((row j + 8) & 15) | (row Kp/2 + j) << 4."""
    Kp, _ = q.shape
    if Kp % 256:
        raise ValueError(f'pack_int4 needs Kp % 256 == 0, got {Kp}')
    g = q.to(torch.int32)
    b = ((g[:Kp // 2] + 8) & 15) | ((g[Kp // 2:] & 15) << 4)   # [0, 255]
    return torch.where(b > 127, b - 256, b).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of `pack_int4`: (Kp/2, N) -> (Kp, N) int8 in [-8, 7]."""
    b = packed.to(torch.int32) & 255
    lo = (b & 15) - 8
    hi = b >> 4
    hi = torch.where(hi > 7, hi - 16, hi)
    return torch.cat([lo, hi], dim=0).to(torch.int8)


def int4_matmul_supported(m: int, kp: int) -> bool:
    return m <= M_MAX and kp % 256 == 0


def gemv_plan(Kp: int, N: int):
    """(splits, column tiles) of the kernel's streaming design: column
    tiles of 512, one block a tile and a step of 128 byte rows, so Kp / 256
    splits of the contraction (128 to 384 blocks at evo-1's shapes)."""
    return Kp // 256, -(-N // 512)


# per device: the streaming design's tickets, one int32 per column tile,
# zeros between launches (the last block of a tile resets its own)
_TICKETS: dict = {}


def _tickets(device, tiles: int) -> torch.Tensor:
    t = _TICKETS.get(device)
    if t is None or t.numel() < tiles:
        t = torch.zeros(max(tiles, 1024), dtype=torch.int32, device=device)
        _TICKETS[device] = t
    return t


def _check_shapes(x, packed, scales):
    M, K = x.shape
    half, N = packed.shape
    Kp = 2 * half
    if K > Kp or scales.shape != (Kp // 128, N):
        raise ValueError(
            f'int4_matmul: x {tuple(x.shape)}, packed {tuple(packed.shape)} '
            f'and scales {tuple(scales.shape)} do not fit (x is (M, K) with '
            f'K <= Kp, packed (Kp/2, N), scales (Kp/128, N))')
    if not int4_matmul_supported(M, Kp):
        raise ValueError(f'int4_matmul takes M <= {M_MAX} rows and Kp % 256 '
                         f'== 0, got M={M}, Kp={Kp}')
    return M, K, Kp, N


def _check_out(out_dtype):
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'int4_matmul writes float32 or bfloat16, not '
                        f'{out_dtype}')


def int4_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                      scales: torch.Tensor,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's function in plain PyTorch: x (M, K <= Kp) rounded to
    bf16 and read as zeros past K, float32 dot per group of 128 rows,
    scaled and summed in float32, rounded once to `out_dtype`. Returns
    (M, N)."""
    M, K, Kp, N = _check_shapes(x, packed, scales)
    _check_out(out_dtype)
    G = Kp // 128
    w = unpack_int4(packed).float().reshape(G, 128, N)
    xg = x.bfloat16().float()
    if K < Kp:
        xg = torch.nn.functional.pad(xg, (0, Kp - K))
    xg = xg.reshape(M, G, 128)
    acc = torch.zeros((M, N), dtype=torch.float32, device=x.device)
    for g in range(G):
        acc += (xg[:, g] @ w[g]) * scales[g]
    return acc.to(out_dtype)


def int4_matmul_kernel(x: torch.Tensor, packed: torch.Tensor,
                       scales: torch.Tensor,
                       out_dtype: torch.dtype = torch.float32,
                       counter: str = 'int4_matmul') -> torch.Tensor:
    """Launch the kernel on CUDA tensors (raises on what it does not
    take), counted under `counter`. Its output has no autograd
    history."""
    M, K, Kp, N = _check_shapes(x, packed, scales)
    _check_out(out_dtype)
    if (x.dtype != torch.bfloat16 or packed.dtype != torch.int8
            or scales.dtype != torch.float32):
        raise TypeError(f'int4_matmul kernel takes bf16 x, int8 packed and '
                        f'float32 scales, got {x.dtype}, {packed.dtype} and '
                        f'{scales.dtype}')
    if packed.device != x.device or scales.device != x.device:
        raise ValueError('int4_matmul: x, packed and scales must lie on one '
                         'device')
    if not (x.is_contiguous() and packed.is_contiguous()
            and scales.is_contiguous()):
        raise ValueError('int4_matmul kernel needs contiguous operands')
    gemv = M <= GEMV_M_MAX
    if not gemv and (K % 8 or x.data_ptr() % 16):
        # the mma.sync design copies 16-byte chunks of x
        x = torch.nn.functional.pad(x, (0, Kp - K))
        K = Kp
    y = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if not (M and N):
        return y
    part = tickets = None      # one split: no workspace
    if gemv:
        splits, tiles = gemv_plan(Kp, N)
        if splits > 1:
            part = torch.empty(splits * M * N, dtype=torch.float32,
                               device=x.device)
            tickets = _tickets(x.device, tiles)
    _build.launch('evo_int4_matmul_bf16', counter, x.data_ptr(),
                  packed.data_ptr(), scales.data_ptr(), y.data_ptr(),
                  None if part is None else part.data_ptr(),
                  None if tickets is None else tickets.data_ptr(), M, K, Kp,
                  N, int(out_dtype == torch.bfloat16), int(gemv))
    return y


class Int4MatmulFunction(torch.autograd.Function):
    """`forward_impl(x, packed, scales, out_dtype)` (the kernel) with the
    gradient of `int4_matmul_plain` to x, recomputed from the saved
    inputs: dx = dy dequant(W)^T at x's K columns, in x's type (LoRA over
    an int4 base at up to 128 rows). The codes and the scales get none:
    they are frozen buffers."""

    @staticmethod
    def forward(ctx, x, packed, scales, out_dtype, forward_impl):
        ctx.save_for_backward(x, packed, scales)
        ctx.out_dtype = out_dtype
        return forward_impl(x, packed, scales, out_dtype)

    @staticmethod
    def backward(ctx, gy):
        x, packed, scales = ctx.saved_tensors
        gx, _, _ = plain_vjp(
            lambda a, p, s: int4_matmul_plain(a, p, s, ctx.out_dtype),
            (x, packed, scales), (True, False, False), (gy,))
        return gx, None, None, None, None


def _kernel_under_grad(x, packed, scales, out_dtype):
    return int4_matmul_kernel(x, packed, scales, out_dtype,
                              'int4_matmul_grad')


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x (M, K) bf16 with K <= Kp, the weight's padded contraction (columns
    K..Kp-1 count as zeros); packed (Kp/2, N) int8; scales (Kp/128, N)
    float32 -> (M, N) in `out_dtype` (float32 or bfloat16: one rounding of
    the float32 sum). A CUDA tensor launches the kernel (or raises on what
    it does not take), through `Int4MatmulFunction` when x requires grad
    (counted as 'int4_matmul_grad'); a CPU tensor takes the plain
    version."""
    if not _build.check_device(x, 'int4_matmul'):
        return int4_matmul_plain(x, packed, scales, out_dtype)
    if needs_grad(x):
        return Int4MatmulFunction.apply(x, packed, scales, out_dtype,
                                        _kernel_under_grad)
    return int4_matmul_kernel(x, packed, scales, out_dtype)
