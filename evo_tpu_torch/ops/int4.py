"""Weight-only int4 matmul: the nibble packing, the CUDA kernels
(`csrc/int4_matmul.cu`, `csrc/int4_dots8.cu`) and their plain versions.

Port of `evo_tpu/ops/pallas_int4.py` (`pack_int4`, `unpack_int4_jnp`,
`int4_matmul` in its four modes). Layout, kept because weights cross
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

That is the function of the modes 'unroll' (the default, which every
model path takes, as `evo_tpu/quant.py` does) and 'dots'. Two more modes
are other functions, each with its own kernel instance and plain version,
and no backward (they refuse a tensor that requires grad):

  'block'  each weight dequantized and rounded to bf16, bf16(q * s), and
           the products with x summed in float32, no scale after the sum
           (kernel 8's kBlock instance; counter `int4_matmul_block`);
  'dots8'  each row of x quantized to int8 (scale max|x| / 127, at least
           1e-12; codes rounded half to even, clipped to +-127), exact
           integer dots with the int4 codes a scale group at a time, the
           group scales and then the row scale applied in float32
           (`csrc/int4_dots8.cu`; counter `int4_matmul_dots8`): a launch
           that quantizes x, then the products, on the int8 tensor cores
           above `DOTS8_STREAM_MAX` rows (`wgmma` s8 x s8 -> s32 on
           `mma_plan`'s persistent blocks, each nibble a signed byte of 16 q
           in registers) and by dp4a in a streaming design at or below it.
           Its plain version adds the float32 sums in the order of the
           design the row count takes, so the two are bit-equal.
"""

from __future__ import annotations

import functools

import torch

from evo_tpu_torch.ops import _build
from evo_tpu_torch.ops._grad import needs_grad, plain_vjp, refuse

# `int4_matmul`'s modes, with the JAX names
MODES = ('unroll', 'dots', 'block', 'dots8')

# the kernel keeps all rows of x in one block's tiles: decode and
# forced-token batches are far below this, a batch prefill is not
M_MAX = 128
# up to this many rows the kernel streams the weight with float32 FMAs
# (its entry point takes no more there); more rows take its wgmma design,
# the faster one from 3 rows on at each of evo-1's weight shapes (PERF.md,
# kernel 8)
GEMV_M_MAX = 2
# 'dots8' streams the weight with dp4a up to this many rows; more rows take
# its int8 wgmma design, the faster one from 2 rows on at 4096 x 12288
# (PERF.md, kernel 8c)
DOTS8_STREAM_MAX = 1
# the SMs of the card the CPU tests plan for (H100 SXM); on a card the
# wrapper asks the device
SMS = 132


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


def _unit_block(u: int, U: int, G: int) -> int:
    """The block of unit u when G blocks take U units in equal runs (the
    kernel's `unit_block`)."""
    return ((u + 1) * G + U - 1) // U - 1


@functools.lru_cache(maxsize=4096)
def mma_plan(M: int, Kp: int, N: int, sms: int = SMS):
    """(n, cols, blocks, parts) of the kernel's wgmma design at M rows: x's
    rows padded to n (16, 32, 64 or 128: the product's N side), column
    tiles of `cols` (256 at n <= 32, else 128), and the U = tiles x Kp/256
    units (tile, step of 128 byte rows) shared out in equal runs over
    `blocks` = min(U, sms) persistent blocks, one an SM; a tile whose
    steps fall to more than one block is added up from their `parts`
    (the most any tile has) partial sums, or `parts` is 0 when no tile
    is split."""
    n = 16 if M <= 16 else 32 if M <= 32 else 64 if M <= 64 else 128
    cols = 256 if n <= 32 else 128
    T = Kp // 256
    U = -(-N // cols) * T
    G = min(U, sms)
    if U % G == 0 and (U // G) % T == 0:
        return n, cols, G, 0
    parts = max(_unit_block(t * T + T - 1, U, G) - _unit_block(t * T, U, G)
                + 1 for t in range(U // T))
    return n, cols, G, parts


# per device: the kernel's tickets, one int32 per column tile,
# zeros between launches (the last block of a tile resets its own)
_TICKETS: dict = {}


def _tickets(device, tiles: int) -> torch.Tensor:
    t = _TICKETS.get(device)
    if t is None or t.numel() < tiles:
        t = torch.zeros(max(tiles, 1024), dtype=torch.int32, device=device)
        _TICKETS[device] = t
    return t


# per device: the split tiles' partial sums, float32, taken by one call at
# a time as the tickets are (a decode step's 160 calls allocate nothing).
# The last buffer is the one in use; one that a larger call outgrew stays
# allocated, so a CUDA graph that captured its address still finds it.
_WORKSPACE: dict = {}


def _kept(store: dict, device, numel: int, dtype) -> torch.Tensor:
    held = store.setdefault(device, [])
    if not held or held[-1].numel() < numel:
        held.append(torch.empty(max(numel, 1 << 20), dtype=dtype,
                                device=device))
    return held[-1]


def _workspace(device, numel: int) -> torch.Tensor:
    return _kept(_WORKSPACE, device, numel, torch.float32)


# per device: 'dots8''s row codes (M, Kp) int8 and row scales (M,) float32,
# which its quantize launch writes and its product reads, in one buffer
# kept as the workspace is
_CODES: dict = {}


def _codes(device, M: int, Kp: int):
    buf = _kept(_CODES, device, M * Kp + 4 * M, torch.uint8)
    xq = buf[:M * Kp].view(torch.int8).view(M, Kp)
    xs = buf[M * Kp:M * Kp + 4 * M].view(torch.float32)
    return xq, xs


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


def int4_matmul_block_plain(x: torch.Tensor, packed: torch.Tensor,
                            scales: torch.Tensor,
                            out_dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """'block' mode in plain PyTorch (the JAX test's `_oracle_block`): the
    weight dequantized in float32 and rounded to bf16, x rounded to bf16
    and read as zeros past K, one product summed in float32, rounded once
    to `out_dtype`."""
    M, K, Kp, N = _check_shapes(x, packed, scales)
    _check_out(out_dtype)
    G = Kp // 128
    w = (unpack_int4(packed).float().reshape(G, 128, N) * scales[:, None]
         ).reshape(Kp, N).bfloat16().float()
    xg = x.bfloat16().float()
    if K < Kp:
        xg = torch.nn.functional.pad(xg, (0, Kp - K))
    return (xg @ w).to(out_dtype)


def quantize_rows(x: torch.Tensor):
    """'dots8''s activation codes: x (M, K) rounded to bf16, then per row
    xs = max(max|x| / 127, 1e-12) and codes clip(round(x / xs), +-127)
    (round half to even). Returns (codes (M, K) as float32 integers, xs
    (M, 1) float32)."""
    x32 = x.bfloat16().float()
    amax = x32.abs().amax(dim=1, keepdim=True)
    # divided by a tensor, not by the number 127: on the card PyTorch
    # multiplies by a scalar divisor's reciprocal, which can be an ulp off
    # the division the kernel (and the JAX test's oracle) takes
    xs = (amax / torch.full_like(amax, 127.0)).clamp(min=1e-12)
    return torch.clamp(torch.round(x32 / xs), -127, 127), xs


def dots8_stream_plan(Kp: int, N: int):
    """(splits of the contraction, steps of 128 byte rows a split) of
    'dots8''s streaming design at one row: the columns (512 a block) give
    the blocks, and the contraction is split until there are about 384 of
    them (three an SM)."""
    T = Kp // 256
    steps = -(-T // min(T, max(1, -(-384 // -(-N // 512)))))
    return -(-T // steps), steps


def int4_matmul_dots8_plain(x: torch.Tensor, packed: torch.Tensor,
                            scales: torch.Tensor,
                            out_dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """'dots8' mode in plain PyTorch, in the kernel's order of float32
    operations, so the two agree bit for bit (`dots8_products`), rounded
    once to `out_dtype`."""
    _check_shapes(x, packed, scales)
    _check_out(out_dtype)
    codes, xs = quantize_rows(x)
    return dots8_products(codes, xs, packed, scales).to(out_dtype)


def _plan_sms(t: torch.Tensor) -> int:
    """The SMs the kernel plans for: the card's, or `SMS` on the CPU."""
    return _build.sm_count(t.device.index) if t.device.type == 'cuda' \
        else SMS


def dots8_products(codes: torch.Tensor, xs: torch.Tensor,
                   packed: torch.Tensor, scales: torch.Tensor
                   ) -> torch.Tensor:
    """The product part of 'dots8' on given codes (M, K <= Kp) and row
    scales (M, 1), in the order of the design M takes: float32 (M, N).
    For each step t (byte rows 128 t.., scale groups t and T + t) the exact
    integer dots lo and hi give p = (lo * s_t) + (hi * s_T+t). Above
    `DOTS8_STREAM_MAX` rows (`mma_plan`, stream-K): the steps of a column
    tile that fall to one block add up in order, the tile's parts in block
    order; at or below (`dots8_stream_plan`): the steps of a split in
    order, the splits in order. The sum is multiplied by the row's
    scale."""
    M, K, Kp, N = _check_shapes(codes, packed, scales)
    G, T = Kp // 128, Kp // 256
    if K < Kp:
        codes = torch.nn.functional.pad(codes, (0, Kp - K))
    w = unpack_int4(packed).float().reshape(G, 128, N)
    xg = codes.reshape(M, G, 128)

    def step(t):
        # integer dots of at most 128 x 127 x 8 in magnitude: exact in
        # float32, whatever the order of the sum
        return (xg[:, t] @ w[t]) * scales[t] + \
            (xg[:, T + t] @ w[T + t]) * scales[T + t]
    if M <= DOTS8_STREAM_MAX:
        _, steps = dots8_stream_plan(Kp, N)
        total = None
        for s0 in range(0, T, steps):
            run = None
            for t in range(s0, min(T, s0 + steps)):
                p = step(t)
                run = p if run is None else run + p
            total = run if total is None else total + run
        return total * xs
    # where each column's tile starts and ends a block's segment of steps
    start, end = dots8_segments(M, Kp, N, _plan_sms(codes))
    start, end = start.to(codes.device), end.to(codes.device)
    total = torch.zeros((M, N), dtype=torch.float32, device=codes.device)
    written = torch.zeros(N, dtype=torch.bool, device=codes.device)
    run = None
    for t in range(T):
        p = step(t)
        run = p if run is None else torch.where(start[:, t], p, run + p)
        e = end[:, t]
        total = torch.where(e, torch.where(written, total + run, run), total)
        written = written | e
    return total * xs


def dots8_segments(M: int, Kp: int, N: int, sms: int = SMS):
    """(start, end), bool (N, Kp / 256): whether step t of column n's tile
    is the first, or the last, of a block's segment of that tile under the
    wgmma design's plan (`mma_plan`: U = tiles x T units in equal runs over
    the blocks)."""
    _n, cols, G, _parts = mma_plan(M, Kp, N, sms)
    T = Kp // 256
    tiles = -(-N // cols)
    U = tiles * T
    u = torch.arange(U).reshape(tiles, T)
    blk = ((u + 1) * G + U - 1) // U - 1      # the kernel's `unit_block`
    start = torch.ones((tiles, T), dtype=torch.bool)
    start[:, 1:] = blk[:, 1:] != blk[:, :-1]
    end = torch.ones((tiles, T), dtype=torch.bool)
    end[:, :-1] = start[:, 1:]
    tile = torch.arange(N) // cols
    return start[tile], end[tile]


def int4_matmul_kernel(x: torch.Tensor, packed: torch.Tensor,
                       scales: torch.Tensor,
                       out_dtype: torch.dtype = torch.float32,
                       counter: str = 'int4_matmul',
                       block: bool = False) -> torch.Tensor:
    """Launch the kernel on CUDA tensors (raises on what it does not
    take), counted under `counter`; `block`: the 'block' mode's instance.
    Its output has no autograd history."""
    M, K, Kp, N = _check_shapes(x, packed, scales)
    _check_out(out_dtype)
    _check_operands(x, packed, scales)
    gemv = M <= GEMV_M_MAX
    if not gemv and (K % 8 or x.data_ptr() % 16):
        # the wgmma design copies 16-byte chunks of x
        x = torch.nn.functional.pad(x, (0, Kp - K))
        K = Kp
    y = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if not (M and N):
        return y
    if gemv:
        (splits, tiles), blocks = gemv_plan(Kp, N), 0
        parts = splits if splits > 1 else 0
    else:
        _n, cols, blocks, parts = mma_plan(M, Kp, N,
                                           _build.sm_count(x.device.index))
        tiles = -(-N // cols)
    part = tickets = None      # no split: no workspace
    if parts:
        part = _workspace(x.device, parts * M * N)
        tickets = _tickets(x.device, tiles)
    _build.launch('evo_int4_matmul_bf16', counter, x.data_ptr(),
                  packed.data_ptr(), scales.data_ptr(), y.data_ptr(),
                  None if part is None else part.data_ptr(),
                  None if tickets is None else tickets.data_ptr(), M, K, Kp,
                  N, int(out_dtype == torch.bfloat16), int(gemv), int(block),
                  blocks)
    return y


def _check_operands(x, packed, scales):
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


def int4_dots8_kernel(x: torch.Tensor, packed: torch.Tensor,
                      scales: torch.Tensor,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch the 'dots8' kernel on CUDA tensors (raises on what it does
    not take), counted under 'int4_matmul_dots8': the streaming design up
    to `DOTS8_STREAM_MAX` rows, else the int8 wgmma design on `mma_plan`'s
    blocks. The codes, row scales, partial sums and tickets are the
    device's kept buffers."""
    M, K, Kp, N = _check_shapes(x, packed, scales)
    _check_out(out_dtype)
    _check_operands(x, packed, scales)
    y = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if not (M and N):
        return y
    if M <= DOTS8_STREAM_MAX:
        splits, steps = dots8_stream_plan(Kp, N)
        blocks, parts = 0, (splits if splits > 1 else 0)
        tiles = -(-N // 512)
    else:
        _n, cols, blocks, parts = mma_plan(M, Kp, N,
                                           _build.sm_count(x.device.index))
        steps = 0
        tiles = -(-N // cols)
    xq, xs = _codes(x.device, M, Kp)
    part = tickets = None      # no split: no workspace
    if parts:
        part = _workspace(x.device, parts * M * N)
        tickets = _tickets(x.device, tiles)
    _build.launch('evo_int4_dots8_bf16', 'int4_matmul_dots8', x.data_ptr(),
                  packed.data_ptr(), scales.data_ptr(), y.data_ptr(),
                  xq.data_ptr(), xs.data_ptr(),
                  None if part is None else part.data_ptr(),
                  None if tickets is None else tickets.data_ptr(), M, K, Kp,
                  N, steps, blocks, int(out_dtype == torch.bfloat16))
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
                out_dtype: torch.dtype = torch.float32,
                mode: str = 'unroll') -> torch.Tensor:
    """x (M, K) bf16 with K <= Kp, the weight's padded contraction (columns
    K..Kp-1 count as zeros); packed (Kp/2, N) int8; scales (Kp/128, N)
    float32 -> (M, N) in `out_dtype` (float32 or bfloat16: one rounding of
    the float32 sum). `mode`: the JAX kernel's, 'unroll' (the default) or
    'dots' (one function), 'block' or 'dots8' (the module docstring);
    another raises. A CUDA tensor launches the mode's kernel (or raises on
    what it does not take), under 'unroll' / 'dots' through
    `Int4MatmulFunction` when x requires grad (counted as
    'int4_matmul_grad'); 'block' and 'dots8' refuse x that requires grad.
    A CPU tensor takes the mode's plain version."""
    if mode not in MODES:
        raise ValueError(f'unknown int4_matmul mode {mode!r} (expected one '
                         f'of {MODES})')
    if mode in ('block', 'dots8'):
        refuse(f'int4_matmul mode {mode!r}', x)
        plain = (int4_matmul_block_plain if mode == 'block'
                 else int4_matmul_dots8_plain)
        if not _build.check_device(x, 'int4_matmul'):
            return plain(x, packed, scales, out_dtype)
        if mode == 'dots8':
            return int4_dots8_kernel(x, packed, scales, out_dtype)
        return int4_matmul_kernel(x, packed, scales, out_dtype,
                                  'int4_matmul_block', block=True)
    if not _build.check_device(x, 'int4_matmul'):
        return int4_matmul_plain(x, packed, scales, out_dtype)
    if needs_grad(x):
        return Int4MatmulFunction.apply(x, packed, scales, out_dtype,
                                        _kernel_under_grad)
    return int4_matmul_kernel(x, packed, scales, out_dtype)
