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
after each group's dot.
"""

from __future__ import annotations

import torch

from evo_tpu_torch.ops import _build

# the kernel keeps all rows of x in one block's tiles: decode and
# forced-token batches are far below this, a batch prefill is not
M_MAX = 128


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


def _check_shapes(x, packed, scales):
    M, Kp = x.shape
    half, N = packed.shape
    if 2 * half != Kp or scales.shape != (Kp // 128, N):
        raise ValueError(
            f'int4_matmul: x {tuple(x.shape)}, packed {tuple(packed.shape)} '
            f'and scales {tuple(scales.shape)} do not fit (packed is '
            f'(Kp/2, N), scales (Kp/128, N))')
    if not int4_matmul_supported(M, Kp):
        raise ValueError(f'int4_matmul takes M <= {M_MAX} rows and Kp % 256 '
                         f'== 0, got M={M}, Kp={Kp}')
    return M, Kp, N


def int4_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                      scales: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: x (M, Kp) rounded to bf16,
    float32 dot per group of 128 rows, scaled and summed in float32.
    Returns (M, N) float32."""
    M, Kp, N = _check_shapes(x, packed, scales)
    G = Kp // 128
    w = unpack_int4(packed).float().reshape(G, 128, N)
    xg = x.bfloat16().float().reshape(M, G, 128)
    acc = torch.zeros((M, N), dtype=torch.float32, device=x.device)
    for g in range(G):
        acc += (xg[:, g] @ w[g]) * scales[g]
    return acc


def int4_matmul(x: torch.Tensor, packed: torch.Tensor,
                scales: torch.Tensor) -> torch.Tensor:
    """x (M, Kp) bf16, zero-padded to the weight's padded contraction;
    packed (Kp/2, N) int8; scales (Kp/128, N) float32 -> (M, N) float32.
    A CUDA tensor launches the kernel (or raises on what it does not
    take); a CPU tensor takes the plain version."""
    if not _build.check_device(x, 'int4_matmul'):
        return int4_matmul_plain(x, packed, scales)
    M, Kp, N = _check_shapes(x, packed, scales)
    if (x.dtype != torch.bfloat16 or packed.dtype != torch.int8
            or scales.dtype != torch.float32):
        raise TypeError(f'int4_matmul kernel takes bf16 x, int8 packed and '
                        f'float32 scales, got {x.dtype}, {packed.dtype} and '
                        f'{scales.dtype}')
    if packed.device != x.device or scales.device != x.device:
        raise ValueError('int4_matmul: x, packed and scales must lie on one '
                         'device')
    if not (x.is_contiguous() and packed.is_contiguous()
            and scales.is_contiguous()) or x.data_ptr() % 16:
        raise ValueError('int4_matmul kernel needs contiguous operands and '
                         'a 16-byte aligned x')
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M and N:
        _build.launch('evo_int4_matmul_bf16', 'int4_matmul', x.data_ptr(),
                      packed.data_ptr(), scales.data_ptr(), y.data_ptr(),
                      M, Kp, N)
    return y
