"""Hyena FIR + gate: the CUDA kernel (`csrc/fir_gate.cu`) and its plain
version.

Port of `evo_tpu/ops/pallas_fir.py:fir_gate_pallas`; the plain version is
`ops/fftconv.py:fir_causal_conv` followed by the gate, as in
`evo_tpu/layers/hyena.py:182-185`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from evo_tpu_torch.ops import _build
from evo_tpu_torch.ops.fftconv import fir_causal_conv


def fir_gate_plain(z: torch.Tensor, w: torch.Tensor,
                   b: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """z: (B, 3, C, L); w: (3, C, K); b: (3, C) or None. Returns
    (x2, u = x1 * v), each (B, C, L) in z.dtype, for a fresh sequence (zero
    FIR state); the FIR output is rounded to z.dtype before the gate."""
    zf, _ = fir_causal_conv(z, w, b)
    return zf[:, 0], zf[:, 1] * zf[:, 2]


def fir_gate(z: torch.Tensor, w: torch.Tensor,
             b: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused FIR + gate. A CUDA tensor launches the kernel (or raises on
    what it does not take); a CPU tensor takes the plain version."""
    if not _build.check_device(z, 'fir_gate'):
        return fir_gate_plain(z, w, b)
    if z.dim() != 4 or z.shape[1] != 3:
        raise ValueError(f'fir_gate: z must be (B, 3, C, L), got '
                         f'{tuple(z.shape)}')
    B, _, C, L = z.shape
    K = w.shape[-1]
    if z.dtype != torch.bfloat16:
        raise TypeError(f'fir_gate kernel takes bf16, got {z.dtype}')
    tensors = [z, w] + ([b] if b is not None else [])
    for t in tensors:
        if t.dtype != z.dtype or t.device != z.device \
                or not t.is_contiguous():
            raise ValueError('fir_gate kernel needs contiguous z, w, b of '
                             'one type on one device')
    if w.shape != (3, C, K) or (b is not None and b.shape != (3, C)):
        raise ValueError(f'fir_gate: w {tuple(w.shape)} / b '
                         f'{None if b is None else tuple(b.shape)} do not '
                         f'match z {tuple(z.shape)}')
    x2 = torch.empty((B, C, L), dtype=z.dtype, device=z.device)
    u = torch.empty_like(x2)
    if x2.numel():
        _build.launch('evo_fir_gate_bf16', 'fir_gate', z.data_ptr(),
                      w.data_ptr(), None if b is None else b.data_ptr(),
                      x2.data_ptr(), u.data_ptr(), B, C, L, K)
    return x2, u
