"""Fused front half of the gated MLP, act(x @ w1) * (x @ w2): the CUDA
kernel (`csrc/mlp_gate.cu`) and its plain version.

Port of `evo_tpu/ops/pallas_mlp.py:fused_gate_pallas`. Both products are
summed in float32 and the result is rounded once, to `x.dtype`; the (M, I)
intermediates never reach device memory. As in the JAX package, no layer
calls it: `layers/mlp.py` keeps its two projections (each rounded to the
activation type) and the gate.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from evo_tpu_torch.ops import _build
from evo_tpu_torch.ops._grad import refuse

# activation name -> (the kernel's code, the plain function)
_ACTS = {
    'gelu': (0, lambda v: F.gelu(v, approximate='none')),
    'gelu_tanh': (1, lambda v: F.gelu(v, approximate='tanh')),
    'silu': (2, F.silu),
    'relu': (3, F.relu),
    'identity': (4, lambda v: v),
}


def _act(activation: str):
    if activation not in _ACTS:
        raise ValueError(f'unknown activation {activation!r} (expected one '
                         f'of {sorted(_ACTS)})')
    return _ACTS[activation]


def fused_gate_plain(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                     activation: str = 'gelu') -> torch.Tensor:
    """x: (..., D); w1, w2: (D, I). Returns act(x @ w1) * (x @ w2) as
    (..., I) in x.dtype, with float32 products, activation and gate."""
    act = _act(activation)[1]
    x32 = x.float()
    return (act(x32 @ w1.float()) * (x32 @ w2.float())).to(x.dtype)


def fused_gate(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
               activation: str = 'gelu') -> torch.Tensor:
    """act(x @ w1) * (x @ w2), fused, for any number of rows and any inner
    width. CUDA tensors launch the kernel (`csrc/mlp_gate.cu`: TMA +
    wgmma, a 64-row tile at M <= 64), or raise on what it does not take;
    CPU tensors take the plain version."""
    code = _act(activation)[0]
    if not _build.check_device(x, 'fused_gate'):
        return fused_gate_plain(x, w1, w2, activation)
    refuse('fused_gate', x, w1, w2)
    if x.dtype != torch.bfloat16:
        raise TypeError(f'fused_gate kernel takes bf16, got {x.dtype}')
    D = x.shape[-1]
    if w1.dim() != 2 or w1.shape[0] != D or w2.shape != w1.shape:
        raise ValueError(f'fused_gate: w1 {tuple(w1.shape)} and w2 '
                         f'{tuple(w2.shape)} must both be ({D}, I)')
    for w in (w1, w2):
        if w.dtype != x.dtype or w.device != x.device \
                or not w.is_contiguous():
            raise ValueError('fused_gate kernel needs contiguous weights of '
                             "x's type on x's device")
    I = w1.shape[1]
    x2 = x.reshape(-1, D)
    M = x2.shape[0]
    out = torch.empty((M, I), dtype=x.dtype, device=x.device)
    if not out.numel():
        return out.reshape(x.shape[:-1] + (I,))
    # TMA takes 16-byte strides and bases: D and I padded to multiples of
    # 8 with zeros, which add nothing to the products, as the JAX wrapper
    # pads its blocks
    Dp, Ip = -(-D // 8) * 8, -(-I // 8) * 8
    x2 = _aligned(F.pad(x2, (0, Dp - D)) if Dp != D else x2)
    w1p, w2p = (_aligned(F.pad(w, (0, Ip - I, 0, Dp - D))
                         if (Dp, Ip) != (D, I) else w) for w in (w1, w2))
    o = out if Ip == I else torch.empty((M, Ip), dtype=x.dtype,
                                        device=x.device)
    _build.launch('evo_mlp_gate_bf16', 'mlp_gate', x2.data_ptr(),
                  w1p.data_ptr(), w2p.data_ptr(), o.data_ptr(), M, Dp, Ip,
                  code)
    if o is not out:
        out.copy_(o[:, :I])
    return out.reshape(x.shape[:-1] + (I,))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous at a 16-byte aligned address (a copy if need be)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()
