"""Gated MLP (port of `evo_tpu/layers/mlp.py`):

    y = w3( act(x @ w1) * (x @ w2) )

with the exact-erf GELU of `mlp_activation: gelu`. Weights keep the JAX
layouts: w1, w2 (D, I) and w3 (I, D).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

_ACTS = {
    'gelu': lambda x: F.gelu(x, approximate='none'),
    'gelu_tanh': lambda x: F.gelu(x, approximate='tanh'),
    'silu': F.silu,
    'relu': F.relu,
    'identity': lambda x: x,
}


class GatedMLP(nn.Module):
    def __init__(self, dim: int, inner: int, activation: str, *,
                 dtype: torch.dtype, device: torch.device):
        super().__init__()
        if activation not in _ACTS:
            raise ValueError(f'unknown mlp_activation {activation!r}')
        self.act = _ACTS[activation]

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype,
                                            device=device),
                                requires_grad=False)

        self.w1 = param(dim, inner)
        self.w2 = param(dim, inner)
        self.w3 = param(inner, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (self.act(x @ self.w1) * (x @ self.w2)) @ self.w3
