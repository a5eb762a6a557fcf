"""Gated MLP (port of `evo_tpu/layers/mlp.py`):

    y = w3( act(x @ w1) * (x @ w2) )

with the exact-erf GELU of `mlp_activation: gelu`. Weights keep the JAX
layouts: w1, w2 (D, I) and w3 (I, D). Each may be a `QuantizedWeight`
(`quant.py`); `project` dispatches as the JAX package does: `qdot` under
`act_quant` or for an int4 weight, else the product with the `wcast`
weight. Adapters attached by `lora.attach_lora` add their side paths
after each frozen product (`layers/adapters.py`). Under a mesh
(`parallel/`) w1 and w2 hold I/tp columns and w3 the matching rows, whose
partial products are summed over tp.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from evo_tpu_torch.layers.adapters import add_lora
from evo_tpu_torch.parallel.collectives import copy_to_tp, reduce_from_tp
from evo_tpu_torch.parallel.mesh import tp_size
from evo_tpu_torch.quant import project

_ACTS = {
    'gelu': lambda x: F.gelu(x, approximate='none'),
    'gelu_tanh': lambda x: F.gelu(x, approximate='tanh'),
    'silu': F.silu,
    'relu': F.relu,
    'identity': lambda x: x,
}


class GatedMLP(nn.Module):
    def __init__(self, dim: int, inner: int, activation: str, *,
                 dtype: torch.dtype, device: torch.device,
                 act_quant: bool = False, mesh=None):
        super().__init__()
        if activation not in _ACTS:
            raise ValueError(f'unknown mlp_activation {activation!r}')
        self.act = _ACTS[activation]
        self.act_quant = act_quant
        self.mesh = mesh
        inner //= tp_size(mesh)

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype,
                                            device=device),
                                requires_grad=False)

        self.w1 = param(dim, inner)
        self.w2 = param(dim, inner)
        self.w3 = param(inner, dim)
        self.lora, self.lora_scale = {}, 1.0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        aq, mesh = self.act_quant, self.mesh
        x = copy_to_tp(x, mesh)
        z1 = add_lora(self, 'w1', x, project(x, self.w1, 1, aq))
        z2 = add_lora(self, 'w2', x, project(x, self.w2, 1, aq))
        g = self.act(z1) * z2
        return add_lora(self, 'w3', g, reduce_from_tp(
            project(g, self.w3, 1, aq), mesh))
