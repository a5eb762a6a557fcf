"""RMSNorm layer (port of `evo_tpu/layers/norms.py`): fp32 statistics,
output in the input type. The arithmetic lives in `ops/rmsnorm.py`, whose
wrapper launches the CUDA kernel for a CUDA tensor and runs the plain
version for a CPU tensor."""

from __future__ import annotations

import torch
from torch import nn

from evo_tpu_torch.ops.rmsnorm import rmsnorm


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, *, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(
            torch.ones(dim, dtype=dtype, device=device), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(x, self.weight, self.eps)
