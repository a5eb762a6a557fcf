"""Ulysses attention: causal attention with the sequence split over the cp
axis of the mesh (port of `evo_tpu/ops/ulysses_attention.py`).

One all-to-all over cp turns this rank's rows of every head into the whole
sequence of its block of heads, the causal flash kernel (kernel 3,
`ops/attention.py`) runs on that block, and the reverse all-to-all gives
back this rank's rows of every head. Needs heads % cp == 0 and L % cp ==
0; the model pads a ragged L (`model.py`) and `layers/attention.py` takes
its own path where the heads do not divide.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from evo_tpu_torch.ops.attention import flash_attention_causal
from evo_tpu_torch.parallel.collectives import heads_to_seq, seq_to_heads


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh, seq_len: Optional[int] = None,
                      core: Callable = flash_attention_causal
                      ) -> torch.Tensor:
    """Causal attention of the sequence whose rows [cp_i L/cp, (cp_i + 1)
    L/cp) this rank holds: q, k, v (B, L/cp, H, Dh) -> (B, L/cp, H, Dh),
    the rows of `flash_attention_causal` over the whole sequence.

    seq_len: the real positions of a padded sequence; the core sees only
    those, and the padded rows of the result are zeros. core(q, k, v):
    the attention over the whole sequence of this rank's H/cp heads (the
    layer's also writes k and v to the cache, or attends the cache)."""
    padded = q.shape[1] * mesh.cp
    qkv = seq_to_heads(torch.stack([q, k, v], dim=2), mesh, 3)[:, :seq_len]
    y = core(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    if y.shape[1] < padded:
        y = torch.nn.functional.pad(y, (0, 0, 0, 0, 0, padded - y.shape[1]))
    return heads_to_seq(y, mesh, 2)
