"""Token sampling: temperature / top-k / top-p (port of
`evo_tpu/ops/sampling.py`). Draws come from an explicit `torch.Generator`;
they cannot match JAX's random bits, so tests hold the filters equal on
fixed logits and compare greedy decoding token for token."""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e10


def top_k_filter(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k largest logits per row, set the rest to NEG_INF."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, NEG_INF, logits)


def top_p_filter(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filter: keep the smallest prefix of the sorted distribution
    with cumulative probability >= p; the top token is always kept."""
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits.float(), dim=-1)
    keep = (torch.cumsum(probs, dim=-1) - probs) < p
    keep[..., 0] = True
    kth = torch.where(keep, sorted_logits, float('inf')).min(
        dim=-1, keepdim=True).values
    return torch.where(logits < kth, NEG_INF, logits)


def sample(logits: torch.Tensor, top_k: int = 0, top_p: float = 1.0,
           temperature: float = 1.0,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Token ids (B,) from logits (B, V); temperature <= 0 or top_k == 1 is
    greedy (argmax, first index on ties)."""
    if temperature <= 0.0 or top_k == 1:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / temperature
    logits = top_p_filter(top_k_filter(logits, top_k), top_p)
    return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                             generator=generator)[:, 0]
