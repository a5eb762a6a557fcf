"""Rotary position embeddings, GPT-NeoX rotate-half, in float32 (port of
`evo_tpu/layers/rotary.py`). With `use_interpolated_rotary_pos_emb` (the
131k config) positions are divided by `rotary_emb_scaling_factor`."""

from __future__ import annotations

import torch


def rotary_cos_sin(positions: torch.Tensor, head_dim: int,
                   base: float = 10000.0, scaling_factor: float = 1.0):
    """positions: integer tensor (L,), or (B, L) for per-row positions ->
    (cos, sin), each (*positions.shape, head_dim // 2) float32."""
    half = head_dim // 2
    inv_freq = 1.0 / (base ** (torch.arange(
        half, dtype=torch.float32, device=positions.device) / half))
    t = positions.to(torch.float32)
    if scaling_factor != 1.0:
        t = t / scaling_factor
    freqs = t[..., None] * inv_freq
    return torch.cos(freqs), torch.sin(freqs)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """x: (B, L, H, Dh); cos/sin: (L, Dh // 2) shared by the batch, or
    (B, L, Dh // 2) per row. Returns x's type."""
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)
