"""Rotary multi-head attention, the 3 attention layers of evo-1 (port of
`evo_tpu/layers/attention.py`).

Weights keep the JAX layouts: wqkv (D, 3, H, Dh), wo (H, Dh, D), bqkv
(3, H, Dh), bo (D,). The KV cache is a dict of preallocated (B, T, H, Dh)
buffers {'k', 'v'} that this module writes in place at the cache offset,
as the reference engine updates its `inference_params_dict`.

Ported paths: a fresh full sequence (`mha_full`, which fills the KV cache
from position 0) and the single-token decode step (`mha_step`). Attending a
new segment over a filled buffer (resumed prefill) is not ported yet.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from evo_tpu_torch.config import ModelConfig
from evo_tpu_torch.layers.rotary import apply_rotary, rotary_cos_sin
from evo_tpu_torch.ops.attention import flash_attention_causal


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, *, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        D, H, Dh = cfg.hidden_size, cfg.num_attention_heads, cfg.head_dim

        def param(make, *shape):
            return nn.Parameter(make(shape, dtype=dtype, device=device),
                                requires_grad=False)

        self.wqkv = param(torch.empty, D, 3, H, Dh)
        self.wo = param(torch.empty, H, Dh, D)
        self.bqkv = param(torch.zeros, 3, H, Dh) if cfg.qkv_proj_bias \
            else None
        self.bo = param(torch.zeros, D) if cfg.mha_out_proj_bias else None


def _qkv(p: Attention, x: torch.Tensor):
    """Fused QKV projection: x (B, L, D) -> q, k, v (B, L, H, Dh), views of
    one (B, L, 3, H, Dh) tensor."""
    B, L, D = x.shape
    qkv = (x @ p.wqkv.reshape(D, -1)).view(B, L, *p.wqkv.shape[1:])
    if p.bqkv is not None:
        qkv = qkv + p.bqkv
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def _rotate(cfg: ModelConfig, q, k, offset: int):
    positions = torch.arange(offset, offset + q.shape[1], device=q.device)
    scaling = (cfg.rotary_emb_scaling_factor
               if cfg.use_interpolated_rotary_pos_emb else 1.0)
    cos, sin = rotary_cos_sin(positions, cfg.head_dim, cfg.rotary_base,
                              scaling)
    return apply_rotary(q, cos, sin), apply_rotary(k, cos, sin)


def _out(p: Attention, y: torch.Tensor) -> torch.Tensor:
    """y (B, L, H, Dh) -> (B, L, D)."""
    B, L = y.shape[:2]
    o = y.reshape(B, L, -1) @ p.wo.reshape(-1, p.wo.shape[-1])
    if p.bo is not None:
        o = o + p.bo
    return o


def _kv_write(st: Dict[str, torch.Tensor], k, v, offset: int) -> None:
    T = st['k'].shape[1]
    if offset + k.shape[1] > T:
        raise ValueError(f'KV cache of length {T} cannot take positions '
                         f'[{offset}, {offset + k.shape[1]})')
    st['k'][:, offset:offset + k.shape[1]] = k
    st['v'][:, offset:offset + v.shape[1]] = v


def mha_full(p: Attention, cfg: ModelConfig, x: torch.Tensor,
             kv_buffers: Optional[Dict[str, torch.Tensor]] = None):
    """Causal attention over a fresh sequence x (B, L, D) (scoring and
    fresh prefill). With `kv_buffers`, k and v are written at positions
    [0, L). Returns (y (B, L, D), kv_buffers)."""
    q, k, v = _qkv(p, x)
    q, k = _rotate(cfg, q, k, 0)
    y = flash_attention_causal(q, k, v)
    if kv_buffers is not None:
        _kv_write(kv_buffers, k, v, 0)
    return _out(p, y), kv_buffers


def mha_step(p: Attention, cfg: ModelConfig, x_t: torch.Tensor,
             kv_buffers: Dict[str, torch.Tensor], offset: int):
    """Single-token decode step: x_t (B, 1, D) at position `offset`. Writes
    its k, v into the cache and attends over positions [0, offset]. Dots in
    float32 on the cache-typed values, softmax in float32, the weights
    rounded to the cache type before A @ V, as the JAX package does."""
    q, k, v = _qkv(p, x_t)
    q, k = _rotate(cfg, q, k, offset)
    _kv_write(kv_buffers, k, v, offset)
    kb = kv_buffers['k'][:, :offset + 1]
    vb = kv_buffers['v'][:, :offset + 1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum('bhd,bthd->bht', q[:, 0].to(kb.dtype).float(),
                     kb.float()) * scale
    a = torch.softmax(s, dim=-1)
    y = torch.einsum('bht,bthd->bhd', a.to(vb.dtype).float(), vb.float())
    return _out(p, y.to(x_t.dtype)[:, None]), kv_buffers
