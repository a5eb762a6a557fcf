"""Rotary multi-head attention, the 3 attention layers of evo-1 (port of
`evo_tpu/layers/attention.py`).

Weights keep the JAX layouts: wqkv (D, 3, H, Dh), wo (H, Dh, D), bqkv
(3, H, Dh), bo (D,); wqkv and wo may be `QuantizedWeight`s (`quant.py`),
and the projections go through `project`. The KV cache of a layer is a
dict of preallocated, zero-filled buffers that this module writes in place
at the cache offset, as the reference engine updates its
`inference_params_dict`:

  {'k', 'v'}              (B, T, H, Dh) in the activation type, or
  {'k', 'v', 'ks', 'vs'}  `kv_quant='int8'`: head-major int8 (B, H, T, Dh)
                          with float32 scales (B, H, T), one per
                          (position, head).

Paths: a fresh full sequence (`mha_full`, the causal flash kernel), a
segment that continues a filled cache (`mha_full(offset=,
attend_buffer=True)`, the buffer-attention kernel), and the single-token
decode step (`mha_step`: the buffer-attention kernel at one query row on
the card, for both caches; on the CPU a dense float32 softmax over an
unquantised cache). The decode step takes a Python int offset or an
int32 (B,) tensor of per-row offsets; the full-sequence paths take an
int. Adapters attached by `lora.attach_lora` add their side paths after
wqkv and wo on the full-sequence paths; the decode step refuses them.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from evo_tpu_torch.config import ModelConfig
from evo_tpu_torch.layers.adapters import add_lora, refuse_in_decode
from evo_tpu_torch.layers.rotary import apply_rotary, rotary_cos_sin
from evo_tpu_torch.ops.attention import flash_attention_causal
from evo_tpu_torch.ops.attention_buffer import Offset, flash_attention_buffer
from evo_tpu_torch.quant import project


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, *, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        D, H, Dh = cfg.hidden_size, cfg.num_attention_heads, cfg.head_dim
        self.act_quant = cfg.act_quant == 'int8'

        def param(make, *shape):
            return nn.Parameter(make(shape, dtype=dtype, device=device),
                                requires_grad=False)

        self.wqkv = param(torch.empty, D, 3, H, Dh)
        self.wo = param(torch.empty, H, Dh, D)
        self.bqkv = param(torch.zeros, 3, H, Dh) if cfg.qkv_proj_bias \
            else None
        self.bo = param(torch.zeros, D) if cfg.mha_out_proj_bias else None
        self.lora, self.lora_scale = {}, 1.0


def _qkv(p: Attention, x: torch.Tensor):
    """Fused QKV projection: x (B, L, D) -> q, k, v (B, L, H, Dh), views of
    one (B, L, 3, H, Dh) tensor."""
    qkv = project(x, p.wqkv, 1, p.act_quant)         # (B, L, 3, H, Dh)
    if p.bqkv is not None:
        qkv = qkv + p.bqkv
    qkv = add_lora(p, 'wqkv', x, qkv)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def _rotate(cfg: ModelConfig, q, k, offset: Offset):
    """Rotary positions [offset, offset + L), shared by the batch, or from
    row b's own offset[b] for an int32 (B,) tensor."""
    if isinstance(offset, torch.Tensor):
        positions = offset[:, None] + torch.arange(q.shape[1],
                                                   device=q.device)
    else:
        positions = torch.arange(offset, offset + q.shape[1],
                                 device=q.device)
    scaling = (cfg.rotary_emb_scaling_factor
               if cfg.use_interpolated_rotary_pos_emb else 1.0)
    cos, sin = rotary_cos_sin(positions, cfg.head_dim, cfg.rotary_base,
                              scaling)
    return apply_rotary(q, cos, sin), apply_rotary(k, cos, sin)


def _out(p: Attention, y: torch.Tensor) -> torch.Tensor:
    """y (B, L, H, Dh) -> (B, L, D): wo contracts the two axes (H, Dh)."""
    o = project(y, p.wo, 2, p.act_quant)
    if p.bo is not None:
        o = o + p.bo
    return add_lora(p, 'wo', y, o, n_in=2)


def kv_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantisation per (batch, position, head): x (...,
    Dh) -> (codes int8 of x's shape, scales float32 (...,)). Rounds half to
    even and divides by the scale, as the JAX package does, so both give
    the same codes."""
    x32 = x.float()
    s = (x32.abs().amax(dim=-1) / 127.0).clamp(min=1e-12)
    q = torch.round(x32 / s[..., None]).clamp(-127, 127).to(torch.int8)
    return q, s


def _kv_write(st: Dict[str, torch.Tensor], k, v, offset: Offset) -> None:
    """Write k, v (B, L, H, Dh) into the layer cache at positions [offset,
    offset + L): as they are, or quantised and head-major.

    An int32 (B,) tensor offset writes one position (L = 1) of each row b
    at offset[b], by an index write on the device. It reads nothing back
    and checks no bound on the device: the caller keeps every offset
    inside the buffer (`serving.GenerationServer` does, on the host)."""
    quantized = 'ks' in st
    if isinstance(offset, torch.Tensor):
        if k.shape[1] != 1:
            raise ValueError('per-row offsets write one position a row, '
                             f'got {k.shape[1]}')
        rows = torch.arange(k.shape[0], device=k.device)
        pos = offset.long()
        if not quantized:
            st['k'][rows, pos] = k[:, 0]
            st['v'][rows, pos] = v[:, 0]
            return
        for name, x in (('k', k), ('v', v)):
            codes, scales = kv_quantize(x[:, 0])       # (B, H, Dh), (B, H)
            st[name][rows, :, pos] = codes
            st[name + 's'][rows, :, pos] = scales
        return
    T = st['k'].shape[2 if quantized else 1]
    end = offset + k.shape[1]
    if end > T:
        raise ValueError(f'KV cache of length {T} cannot take positions '
                         f'[{offset}, {end})')
    if not quantized:
        st['k'][:, offset:end] = k
        st['v'][:, offset:end] = v
        return
    for name, x in (('k', k), ('v', v)):
        codes, scales = kv_quantize(x)
        st[name][:, :, offset:end] = codes.transpose(1, 2)
        st[name + 's'][:, :, offset:end] = scales.transpose(1, 2)


def mha_full(p: Attention, cfg: ModelConfig, x: torch.Tensor,
             kv_buffers: Optional[Dict[str, torch.Tensor]] = None,
             offset: int = 0, attend_buffer: bool = False):
    """Causal attention over the sequence or segment x (B, L, D) at
    positions [offset, offset + L) (scoring and prefill). With
    `kv_buffers`, k and v are written there. Returns (y (B, L, D),
    kv_buffers).

    By default the block attends only itself (a fresh sequence), over its
    own unquantised k and v even when the cache is int8. With
    `attend_buffer` it continues a filled cache: the queries attend the
    whole buffer under the mask `key <= offset + query`."""
    if attend_buffer and kv_buffers is None:
        raise ValueError('attend_buffer needs the kv_buffers to attend')
    if isinstance(offset, torch.Tensor):
        raise ValueError('mha_full takes a Python int offset; per-row '
                         '(B,) offsets are for the decode step (mha_step)')
    q, k, v = _qkv(p, x)
    q, k = _rotate(cfg, q, k, offset)
    if kv_buffers is not None:
        _kv_write(kv_buffers, k, v, offset)
    if attend_buffer:
        y = flash_attention_buffer(q, kv_buffers['k'], kv_buffers['v'],
                                   offset, kv_buffers.get('ks'),
                                   kv_buffers.get('vs'))
    else:
        y = flash_attention_causal(q, k, v)
    return _out(p, y), kv_buffers


def mha_step(p: Attention, cfg: ModelConfig, x_t: torch.Tensor,
             kv_buffers: Dict[str, torch.Tensor], offset: Offset):
    """Single-token decode step: x_t (B, 1, D) at position `offset`. Writes
    its k, v into the cache and attends over positions [0, offset].
    `offset` is a Python int shared by the batch, or an int32 (B,) tensor
    on the cache's device with one offset a row (continuous batching,
    `serving.py`), which the kernels take as it is.

    On the card both caches go through the buffer-attention kernel with
    one query row, which reads the live prefix once, in the cache's own
    type. On the CPU a bf16 or float32 cache takes the dense path: dots in
    float32 on the cache-typed values, softmax in float32, the weights
    rounded to the cache type before A @ V, as the JAX package does (the
    same function as the kernel's plain version, in another order of
    sums)."""
    refuse_in_decode(p)
    q, k, v = _qkv(p, x_t)
    q, k = _rotate(cfg, q, k, offset)
    _kv_write(kv_buffers, k, v, offset)
    if 'ks' in kv_buffers or q.device.type == 'cuda':
        y = flash_attention_buffer(q, kv_buffers['k'], kv_buffers['v'],
                                   offset, kv_buffers.get('ks'),
                                   kv_buffers.get('vs'))
        return _out(p, y), kv_buffers
    y = dense_step_attention(q, kv_buffers['k'], kv_buffers['v'], offset)
    return _out(p, y), kv_buffers


def dense_step_attention(q: torch.Tensor, k_buf: torch.Tensor,
                         v_buf: torch.Tensor, offset: Offset) -> torch.Tensor:
    """The CPU's decode attention: q (B, 1, H, Dh) at position `offset`
    over the unquantised buffers' positions [0, offset], with float32
    copies of the live prefix. Returns (B, 1, H, Dh) in q.dtype.

    With an int32 (B,) tensor of offsets it takes the whole buffer under
    the mask `key <= offset[b]`, as the JAX package's step does."""
    per_row = isinstance(offset, torch.Tensor)
    kb = k_buf if per_row else k_buf[:, :offset + 1]
    vb = v_buf if per_row else v_buf[:, :offset + 1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum('bhd,bthd->bht', q[:, 0].to(kb.dtype).float(),
                     kb.float()) * scale
    if per_row:
        keys = torch.arange(kb.shape[1], device=kb.device)
        s = s.masked_fill((keys[None, :] > offset[:, None])[:, None],
                          float('-inf'))
    a = torch.softmax(s, dim=-1)
    y = torch.einsum('bht,bthd->bhd', a.to(vb.dtype).float(), vb.float())
    return y.to(q.dtype)[:, None]
