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
int. Under a mesh (`parallel/`) a rank holds H/tp heads of wqkv and
bqkv, the matching rows of wo and an (H/tp)-head cache; the kernels run at
H/tp heads, and wo's partial products are summed over tp before bo.
Under context parallelism (cp > 1) x is this rank's rows of the sequence;
q and k are rotated at their global positions, and `cfg.cp_attn` picks
the attention (`_cp_attend`): Ulysses (one all-to-all to the whole
sequence of H/(tp cp) heads, the causal flash kernel, the reverse
all-to-all), or the ring or zigzag ring (`ops/ring_attention.py`). The
cache holds this rank's H/(tp cp) heads (`mesh.channel_block`), which a
resumed segment reaches in the Ulysses layout; the decode step keeps those
heads of the projection and sums wo's partial products over tp and cp.
Adapters attached by `lora.attach_lora` add their side paths after
wqkv and after wo (before its sum over tp and its bias) on the
full-sequence paths; the decode step refuses them.
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
from evo_tpu_torch.ops.ring_attention import (ring_attention,
                                              zigzag_ring_attention)
from evo_tpu_torch.ops.ulysses_attention import ulysses_attention
from evo_tpu_torch.parallel.collectives import (all_reduce_sum, copy_to_tp,
                                                gather_seq, reduce_from_tp,
                                                seq_to_heads, split_seq)
from evo_tpu_torch.parallel.mesh import (CHANNEL, channel_block, has_cp,
                                         tp_size)
from evo_tpu_torch.quant import project, row_block


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, *, dtype: torch.dtype,
                 device: torch.device, mesh=None):
        super().__init__()
        D, Dh = cfg.hidden_size, cfg.head_dim
        H = cfg.num_attention_heads // tp_size(mesh)
        self.act_quant = cfg.act_quant == 'int8'
        self.mesh = mesh

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
    x = copy_to_tp(x, p.mesh)
    qkv = project(x, p.wqkv, 1, p.act_quant)         # (B, L, 3, H, Dh)
    if p.bqkv is not None:
        qkv = qkv + p.bqkv
    qkv = add_lora(p, 'wqkv', x, qkv)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def _rotate(cfg: ModelConfig, q, k, offset: Offset):
    """Rotary positions [offset, offset + L), shared by the batch, or from
    row b's own offset[b] for an int32 (B,) tensor. Under cp the caller
    passes the global position of this rank's first row."""
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


def _out(p: Attention, y: torch.Tensor, heads=None) -> torch.Tensor:
    """y (B, L, H, Dh) -> (B, L, D): wo contracts the two axes (H, Dh).
    heads=(start, n): y holds only heads [start, start + n) of the tp
    shard (a decode step under cp), whose partial products with wo's
    matching rows are summed over tp and cp."""
    if heads is None:
        o = reduce_from_tp(add_lora(p, 'wo', y, project(
            y, p.wo, 2, p.act_quant), n_in=2), p.mesh)
    else:
        o = all_reduce_sum(project(y, row_block(p.wo, *heads, CHANNEL), 2,
                                   p.act_quant), p.mesh, CHANNEL)
    return o if p.bo is None else o + p.bo


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
             offset: int = 0, attend_buffer: bool = False,
             seq_len: Optional[int] = None):
    """Causal attention over the sequence or segment x (B, L, D) at
    positions [offset, offset + L) (scoring and prefill). With
    `kv_buffers`, k and v are written there. Returns (y (B, L, D),
    kv_buffers).

    By default the block attends only itself (a fresh sequence), over its
    own unquantised k and v even when the cache is int8. With
    `attend_buffer` it continues a filled cache: the queries attend the
    whole buffer under the mask `key <= offset + query`.

    Under cp, x holds this rank's rows of a sequence padded to a multiple
    of cp, whose first `seq_len` positions are real: only those are written
    to the cache, and the padded rows of the result are not used."""
    if attend_buffer and kv_buffers is None:
        raise ValueError('attend_buffer needs the kv_buffers to attend')
    if isinstance(offset, torch.Tensor):
        raise ValueError('mha_full takes a Python int offset; per-row '
                         '(B,) offsets are for the decode step (mha_step)')
    q, k, v = _qkv(p, x)
    if has_cp(p.mesh):
        rows = q.shape[1]
        q, k = _rotate(cfg, q, k, offset + p.mesh.index('cp') * rows)
        y = _cp_attend(p, cfg, q, k, v, kv_buffers, offset, attend_buffer,
                       rows * p.mesh.cp if seq_len is None else seq_len)
        return _out(p, y), kv_buffers
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


def _cp_attend(p: Attention, cfg: ModelConfig, q, k, v, kv_buffers,
               offset: int, attend_buffer: bool, seq_len: int
               ) -> torch.Tensor:
    """Attention under cp: q, k, v (B, L/cp, H, Dh) this rank's rows at H
    heads of the tp shard (q and k rotated) -> (B, L/cp, H, Dh), writing
    the first `seq_len` positions of this rank's H/cp heads to the cache.

    A resumed segment, and `cp_attn='ulysses'`, go to the whole sequence
    of H/cp heads by one all-to-all (which also gives the cache its
    layout), run kernel 4 / 5 over the buffer or kernel 3 there, and come
    back by the reverse one. Where cp does not divide H, Ulysses gathers
    the sequence instead and keeps this rank's rows of kernel 3's result
    (there is no cache then: `cache_shardings` raises). 'ring' and
    'zigzag' keep the rows and pass K/V around the cp group; with a cache
    they first move k and v to its layout by one all-to-all."""
    mesh = p.mesh
    if q.shape[2] % mesh.cp and cfg.cp_attn == 'ulysses':
        y = flash_attention_causal(*(gather_seq(t, mesh) for t in (q, k, v)))
        return split_seq(y, mesh)
    if attend_buffer or cfg.cp_attn == 'ulysses':
        def core(qh, kh, vh):
            if kv_buffers is not None:
                _kv_write(kv_buffers, kh, vh, offset)
            if not attend_buffer:
                return flash_attention_causal(qh, kh, vh)
            return flash_attention_buffer(qh, kv_buffers['k'],
                                          kv_buffers['v'], offset,
                                          kv_buffers.get('ks'),
                                          kv_buffers.get('vs'))
        return ulysses_attention(q, k, v, mesh, seq_len, core)
    if kv_buffers is not None:
        kv = seq_to_heads(torch.stack([k, v], dim=2), mesh, 3)[:, :seq_len]
        _kv_write(kv_buffers, kv[:, :, 0], kv[:, :, 1], offset)
    ring = (zigzag_ring_attention if cfg.cp_attn == 'zigzag'
            else ring_attention)
    return ring(q, k, v, mesh, seq_len)


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
    sums).

    Under cp, x_t is whole on every rank, and the rank keeps its block of
    heads of the projection (the heads of its cache); wo's partial
    products are summed over tp and cp."""
    refuse_in_decode(p)
    q, k, v = _qkv(p, x_t)
    heads = channel_block(p.mesh, q.shape[2]) if has_cp(p.mesh) else None
    if heads is not None:
        q, k, v = (t.narrow(2, *heads) for t in (q, k, v))
    q, k = _rotate(cfg, q, k, offset)
    _kv_write(kv_buffers, k, v, offset)
    if 'ks' in kv_buffers or q.device.type == 'cuda':
        y = flash_attention_buffer(q, kv_buffers['k'], kv_buffers['v'],
                                   offset, kv_buffers.get('ks'),
                                   kv_buffers.get('vs'))
    else:
        y = dense_step_attention(q, kv_buffers['k'], kv_buffers['v'],
                                 offset)
    return _out(p, y, heads), kv_buffers


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
