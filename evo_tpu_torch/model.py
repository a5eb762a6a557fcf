"""StripedHyena model: modules in layer order, and the three engine entry
points (port of `evo_tpu/model.py`):

    forward(model, ids)                  -> logits             scoring
    prefill(model, ids, cache)           -> logits, cache      generation start
    decode_step(model, token, cache)     -> logits_t, cache    one decode step

Precision policy, as in the JAX package: weights in `param_dtype` except
the Hyena poles and residues (float32); activations in `compute_dtype`;
RMSNorm statistics, softmax, the long conv and the logits in float32.

The decode cache is a dict {'offset': int, 'layers': [...]}, one entry per
layer in layer order: {'k', 'v'} (B, T, H, Dh) KV buffers for attention,
a `HyenaState` for Hyena. The entry points update it in place and return
it. `prefill` fills a fresh cache; continuing a filled one
(`resume=True`) is not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Union

import torch
import torch.nn.functional as F
from torch import nn

from evo_tpu_torch.config import ModelConfig
from evo_tpu_torch.layers.attention import Attention, mha_full, mha_step
from evo_tpu_torch.layers.hyena import (HyenaMixer, HyenaState, hyena_full,
                                        hyena_step)
from evo_tpu_torch.layers.mlp import GatedMLP
from evo_tpu_torch.layers.norms import RMSNorm

Cache = Dict[str, Any]


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device a caller asked for. CUDA without a card raises: nothing
    falls back to the CPU."""
    d = torch.device(device)
    if d.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'device="cuda" was requested but no CUDA device is available; '
            'pass device="cpu" to run the plain PyTorch path on the CPU')
    if d.type not in ('cuda', 'cpu'):
        raise ValueError(f'unsupported device {d}')
    return d


class AttentionBlock(nn.Module):
    """Pre-norm residual block: x + attn(norm(x)), then + mlp(norm(x))."""

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        D = cfg.hidden_size
        self.pre_norm = RMSNorm(D, cfg.eps, dtype=dtype, device=device)
        self.post_norm = RMSNorm(D, cfg.eps, dtype=dtype, device=device)
        self.attn = Attention(cfg, dtype=dtype, device=device)
        self.mlp = GatedMLP(D, cfg.inner_mlp_size_actual, cfg.mlp_activation,
                            dtype=dtype, device=device)


class HyenaBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        D = cfg.hidden_size
        self.pre_norm = RMSNorm(D, cfg.eps, dtype=dtype, device=device)
        self.post_norm = RMSNorm(D, cfg.eps, dtype=dtype, device=device)
        self.hyena = HyenaMixer(cfg, dtype=dtype, device=device)
        self.mlp = GatedMLP(D, cfg.inner_mlp_size_actual, cfg.mlp_activation,
                            dtype=dtype, device=device)


class StripedHyena(nn.Module):
    """Parameters of the whole model; weights are left uninitialised here
    (`random_init` or `checkpoint.params_from_state_dict` fill them)."""

    def __init__(self, cfg: ModelConfig,
                 device: Union[str, torch.device] = 'cuda'):
        super().__init__()
        device = resolve_device(device)
        dtype = getattr(torch, cfg.param_dtype)
        D, V = cfg.hidden_size, cfg.padded_vocab_size
        self.config = cfg

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype,
                                            device=device),
                                requires_grad=False)

        self.embedding = param(V, D)
        self.unembed = None if cfg.tie_embeddings else param(V, D)
        self.final_norm = (RMSNorm(D, cfg.eps, dtype=dtype, device=device)
                           if cfg.final_norm else None)
        self.blocks = nn.ModuleList([
            (AttentionBlock if cfg.is_attn_layer(i) else HyenaBlock)(
                cfg, dtype=dtype, device=device)
            for i in range(cfg.num_layers)])

    @property
    def device(self) -> torch.device:
        return self.embedding.device


def random_init(cfg: ModelConfig, generator: torch.Generator,
                device: Union[str, torch.device] = 'cuda') -> StripedHyena:
    """Random weights with the distributions of `evo_tpu.model.init_params`
    (not its values: the generators differ). `generator` lives on
    `device`. Pole magnitudes stay in [0.6, 0.99]: a pole outside the unit
    disk overflows over 8k positions."""
    model = StripedHyena(cfg, device)
    D, I = cfg.hidden_size, cfg.inner_mlp_size_actual
    K, S = cfg.short_filter_length, cfg.state_size

    def normal_(t, std):
        t.normal_(0.0, std, generator=generator)

    normal_(model.embedding, 0.02)
    if model.unembed is not None:
        normal_(model.unembed, 0.02)
    for blk in model.blocks:
        normal_(blk.mlp.w1, D ** -0.5)
        normal_(blk.mlp.w2, D ** -0.5)
        normal_(blk.mlp.w3, I ** -0.5)
        if isinstance(blk, AttentionBlock):
            normal_(blk.attn.wqkv, D ** -0.5)
            normal_(blk.attn.wo, D ** -0.5)
            continue
        hy = blk.hyena
        normal_(hy.w_in, D ** -0.5)
        normal_(hy.fir_w, K ** -0.5)
        normal_(hy.residues, 1.0 / S)
        normal_(hy.w_out, D ** -0.5)
        mag = torch.empty((D, S), device=model.device).uniform_(
            0.6, 0.99, generator=generator)
        ang = torch.empty((D, S), device=model.device).uniform_(
            -3.14159, 3.14159, generator=generator)
        hy.poles.copy_(torch.stack([mag * torch.cos(ang),
                                    mag * torch.sin(ang)], dim=-1))
    return model


def param_count(model: StripedHyena) -> int:
    return sum(p.numel() for p in model.parameters())


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: Union[str, torch.device] = 'cuda') -> Cache:
    """Zeroed decode cache for `batch` rows of up to `max_len` positions."""
    device = resolve_device(device)
    cd = getattr(torch, cfg.compute_dtype)
    D, H, Dh = cfg.hidden_size, cfg.num_attention_heads, cfg.head_dim
    K, S = cfg.short_filter_length, cfg.state_size
    layers = []
    for i in range(cfg.num_layers):
        if cfg.is_attn_layer(i):
            layers.append({
                'k': torch.zeros((batch, max_len, H, Dh), dtype=cd,
                                 device=device),
                'v': torch.zeros((batch, max_len, H, Dh), dtype=cd,
                                 device=device)})
        else:
            layers.append(HyenaState(
                fir=torch.zeros((batch, 3, D, K - 1), dtype=cd,
                                device=device),
                iir=torch.zeros((batch, D, S, 2), dtype=torch.float32,
                                device=device)))
    return {'offset': 0, 'layers': layers}


def _embed(model: StripedHyena, ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(ids, model.embedding).to(
        getattr(torch, model.config.compute_dtype))


def _unembed(model: StripedHyena, x: torch.Tensor) -> torch.Tensor:
    if model.final_norm is not None:
        x = model.final_norm(x)
    w = model.unembed if model.unembed is not None else model.embedding
    logits = x.float() @ w.float().T
    return logits[..., :model.config.vocab_size]


def _full_sequence(model: StripedHyena, ids: torch.Tensor, layers=None):
    """The fresh full-sequence pass shared by `forward` and `prefill`;
    with `layers` (the cache's list), each layer's decode state is written
    into it."""
    cfg = model.config
    x = _embed(model, ids)
    for i, blk in enumerate(model.blocks):
        h = blk.pre_norm(x)
        if isinstance(blk, AttentionBlock):
            mix, _ = mha_full(blk.attn, cfg, h, kv_buffers=(
                None if layers is None else layers[i]))
        else:
            mix, st = hyena_full(blk.hyena, cfg, h,
                                 collect_state=layers is not None)
            if layers is not None:
                layers[i] = st
        x = x + mix
        x = x + blk.mlp(blk.post_norm(x))
    return _unembed(model, x)


def forward(model: StripedHyena, ids: torch.Tensor) -> torch.Tensor:
    """ids (B, L) integer -> logits (B, L, vocab) float32. No padding mask,
    as in the reference: a right-padded batch is sliced afterwards."""
    return _full_sequence(model, ids)


def prefill(model: StripedHyena, ids: torch.Tensor, cache: Cache,
            resume: bool = False):
    """Consume a fresh prompt ids (B, L), filling `cache` from position 0.
    Returns (logits (B, L, vocab) float32, cache with offset L)."""
    if resume:
        raise NotImplementedError(
            'prefill(resume=True) is not ported yet (ROADMAP.md, modules '
            'queue: resumed prefill with the flash_attention_buffer kernel)')
    logits = _full_sequence(model, ids, cache['layers'])
    cache['offset'] = ids.shape[1]
    return logits, cache


def decode_step(model: StripedHyena, token: torch.Tensor, cache: Cache):
    """One autoregressive step. token (B,) or (B, 1) -> (logits (B, vocab)
    float32, cache with offset + 1)."""
    cfg = model.config
    if token.dim() == 1:
        token = token[:, None]
    offset = cache['offset']
    layers = cache['layers']
    x = _embed(model, token)
    for i, blk in enumerate(model.blocks):
        h = blk.pre_norm(x)
        if isinstance(blk, AttentionBlock):
            mix, _ = mha_step(blk.attn, cfg, h, layers[i], offset)
        else:
            mix, layers[i] = hyena_step(blk.hyena, cfg, h, layers[i])
        x = x + mix
        x = x + blk.mlp(blk.post_norm(x))
    cache['offset'] = offset + 1
    return _unembed(model, x)[:, 0], cache
