"""StripedHyena model: modules in layer order, and the three engine entry
points (port of `evo_tpu/model.py`):

    forward(model, ids)                  -> logits             scoring
    prefill(model, ids, cache)           -> logits, cache      generation start
    decode_step(model, token, cache)     -> logits_t, cache    one decode step

Precision policy, as in the JAX package: weights in `param_dtype` except
the Hyena poles and residues (float32); activations in `compute_dtype`;
RMSNorm statistics, softmax, the long conv and the logits in float32.

The decode cache is a dict {'offset': int, 'layers': [...]}, one entry per
layer in layer order: the KV buffers of `layers/attention.py` for
attention ({'k', 'v'}, or with `kv_quant='int8'` {'k', 'v', 'ks', 'vs'}),
a `HyenaState` for Hyena. The offset is a Python int, so no entry point
reads the device to learn it. `decode_step` also takes an int32 (B,)
tensor of per-row offsets on the cache's device (the slot batch of
`serving.py`, whose rows hold sequences of different lengths) and
advances it on the device; the prefill takes an int only. The entry
points update the cache in place and return it: a caller that wants to
keep a cache as it was clones it first (`generation._grow_cache`). Every
buffer is made of zeros: the attention kernels multiply masked keys by 0,
which a NaN survives.

Under a mesh (`parallel/`, `StripedHyena(cfg, device, mesh)`) every rank
holds its tensor-parallel shards and runs the same entry points on them:
the layers sum their row-parallel products over tp, while the embedding,
the norms and the unembedding stay replicated (kernel 1 runs on the full
D on every rank). The data-parallel split of a batch is the engine
facade's (`models.EvoModel`). Under context parallelism (cp > 1) the
full-sequence pass keeps this rank's rows of the sequence in the residual
stream (embedding, norms, MLPs and kernel 1 on L/cp rows), a length that
cp does not divide padded on the right inside the pass and cut back
wherever a layout holds the whole sequence (causality keeps every real
position exact), and the logits are gathered over cp, so every rank
returns them whole; a decode step's token is whole on every rank.

Training (`training.py`, `lora.py`): the parameters are created with
`requires_grad=False`, and the train steps turn on the ones they train.
Under `cfg.remat` the cache-free forward recomputes each block on the
backward pass (`torch.utils.checkpoint`), as the JAX package's forward
does under `jax.checkpoint`; under cp the recompute posts the block's
collectives again, which every rank does for the same blocks in the same
order. Under cp the loss reads this rank's rows of the logits
(`forward_rows`), with no gather.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, Optional, Union

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from evo_tpu_torch.config import ModelConfig
from evo_tpu_torch.layers.adapters import refuse_in_decode
from evo_tpu_torch.layers.attention import Attention, mha_full, mha_step
from evo_tpu_torch.layers.hyena import (HyenaMixer, HyenaState, hyena_full,
                                        hyena_step)
from evo_tpu_torch.layers.mlp import GatedMLP
from evo_tpu_torch.layers.norms import RMSNorm
from evo_tpu_torch.parallel import sharding
from evo_tpu_torch.parallel.collectives import gather_seq, split_seq
from evo_tpu_torch.parallel.mesh import has_cp

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

    def __init__(self, cfg: ModelConfig, *, dtype, device, mesh=None):
        super().__init__()
        D = cfg.hidden_size
        self.pre_norm = RMSNorm(D, cfg.eps, dtype=dtype, device=device)
        self.post_norm = RMSNorm(D, cfg.eps, dtype=dtype, device=device)
        self.attn = Attention(cfg, dtype=dtype, device=device, mesh=mesh)
        self.mlp = GatedMLP(D, cfg.inner_mlp_size_actual, cfg.mlp_activation,
                            dtype=dtype, device=device,
                            act_quant=cfg.act_quant == 'int8', mesh=mesh)


class HyenaBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, *, dtype, device, mesh=None):
        super().__init__()
        D = cfg.hidden_size
        self.pre_norm = RMSNorm(D, cfg.eps, dtype=dtype, device=device)
        self.post_norm = RMSNorm(D, cfg.eps, dtype=dtype, device=device)
        self.hyena = HyenaMixer(cfg, dtype=dtype, device=device, mesh=mesh)
        self.mlp = GatedMLP(D, cfg.inner_mlp_size_actual, cfg.mlp_activation,
                            dtype=dtype, device=device,
                            act_quant=cfg.act_quant == 'int8', mesh=mesh)


class StripedHyena(nn.Module):
    """Parameters of the whole model; weights are left uninitialised here
    (`random_init` or `checkpoint.params_from_state_dict` fill them). With
    a `parallel.mesh.Mesh`, each layer holds this rank's tp shards; a size
    that tp does not divide raises a ValueError naming it."""

    def __init__(self, cfg: ModelConfig,
                 device: Union[str, torch.device] = 'cuda', mesh=None):
        super().__init__()
        device = resolve_device(device)
        sharding.check_divisible(cfg, mesh)
        dtype = getattr(torch, cfg.param_dtype)
        D, V = cfg.hidden_size, cfg.padded_vocab_size
        self.config = cfg
        self.mesh = mesh

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
                cfg, dtype=dtype, device=device, mesh=mesh)
            for i in range(cfg.num_layers)])

    @property
    def device(self) -> torch.device:
        return self.embedding.device


def random_init(cfg: ModelConfig, generator: torch.Generator,
                device: Union[str, torch.device] = 'cuda',
                mesh=None) -> StripedHyena:
    """Random weights with the distributions of `evo_tpu.model.init_params`
    (not its values: the generators differ). `generator` lives on
    `device`. Pole magnitudes stay in [0.6, 0.99]: a pole outside the unit
    disk overflows over 8k positions.

    Under a mesh every rank draws each full tensor in the same order from
    the one generator and keeps its slice, so that the shards are those of
    the unsharded `random_init` with the same generator; one full tensor
    at a time is held."""
    model = StripedHyena(cfg, device, mesh)
    D, I = cfg.hidden_size, cfg.inner_mlp_size_actual
    K, S = cfg.short_filter_length, cfg.state_size
    names = {id(t): n for n, t in model.named_parameters()}

    def put(t, full):
        t.copy_(sharding.shard_tensor(full, names[id(t)], mesh))

    def normal_(t, std):
        shape = sharding.full_shape(names[id(t)], t.shape, mesh)
        if shape == tuple(t.shape):
            t.normal_(0.0, std, generator=generator)
            return
        put(t, torch.empty(shape, dtype=t.dtype, device=t.device).normal_(
            0.0, std, generator=generator))

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
        put(hy.poles, torch.stack([mag * torch.cos(ang),
                                   mag * torch.sin(ang)], dim=-1))
    return model


def param_count(model: StripedHyena) -> int:
    """Elements of every parameter, and of the codes and scales that stand
    in for a quantized one."""
    return sum(t.numel() for t in itertools.chain(model.parameters(),
                                                  model.buffers()))


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: Union[str, torch.device] = 'cuda',
               mesh=None, split_dp: bool = True) -> Cache:
    """Zeroed decode cache for `batch` rows of up to `max_len` positions.
    Attention layers take {'k', 'v'} (B, T, H, Dh) buffers, or head-major
    int8 ones with their scales under `kv_quant='int8'`; Hyena layers a
    `HyenaState`. Under a mesh, this rank's part: H/tp heads, C/tp
    channels, and its dp rank's rows, or with `split_dp=False` every row
    (`parallel.sharding.cache_shardings`)."""
    device = resolve_device(device)
    layers = []
    for spec in sharding.cache_shardings(cfg, mesh, batch, max_len,
                                         split_dp):
        bufs = {name: torch.zeros(shape, dtype=dt, device=device)
                for name, (shape, dt) in spec.items()}
        layers.append(HyenaState(**bufs) if 'fir' in bufs else bufs)
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


def _block(blk, cfg: ModelConfig, x: torch.Tensor, layers=None, i: int = 0,
           offset: int = 0, resume: bool = False,
           seq_len: Optional[int] = None) -> torch.Tensor:
    """One pre-norm residual block of the full-sequence pass: x + mix(
    norm(x)), then + mlp(norm(x)). With `layers` (the cache's list), the
    block's decode state is written into layers[i]. `seq_len`: under cp,
    the real positions of the padded sequence whose rows x holds."""
    h = blk.pre_norm(x)
    if isinstance(blk, AttentionBlock):
        mix, _ = mha_full(blk.attn, cfg, h, kv_buffers=(
            None if layers is None else layers[i]), offset=offset,
            attend_buffer=resume, seq_len=seq_len)
    else:
        mix, st = hyena_full(blk.hyena, cfg, h,
                             collect_state=layers is not None,
                             state=layers[i] if resume else None,
                             seq_len=seq_len)
        if layers is not None:
            layers[i] = st
    x = x + mix
    return x + blk.mlp(blk.post_norm(x))


def _full_sequence(model: StripedHyena, ids: torch.Tensor, layers=None,
                   offset: int = 0, resume: bool = False,
                   cfg: Optional[ModelConfig] = None, gather: bool = True):
    """The full-sequence pass shared by `forward`, `forward_rows` and
    `prefill`. With `layers` (the cache's list), each layer's decode state
    is written into it; with `resume`, ids continue the sequence that
    filled `layers` up to `offset`. Under `cfg.remat` the cache-free pass
    checkpoints each block when grad mode is on, with the whole of
    `_block`'s arguments.

    Under cp the ids are the whole sequence on every rank; the pass runs
    on this rank's rows of it, padded on the right to a multiple of cp
    (the ring attentions take no padding on a fresh sequence: they raise
    the JAX package's ValueError), and returns the whole logits, or with
    `gather=False` this rank's rows of the padded sequence's."""
    cfg = model.config if cfg is None else cfg
    remat = cfg.remat and layers is None and torch.is_grad_enabled()
    mesh = model.mesh
    seq_len = None
    if has_cp(mesh):
        seq_len = ids.shape[1]
        pad = -seq_len % mesh.cp
        if pad:
            ids = F.pad(ids, (0, pad))
        ids = split_seq(ids, mesh)
    x = _embed(model, ids)
    for i, blk in enumerate(model.blocks):
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                _block, blk, cfg, x, layers, i, offset, resume, seq_len,
                use_reentrant=False)
        else:
            x = _block(blk, cfg, x, layers, i, offset, resume, seq_len)
    logits = _unembed(model, x)
    if seq_len is None or not gather:
        return logits
    return gather_seq(logits, mesh)[:, :seq_len]


def forward(model: StripedHyena, ids: torch.Tensor,
            cfg: Optional[ModelConfig] = None) -> torch.Tensor:
    """ids (B, L) integer -> logits (B, L, vocab) float32. No padding mask,
    as in the reference: a right-padded batch is sliced afterwards.
    `cfg`: the config to run under, the model's own by default (the train
    steps pass one with the kernel switches that have no backward off)."""
    return _full_sequence(model, ids, cfg=cfg)


def forward_rows(model: StripedHyena, ids: torch.Tensor,
                 cfg: Optional[ModelConfig] = None):
    """`forward` without the gather over cp: (logits, start), the logits
    of rows [start, start + n) of the sequence padded on the right to a
    multiple of cp that this cp rank holds (rows at L and past are
    padding), float32 (B, n, vocab). Without cp, the whole logits and 0.
    The train steps' loss reads these rows: the ids are whole on every
    rank, so each rank knows the targets of its rows."""
    logits = _full_sequence(model, ids, cfg=cfg, gather=False)
    start = (model.mesh.index('cp') * logits.shape[1]
             if has_cp(model.mesh) else 0)
    return logits, start


def prefill(model: StripedHyena, ids: torch.Tensor, cache: Cache,
            resume: bool = False):
    """Consume ids (B, L), filling `cache`. Returns (logits (B, L, vocab)
    float32, the cache with its offset advanced by L).

    A fresh prompt fills the cache from position 0. `resume=True`
    continues a filled cache: attention attends the cached and the new
    positions, rotary positions start at the cache offset, and the Hyena
    layers start from the carried FIR tail and modal state."""
    offset = cache['offset'] if resume else 0
    logits = _full_sequence(model, ids, cache['layers'], offset, resume)
    cache['offset'] = offset + ids.shape[1]
    return logits, cache


def decode_step(model: StripedHyena, token: torch.Tensor, cache: Cache):
    """One autoregressive step. token (B,) or (B, 1) -> (logits (B, vocab)
    float32, cache with offset + 1). `cache['offset']` is an int, or an
    int32 (B,) tensor of per-row offsets that the step advances on the
    device without reading it."""
    cfg = model.config
    if token.dim() == 1:
        token = token[:, None]
    offset = cache['offset']
    layers = cache['layers']
    x = _embed(model, token)
    for i, blk in enumerate(model.blocks):
        refuse_in_decode(blk.mlp)
        h = blk.pre_norm(x)
        if isinstance(blk, AttentionBlock):
            mix, _ = mha_step(blk.attn, cfg, h, layers[i], offset)
        else:
            mix, layers[i] = hyena_step(blk.hyena, cfg, h, layers[i])
        x = x + mix
        x = x + blk.mlp(blk.post_norm(x))
    cache['offset'] = offset + 1
    return _unembed(model, x)[:, 0], cache
