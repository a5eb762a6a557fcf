"""Megatron tensor-parallel layouts of the port's parameters and caches
(port of `evo_tpu/parallel/sharding.py`).

The JAX package writes each layout as a `PartitionSpec` and lets GSPMD
place the shards. The port keeps the same table, in its parameter names
and shapes (which are the JAX package's), as the one axis of each tensor
that is split over tp, and each rank holds its slice of that axis as a
tensor of its own:

  * attention: wqkv (D, 3, H, Dh) and bqkv (3, H, Dh) split by head
    (column-parallel); wo (H, Dh, D) by its head rows (row-parallel);
  * Hyena: the channel axis C everywhere (w_in's columns, b_in, the FIR
    taps and bias, poles, residues, d_skip, w_out's rows);
  * MLP: w1, w2 (D, I) by column, w3 (I, D) by row;
  * replicated: the embedding (and an untied unembed), the norms, and the
    biases after row-parallel products (b_out, bo).

A slice is a contiguous copy, never a view: a view keeps the full weight
alive, and the in-projection's output must stay a dense (B, L, 3, C/tp)
tensor, which kernels 2 and 6 read in place.

Decode caches hold H/tp heads and C/tp channels, and the rows of their dp
rank.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from evo_tpu_torch.config import ModelConfig
from evo_tpu_torch.parallel.mesh import Mesh

# the axis of each parameter that tp splits (None: replicated), by scope
_ATTN_SPECS = {
    'wqkv': 2,          # (D, 3, H, Dh)
    'bqkv': 1,          # (3, H, Dh)
    'wo': 0,            # (H, Dh, D) row-parallel
    'bo': None,
}
_HYENA_SPECS = {
    'w_in': 2,          # (D, 3, C)
    'b_in': 1,          # (3, C)
    'fir_w': 1,         # (3, C, K)
    'fir_b': 1,         # (3, C)
    'poles': 0,         # (C, S, 2)
    'residues': 0,
    'd_skip': 0,
    'w_out': 0,         # (C, D) row-parallel
    'b_out': None,
}
_MLP_SPECS = {
    'w1': 1,            # (D, I)
    'w2': 1,
    'w3': 0,            # (I, D) row-parallel
}
_TOP_SPECS = {
    # (V, D) = 512 x 4096 bf16: replicated, as in the JAX package
    'embedding': None,
    'unembed': None,
    'final_norm': None,
    'pre_norm': None,
    'post_norm': None,
}
_SCOPES = {'attn': _ATTN_SPECS, 'hyena': _HYENA_SPECS, 'mlp': _MLP_SPECS}
# contraction axes of the quantized projections (`quant._QUANT_AXES`)
_CONTRACT = {'w1': 1, 'w2': 1, 'w3': 1, 'w_in': 1, 'w_out': 1, 'wqkv': 1,
             'wo': 2}
INT4_REFUSAL = ('param_specs: weight_quant int4 has no sharded layout '
                '(single-chip serving mode, evo_tpu_torch/ops/int4.py)')


def tp_axis(name: str) -> Optional[int]:
    """The tp-split axis of the parameter or buffer `name` (a dotted name
    of `StripedHyena.named_parameters()` / `named_buffers()`), or None.

    An int8 weight's codes `<w>.q` keep the weight's axis; its scales
    `<w>.s` keep their contraction axes as 1, so they drop the axis when
    it is one of those (the row-parallel weights), as the JAX package's
    `q`/`s` rule does."""
    parts = name.split('.')
    leaf = parts[-1]
    if leaf in ('q', 's'):
        axis = tp_axis('.'.join(parts[:-1]))
        if leaf == 's' and axis is not None and axis < _CONTRACT[parts[-2]]:
            return None
        return axis
    if leaf in ('q4', 's4'):
        raise NotImplementedError(INT4_REFUSAL)
    if leaf == 'weight':                      # the norms' gains
        leaf = parts[-2]
    for scope, specs in _SCOPES.items():
        if scope in parts[:-1]:
            return specs[leaf]
    return _TOP_SPECS[leaf]


def _param_names(cfg: ModelConfig) -> List[str]:
    """The parameter names of `model.StripedHyena(cfg)`, in its order."""
    names = ['embedding']
    if not cfg.tie_embeddings:
        names.append('unembed')
    if cfg.final_norm:
        names.append('final_norm.weight')
    for i in range(cfg.num_layers):
        p = f'blocks.{i}.'
        names += [p + 'pre_norm.weight', p + 'post_norm.weight']
        if cfg.is_attn_layer(i):
            names += [p + 'attn.wqkv', p + 'attn.wo']
            names += [p + 'attn.bqkv'] if cfg.qkv_proj_bias else []
            names += [p + 'attn.bo'] if cfg.mha_out_proj_bias else []
        else:
            names += [p + 'hyena.' + n for n in (
                'w_in', 'fir_w', 'poles', 'residues', 'd_skip', 'w_out')]
            for n, on in (('b_in', cfg.hyena_proj_bias),
                          ('fir_b', cfg.short_filter_bias),
                          ('b_out', cfg.hyena_out_proj_bias)):
                names += [p + 'hyena.' + n] if on else []
        names += [p + 'mlp.' + n for n in ('w1', 'w2', 'w3')]
    return names


def param_specs(cfg: ModelConfig) -> Dict[str, Optional[int]]:
    """Name -> tp-split axis (None: replicated) for every tensor of a model
    of `cfg`. Under `weight_quant='int8'` the seven projection families
    appear as their codes and scales (`<w>.q`, `<w>.s`); int4 raises, as
    in the JAX package."""
    if cfg.weight_quant == 'int4':
        raise NotImplementedError(INT4_REFUSAL)
    out = {}
    for name in _param_names(cfg):
        leaf = name.split('.')[-1]
        if cfg.weight_quant == 'int8' and leaf in _CONTRACT:
            for part in ('q', 's'):
                out[f'{name}.{part}'] = tp_axis(f'{name}.{part}')
        else:
            out[name] = tp_axis(name)
    return out


def _split(size: int, name: str, axis: int, mesh: Mesh) -> int:
    tp = mesh.tp
    if size % tp:
        raise ValueError(f'{name}: axis {axis} of size {size} does not '
                         f'divide over tp={tp}')
    return size // tp


def local_shape(name: str, shape: Tuple[int, ...], mesh: Optional[Mesh]
                ) -> Tuple[int, ...]:
    """The shape of this rank's shard of the full tensor `name`."""
    axis = tp_axis(name) if mesh is not None and mesh.tp > 1 else None
    if axis is None:
        return tuple(shape)
    shape = list(shape)
    shape[axis] = _split(shape[axis], name, axis, mesh)
    return tuple(shape)


def full_shape(name: str, shape: Tuple[int, ...], mesh: Optional[Mesh]
               ) -> Tuple[int, ...]:
    """The unsharded shape of the shard `name` of `shape`."""
    axis = tp_axis(name) if mesh is not None and mesh.tp > 1 else None
    if axis is None:
        return tuple(shape)
    shape = list(shape)
    shape[axis] *= mesh.tp
    return tuple(shape)


def shard_tensor(full: torch.Tensor, name: str, mesh: Optional[Mesh]
                 ) -> torch.Tensor:
    """This rank's slice of the full tensor `name`, as a contiguous copy
    (the full tensor itself where nothing is split). Raises a ValueError
    naming the parameter and axis when tp does not divide it."""
    axis = tp_axis(name) if mesh is not None and mesh.tp > 1 else None
    if axis is None:
        return full
    n = _split(full.shape[axis], name, axis, mesh)
    return full.narrow(axis, mesh.index('tp') * n, n).contiguous()


def _full_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    D, V = cfg.hidden_size, cfg.padded_vocab_size
    H, Dh, I = cfg.num_attention_heads, cfg.head_dim, cfg.inner_mlp_size_actual
    K, S = cfg.short_filter_length, cfg.state_size
    leaf_shapes = {
        'embedding': (V, D), 'unembed': (V, D), 'weight': (D,),
        'wqkv': (D, 3, H, Dh), 'wo': (H, Dh, D), 'bqkv': (3, H, Dh),
        'bo': (D,), 'w_in': (D, 3, D), 'fir_w': (3, D, K), 'poles': (D, S, 2),
        'residues': (D, S, 2), 'd_skip': (D,), 'w_out': (D, D),
        'b_in': (3, D), 'fir_b': (3, D), 'b_out': (D,), 'w1': (D, I),
        'w2': (D, I), 'w3': (I, D)}
    return {n: leaf_shapes[n.split('.')[-1]] for n in _param_names(cfg)}


def check_divisible(cfg: ModelConfig, mesh: Optional[Mesh]) -> None:
    """Raise a ValueError naming the first parameter and axis that tp does
    not divide."""
    if mesh is None or mesh.tp == 1:
        return
    for name, shape in _full_shapes(cfg).items():
        local_shape(name, shape, mesh)


def shard_params(params: Any, cfg: ModelConfig, mesh: Mesh) -> Any:
    """Shard an unsharded model onto this rank.

    A `model.StripedHyena` (unquantized) is sharded in place: each
    parameter is replaced by its contiguous slice, so the full one is
    freed as soon as its shard exists, and every layer takes the mesh. A
    dict of full tensors by parameter name comes back as a dict of the
    slices, its entries popped one at a time. The model is returned."""
    if isinstance(params, dict):
        out = {}
        for name in list(params):
            out[name] = shard_tensor(params.pop(name), name, mesh)
        return out
    from evo_tpu_torch.quant import QuantizedWeight
    check_divisible(cfg, mesh)
    if any(isinstance(m, QuantizedWeight) for m in params.modules()):
        raise ValueError('shard_params takes an unquantized model: shard '
                         'first, then quantize (quant.quantize_params)')
    for name, p in list(params.named_parameters()):
        owner_name, _, leaf = name.rpartition('.')
        owner = params.get_submodule(owner_name) if owner_name else params
        shard = shard_tensor(p.detach(), name, mesh)
        del p
        delattr(owner, leaf)
        owner.register_parameter(
            leaf, torch.nn.Parameter(shard, requires_grad=False))
    for m in params.modules():
        if hasattr(m, 'mesh'):
            m.mesh = mesh
    return params


def cache_shardings(cfg: ModelConfig, mesh: Optional[Mesh], batch: int,
                    max_len: int) -> List[Dict[str, Tuple[tuple, Any]]]:
    """The local decode-cache layout of each layer on this rank: name ->
    (shape, dtype). Heads and channels are split over tp and the batch
    over dp (`collectives.dp_rows` rows), as the JAX package's cache
    shardings place them."""
    from evo_tpu_torch.parallel.collectives import dp_rows
    tp = 1 if mesh is None else mesh.tp
    B = dp_rows(batch, mesh)
    cd = getattr(torch, cfg.compute_dtype)
    H, Dh = cfg.num_attention_heads // tp, cfg.head_dim
    C = cfg.hidden_size // tp
    K, S = cfg.short_filter_length, cfg.state_size
    layers = []
    for i in range(cfg.num_layers):
        if cfg.is_attn_layer(i) and cfg.kv_quant == 'int8':
            # head-major, so a head's positions are contiguous for the
            # decode step that streams them
            layers.append({'k': ((B, H, max_len, Dh), torch.int8),
                           'v': ((B, H, max_len, Dh), torch.int8),
                           'ks': ((B, H, max_len), torch.float32),
                           'vs': ((B, H, max_len), torch.float32)})
        elif cfg.is_attn_layer(i):
            layers.append({'k': ((B, max_len, H, Dh), cd),
                           'v': ((B, max_len, H, Dh), cd)})
        else:
            layers.append({'fir': ((B, 3, C, K - 1), cd),
                           'iir': ((B, C, S, 2), torch.float32)})
    return layers


def unshard(module, mesh: Mesh, device='cpu'):
    """A full, unsharded copy of the sharded model `module` on `device`,
    its tp shards gathered one tensor at a time, on the first rank of the
    tp group; the others send their shards and get None. Every rank of
    the group calls it (e.g. before rank 0 writes a serving
    checkpoint)."""
    from evo_tpu_torch.model import StripedHyena
    from evo_tpu_torch.parallel.collectives import gather_cpu
    keep = mesh.index('tp') == 0
    full = StripedHyena(module.config, device) if keep else None
    dest = dict(full.named_parameters()) if keep else {}
    with torch.no_grad():
        for name, p in module.named_parameters():
            axis = tp_axis(name) if mesh.tp > 1 else None
            t = p.detach() if axis is None else torch.cat(
                gather_cpu(p.detach(), mesh, 'tp'), dim=axis)
            if keep:
                dest[name].copy_(t)
    return full
