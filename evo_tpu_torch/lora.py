"""LoRA (low-rank adaptation) fine-tuning (port of `evo_tpu/lora.py`).

Full fine-tuning keeps float32 masters and two Adam moments, 12 bytes a
parameter (~84 GB at 7B): a multi-card job. LoRA keeps the base weights
frozen in their serving types (12.9 GB at 7B in bf16) and trains only
rank-r factors of the seven projection weights, which carry the masters
and the optimizer state.

Adapted weights (names as in `model.py`, layouts as in the JAX package):

    mlp.w1 (D,I)  mlp.w2 (D,I)  mlp.w3 (I,D)
    attn.wqkv (D,3,H,Dh)  attn.wo (H,Dh,D)
    hyena.w_in (D,3,C)    hyena.w_out (D,D)

For a weight of shape (*in_dims, *out_dims) the factors are A (*in_dims,
r) and B (r, *out_dims); `wo` is the one target with two input axes. A is
Kaiming-initialised from a `torch.Generator`, B is zero, so the adapted
model is exactly the base model at step 0.

The adapter tree is a list with one entry per layer, {'attn' or 'hyena':
{name: {'a': A, 'b': B}}, 'mlp': {...}} (either dict may be empty), the
factors float32 on the model's device. The JAX package keeps the same
tree by segment, each run of Hyena layers stacked along a leading axis;
`checkpoint.lora_to_jax` / `lora_from_jax` convert, and `save_lora` /
`load_lora` read and write the JAX package's npz layout (its
`jax.tree_util.keystr` keys and `__alpha__`), so an adapter file moves
between the two packages with numpy alone.

The adapted weight is never formed: `attach_lora` hands each owning module
its factors and the scale alpha / r, and the layer sites add
`(x @ A) @ (scale * B)` after the frozen product (`layers/adapters.py`).
Decode steps refuse attached adapters; `merge_lora` folds them into the
weights (W + alpha / r * A @ B in float32, cast back) for generation and
serving.

Under a mesh (`parallel/`) the adapters are whole on every rank, drawn
alike from a generator seeded alike, in the shapes of the whole weights
(so `adapters.npz` keeps its layout); each site uses the slice its shard
meets (`layers/adapters.tp_factors`), and `merge_lora` folds into each
rank's shard the same slice of A @ B. `make_lora_train_step` runs under
any (dp, cp, tp): each rank passes its dp rank's rows, the loss is
`training.next_token_loss` normalised by the whole batch's count as
`training.make_sharded_train_step` does (under cp each rank's share of
its rows of the sequence), each adapter gradient is summed over tp, then
cp, then dp, the clip takes the norm of the whole (and equal) gradients,
and AdamW steps every rank's copy of the adapters alike.
"""

from __future__ import annotations

import copy
import math
from typing import Any, Callable, Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from evo_tpu_torch import training
from evo_tpu_torch.checkpoint import _lora_unstack, lora_to_jax
from evo_tpu_torch.layers.adapters import (  # noqa: F401
    TARGETS as _TARGETS, delta1, delta2, tp_factors)
from evo_tpu_torch.model import AttentionBlock
from evo_tpu_torch.ops.fftconv import full_float32
from evo_tpu_torch.parallel.collectives import all_reduce_sum, sum_grads
from evo_tpu_torch.parallel.sharding import full_shape
from evo_tpu_torch.quant import QuantizedWeight

DEFAULT_TARGETS = tuple(_TARGETS)

Lora = List[Dict[str, Dict[str, Dict[str, torch.Tensor]]]]


def _mixer(blk) -> str:
    return 'attn' if isinstance(blk, AttentionBlock) else 'hyena'


def _full_shape(owner, name: str) -> tuple:
    """The shape of the whole weight `name` of `owner` (its tp shard's
    under a mesh)."""
    return full_shape(f'{_TARGETS[name][0]}.{name}',
                      tuple(getattr(owner, name).shape), owner.mesh)


def _sites(module, lora: Lora):
    """(owning module, weight name, {'a', 'b'}) of every adapter."""
    if len(lora) != len(module.blocks):
        raise ValueError(f'adapter tree has {len(lora)} layers, the model '
                         f'{len(module.blocks)}')
    for blk, entry in zip(module.blocks, lora):
        for sub, pairs in entry.items():
            for name, pr in pairs.items():
                yield getattr(blk, sub), name, pr


def init_lora(generator: torch.Generator, model, rank: int = 8,
              targets: Sequence[str] = DEFAULT_TARGETS) -> Lora:
    """Adapters for every target weight of every layer: A normal / sqrt(
    fan_in), drawn from `generator` on its own device, B zeros, both
    float32 on the model's device, in the shapes of the whole weights
    under a mesh too (every rank the same call, with a generator seeded
    alike)."""
    targets = set(targets)
    unknown = targets - set(_TARGETS)
    if unknown:
        raise ValueError(f'unknown LoRA targets {sorted(unknown)}; '
                         f'choose from {sorted(_TARGETS)}')
    module = training.module_of(model)
    out: Lora = []
    for blk in module.blocks:
        entry = {_mixer(blk): {}, 'mlp': {}}
        for name, (sub, n_in) in _TARGETS.items():
            if name not in targets or sub not in entry:
                continue
            w = getattr(getattr(blk, sub), name)
            if isinstance(w, QuantizedWeight):
                raise NotImplementedError(
                    'LoRA over int8 / int4 base weights is not ported yet '
                    '(ROADMAP.md, modules queue: LoRA over a quantized '
                    'base)')
            shape = _full_shape(getattr(blk, sub), name)
            in_dims, out_dims = shape[:n_in], shape[n_in:]
            a = torch.randn((*in_dims, rank), generator=generator,
                            device=generator.device, dtype=torch.float32)
            entry[sub][name] = {
                'a': (a / math.sqrt(math.prod(in_dims))).to(w.device),
                'b': torch.zeros((rank, *out_dims), dtype=torch.float32,
                                 device=w.device)}
        out.append(entry)
    return out


def lora_rank(lora: Lora) -> int:
    """Rank r, read off the first A factor's trailing axis."""
    for entry in lora:
        for pairs in entry.values():
            for pr in pairs.values():
                return int(pr['a'].shape[-1])
    raise ValueError('empty adapter tree')


def named_adapters(lora: Lora) -> Dict[str, torch.Tensor]:
    """The factors by name, 'blocks.<i>.<module>.<weight>.<a|b>'."""
    return {f'blocks.{i}.{sub}.{name}.{f}': t
            for i, entry in enumerate(lora)
            for sub, pairs in entry.items()
            for name, pr in pairs.items() for f, t in pr.items()}


def attach_lora(model, lora: Lora, alpha: float = 16.0):
    """Give each module that owns an adapted weight its factors and the
    scale alpha / r; the full-sequence paths then add the side paths. No
    weight is copied; under a mesh the factors are the whole ones, which
    each site slices. Returns `model`."""
    module = training.module_of(model)
    scale = alpha / lora_rank(lora)
    owners = {}
    for owner, name, pr in _sites(module, lora):
        w = getattr(owner, name)
        n_in = _TARGETS[name][1]
        if isinstance(w, QuantizedWeight):
            raise NotImplementedError(
                'LoRA over int8 / int4 base weights is not ported yet '
                '(ROADMAP.md, modules queue: LoRA over a quantized base)')
        shape = _full_shape(owner, name)
        if (tuple(pr['a'].shape[:-1]) != shape[:n_in]
                or tuple(pr['b'].shape[1:]) != shape[n_in:]
                or pr['a'].shape[-1] != pr['b'].shape[0]):
            raise ValueError(
                f'adapter of {name} has A {tuple(pr["a"].shape)} and B '
                f'{tuple(pr["b"].shape)} for a weight of {shape} '
                '(rank/targets mismatch?)')
        owners.setdefault(owner, {})[name] = pr
    for owner, pairs in owners.items():
        owner.lora, owner.lora_scale = pairs, scale
    return model


def detach_lora(model):
    """Remove every attached adapter. Returns `model`."""
    for m in training.module_of(model).modules():
        if getattr(m, 'lora', None):
            m.lora, m.lora_scale = {}, 1.0
    return model


def attached(model) -> bool:
    return any(getattr(m, 'lora', None)
               for m in training.module_of(model).modules())


@full_float32
def _fold(w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
          scale: float) -> None:
    """w <- w + A @ (scale * B), in float32, cast back to w's type."""
    b = b * scale
    delta = torch.tensordot(a, b.to(a.device), dims=([a.dim() - 1], [0]))
    w.copy_((w.float() + delta).to(w.dtype))


def merge_lora(model, lora: Lora, alpha: float = 16.0,
               donate: bool = False):
    """Fold the adapters into the base weights: W + alpha / r * A @ B,
    computed in float32 and cast back to each weight's type, so the merged
    model serves through every path (decode, serving, quantization after).

    donate=False (default): `model` is left as it is; the result is a new
    model that shares every tensor but the adapted weights. donate=True
    folds into `model` itself and returns it, so two copies of the weights
    never coexist (a 7B merge on one card). Adapters must not be attached
    (`detach_lora`). Under a mesh each rank folds A @ B's slice that its
    shard holds."""
    if attached(model):
        raise ValueError('merge_lora folds into the base weights: '
                         'detach_lora first')
    scale = alpha / lora_rank(lora)
    target = model
    if not donate:
        module = training.module_of(model)
        adapted = {id(getattr(o, n)) for o, n, _ in _sites(module, lora)}
        shared = {id(t): t for t in list(module.parameters())
                  + list(module.buffers()) if id(t) not in adapted}
        target = copy.deepcopy(model, shared)
    with torch.no_grad():
        for owner, name, pr in _sites(training.module_of(target), lora):
            _fold(getattr(owner, name), *tp_factors(owner.mesh, name, pr),
                  scale)
    return target


class LoraTrainState(NamedTuple):
    lora: Lora                          # float32 adapter masters
    opt_state: torch.optim.Optimizer
    step: int


def init_lora_train_state(lora: Lora, optimizer: training.Optimizer
                          ) -> LoraTrainState:
    return LoraTrainState(lora, optimizer.init(named_adapters(lora)), 0)


def make_lora_train_step(model, optimizer: training.Optimizer,
                         alpha: float = 16.0) -> Callable[..., tuple]:
    """step(state, ids, loss_mask=None) -> (state', loss).

    The frozen base is `model` itself, shared with its serving use (the
    JAX step takes it as an argument for the same reason): the adapters
    are attached for the step and detached after it, and gradients flow
    only to them. Set `cfg.remat` for long sequences: the backward then
    recomputes each block instead of keeping every layer's activations.

    Under the model's (dp, cp, tp) mesh every rank calls the step with its
    dp rank's rows of the global batch, whole sequences (each tp and cp
    rank of a dp group the same rows), and the loss returned on every rank
    is the global batch's (module docstring)."""
    module = training.module_of(model)
    mesh = module.mesh
    cfg = training.train_config(module, adapters=True)
    # the axes the loss is summed over: a cp rank's is its rows' share
    axes = [a for a in ('cp', 'dp') if mesh is not None and mesh.shape[a] > 1]

    def train_step(state: LoraTrainState, ids, loss_mask=None):
        params = named_adapters(state.lora)
        count = None
        if 'dp' in axes:
            # the whole batch's count of scored positions, so that the
            # sum of the dp ranks' losses is the global mean
            count = all_reduce_sum(training.scored_positions(
                module, ids, loss_mask), mesh, 'dp')
        training.set_trainable(params.values(), True)
        attach_lora(module, state.lora, alpha)
        try:
            loss = training.next_token_loss(module, cfg, ids, loss_mask,
                                            count)
            loss.backward()
        finally:
            detach_lora(module)
            training.set_trainable(params.values(), False)
        for t in params.values():
            if t.grad is None:
                t.grad = torch.zeros_like(t)
        sum_grads(list(params.values()), mesh)
        optimizer.update(state.opt_state, params, state.step)
        for t in params.values():
            t.grad = None
        loss = loss.detach()
        for axis in axes:
            loss = all_reduce_sum(loss, mesh, axis)
        return (LoraTrainState(state.lora, state.opt_state, state.step + 1),
                loss)

    return train_step


# ---------------------------------------------------------------------------
# Adapter files: the JAX package's npz layout
# ---------------------------------------------------------------------------

def _keystr(path: Tuple) -> str:
    """`jax.tree_util.keystr` of a path of list indices and dict keys."""
    return ''.join(f'[{k}]' if isinstance(k, int) else f'[{k!r}]'
                   for k in path)


def _flat_jax(tree, path=()) -> Dict[str, Any]:
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_jax(tree[k], path + (k,)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat_jax(v, path + (i,)))
        return out
    return {_keystr(path): tree}


def save_lora(lora: Lora, path: str, alpha: float = 16.0) -> None:
    """Write the adapters as the JAX package's `save_lora` does: one npz
    entry per factor of its segment tree, keyed by keystr, and
    `__alpha__`."""
    flat = _flat_jax(lora_to_jax(lora))
    flat['__alpha__'] = np.float32(alpha)
    np.savez(path, **flat)


def load_lora(path: str, template: Lora) -> Tuple[Lora, float]:
    """Read an adapter npz (written by either package) onto `template`
    (e.g. from `init_lora` with the same rank and targets). Returns
    (lora, alpha), the factors float32 on the template's device."""
    want = _flat_jax(lora_to_jax(template))
    got = {}
    with np.load(path) as z:
        alpha = float(z['__alpha__'])
        for key, tmpl in want.items():
            arr = z[key]
            if arr.shape != tmpl.shape:
                raise ValueError(
                    f'adapter leaf {key} has shape {arr.shape}, template '
                    f'expects {tmpl.shape} (rank/targets mismatch?)')
            got[key] = arr
    tree = _unflat_jax(lora_to_jax(template), got)
    device = next(iter(named_adapters(template).values())).device
    kinds = ['attn' if 'attn' in e else 'hyena' for e in template]
    return _lora_unstack(tree, kinds, device), alpha


def _unflat_jax(tree, values: Dict[str, Any], path=()):
    if isinstance(tree, dict):
        return {k: _unflat_jax(v, values, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unflat_jax(v, values, path + (i,))
                for i, v in enumerate(tree)]
    return values[_keystr(path)]
