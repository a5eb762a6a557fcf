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
"""

from __future__ import annotations

import copy
import math
from typing import Any, Callable, Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from evo_tpu_torch import training
from evo_tpu_torch.checkpoint import _lora_unstack, lora_to_jax
from evo_tpu_torch.layers.adapters import delta1, delta2  # noqa: F401
from evo_tpu_torch.model import AttentionBlock
from evo_tpu_torch.ops.fftconv import full_float32
from evo_tpu_torch.parallel import refuse_mesh
from evo_tpu_torch.quant import QuantizedWeight

# target weight -> (owning submodule of a block, number of input axes)
_TARGETS = {
    'w1': ('mlp', 1), 'w2': ('mlp', 1), 'w3': ('mlp', 1),
    'wqkv': ('attn', 1), 'wo': ('attn', 2),
    'w_in': ('hyena', 1), 'w_out': ('hyena', 1),
}
DEFAULT_TARGETS = tuple(_TARGETS)

Lora = List[Dict[str, Dict[str, Dict[str, torch.Tensor]]]]


def _mixer(blk) -> str:
    return 'attn' if isinstance(blk, AttentionBlock) else 'hyena'


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
    float32 on the model's device."""
    targets = set(targets)
    unknown = targets - set(_TARGETS)
    if unknown:
        raise ValueError(f'unknown LoRA targets {sorted(unknown)}; '
                         f'choose from {sorted(_TARGETS)}')
    module = training.module_of(model)
    refuse_mesh('LoRA', module.mesh)
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
            in_dims, out_dims = tuple(w.shape[:n_in]), tuple(w.shape[n_in:])
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
    weight is copied. Returns `model`."""
    module = training.module_of(model)
    refuse_mesh('LoRA', module.mesh)
    scale = alpha / lora_rank(lora)
    owners = {}
    for owner, name, pr in _sites(module, lora):
        w = getattr(owner, name)
        n_in = _TARGETS[name][1]
        if isinstance(w, QuantizedWeight):
            raise NotImplementedError(
                'LoRA over int8 / int4 base weights is not ported yet '
                '(ROADMAP.md, modules queue: LoRA over a quantized base)')
        if (tuple(pr['a'].shape[:-1]) != tuple(w.shape[:n_in])
                or tuple(pr['b'].shape[1:]) != tuple(w.shape[n_in:])
                or pr['a'].shape[-1] != pr['b'].shape[0]):
            raise ValueError(
                f'adapter of {name} has A {tuple(pr["a"].shape)} and B '
                f'{tuple(pr["b"].shape)} for a weight of {tuple(w.shape)} '
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
def _fold(w: torch.Tensor, pr: Dict[str, torch.Tensor],
          scale: float) -> None:
    """w <- w + A @ (scale * B), in float32, cast back to w's type."""
    a, b = pr['a'], pr['b'] * scale
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
    (`detach_lora`)."""
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
            _fold(getattr(owner, name), pr, scale)
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
    recomputes each block instead of keeping every layer's activations."""
    module = training.module_of(model)
    refuse_mesh('LoRA', module.mesh)
    cfg = training.train_config(module, adapters=True)

    def train_step(state: LoraTrainState, ids, loss_mask=None):
        params = named_adapters(state.lora)
        training.set_trainable(params.values(), True)
        attach_lora(module, state.lora, alpha)
        try:
            loss = training.next_token_loss(module, cfg, ids, loss_mask)
            loss.backward()
        finally:
            detach_lora(module)
            training.set_trainable(params.values(), False)
        for t in params.values():
            if t.grad is None:
                t.grad = torch.zeros_like(t)
        optimizer.update(state.opt_state, params, state.step)
        for t in params.values():
            t.grad = None
        return (LoraTrainState(state.lora, state.opt_state, state.step + 1),
                loss.detach())

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
