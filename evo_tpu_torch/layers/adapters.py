"""LoRA side paths at the projection sites (the sites of `delta1` /
`delta2` in `evo_tpu/layers/{mlp,attention,hyena}.py`).

`lora.attach_lora` gives each module that owns an adapted weight a dict
`lora` {weight name: {'a': A, 'b': B}} of the float32 adapter masters and
the scale `lora_scale` = alpha / r. A site adds the side path
`(x @ A) @ (scale * B)` after the frozen product: A is cast to x's type,
B is scaled in float32 and then cast, as the JAX package's `attach_lora`
scales B in float32 before `delta1` casts it. So the master B receives
the scaled gradient, as it does there. The adapted weight itself is never
formed.

Under tensor parallelism the adapters stay whole on every rank (the JAX
package keeps them replicated), and a site takes the part of them that
its shard of the weight meets (`tp_factors`): at a column-parallel weight
(w1, w2, wqkv, w_in) this rank's slice of B's output axis, at a
row-parallel one (w3, wo, w_out) its slice of A's input axis, whose side
path is a partial sum like the product's and is added to it before the
sum over tp and before the bias. The slices are views, so each rank's
gradient of a factor is zero outside its slice (or, for the factor that
stays whole, a partial sum), and the ranks' gradients sum to the whole
one (`lora.make_lora_train_step`). Under cp the side paths run on the
rank's rows, as the products do.

Decode steps do not read adapters, as in the JAX package, which serves
decode from the merged tree: a decode step on a module with adapters
attached raises (`refuse_in_decode`) and points to `lora.merge_lora`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from evo_tpu_torch.parallel.sharding import tp_axis

# adapted weight -> (owning submodule of a block, number of input axes)
TARGETS = {
    'w1': ('mlp', 1), 'w2': ('mlp', 1), 'w3': ('mlp', 1),
    'wqkv': ('attn', 1), 'wo': ('attn', 2),
    'w_in': ('hyena', 1), 'w_out': ('hyena', 1),
}


def tp_factors(mesh, name: str, pr: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A, B) of weight `name` as this rank's shard of it meets them: at
    tp > 1 A's slice along the weight's tp axis where that axis is an
    input axis, else B's; views of the whole factors."""
    a, b = pr['a'], pr['b']
    if mesh is None or mesh.tp == 1:
        return a, b
    sub, n_in = TARGETS[name]
    axis = tp_axis(f'{sub}.{name}')
    row = axis < n_in
    t, f_axis = (a, axis) if row else (b, 1 + axis - n_in)
    n = t.shape[f_axis] // mesh.tp
    part = t.narrow(f_axis, mesh.index('tp') * n, n)
    return (part, b) if row else (a, part)


def delta1(x: torch.Tensor, pr: Dict[str, torch.Tensor],
           scale: float = 1.0) -> torch.Tensor:
    """Side path of a weight with one input axis: x (..., d_in), A (d_in,
    r), B (r, *out) -> (x @ A) @ (scale * B), (..., *out) in x's type."""
    a = pr['a'].to(x.dtype)
    b = (pr['b'] * scale).to(x.dtype)
    xa = x @ a                                               # (..., r)
    y = xa @ b.reshape(b.shape[0], -1)
    return y.reshape(xa.shape[:-1] + b.shape[1:])


def delta2(y: torch.Tensor, pr: Dict[str, torch.Tensor],
           scale: float = 1.0) -> torch.Tensor:
    """Side path of the two-input-axis `wo` (H, Dh, D): y (B, L, H, Dh),
    A (H, Dh, r), B (r, D) -> (B, L, D) in y's type."""
    a = pr['a'].to(y.dtype)
    b = (pr['b'] * scale).to(y.dtype)
    return torch.einsum('blhe,her->blr', y, a) @ b


def add_lora(module: torch.nn.Module, name: str, x: torch.Tensor,
             out: torch.Tensor, n_in: int = 1) -> torch.Tensor:
    """`out` (the frozen product of `x` with `module`'s shard of its
    weight `name`) plus the side path of its adapter, in out's type, when
    one is attached; `out` itself otherwise. `n_in`: the weight's input
    axes."""
    pr = module.lora.get(name) if module.lora else None
    if pr is None:
        return out
    a, b = tp_factors(module.mesh, name, pr)
    side = (delta1 if n_in == 1 else delta2)(x, {'a': a, 'b': b},
                                             module.lora_scale)
    return out + side.to(out.dtype)


def refuse_in_decode(module: torch.nn.Module) -> None:
    """Raise in a decode step of a module with adapters attached."""
    if module.lora:
        raise RuntimeError(
            'decode steps do not read LoRA adapters (as in the JAX '
            'package); fold them into the weights with lora.merge_lora '
            'and generate from the merged model, or detach_lora first '
            '(over a quantized base: merge into the float weights it was '
            'quantized from, then quant.quantize_params)')
