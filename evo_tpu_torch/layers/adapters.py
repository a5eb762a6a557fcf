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

Decode steps do not read adapters, as in the JAX package, which serves
decode from the merged tree: a decode step on a module with adapters
attached raises (`refuse_in_decode`) and points to `lora.merge_lora`.
"""

from __future__ import annotations

from typing import Dict

import torch


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
    """`out` (the frozen product of `x` with `module`'s weight `name`)
    plus the side path of its adapter, in out's type, when one is
    attached; `out` itself otherwise. `n_in`: the weight's input axes."""
    pr = module.lora.get(name) if module.lora else None
    if pr is None:
        return out
    side = (delta1 if n_in == 1 else delta2)(x, pr, module.lora_scale)
    return out + side.to(out.dtype)


def refuse_in_decode(module: torch.nn.Module) -> None:
    """Raise in a decode step of a module with adapters attached."""
    if module.lora:
        raise RuntimeError(
            'decode steps do not read LoRA adapters (as in the JAX '
            'package); fold them into the weights with lora.merge_lora '
            'and generate from the merged model, or detach_lora first')
