"""Gradients through the kernels of the training path.

A CUDA kernel writes its output through a raw pointer, so what it returns
has no autograd history: a loss computed through it would train nothing
behind it, and raise nothing. The JAX package avoids the question by
forcing its plain paths in both train steps (`use_pallas='never'`), since
its Pallas kernels have no VJP.

The port keeps the kernels on the card and gives the three that a training
forward runs (RMSNorm, FIR + gate, causal flash attention) a
`torch.autograd.Function` each: the forward is the kernel, the backward is
the gradient of the kernel's plain version, recomputed from the saved
inputs (`plain_vjp`). A wrapper enters its Function only when one of its
tensor arguments requires grad and grad mode is on, so scoring, generation
and serving launch exactly as before. The other kernels have no backward:
their wrappers refuse a tensor that requires grad (`refuse`), and the
train steps turn their switches off as the JAX package does.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def needs_grad(*tensors) -> bool:
    """Whether grad mode is on and one of the tensors requires grad."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def refuse(what: str, *tensors) -> None:
    """Raise where a kernel without a backward would be given a tensor
    that requires grad: its output would silently carry no gradient."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f'{what}: this CUDA kernel has no backward, and its output would '
            'carry no gradient; run it under torch.no_grad(), or train with '
            'its switch off as the train steps of training.py and lora.py do')


def plain_vjp(fn: Callable, inputs: Sequence, needs: Sequence[bool],
              grad_outputs: Sequence) -> tuple:
    """The vector-Jacobian product of `fn(*inputs)` with `grad_outputs`,
    by recomputing fn under autograd on detached copies of the inputs.
    Returns one gradient per input: None where `needs` is False. An output
    whose gradient is None contributes nothing."""
    leaves = [t.detach().requires_grad_(bool(n))
              if isinstance(t, torch.Tensor) else t
              for t, n in zip(inputs, needs)]
    with torch.enable_grad():
        out = fn(*leaves)
    if isinstance(out, torch.Tensor):
        out = (out,)
    pairs = [(o, g) for o, g in zip(out, grad_outputs)
             if g is not None and o.requires_grad]
    wrt = [t for t, n in zip(leaves, needs) if n]
    got = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                   [g for _, g in pairs], allow_unused=True))
    return tuple(next(got) if n else None for n in needs)
