"""Weights drawn on the device from the run's seed, in the reference
(HF snapshot) names and torch layouts, in the type they are served in.

The distributions are those of `evo_tpu_torch.model.random_init`
(embedding N(0, 0.02); projections N(0, fan_in^-1/2); FIR taps N(0,
K^-1/2); residues N(0, 1/S); poles of magnitude U(0.6, 0.99) and phase
U(-pi, pi), float32), and the biases, gains and D_skip, which that
function leaves at 0 and 1, are drawn too (N(0, 0.02) about them), so
that the comparison with the reference covers their paths. Each layer
is one float32 draw on the card's generator, cut into its leaves and cast
to bf16: a few large calls, nothing on the host. The same seed gives the
same tensors, so the reference regenerates them after the program has
been freed instead of holding a second copy beside it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from benchmark.roofline import inner_mlp_size

SEED_MASK = (1 << 63) - 1


def _leaves(cfg: dict, i: int) -> List[Tuple[str, tuple, float, float]]:
    """(name, shape, mean, std) of layer i's Gaussian leaves."""
    D = cfg['hidden_size']
    K = cfg['short_filter_length']
    inner = inner_mlp_size(cfg)
    p = f'blocks.{i}.'
    small = 0.02
    leaves = [(p + 'pre_norm.scale', (D,), 1.0, small),
              (p + 'post_norm.scale', (D,), 1.0, small),
              (p + 'mlp.l1.weight', (inner, D), 0.0, D ** -0.5),
              (p + 'mlp.l2.weight', (inner, D), 0.0, D ** -0.5),
              (p + 'mlp.l3.weight', (D, inner), 0.0, inner ** -0.5)]
    if i in cfg['attn_layer_idxs']:
        return leaves + [
            (p + 'inner_mha_cls.Wqkv.weight', (3 * D, D), 0.0, D ** -0.5),
            (p + 'inner_mha_cls.Wqkv.bias', (3 * D,), 0.0, small),
            (p + 'inner_mha_cls.out_proj.weight', (D, D), 0.0, D ** -0.5),
            (p + 'inner_mha_cls.out_proj.bias', (D,), 0.0, small)]
    return leaves + [
        (p + 'projections.weight', (3 * D, D), 0.0, D ** -0.5),
        (p + 'projections.bias', (3 * D,), 0.0, small),
        (p + 'filter.short_filter_weight', (3 * D, 1, K), 0.0, K ** -0.5),
        (p + 'filter.short_filter_bias', (3 * D,), 0.0, small),
        (p + 'filter.D', (D,), 1.0, small),
        (p + 'out_filter_dense.weight', (D, D), 0.0, D ** -0.5),
        (p + 'out_filter_dense.bias', (D,), 0.0, small)]


def _draw(gen: torch.Generator, leaves, device, dtype
          ) -> Dict[str, torch.Tensor]:
    total = sum(math.prod(shape) for _, shape, _, _ in leaves)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    flat.normal_(generator=gen)
    out, at = {}, 0
    for name, shape, mean, std in leaves:
        n = math.prod(shape)
        out[name] = (flat[at:at + n].view(shape) * std + mean).to(dtype)
        at += n
    return out


def draw(cfg: dict, seed: int, device, dtype=torch.bfloat16
         ) -> Dict[str, torch.Tensor]:
    """The whole state dict of `cfg` (the published YAML keys) from
    `seed`."""
    gen = torch.Generator(device=device).manual_seed(int(seed) & SEED_MASK)
    D, S = cfg['hidden_size'], cfg['state_size']
    V = cfg['vocab_size']
    sd = _draw(gen, [('embedding_layer.weight', (V, D), 0.0, 0.02),
                     ('norm.scale', (D,), 1.0, 0.02)], device, dtype)
    for i in range(cfg['num_layers']):
        sd.update(_draw(gen, _leaves(cfg, i), device, dtype))
        if i in cfg['attn_layer_idxs']:
            continue
        p = f'blocks.{i}.filter.'
        u = torch.empty((2, D, S), dtype=torch.float32, device=device)
        u.uniform_(generator=gen)
        mag = 0.6 + 0.39 * u[0]
        ang = math.pi * (2 * u[1] - 1)
        sd[p + 'poles'] = torch.stack([mag * torch.cos(ang),
                                       mag * torch.sin(ang)],
                                      dim=-1)[:, :, None]
        res = torch.empty((D, S, 1, 2), dtype=torch.float32, device=device)
        sd[p + 'residues'] = res.normal_(0.0, 1.0 / S, generator=gen)
    return sd


def fingerprint(sd: Dict[str, torch.Tensor]) -> float:
    """A float64 checksum of every tensor, to show that a regenerated
    state dict is the one the program was built from."""
    total = torch.zeros((), dtype=torch.float64,
                        device=next(iter(sd.values())).device)
    for i, name in enumerate(sorted(sd)):
        total += (i + 1) * sd[name].double().sum()
    return float(total)
