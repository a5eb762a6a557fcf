"""int8 / int4 weight quantization: opt-in serving modes (port of
`evo_tpu/quant.py`).

Three levers, all off by default:

* `weight_quant: int8`: weight-only. int8 codes with float32 scales per
  output channel halve the weight bytes. `wcast` dequantizes
  (`q.to(dt) * s.to(dt)`) and the product follows, in that order, so the
  results match the JAX package; PyTorch materializes the dequantized
  weight at every call (see PERF.md for what that costs).
* `act_quant: int8` (requires int8 weights): `qdot` quantizes each token's
  activations with a max-abs scale and takes an exact int8 x int8 -> int32
  product against the stored codes.
* `weight_quant: int4`: nibble-packed weights with float32 scales per
  group of 128 contraction rows, unpacked inside the kernel of
  `ops/int4.py`, so device memory sees only the packed bytes. The
  memory-fit mode: a quarter of the bf16 weight bytes plus scales.

What is quantized: the seven large projection families (MLP w1 / w2 / w3,
Hyena w_in / w_out, attention wqkv / wo). Poles and residues, FIR taps,
norms, biases and the tied embedding keep their types.

Symmetric max-abs scales, reduced over the product's contraction axes. A
quantized weight is a `QuantizedWeight` module in the place of the layer's
parameter, holding buffers `q`, `s` (int8) or `q4`, `s4` (int4).

Under a mesh (`parallel/`) the codes and scales follow the weights'
shards. A row-parallel weight (w3, w_out, wo) is split along its
contraction, so its scales and, under `act_quant`, each activation row's
scale are maxima over the whole row, all-reduced over tp: the unsharded
function, as GSPMD computes it in the JAX package. int4 has no sharded
layout.
"""

from __future__ import annotations

import copy
import itertools
from typing import Any, Tuple

import torch
from torch import nn

from evo_tpu_torch.ops import int4 as int4_ops
from evo_tpu_torch.parallel.collectives import all_reduce_max

# weight name -> number of leading contraction axes (layouts of model.py:
# w1, w2 (D, I), w3 (I, D), w_in (D, 3, C), w_out (C, D), wqkv (D, 3, H,
# Dh), wo (H, Dh, D))
_QUANT_AXES = {'w1': 1, 'w2': 1, 'w3': 1, 'w_in': 1, 'w_out': 1, 'wqkv': 1,
               'wo': 2}
# the weights split along their contraction under a mesh
_ROW_PARALLEL = ('w3', 'w_out', 'wo')
INT4_MESH_REFUSAL = ('weight_quant: int4 is single-chip only '
                     '(evo_tpu_torch/ops/int4.py); drop the mesh or use '
                     'int8')
# where each family lives in a block: (submodule, weight names)
_FAMILIES = (('mlp', ('w1', 'w2', 'w3')), ('hyena', ('w_in', 'w_out')),
             ('attn', ('wqkv', 'wo')))


class QuantizedWeight(nn.Module):
    """A quantized projection weight: buffers `q` (int8 codes in the
    weight's own shape) and `s` (float32, contraction axes kept as 1), or
    `q4` ((Kp/2, N) packed nibbles) and `s4` (float32 (Kp/128, *out)).
    `row_mesh`: the mesh whose tp ranks split its contraction (a
    row-parallel shard), else None; `row_axis`: the mesh axes over which
    the contraction is split, tp, or tp and cp for a decode step's block
    (`row_block`)."""

    def __init__(self, mode: str, codes: torch.Tensor, scales: torch.Tensor,
                 row_mesh=None, row_axis='tp'):
        super().__init__()
        self.row_mesh = row_mesh
        self.row_axis = row_axis
        if mode not in ('int8', 'int4'):
            raise ValueError(f'unknown quantization mode {mode!r}')
        self.mode = mode
        names = ('q', 's') if mode == 'int8' else ('q4', 's4')
        self.register_buffer(names[0], codes)
        self.register_buffer(names[1], scales)


def quantize_weight(w: torch.Tensor, axes: Tuple[int, ...], mesh=None
                    ) -> QuantizedWeight:
    """Symmetric int8 with max-abs scales per output channel (reduced over
    `axes`, kept as 1). Rounds half to even, as the JAX package does.
    `mesh`: w is a row-parallel shard, whose maxima are taken over tp."""
    w32 = w.float()
    amax = all_reduce_max(w32.abs().amax(dim=axes, keepdim=True), mesh)
    s = (amax / 127.0).clamp(min=1e-12)
    q = torch.round(w32 / s).clamp(-127, 127).to(torch.int8)
    return QuantizedWeight('int8', q, s, mesh)


def quantize_weight_int4(w: torch.Tensor, nc: int) -> QuantizedWeight:
    """Symmetric int4 with scales per group of 128 contraction rows,
    nibble-packed. The first `nc` axes are the contraction; the output
    axes stay on the scales so `int4_dot` can shape its result: q4
    (Kp/2, prod(out)) int8, s4 (Kp/128, *out) float32, Kp the contraction
    padded to a multiple of 256."""
    out = tuple(w.shape[nc:])
    K = 1
    for d in w.shape[:nc]:
        K *= d
    w2 = w.reshape(K, -1).float()
    N = w2.shape[1]
    Kp = -(-K // 256) * 256        # pack_int4 pairs rows j and Kp/2 + j
    if Kp > K:
        w2 = torch.cat([w2, w2.new_zeros((Kp - K, N))], dim=0)
    G = Kp // 128
    wg = w2.reshape(G, 128, N)
    s = (wg.abs().amax(dim=1) / 7.0).clamp(min=1e-12)          # (G, N)
    q = torch.round(wg / s[:, None]).clamp(-7, 7).to(torch.int8)
    return QuantizedWeight('int4', int4_ops.pack_int4(q.reshape(Kp, N)),
                           s.reshape((G,) + out))


def is_quantized(w: Any) -> bool:
    return isinstance(w, QuantizedWeight) and w.mode == 'int8'


def is_int4(w: Any) -> bool:
    return isinstance(w, QuantizedWeight) and w.mode == 'int4'


def wcast(w: Any, dt: torch.dtype) -> torch.Tensor:
    """The weight-load hook of every projection site: an int8 weight
    dequantized in `dt`, a plain one cast to it."""
    if isinstance(w, QuantizedWeight):
        if w.mode != 'int8':
            raise TypeError('int4 weights go through qdot / int4_dot')
        return w.q.to(dt) * w.s.to(dt)
    return w.to(dt)


def _flatten(x: torch.Tensor, nc: int):
    lead = tuple(x.shape[:x.dim() - nc])
    M = 1
    for d in lead:
        M *= d
    return lead, x.reshape(M, -1)


def int4_dot(x: torch.Tensor, w: QuantizedWeight, nc: int = 1
             ) -> torch.Tensor:
    """Weight-only int4 projection: contract x's last `nc` axes with the
    packed weight's contraction rows.

    Up to `M_MAX` rows (decode steps and forced tokens: M = batch) go
    through `ops.int4.int4_matmul`, which unpacks inside the kernel so
    that device memory sees only the packed bytes. More rows (a batch
    prefill, a scoring forward) dequantize to bf16 and take one
    `torch.matmul`, as the JAX package leaves that product to XLA."""
    q4, s4 = w.q4, w.s4
    out = tuple(s4.shape[1:])
    G, N = s4.shape[0], q4.shape[1]
    Kp = 2 * q4.shape[0]
    lead, x2 = _flatten(x, nc)
    M, K = x2.shape
    x2 = x2.bfloat16()
    s2 = s4.reshape(G, N)
    if int4_ops.int4_matmul_supported(M, Kp):
        # x of K columns (the kernel reads zeros past K), y rounded once to
        # bf16 inside the kernel for a bf16 caller
        y2 = int4_ops.int4_matmul(
            x2.contiguous(), q4, s2,
            torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32)
    else:
        if Kp > K:
            x2 = torch.cat([x2, x2.new_zeros((M, Kp - K))], dim=1)
        wd = (int4_ops.unpack_int4(q4).bfloat16().reshape(G, 128, N)
              * s2[:, None].bfloat16()).reshape(Kp, N)
        if x.dtype == torch.bfloat16:
            y2 = x2 @ wd          # float32 sums, rounded once to bf16
        else:
            y2 = x2.float() @ wd.float()
    return y2.reshape(lead + out).to(x.dtype)


def _int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact a (M, K) int8 @ b (K, N) int8 -> (M, N) int32. The sums reach
    127 * 127 * K, past what float32 holds exactly, so the product is an
    integer one: on the CPU in int32, on CUDA `torch._int_mm`, whose shape
    rules (more than 16 rows, K and N multiples of 8) are met by padding
    with zeros."""
    if a.device.type != 'cuda':
        return a.to(torch.int32) @ b.to(torch.int32)
    if not hasattr(torch, '_int_mm'):
        raise NotImplementedError(
            'act_quant="int8" needs an exact int8 x int8 -> int32 product '
            'on CUDA, which this PyTorch lacks (torch._int_mm)')
    M, K = a.shape
    N = b.shape[1]
    Mp, Kq, Nq = max(32, -(-M // 8) * 8), -(-K // 8) * 8, -(-N // 8) * 8
    if (Mp, Kq) != (M, K):
        a = torch.nn.functional.pad(a, (0, Kq - K, 0, Mp - M))
    if (Kq, Nq) != (K, N):
        b = torch.nn.functional.pad(b, (0, Nq - N, 0, Kq - K))
    return torch._int_mm(a.contiguous(), b.contiguous())[:M, :N]


def qdot(x: torch.Tensor, w: Any, nc: int = 1) -> torch.Tensor:
    """int8 x int8 projection: each token's activations are quantized
    with a symmetric max-abs scale over the contracted axes, multiplied
    exactly in integers with the weight's codes, and rescaled once:
    y = int32_dot * x_scale * w_scale.

    A plain weight takes the ordinary product (so call sites can be
    unconditional under `act_quant`), an int4 weight `int4_dot`. The
    codes of a row-parallel shard (`w.row_mesh`) contract x's axes split
    over tp, so each row's scale is its maximum over tp."""
    if is_int4(w):
        return int4_dot(x, w, nc)
    lead, x2 = _flatten(x, nc)
    if not is_quantized(w):
        wshape = tuple(w.shape[nc:])
        y = x2 @ w.to(x.dtype).reshape(x2.shape[1], -1)
        return y.reshape(lead + wshape)
    wshape = tuple(w.q.shape[nc:])
    x32 = x2.float()
    xs = (all_reduce_max(x32.abs().amax(dim=1, keepdim=True), w.row_mesh,
                         w.row_axis) / 127.0).clamp(min=1e-12)
    xq = torch.round(x32 / xs).clamp(-127, 127).to(torch.int8)
    y32 = _int8_matmul(xq, w.q.reshape(x2.shape[1], -1))
    y = y32.float() * xs * w.s.reshape(1, -1)
    return y.reshape(lead + wshape).to(x.dtype)


def project(x: torch.Tensor, w: Any, nc: int = 1,
            act_quant: bool = False) -> torch.Tensor:
    """What every projection site does: `qdot` under `act_quant` or for an
    int4 weight, else the product with the `wcast` weight."""
    if act_quant or is_int4(w):
        return qdot(x, w, nc)
    lead, x2 = _flatten(x, nc)
    wd = wcast(w, x.dtype)
    y = x2 @ wd.reshape(x2.shape[1], -1)
    return y.reshape(lead + tuple(wd.shape[nc:]))


def row_block(w: Any, start: int, n: int, axis) -> Any:
    """Rows [start, start + n) of the leading (contraction) axis of a
    row-parallel weight, the rest of whose rows other ranks hold along the
    mesh axes `axis`: a view of a plain weight, or the same codes' rows
    with the per-column scales unchanged (still valid for any rows)."""
    if not isinstance(w, QuantizedWeight):
        return w.narrow(0, start, n)
    if w.mode != 'int8':
        raise TypeError('int4 weights have no sharded layout')
    return QuantizedWeight('int8', w.q.narrow(0, start, n), w.s, w.row_mesh,
                           axis)


def _family_sites(model: nn.Module):
    """(owner module, weight name) of every quantizable projection, layer
    by layer."""
    for blk in model.blocks:
        for sub, names in _FAMILIES:
            owner = getattr(blk, sub, None)
            if owner is not None:
                for name in names:
                    yield owner, name


def quantize_params(model: nn.Module, free_source: bool = False,
                    mode: str = 'int8') -> nn.Module:
    """Replace the large projection weights of a `model.StripedHyena` with
    `QuantizedWeight`s of `mode` ('int8' or 'int4'), one layer at a time.
    Returns the quantized model.

    free_source=False leaves `model` as it was: the result is a new module
    tree that shares every tensor it did not quantize. free_source=True
    quantizes `model` itself and drops each source weight as soon as its
    codes exist, so the peak stays near the source's size; pass it only
    when nothing else holds the unquantized model.

    A model already quantized in `mode` comes back unchanged; one
    quantized in the other mode raises (it would silently keep other
    bytes than asked for)."""
    if mode not in ('int8', 'int4'):
        raise ValueError(f'unknown quantization mode {mode!r}')
    if mode == 'int4' and getattr(model, 'mesh', None) is not None:
        raise ValueError(INT4_MESH_REFUSAL)
    if not free_source:
        shared = {id(t): t for t in itertools.chain(model.parameters(),
                                                    model.buffers())}
        model = copy.deepcopy(model, shared)
    for owner, name in _family_sites(model):
        w = getattr(owner, name)
        if isinstance(w, QuantizedWeight):
            if w.mode != mode:
                raise ValueError(
                    f'params already quantized in a different mode (found '
                    f'{w.mode!r} weight {name!r}, requested {mode!r}); '
                    'reload the unquantized weights before switching '
                    'quantization modes')
            continue
        nc = _QUANT_AXES[name]
        src = w.detach()
        row_mesh = owner.mesh if name in _ROW_PARALLEL else None
        qw = (quantize_weight_int4(src, nc) if mode == 'int4'
              else quantize_weight(src, tuple(range(nc)), row_mesh))
        del src, w
        delattr(owner, name)     # the parameter leaves before the module
        setattr(owner, name, qw)  # of the same name is registered
    return model


def quantized_bytes(model: nn.Module) -> int:
    """Total bytes of the model's parameters and buffers."""
    return sum(t.numel() * t.element_size()
               for t in itertools.chain(model.parameters(), model.buffers()))
