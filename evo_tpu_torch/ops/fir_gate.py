"""Hyena FIR + gate: the CUDA kernel (`csrc/fir_gate.cu`) and its plain
version.

Port of `evo_tpu/ops/pallas_fir.py:fir_gate_pallas`; the plain version is
the in-projection bias, then `ops/fftconv.py:fir_causal_conv` followed by
the gate, as in `evo_tpu/layers/hyena.py:182-185`. Both take the carried
FIR tail of a resumed segment (the JAX package runs only its plain
composition there).

The streams z are `(B, 3, C, L)` to the caller. On the card the kernel
reads them where the in-projection left them: z must be the view
`zl.permute(0, 2, 3, 1)` of the product's `(B, L, 3, C)` output, and the
kernel adds the in-projection bias `b_in` itself, so the layer makes
neither the bias pass nor the `(B, 3, C, L)` copy. Under autograd the
kernel runs inside `FirGateFunction`, whose backward is the plain
version's gradient (`ops/_grad.py`), taken with z still the view of the
in-projection's output.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from evo_tpu_torch.ops import _build
from evo_tpu_torch.ops._grad import needs_grad, plain_vjp
from evo_tpu_torch.ops.fftconv import fir_causal_conv

KERNEL_TAPS = 3     # the kernel's filter length (every published evo config)
# the taps' and FIR bias's type -> (entry point, launch counter): a model
# whose param_dtype is float32 under bf16 activations keeps them float32,
# which the kernel reads as stored (the JAX kernel upcasts them); b_in
# comes rounded to the activation type, as the layer rounds it
WEIGHT_TYPES = {torch.bfloat16: ('evo_fir_gate_bf16', 'fir_gate'),
                torch.float32: ('evo_fir_gate_bf16_wf32', 'fir_gate_w32')}


def fir_gate_plain(z: torch.Tensor, w: torch.Tensor,
                   b: Optional[torch.Tensor] = None,
                   tail: Optional[torch.Tensor] = None,
                   b_in: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """z: (B, 3, C, L), any strides; w: (3, C, K); b: (3, C) or None;
    tail: (B, 3, C, K-1), the (biased) inputs before t=0 (None = zeros, a
    fresh sequence); b_in: (3, C), added to z first, or None. Returns
    (x2, u = x1 * v), each (B, C, L) in z.dtype; the FIR output is rounded
    to z.dtype before the gate."""
    if b_in is not None:
        z = z + b_in[None, :, :, None]
    zf, _ = fir_causal_conv(z, w, b, tail)
    return zf[:, 0], zf[:, 1] * zf[:, 2]


def in_projection_layout(z: torch.Tensor) -> bool:
    """Whether z (B, 3, C, L) lies as the (B, L, 3, C) tensor it views:
    channel stride 1, stream stride C, position stride 3C, batch stride
    3CL (the strides of axes of length 1 do not matter)."""
    B, _, C, L = z.shape
    want = (3 * C * L, C, 1, 3 * C)
    return all(n == 1 or s == w
               for n, s, w in zip(z.shape, z.stride(), want))


def check_kernel_args(z: torch.Tensor, w: torch.Tensor,
                      b: Optional[torch.Tensor],
                      tail: Optional[torch.Tensor],
                      b_in: Optional[torch.Tensor]) -> None:
    """Raise on what the kernel does not take (before any launch)."""
    if z.dim() != 4 or z.shape[1] != 3:
        raise ValueError(f'fir_gate: z must be (B, 3, C, L), got '
                         f'{tuple(z.shape)}')
    B, _, C, L = z.shape
    K = w.shape[-1]
    if z.dtype != torch.bfloat16:
        raise TypeError(f'fir_gate kernel takes bf16, got {z.dtype}')
    if w.dtype not in WEIGHT_TYPES or (b is not None and b.dtype != w.dtype):
        raise TypeError(f'fir_gate kernel takes the taps and the FIR bias in '
                        f'one type, bf16 or float32; got {w.dtype} and '
                        f'{None if b is None else b.dtype}')
    for t in (w, b, tail, b_in):
        if t is not None and (t.device != z.device or not t.is_contiguous()):
            raise ValueError('fir_gate kernel needs w, b, tail and b_in '
                             'contiguous and on one device with z')
    for t in (tail, b_in):
        if t is not None and t.dtype != z.dtype:
            raise ValueError(f'fir_gate kernel needs the tail and b_in of '
                             f'one type with z ({z.dtype}), got {t.dtype}')
    if K != KERNEL_TAPS:
        raise ValueError(f'fir_gate kernel is built for {KERNEL_TAPS} taps '
                         f'(short_filter_length), got {K}')
    if C % 8:
        raise ValueError(f'fir_gate kernel needs C % 8 == 0 (16-byte '
                         f'channel rows), got C={C}')
    if not in_projection_layout(z) or z.data_ptr() % 16:
        raise ValueError(
            'fir_gate kernel reads the in-projection output (B, L, 3, C) in '
            'place: pass zl.permute(0, 2, 3, 1) of a contiguous, 16-byte '
            f'aligned zl; got strides {z.stride()} for shape '
            f'{tuple(z.shape)}')
    if w.shape != (3, C, K) or (b is not None and b.shape != (3, C)) \
            or (b_in is not None and b_in.shape != (3, C)) \
            or (tail is not None and tail.shape != (B, 3, C, K - 1)):
        raise ValueError(
            f'fir_gate: w {tuple(w.shape)} / b '
            f'{None if b is None else tuple(b.shape)} / b_in '
            f'{None if b_in is None else tuple(b_in.shape)} / tail '
            f'{None if tail is None else tuple(tail.shape)} do not match z '
            f'{tuple(z.shape)}')


def fir_gate_kernel(z: torch.Tensor, w: torch.Tensor,
                    b: Optional[torch.Tensor] = None,
                    tail: Optional[torch.Tensor] = None,
                    b_in: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA tensors (raises on what it does not
    take). Its outputs have no autograd history."""
    check_kernel_args(z, w, b, tail, b_in)
    B, _, C, L = z.shape
    x2 = torch.empty((B, C, L), dtype=z.dtype, device=z.device)
    u = torch.empty_like(x2)
    if x2.numel():
        entry, counter = WEIGHT_TYPES[w.dtype]
        _build.launch(entry, counter, z.data_ptr(),
                      w.data_ptr(), _ptr(b), _ptr(b_in), _ptr(tail),
                      x2.data_ptr(), u.data_ptr(), B, C, L, w.shape[-1])
    return x2, u


class FirGateFunction(torch.autograd.Function):
    """`forward_impl(z, w, b, tail, b_in)` (the kernel) with the gradient
    of `fir_gate_plain` to z, the taps, both biases and the tail,
    recomputed from the saved inputs. z is saved as it was given (the view
    of the in-projection's output), not copied."""

    @staticmethod
    def forward(ctx, z, w, b, tail, b_in, forward_impl):
        ctx.save_for_backward(z, w, b, tail, b_in)
        return forward_impl(z, w, b, tail, b_in)

    @staticmethod
    def backward(ctx, gx2, gu):
        grads = plain_vjp(fir_gate_plain, ctx.saved_tensors,
                          ctx.needs_input_grad[:5], (gx2, gu))
        return (*grads, None)


def fir_gate(z: torch.Tensor, w: torch.Tensor,
             b: Optional[torch.Tensor] = None,
             tail: Optional[torch.Tensor] = None,
             b_in: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused in-projection bias + FIR + gate; arguments as for
    `fir_gate_plain`. A CUDA tensor launches the kernel, which needs z in
    the in-projection's layout (`in_projection_layout`) and raises on
    anything else, through `FirGateFunction` when an argument requires
    grad; a CPU tensor takes the plain version."""
    if not _build.check_device(z, 'fir_gate'):
        return fir_gate_plain(z, w, b, tail, b_in)
    if needs_grad(z, w, b, tail, b_in):
        return FirGateFunction.apply(z, w, b, tail, b_in, fir_gate_kernel)
    return fir_gate_kernel(z, w, b, tail, b_in)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()
