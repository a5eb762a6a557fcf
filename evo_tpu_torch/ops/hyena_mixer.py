"""The fused Hyena mixer core: the CUDA kernel (`csrc/hyena_mixer.cu`) and
its plain version.

Port of `evo_tpu/ops/pallas_hyena.py:hyena_mixer_pallas`: everything
between the mixer's two projections in one pass,

    z' = FIR(z + b_in) + bias (rounded);  x2, x1, v = z';  u = x1 * v
    y  = chunked long conv(u) + d_skip * u;  out = x2 * y

with the modal state and the FIR tail after position L as further
outputs, and the same two as an optional carried state going in. The
plain version is the unfused composition that `layers/hyena.py` runs
without `hyena_fused_mixer` (and the JAX tests' oracle): the in-projection
bias, `fir_causal_conv`, gate, `conv_matmul_chunked`, gate.

The streams z are `(B, 3, C, L)` to the caller. On the card the kernel
reads them where the in-projection left them: z must be the view
`zl.permute(0, 2, 3, 1)` of the product's `(B, L, 3, C)` output, the
kernel adds `b_in` itself, and it writes y as the `(B, C, L)` view of a
`(B, L, C)` buffer, the layout the out-projection reads.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from evo_tpu_torch.ops import _build
from evo_tpu_torch.ops._grad import refuse
from evo_tpu_torch.ops.fftconv import conv_matmul_chunked, fir_causal_conv
from evo_tpu_torch.ops.fir_gate import in_projection_layout

# what one launch of the kernel takes: chunks of at most 64 positions, a
# thread for each of at most 8 modal states of a channel, the FIR window
# compiled in at the three taps every published config has, and 16-byte
# channel rows
MAX_CHUNK = 64
MAX_STATE_SIZE = 8
FILTER_LENGTH = 3
CHANNEL_MULTIPLE = 8

State = Tuple[torch.Tensor, torch.Tensor]


def hyena_mixer_supported(shape, chunk: int, state_size: int = 8,
                          filter_length: int = 3) -> bool:
    """True when the fused kernel takes z of `shape` (B, 3, C, L): the
    chunk Ct = min(chunk, L) divides L and is at most 64, C is a multiple
    of 8 (as `evo_tpu.ops.pallas_hyena._pick_blocks` asks of its channel
    block), for any B, with up to 8 modal states a channel and a FIR of 3
    taps. Other shapes (ragged lengths above all) go through the unfused
    path."""
    B, three, C, L = shape
    if three != 3 or min(B, C, L) < 1 or chunk < 1:
        return False
    Ct = min(chunk, L)
    return (L % Ct == 0 and Ct <= MAX_CHUNK and C % CHANNEL_MULTIPLE == 0
            and 1 <= state_size <= MAX_STATE_SIZE
            and filter_length == FILTER_LENGTH)


def _fir_tail(z: torch.Tensor, Kf: int,
              fir0: Optional[torch.Tensor]) -> torch.Tensor:
    """The last Kf-1 (biased) inputs after this segment, (B, 3, C, Kf-1),
    from the biased streams z (or their last Kf-1 positions)."""
    L = z.shape[-1]
    if L >= Kf - 1:
        return z[..., L - (Kf - 1):]
    if fir0 is None:
        fir0 = z.new_zeros(z.shape[:-1] + (Kf - 1,))
    return torch.cat([fir0.to(z.dtype), z], dim=-1)[..., L:]


def hyena_mixer_plain(z: torch.Tensor, fir_w: torch.Tensor,
                      fir_b: Optional[torch.Tensor], poles: torch.Tensor,
                      residues: torch.Tensor, d_skip: torch.Tensor, *,
                      chunk: int = 64, state: Optional[State] = None,
                      b_in: Optional[torch.Tensor] = None):
    """z: (B, 3, C, L), any strides; fir_w: (3, C, Kf); fir_b: (3, C) or
    None; poles, residues: (C, S, 2) float32; d_skip: (C,); state: (fir
    (B, 3, C, Kf-1), the biased inputs before t=0, iir (B, C, S, 2)) of the
    sequence so far, or None; b_in: (3, C), added to z first, or None.

    Returns (y (B, C, L) z.dtype, the gated output ready for the
    out-projection; iir (B, C, S, 2) float32 and fir_state (B, 3, C, Kf-1)
    z.dtype, the last biased inputs, after position L)."""
    if b_in is not None:
        z = z + b_in[None, :, :, None]
    fir0, iir0 = (None, None) if state is None else state
    zf, fir_state = fir_causal_conv(z, fir_w, fir_b, fir0)
    x2, u = zf[:, 0], zf[:, 1] * zf[:, 2]
    y, iir = conv_matmul_chunked(u, poles, residues, chunk, state=iir0,
                                 d_skip=d_skip)
    return x2 * y.to(z.dtype), iir, fir_state


def _check_kernel_args(z, fir_w, fir_b, poles, residues, d_skip, fir0,
                       iir0, b_in, chunk) -> None:
    """Raise on what the kernel does not take (before any launch)."""
    if z.dim() != 4 or z.shape[1] != 3:
        raise ValueError(f'hyena_mixer: z must be (B, 3, C, L), got '
                         f'{tuple(z.shape)}')
    if z.dtype != torch.bfloat16:
        raise TypeError(f'hyena_mixer kernel takes bf16, got {z.dtype}')
    B, _, C, L = z.shape
    Kf, S = fir_w.shape[-1], poles.shape[1]
    if not hyena_mixer_supported(z.shape, chunk, S, Kf):
        raise ValueError(
            f'hyena_mixer kernel does not take z {tuple(z.shape)} with '
            f'chunk {chunk}, {S} states and {Kf} taps: gate with '
            f'hyena_mixer_supported() first')
    if not in_projection_layout(z) or z.data_ptr() % 16:
        raise ValueError(
            'hyena_mixer kernel reads the in-projection output (B, L, 3, C) '
            'in place: pass zl.permute(0, 2, 3, 1) of a contiguous, 16-byte '
            f'aligned zl; got strides {z.stride()} for shape '
            f'{tuple(z.shape)}')
    if fir_w.shape != (3, C, Kf) or poles.shape != (C, S, 2) \
            or residues.shape != (C, S, 2) or d_skip.shape != (C,) \
            or (fir_b is not None and fir_b.shape != (3, C)) \
            or (b_in is not None and b_in.shape != (3, C)) \
            or (fir0 is not None and fir0.shape != (B, 3, C, Kf - 1)) \
            or (iir0 is not None and iir0.shape != (B, C, S, 2)):
        raise ValueError(
            f'hyena_mixer: parameters or state do not match z '
            f'{tuple(z.shape)}: fir_w {tuple(fir_w.shape)}, poles '
            f'{tuple(poles.shape)}, residues {tuple(residues.shape)}, '
            f'd_skip {tuple(d_skip.shape)}')
    for t, dtype in ((fir_w, z.dtype), (fir_b, z.dtype), (b_in, z.dtype),
                     (d_skip, z.dtype), (fir0, z.dtype),
                     (poles, torch.float32), (residues, torch.float32),
                     (iir0, torch.float32)):
        if t is None:
            continue
        if t.device != z.device:
            raise ValueError('hyena_mixer kernel needs its inputs on one '
                             'device')
        if t.dtype != dtype:
            raise TypeError(f'hyena_mixer kernel takes fir_w, fir_b, b_in, '
                            f'd_skip and the FIR tail in {z.dtype} and the '
                            f'modal tables and state in float32; got '
                            f'{t.dtype}')
    for t in (fir_w, fir_b, b_in, d_skip, poles, residues):
        if t is not None and not t.is_contiguous():
            raise ValueError('hyena_mixer kernel needs its parameters '
                             'contiguous')


def hyena_mixer(z: torch.Tensor, fir_w: torch.Tensor,
                fir_b: Optional[torch.Tensor], poles: torch.Tensor,
                residues: torch.Tensor, d_skip: torch.Tensor, *,
                chunk: int = 64, state: Optional[State] = None,
                b_in: Optional[torch.Tensor] = None):
    """The fused mixer core, arguments and results as `hyena_mixer_plain`.
    A CUDA tensor launches the kernel, which needs z in the in-projection's
    layout (`fir_gate.in_projection_layout`) and raises on anything else or
    on a shape it does not take (ask `hyena_mixer_supported` first); its y
    is the (B, C, L) view of a contiguous (B, L, C) tensor. A CPU tensor
    takes the plain version."""
    if not _build.check_device(z, 'hyena_mixer'):
        return hyena_mixer_plain(z, fir_w, fir_b, poles, residues, d_skip,
                                 chunk=chunk, state=state, b_in=b_in)
    refuse('hyena_mixer', z, fir_w, fir_b, poles, residues, d_skip, b_in)
    fir0, iir0 = (None, None) if state is None else state
    _check_kernel_args(z, fir_w, fir_b, poles, residues, d_skip, fir0, iir0,
                       b_in, chunk)
    B, _, C, L = z.shape
    Kf, S = fir_w.shape[-1], poles.shape[1]
    if fir0 is not None:
        fir0 = fir0.contiguous()
    if iir0 is not None:
        iir0 = iir0.contiguous()
    y = torch.empty((B, L, C), dtype=z.dtype, device=z.device)
    iir = torch.empty((B, C, S, 2), dtype=torch.float32, device=z.device)
    _build.launch('evo_hyena_mixer_bf16', 'hyena_mixer', z.data_ptr(),
                  fir_w.data_ptr(), _ptr(fir_b), _ptr(b_in),
                  poles.data_ptr(), residues.data_ptr(), d_skip.data_ptr(),
                  _ptr(fir0), _ptr(iir0), y.data_ptr(), iir.data_ptr(), B, C,
                  L, min(chunk, L), S, Kf)
    tail = z[..., max(0, L - (Kf - 1)):]
    if b_in is not None:
        tail = tail + b_in[None, :, :, None]
    return y.transpose(1, 2), iir, _fir_tail(tail, Kf, fir0)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()
