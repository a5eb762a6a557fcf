"""Hyena gated long-convolution mixer, 29 of evo-1's 32 layers (port of
`evo_tpu/layers/hyena.py`):

    z = in_proj(x)                      (B, 3, C, L), streams x2 | x1 | v
    z = short_fir(z)                    depthwise causal FIR, length 3
    u = x1 * v                          pre-gate
    y = longconv(u) + d_skip * u        modal filter, chunked Toeplitz
    out = out_proj(x2 * y)              post-gate

Weights keep the JAX layouts: w_in (D, 3, C), fir_w (3, C, K), poles and
residues (C, S, 2) float32, d_skip (C,), w_out (C, D). w_in and w_out may
be `QuantizedWeight`s (`quant.py`); the projections go through `project`.

Decode state (`HyenaState`): fir (B, 3, C, K-1) trailing pre-FIR inputs
and iir (B, C, S, 2) float32 modal state. Paths: a full sequence or a
segment that continues from a carried state (`hyena_full`), and the decode
step (`hyena_step`). Under `hyena_fused_mixer` the whole core between the
projections is one kernel (`ops/hyena_mixer.py`) wherever its shape rule
holds; under `hyena_pallas_prefix` the unfused long conv takes the prefix
kernel (`ops/modal_prefix.py`). On both paths the in-projection's output
stays in its (B, L, 3, C) layout: the FIR + gate kernel and the fused
mixer read it in place and add the in-projection bias themselves.
Adapters attached by `lora.attach_lora` add their side paths after w_in
(in that (B, L, 3, C) layout, so the kernels still read it in place) and
w_out on the full-sequence path; the decode step refuses them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from evo_tpu_torch.config import ModelConfig
from evo_tpu_torch.layers.adapters import add_lora, refuse_in_decode
from evo_tpu_torch.ops import fftconv
from evo_tpu_torch.ops.fir_gate import fir_gate
from evo_tpu_torch.ops.hyena_mixer import hyena_mixer, hyena_mixer_supported
from evo_tpu_torch.quant import project


class HyenaState(NamedTuple):
    fir: torch.Tensor   # (B, 3, C, K-1)
    iir: torch.Tensor   # (B, C, S, 2) float32


class HyenaMixer(nn.Module):
    def __init__(self, cfg: ModelConfig, *, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        D = cfg.hidden_size
        K, S = cfg.short_filter_length, cfg.state_size
        self.act_quant = cfg.act_quant == 'int8'

        def param(make, *shape, dt=dtype):
            return nn.Parameter(make(shape, dtype=dt, device=device),
                                requires_grad=False)

        self.w_in = param(torch.empty, D, 3, D)
        self.fir_w = param(torch.empty, 3, D, K)
        self.poles = param(torch.empty, D, S, 2, dt=torch.float32)
        self.residues = param(torch.empty, D, S, 2, dt=torch.float32)
        self.d_skip = param(torch.ones, D)
        self.w_out = param(torch.empty, D, D)
        self.b_in = param(torch.zeros, 3, D) if cfg.hyena_proj_bias \
            else None
        self.fir_b = param(torch.zeros, 3, D) if cfg.short_filter_bias \
            else None
        self.b_out = param(torch.zeros, D) if cfg.hyena_out_proj_bias \
            else None
        self.lora, self.lora_scale = {}, 1.0


def _out_proj(p: HyenaMixer, y: torch.Tensor) -> torch.Tensor:
    o = project(y, p.w_out, 1, p.act_quant)
    if p.b_out is not None:
        o = o + p.b_out
    return add_lora(p, 'w_out', y, o)


def _streams(zl: torch.Tensor, b_in: Optional[torch.Tensor]) -> torch.Tensor:
    """The in-projection's output (B, L, 3, C) plus its bias, as the
    contiguous (B, 3, C, L) streams: a copy, for what still reads that
    layout (`fir_causal_conv` below the FIR width, and the FIR tail of the
    unfused branch, over its last K-1 positions only)."""
    if b_in is not None:
        zl = zl + b_in
    return zl.permute(0, 2, 3, 1).contiguous()


def hyena_full(p: HyenaMixer, cfg: ModelConfig, x: torch.Tensor, *,
               collect_state: bool = False,
               state: Optional[HyenaState] = None):
    """Full-sequence mixer: x (B, L, D) -> (y (B, L, D), HyenaState after
    position L-1, or None unless `collect_state`). With `state`, x is a
    segment that continues the sequence the state was collected from: the
    FIR reads the carried tail before t=0 and the long conv starts from
    the carried modal state, both exactly.

    Under `cfg.hyena_fused_mixer` the fused kernel takes every shape it
    supports, fresh or continued, with L >= short_filter_length (a
    shorter one would return a truncated FIR state); the choice is made
    from the flag and the shape alone. Otherwise the FIR + gate kernel
    runs when L >= short_filter_length, and a shorter sequence takes
    `fir_causal_conv`, as in the JAX package."""
    L = x.shape[1]
    K = cfg.short_filter_length
    chunk = cfg.hyena_matmul_chunk
    zl = add_lora(p, 'w_in', x,
                  project(x, p.w_in, 1, p.act_quant))   # (B, L, 3, C)
    B, C = zl.shape[0], zl.shape[-1]
    if (cfg.hyena_fused_mixer and L >= K
            and hyena_mixer_supported((B, 3, C, L), chunk, cfg.state_size,
                                      K)):
        # the kernel reads zl where the product left it, adds b_in and
        # writes y as the (B, L, C) tensor the out-projection reads
        y, iir, fir_state = hyena_mixer(
            zl.permute(0, 2, 3, 1), p.fir_w, p.fir_b, p.poles, p.residues,
            p.d_skip, chunk=chunk,
            state=None if state is None else (state.fir, state.iir),
            b_in=p.b_in)
        out = _out_proj(p, y.transpose(1, 2))
        if not collect_state:
            return out, None
        return out, HyenaState(fir=fir_state.contiguous(), iir=iir)
    tail = None if state is None else state.fir.contiguous()
    if L >= K:
        # the kernel reads zl where the product left it and adds b_in
        x2, u = fir_gate(zl.permute(0, 2, 3, 1), p.fir_w, p.fir_b, tail,
                         b_in=p.b_in)
        fir_state = (_streams(zl[:, L - (K - 1):], p.b_in)
                     if collect_state else None)
    else:
        zf, fir_state = fftconv.fir_causal_conv(_streams(zl, p.b_in),
                                                p.fir_w, p.fir_b, tail)
        x2, u = zf[:, 0], zf[:, 1] * zf[:, 2]
    iir = None if state is None else state.iir
    prefix = cfg.hyena_pallas_prefix
    if state is not None and L > chunk and L % chunk:
        # a continued conv needs chunk | L: the aligned prefix runs
        # chunked, then the remainder (shorter than a chunk) from the
        # state in between
        split = (L // chunk) * chunk
        y1, iir = fftconv.conv_matmul_chunked(
            u[..., :split], p.poles, p.residues, chunk, state=iir,
            d_skip=p.d_skip, pallas_prefix=prefix)
        y2, iir = fftconv.conv_matmul_chunked(
            u[..., split:], p.poles, p.residues, chunk, state=iir,
            d_skip=p.d_skip, pallas_prefix=prefix)
        y = torch.cat([y1, y2], dim=-1)
    else:
        y, iir = fftconv.conv_matmul_chunked(
            u, p.poles, p.residues, chunk, state=iir, d_skip=p.d_skip,
            pallas_prefix=prefix)
    y = x2 * y.to(x.dtype)
    out = _out_proj(p, y.transpose(1, 2))
    if not collect_state:
        return out, None
    # a copy of the FIR tail, so the streams themselves are freed here
    return out, HyenaState(fir=fir_state.contiguous(), iir=iir)


def hyena_step(p: HyenaMixer, cfg: ModelConfig, x_t: torch.Tensor,
               state: HyenaState):
    """Single-token decode step: x_t (B, 1, D) -> (y (B, 1, D), state)."""
    refuse_in_decode(p)
    z_t = project(x_t[:, 0], p.w_in, 1, p.act_quant)   # (B, 3, C)
    if p.b_in is not None:
        z_t = z_t + p.b_in
    z_t, fir = fftconv.fir_step(z_t, p.fir_w, p.fir_b, state.fir)
    u = z_t[:, 1] * z_t[:, 2]
    y, iir = fftconv.modal_step(u, p.poles, p.residues, p.d_skip, state.iir)
    y = z_t[:, 0] * y.to(x_t.dtype)
    return _out_proj(p, y[:, None]), HyenaState(fir=fir, iir=iir)
