"""Hyena gated long-convolution mixer, 29 of evo-1's 32 layers (port of
`evo_tpu/layers/hyena.py`):

    z = in_proj(x)                      (B, 3, C, L), streams x2 | x1 | v
    z = short_fir(z)                    depthwise causal FIR, length 3
    u = x1 * v                          pre-gate
    y = longconv(u) + d_skip * u        modal filter, chunked Toeplitz
    out = out_proj(x2 * y)              post-gate

Weights keep the JAX layouts: w_in (D, 3, C), fir_w (3, C, K), poles and
residues (C, S, 2) float32, d_skip (C,), w_out (C, D).

Decode state (`HyenaState`): fir (B, 3, C, K-1) trailing pre-FIR inputs
and iir (B, C, S, 2) float32 modal state. Ported paths: a fresh full
sequence (`hyena_full`) and the decode step (`hyena_step`); continuing a
sequence from a carried state is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from evo_tpu_torch.config import ModelConfig
from evo_tpu_torch.ops import fftconv
from evo_tpu_torch.ops.fir_gate import fir_gate


class HyenaState(NamedTuple):
    fir: torch.Tensor   # (B, 3, C, K-1)
    iir: torch.Tensor   # (B, C, S, 2) float32


class HyenaMixer(nn.Module):
    def __init__(self, cfg: ModelConfig, *, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        D = cfg.hidden_size
        K, S = cfg.short_filter_length, cfg.state_size

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


def _out_proj(p: HyenaMixer, y: torch.Tensor) -> torch.Tensor:
    o = y @ p.w_out
    if p.b_out is not None:
        o = o + p.b_out
    return o


def hyena_full(p: HyenaMixer, cfg: ModelConfig, x: torch.Tensor, *,
               collect_state: bool = False):
    """Fresh full-sequence mixer: x (B, L, D) -> (y (B, L, D), HyenaState
    after position L-1, or None unless `collect_state`).

    The FIR + gate kernel runs when L >= short_filter_length; a shorter
    sequence takes `fir_causal_conv`, as in the JAX package."""
    B, L, D = x.shape
    C = p.w_in.shape[-1]
    K = cfg.short_filter_length
    zl = (x @ p.w_in.reshape(D, 3 * C)).view(B, L, 3, C)
    if p.b_in is not None:
        zl = zl + p.b_in
    z = zl.permute(0, 2, 3, 1).contiguous()          # (B, 3, C, L)
    if L >= K:
        x2, u = fir_gate(z, p.fir_w, p.fir_b)
        fir_state = z[..., L - (K - 1):]
    else:
        zf, fir_state = fftconv.fir_causal_conv(z, p.fir_w, p.fir_b)
        x2, u = zf[:, 0], zf[:, 1] * zf[:, 2]
    y, iir = fftconv.conv_matmul_chunked(
        u, p.poles, p.residues, cfg.hyena_matmul_chunk, d_skip=p.d_skip)
    y = x2 * y.to(x.dtype)
    out = _out_proj(p, y.transpose(1, 2))
    if not collect_state:
        return out, None
    # copy the FIR tail out of z, so z itself is freed with this layer
    return out, HyenaState(fir=fir_state.contiguous(), iir=iir)


def hyena_step(p: HyenaMixer, cfg: ModelConfig, x_t: torch.Tensor,
               state: HyenaState):
    """Single-token decode step: x_t (B, 1, D) -> (y (B, 1, D), state)."""
    B, _, D = x_t.shape
    C = p.w_in.shape[-1]
    z_t = (x_t[:, 0] @ p.w_in.reshape(D, 3 * C)).view(B, 3, C)
    if p.b_in is not None:
        z_t = z_t + p.b_in
    z_t, fir = fftconv.fir_step(z_t, p.fir_w, p.fir_b, state.fir)
    u = z_t[:, 1] * z_t[:, 2]
    y, iir = fftconv.modal_step(u, p.poles, p.residues, p.d_skip, state.iir)
    y = z_t[:, 0] * y.to(x_t.dtype)
    return _out_proj(p, y[:, None]), HyenaState(fir=fir, iir=iir)
