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
Under a mesh (`parallel/`) a rank holds C/tp channels of every C-axis
tensor and the matching rows of w_out: everything between the
projections, kernels included, runs on the local channels unchanged, and
the out-projection's partial products are summed over tp before b_out.
Under context parallelism (cp > 1) x is this rank's rows of the sequence:
the in-projection runs on them, one all-to-all over cp gives the whole
sequence of the rank's block of C/(tp cp) channels (`mesh.
channel_block`), the core runs there unchanged (kernels included, at
C/(tp cp)), and the reverse all-to-all gives back the rows for the
out-projection. The decode step keeps the same block of channels of the
in-projection's output and of the state, and sums its partial product
over tp and cp together.

Decode state (`HyenaState`): fir (B, 3, C, K-1) trailing pre-FIR inputs
and iir (B, C, S, 2) float32 modal state. Paths: a full sequence or a
segment that continues from a carried state (`hyena_full`), and the decode
step (`hyena_step`). The long conv has the JAX package's two backends
(`hyena_conv_backend`): 'matmul', the chunked Toeplitz products, and
'fft', real FFTs (monolithic with the modal state scanned afterwards for
decode, or chunked under `hyena_fft_chunk` with the state carried between
chunks). Under 'matmul' and `hyena_fused_mixer` the whole core between the
projections is one kernel (`ops/hyena_mixer.py`) wherever its shape rule
holds; under `hyena_pallas_prefix` the unfused matmul conv takes the
prefix kernel (`ops/modal_prefix.py`). On both paths the in-projection's output
stays in its (B, L, 3, C) layout: the FIR + gate kernel and the fused
mixer read it in place and add the in-projection bias themselves.
Adapters attached by `lora.attach_lora` add their side paths after w_in
(in that (B, L, 3, C) layout, so the kernels still read it in place) and
after w_out (before its sum over tp and its bias) on the full-sequence
path; the decode step refuses them.
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
from evo_tpu_torch.parallel.collectives import (all_reduce_sum, copy_to_tp,
                                                heads_to_seq, reduce_from_tp,
                                                seq_to_heads)
from evo_tpu_torch.parallel.mesh import (CHANNEL, channel_block, has_cp,
                                         tp_size)
from evo_tpu_torch.quant import project, row_block


class HyenaState(NamedTuple):
    fir: torch.Tensor   # (B, 3, C, K-1)
    iir: torch.Tensor   # (B, C, S, 2) float32


class HyenaMixer(nn.Module):
    def __init__(self, cfg: ModelConfig, *, dtype: torch.dtype,
                 device: torch.device, mesh=None):
        super().__init__()
        D = cfg.hidden_size
        C = D // tp_size(mesh)
        K, S = cfg.short_filter_length, cfg.state_size
        self.act_quant = cfg.act_quant == 'int8'
        self.mesh = mesh

        def param(make, *shape, dt=dtype):
            return nn.Parameter(make(shape, dtype=dt, device=device),
                                requires_grad=False)

        self.w_in = param(torch.empty, D, 3, C)
        self.fir_w = param(torch.empty, 3, C, K)
        self.poles = param(torch.empty, C, S, 2, dt=torch.float32)
        self.residues = param(torch.empty, C, S, 2, dt=torch.float32)
        self.d_skip = param(torch.ones, C)
        self.w_out = param(torch.empty, C, D)
        self.b_in = param(torch.zeros, 3, C) if cfg.hyena_proj_bias \
            else None
        self.fir_b = param(torch.zeros, 3, C) if cfg.short_filter_bias \
            else None
        self.b_out = param(torch.zeros, D) if cfg.hyena_out_proj_bias \
            else None
        self.lora, self.lora_scale = {}, 1.0


class _Core(NamedTuple):
    """The tensors of the core between the projections, over this rank's
    channels."""
    fir_w: torch.Tensor
    fir_b: Optional[torch.Tensor]
    b_in: Optional[torch.Tensor]
    poles: torch.Tensor
    residues: torch.Tensor
    d_skip: torch.Tensor


def _core(p: HyenaMixer, dtype: torch.dtype) -> _Core:
    """The core's tensors over the channels this rank mixes: the tp shard,
    or under cp its block (contiguous copies, for the kernels). `b_in`
    comes in the activation type `dtype`, as the JAX package rounds it
    before the FIR; the taps, FIR bias and d_skip keep their own type,
    which the kernels and the plain versions read as stored."""
    b_in = None if p.b_in is None else p.b_in.to(dtype)
    start, n = channel_block(p.mesh, p.d_skip.shape[0])
    if n == p.d_skip.shape[0]:
        return _Core(p.fir_w, p.fir_b, b_in, p.poles, p.residues, p.d_skip)

    def cut(t, axis):
        return None if t is None else t.narrow(axis, start, n).contiguous()
    return _Core(cut(p.fir_w, 1), cut(p.fir_b, 1), cut(b_in, 1),
                 cut(p.poles, 0), cut(p.residues, 0), cut(p.d_skip, 0))


def _out_proj(p: HyenaMixer, y: torch.Tensor) -> torch.Tensor:
    o = reduce_from_tp(add_lora(p, 'w_out', y, project(
        y, p.w_out, 1, p.act_quant)), p.mesh)
    return o if p.b_out is None else o + p.b_out.to(o.dtype)


def _out_proj_block(p: HyenaMixer, y: torch.Tensor, start: int, n: int
                    ) -> torch.Tensor:
    """The decode step's out-projection under cp: y (B, 1, n) holds
    channels [start, start + n) of the tp shard; the partial products of
    the matching rows of w_out are summed over tp and cp in float32."""
    w = row_block(p.w_out, start, n, CHANNEL)
    o = all_reduce_sum(project(y, w, 1, p.act_quant), p.mesh, CHANNEL)
    return o if p.b_out is None else o + p.b_out.to(o.dtype)


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
               state: Optional[HyenaState] = None,
               seq_len: Optional[int] = None):
    """Full-sequence mixer: x (B, L, D) -> (y (B, L, D), HyenaState after
    position L-1, or None unless `collect_state`). With `state`, x is a
    segment that continues the sequence the state was collected from: the
    FIR reads the carried tail before t=0 and the long conv starts from
    the carried modal state, both exactly.

    Under `cfg.hyena_fused_mixer` and the matmul backend the fused kernel
    takes every shape it supports, fresh or continued, with L >=
    short_filter_length (a shorter one would return a truncated FIR
    state); the choice is made from the flags and the shape alone.
    Otherwise the FIR + gate kernel runs when L >= short_filter_length,
    and a shorter sequence takes `fir_causal_conv`, as in the JAX
    package; the long conv follows `cfg.hyena_conv_backend`.

    Under cp, x holds this rank's rows of a sequence padded to a multiple
    of cp, whose first `seq_len` positions are real: the core runs on
    those alone (the state is the one after position seq_len - 1), and
    the padded rows enter the out-projection as zeros."""
    K = cfg.short_filter_length
    chunk = cfg.hyena_matmul_chunk
    x = copy_to_tp(x, p.mesh)
    zl = add_lora(p, 'w_in', x,
                  project(x, p.w_in, 1, p.act_quant))   # (B, L, 3, C)
    # under cp: the whole sequence of this rank's channel block
    zl = seq_to_heads(zl, p.mesh, 3)
    padded = zl.shape[1]
    if seq_len is not None and seq_len < padded:
        zl = zl[:, :seq_len].contiguous()
    L = zl.shape[1]
    w = _core(p, zl.dtype)
    B, C = zl.shape[0], zl.shape[-1]
    if (cfg.hyena_fused_mixer and cfg.hyena_conv_backend == 'matmul'
            and L >= K
            and hyena_mixer_supported((B, 3, C, L), chunk, cfg.state_size,
                                      K)):
        # the kernel reads zl where the product left it, adds b_in and
        # writes y as the (B, L, C) tensor the out-projection reads
        y, iir, fir_state = hyena_mixer(
            zl.permute(0, 2, 3, 1), w.fir_w, w.fir_b, w.poles, w.residues,
            w.d_skip, chunk=chunk,
            state=None if state is None else (state.fir, state.iir),
            b_in=w.b_in)
        out = _out_proj(p, _to_rows(p, y.transpose(1, 2), padded))
        if not collect_state:
            return out, None
        return out, HyenaState(fir=fir_state.contiguous(), iir=iir)
    tail = None if state is None else state.fir.contiguous()
    if L >= K:
        # the kernel reads zl where the product left it and adds b_in
        x2, u = fir_gate(zl.permute(0, 2, 3, 1), w.fir_w, w.fir_b, tail,
                         b_in=w.b_in)
        fir_state = (_streams(zl[:, L - (K - 1):], w.b_in)
                     if collect_state else None)
    else:
        zf, fir_state = fftconv.fir_causal_conv(_streams(zl, w.b_in),
                                                w.fir_w, w.fir_b, tail)
        x2, u = zf[:, 0], zf[:, 1] * zf[:, 2]
    if cfg.hyena_conv_backend == 'fft':
        y, iir = _fft_long_conv(cfg, w, u, state, collect_state)
    else:
        y, iir = _matmul_long_conv(cfg, w, u, state)
    y = x2 * y.to(x.dtype)
    out = _out_proj(p, _to_rows(p, y.transpose(1, 2), padded))
    if not collect_state:
        return out, None
    # a copy of the FIR tail, so the streams themselves are freed here
    return out, HyenaState(fir=fir_state.contiguous(), iir=iir)


def _matmul_long_conv(cfg: ModelConfig, w: _Core, u: torch.Tensor,
                      state: Optional[HyenaState]):
    """The matmul backend's long conv of u (B, C, L): (y including the
    d_skip term, float32, the state at L)."""
    chunk = cfg.hyena_matmul_chunk
    L = u.shape[-1]
    iir = None if state is None else state.iir
    prefix = cfg.hyena_pallas_prefix
    if state is not None and L > chunk and L % chunk:
        # a continued conv needs chunk | L: the aligned prefix runs
        # chunked, then the remainder (shorter than a chunk) from the
        # state in between
        split = (L // chunk) * chunk
        y1, iir = fftconv.conv_matmul_chunked(
            u[..., :split], w.poles, w.residues, chunk, state=iir,
            d_skip=w.d_skip, pallas_prefix=prefix)
        y2, iir = fftconv.conv_matmul_chunked(
            u[..., split:], w.poles, w.residues, chunk, state=iir,
            d_skip=w.d_skip, pallas_prefix=prefix)
        return torch.cat([y1, y2], dim=-1), iir
    return fftconv.conv_matmul_chunked(
        u, w.poles, w.residues, chunk, state=iir, d_skip=w.d_skip,
        pallas_prefix=prefix)


def _fft_long_conv(cfg: ModelConfig, w: _Core, u: torch.Tensor,
                   state: Optional[HyenaState], collect_state: bool):
    """The FFT backend's long conv of u (B, C, L), as the JAX layer
    branches (`evo_tpu/layers/hyena.py:215-253`): a continued segment runs
    the chunked conv from the carried state, in chunks of hyena_fft_chunk
    where L is a longer multiple of it, else as one chunk of L; a fresh L
    longer than hyena_fft_chunk (> 0) runs it chunked from zeros (left
    padded); anything else is one FFT with the materialized filter, after
    which the state for decode is scanned in chunks of
    state_prefill_chunk. Returns (y + d_skip u in float32, the state at L
    or None). Each layer builds its filter here and frees it on return, so
    no filter outlives its layer (the JAX package ties it to the
    activations with an optimization_barrier so that XLA cannot hoist all
    29 layers' filters to the start of the program; eager code has no such
    hoisting)."""
    fc = cfg.hyena_fft_chunk
    L = u.shape[-1]
    chunked = bool(fc) and L > fc
    if state is not None:
        y, iir = fftconv.fft_causal_conv_chunked(
            u, w.poles, w.residues, fc if chunked and L % fc == 0 else L,
            state=state.iir)
    elif chunked:
        y, iir = fftconv.fft_causal_conv_chunked(u, w.poles, w.residues, fc)
    else:
        h = fftconv.materialize_filter(w.poles, w.residues, L)
        y = fftconv.fft_causal_conv(u, h)
        del h
        iir = (fftconv.modal_prefill_state(u, w.poles,
                                           cfg.state_prefill_chunk)
               if collect_state else None)
    return y + w.d_skip.float()[None, :, None] * u.float(), iir


def _to_rows(p: HyenaMixer, y: torch.Tensor, padded: int) -> torch.Tensor:
    """y (B, L, C') -> the out-projection's input: itself, or under cp the
    rows of this rank (every channel of the tp shard) by the reverse
    all-to-all, after zeros for the padded positions past L."""
    if not has_cp(p.mesh):
        return y
    if y.shape[1] < padded:
        y = torch.nn.functional.pad(y, (0, 0, 0, padded - y.shape[1]))
    return heads_to_seq(y, p.mesh, 2)


def hyena_step(p: HyenaMixer, cfg: ModelConfig, x_t: torch.Tensor,
               state: HyenaState):
    """Single-token decode step: x_t (B, 1, D) -> (y (B, 1, D), state).
    Under cp, x_t is whole on every rank, and the rank keeps its block of
    channels of the in-projection's output (and the state of that block);
    the out-projection's partial products are summed over tp and cp."""
    refuse_in_decode(p)
    z_t = project(x_t[:, 0], p.w_in, 1, p.act_quant)   # (B, 3, C)
    start, n = channel_block(p.mesh, z_t.shape[-1])
    w = _core(p, z_t.dtype)
    z_t = z_t.narrow(-1, start, n)
    if w.b_in is not None:
        z_t = z_t + w.b_in
    z_t, fir = fftconv.fir_step(z_t, w.fir_w, w.fir_b, state.fir)
    u = z_t[:, 1] * z_t[:, 2]
    y, iir = fftconv.modal_step(u, w.poles, w.residues, w.d_skip, state.iir)
    y = (z_t[:, 0] * y.to(x_t.dtype))[:, None]
    out = (_out_proj_block(p, y, start, n) if has_cp(p.mesh)
           else _out_proj(p, y))
    return out, HyenaState(fir=fir, iir=iir)
