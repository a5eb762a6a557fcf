"""Hyena convolution primitives (port of `evo_tpu/ops/fftconv.py`).

Modal parametrization, as in the JAX package:

  filter    h[d, t] = Re( sum_s R[d,s] * p[d,s]^t )
  output    y[d, t] = sum_{tau<=t} h[d, t-tau] * u[d, tau] + D[d] * u[d, t]
  state     s[d,k](t) = p[d,k] * s[d,k](t-1) + u[d, t]        (complex)

Poles and residues are float32 (D, S, 2) real/imag pairs. The long conv is
plain tensor code (einsums on float32); every float32 product here needs
full float32, as the JAX package pins `Precision.HIGHEST` inside its conv.
So `conv_matmul_chunked` runs at the 'highest' float32 matmul precision
whatever the global setting (`runtime.configure(highest_matmul_precision=
False)` lowers it for every other product), and restores that setting.
Under autograd it runs inside `PinnedConvFunction`, whose backward
recomputes the conv and takes its gradient under the same pin: autograd's
backward products run after the forward has left the pinned region, where
they would otherwise take the global setting.
"""

from __future__ import annotations

import functools
import threading
from typing import Optional, Tuple

import torch

from evo_tpu_torch.ops import modal_prefix as prefix_ops
from evo_tpu_torch.ops._grad import needs_grad, plain_vjp
from evo_tpu_torch.ops.modal_prefix import _pole_pow_range

_MIN_MAG = 1e-20


def _pole_log(poles: torch.Tensor):
    """(log|p|, arg p) as float32 (D, S)."""
    pr, pi = poles[..., 0], poles[..., 1]
    mag = torch.sqrt(pr * pr + pi * pi)
    return torch.log(torch.clamp(mag, min=_MIN_MAG)), torch.atan2(pi, pr)


def _conv_chunk_tables(poles, residues, C: int):
    """Per-layer tables of the chunked conv from one power range:
    h_local (D, C) first C taps; pw (D, S, C) injection weights p^(C-1-j);
    tab (D, S, C) state decay R p^(t+1)."""
    logmag, theta = _pole_log(poles.float())
    rr = residues[..., 0].float()
    ri = residues[..., 1].float()
    rng_r, rng_i = _pole_pow_range(logmag, theta, C)
    h_local = torch.sum(rr[..., None] * rng_r - ri[..., None] * rng_i, dim=1)
    pw_r, pw_i = rng_r.flip(-1), rng_i.flip(-1)
    p1m = torch.exp(logmag)
    p1r = (p1m * torch.cos(theta))[..., None]
    p1i = (p1m * torch.sin(theta))[..., None]
    dec_r = p1r * rng_r - p1i * rng_i                       # p^(t+1)
    dec_i = p1r * rng_i + p1i * rng_r
    tab_r = rr[..., None] * dec_r - ri[..., None] * dec_i
    tab_i = rr[..., None] * dec_i + ri[..., None] * dec_r
    return h_local, pw_r, pw_i, tab_r, tab_i


def _toeplitz_from_taps(h_local: torch.Tensor, C: int,
                        d_skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(D, C, C) lower-triangular causal Toeplitz of the first C taps,
    toep[d, t, c] = h[d, t-c] for t >= c, plus d_skip[d] on the diagonal.
    Built by indexing the taps (index C reads an appended zero column)."""
    t = torch.arange(C, device=h_local.device)
    diff = t[:, None] - t[None, :]
    idx = torch.where(diff >= 0, diff, torch.full_like(diff, C))
    h_pad = torch.cat([h_local, h_local.new_zeros(h_local.shape[0], 1)], -1)
    toep = h_pad[:, idx]
    if d_skip is not None:
        toep = toep + torch.diag_embed(
            d_skip.float()[:, None].expand(-1, C))
    return toep


_PIN_LOCK = threading.Lock()
_PIN = {'depth': 0, 'saved': None}


def full_float32(fn):
    """Run fn at the 'highest' float32 matmul precision (no TF32 on the
    card, no reduced precision in oneDNN on the CPU), and restore the
    caller's setting after it.

    The setting is process-wide. Calls that overlap, from any threads,
    share one pin: the first to enter saves the caller's setting and the
    last to leave restores it, so no conv restores it under another. A
    thread that sets the precision itself while a conv runs is not held
    off: it can still put that conv under TF32."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with _PIN_LOCK:
            if _PIN['depth'] == 0:
                _PIN['saved'] = torch.get_float32_matmul_precision()
                torch.set_float32_matmul_precision('highest')
            _PIN['depth'] += 1
        try:
            return fn(*args, **kwargs)
        finally:
            with _PIN_LOCK:
                _PIN['depth'] -= 1
                if _PIN['depth'] == 0:
                    torch.set_float32_matmul_precision(_PIN['saved'])
    return wrapped


@full_float32
def conv_matmul_chunked(u: torch.Tensor, poles: torch.Tensor,
                        residues: torch.Tensor, chunk: int = 128,
                        state: Optional[torch.Tensor] = None,
                        d_skip: Optional[torch.Tensor] = None,
                        pallas_prefix: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked causal long conv as matmuls (`fftconv.py:310`).

    u: (B, D, L); poles/residues (D, S, 2) float32; state (B, D, S, 2)
    float32 entering the sequence (None = zeros); d_skip (D,) folded onto
    the Toeplitz diagonal. Returns (y (B, D, L) float32 including the skip
    term when d_skip is given, modal state (B, D, S, 2) at position L).

    Within a chunk: y_i = T @ u_i with the (C, C) Toeplitz of the first C
    taps. Across chunks: per-chunk injected modal states, a weighted
    prefix over the K chunks (`ops/modal_prefix.py`: its kernel when
    `pallas_prefix` is set, the name of the JAX argument, else the plain
    Hillis-Steele loop), decayed into each chunk. A fresh
    L is left-padded to a multiple of the chunk (leading zeros neither
    change the outputs nor inject state); a continued one must be a
    multiple already, or shorter than a chunk (`layers/hyena.py` splits a
    ragged segment accordingly).

    When an argument requires grad, the conv runs inside
    `PinnedConvFunction`: its backward is this function's gradient, taken
    at the same pinned precision.
    """
    if needs_grad(u, poles, residues, state, d_skip):
        return PinnedConvFunction.apply(u, poles, residues, state, d_skip,
                                        chunk, pallas_prefix)
    return _conv_chunked(u, poles, residues, chunk, state, d_skip,
                         pallas_prefix)


def _conv_chunked(u, poles, residues, chunk, state, d_skip, pallas_prefix):
    """The body of `conv_matmul_chunked`; its callers pin the precision."""
    B, D, L = u.shape
    S = poles.shape[1]
    C = min(chunk, L)
    pad = (-L) % C
    if state is not None and pad:
        raise ValueError(
            'segment continuation (state != None) requires L to be a '
            f'multiple of chunk (L={L}, chunk={C})')
    u32 = u.float()
    if pad:
        u32 = torch.cat([u32.new_zeros(B, D, pad), u32], dim=-1)
    K = (L + pad) // C
    logmag, theta = _pole_log(poles.float())
    h_local, pw_r, pw_i, tab_r, tab_i = _conv_chunk_tables(poles, residues, C)
    toep = _toeplitz_from_taps(h_local, C, d_skip)             # (D, C, C)

    uc = u32.reshape(B, D, K, C)
    y_local = torch.einsum('dtc,bdkc->bdkt', toep, uc)
    inj_r = torch.einsum('bdkc,dsc->bdks', uc, pw_r)
    inj_i = torch.einsum('bdkc,dsc->bdks', uc, pw_i)

    # state entering chunk k: a^k s0 + incl_{k-1}, with the inclusive prefix
    # incl_k = sum_{j<=k} a^(k-j) inj_j over chunks, a = p^C; final state
    # a^K s0 + incl_{K-1}. The prefix is the kernel of `ops/modal_prefix.py`
    # under `pallas_prefix` (for K >= 2), seeded by the carried state, else
    # its plain doubling loop, which adds the state's terms after it.
    if pallas_prefix and prefix_ops.modal_prefix_supported((B, D, K, S)):
        br, bi, fr, fi = prefix_ops.modal_prefix(inj_r, inj_i, logmag, theta,
                                                 C, state)
    else:
        br, bi, fr, fi = prefix_ops.modal_prefix_plain(inj_r, inj_i, logmag,
                                                       theta, C, state)

    y_state = (torch.einsum('bdks,dsc->bdkc', br, tab_r)
               - torch.einsum('bdks,dsc->bdkc', bi, tab_i))
    y = (y_local + y_state).reshape(B, D, L + pad)[..., pad:]
    return y, torch.stack([fr, fi], dim=-1)


class PinnedConvFunction(torch.autograd.Function):
    """`conv_matmul_chunked` with its gradient to u, the poles, the
    residues, the entering state and d_skip, recomputed from the saved
    inputs at the pinned precision. The recompute takes the plain prefix:
    the prefix kernel computes the same function and has no backward."""

    @staticmethod
    def forward(ctx, u, poles, residues, state, d_skip, chunk,
                pallas_prefix):
        ctx.save_for_backward(u, poles, residues, state, d_skip)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return _conv_chunked(u, poles, residues, chunk, state, d_skip,
                             pallas_prefix)

    @staticmethod
    @full_float32
    def backward(ctx, gy, gstate):
        def conv(u, poles, residues, state, d_skip):
            return _conv_chunked(u, poles, residues, ctx.chunk, state,
                                 d_skip, False)
        grads = plain_vjp(conv, ctx.saved_tensors, ctx.needs_input_grad[:5],
                          (gy, gstate))
        return (*grads, None, None)


def fir_causal_conv(z: torch.Tensor, w: torch.Tensor,
                    b: Optional[torch.Tensor],
                    state: Optional[torch.Tensor] = None):
    """Depthwise causal FIR, taps [oldest .. newest]:
    y[c, t] = sum_j w[c, j] * z[c, t - (K-1-j)] (+ b[c]).

    z: (B, *C, L); w: (*C, K); state: (B, *C, K-1) trailing inputs of a
    previous segment (None = zeros). Sums in float32 (or wider, for a
    float64 z) in tap order, then bias; returns (y in z.dtype, the last K-1 inputs)."""
    L = z.shape[-1]
    K = w.shape[-1]
    if state is None:
        state = z.new_zeros(z.shape[:-1] + (K - 1,))
    zc = torch.cat([state.to(z.dtype), z], dim=-1)
    acc = torch.promote_types(z.dtype, torch.float32)
    y = torch.zeros(z.shape, dtype=acc, device=z.device)
    for j in range(K):
        y = y + w[None, ..., j, None].to(acc) * zc[..., j:j + L].to(acc)
    if b is not None:
        y = y + b[None, ..., None].to(acc)
    return y.to(z.dtype), zc[..., L:]


def fir_step(z_t: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
             state: torch.Tensor):
    """Single-token FIR step. z_t: (B, *C); state: (B, *C, K-1)."""
    zc = torch.cat([state, z_t[..., None]], dim=-1)
    y = torch.sum(zc.float() * w.float()[None], dim=-1)
    if b is not None:
        y = y + b.float()[None]
    return y.to(z_t.dtype), zc[..., 1:]


def modal_step(u_t: torch.Tensor, poles: torch.Tensor,
               residues: torch.Tensor, d_skip: torch.Tensor,
               state: torch.Tensor):
    """One decode step of the modal recurrence. u_t: (B, D); state
    (B, D, S, 2) float32. Returns (y_t (B, D) float32, new state)."""
    pr, pi = poles[..., 0], poles[..., 1]
    sr, si = state[..., 0], state[..., 1]
    u32 = u_t.float()
    nsr = pr[None] * sr - pi[None] * si + u32[..., None]
    nsi = pi[None] * sr + pr[None] * si
    rr, ri = residues[..., 0], residues[..., 1]
    y = torch.sum(rr[None] * nsr - ri[None] * nsi, dim=-1) + \
        d_skip.float()[None] * u32
    return y, torch.stack([nsr, nsi], dim=-1)
