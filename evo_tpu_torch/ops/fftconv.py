"""Hyena convolution primitives (port of `evo_tpu/ops/fftconv.py`).

Modal parametrization, as in the JAX package:

  filter    h[d, t] = Re( sum_s R[d,s] * p[d,s]^t )
  output    y[d, t] = sum_{tau<=t} h[d, t-tau] * u[d, tau] + D[d] * u[d, t]
  state     s[d,k](t) = p[d,k] * s[d,k](t-1) + u[d, t]        (complex)

Poles and residues are float32 (D, S, 2) real/imag pairs. The long conv is
plain tensor code (einsums on float32); every float32 product here needs
full float32, so `torch.backends.cuda.matmul.allow_tf32` must stay False
(its default), as the JAX package runs these at `Precision.HIGH`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_MIN_MAG = 1e-20


def _pole_log(poles: torch.Tensor):
    """(log|p|, arg p) as float32 (D, S)."""
    pr, pi = poles[..., 0], poles[..., 1]
    mag = torch.sqrt(pr * pr + pi * pi)
    return torch.log(torch.clamp(mag, min=_MIN_MAG)), torch.atan2(pi, pr)


def _pole_pow_tables(logmag, theta, e: float):
    """Re/Im of p^e for one scalar exponent e, (D, S) each."""
    mag = torch.exp(e * logmag)
    return mag * torch.cos(e * theta), mag * torch.sin(e * theta)


def _pole_pow_range(logmag, theta, n: int):
    """{p^0 .. p^(n-1)} re/im as (D, S, n) float32 by log-doubling: only
    the powers p^(2^j) are transcendental, each further entry is one
    complex product of exact lower powers."""
    rng_r = torch.ones_like(logmag)[..., None]
    rng_i = torch.zeros_like(logmag)[..., None]
    m = 1
    while m < n:
        k = min(m, n - m)
        ar, ai = _pole_pow_tables(logmag, theta, float(m))
        ar, ai = ar[..., None], ai[..., None]
        new_r = ar * rng_r[..., :k] - ai * rng_i[..., :k]
        new_i = ar * rng_i[..., :k] + ai * rng_r[..., :k]
        rng_r = torch.cat([rng_r, new_r], dim=-1)
        rng_i = torch.cat([rng_i, new_i], dim=-1)
        m += k
    return rng_r, rng_i


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


def conv_matmul_chunked(u: torch.Tensor, poles: torch.Tensor,
                        residues: torch.Tensor, chunk: int = 128,
                        state: Optional[torch.Tensor] = None,
                        d_skip: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked causal long conv as matmuls (`fftconv.py:310`).

    u: (B, D, L); poles/residues (D, S, 2) float32; state (B, D, S, 2)
    float32 entering the sequence (None = zeros); d_skip (D,) folded onto
    the Toeplitz diagonal. Returns (y (B, D, L) float32 including the skip
    term when d_skip is given, modal state (B, D, S, 2) at position L).

    Within a chunk: y_i = T @ u_i with the (C, C) Toeplitz of the first C
    taps. Across chunks: per-chunk injected modal states, a Hillis-Steele
    weighted prefix over the K chunks, decayed into each chunk. L is
    left-padded to a multiple of the chunk (leading zeros neither change
    the outputs nor inject state).
    """
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

    # inclusive prefix over chunks: s_k = sum_{j<=k} a^(k-j) inj_j, a = p^C
    sr, si = inj_r, inj_i
    step = 1
    while step < K:
        ar, ai = _pole_pow_tables(logmag, theta, float(C * step))
        ar, ai = ar[None, :, None, :], ai[None, :, None, :]    # (1, D, 1, S)
        z = sr.new_zeros(B, D, step, S)
        sr_sh = torch.cat([z, sr[:, :, :-step]], dim=2)
        si_sh = torch.cat([z, si[:, :, :-step]], dim=2)
        sr, si = sr + ar * sr_sh - ai * si_sh, si + ar * si_sh + ai * sr_sh
        step *= 2
    # state entering chunk k: a^k s0 + incl_{k-1}
    z1 = sr.new_zeros(B, D, 1, S)
    br = torch.cat([z1, sr[:, :, :-1]], dim=2)
    bi = torch.cat([z1, si[:, :, :-1]], dim=2)
    if state is not None:
        s0r, s0i = state[..., 0], state[..., 1]
        ak_r, ak_i = _pole_pow_range(C * logmag, C * theta, K + 1)
        ak_r = ak_r.movedim(-1, 1)[None]                      # (1, D, K+1, S)
        ak_i = ak_i.movedim(-1, 1)[None]
        br = br + ak_r[:, :, :K] * s0r[:, :, None] - \
            ak_i[:, :, :K] * s0i[:, :, None]
        bi = bi + ak_r[:, :, :K] * s0i[:, :, None] + \
            ak_i[:, :, :K] * s0r[:, :, None]
        fr = ak_r[:, :, K] * s0r - ak_i[:, :, K] * s0i + sr[:, :, -1]
        fi = ak_r[:, :, K] * s0i + ak_i[:, :, K] * s0r + si[:, :, -1]
    else:
        fr, fi = sr[:, :, -1], si[:, :, -1]

    y_state = (torch.einsum('bdks,dsc->bdkc', br, tab_r)
               - torch.einsum('bdks,dsc->bdkc', bi, tab_i))
    y = (y_local + y_state).reshape(B, D, L + pad)[..., pad:]
    return y, torch.stack([fr, fi], dim=-1)


def fir_causal_conv(z: torch.Tensor, w: torch.Tensor,
                    b: Optional[torch.Tensor],
                    state: Optional[torch.Tensor] = None):
    """Depthwise causal FIR, taps [oldest .. newest]:
    y[c, t] = sum_j w[c, j] * z[c, t - (K-1-j)] (+ b[c]).

    z: (B, *C, L); w: (*C, K); state: (B, *C, K-1) trailing inputs of a
    previous segment (None = zeros). Sums in float32 in tap order, then
    bias; returns (y in z.dtype, the last K-1 inputs)."""
    L = z.shape[-1]
    K = w.shape[-1]
    if state is None:
        state = z.new_zeros(z.shape[:-1] + (K - 1,))
    zc = torch.cat([state.to(z.dtype), z], dim=-1)
    y = torch.zeros(z.shape, dtype=torch.float32, device=z.device)
    for j in range(K):
        y = y + w[None, ..., j, None].float() * zc[..., j:j + L].float()
    if b is not None:
        y = y + b[None, ..., None].float()
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
