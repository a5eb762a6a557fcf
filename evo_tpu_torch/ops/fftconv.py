"""Hyena convolution primitives (port of `evo_tpu/ops/fftconv.py`).

Modal parametrization, as in the JAX package:

  filter    h[d, t] = Re( sum_s R[d,s] * p[d,s]^t )
  output    y[d, t] = sum_{tau<=t} h[d, t-tau] * u[d, tau] + D[d] * u[d, t]
  state     s[d,k](t) = p[d,k] * s[d,k](t-1) + u[d, t]        (complex)

Poles and residues are float32 (D, S, 2) real/imag pairs. The long conv
has two backends, as there: `conv_matmul_chunked` (chunked Toeplitz
products, the default) and the FFT one (`materialize_filter` +
`fft_causal_conv`, or `fft_causal_conv_chunked` with the modal state
carried between chunks, and `modal_prefill_state` to hand a monolithic
FFT's state to decode). Both are plain tensor code: the JAX package runs
its FFT through XLA, outside any Pallas kernel, so the port calls
`torch.fft` (cuFFT on the card). Every float32 product here needs full
float32, as the JAX package pins `Precision.HIGHEST` inside its conv, so
each of these functions runs at the 'highest' float32 matmul precision
whatever the global setting (`runtime.configure(highest_matmul_precision=
False)` lowers it for every other product), and restores that setting.
Under autograd each runs inside `PinnedFunction`, whose backward
recomputes the function and takes its gradient under the same pin:
autograd's backward products run after the forward has left the pinned
region, where they would otherwise take the global setting.
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


class PinnedFunction(torch.autograd.Function):
    """`body(*tensors)` with its gradient to each tensor, recomputed from
    the saved inputs at the pinned precision by `recompute`, a function
    equal to body (the same body, or one that takes plain routes where
    body launches a kernel without a backward)."""

    @staticmethod
    def forward(ctx, body, recompute, *tensors):
        ctx.recompute = recompute
        ctx.save_for_backward(*tensors)
        ctx.set_materialize_grads(False)
        return body(*tensors)

    @staticmethod
    @full_float32
    def backward(ctx, *grads):
        return (None, None, *plain_vjp(ctx.recompute, ctx.saved_tensors,
                                       ctx.needs_input_grad[2:], grads))


def _pinned(body, *tensors, recompute=None):
    """body(*tensors), for a caller that runs pinned: inside
    `PinnedFunction` when one of the tensors requires grad, so that the
    backward is pinned too."""
    if needs_grad(*tensors):
        return PinnedFunction.apply(body, recompute or body, *tensors)
    return body(*tensors)


def _pole_log(poles: torch.Tensor):
    """(log|p|, arg p) as float32 (D, S)."""
    pr, pi = poles[..., 0], poles[..., 1]
    mag = torch.sqrt(pr * pr + pi * pi)
    return torch.log(torch.clamp(mag, min=_MIN_MAG)), torch.atan2(pi, pr)


def _conv_chunk_tables(poles, residues, C: int):
    """Per-layer tables of the chunked convs from one power range:
    h_local (D, C) first C taps; pw (D, S, C) injection weights p^(C-1-j);
    tab (D, S, C) state decay R p^(t+1); pc (D, S) chunk decay p^C."""
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
    return (h_local, pw_r, pw_i, tab_r, tab_i, dec_r[..., -1],
            dec_i[..., -1])


@full_float32
def materialize_filter(poles: torch.Tensor, residues: torch.Tensor,
                       length: int, block: int = 128) -> torch.Tensor:
    """h[d, t] = Re(sum_s R p^t) for t in [0, length), (D, length) float32,
    from factored power tables (`fftconv.py:45`): with t = q*block + r,
    R p^t = (R p^(q*block)) p^r, so only D*S*(L/block + block) powers are
    transcendental, and one contraction over the S modes remains."""
    return _pinned(lambda p, r: _materialize_filter(p, r, length, block),
                   poles, residues)


def _materialize_filter(poles, residues, length, block):
    D, S, _ = poles.shape
    logmag, theta = _pole_log(poles.float())
    rr = residues[..., 0].float()
    ri = residues[..., 1].float()
    C = min(block, length)
    Q = -(-length // C)
    dev = poles.device
    r = torch.arange(C, dtype=torch.float32, device=dev)[None, None, :]
    q = torch.arange(Q, dtype=torch.float32, device=dev)[None, None, :] * C
    sm = torch.exp(r * logmag[..., None])                     # p^r
    s_re = sm * torch.cos(r * theta[..., None])               # (D, S, C)
    s_im = sm * torch.sin(r * theta[..., None])
    bm = torch.exp(q * logmag[..., None])                     # R p^(qC)
    ang = q * theta[..., None]
    cos_a, sin_a = torch.cos(ang), torch.sin(ang)
    b_re = bm * (rr[..., None] * cos_a - ri[..., None] * sin_a)  # (D, S, Q)
    b_im = bm * (rr[..., None] * sin_a + ri[..., None] * cos_a)
    h = (torch.einsum('dsq,dsc->dqc', b_re, s_re)
         - torch.einsum('dsq,dsc->dqc', b_im, s_im))
    return h.reshape(D, Q * C)[:, :length]


def materialize_filter_direct(poles: torch.Tensor, residues: torch.Tensor,
                              length: int) -> torch.Tensor:
    """The naive per-t filter, |R| |p|^t cos(t arg p + arg R) summed over
    the modes (the oracle of the tests)."""
    D, S, _ = poles.shape
    logmag, theta = _pole_log(poles.float())
    rr, ri = residues[..., 0].float(), residues[..., 1].float()
    rmag = torch.sqrt(rr * rr + ri * ri)
    rphase = torch.atan2(ri, rr)
    t = torch.arange(length, dtype=torch.float32,
                     device=poles.device)[None, :]
    h = torch.zeros((D, length), dtype=torch.float32, device=poles.device)
    for s in range(S):
        h = h + rmag[:, s:s + 1] * torch.exp(t * logmag[:, s:s + 1]) * \
            torch.cos(t * theta[:, s:s + 1] + rphase[:, s:s + 1])
    return h


def _fft_conv(u, h):
    """The body of `fft_causal_conv`, for callers that pin already."""
    L = u.shape[-1]
    n = max(2, 1 << (2 * L - 1).bit_length())     # next power of 2 >= 2L
    u_f = torch.fft.rfft(u.float(), n=n, dim=-1)
    h_f = torch.fft.rfft(h.float(), n=n, dim=-1)
    return torch.fft.irfft(u_f * h_f, n=n, dim=-1)[..., :L]


@full_float32
def fft_causal_conv(u: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Causal convolution along the last axis by real FFT (`fftconv.py:
    102`): u (B, D, L) of any float type, h (D, L) float32 -> (B, D, L)
    float32, y[b, d, t] = sum_{tau<=t} h[d, t-tau] u[b, d, tau]. The FFT
    length is the next power of two >= 2L (a linear, not a circular,
    conv), in float32 whatever the input type. There is no mesh argument:
    the conv is depthwise, so a rank convolves its own channels."""
    return _pinned(_fft_conv, u, h)


@full_float32
def fft_causal_conv_chunked(u: torch.Tensor, poles: torch.Tensor,
                            residues: torch.Tensor, chunk: int,
                            state: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked causal conv with the modal filter, O(L chunk) memory
    (`fftconv.py:141`). Within a chunk of length C the output is a local
    FFT conv with the first C taps, plus the incoming state decayed through
    the chunk:

        y_i[t]  = (h[0:C] * u_i)[t] + Re( sum_s R_s p_s^(t+1) state_{i-1,s} )
        state_i = p^C state_{i-1} + sum_j p^(C-1-j) u_i[j]

    u (B, D, L); poles/residues (D, S, 2) float32; state (B, D, S, 2)
    float32 entering the sequence (None = zeros). Returns (y (B, D, L)
    float32 without the skip term, the state at position L). A fresh L is
    LEFT-padded to a multiple of the chunk: leading zeros convolve to zero
    and inject nothing, so the returned state is the one at L (right
    padding would decay it past L). A continued L must be a multiple
    already: the JAX ValueError otherwise."""
    L = u.shape[-1]
    C = min(chunk, L)
    if state is not None and (-L) % C:
        raise ValueError(
            'segment continuation (state != None) requires L to be a '
            f'multiple of chunk (L={L}, chunk={C}): left-padding would '
            'mis-align the incoming state decay')
    return _pinned(lambda *a: _fft_chunked(*a, C), u, poles, residues,
                   state)


def _fft_chunked(u, poles, residues, state, C):
    B, D, L = u.shape
    S = poles.shape[1]
    pad = (-L) % C
    u32 = u.float()
    if pad:
        u32 = torch.cat([u32.new_zeros(B, D, pad), u32], dim=-1)
    h_local, pw_r, pw_i, tab_r, tab_i, pc_r, pc_i = _conv_chunk_tables(
        poles, residues, C)
    if state is None:
        sr = si = u32.new_zeros(B, D, S)
    else:
        sr, si = state[..., 0], state[..., 1]
    ys = []
    for uc in u32.split(C, dim=-1):
        y_local = _fft_conv(uc, h_local)
        y_state = (torch.einsum('bds,dsc->bdc', sr, tab_r)
                   - torch.einsum('bds,dsc->bdc', si, tab_i))
        inj_r = torch.einsum('bdc,dsc->bds', uc, pw_r)
        inj_i = torch.einsum('bdc,dsc->bds', uc, pw_i)
        sr, si = (pc_r[None] * sr - pc_i[None] * si + inj_r,
                  pc_i[None] * sr + pc_r[None] * si + inj_i)
        ys.append(y_local + y_state)
    y = torch.cat(ys, dim=-1)[..., pad:]
    return y, torch.stack([sr, si], dim=-1)


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

    When an argument requires grad, the conv runs inside `PinnedFunction`:
    its backward is this function's gradient, taken at the same pinned
    precision, through the plain prefix (the prefix kernel computes the
    same function and has no backward).
    """
    def conv(prefix):
        return lambda u, p, r, s, d: _conv_chunked(u, p, r, chunk, s, d,
                                                   prefix)
    return _pinned(conv(pallas_prefix), u, poles, residues, state, d_skip,
                   recompute=conv(False))


def _conv_chunked(u, poles, residues, chunk, state, d_skip, pallas_prefix):
    """The body of `conv_matmul_chunked`."""
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
    h_local, pw_r, pw_i, tab_r, tab_i, _, _ = _conv_chunk_tables(
        poles, residues, C)
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


def direct_causal_conv(u: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """O(L^2) oracle of the tests, the contract of `fft_causal_conv`:
    y[t] = sum_k h[k] u[t-k], in float32."""
    L = u.shape[-1]
    u32, h32 = u.float(), h.float()
    cols = [torch.sum(h32[..., :t + 1].flip(-1) * u32[..., :t + 1], dim=-1)
            for t in range(L)]
    return torch.stack(cols, dim=-1)


def modal_state_init(batch: int, channels: int, state_size: int,
                     device=None) -> torch.Tensor:
    """The zero modal state, (B, D, S, 2) float32 (real, imag)."""
    return torch.zeros((batch, channels, state_size, 2),
                       dtype=torch.float32, device=device)


@full_float32
def modal_prefill_state(u: torch.Tensor, poles: torch.Tensor,
                        chunk: int = 128) -> torch.Tensor:
    """The modal state after u[..., 0:L], so decode can continue at L
    (`fftconv.py:517`): u (B, D, L), poles (D, S, 2) float32 -> (B, D, S, 2)
    float32 with s[d, k] = sum_tau p[d, k]^(L-1-tau) u[d, tau]. A scan over
    chunks of C samples, s <- p^C s + sum_j p^(C-1-j) u_j, which keeps the
    power tables at (D, S, C); L is left-padded to a multiple of C
    (leading zeros leave the state as it is)."""
    return _pinned(lambda a, p: _prefill_state(a, p, chunk), u, poles)


def _prefill_state(u, poles, chunk):
    B, D, L = u.shape
    S = poles.shape[1]
    C = min(chunk, L)
    pad = (-L) % C
    u32 = u.float()
    if pad:
        u32 = torch.cat([u32.new_zeros(B, D, pad), u32], dim=-1)
    logmag, theta = _pole_log(poles.float())
    rng_r, rng_i = _pole_pow_range(logmag, theta, C)
    pw_r, pw_i = rng_r.flip(-1), rng_i.flip(-1)            # p^(C-1-j)
    p1m = torch.exp(logmag)
    p1r, p1i = p1m * torch.cos(theta), p1m * torch.sin(theta)
    pc_r = p1r * rng_r[..., -1] - p1i * rng_i[..., -1]     # p * p^(C-1)
    pc_i = p1r * rng_i[..., -1] + p1i * rng_r[..., -1]
    sr = si = u32.new_zeros(B, D, S)
    for uc in u32.split(C, dim=-1):
        inj_r = torch.einsum('bdc,dsc->bds', uc, pw_r)
        inj_i = torch.einsum('bdc,dsc->bds', uc, pw_i)
        sr, si = (pc_r[None] * sr - pc_i[None] * si + inj_r,
                  pc_i[None] * sr + pc_r[None] * si + inj_i)
    return torch.stack([sr, si], dim=-1)
