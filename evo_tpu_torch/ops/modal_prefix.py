"""Decayed prefix over the chunks of the long conv: the CUDA kernel
(`csrc/modal_prefix.cu`) and its plain version.

Port of `evo_tpu/ops/pallas_prefix.py:modal_prefix_pallas`. For per-chunk
injected complex states inj[k], the decay a = p^chunk and an optional
carried state s0 (zeros when absent),

    incl[k] = a^(k+1) s0 + sum_{j<=k} a^(k-j) inj[j]
    ent[k]  = incl[k-1]   (ent[0] = s0: the state entering chunk k)
    fin     = incl[K-1]

The plain version is the Hillis-Steele doubling loop of the JAX
`conv_matmul_chunked`, with a carried state's a^k s0 terms added after it
by that function's formula; the kernel walks the chunks in segments, seeded
by s0. Both define the same sums and round them in different orders.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from evo_tpu_torch.ops import _build
from evo_tpu_torch.ops._grad import refuse

Prefix = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


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


def modal_prefix_supported(shape) -> bool:
    """shape = (B, D, K, S) of the injected states. One chunk has no
    prefix to take."""
    return shape[2] >= 2


def modal_prefix_plain(inj_r: torch.Tensor, inj_i: torch.Tensor,
                       logmag: torch.Tensor, theta: torch.Tensor,
                       chunk: int, s0: Optional[torch.Tensor] = None
                       ) -> Prefix:
    """inj_r, inj_i: (B, D, K, S) float32; logmag, theta: (D, S) pole logs;
    the decay base is p^chunk; s0: (B, D, S, 2) float32 (re, im) carried
    state or None. Returns (ent_r, ent_i (B, D, K, S), fin_r, fin_i
    (B, D, S))."""
    B, D, K, S = inj_r.shape
    sr, si = inj_r, inj_i
    step = 1
    while step < K:
        ar, ai = _pole_pow_tables(logmag, theta, float(chunk * step))
        ar, ai = ar[None, :, None, :], ai[None, :, None, :]    # (1, D, 1, S)
        z = sr.new_zeros(B, D, step, S)
        sr_sh = torch.cat([z, sr[:, :, :-step]], dim=2)
        si_sh = torch.cat([z, si[:, :, :-step]], dim=2)
        sr, si = sr + ar * sr_sh - ai * si_sh, si + ar * si_sh + ai * sr_sh
        step *= 2
    z1 = sr.new_zeros(B, D, 1, S)
    br, bi = (torch.cat([z1, sr[:, :, :-1]], dim=2),
              torch.cat([z1, si[:, :, :-1]], dim=2))
    fr, fi = sr[:, :, -1], si[:, :, -1]
    if s0 is None:
        return br, bi, fr, fi
    # the carried state's terms, a^k s0 for k = 0..K, as the JAX
    # `conv_matmul_chunked` adds them
    s0r, s0i = s0[..., 0], s0[..., 1]
    ak_r, ak_i = _pole_pow_range(chunk * logmag, chunk * theta, K + 1)
    ak_r = ak_r.movedim(-1, 1)[None]                          # (1, D, K+1, S)
    ak_i = ak_i.movedim(-1, 1)[None]
    br = br + ak_r[:, :, :K] * s0r[:, :, None] - \
        ak_i[:, :, :K] * s0i[:, :, None]
    bi = bi + ak_r[:, :, :K] * s0i[:, :, None] + \
        ak_i[:, :, :K] * s0r[:, :, None]
    fr = ak_r[:, :, K] * s0r - ak_i[:, :, K] * s0i + fr
    fi = ak_r[:, :, K] * s0i + ak_i[:, :, K] * s0r + fi
    return br, bi, fr, fi


def modal_prefix(inj_r: torch.Tensor, inj_i: torch.Tensor,
                 logmag: torch.Tensor, theta: torch.Tensor,
                 chunk: int, s0: Optional[torch.Tensor] = None) -> Prefix:
    """The prefix of `modal_prefix_plain`. CUDA tensors launch the kernel
    (or raise on what it does not take), which computes p^chunk itself and
    reads the (B, D, K, S) arrays in any layout whose last two axes are
    dense (as the injection einsum leaves them), so the wrapper launches
    nothing else; CPU tensors take the plain version."""
    if not _build.check_device(inj_r, 'modal_prefix'):
        return modal_prefix_plain(inj_r, inj_i, logmag, theta, chunk, s0)
    refuse('modal_prefix', inj_r, inj_i, logmag, theta, s0)
    if inj_r.dim() != 4 or inj_i.shape != inj_r.shape:
        raise ValueError('modal_prefix: inj_r and inj_i must be one '
                         f'(B, D, K, S) shape, got {tuple(inj_r.shape)} and '
                         f'{tuple(inj_i.shape)}')
    B, D, K, S = inj_r.shape
    if logmag.shape != (D, S) or theta.shape != (D, S):
        raise ValueError(f'modal_prefix: pole logs must be ({D}, {S}), got '
                         f'{tuple(logmag.shape)} and {tuple(theta.shape)}')
    if s0 is not None and s0.shape != (B, D, S, 2):
        raise ValueError(f'modal_prefix: the carried state must be ({B}, '
                         f'{D}, {S}, 2), got {tuple(s0.shape)}')
    if S > 32 and (S % 4 or S > 128):
        raise ValueError(f'modal_prefix kernel takes at most 32 states, or '
                         f'128 in fours, got {S}')
    dev = inj_r.device
    for t in (inj_i, logmag, theta, s0):
        if t is not None and t.device != dev:
            raise ValueError('modal_prefix kernel needs its inputs on one '
                             'device')
    if not (inj_r.dtype == inj_i.dtype == logmag.dtype == theta.dtype
            == (torch.float32 if s0 is None else s0.dtype) == torch.float32):
        raise TypeError('modal_prefix kernel takes float32')
    stride = inj_r.stride()
    if not (stride[2:] == (S, 1) and inj_i.stride() == stride
            and min(stride) >= 0):
        inj_r, inj_i = inj_r.contiguous(), inj_i.contiguous()
        stride = inj_r.stride()
    sb, sd = stride[:2]
    logmag, theta = logmag.contiguous(), theta.contiguous()
    # ent_r and ent_i in the layout of inj, then fin_r and fin_i, in one
    # allocation (the host's time counts around a short kernel)
    extent = 1 + sum((n - 1) * st for n, st in zip(inj_r.shape, stride))
    nfin = B * D * S
    buf = torch.empty(2 * extent + 2 * nfin, dtype=torch.float32, device=dev)
    ent_r = buf.as_strided(inj_r.shape, stride)
    ent_i = buf.as_strided(inj_r.shape, stride, extent)
    fin_r = buf.as_strided((B, D, S), (D * S, S, 1), 2 * extent)
    fin_i = buf.as_strided((B, D, S), (D * S, S, 1), 2 * extent + nfin)
    if s0 is not None:
        s0 = s0.contiguous()
    if fin_r.numel() and K:
        _build.launch('evo_modal_prefix_f32', 'modal_prefix',
                      inj_r.data_ptr(), inj_i.data_ptr(), logmag.data_ptr(),
                      theta.data_ptr(),
                      None if s0 is None else s0.data_ptr(),
                      ent_r.data_ptr(), ent_i.data_ptr(), fin_r.data_ptr(),
                      fin_i.data_ptr(), B, D, K, S, sb, sd, float(chunk))
    return ent_r, ent_i, fin_r, fin_i
