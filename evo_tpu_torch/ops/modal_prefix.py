"""Decayed prefix over the chunks of the long conv: the CUDA kernel
(`csrc/modal_prefix.cu`) and its plain version.

Port of `evo_tpu/ops/pallas_prefix.py:modal_prefix_pallas`. For per-chunk
injected complex states inj[k] and the decay a = p^chunk,

    incl[k] = sum_{j<=k} a^(k-j) inj[j]
    ent[k]  = incl[k-1]   (zero-seeded: the state entering chunk k)
    fin     = incl[K-1]

The plain version is the Hillis-Steele doubling loop of the JAX
`conv_matmul_chunked` (log2 K shifted passes); the kernel walks the chunks
in order. Both define the same sums and round them in different orders.
A carried state of a resumed segment is not an input here: its a^k s0
terms are added by the caller (`ops/fftconv.py`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from evo_tpu_torch.ops import _build

Prefix = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _pole_pow_tables(logmag, theta, e: float):
    """Re/Im of p^e for one scalar exponent e, (D, S) each."""
    mag = torch.exp(e * logmag)
    return mag * torch.cos(e * theta), mag * torch.sin(e * theta)


def modal_prefix_supported(shape) -> bool:
    """shape = (B, D, K, S) of the injected states. One chunk has no
    prefix to take."""
    return shape[2] >= 2


def modal_prefix_plain(inj_r: torch.Tensor, inj_i: torch.Tensor,
                       logmag: torch.Tensor, theta: torch.Tensor,
                       chunk: int) -> Prefix:
    """inj_r, inj_i: (B, D, K, S) float32; logmag, theta: (D, S) pole logs;
    the decay base is p^chunk. Returns (ent_r, ent_i (B, D, K, S),
    fin_r, fin_i (B, D, S))."""
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
    return (torch.cat([z1, sr[:, :, :-1]], dim=2),
            torch.cat([z1, si[:, :, :-1]], dim=2), sr[:, :, -1], si[:, :, -1])


def modal_prefix(inj_r: torch.Tensor, inj_i: torch.Tensor,
                 logmag: torch.Tensor, theta: torch.Tensor,
                 chunk: int) -> Prefix:
    """The prefix of `modal_prefix_plain`. CUDA tensors launch the kernel
    (or raise on what it does not take); CPU tensors take the plain
    version."""
    if not _build.check_device(inj_r, 'modal_prefix'):
        return modal_prefix_plain(inj_r, inj_i, logmag, theta, chunk)
    if inj_r.dim() != 4 or inj_i.shape != inj_r.shape:
        raise ValueError('modal_prefix: inj_r and inj_i must be one '
                         f'(B, D, K, S) shape, got {tuple(inj_r.shape)} and '
                         f'{tuple(inj_i.shape)}')
    B, D, K, S = inj_r.shape
    if logmag.shape != (D, S) or theta.shape != (D, S):
        raise ValueError(f'modal_prefix: pole logs must be ({D}, {S}), got '
                         f'{tuple(logmag.shape)} and {tuple(theta.shape)}')
    for t in (inj_r, inj_i, logmag, theta):
        if t.dtype != torch.float32:
            raise TypeError(f'modal_prefix kernel takes float32, got '
                            f'{t.dtype}')
        if t.device != inj_r.device:
            raise ValueError('modal_prefix kernel needs its inputs on one '
                             'device')
    inj_r, inj_i = inj_r.contiguous(), inj_i.contiguous()
    a_r, a_i = _pole_pow_tables(logmag, theta, float(chunk))
    a_r, a_i = a_r.contiguous(), a_i.contiguous()
    ent_r, ent_i = torch.empty_like(inj_r), torch.empty_like(inj_i)
    fin_r = torch.empty((B, D, S), dtype=torch.float32, device=inj_r.device)
    fin_i = torch.empty_like(fin_r)
    if fin_r.numel():
        _build.launch('evo_modal_prefix_f32', 'modal_prefix',
                      inj_r.data_ptr(), inj_i.data_ptr(), a_r.data_ptr(),
                      a_i.data_ptr(), ent_r.data_ptr(), ent_i.data_ptr(),
                      fin_r.data_ptr(), fin_i.data_ptr(), B, D, K, S)
    return ent_r, ent_i, fin_r, fin_i
