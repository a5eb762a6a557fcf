"""Ring attention: causal attention with the sequence split over the cp
axis of the mesh, K/V blocks passed around the cp group (port of
`evo_tpu/ops/ring_attention.py`).

Each rank keeps its block of queries and accumulates their attention over
the K/V blocks as they pass, in a float32 online softmax (running max,
denominator and accumulator), as the JAX package's dense core does: it
runs no Pallas kernel there, and this is plain PyTorch here. The next
block's exchange (`collectives.cp_exchange`, one `batch_isend_irecv`) is
posted before the current block is computed. A block wholly in the
future of the queries adds nothing and is skipped (the JAX core computes
it, masked: the same sums). The queries go in row blocks, so that one
float32 score block stays near `SCORE_BYTES`.

`zigzag_ring_attention` gives rank r the chunk pair (r, 2R-1-r) of the
sequence in 2R chunks, so that every rank does the same causal work; the
residual stream stays in contiguous order, and the chunks move to and
from the pairs by one exchange each way.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from evo_tpu_torch.parallel.collectives import cp_exchange

_NEG = -1e30
# bytes of one float32 score block (B, H, rows, keys)
SCORE_BYTES = 256 * 2 ** 20

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def check_ring_length(L: int, ring_size: int, zigzag: bool) -> None:
    """The JAX package's ValueError for a length the ring (twice the ring
    for zigzag) does not divide."""
    if zigzag and L % (2 * ring_size):
        raise ValueError(f'zigzag needs L ({L}) divisible by '
                         f'2*ring_size ({2 * ring_size})')
    if not zigzag and L % ring_size:
        raise ValueError(f'sequence length {L} not divisible by ring size '
                         f'{ring_size}')


def zigzag_indices(L: int, ring_size: int):
    """(perm, inv): contiguous -> zigzag sequence order and its inverse.
    Zigzag order concatenates, for each rank r, chunks r and 2R-1-r of the
    2R-chunk split."""
    Lc = L // (2 * ring_size)
    order = []
    for r in range(ring_size):
        order += [r, 2 * ring_size - 1 - r]
    perm = np.concatenate([np.arange(c * Lc, (c + 1) * Lc) for c in order])
    return perm, np.argsort(perm)


def _online_update(m, l, acc, s, v_blk):
    """One score block's flash-style online-softmax step: s (B, H, Lq, Lk)
    float32, v_blk (B, Lk, H, Dh). Returns the new (m, l, acc)."""
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1)
    acc_new = acc * alpha[..., None] + torch.einsum(
        'bhlm,bmhd->bhld', p, v_blk.float())
    return m_new, l_new, acc_new


def _stats(B: int, H: int, L: int, Dh: int, device) -> State:
    return (torch.full((B, H, L), -math.inf, device=device),
            torch.zeros((B, H, L), device=device),
            torch.zeros((B, H, L, Dh), device=device))


def _rows(B: int, H: int, Lk: int) -> int:
    return max(1, SCORE_BYTES // (4 * B * H * max(1, Lk)))


def _accumulate(st: State, q32: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, causal: bool) -> None:
    """Update st (m, l, acc of q32's rows) in place with the keys k and
    values v (B, Lk, H, Dh), in row blocks; `causal`: key j only for rows
    i >= j (the diagonal block)."""
    m, l, acc = st
    B, Lq, H, Dh = q32.shape
    k32 = k.float()
    scale = 1.0 / math.sqrt(Dh)
    step = _rows(B, H, k.shape[1])
    for a in range(0, Lq, step):
        b = min(Lq, a + step)
        s = torch.einsum('blhd,bmhd->bhlm', q32[:, a:b], k32) * scale
        if causal:
            rows = torch.arange(a, b, device=s.device)[:, None]
            cols = torch.arange(k.shape[1], device=s.device)[None, :]
            s = s.masked_fill(cols > rows, _NEG)
        m[..., a:b], l[..., a:b], acc[..., a:b, :] = _online_update(
            m[..., a:b], l[..., a:b], acc[..., a:b, :], s, v)


def _finish(st: State, dtype) -> torch.Tensor:
    m, l, acc = st
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.transpose(1, 2).to(dtype)          # (B, L, H, Dh)


def _pass_on(kv: torch.Tensor, mesh):
    """Post kv's exchange around the ring: to cp rank r + 1, from r - 1."""
    R, r = mesh.cp, mesh.index('cp')
    return cp_exchange([((r + 1) % R, kv)], [((r - 1) % R, kv)], mesh)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   seq_len: int) -> torch.Tensor:
    """Causal attention of the sequence of `seq_len` positions whose
    contiguous block cp_i this rank holds: q, k, v (B, L/cp, H, Dh) ->
    (B, L/cp, H, Dh). The JAX package's ValueError where cp does not divide
    seq_len."""
    R, r = mesh.cp, mesh.index('cp')
    check_ring_length(seq_len, R, zigzag=False)
    B, Lb, H, Dh = q.shape
    q32 = q.float()
    st = _stats(B, H, Lb, Dh, q.device)
    kv = torch.stack([k, v])
    for t in range(R):
        pending = _pass_on(kv, mesh) if t + 1 < R else None
        j = (r - t) % R                          # the owner of kv
        if j <= r:
            _accumulate(st, q32, kv[0], kv[1], causal=j == r)
        if pending is not None:
            kv = pending.wait()[0]
    return _finish(st, q.dtype)


def _zigzag_owner(c: int, R: int) -> int:
    return c if c < R else 2 * R - 1 - c


def _regroup(x: torch.Tensor, mesh, to_zigzag: bool) -> torch.Tensor:
    """x (..., B, 2 Lh, ...) on axis -4 of (B, L, H, Dh): this rank's two
    chunks of the 2R-chunk split, contiguous (2r, 2r+1) <-> zigzag
    (r, 2R-1-r), by one exchange. Both sides order each pair's messages by
    chunk index."""
    R, r = mesh.cp, mesh.index('cp')
    Lh = x.shape[-3] // 2
    mine = ([2 * r, 2 * r + 1] if to_zigzag else [r, 2 * R - 1 - r])
    want = ([r, 2 * R - 1 - r] if to_zigzag else [2 * r, 2 * r + 1])
    dest = ((lambda c: _zigzag_owner(c, R)) if to_zigzag
            else (lambda c: c // 2))
    src = ((lambda c: c // 2) if to_zigzag
           else (lambda c: _zigzag_owner(c, R)))
    halves = dict(zip(mine, x.split(Lh, dim=-3)))
    sends = [(dest(c), halves[c]) for c in mine if dest(c) != r]
    need = [c for c in want if src(c) != r]
    got = dict(zip(need, cp_exchange(
        sends, [(src(c), halves[mine[0]]) for c in need], mesh).wait()))
    return torch.cat([got[c] if c in got else halves[c] for c in want],
                     dim=-3)


def zigzag_ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mesh, seq_len: int) -> torch.Tensor:
    """`ring_attention` over balanced chunk pairs: the same result, with
    every rank doing the same causal work. The JAX package's ValueError
    where 2 cp does not divide seq_len."""
    R, r = mesh.cp, mesh.index('cp')
    check_ring_length(seq_len, R, zigzag=True)
    qkv = _regroup(torch.stack([q, k, v]), mesh, to_zigzag=True)
    B, L2, H, Dh = q.shape
    Lc = L2 // 2
    q0, q1 = qkv[0, :, :Lc].float(), qkv[0, :, Lc:].float()
    st0, st1 = (_stats(B, H, Lc, Dh, q.device) for _ in range(2))
    kv = qkv[1:]
    for t in range(R):
        pending = _pass_on(kv, mesh) if t + 1 < R else None
        k0, k1 = kv[0, :, :Lc], kv[0, :, Lc:]
        v0, v1 = kv[1, :, :Lc], kv[1, :, Lc:]
        if t == 0:
            # the diagonal step: both own chunks causal, and the late
            # queries over the early keys
            _accumulate(st0, q0, k0, v0, causal=True)
            _accumulate(st1, q1, k1, v1, causal=True)
            _accumulate(st1, q1, k0, v0, causal=False)
        else:
            j = (r - t) % R                      # the owner of kv
            _accumulate(st1, q1, k0, v0, causal=False)
            if j < r:
                _accumulate(st0, q0, k0, v0, causal=False)
            else:
                _accumulate(st1, q1, k1, v1, causal=False)
        if pending is not None:
            kv = pending.wait()[0]
    out = torch.cat([_finish(st0, q.dtype), _finish(st1, q.dtype)], dim=1)
    return _regroup(out, mesh, to_zigzag=False)

