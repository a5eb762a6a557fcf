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

Under autograd both run inside `RingAttentionFunction`, whose backward is
written by hand (the JAX package transposes its ring, each ppermute into
the reverse one; the port's forward writes its running sums in place and
skips the future blocks, which autograd could not differentiate alike on
every rank). The forward saves q, k, v, the float32 output and each row's
log-sum-exp. The backward forms D = rowsum(dO * O), then goes around the
ring again with the forward's schedule and row blocks, recomputing P =
exp(S scale - lse) and adding dV += P^T dO, dS = P * (dO V^T - D), dQ +=
dS K scale, dK += dS^T Q scale. Each K/V block travels with its dK / dV
sums, which after R hops are home. Every rank posts every exchange,
whatever it computes, in the forward and in the backward. The zigzag
regroup's adjoint is the reverse regroup (`_Regroup`). All of it is
plain PyTorch in float32 (float64 for float64 inputs), as the JAX
package's ring is plain jnp.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from evo_tpu_torch.ops._grad import needs_grad
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
    float32 (or float64), v_blk (B, Lk, H, Dh). Returns the new (m, l,
    acc)."""
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1)
    acc_new = acc * alpha[..., None] + torch.einsum(
        'bhlm,bmhd->bhld', p, v_blk.to(acc.dtype))
    return m_new, l_new, acc_new


def _stats(B: int, H: int, L: int, Dh: int, like: torch.Tensor) -> State:
    return (torch.full((B, H, L), -math.inf, dtype=like.dtype,
                       device=like.device),
            torch.zeros((B, H, L), dtype=like.dtype, device=like.device),
            torch.zeros((B, H, L, Dh), dtype=like.dtype, device=like.device))


def _rows(B: int, H: int, Lk: int) -> int:
    return max(1, SCORE_BYTES // (4 * B * H * max(1, Lk)))


def _scores(q: torch.Tensor, k: torch.Tensor, a: int, b: int,
            causal: bool) -> torch.Tensor:
    """Scaled scores of q's rows [a, b) over the keys k (B, Lk, H, Dh), as
    (B, H, b - a, Lk); `causal`: key j only for rows i >= j (the diagonal
    block, whose rows and keys start at the same position)."""
    s = torch.einsum('blhd,bmhd->bhlm', q[:, a:b], k) * (
        1.0 / math.sqrt(q.shape[-1]))
    if causal:
        rows = torch.arange(a, b, device=s.device)[:, None]
        cols = torch.arange(k.shape[1], device=s.device)[None, :]
        s = s.masked_fill(cols > rows, _NEG)
    return s


def _accumulate(st: State, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, causal: bool) -> None:
    """Update st (m, l, acc of q's rows, in q's type) in place with the
    keys k and values v (B, Lk, H, Dh), in row blocks."""
    m, l, acc = st
    B, Lq, H, _ = q.shape
    k, v = k.to(q.dtype), v.to(q.dtype)
    step = _rows(B, H, k.shape[1])
    for a in range(0, Lq, step):
        b = min(Lq, a + step)
        m[..., a:b], l[..., a:b], acc[..., a:b, :] = _online_update(
            m[..., a:b], l[..., a:b], acc[..., a:b, :],
            _scores(q, k, a, b, causal), v)


def _accumulate_grads(q, k, v, go, lse, D, dq, dk, dv, causal: bool
                      ) -> None:
    """Add the gradients of one (query chunk, key chunk) pair in place: q,
    dq (B, Lq, H, Dh); k, v, dk, dv (B, Lk, H, Dh); go, the output's
    gradient (B, H, Lq, Dh); lse and D (B, H, Lq). Row blocks as the
    forward's."""
    B, Lq, H, Dh = q.shape
    k, v = k.to(q.dtype), v.to(q.dtype)
    scale = 1.0 / math.sqrt(Dh)
    step = _rows(B, H, k.shape[1])
    for a in range(0, Lq, step):
        b = min(Lq, a + step)
        p = torch.exp(_scores(q, k, a, b, causal) - lse[..., a:b, None])
        g = go[:, :, a:b]
        dv += torch.einsum('bhlm,bhld->bmhd', p, g)
        ds = p * (torch.einsum('bhld,bmhd->bhlm', g, v) - D[..., a:b, None])
        dq[:, a:b] += torch.einsum('bhlm,bmhd->blhd', ds, k) * scale
        dk += torch.einsum('bhlm,blhd->bmhd', ds, q[:, a:b]) * scale


def _pass_on(t: torch.Tensor, mesh):
    """Post t's exchange around the ring: to cp rank r + 1, from r - 1."""
    R, r = mesh.cp, mesh.index('cp')
    return cp_exchange([((r + 1) % R, t)], [((r - 1) % R, t)], mesh)


def _pairs(t: int, R: int, r: int, zigzag: bool):
    """(query chunk, key chunk, causal) of ring step t, in the order they
    are added. Without zigzag a rank holds one chunk and the block of
    owner j = r - t adds where j <= r; with zigzag two, (r, 2R-1-r), and
    every step adds the same work."""
    j = (r - t) % R                               # the owner of the K/V
    if not zigzag:
        return [(0, 0, j == r)] if j <= r else []
    if t == 0:
        # the diagonal step: both own chunks causal, and the late queries
        # over the early keys
        return [(0, 0, True), (1, 1, True), (1, 0, False)]
    return [(1, 0, False), (0, 0, False) if j < r else (1, 1, False)]


def _chunks(x: torch.Tensor, n: int):
    return x.split(x.shape[1] // n, dim=1)


def _ring_forward(q, k, v, mesh, zigzag: bool):
    """The ring's forward on this rank's chunks q, k, v (B, Lb, H, Dh):
    (output in q's type, output (B, H, Lb, Dh) and row log-sum-exp (B, H,
    Lb) in the float type of the sums)."""
    R, r = mesh.cp, mesh.index('cp')
    n = 2 if zigzag else 1
    B, Lb, H, Dh = q.shape
    q32 = q.to(torch.promote_types(q.dtype, torch.float32))
    qs = _chunks(q32, n)
    st = [_stats(B, H, Lb // n, Dh, q32) for _ in range(n)]
    kv = torch.stack([k, v])
    for t in range(R):
        pending = _pass_on(kv, mesh) if t + 1 < R else None
        ks, vs = _chunks(kv[0], n), _chunks(kv[1], n)
        for qi, ki, causal in _pairs(t, R, r, zigzag):
            _accumulate(st[qi], qs[qi], ks[ki], vs[ki], causal)
        if pending is not None:
            kv = pending.wait()[0]
    out = torch.cat([acc / l.clamp(min=1e-30)[..., None]
                     for _, l, acc in st], dim=2)
    lse = torch.cat([m + torch.log(l) for m, l, _ in st], dim=2)
    return out.transpose(1, 2).to(q.dtype), out, lse


class RingAttentionFunction(torch.autograd.Function):
    """The ring (or, with `zigzag`, the zigzag ring's core over the chunk
    pairs) with the hand-written backward of the module docstring."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, zigzag):
        out, out32, lse = _ring_forward(q, k, v, mesh, zigzag)
        ctx.mesh, ctx.zigzag = mesh, zigzag
        ctx.save_for_backward(q, k, v, out32, lse)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        mesh, zigzag = ctx.mesh, ctx.zigzag
        R, r = mesh.cp, mesh.index('cp')
        n = 2 if zigzag else 1
        q32 = q.to(out.dtype)
        go = grad_out.to(out.dtype).transpose(1, 2)       # (B, H, Lb, Dh)
        D = (go * out).sum(dim=-1)
        dq = torch.zeros_like(q32)
        qs, dqs = _chunks(q32, n), _chunks(dq, n)
        gos, lses, Ds = (x.split(x.shape[2] // n, dim=2)
                         for x in (go, lse, D))
        kv = torch.stack([k, v])
        dkv = torch.zeros(kv.shape, dtype=out.dtype, device=kv.device)
        for t in range(R):
            pending = _pass_on(kv, mesh) if t + 1 < R else None
            ks, vs = _chunks(kv[0], n), _chunks(kv[1], n)
            dks, dvs = _chunks(dkv[0], n), _chunks(dkv[1], n)
            for qi, ki, causal in _pairs(t, R, r, zigzag):
                _accumulate_grads(qs[qi], ks[ki], vs[ki], gos[qi], lses[qi],
                                  Ds[qi], dqs[qi], dks[ki], dvs[ki], causal)
            # the sums travel with their K/V: R hops bring them home
            dkv = _pass_on(dkv, mesh).wait()[0]
            if pending is not None:
                kv = pending.wait()[0]
        return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype), \
            None, None


def _ring(q, k, v, mesh, zigzag: bool) -> torch.Tensor:
    if needs_grad(q, k, v):
        return RingAttentionFunction.apply(q, k, v, mesh, zigzag)
    return _ring_forward(q, k, v, mesh, zigzag)[0]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   seq_len: int) -> torch.Tensor:
    """Causal attention of the sequence of `seq_len` positions whose
    contiguous block cp_i this rank holds: q, k, v (B, L/cp, H, Dh) ->
    (B, L/cp, H, Dh). The JAX package's ValueError where cp does not divide
    seq_len."""
    check_ring_length(seq_len, mesh.cp, zigzag=False)
    return _ring(q, k, v, mesh, zigzag=False)


def _zigzag_owner(c: int, R: int) -> int:
    return c if c < R else 2 * R - 1 - c


def _regroup_blocks(x: torch.Tensor, mesh, to_zigzag: bool) -> torch.Tensor:
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


class _Regroup(torch.autograd.Function):
    """A permutation of chunks between ranks; its adjoint is the reverse
    regroup."""

    @staticmethod
    def forward(ctx, x, mesh, to_zigzag):
        ctx.mesh, ctx.to_zigzag = mesh, to_zigzag
        return _regroup_blocks(x, mesh, to_zigzag)

    @staticmethod
    def backward(ctx, g):
        return _regroup_blocks(g, ctx.mesh, not ctx.to_zigzag), None, None


def _regroup(x: torch.Tensor, mesh, to_zigzag: bool) -> torch.Tensor:
    if needs_grad(x):
        return _Regroup.apply(x, mesh, to_zigzag)
    return _regroup_blocks(x, mesh, to_zigzag)


def zigzag_ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mesh, seq_len: int) -> torch.Tensor:
    """`ring_attention` over balanced chunk pairs: the same result, with
    every rank doing the same causal work. The JAX package's ValueError
    where 2 cp does not divide seq_len."""
    check_ring_length(seq_len, mesh.cp, zigzag=True)
    qkv = _regroup(torch.stack([q, k, v]), mesh, to_zigzag=True)
    out = _ring(qkv[0], qkv[1], qkv[2], mesh, zigzag=True)
    return _regroup(out, mesh, to_zigzag=False)
