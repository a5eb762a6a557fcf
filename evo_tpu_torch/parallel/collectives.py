"""Megatron's two tensor-parallel operators, the context-parallel
reshards, and the few other collectives of the port's mesh paths.

The JAX package states a layout and lets GSPMD insert the collectives; the
port inserts them by hand, around each rank's shard of a product:

  copy_to_tp      before a column-parallel product (w_in, wqkv, w1 / w2):
                  the identity forward; backward, the gradient of the
                  replicated input summed over tp (each rank only saw its
                  columns' share);
  reduce_from_tp  after a row-parallel product (w_out, wo, w3), before its
                  bias: the partial products summed over tp forward; the
                  identity backward.

The sums run in float32 and are rounded once to the activation type (a
bf16 all-reduce would round at every hop, and gloo does not promise to
reduce bf16 at all). Without a mesh, or at tp = 1, both return their
input and launch nothing.

Under context parallelism (cp > 1) the residual stream holds this cp
rank's rows of the sequence (`split_seq`, `gather_seq`), and the mixers
move between that layout and the whole sequence of a block of channels
or heads with one all-to-all over cp each way (`seq_to_heads`,
`heads_to_seq`); ring attention passes K/V blocks between cp neighbours
(`cp_exchange`). The decode step sums over tp and cp together
(`all_reduce_sum(x, mesh, CHANNEL)`). Each is a no-op at cp = 1.

Under autograd the cp collectives carry gradients, as JAX transposes its
collectives: the all-to-all's adjoint is the same all-to-all of the
gradient; `gather_seq`'s is a reduce-scatter (the gradient summed over
cp in float32, this rank's block kept), since the ranks that hold the
gathered sequence may each compute something else from it (the Ulysses
fallback keeps only its own rows); `split_seq` is a slice. Every rank
posts the same collectives in the backward in the same order, so no
gradient may be None on one rank and not on another.

Serving and LoRA add three: `broadcast_object` (a server's requests,
cancels and stops, from the first rank), `gather_rows_to_host` (a decode
chunk's tokens and log-probs over dp, with the chunk's one readback) and
`sum_grads` (gradients over tp, then cp, then dp).

Gloo takes CUDA tensors for `all_reduce`, `broadcast` and `barrier` only;
the gathers, all-to-alls and sends here go through CPU copies under gloo
and stay on the card under NCCL. They move bytes (a uint8 view of each
tensor), so any type passes either backend unchanged.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch

from evo_tpu_torch.parallel.mesh import Mesh

Axis = Union[str, Tuple[str, ...]]


def _active(mesh: Optional[Mesh], axis: Axis) -> bool:
    return mesh is not None and mesh.axis_size(axis) > 1


def all_reduce_sum(x: torch.Tensor, mesh: Optional[Mesh],
                   axis: Axis = 'tp') -> torch.Tensor:
    """Sum over `axis` (or a tuple of axes together) in float32, rounded
    once to x's type."""
    if not _active(mesh, axis):
        return x
    import torch.distributed as dist
    acc = x.to(torch.promote_types(x.dtype, torch.float32), copy=True)
    dist.all_reduce(acc, group=mesh.group(axis))
    return acc.to(x.dtype)


def _max_over(x: torch.Tensor, mesh: Mesh, axis: Axis) -> torch.Tensor:
    import torch.distributed as dist
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=mesh.group(axis))
    return out


class _AllReduceMax(torch.autograd.Function):
    """The max over `axis` with the max's own VJP: the gradient of the
    result, summed over the ranks that used it, goes to the rank that
    holds the maximum, split evenly among ranks that tie, as `amax`
    splits it among equal elements. (The int8 x int8 product's row
    scales under tp; JAX's max over the whole row transposes alike.)"""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        out = _max_over(x, mesh, axis)
        ctx.mesh, ctx.axis = mesh, axis
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        holds = (x == out).to(g.dtype)
        total = all_reduce_sum(g, ctx.mesh, ctx.axis)
        ties = all_reduce_sum(holds, ctx.mesh, ctx.axis)
        return total * holds / ties, None, None


def all_reduce_max(x: torch.Tensor, mesh: Optional[Mesh],
                   axis: Axis = 'tp') -> torch.Tensor:
    """Element-wise max over `axis` (a copy; exact in any type), with a
    backward (`_AllReduceMax`) where x requires grad."""
    if not _active(mesh, axis):
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllReduceMax.apply(x, mesh, axis)
    return _max_over(x, mesh, axis)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.mesh), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce_sum(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Identity forward, gradient summed over tp backward. Goes before a
    column-parallel product."""
    if not _active(mesh, 'tp'):
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _CopyToTP.apply(x, mesh)
    return x


def reduce_from_tp(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Partial products summed over tp forward (float32 sum, one rounding),
    identity backward. Goes after a row-parallel product, before its
    bias."""
    if not _active(mesh, 'tp'):
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromTP.apply(x, mesh)
    return all_reduce_sum(x, mesh)


def gather_cpu(x: torch.Tensor, mesh: Mesh, axis: str) -> List[torch.Tensor]:
    """Every rank's x along `axis`, in rank order, as tensors on x's
    device. Through CPU copies under gloo (whose all_gather refuses CUDA
    tensors); on the device under NCCL. All ranks pass the same shape."""
    import torch.distributed as dist
    n = mesh.shape[axis]
    if n == 1:
        return [x]
    wire = _wire(x, mesh)
    parts = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(parts, wire, group=mesh.group(axis))
    return [p.view(x.dtype).view(x.shape).to(x.device) for p in parts]


def dp_rows(n: int, mesh: Optional[Mesh]) -> int:
    """Rows a dp rank holds of an n-row batch: n split in dp equal parts,
    the last padded (by repeating the batch's last row) when dp does not
    divide n."""
    dp = 1 if mesh is None else mesh.dp
    return -(-n // dp)


def shard_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """This dp rank's rows of the batch x (B, ...): contiguous blocks of
    `dp_rows(B)` rows, the batch padded with copies of its last row."""
    if not _active(mesh, 'dp'):
        return x
    n = x.shape[0]
    per = dp_rows(n, mesh)
    pad = per * mesh.dp - n
    if pad:
        x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])], dim=0)
    i = mesh.index('dp')
    return x[i * per:(i + 1) * per]


def gather_rows(x: torch.Tensor, mesh: Optional[Mesh], n: int
                ) -> torch.Tensor:
    """Inverse of `shard_rows`: every dp rank's rows, in order, cut to the
    batch's n rows. Every rank gets the whole result."""
    if not _active(mesh, 'dp'):
        return x
    return torch.cat(gather_cpu(x, mesh, 'dp'), dim=0)[:n]


def gather_rows_to_host(x: torch.Tensor, mesh: Optional[Mesh], n: int
                        ) -> torch.Tensor:
    """`gather_rows` of x, on the host, with one device-to-host copy: under
    gloo the rank's rows are copied out and gathered there, under NCCL
    gathered on the device and copied out."""
    if mesh is None or mesh.backend == 'nccl':
        return gather_rows(x, mesh, n).cpu()
    return gather_rows(x.cpu(), mesh, n)


def broadcast_object(obj):
    """A small picklable host object from global rank 0, on every rank of
    the process group (a server's mesh is the whole world). The others'
    `obj` is ignored."""
    import torch.distributed as dist
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def sum_grads(tensors: Sequence[torch.Tensor], mesh: Optional[Mesh]
              ) -> None:
    """Replace each tensor's `.grad` by its sum over tp, then cp, then dp
    (float32, in place), through one flat buffer an axis (the adapters of
    `lora.py`: small; the full train step sums its masters per tensor)."""
    live = [a for a in ('tp', 'cp', 'dp') if _active(mesh, a)]
    if not live:
        return
    grads = [t.grad for t in tensors]
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    for axis in live:
        flat = all_reduce_sum(flat, mesh, axis)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


# ---------------------------------------------------------------------------
# Context parallelism
# ---------------------------------------------------------------------------

def _wire(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """t's bytes as a contiguous uint8 tensor where the backend takes it:
    on the host under gloo, on t's device under NCCL."""
    t = t.contiguous()
    if mesh.backend != 'nccl':
        t = t.cpu()
    return t.view(torch.uint8) if t.dim() else t.reshape(1).view(torch.uint8)


def exchange_blocks(x: torch.Tensor, mesh: Mesh, axis: str = 'cp'
                    ) -> torch.Tensor:
    """The all-to-all itself, with no autograd history: x (n, ...), block
    j to the axis's rank j; returns (n, ...) whose block j came from rank
    j."""
    import torch.distributed as dist
    wire = _wire(x, mesh)
    out = torch.empty_like(wire)
    dist.all_to_all_single(out, wire, group=mesh.group(axis))
    return out.view(x.dtype).view(x.shape).to(x.device)


class _AllToAll(torch.autograd.Function):
    """A permutation of blocks between ranks: its adjoint sends each
    block's gradient back the way it came, which is the same all-to-all
    applied to the gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return exchange_blocks(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return exchange_blocks(g, ctx.mesh, ctx.axis), None, None


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str = 'cp'
               ) -> torch.Tensor:
    """x (n, ...), n the size of `axis`: block j goes to the axis's rank
    j. Returns (n, ...) on x's device whose block j came from rank j.
    Under autograd the gradient takes the same all-to-all back."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllToAll.apply(x, mesh, axis)
    return exchange_blocks(x, mesh, axis)


def split_seq(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """This cp rank's rows of x (B, L, ...): the contiguous block cp_i of
    cp along L (which cp must divide). A slice: autograd's own."""
    if not _active(mesh, 'cp'):
        return x
    n = x.shape[1] // mesh.cp
    return x[:, mesh.index('cp') * n:(mesh.index('cp') + 1) * n]


class _GatherSeq(torch.autograd.Function):
    """Every cp rank's rows on every rank; backward, a reduce-scatter: the
    gathered gradient summed over cp in float32 (each rank may have used
    the whole sequence for something of its own), this rank's block
    kept."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return torch.cat(gather_cpu(x, mesh, 'cp'), dim=1)

    @staticmethod
    def backward(ctx, g):
        return split_seq(all_reduce_sum(g, ctx.mesh, 'cp'), ctx.mesh), None


def gather_seq(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Inverse of `split_seq`: every cp rank's rows, in order, on every
    rank. Under autograd the gradient is summed over cp and split."""
    if not _active(mesh, 'cp'):
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherSeq.apply(x, mesh)
    return torch.cat(gather_cpu(x, mesh, 'cp'), dim=1)


def seq_to_heads(x: torch.Tensor, mesh: Optional[Mesh], axis: int
                 ) -> torch.Tensor:
    """(B, L/cp, ..., N, ...) rows of the sequence, every channel or head
    on axis `axis` -> (B, L, ..., N/cp, ...): the whole sequence of this
    rank's block cp_i of N. One all-to-all over cp. At B = 1 the received
    buffer already is the result; at B > 1 it takes one permuting copy."""
    if not _active(mesh, 'cp'):
        return x
    n = mesh.cp
    send = x.unflatten(axis, (n, x.shape[axis] // n)).movedim(axis, 0)
    recv = all_to_all(send, mesh)              # (n, B, L/cp, ..., N/cp, ...)
    return recv.movedim(0, 1).flatten(1, 2)


def heads_to_seq(y: torch.Tensor, mesh: Optional[Mesh], axis: int
                 ) -> torch.Tensor:
    """Inverse of `seq_to_heads`: (B, L, ..., N/cp, ...) -> (B, L/cp, ...,
    N, ...), this rank's rows with every cp rank's block in order."""
    if not _active(mesh, 'cp'):
        return y
    n = mesh.cp
    send = y.unflatten(1, (n, y.shape[1] // n)).movedim(1, 0)
    recv = all_to_all(send, mesh)              # (n, B, L/cp, ..., N/cp, ...)
    return recv.movedim(0, axis).flatten(axis, axis + 1)


def _cp_rank(mesh: Mesh, c: int) -> int:
    """The global rank of cp index c in this rank's cp group."""
    return mesh.rank + (c - mesh.index('cp')) * mesh.tp


class _Pending:
    """The sends and receives of a `cp_exchange` in flight (holding their
    buffers until they complete); `wait()` returns the receives on the
    device."""

    def __init__(self, reqs, sent, bufs, like):
        self.reqs, self.sent, self.bufs, self.like = reqs, sent, bufs, like

    def wait(self) -> List[torch.Tensor]:
        for req in self.reqs:
            req.wait()
        self.sent = None
        return [b.view(t.dtype).view(t.shape).to(t.device)
                for b, t in zip(self.bufs, self.like)]


def cp_exchange(sends: Sequence[Tuple[int, torch.Tensor]],
                recvs: Sequence[Tuple[int, torch.Tensor]], mesh: Mesh
                ) -> _Pending:
    """Point-to-point sends and receives within the cp group, posted in one
    `batch_isend_irecv` (so that no pair of ranks waits on the other).
    sends: (cp index, tensor); recvs: (cp index, a tensor of the shape
    and type to receive). Messages between a pair are matched in the
    order given, which both sides keep. Returns the pending receives."""
    import torch.distributed as dist
    group = mesh.group('cp')
    ops, sent, bufs = [], [_wire(t, mesh) for _, t in sends], []
    for (c, _), wire in zip(sends, sent):
        ops.append(dist.P2POp(dist.isend, wire, _cp_rank(mesh, c),
                              group=group))
    for c, t in recvs:
        buf = torch.empty(t.numel() * t.element_size(), dtype=torch.uint8,
                          device=t.device if mesh.backend == 'nccl'
                          else 'cpu')
        bufs.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf, _cp_rank(mesh, c),
                              group=group))
    reqs = dist.batch_isend_irecv(ops) if ops else []
    return _Pending(reqs, sent, bufs, [t for _, t in recvs])
