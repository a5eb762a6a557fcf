"""Megatron's two tensor-parallel operators, and the few other collectives
of the port's mesh paths.

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

Gloo takes CUDA tensors for `all_reduce`, `broadcast` and `barrier` only;
the gathers here go through CPU copies under gloo and stay on the card
under NCCL.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from evo_tpu_torch.parallel.mesh import Mesh


def _active(mesh: Optional[Mesh], axis: str) -> bool:
    return mesh is not None and mesh.shape[axis] > 1


def all_reduce_sum(x: torch.Tensor, mesh: Optional[Mesh],
                   axis: str = 'tp') -> torch.Tensor:
    """Sum over `axis` in float32, rounded once to x's type."""
    if not _active(mesh, axis):
        return x
    import torch.distributed as dist
    acc = x.to(torch.promote_types(x.dtype, torch.float32), copy=True)
    dist.all_reduce(acc, group=mesh.group(axis))
    return acc.to(x.dtype)


def all_reduce_max(x: torch.Tensor, mesh: Optional[Mesh],
                   axis: str = 'tp') -> torch.Tensor:
    """Element-wise max over `axis` (a copy; exact in any type)."""
    if not _active(mesh, axis):
        return x
    import torch.distributed as dist
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=mesh.group(axis))
    return out


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
    src = x.contiguous()
    if mesh.backend != 'nccl':
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=mesh.group(axis))
    return [p.to(x.device) for p in parts]


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
