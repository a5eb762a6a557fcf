"""The process mesh (port of `evo_tpu/parallel/mesh.py`).

The JAX package drives every chip of a host from one process and lays a
`jax.sharding.Mesh` over them. The port runs one process per card, the
way `torchrun` launches it, so its mesh is a small object of its own over
`torch.distributed` ranks: the sizes of the axes, this rank's coordinate
on each, one process group per axis, and the device. `DeviceMesh` is not
used: the port's kernels take raw pointers of local tensors, so the
layers run Megatron tensor parallelism by hand on each rank's shards
(`collectives.py`).

Axes, outermost to innermost, as in the JAX package:

  dp  data parallel: each dp rank runs its rows of the batch;
  cp  context parallel (sequence sharding); sizes above 1 are not ported
      yet and raise;
  tp  tensor parallel: weights sharded Megatron-style. Innermost, so a tp
      group is contiguous ranks, which `torchrun` places on one host.

A rank's coordinates: rank = base + (dp_i * cp + cp_i) * tp + tp_i, where
base is the first rank of its replica (`local_mesh` splits the world into
several replicas of the same shape; `make_mesh` makes one).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import torch

AXES = ('dp', 'cp', 'tp')
CP_REFUSAL = ('context parallelism (cp > 1) is not ported yet (ROADMAP.md, '
              'modules queue: parallelism: context parallel)')


def plan_mesh(n: int, dp: int = 1, tp: Optional[int] = None, cp: int = 1,
              what: str = 'device_count') -> Tuple[int, int, int]:
    """The (dp, cp, tp) sizes for n ranks, by the rules of the JAX
    package's `make_mesh`: tp defaults to n/(dp*cp), dp=-1 means n/(tp*cp),
    and a product other than n raises its ValueError."""
    if dp == -1:
        dp = max(1, n // ((tp or n) * cp))
    if tp is None:
        tp = n // (dp * cp)
    if dp * cp * tp != n:
        raise ValueError(f'dp*cp*tp = {dp}*{cp}*{tp} != {what} {n}')
    return dp, cp, tp


def coords_of(rank: int, dp: int, cp: int, tp: int) -> Tuple[int, int, int]:
    """(dp_i, cp_i, tp_i) of `rank` within a replica of that shape."""
    rank %= dp * cp * tp
    return rank // (cp * tp), (rank // tp) % cp, rank % tp


def axis_groups(base: int, dp: int, cp: int, tp: int
                ) -> Dict[str, List[List[int]]]:
    """The rank lists of every group along each axis of the replica that
    starts at rank `base`."""
    def rank(d, c, t):
        return base + (d * cp + c) * tp + t
    return {
        'dp': [[rank(d, c, t) for d in range(dp)]
               for c in range(cp) for t in range(tp)],
        'cp': [[rank(d, c, t) for c in range(cp)]
               for d in range(dp) for t in range(tp)],
        'tp': [[rank(d, c, t) for t in range(tp)]
               for d in range(dp) for c in range(cp)],
    }


class Mesh:
    """A (dp, cp, tp) grid of ranks with one process group per axis.

    `shape` maps each axis name to its size, `coords` to this rank's index
    on it; `group(axis)` is the axis's `torch.distributed` group (None for
    a size-1 axis: nothing to talk to). `replica` and `replicas` say which
    of the world's replicas this is and how many there are."""

    def __init__(self, dp: int, cp: int, tp: int, rank: int = 0,
                 replica: int = 0, replicas: int = 1,
                 groups: Optional[Dict[str, object]] = None,
                 device: Optional[torch.device] = None,
                 backend: Optional[str] = None):
        self.shape = {'dp': dp, 'cp': cp, 'tp': tp}
        self.rank = rank
        self.coords = dict(zip(AXES, coords_of(rank, dp, cp, tp)))
        self.replica, self.replicas = replica, replicas
        self.groups = groups or {}
        self.device = device
        self.backend = backend

    @property
    def dp(self) -> int:
        return self.shape['dp']

    @property
    def cp(self) -> int:
        return self.shape['cp']

    @property
    def tp(self) -> int:
        return self.shape['tp']

    @property
    def size(self) -> int:
        return self.dp * self.cp * self.tp

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        return self.groups.get(axis)

    def __repr__(self) -> str:
        return (f'Mesh(dp={self.dp}, cp={self.cp}, tp={self.tp}, rank='
                f'{self.rank}, coords={self.coords}, replica {self.replica}'
                f'/{self.replicas}, backend={self.backend})')

    # a module tree that holds the mesh (every layer of a sharded model)
    # is deep-copied by `quant.quantize_params`; process groups cannot be
    def __deepcopy__(self, memo):
        return self


def _world() -> Tuple[int, int]:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _build(dp: int, cp: int, tp: int, replicas: int,
           device: Optional[torch.device]) -> Mesh:
    """Create every replica's axis groups, in the same order on every rank
    (`dist.new_group` is collective over the whole world), and keep this
    rank's."""
    world, rank = _world()
    size = dp * cp * tp
    groups, backend = {}, None
    if world > 1:
        import torch.distributed as dist
        backend = dist.get_backend()
        for r in range(replicas):
            for axis, lists in axis_groups(r * size, dp, cp, tp).items():
                if len(lists[0]) < 2:
                    continue
                for ranks in lists:
                    g = dist.new_group(ranks)
                    if rank in ranks:
                        groups[axis] = g
    if device is None:
        device = (torch.device('cuda', torch.cuda.current_device())
                  if backend == 'nccl' else None)
    return Mesh(dp, cp, tp, rank=rank, replica=rank // size,
                replicas=replicas, groups=groups, device=device,
                backend=backend)


def make_mesh(dp: int = 1, tp: Optional[int] = None, cp: int = 1,
              device: Optional[torch.device] = None) -> Mesh:
    """A (dp, cp, tp) mesh over every rank of the process group (one rank
    when `torch.distributed` is not initialized). tp defaults to
    world/(dp*cp); dp=-1 means world/(tp*cp). Call
    `distributed.initialize_distributed` first."""
    if cp > 1:
        raise NotImplementedError(CP_REFUSAL)
    world, _ = _world()
    dp, cp, tp = plan_mesh(world, dp, tp, cp)
    return _build(dp, cp, tp, 1, device)


def local_mesh(dp: int = 1, tp: Optional[int] = None, cp: int = 1,
               device: Optional[torch.device] = None) -> Mesh:
    """A mesh over this host's ranks (`LOCAL_WORLD_SIZE`, as torchrun sets
    it): one model replica a host, each replica with its own groups, the
    hosts splitting the work among themselves (`distributed.
    score_fasta_sharded`). The sizes follow `make_mesh`'s rules over the
    local world."""
    if cp > 1:
        raise NotImplementedError(CP_REFUSAL)
    world, _ = _world()
    local = int(os.environ.get('LOCAL_WORLD_SIZE', world))
    dp, cp, tp = plan_mesh(local, dp, tp, cp, what='local world size')
    if world % local:
        raise ValueError(f'world size {world} is not a multiple of the '
                         f'local world size {local}')
    return _build(dp, cp, tp, world // local, device)


def has_cp(mesh: Optional[Mesh]) -> bool:
    """True when `mesh` carries an active (size > 1) context-parallel axis."""
    return mesh is not None and mesh.shape.get('cp', 1) > 1


def channel_axes(mesh: Optional[Mesh]):
    """Mesh axes that shard mixer channels and heads: tp alone on (dp, tp)
    meshes; (tp, cp) under context parallelism, as in the JAX package."""
    return ('tp', 'cp') if has_cp(mesh) else 'tp'


def tp_size(mesh: Optional[Mesh]) -> int:
    return 1 if mesh is None else mesh.tp
