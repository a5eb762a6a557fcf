"""Data- and tensor-parallel execution over `torch.distributed` (port of
`evo_tpu/parallel/`).

One process per card, as `torchrun` launches it. A (dp, cp, tp) `Mesh`
of ranks (`mesh.py`), Megatron layouts kept by hand: each rank holds
contiguous shards of the weights (`sharding.py`), runs every kernel at
the shard's shape, and sums the row-parallel products over tp with an
explicit all-reduce (`collectives.py`). `distributed.py` starts the
process group and runs the restartable sharded scoring jobs. Context
parallelism (cp > 1) is not ported yet and raises.

The JAX package's exports, but for `param_shardings` and `data_sharding`:
they build `NamedSharding`s for GSPMD to place, and a rank of the port
places nothing. What they describe is `sharding.tp_axis` /
`sharding.shard_tensor` (a parameter's split) and `collectives.
shard_rows` (a dp rank's rows of a batch).
"""

from evo_tpu_torch.parallel.mesh import local_mesh, make_mesh  # noqa: F401
from evo_tpu_torch.parallel.sharding import (  # noqa: F401
    cache_shardings, shard_params,
)


def refuse_mesh(what: str, mesh) -> None:
    """Raise for a path that is not ported under a mesh yet."""
    if mesh is not None:
        raise NotImplementedError(
            f'{what} under a mesh is not ported yet (ROADMAP.md, modules '
            'queue: parallelism: context parallel, and serving, '
            'speculation and LoRA under a mesh)')
