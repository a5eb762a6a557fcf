"""Data-, context- and tensor-parallel execution over `torch.distributed` (port of
`evo_tpu/parallel/`).

One process per card, as `torchrun` launches it. A (dp, cp, tp) `Mesh`
of ranks (`mesh.py`), Megatron layouts kept by hand: each rank holds
contiguous shards of the weights (`sharding.py`), runs every kernel at
the shard's shape, and sums the row-parallel products over tp with an
explicit all-reduce (`collectives.py`). Under context parallelism (cp >
1) the residual stream is split over the sequence, and the mixers move to
the whole sequence of a block of channels or heads and back by an
all-to-all over cp (or pass K/V around the cp group: `ops/
ring_attention.py`). `distributed.py` starts the process group and runs
the restartable sharded scoring jobs. Serving (`serving.py`: the first rank
takes the requests and broadcasts them), speculation and LoRA run under
any mesh, and the train steps under (dp, tp); training under cp is not
ported yet and raises (`refuse_cp`).

The JAX package's exports, but for `param_shardings` and `data_sharding`:
they build `NamedSharding`s for GSPMD to place, and a rank of the port
places nothing. What they describe is `sharding.tp_axis` /
`sharding.shard_tensor` (a parameter's split) and `collectives.
shard_rows` (a dp rank's rows of a batch).
"""

from evo_tpu_torch.parallel.mesh import (  # noqa: F401
    has_cp, local_mesh, make_mesh,
)
from evo_tpu_torch.parallel.sharding import (  # noqa: F401
    cache_shardings, shard_params,
)

QUEUE = 'ROADMAP.md, modules queue: parallelism: training under cp'


def refuse_cp(what: str, mesh) -> None:
    """Raise for a path that is not ported under context parallelism
    yet."""
    if has_cp(mesh):
        raise NotImplementedError(
            f'{what} under context parallelism (cp > 1) is not ported yet '
            f'({QUEUE})')
