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
takes the requests and broadcasts them), speculation, LoRA and the full
train step run under any (dp, cp, tp) mesh; under cp the collectives
carry gradients (`collectives.py`, and the ring's hand-written backward in
`ops/ring_attention.py`).

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
