"""Multi-process execution: process-group start-up, per-process work
splits, result merging and restartable sharded scoring jobs (port of
`evo_tpu/parallel/distributed.py`).

The JAX package runs one process per host, joined by
`jax.distributed`. The port runs one process per card under
`torch.distributed`, started the way `torchrun` starts it (`RANK`,
`WORLD_SIZE`, `LOCAL_RANK`, `LOCAL_WORLD_SIZE`, `MASTER_ADDR`,
`MASTER_PORT`). The backend is chosen by the caller: NCCL on the card by
default, gloo on the CPU. NCCL refuses two ranks on one card, and
`initialize_distributed` says so before NCCL does, naming gloo; nothing
switches backends quietly. Under gloo, CUDA tensors go through
`all_reduce`, `broadcast` and `barrier` only; every gather here runs on
CPU tensors.

The scoring jobs keep the JAX package's files: a manifest.json of the
shards (byte for byte the same on the same inputs, so that a work
directory moves between the packages), a CSV and a done-marker a shard,
and a merged scores.csv in input order.

`global_batch_from_local` has no counterpart: it assembles the per-host
rows of one single-controller program into a global array, and in a
one-process-per-card design each rank runs its own rows (`collectives.
shard_rows`) and the results are gathered (`collectives.gather_rows`).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

# environment hints of a managed cluster, as in the JAX package
_HINTS = ('TPU_WORKER_HOSTNAMES', 'TPU_WORKER_ID',
          'MEGASCALE_COORDINATOR_ADDRESS', 'CLOUD_TPU_TASK_ID',
          'SLURM_STEP_NODELIST', 'OMPI_MCA_orte_hnp_uri')
GLOO_HINT = ("pass backend='gloo' (--dist-backend gloo) to run several "
             'ranks on one card')


def _dist():
    import torch.distributed as dist
    return dist


def get_rank() -> int:
    dist = _dist()
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    dist = _dist()
    return dist.get_world_size() if dist.is_initialized() else 1


def _env_int(*names: str) -> Optional[int]:
    for n in names:
        if os.environ.get(n):
            return int(os.environ[n])
    return None


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           retries: int = 5,
                           retry_delay: float = 10.0,
                           backend: Optional[str] = None,
                           device: str = 'cuda') -> bool:
    """`torch.distributed.init_process_group` from torchrun's environment,
    with the JAX package's coordinator forwarding and retry. Returns True
    when more than one process takes part afterwards.

    The coordinator is `coordinator_address`, else COORDINATOR_ADDRESS /
    JAX_COORDINATOR_ADDRESS (host:port), else MASTER_ADDR:MASTER_PORT. The
    world size and rank come from the arguments, else WORLD_SIZE / RANK
    (SLURM_NTASKS / SLURM_PROCID and OMPI_COMM_WORLD_SIZE / _RANK under
    the cluster hints). A single process with none of these returns False
    at once.

    backend: 'nccl' or 'gloo'; None means NCCL for `device='cuda'` and
    gloo for the CPU. With NCCL each local rank takes card LOCAL_RANK,
    and more local ranks than cards raise (NCCL refuses two ranks on one
    card). Under gloo on CUDA, ranks share the cards round-robin. Called
    again, it returns the state of the existing group."""
    dist = _dist()
    if dist.is_initialized():
        return dist.get_world_size() > 1
    addr = (coordinator_address or os.environ.get('JAX_COORDINATOR_ADDRESS')
            or os.environ.get('COORDINATOR_ADDRESS'))
    if addr is None and os.environ.get('MASTER_ADDR'):
        addr = (f"{os.environ['MASTER_ADDR']}:"
                f"{os.environ.get('MASTER_PORT', '29500')}")
    world = (num_processes if num_processes is not None else _env_int(
        'WORLD_SIZE', 'SLURM_NTASKS', 'OMPI_COMM_WORLD_SIZE'))
    rank = (process_id if process_id is not None else _env_int(
        'RANK', 'SLURM_PROCID', 'OMPI_COMM_WORLD_RANK'))
    explicit = (coordinator_address is not None or num_processes is not None
                or 'WORLD_SIZE' in os.environ)
    if not explicit and not any(h in os.environ for h in _HINTS):
        return False                    # single-process run
    if world is None or world == 1 and addr is None:
        return False                    # a hint, but nothing configured
    if addr is None or rank is None:
        raise ValueError(
            f'distributed start-up needs a coordinator address and a rank '
            f'(got {addr!r}, rank {rank}, world {world}): set MASTER_ADDR / '
            'MASTER_PORT and RANK, as torchrun does')
    if device == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('device="cuda" was requested but no CUDA device '
                           'is available; pass device="cpu"')
    if backend is None:
        backend = 'nccl' if device == 'cuda' else 'gloo'
    if backend not in ('nccl', 'gloo'):
        raise ValueError(f"unknown backend {backend!r} ('nccl' or 'gloo')")
    local_rank = _env_int('LOCAL_RANK') or 0
    local_world = _env_int('LOCAL_WORLD_SIZE') or 1
    if device == 'cuda':
        cards = torch.cuda.device_count()
        if backend == 'nccl' and local_world > cards:
            raise RuntimeError(
                f'NCCL needs a card of its own for each rank: '
                f'{local_world} local ranks on {cards} card(s); '
                + GLOO_HINT)
        torch.cuda.set_device(local_rank % cards)
    elif backend == 'nccl':
        raise ValueError("backend 'nccl' needs device='cuda'")
    host, _, port = addr.rpartition(':')
    last_err: Optional[Exception] = None
    for attempt in range(retries):
        try:
            dist.init_process_group(
                backend, init_method=f'tcp://{host}:{port}',
                world_size=world, rank=rank)
            return world > 1
        except (RuntimeError, ConnectionError, OSError) as e:
            last_err = e                # coordinator not up yet etc.
        if attempt < retries - 1:
            time.sleep(retry_delay * (attempt + 1))
    raise RuntimeError(
        f'torch.distributed.init_process_group failed after {retries} '
        'attempts') from last_err


def barrier() -> None:
    if get_world_size() > 1:
        _dist().barrier()


def split_for_process(items: Sequence, process_index: Optional[int] = None,
                      process_count: Optional[int] = None) -> List:
    """This process's contiguous slice of a global work list."""
    pi = get_rank() if process_index is None else process_index
    pc = get_world_size() if process_count is None else process_count
    per = (len(items) + pc - 1) // pc
    return list(items[pi * per:(pi + 1) * per])


# `global_batch_from_local` (the JAX package's, between these two) has no
# counterpart: each rank runs its own rows and the results are gathered
# (module docstring).


def allgather_to_all_hosts(x):
    """Every process's x concatenated along axis 0 (tiled, not stacked), on
    every process. x: a numpy array or a tensor of the same shape on every
    process; the result has x's kind (and device)."""
    is_np = isinstance(x, np.ndarray)
    t = torch.from_numpy(np.ascontiguousarray(x)) if is_np else x
    if get_world_size() == 1:
        return x
    src = t.detach().cpu().contiguous()
    parts = [torch.empty_like(src) for _ in range(get_world_size())]
    _dist().all_gather(parts, src)
    out = torch.cat(parts, dim=0)
    return out.numpy() if is_np else out.to(t.device)


# ---------------------------------------------------------------------------
# Restartable sharded scoring jobs
# ---------------------------------------------------------------------------

def write_shard_manifest(work_dir: str, names: Sequence[str],
                         num_shards: int,
                         fingerprint: Optional[str] = None
                         ) -> List[List[str]]:
    """Split a sequence-name list into shards; persist manifest.json.

    fingerprint: content hash of the inputs (score_fasta_sharded hashes
    the sequences): done-markers are valid only for the exact inputs they
    were written under, and names alone cannot detect an edited FASTA
    with unchanged headers."""
    shards = [list(names[i::num_shards]) for i in range(num_shards)]
    path = Path(work_dir)
    path.mkdir(parents=True, exist_ok=True)
    manifest = path / 'manifest.json'
    meta = {'num_shards': num_shards, 'shards': shards,
            'fingerprint': fingerprint}
    if not manifest.exists() and get_rank() == 0:
        # atomic publish: a reader never sees a partial file
        tmp = path / f'.manifest.{os.getpid()}.tmp'
        with open(tmp, 'w') as f:
            json.dump(meta, f)
        os.replace(tmp, manifest)
    if not manifest.exists():
        # another process on a shared filesystem: wait briefly for rank
        # 0's publish (the rename is atomic, so existence => complete)
        for _ in range(50):
            if manifest.exists():
                break
            time.sleep(0.2)
    if manifest.exists():
        # resume (or freshly published): the done-markers are valid only
        # for the sharding and inputs they were written under
        with open(manifest) as f:
            prev = json.load(f)
        if (prev.get('num_shards') != num_shards
                or prev.get('shards') != shards
                or (fingerprint is not None
                    and prev.get('fingerprint') is not None
                    and prev.get('fingerprint') != fingerprint)):
            raise ValueError(
                f'{manifest} holds a different sharding or input '
                f'fingerprint (num_shards={prev.get("num_shards")} vs '
                f'{num_shards}); the inputs or settings changed: clear '
                'the work_dir or rerun with the originals')
    return shards


def shard_done(work_dir: str, shard_idx: int) -> bool:
    return (Path(work_dir) / f'shard_{shard_idx}.done').exists()


def mark_shard_done(work_dir: str, shard_idx: int) -> None:
    (Path(work_dir) / f'shard_{shard_idx}.done').write_text('done\n')


def fasta_fingerprint(names: Sequence[str], seqs: Sequence[str]) -> str:
    """sha1 over every record's name and sequence, each ended by a NUL."""
    import hashlib
    h = hashlib.sha1()
    for n, s in zip(names, seqs):
        h.update(n.encode()); h.update(b'\0')        # noqa: E702
        h.update(s.encode()); h.update(b'\0')        # noqa: E702
    return h.hexdigest()


def score_fasta_sharded(
    fasta_path: str,
    work_dir: str,
    score_fn: Callable[[List[str]], List[float]],
    num_shards: Optional[int] = None,
    batch_size: int = 32,
    mesh=None,
    log: Optional[Callable[[str], None]] = None,
) -> Optional[str]:
    """Score a FASTA across processes with a checkpoint a shard.

    The unit of work is a model replica: every process, or with `mesh`
    (a `mesh.local_mesh`) every replica of that mesh, whose ranks all run
    `score_fn` on the same batches and whose first rank writes the
    files. Each unit scores its own shards (a CSV and a done-marker a
    shard; done shards are skipped on a re-run), then rank 0 merges all
    shard CSVs into scores.csv in input order. `score_fn(seq_batch) ->
    scores` is typically `lambda b: score_sequences(b, model, tokenizer)`.
    `log`, if given, is told of each shard this process skips or scores.

    Returns the merged CSV path on rank 0, None elsewhere."""
    import csv

    from evo_tpu_torch.io.fasta import read_fasta

    names, seqs = read_fasta(fasta_path)
    if mesh is None:
        unit, units, writer = get_rank(), get_world_size(), True
    else:
        unit, units = mesh.replica, mesh.replicas
        writer = (get_rank() - unit * mesh.size) == 0
    num_shards = num_shards or units
    # shard by record INDEX, not name: FASTA names may repeat
    idx_shards = [list(range(len(names)))[i::num_shards]
                  for i in range(num_shards)]
    write_shard_manifest(work_dir, names, num_shards,
                         fingerprint=fasta_fingerprint(names, seqs))
    my_shards = split_for_process(list(range(num_shards)), unit, units)

    for shard_idx in my_shards:
        # every rank of a replica reads the marker before its writer can
        # set it: the writer's scores need the others' collectives
        if shard_done(work_dir, shard_idx):
            if log is not None:
                log(f'shard {shard_idx}: done before, skipped')
            continue
        idxs = idx_shards[shard_idx]
        rows = []
        for i in range(0, len(idxs), batch_size):
            batch_idx = idxs[i:i + batch_size]
            scores = score_fn([seqs[j] for j in batch_idx])
            rows += [(j, names[j], s) for j, s in zip(batch_idx, scores)]
        if writer:
            with open(Path(work_dir) / f'shard_{shard_idx}.csv', 'w',
                      newline='') as f:
                w = csv.writer(f)
                w.writerow(['index', 'name', 'score'])
                w.writerows(rows)
            mark_shard_done(work_dir, shard_idx)
        if log is not None:
            log(f'shard {shard_idx}: scored {len(rows)} sequences')

    # rank 0 merges only after everyone finished
    barrier()
    if get_rank() != 0:
        return None
    rows = []
    for shard_idx in range(num_shards):
        shard_csv = Path(work_dir) / f'shard_{shard_idx}.csv'
        if not shard_csv.exists():
            raise FileNotFoundError(
                f'{shard_csv} missing after the completion barrier: '
                'work_dir must be on a filesystem shared by all hosts')
        with open(shard_csv) as f:
            reader = csv.reader(f)
            next(reader, None)
            rows.extend(reader)
    rows.sort(key=lambda r: int(r[0]))     # restore input order
    merged = Path(work_dir) / 'scores.csv'
    with open(merged, 'w', newline='') as out:
        w = csv.writer(out)
        w.writerow(['index', 'name', 'score'])
        w.writerows(rows)
    return str(merged)


# ---------------------------------------------------------------------------
# Launching ranks on one host
# ---------------------------------------------------------------------------

def free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(('localhost', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch_local(argv: Sequence[str], nprocs: int,
                 env: Optional[Dict[str, str]] = None,
                 timeout: Optional[float] = None,
                 log_dir: Optional[str] = None) -> List[str]:
    """Run `python <argv>` as `nprocs` ranks on this host with torchrun's
    environment (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE,
    MASTER_ADDR=localhost, a free MASTER_PORT), wait for all of them and
    return each rank's output (standard output and errors together; also
    written to `<log_dir>/rank<i>.log` when given). A rank that exits
    non-zero, or a timeout, stops the others and raises with every rank's
    output tail."""
    base = dict(os.environ if env is None else env)
    base.update(MASTER_ADDR='localhost', MASTER_PORT=str(free_port()),
                WORLD_SIZE=str(nprocs), LOCAL_WORLD_SIZE=str(nprocs))
    for k in ('JAX_COORDINATOR_ADDRESS', 'COORDINATOR_ADDRESS'):
        base.pop(k, None)
    logs = []
    procs = []
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
    for r in range(nprocs):
        path = (Path(log_dir) / f'rank{r}.log' if log_dir else None)
        f = open(path, 'w+') if path else tempfile.TemporaryFile('w+')
        logs.append(f)
        procs.append(subprocess.Popen(
            [sys.executable, *argv], env=dict(base, RANK=str(r),
                                              LOCAL_RANK=str(r)),
            stdout=f, stderr=subprocess.STDOUT, text=True))
    deadline = None if timeout is None else time.time() + timeout
    failed = None
    try:
        pending = list(range(nprocs))
        while pending and failed is None:
            for r in list(pending):
                rc = procs[r].poll()
                if rc is None:
                    continue
                pending.remove(r)
                if rc != 0:
                    failed = f'rank {r} exited with code {rc}'
            if deadline is not None and time.time() > deadline:
                failed = f'timed out after {timeout} s'
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = []
    for f in logs:
        f.seek(0)
        outs.append(f.read())
        f.close()
    if failed:
        raise RuntimeError(f'{" ".join(argv)}: {failed}\n' + '\n'.join(
            f'--- rank {r} ---\n{o[-4000:]}' for r, o in enumerate(outs)))
    return outs
