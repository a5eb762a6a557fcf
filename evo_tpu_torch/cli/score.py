"""CLI: FASTA in -> TSV of per-sequence log-likelihood scores out (the
flags, defaults and output of the JAX package's `scripts/score.py`).

    python -m evo_tpu_torch.cli.score \
        --input-fasta examples/example_seqs.fasta --output-tsv scores.tsv \
        --model-name evo-1-8k-base --checkpoint-path /path/to/snapshot

`--device` is honoured and defaults to `cuda`; `--tiny --device cpu` runs a
tiny model of the same schema on the CPU.

Across processes (the multi-host branch of the JAX package's script),
launched one rank a card the way torchrun launches it:

    torchrun --nproc-per-node 8 -m evo_tpu_torch.cli.score \
        --input-fasta big.fasta --output-tsv scores.tsv [--tp 2]

Each model replica scores its shards of the FASTA, with a manifest, a
CSV and a done-marker a shard in `<output-tsv>.work/`, so a re-run
resumes; rank 0 writes the TSV in input order and the other ranks exit
quietly. Without `--tp` / `--cp` a replica is one rank. With `--tp T`
and / or `--cp N` it is all the ranks of a host (`local_mesh`): T-way
tensor parallel and N-way context parallel (each sequence split over N
ranks), with the host's ranks / (T N) data-parallel ranks inside it that
split each batch, and the hosts split the shards. `--dist-backend gloo`
runs several ranks on one card (NCCL refuses that).
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from evo_tpu_torch.config import cli_quant_overrides, cli_tiny_overrides
from evo_tpu_torch.io.fasta import read_fasta
from evo_tpu_torch.models import Evo
from evo_tpu_torch.scoring import (score_sequences, score_sequences_segmented,
                                   score_stream)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description='Score sequences with Evo (PyTorch / CUDA).')
    parser.add_argument('--input-fasta', required=True,
                        help='Path to input FASTA file')
    parser.add_argument('--output-tsv', required=True,
                        help='Path to output TSV file')
    parser.add_argument('--model-name', default='evo-1-8k-base')
    parser.add_argument('--batch-size', type=int, default=32)
    parser.add_argument('--device', default='cuda',
                        help='where the model runs: cuda (default) or cpu')
    parser.add_argument('--checkpoint-path', default=None,
                        help='local reference safetensors snapshot or '
                             'native evo_tpu_torch checkpoint')
    parser.add_argument('--random-init', action='store_true',
                        help='random weights (smoke tests / benchmarking)')
    parser.add_argument('--tiny', action='store_true',
                        help='tiny model of the same schema (CPU smoke '
                             'tests; implies --random-init)')
    parser.add_argument('--reduce-method', default='mean',
                        choices=['mean', 'sum'])
    add_mesh_flags(parser)
    parser.add_argument('--no-bucket', action='store_true',
                        help='disable power-of-two length bucketing')
    parser.add_argument('--segment-len', type=int, default=None,
                        help='score in SEGMENT_LEN chunks through the '
                             'resumable cache (bounded activation memory '
                             'for 131k-class sequences); runs unbatched')
    parser.add_argument('--quant', default='none',
                        choices=['none', 'int8', 'int8x8', 'int4'],
                        help='opt-in serving precision: int8 = weight-only; '
                             'int8x8 = int8 weights + dynamic int8 '
                             'activations; int4 = memory-fit mode. Default '
                             'bf16 keeps the reference-parity numerics.')
    parser.add_argument('--kv-quant', default='none',
                        choices=['none', 'int8'],
                        help='int8 attention KV cache: halves the KV '
                             'buffers of --segment-len scoring (opt-in)')
    return parser


def add_mesh_flags(parser: argparse.ArgumentParser) -> None:
    parser.add_argument('--dp', type=int, default=1,
                        help='data-parallel size (ranks that split the '
                             'work; one process a rank)')
    parser.add_argument('--cp', type=int, default=1,
                        help='context-parallel size (ranks that split each '
                             'sequence; long-context prefill)')
    parser.add_argument('--tp', type=int, default=None,
                        help='tensor-parallel size (ranks that shard one '
                             'model)')
    parser.add_argument('--dist-backend', default=None,
                        choices=['nccl', 'gloo'],
                        help='torch.distributed backend: nccl on the card '
                             '(default), gloo on the CPU; gloo also runs '
                             'several ranks on one card')


def start_ranks(args) -> bool:
    """Join the process group that torchrun's environment describes
    (`parallel.distributed.initialize_distributed`, the backend of
    --dist-backend). Returns True with more than one rank. --dp / --tp /
    --cp above 1 in a single process raise: each rank is a process."""
    from evo_tpu_torch.parallel.distributed import initialize_distributed
    multi = initialize_distributed(backend=args.dist_backend,
                                   device=args.device)
    cp = getattr(args, 'cp', 1)
    if not multi and (args.dp not in (1, -1) or args.tp not in (None, 1)
                      or cp != 1):
        raise ValueError(
            f'--dp {args.dp} --tp {args.tp} --cp {cp} needs one process a '
            'rank: launch with torchrun (or the same RANK / WORLD_SIZE / '
            'MASTER_ADDR / MASTER_PORT environment)')
    return multi


def rank() -> int:
    from evo_tpu_torch.parallel.distributed import get_rank
    return get_rank()


def build_overrides(args) -> Optional[dict]:
    """The config overrides of --tiny (which implies --random-init),
    --quant and --kv-quant."""
    overrides = None
    if args.tiny:
        args.random_init = True
        overrides = cli_tiny_overrides()
    if args.quant != 'none':
        overrides = dict(overrides or {}, **cli_quant_overrides(args.quant))
    if args.kv_quant != 'none':
        overrides = dict(overrides or {}, kv_quant=args.kv_quant)
    return overrides


def main(argv: Optional[List[str]] = None):
    args = build_parser().parse_args(argv)
    # join the ranks first: each takes its card before anything else does
    multi = start_ranks(args)
    mesh = None
    if multi:
        from evo_tpu_torch.parallel.distributed import get_world_size
        from evo_tpu_torch.parallel.mesh import local_mesh
        # a model replica: one rank, or under --tp / --cp every rank of a
        # host (dp = local ranks / (tp cp) inside it); the replicas split
        # the FASTA between them (score_fasta_sharded)
        tp, cp = args.tp or 1, args.cp
        n = get_world_size() // (tp * cp)
        if args.dp not in (1, -1, n):
            raise ValueError(f'--dp {args.dp}: {get_world_size()} ranks at '
                             f'--tp {tp} --cp {cp} make {n} data-parallel '
                             'replicas')
        if tp > 1 or cp > 1:
            mesh = local_mesh(dp=-1, tp=tp, cp=cp)
    overrides = build_overrides(args)
    evo = Evo(args.model_name, args.device,
              checkpoint_path=args.checkpoint_path,
              random_init=args.random_init, config_overrides=overrides,
              mesh=mesh)

    _, seqs = read_fasta(args.input_fasta)
    print(f'Scoring {len(seqs)} sequences...', flush=True)
    if multi:
        return _score_sharded(args, evo, seqs, mesh)
    if args.segment_len:
        scores = score_sequences_segmented(
            seqs, evo.model, evo.tokenizer, segment_len=args.segment_len,
            reduce_method=args.reduce_method)
    else:
        batches = [seqs[i:i + args.batch_size]
                   for i in range(0, len(seqs), args.batch_size)]
        scores = score_stream(
            batches, evo.model, evo.tokenizer,
            reduce_method=args.reduce_method,
            pad_to_bucket=not args.no_bucket,
            progress=lambda done: print(f'  {done}/{len(seqs)}',
                                        flush=True))

    with open(args.output_tsv, 'w') as f:
        f.write('seqs\tscores\n')
        for seq, score in zip(seqs, scores):
            f.write(f'{seq}\t{score}\n')
    print(f'Wrote {args.output_tsv}')
    return seqs, scores


def _score_sharded(args, evo, seqs, mesh):
    """The multi-process branch: shards, done-markers and resume in
    `<output-tsv>.work/`; rank 0 writes the TSV in input order."""
    import csv

    from evo_tpu_torch.parallel.distributed import score_fasta_sharded

    def score_batch(batch):
        if args.segment_len:
            return score_sequences_segmented(
                batch, evo.model, evo.tokenizer,
                segment_len=args.segment_len,
                reduce_method=args.reduce_method)
        return score_sequences(batch, evo.model, evo.tokenizer,
                               reduce_method=args.reduce_method)

    merged = score_fasta_sharded(
        args.input_fasta, args.output_tsv + '.work', score_batch,
        batch_size=args.batch_size, mesh=mesh,
        log=lambda msg: print(f'rank {rank()}: {msg}', flush=True))
    if merged is None:
        return None, None
    with open(merged) as f:
        rows = list(csv.reader(f))[1:]       # input order
    scores = [float(r[2]) for r in rows]
    with open(args.output_tsv, 'w') as f:
        f.write('seqs\tscores\n')
        for seq, score in zip(seqs, scores):
            f.write(f'{seq}\t{score}\n')
    print(f'Wrote {args.output_tsv}')
    return seqs, scores


if __name__ == '__main__':
    main()
