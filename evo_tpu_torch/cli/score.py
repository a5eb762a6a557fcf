"""CLI: FASTA in -> TSV of per-sequence log-likelihood scores out (the
flags, defaults and output of the JAX package's `scripts/score.py`).

    python -m evo_tpu_torch.cli.score \
        --input-fasta examples/example_seqs.fasta --output-tsv scores.tsv \
        --model-name evo-1-8k-base --checkpoint-path /path/to/snapshot

`--device` is honoured and defaults to `cuda`; `--tiny --device cpu` runs a
tiny model of the same schema on the CPU.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from evo_tpu_torch.config import cli_quant_overrides, cli_tiny_overrides
from evo_tpu_torch.io.fasta import read_fasta
from evo_tpu_torch.models import Evo
from evo_tpu_torch.scoring import score_sequences_segmented, score_stream


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
    parser.add_argument('--dp', type=int, default=1,
                        help='data-parallel mesh size (not ported yet)')
    parser.add_argument('--cp', type=int, default=1,
                        help='context-parallel axis size (not ported yet)')
    parser.add_argument('--tp', type=int, default=None,
                        help='tensor-parallel mesh size (not ported yet)')
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


def refuse_parallelism(args) -> None:
    """The mesh flags are accepted for compatibility and raise when set:
    their machinery is not ported."""
    if args.dp != 1 or args.cp != 1 or args.tp not in (None, 1):
        raise NotImplementedError(
            '--dp / --tp / --cp (meshes, and with them multi-host scoring) '
            'are not ported yet (ROADMAP.md, modules queue: parallelism)')


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
    refuse_parallelism(args)
    overrides = build_overrides(args)
    evo = Evo(args.model_name, args.device,
              checkpoint_path=args.checkpoint_path,
              random_init=args.random_init, config_overrides=overrides)

    _, seqs = read_fasta(args.input_fasta)
    print(f'Scoring {len(seqs)} sequences...', flush=True)
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


if __name__ == '__main__':
    main()
