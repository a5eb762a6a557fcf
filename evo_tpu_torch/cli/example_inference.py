"""Minimal forward-pass demo (the twin of the JAX package's
`scripts/example_inference.py`): a single sequence, then a ragged batch
through `prepare_batch`; prints logits of shape (batch, length, vocab).

    python -m evo_tpu_torch.cli.example_inference \
        [--checkpoint-path ... | --random-init] [--device cuda]

`--tiny --device cpu` runs a tiny model of the same schema on the CPU.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from evo_tpu_torch.config import cli_tiny_overrides
from evo_tpu_torch.models import Evo
from evo_tpu_torch.scoring import prepare_batch


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description='Forward-pass demo of Evo '
                                     '(PyTorch / CUDA).')
    parser.add_argument('--model-name', default='evo-1-8k-base')
    parser.add_argument('--checkpoint-path', default=None)
    parser.add_argument('--random-init', action='store_true')
    parser.add_argument('--device', default='cuda',
                        help='where the model runs: cuda (default) or cpu')
    parser.add_argument('--tiny', action='store_true',
                        help='tiny model of the same schema (CPU smoke '
                             'tests; implies --random-init)')
    return parser


def main(argv: Optional[List[str]] = None):
    args = build_parser().parse_args(argv)
    evo = Evo(args.model_name, args.device,
              checkpoint_path=args.checkpoint_path,
              random_init=args.random_init or args.tiny,
              config_overrides=cli_tiny_overrides() if args.tiny else None)
    model, tokenizer = evo.model, evo.tokenizer

    sequence = 'ACGT'
    input_ids = torch.as_tensor(
        np.asarray(tokenizer.tokenize(sequence), dtype=np.int64)[None],
        device=model.device)
    with torch.no_grad():
        logits, _ = model(input_ids)
    print('Logits: ', logits.float().cpu().numpy())
    print('Shape (batch, length, vocab): ', tuple(logits.shape))

    seqs = ['ACGT', 'CAGATTCCATT', 'GAATTCC']
    input_ids, seq_lengths = prepare_batch(seqs, tokenizer,
                                           prepend_bos=False)
    print('Batch shape: ', tuple(input_ids.shape), ' lengths: ', seq_lengths)
    with torch.no_grad():
        batch_logits, _ = model(torch.as_tensor(input_ids,
                                                device=model.device))
    print('Batch logits shape (batch, length, vocab): ',
          tuple(batch_logits.shape))
    return logits, batch_logits


if __name__ == '__main__':
    main()
