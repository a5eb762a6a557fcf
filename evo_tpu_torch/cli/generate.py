"""CLI sampling (the flags, defaults and output of the JAX package's
`scripts/generate.py`).

    python -m evo_tpu_torch.cli.generate --prompt ACGT --n-samples 10 \
        --n-tokens 100 --temperature 1.0 --top-k 4 \
        --model-name evo-1-8k-base --checkpoint-path /path/to/snapshot

`--device` is honoured and defaults to `cuda`; `--tiny --device cpu` runs a
tiny model of the same schema on the CPU. `--speculative G` generates each
sample by n-gram speculative decoding (`speculative.py`) with G proposed
tokens a verify pass, seed `--seed + i` for sample i.

`--dp` / `--tp` / `--cp` run one model over that many ranks, launched
one rank a card as torchrun launches them (`--dist-backend gloo` for
several ranks on one card): every rank runs the same loop and draws the
same tokens, and rank 0 prints them. `--cp N` splits the prompt's prefill
over N ranks. `--speculative G` runs under the mesh too: every rank takes
the same decisions from the same logits.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np

from evo_tpu_torch.cli.score import (add_mesh_flags, build_overrides, rank,
                                     start_ranks)

from evo_tpu_torch.generation import generate
from evo_tpu_torch.models import Evo
from evo_tpu_torch.speculative import generate_speculative


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description='Generate with Evo (PyTorch / CUDA).')
    parser.add_argument('--prompt', required=True)
    parser.add_argument('--n-samples', type=int, default=3)
    parser.add_argument('--n-tokens', type=int, default=100)
    parser.add_argument('--temperature', type=float, default=1.0)
    parser.add_argument('--top-k', type=int, default=4)
    parser.add_argument('--top-p', type=float, default=1.0)
    parser.add_argument('--model-name', default='evo-1-8k-base')
    parser.add_argument('--cached-generation', action='store_true',
                        default=True,
                        help='accepted for compat; decode is always cached')
    parser.add_argument('--batched', action='store_true', default=True)
    parser.add_argument('--prepend-bos', action='store_true', default=False)
    parser.add_argument('--device', default='cuda',
                        help='where the model runs: cuda (default) or cpu')
    parser.add_argument('--verbose', type=int, default=1)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--checkpoint-path', default=None)
    parser.add_argument('--random-init', action='store_true')
    parser.add_argument('--tiny', action='store_true',
                        help='tiny same-schema model (CPU smoke tests; '
                             'implies --random-init)')
    add_mesh_flags(parser)
    parser.add_argument('--prefill-segment-len', type=int, default=None,
                        help='prefill long prompts in chunks of this many '
                             'tokens through the resumable cache (bounded '
                             'activation memory for 131k-class prompts)')
    parser.add_argument('--ngram', type=int, default=12,
                        help='speculative drafter: longest gram length '
                             'tried (read only with --speculative)')
    parser.add_argument('--speculative', type=int, default=0, metavar='G',
                        help='n-gram speculative decoding with G proposed '
                             'tokens per verify pass; 0 = off')
    parser.add_argument('--quant', default='none',
                        choices=['none', 'int8', 'int8x8', 'int4'],
                        help='opt-in serving precision: int8 = weight-only; '
                             'int8x8 = + dynamic int8 activations; int4 = '
                             'memory-fit mode. Default bf16 keeps the '
                             'reference-parity numerics.')
    parser.add_argument('--kv-quant', default='none',
                        choices=['none', 'int8'],
                        help='int8 attention KV cache: halves the '
                             'long-context cache footprint and per-step '
                             'cache reads (opt-in)')
    return parser


def main(argv: Optional[List[str]] = None):
    args = build_parser().parse_args(argv)
    mesh = None
    if start_ranks(args):
        from evo_tpu_torch.parallel.mesh import make_mesh
        mesh = make_mesh(dp=args.dp, tp=args.tp, cp=args.cp)
        if rank() != 0:
            args.verbose = 0
    overrides = build_overrides(args)
    evo = Evo(args.model_name, args.device,
              checkpoint_path=args.checkpoint_path,
              random_init=args.random_init, config_overrides=overrides,
              mesh=mesh)
    if args.speculative:
        seqs, scores = [], []
        for i in range(args.n_samples):
            toks, logps, stats = generate_speculative(
                evo.model, evo.tokenizer, prompt=args.prompt,
                num_tokens=args.n_tokens, gamma=args.speculative,
                ngram=args.ngram, temperature=args.temperature,
                top_k=args.top_k, top_p=args.top_p, seed=args.seed + i)
            seqs.append(evo.tokenizer.detokenize(toks.tolist()))
            scores.append(float(np.mean(logps)))
            if args.verbose:
                print(f'Output: "{seqs[-1]}", Score: {scores[-1]:.4f} '
                      f'(acceptance {stats.acceptance_rate:.2f}, '
                      f'{stats.tokens_per_call:.2f} tokens/device-call)')
        return seqs, scores
    prompts = [args.prompt] * args.n_samples
    return generate(
        prompts, evo.model, evo.tokenizer,
        n_tokens=args.n_tokens, temperature=args.temperature,
        top_k=args.top_k, top_p=args.top_p, batched=args.batched,
        prepend_bos=args.prepend_bos,
        prefill_segment_len=args.prefill_segment_len,
        verbose=args.verbose, seed=args.seed)


if __name__ == '__main__':
    main()
