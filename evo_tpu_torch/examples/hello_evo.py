"""Hello Evo: a guided tour of the PyTorch port (the twin of the JAX
package's `examples/hello_evo.py`): scoring, positional entropies,
generation, speculative decoding and generation resumed from its cache,
on a real checkpoint or a random-weight tiny model.

Run (no checkpoint needed):
    python -m evo_tpu_torch.examples.hello_evo --tiny --device cpu
With a local checkpoint snapshot, on the card:
    python -m evo_tpu_torch.examples.hello_evo --model-name evo-1-8k-base \
        --checkpoint-path /path/to/snapshot
For the downstream gene calling and folding, see
`evo_tpu_torch/cli/generation_to_folding.py`.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np

from evo_tpu_torch import (Evo, generate, generate_speculative,
                           positional_entropies, score_sequences)
from evo_tpu_torch.config import cli_tiny_overrides
from evo_tpu_torch.generation import Generator
from evo_tpu_torch.io.fasta import read_fasta

EXAMPLE_FASTA = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), 'examples', 'example_seqs.fasta')


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--model-name', default='evo-1-8k-base')
    ap.add_argument('--checkpoint-path', default=None)
    ap.add_argument('--device', default='cuda',
                    help='where the model runs: cuda (default) or cpu')
    ap.add_argument('--tiny', action='store_true',
                    help='random-weight tiny model (CPU-friendly demo)')
    args = ap.parse_args(argv)

    print('== Loading model ==')
    evo = Evo(args.model_name, args.device,
              checkpoint_path=args.checkpoint_path, random_init=args.tiny,
              config_overrides=cli_tiny_overrides() if args.tiny else None)
    model, tokenizer = evo.model, evo.tokenizer
    print(f'{args.model_name}: {model.num_params / 1e6:.1f}M parameters')

    print('\n== Scoring the example FASTA ==')
    names, seqs = read_fasta(EXAMPLE_FASTA)
    scores = score_sequences(seqs, model, tokenizer)
    for name, seq, score in zip(names, seqs, scores):
        print(f'  {name:24s} len={len(seq):3d} mean-logprob={score:+.4f}')

    print('\n== Positional entropies ==')
    ents = positional_entropies(seqs[:1], model, tokenizer)
    print(f'  {names[0]}: per-position entropy '
          f'{[round(float(e), 2) for e in ents[0][:8]]}...')

    print('\n== Generation ==')
    gen_seqs, gen_scores = generate(
        ['ACGT'] * 3, model, tokenizer, n_tokens=32, temperature=1.0,
        top_k=4, verbose=0)
    for seq, score in zip(gen_seqs, gen_scores):
        print(f'  {seq!r}  score={score:+.4f}')

    print('\n== Speculative decoding (self-similar prompts) ==')
    # On repetitive genomic sequence the n-gram drafter proposes the
    # continuation and one verify pass scores gamma tokens a weight read
    toks, _logps, stats = generate_speculative(
        model, tokenizer, prompt='ACGTTGCAAC' * 12, num_tokens=24, gamma=8)
    print(f'  {tokenizer.detokenize(np.asarray(toks).tolist())!r}')
    print(f'  acceptance={stats.acceptance_rate:.2f} '
          f'tokens/device-call={stats.tokens_per_call:.2f} '
          f'(random weights: acceptance ~0 is expected)')

    print('\n== Long generation (resumable cache across regrowths) ==')
    # chunked greedy generation, each call resumed from the cache the last
    # returned, is token-exact against one call
    g = Generator(model, tokenizer, top_k=1, temperature=0.0)
    cache, nxt, pieces = None, tokenizer.tokenize('ACGTACGT')[None], []
    for _ in range(3):
        part, _, cache = g.generate(
            input_ids=nxt, num_tokens=16, inference_params_dict=cache,
            verbose=False)
        part = np.asarray(part.cpu() if hasattr(part, 'cpu') else part)
        pieces.append(part[0])
        nxt = part[0][-1:][None]
    total = np.concatenate(pieces)
    print(f'  3 resumed chunks -> {len(total)} tokens: '
          f'{tokenizer.detokenize(total.tolist())[:48]!r}...')

    print('\nDone. Next steps: evo_tpu_torch/cli/generation_to_folding.py '
          'folds generated proteins.')
    return dict(scores=scores, generated=gen_seqs, resumed=total)


if __name__ == '__main__':
    main()
