"""A 131,072-nt context on one card (the twin of the JAX package's
`examples/long_context.py`): evo-1-131k-base reaches 131,072 tokens by
interpolated rotary embeddings; this runs that length with the opt-in
serving modes:

  * int8 weights with int8 activations (`torch._int_mm` on the card);
  * segmented scoring through the resumable cache, O(segment)
    activations, the modal and FIR states carried exactly;
  * attention of each segment over the KV buffer (kernels 4 / 5).

Random weights from a seed; swap `random_init=True` for
`checkpoint_path=...` to run real ones.

    python -m evo_tpu_torch.examples.long_context [length] [segment]
        [--device cuda]

`--tiny --device cpu` runs a tiny model of the same schema (under the
same int8 modes), at a short length for a quick run.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np

from evo_tpu_torch.config import cli_tiny_overrides
from evo_tpu_torch.generation import generate
from evo_tpu_torch.models import Evo
from evo_tpu_torch.scoring import (positional_entropies_segmented,
                                   score_sequences_segmented)


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument('length', type=int, nargs='?', default=131072)
    ap.add_argument('segment', type=int, nargs='?', default=8192)
    ap.add_argument('--device', default='cuda',
                    help='where the model runs: cuda (default) or cpu')
    ap.add_argument('--tiny', action='store_true',
                    help='tiny model of the same schema (CPU smoke tests)')
    args = ap.parse_args(argv)
    L, SEG = args.length, args.segment

    overrides = dict(weight_quant='int8', act_quant='int8')
    if args.tiny:
        overrides.update(cli_tiny_overrides())
    evo = Evo('evo-1-131k-base', args.device, random_init=True,
              config_overrides=overrides)

    # L - 1 bases + BOS = L tokens
    seq = ''.join(np.random.default_rng(0).choice(list('ACGT'), L - 1))

    t0 = time.perf_counter()
    score = score_sequences_segmented([seq], evo.model, evo.tokenizer,
                                      segment_len=SEG)[0]
    dt = time.perf_counter() - t0
    print(f'{L}-token context scored in {dt:.1f}s '
          f'({L / dt:.0f} tok/s): mean logprob {score:.4f}')

    t0 = time.perf_counter()
    ents = positional_entropies_segmented([seq], evo.model, evo.tokenizer,
                                          segment_len=SEG)[0]
    dt = time.perf_counter() - t0
    print(f'per-position entropies in {dt:.1f}s: '
          f'first/median/last = {ents[0]:.3f}/{np.median(ents):.3f}/'
          f'{ents[-1]:.3f} nats over {len(ents)} positions')

    # generation continuing a long prompt, prefilled in segments
    prompt = seq[:min(4 * SEG, L - 1)]
    t0 = time.perf_counter()
    seqs, scores = generate([prompt], evo.model, evo.tokenizer,
                            n_tokens=64, top_k=4, temperature=1.0,
                            prefill_segment_len=SEG, verbose=0)
    dt = time.perf_counter() - t0
    print(f'generated 64 tokens from a {len(prompt)}-token prompt in '
          f'{dt:.1f}s; score {scores[0]:.4f}')
    return dict(score=score, entropies=ents, generated=seqs[0],
                generated_score=scores[0])


if __name__ == '__main__':
    main()
