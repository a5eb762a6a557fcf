"""The one traffic generator: it reads a mix's parameters (a file under
`traffic/`) and the run's seed, and yields the inputs a driver hands the
program.

Every seed gets the same sizes in another order: lengths are the
stratified quantiles of the mix's distribution (for n draws, the
quantiles (i + 0.5) / n), which the seed permutes, and the seed draws
the bases. So two seeds ask the same work of the card, and runs differ
by the card and the host, not by the draw.
"""

from __future__ import annotations

import math
from typing import Iterator, List, Sequence

import numpy as np

BASES = np.frombuffer(b'ACGT', dtype=np.uint8)
SEED_MASK = (1 << 63) - 1


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one purpose (`stream`) of a run's seed."""
    return np.random.Generator(np.random.PCG64(
        np.random.SeedSequence([int(seed) & SEED_MASK, *stream])))


def quantiles(lo: float, hi: float, n: int) -> List[int]:
    """n stratified draws of a length from [lo, hi]: the (i + 0.5) / n
    quantiles of the log-uniform distribution, rounded."""
    span = math.log(hi) - math.log(lo)
    return [int(round(math.exp(math.log(lo) + (i + 0.5) / n * span)))
            for i in range(n)]


def bases(r: np.random.Generator, n: int) -> str:
    """n random nucleotides (A, C, G, T, equally likely)."""
    return BASES[r.integers(0, 4, size=n)].tobytes().decode()


def score_batches(seed: int, mix: dict, stream: int = 0
                  ) -> Iterator[List[str]]:
    """Endless batches of `batch_size` sequences: each batch holds the
    stratified lengths of the mix in an order the seed draws."""
    r = rng(seed, 1, stream)
    lengths = quantiles(mix['min_len'], mix['max_len'], mix['batch_size'])
    while True:
        yield [bases(r, n) for n in r.permutation(lengths)]


def long_sequences(seed: int, mix: dict, stream: int = 0
                   ) -> Iterator[str]:
    """Endless sequences of the mix's one length."""
    r = rng(seed, 2, stream)
    while True:
        yield bases(r, mix['seq_len'])


class DesignTraffic:
    """The prompts of a design pipeline: groups of `samples_per_prompt`
    requests of one prompt and one output length, the first
    `greedy_per_prompt` of them greedy (temperature 0) and the rest
    sampled at the mix's temperature and top-k. Each cycle of `cycle`
    groups holds the stratified prompt lengths paired with the stratified
    output lengths. The first wave's groups take the stratified fractions
    (i + 0.5) / n of their output lengths, so that completions spread
    from the start. A server's work follows the order of the sizes (when
    each fill comes, how many slots decode), so that order is one fixed
    draw for every seed; the seed draws the bases and the samples."""

    def __init__(self, seed: int, mix: dict):
        self.mix = mix
        self.r = rng(seed, 3)
        self.order = rng(0, 3)
        n = mix['cycle']
        self.prompt_lens = quantiles(*mix['prompt_len'], n)
        self.output_lens = quantiles(*mix['output_len'], n)
        self.queue: List[tuple] = []
        clients = mix['clients']
        self.first = list(self.order.permutation(
            [(i + 0.5) / clients for i in range(clients)]))

    def next_group(self) -> dict:
        """{'prompt': str, 'num_tokens': int, 'temperatures': [...]}"""
        if not self.queue:
            outs = self.order.permutation(self.output_lens)
            order = self.order.permutation(len(self.prompt_lens))
            self.queue = [(self.prompt_lens[i], int(outs[i])) for i in order]
        p_len, n_out = self.queue.pop(0)
        if self.first:
            n_out = max(1, int(round(n_out * self.first.pop(0))))
        mix = self.mix
        k, g = mix['samples_per_prompt'], mix['greedy_per_prompt']
        return dict(prompt=bases(self.r, p_len), num_tokens=n_out,
                    temperatures=[0.0] * g + [mix['temperature']] * (k - g))


def stratified_pick(r: np.random.Generator, n: int, k: int,
                    must: Sequence[int] = ()) -> List[int]:
    """k distinct indices of range(n), those in `must` first, the rest
    drawn."""
    chosen = list(dict.fromkeys(must))[:k]
    rest = [i for i in r.permutation(n) if i not in chosen]
    return chosen + [int(i) for i in rest[:max(0, k - len(chosen))]]
