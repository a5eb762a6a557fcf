"""Greedy and sampled n-gram speculative decoding (prompt lookup), port of
`evo_tpu/speculative.py`.

A host-side n-gram index proposes the `gamma` tokens that followed the
last earlier occurrence of the current suffix, and one resumed prefill
over [last token, p_1..p_gamma] scores them all. Greedy acceptance is
exact in exact arithmetic: the emitted stream is the one ordinary greedy
decoding gives, and only the number of device passes changes. In float32
on the CPU it is token for token that stream. In bf16 on the card a
verify pass of gamma + 1 rows rounds apart from a decode step, so the two
streams part at near-ties of the logits; each still takes the argmax of
the logits it read, within rounding of one forward (teacher forcing).

On the card a decode step is bound by the host's launches (about 1,345
kernels a bf16 step), and a verify pass of gamma + 1 positions costs one
launch sequence, so every accepted token saves one.

Genomic sequences are the friendly case: generated phage genomes and
tandem repeats are highly self-similar. On sequence that does not repeat,
acceptance falls to ~0 and each token costs a verify pass plus a replay.
Strictly opt-in (`python -m evo_tpu_torch.cli.generate --speculative`).

The host parts (`NGramIndex`, `filtered_probs`, `accept_or_resample`) are
the JAX package's numpy code, so the same inputs give the same results,
and sampling draws from `np.random.default_rng(seed)` as there: a seeded
stream can be compared token for token with the JAX package's.

Cache discipline (what keeps it exact): Hyena's modal state is a running
recurrence with no rollback, and the engine updates a cache in place
whether or not it is donated. Before each verify pass the offset and a
shallow copy of the cache's layer list are saved. The verify pass
replaces every Hyena layer's `HyenaState` with new tensors (no path
writes one in place) and writes KV rows [offset, offset + gamma + 1) in
place. Full acceptance keeps the verified cache; partial acceptance puts
back the saved offset and states and replays the accepted prefix. KV rows
past the restored offset are stale, masked by causality, and written over
by the next pass; the KV buffers are never copied.

Under a mesh (`parallel/`) every rank calls `generate_speculative` with
the same arguments. The verify passes and replays are resumed prefills
through the engine facade, which runs them on the rank's shards (under
cp padded to a multiple of cp, in the Ulysses layout); the offset and
layer list saved before a pass are the rank's own. The host decisions
(acceptance, the correction, every draw of the seeded numpy generator)
are taken on every rank from the same logits, which the facade returns
whole and bit-equal on every rank, so the ranks emit the same stream
with no collective of their own.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


class NGramIndex:
    """Longest-match last-occurrence index over the emitted stream.

    Proposals continue the latest earlier occurrence of the LONGEST
    matching suffix, trying gram lengths n, n-1, ... n_min (n_min == n
    recovers single-length behaviour). Longest match matters on a
    4-letter alphabet: there are only 4^k distinct k-mers, so a trailing
    3-mer recurs every ~32 nt of random DNA and its most recent match is
    rarely the self-similar region the proposal should copy from.
    O(n - n_min) amortized update per token, O(n - n_min) proposal. The
    n-gram dicts are bounded by the sliding `window`; the raw token list
    grows with the stream (one int a token: the index stores absolute
    positions into it).
    """

    def __init__(self, n: int = 12, n_min: Optional[int] = None,
                 window: int = 32768):
        self.n = n
        self.n_min = n if n_min is None else n_min
        assert 1 <= self.n_min <= self.n
        self.tokens: List[int] = []
        self._index: Dict[int, Dict[int, int]] = {
            k: {} for k in range(self.n_min, self.n + 1)}
        self._indexed_upto = 0      # grams ending strictly before this
        # the index is rebuilt over the trailing `window` positions
        # whenever the indexed span exceeds 2 * window (a bulk clear:
        # O(1) a token amortized, <= 2 * window entries a dict). Matches
        # farther back only lose draft quality; verify keeps the output
        # exact.
        self.window = max(int(window), 4 * self.n)
        self._index_base = 0        # oldest position with indexed grams

    @staticmethod
    def _key(toks: List[int], end: int, k: int) -> int:
        """Pack the k-gram ending at `end` (inclusive) into one int (10
        bits a token: ids >= 1024 alias, which at worst gives a bad draft
        that verify rejects)."""
        key = 0
        for i in range(end - k + 1, end + 1):
            key = (key << 10) | (toks[i] & 0x3FF)
        return key

    def extend(self, toks) -> None:
        self.tokens.extend(int(t) for t in toks)

    def _catch_up(self) -> None:
        """Index every gram ending at position < len-1 (the trailing gram
        is the query; indexing it would always match itself)."""
        end = len(self.tokens) - 1
        toks = self.tokens
        if end - self._index_base > 2 * self.window:
            for idx in self._index.values():
                idx.clear()
            self._index_base = self._indexed_upto = end - self.window
        for k, idx in self._index.items():
            start = max(self._indexed_upto, self._index_base + k - 1, k - 1)
            for i in range(start, end):
                idx[self._key(toks, i, k)] = i
        self._indexed_upto = max(self._indexed_upto, end)

    def propose(self, gamma: int) -> np.ndarray:
        """gamma proposed continuations of the current stream."""
        toks = self.tokens
        if len(toks) >= self.n_min:
            self._catch_up()
            for k in range(min(self.n, len(toks)), self.n_min - 1, -1):
                j = self._index[k].get(self._key(toks, len(toks) - 1, k))
                if j is None:
                    continue
                cont = toks[j + 1:j + 1 + gamma]
                if len(cont) < gamma:      # near the end: cycle the match
                    cont = (cont + toks[j + 1:])[:gamma]
                if len(cont) == gamma:
                    return np.asarray(cont, np.int32)
        # no match: repeat the last token (free to be wrong: one
        # mispredicted run costs the same as no speculation)
        last = toks[-1] if toks else 0
        return np.full((gamma,), last, np.int32)


def filtered_probs(logits_row: np.ndarray, temperature: float,
                   top_k: int, top_p: float) -> np.ndarray:
    """The sampling target distribution for one (V,) logits row, in
    float64 on the host: temperature, top-k, then the nucleus with the top
    token always kept (the semantics of `ops/sampling.py`)."""
    z = logits_row.astype(np.float64) / max(temperature, 1e-6)
    if 0 < top_k < z.size:
        kth = np.partition(z, -top_k)[-top_k]
        z = np.where(z < kth, -np.inf, z)
    if top_p < 1.0:
        order = np.argsort(z)[::-1]
        zs = z[order]
        ps = np.exp(zs - zs.max())
        ps = ps / ps.sum()
        cum = np.cumsum(ps)
        keep = (cum - ps) < top_p
        keep[0] = True
        kth = zs[keep][-1]
        z = np.where(z < kth, -np.inf, z)
    z = z - z.max()
    p = np.exp(z)
    return p / p.sum()


def accept_or_resample(rng: np.random.Generator, p: np.ndarray,
                       proposal: int):
    """Point-draft speculative sampling step: accept `proposal` with
    probability p[proposal]; on rejection draw from the residual (p with
    the proposal zeroed, renormalized). The emitted token is exactly
    p-distributed:
        P(j) = p[x][j==x] + (1 - p[x]) * p[j] * [j!=x] / (1 - p[x]).
    Returns (accepted, token)."""
    px = float(p[proposal])
    if rng.random() < px:
        return True, int(proposal)
    residual = p.copy()
    residual[proposal] = 0.0
    total = residual.sum()
    if total <= 0.0:          # p was a point mass at the proposal
        return True, int(proposal)
    return False, int(rng.choice(p.size, p=residual / total))


@dataclasses.dataclass
class SpecStats:
    cycles: int = 0
    proposed: int = 0
    accepted: int = 0
    device_calls: int = 0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / max(self.proposed, 1)

    @property
    def tokens_per_call(self) -> float:
        return (self.accepted + self.cycles) / max(self.device_calls, 1)


def _row_logp(row: np.ndarray, tok: int) -> float:
    """log softmax(row)[tok] in the row's float32, as the JAX package
    computes it on the host."""
    m = row.max()
    return float(row[tok] - m - np.log(np.sum(np.exp(row - m))))


def generate_speculative(
    model,
    tokenizer=None,
    prompt: Optional[str] = None,
    input_ids=None,
    num_tokens: int = 100,
    gamma: int = 8,
    ngram: int = 12,
    ngram_min: int = 4,
    max_len: Optional[int] = None,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    seed: int = 0,
) -> Tuple[np.ndarray, List[float], SpecStats]:
    """Generation with n-gram speculation (module docstring), at B=1 on
    the model's device.

    temperature <= 0: greedy, the stream of ordinary greedy decoding
    (token for token in float32; in bf16 within rounding, module
    docstring). temperature > 0: exact speculative sampling with a
    point-mass draft: proposal x is accepted with probability p(x) under
    the temperature / top-k / top-p filtered target distribution, and on
    rejection the correction is drawn from the residual, so every emitted
    token is distributed as ordinary autoregressive sampling gives it.

    The cache holds `max_len` positions, by default P + num_tokens +
    gamma + 2 as in the JAX package: the kernels take a buffer of any
    length, int8 KV included (their scales are read one float at a time).

    Engine calls: one fresh prefill of the prompt; per cycle a verify
    pass, a resumed prefill of gamma + 1 positions, whose logits are read
    back once as float32; on partial acceptance a replay of the accepted
    a + 1 positions from the state saved before the verify pass, donated,
    so a replay of one position takes the prefill route as in the JAX
    package.

    Returns (token ids (num_tokens,) int32, per-token log-probs under the
    UNFILTERED distribution, SpecStats).
    """
    if input_ids is None:
        if prompt is None or tokenizer is None:
            raise ValueError('pass input_ids= or prompt= with a tokenizer')
        input_ids = tokenizer.tokenize(prompt)
    ids = np.asarray(input_ids, np.int32).reshape(1, -1)
    P = ids.shape[1]
    if P == 0:
        raise ValueError('empty prompt')
    if num_tokens < 1:
        raise ValueError('num_tokens must be >= 1')
    if gamma < 1:
        raise ValueError('gamma must be >= 1')
    T = max_len or (P + num_tokens + gamma + 2)

    stats = SpecStats()
    spec = NGramIndex(ngram, n_min=min(ngram, ngram_min))
    spec.extend(ids[0])
    greedy_mode = temperature <= 0.0
    rng = np.random.default_rng(seed)

    def choose(lg_row: np.ndarray) -> int:
        """Sample or argmax the target distribution of one logits row."""
        if greedy_mode:
            return int(lg_row.argmax())
        p = filtered_probs(lg_row, temperature, top_k, top_p)
        return int(rng.choice(p.size, p=p))

    cache = model.initialize_inference_params(1, T)
    logits, cache = model(ids, inference_params_dict=cache,
                          donate_cache=True, resume=False)
    stats.device_calls += 1
    row0 = logits[0, -1].float().cpu().numpy()
    t_last = choose(row0)
    out: List[int] = [t_last]
    logps: List[float] = [_row_logp(row0, t_last)]
    spec.extend([t_last])

    while len(out) < num_tokens:
        props = spec.propose(gamma)
        x = np.concatenate([[t_last], props])[None]          # (1, g+1)
        # the state the verify pass replaces: the offset and the layer
        # list (Hyena states are swapped for new tensors, KV rows past
        # the offset are written in place and stay masked once it is put
        # back)
        saved_offset, saved_layers = cache['offset'], list(cache['layers'])
        logits, cache = model(x, inference_params_dict=cache,
                              donate_cache=False, resume=True)
        stats.device_calls += 1
        stats.cycles += 1
        stats.proposed += gamma
        lg = logits[0].float().cpu().numpy()                 # (g+1, V)
        if greedy_mode:
            greedy = lg.argmax(axis=-1).astype(np.int32)
            a = 0
            while a < gamma and props[a] == greedy[a]:
                a += 1
            correction = int(greedy[a])
        else:
            a = 0
            correction = None
            while a < gamma:
                p = filtered_probs(lg[a], temperature, top_k, top_p)
                ok, tok = accept_or_resample(rng, p, int(props[a]))
                if not ok:
                    correction = tok
                    break
                a += 1
            if correction is None:            # all gamma accepted: bonus
                correction = choose(lg[gamma])
        stats.accepted += a
        # emitted this cycle: the accepted run and the correction or
        # bonus token; log-probs under the unfiltered row i
        emitted = [int(t) for t in props[:a]] + [correction]
        logps.extend(_row_logp(lg[i], tok) for i, tok in enumerate(emitted))
        out.extend(emitted)
        spec.extend(emitted)
        t_last = correction
        if a < gamma:
            # back to the state before the verify pass, then replay the
            # accepted prefix of its inputs ([old last token, accepted
            # proposals])
            cache['offset'], cache['layers'] = saved_offset, saved_layers
            _, cache = model(x[:, :a + 1], inference_params_dict=cache,
                             donate_cache=True, resume=True)
            stats.device_calls += 1
    return (np.asarray(out[:num_tokens], np.int32), logps[:num_tokens],
            stats)
