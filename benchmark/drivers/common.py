"""Pieces the drivers share: the recording wrapper passed to the
program's scoring entries as its `model`, and the comparisons of the
scores and of the next-token log-probabilities behind them."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from benchmark.reference import striped_hyena


class Recorder:
    """The engine facade as the scoring entries call it, `model(ids, ...)
    -> (logits, cache)`, passed through to the program. It records the
    shape of every call and, while `keep` is set, every row's next-token
    log-probabilities as the call's logits give them (a log-softmax and a
    gather on the device; nothing is read back) and the last position's
    log-softmax, which scores the next segment's first token."""

    def __init__(self, model):
        self.model = model
        self.config = model.config
        self.shapes: List[tuple] = []
        self.keep = False
        self.kept: List[tuple] = []

    def initialize_inference_params(self, batch_size, max_len, **kw):
        return self.model.initialize_inference_params(batch_size, max_len,
                                                      **kw)

    def __call__(self, input_ids, **kw):
        logits, cache = self.model(input_ids, **kw)
        self.shapes.append(tuple(np.shape(input_ids)))
        if self.keep:
            # the operations and shapes of `scoring.logits_to_logprobs`
            # as the entries call it, so that the values are the ones the
            # program reduces to its scores, bit for bit
            ids = torch.as_tensor(np.asarray(input_ids),
                                  device=logits.device).long()
            lp = torch.log_softmax(logits.float(), dim=-1)
            last = torch.log_softmax(logits[:, -1:].float(), dim=-1)
            self.kept.append((lp[:, :-1].gather(-1, ids[:, 1:, None])[..., 0],
                              last[:, 0]))
        return logits, cache


def token_ids(seq: str, bos: bool = True) -> torch.Tensor:
    ids = np.frombuffer(seq.encode(), dtype=np.uint8).astype(np.int64)
    if bos:
        ids = np.concatenate([[0], ids])
    return torch.from_numpy(ids)


def joined_logprobs(pieces, ids: torch.Tensor) -> torch.Tensor:
    """The next-token log-probabilities of a sequence from its segments'
    records (`Recorder.kept` of one-row calls, in order): within each
    segment, then the previous segment's last position scoring the next
    one's first token."""
    out, at = [], 0
    prev_last = None
    for within, last in pieces:
        n = within.shape[1] + 1
        if prev_last is not None:
            out.append(prev_last[0, ids[at]].reshape(1))
        out.append(within[0])
        prev_last = last
        at += n
    return torch.cat(out)


def score_logp_gap(seq: str, score: float, got: np.ndarray) -> float:
    """|the program's score - the mean of the sequence's log-probabilities
    `got` (float32, on the host) as the program reduces them (numpy's
    float32 mean)|. `got` holds the values the program's logits give,
    which `logprob_gaps` holds against the reference, so this reads 0
    unless the program's trim, padding mask, seams or reduction part from
    it."""
    return abs(score - float(np.mean(got[:len(seq)])))


def logprob_gaps(sd, cfg: dict, seq: str, got: torch.Tensor,
                 got_score: float) -> dict:
    """The program's next-token log-probabilities `got` over the
    sequence's nucleotides and its score against the reference: the
    widest and the mean |log p| gap, and the score's gap to the mean of
    the reference's."""
    ids = token_ids(seq).to(got.device)
    want = striped_hyena.next_token_logprobs(sd, cfg, ids)
    n = len(seq)
    gap = (got[:n].float() - want[:n]).abs()
    return dict(logp_gap=float(gap.max()), logp_mean_gap=float(gap.mean()),
                score_gap=abs(got_score - float(want[:n].double().mean())))


def strata_pick(r: np.random.Generator, positions: Sequence[int],
                strata: int, must: int) -> List[int]:
    """One index a stratum of the positions a sequence held in its batch
    (`strata` equal runs of positions), `must` the one of its stratum and
    the others drawn: a path that leaves out part of a batch always has a
    compared row among the rows it left out."""
    width = max(positions) + 1
    bands = np.array_split(np.arange(width), min(strata, width))
    chosen = []
    for band in bands:
        members = [i for i, p in enumerate(positions) if p in band]
        if must in members:
            chosen.append(must)
        elif members:
            chosen.append(members[int(r.integers(0, len(members)))])
    return chosen


def worst(gaps, limits: dict) -> list:
    """(name, the largest reading over the compared sequences, limit) of
    every number `limits` holds a limit for."""
    return [(k, max(g[k] for g in gaps), limits[k]) for k in gaps[0]
            if k in limits]


def own_checks(seqs: Sequence[str], scores: Sequence[float],
               logps: Sequence[np.ndarray], limits: dict) -> list:
    """`score_logp_gap` of every sequence of the window, the largest."""
    if 'score_logp_gap' not in limits or not seqs:
        return []
    return [('score_logp_gap',
             max(score_logp_gap(s, x, lp)
                 for s, x, lp in zip(seqs, scores, logps)),
             limits['score_logp_gap'])]

