"""Batch scoring as the score CLI calls it: `scoring.score_stream` over
batches of the mix (`pad_to_bucket`, `prefetch_depth`), the recording
wrapper as its model. The window hands batches to the entry until the
time is up; the rate is the scored nucleotides of every batch the call
completed over the time to complete them."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import generator, roofline
from benchmark.drivers.common import (Recorder, logprob_gaps, own_checks,
                                      strata_pick, worst)
from evo_tpu_torch.scoring import score_stream
from evo_tpu_torch.tokenizer import CharLevelTokenizer


class State:
    def __init__(self, model, mix, seed):
        self.rec = Recorder(model)
        self.mix = mix
        self.tok = CharLevelTokenizer(512)
        self.batches = generator.score_batches(seed, mix)
        self.handed, self.scores = [], []


def _score(st: State, batches, record: bool):
    """score_stream over `batches`; with `record`, every row keeps its
    log-probabilities for the check."""
    handed = []

    def feed():
        for b in batches:
            handed.append(b)
            yield b

    st.rec.keep = record
    scores = score_stream(feed(), st.rec, st.tok,
                          pad_to_bucket=st.mix['pad_to_bucket'],
                          prefetch_depth=st.mix['prefetch_depth'])
    st.rec.keep = False
    return handed, scores


def setup(ctx, model):
    st = State(model, ctx.cell.traffic, ctx.seed)
    warm = generator.score_batches(ctx.seed, ctx.cell.traffic, stream=1)
    with torch.no_grad():
        _score(st, [next(warm)], record=False)
    st.rec.shapes.clear()
    return st


def window(ctx, st: State, seconds: float) -> dict:
    t0 = time.perf_counter()

    def timed():
        while time.perf_counter() - t0 < seconds:
            yield next(st.batches)

    with torch.no_grad():
        handed, scores = _score(st, timed(), record=True)
    ctx.sync()
    elapsed = time.perf_counter() - t0
    st.handed, st.scores = handed, scores
    lengths = [len(s) for b in handed for s in b]
    shapes = list(st.rec.shapes)
    positions = sum(b * n for b, n in shapes)
    return dict(window_s=elapsed, batches=len(handed),
                attempted=len(lengths),
                failed=int(sum(not np.isfinite(x) for x in scores)),
                scored_nt=sum(lengths),
                handed_positions=positions,
                pad_positions=positions - sum(n + 1 for n in lengths),
                model_flops=sum(roofline.sequence_flops(
                    ctx.model_cfg, n, start=1) for n in lengths))


def traced(ctx, st: State) -> dict:
    n = ctx.cell.traffic['traced_batches']
    st.rec.shapes.clear()
    with torch.no_grad():
        handed, _ = _score(st, [next(st.batches) for _ in range(n)],
                           record=False)
    return dict(forwards=list(st.rec.shapes),
                scored_nt=sum(len(s) for b in handed for s in b))


def release(st: State) -> dict:
    """Every sequence of the window: (sequence, its score, its
    log-probabilities on the host, in the (batch, position) array the
    program reduces rows of, its position in its batch)."""
    scores = iter(st.scores)
    kept = [(seq, next(scores), host[r], r)
            for batch, host in zip(st.handed, (lp.cpu().numpy()
                                               for lp, _ in st.rec.kept))
            for r, seq in enumerate(batch)]
    st.rec.model = None
    return dict(kept=kept)


def check(ctx, kept: dict, sd) -> list:
    """Every sequence's score against its log-probabilities; then the
    log-probabilities and the scores of `sequences` of them, one from
    each stratum of batch positions, the longest among them, against the
    reference (none where `sd` is None)."""
    rows = kept['kept']
    lim = ctx.cell.limits
    out = own_checks([s for s, _, _, _ in rows], [x for _, x, _, _ in rows],
                     [lp for _, _, lp, _ in rows], lim)
    if sd is None:
        return out
    dev = next(iter(sd.values())).device
    longest = max(range(len(rows)), key=lambda i: len(rows[i][0]))
    chosen = strata_pick(generator.rng(ctx.seed, 4),
                         [p for _, _, _, p in rows], lim['sequences'],
                         must=longest)
    gaps = [logprob_gaps(sd, ctx.model_cfg, rows[i][0],
                         torch.from_numpy(rows[i][2]).to(dev), rows[i][1])
            for i in chosen]
    return worst(gaps, lim) + out
