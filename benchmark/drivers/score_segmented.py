"""Long-sequence scoring: `scoring.score_sequences_segmented` over the
mix's sequences, one call a sequence, back to back, the recording
wrapper as its model. The rate is the nucleotides of every sequence
completed over the time to complete them."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import generator, roofline
from benchmark.drivers.common import (Recorder, joined_logprobs, logprob_gaps,
                                      own_checks, token_ids, worst)
from evo_tpu_torch.scoring import score_sequences_segmented
from evo_tpu_torch.tokenizer import CharLevelTokenizer


class State:
    def __init__(self, model, mix, seed):
        self.rec = Recorder(model)
        self.mix = mix
        self.tok = CharLevelTokenizer(512)
        self.seqs = generator.long_sequences(seed, mix)
        self.done = []          # (sequence, score, its segments' records)


def _one(st: State, seq: str, record: bool) -> float:
    st.rec.keep = record
    st.rec.kept = []
    with torch.no_grad():
        score = score_sequences_segmented(
            [seq], st.rec, st.tok, segment_len=st.mix['segment_len'])[0]
    if record:
        st.done.append((seq, score, st.rec.kept))
    st.rec.keep = False
    return score


def setup(ctx, model):
    mix = ctx.cell.traffic
    st = State(model, mix, ctx.seed)
    # a fresh segment and a resumed one: every shape of the window
    warm = generator.long_sequences(ctx.seed, dict(
        mix, seq_len=2 * mix['segment_len'] - 1), stream=1)
    _one(st, next(warm), record=False)
    st.rec.shapes.clear()
    return st


def window(ctx, st: State, seconds: float) -> dict:
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        _one(st, next(st.seqs), record=True)
    ctx.sync()
    elapsed = time.perf_counter() - t0
    lengths = [len(s) for s, _, _ in st.done]
    return dict(window_s=elapsed, attempted=len(st.done),
                failed=int(sum(not np.isfinite(x) for _, x, _ in st.done)),
                scored_nt=sum(lengths),
                model_flops=sum(roofline.sequence_flops(
                    ctx.model_cfg, n, start=1) for n in lengths))


def traced(ctx, st: State) -> dict:
    st.rec.shapes.clear()
    seq = next(st.seqs)
    _one(st, seq, record=False)
    # every call is one segment of one row, at the offset where the
    # previous segments of its sequence end
    segments, at = [], 0
    for _, length in st.rec.shapes:
        segments.append((length, at))
        at += length
    return dict(segments=segments, scored_nt=len(seq),
                forwards=list(st.rec.shapes))


def release(st: State) -> dict:
    st.rec.model = None
    return dict(done=st.done)


def check(ctx, kept: dict, sd) -> list:
    """Every sequence's score against its log-probabilities joined across
    the seams; then the log-probabilities and the score of `sequences` of
    them, drawn from the seed, against the reference (none where `sd` is
    None)."""
    done = kept['done']
    lim = ctx.cell.limits
    joined = [joined_logprobs(pieces, token_ids(seq).to(pieces[0][0].device))
              for seq, _, pieces in done]
    out = own_checks([s for s, _, _ in done], [x for _, x, _ in done],
                     [j.cpu().numpy() for j in joined], lim)
    if sd is None:
        return out
    pick = generator.rng(ctx.seed, 5)
    chosen = generator.stratified_pick(pick, len(done), lim['sequences'])
    gaps = [logprob_gaps(sd, ctx.model_cfg, done[i][0], joined[i],
                         done[i][1]) for i in chosen]
    return worst(gaps, lim) + out
