"""The drivers' shared comparisons: which rows of a window are held
against the reference, and a score against its own log-probabilities."""

import numpy as np
import pytest
import torch

from benchmark.drivers.common import (joined_logprobs, own_checks,
                                      score_logp_gap, strata_pick)
from benchmark.generator import rng


@pytest.mark.parametrize('seed', [1, 2 ** 33 + 7, 12345])
@pytest.mark.parametrize('width,strata', [(8, 4), (4, 4), (8, 2), (3, 4)])
def test_one_compared_row_from_each_stratum_of_batch_positions(
        seed, width, strata):
    positions = [p for _ in range(5) for p in range(width)]
    must = int(rng(seed, 9).integers(0, len(positions)))
    chosen = strata_pick(rng(seed, 4), positions, strata, must)
    assert must in chosen and len(set(chosen)) == len(chosen)
    bands = np.array_split(np.arange(width), min(strata, width))
    assert len(chosen) == len(bands)
    for band in bands:
        assert sum(positions[i] in band for i in chosen) == 1
    # so a path that drops the upper half of every batch is always seen
    assert any(positions[i] >= width // 2 for i in chosen)


def test_a_score_reduced_over_other_positions_reads_far_above_rounding():
    r = rng(3, 1)
    seq = 'ACGT' * 500
    lp = (-3 * r.random(len(seq) + 40)).astype(np.float32)
    batch = np.stack([lp, lp[::-1]])      # a row of a batch, as scored
    score = float(np.mean(batch[0][:len(seq)]))
    assert score_logp_gap(seq, score, lp.copy()) == 0.0
    one_more = float(np.mean(batch[0][:len(seq) + 1]))
    assert score_logp_gap(seq, one_more, lp) > 1e-5
    limits = {'score_logp_gap': 1e-6}
    [(name, value, limit)] = own_checks([seq, seq], [score, one_more],
                                        [lp, lp], limits)
    assert name == 'score_logp_gap' and value > limit
    assert own_checks([seq], [score], [lp], {}) == []


def test_joined_logprobs_pair_each_seam_with_the_previous_segment():
    V = 8
    ids = torch.tensor([0, 3, 5, 1, 2, 7, 4])
    logp = torch.log_softmax(torch.randn(len(ids), V), -1)
    want = logp[torch.arange(len(ids) - 1), ids[1:]]
    pieces, at = [], 0
    for n in (3, 2, 2):
        seg = logp[at:at + n]
        within = seg[:-1].gather(-1, ids[at + 1:at + n, None])[:, 0]
        pieces.append((within[None], seg[-1:]))
        at += n
    assert torch.equal(joined_logprobs(pieces, ids), want)
