"""The generator: each mix is the same for the same seed, another order
for another seed, with the same sizes, inside the mix's ranges."""

import itertools
import json
import os

import pytest

from benchmark import generator, harness


def _mix(name):
    with open(os.path.join(harness.HERE, 'traffic', name + '.json')) as f:
        return json.load(f)


SEEDS = [0, 7, 2 ** 31 + 3, 2 ** 62 + 11]


@pytest.mark.parametrize('seed', SEEDS)
def test_score_batches_are_stratified_and_seeded(seed):
    mix = _mix('batch-mixed')
    a = list(itertools.islice(generator.score_batches(seed, mix), 5))
    b = list(itertools.islice(generator.score_batches(seed, mix), 5))
    assert a == b
    want = sorted(generator.quantiles(mix['min_len'], mix['max_len'],
                                      mix['batch_size']))
    for batch in a:
        assert len(batch) == mix['batch_size']
        assert sorted(len(s) for s in batch) == want
        assert all(set(s) <= set('ACGT') for s in batch)
    # with BOS the longest fits the 8,192 bucket
    assert max(want) + 1 <= 8192 and min(want) >= mix['min_len']


def test_another_seed_another_draw_of_the_same_sizes():
    mix = _mix('batch-mixed')
    a = next(generator.score_batches(1, mix))
    b = next(generator.score_batches(2, mix))
    assert a != b
    assert sorted(map(len, a)) == sorted(map(len, b))


@pytest.mark.parametrize('seed', SEEDS)
def test_design_groups(seed):
    mix = _mix('design')
    t1, t2 = generator.DesignTraffic(seed, mix), generator.DesignTraffic(
        seed, mix)
    groups = [t1.next_group() for _ in range(3 * mix['cycle'])]
    assert groups == [t2.next_group() for _ in range(3 * mix['cycle'])]
    lo, hi = mix['prompt_len']
    for i, g in enumerate(groups):
        assert lo <= len(g['prompt']) <= hi
        assert g['temperatures'] == [0.0] * mix['greedy_per_prompt'] + [
            mix['temperature']] * (mix['samples_per_prompt']
                                   - mix['greedy_per_prompt'])
        if i >= mix['clients']:
            assert mix['output_len'][0] <= g['num_tokens'] <= \
                mix['output_len'][1]
        else:                                     # the first wave
            assert 1 <= g['num_tokens'] <= mix['output_len'][1]
        assert len(g['prompt']) + g['num_tokens'] <= mix['max_len']
    # each cycle after the first holds the same stratified sizes
    for c in (1, 2):
        cyc = groups[c * mix['cycle']:(c + 1) * mix['cycle']]
        assert sorted(len(g['prompt']) for g in cyc) == sorted(
            generator.quantiles(lo, hi, mix['cycle']))


@pytest.mark.parametrize('seed', SEEDS)
def test_long_sequences(seed):
    mix = _mix('genome-segmented')
    a = next(generator.long_sequences(seed, mix))
    assert a == next(generator.long_sequences(seed, mix))
    assert len(a) == mix['seq_len'] and set(a) <= set('ACGT')
    assert (len(a) + 1) % mix['segment_len'] == 0


def test_quantiles_are_log_uniform_strata():
    assert generator.quantiles(1, 100, 1) == [10]
    q = generator.quantiles(1024, 8191, 8)
    assert q == sorted(q) and q[0] > 1024 and q[-1] < 8191
    ratios = [b / a for a, b in zip(q, q[1:])]
    assert max(ratios) - min(ratios) < 0.01
