"""The comparison that decides `correct` fails what it must, at the tiny
size on the CPU with the cells' own limits:

* the control, the program's own lower precision (int8 weights and
  int8 activations, `weight_quant='int8'`, `act_quant='int8'`, below the
  configuration's bf16): it reads several times the program's gaps on
  every cell;
* a run with the timed path broken underneath, once for each fault the
  cell can have: an answer altered where it is produced (a logit moved
  in the unembedding), half of the batch left out (its rows given the
  other half's logits), a step that returns its state unchanged (the
  decode step's, or a resumed segment's, Hyena state), and a score
  reduced over the wrong positions (a position of padding counted, the
  seams' tokens left out). No cell spans chips, so none can leave out an
  exchange between them.
"""

import pytest
import torch

from benchmark.readings import pad_counted, seams_left_out
from benchmark.tests.tiny import CELLS, TRAFFIC, run
from evo_tpu_torch import model as model_lib
from evo_tpu_torch import models


WIDE = dict(hidden_size=1024, num_filters=1024, num_attention_heads=8)
# many seams, so that a state carried wrong shows
SEAMS = {'score-131k-segmented': dict(seq_len=1023, segment_len=64)}


# the numbers that compare with the reference (`score_logp_gap` holds a
# score against the program's own log-probabilities, which the control
# keeps consistent)
OWN = ('weights_redrawn', 'uncompared', 'score_logp_gap')


def _numbers(r):
    return {k: v['value'] for k, v in r['checks'].items() if k not in OWN}


@pytest.mark.parametrize('cell', CELLS)
def test_control_reads_several_times_the_program(cell):
    good = _numbers(run(cell))
    low = _numbers(run(cell, overrides=dict(weight_quant='int8',
                                            act_quant='int8')))
    for name, value in good.items():
        assert low[name] > 3 * max(value, 1e-6), (name, value, low[name])


def _altered_answer(monkeypatch):
    unembed = model_lib._unembed

    def altered(model, x):
        logits = unembed(model, x)
        logits[..., 65] += 4.0          # the answer for 'A', everywhere
        return logits
    monkeypatch.setattr(model_lib, '_unembed', altered)


def _half_batch(monkeypatch):
    call = models.EvoModel.__call__

    def half(self, input_ids, inference_params_dict=None, **kw):
        if inference_params_dict is not None:
            return call(self, input_ids, inference_params_dict, **kw)
        ids = torch.as_tensor(input_ids)
        h = max(1, ids.shape[0] // 2)
        logits, _ = call(self, ids[:h])
        # the rows left out come back as zeros
        return torch.cat([logits, logits.new_zeros(
            (ids.shape[0] - h,) + logits.shape[1:])]), None
    monkeypatch.setattr(models.EvoModel, '__call__', half)


def _state_unchanged(monkeypatch):
    step = model_lib.decode_step
    hyena_full = model_lib.hyena_full

    def frozen_step(module, token, cache):
        kept = {i: st for i, st in enumerate(cache['layers'])
                if isinstance(st, model_lib.HyenaState)}
        kept = {i: model_lib.HyenaState(st.fir.clone(), st.iir.clone())
                for i, st in kept.items()}
        logits, cache = step(module, token, cache)
        for i, st in kept.items():
            cache['layers'][i] = st
        return logits, cache

    def frozen_segment(p, cfg, x, *, state=None, **kw):
        out, new = hyena_full(p, cfg, x, state=state, **kw)
        return out, (state if state is not None else new)
    monkeypatch.setattr(model_lib, 'decode_step', frozen_step)
    monkeypatch.setattr(model_lib, 'hyena_full', frozen_segment)


def _pad_counted(monkeypatch):
    pad_counted(monkeypatch.setattr)


def _seams_left_out(monkeypatch):
    seams_left_out(monkeypatch.setattr)


FAULTS = {
    'score-8k-mixed': [_altered_answer, _half_batch, _pad_counted],
    'serve-8k-design': [_altered_answer, _state_unchanged],
    'score-131k-segmented': [_altered_answer, _state_unchanged,
                             _seams_left_out],
}


@pytest.mark.parametrize('cell,fault', [(c, f) for c in CELLS
                                        for f in FAULTS[c]],
                         ids=lambda x: getattr(x, '__name__', x))
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    # at a width whose logits are as far from flat as a deployment's,
    # so that a broken row reads as one
    traffic = dict(TRAFFIC[cell], **SEAMS.get(cell, {}))
    assert run(cell, overrides=WIDE, traffic=traffic)['correct']
    fault(monkeypatch)
    r = run(cell, overrides=WIDE, traffic=traffic)
    assert not r['correct'], r['checks']
