"""The port's spans and counters (`evo_tpu_torch/runtime.py`) and the
layers that record them (`serving.py`, `model.py`, `scoring.py`), on the
CPU at the tiny size: on only under a profiler, a new record with each
`runtime.trace` window, parents, threads and request ids, the trace's
clock, the server's span tree and counters against hand arithmetic,
scoring's spans, the CLIs' `--trace-dir`, and outputs bit-identical with
and without a profiler."""

import glob
import json
import os
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from evo_tpu_torch import model as model_lib
from evo_tpu_torch import runtime
from evo_tpu_torch.cli import score as score_cli
from evo_tpu_torch.cli import serve as serve_cli
from evo_tpu_torch.config import tiny_config
from evo_tpu_torch.models import EvoModel
from evo_tpu_torch.scoring import score_sequences_segmented, score_stream
from evo_tpu_torch.serving import GenerationServer
from evo_tpu_torch.tokenizer import CharLevelTokenizer

torch.set_num_threads(2)
TOK = CharLevelTokenizer(512)
STEP_CHILDREN = {'serve.sync', 'serve.fill', 'serve.decode',
                 'serve.readback', 'serve.harvest'}


@pytest.fixture(autouse=True)
def new_record():
    # only runtime.trace restarts the record; each test starts its own
    runtime._restart()


@pytest.fixture(scope='module')
def model():
    cfg = tiny_config()
    return EvoModel(cfg, model_lib.random_init(
        cfg, torch.Generator().manual_seed(0), 'cpu'))


def _ids(text):
    return np.frombuffer(text.encode(), dtype=np.uint8).astype(np.int32)


def _server(model, **kw):
    args = dict(max_slots=4, max_len=64, steps_per_sync=4, prompt_chunk=8,
                seed=3)
    args.update(kw)
    return GenerationServer(model, None, **args)


def _children(spans, parent):
    return [s for s in spans if s.parent is parent]


# -- the record -------------------------------------------------------------

def test_spans_and_counters_record_only_under_a_profiler():
    with profile(activities=[ProfilerActivity.CPU]):
        with runtime.span('on', rid=1):
            runtime.count('c', 2)
    before = (list(runtime.SPANS), dict(runtime.COUNTERS))
    assert [s.name for s in before[0]] == ['on']
    assert before[1] == {'c': 2}
    with runtime.span('off') as sp:
        runtime.count('c', 5)
        runtime.record_span('off.interval', time.time_ns())
    assert sp is None
    assert (runtime.SPANS, runtime.COUNTERS) == before


def test_the_off_path_is_one_shared_no_op():
    first = runtime.span('a', i=1)
    assert first is runtime.span('b') is runtime._OFF
    n = len(runtime.SPANS)
    for i in range(1000):
        with runtime.span('layer.hyena', i=i):
            runtime.count('x')
    assert len(runtime.SPANS) == n and 'x' not in runtime.COUNTERS


def test_a_second_profiled_session_sees_only_its_own(tmp_path):
    # runtime.trace starts a new record; another profiler session adds
    # to the one there is
    with runtime.trace(str(tmp_path / 'a')):
        with runtime.span('first'):
            runtime.count('first')
    with profile(activities=[ProfilerActivity.CPU]):
        with runtime.span('plain'):
            runtime.count('plain')
    assert [s.name for s in runtime.SPANS] == ['first', 'plain']
    with runtime.trace(str(tmp_path / 'b')):
        with runtime.span('second'):
            runtime.count('second', 3)
    assert [s.name for s in runtime.SPANS] == ['second']
    assert runtime.COUNTERS == {'second': 3}


def test_a_span_open_across_sessions_is_dropped(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]):
        outer = runtime.span('across')
        outer.__enter__()
    with runtime.trace(str(tmp_path)):
        outer.__exit__(None, None, None)
        with runtime.span('inside'):
            pass
    assert [s.name for s in runtime.SPANS] == ['inside']


def test_parent_thread_and_rid():
    def worker():
        with runtime.span('worker.outer', rid=7):
            with runtime.span('worker.inner', rid=7):
                time.sleep(0.001)

    with profile(activities=[ProfilerActivity.CPU]):
        with runtime.span('main.outer', rid=3):
            th = threading.Thread(target=worker)
            th.start()
            with runtime.span('main.inner', rid=3):
                time.sleep(0.001)
            th.join()
        runtime.record_span('main.queued', time.time_ns() - 10 ** 6, rid=3)
    by = {s.name: s for s in runtime.SPANS}
    assert set(by) == {'main.outer', 'main.inner', 'worker.outer',
                       'worker.inner', 'main.queued'}
    main, other = threading.get_ident(), by['worker.outer'].thread
    assert other != main
    assert by['main.inner'].parent is by['main.outer']
    assert by['main.outer'].parent is None
    # a thread's spans nest on that thread alone
    assert by['worker.outer'].parent is None
    assert by['worker.inner'].parent is by['worker.outer']
    assert by['worker.inner'].thread == other
    assert by['main.inner'].thread == by['main.outer'].thread == main
    assert by['main.queued'].parent is None
    assert by['main.queued'].end_ns - by['main.queued'].start_ns >= 10 ** 6
    for s in runtime.SPANS:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            assert s.parent.start_ns <= s.start_ns <= s.end_ns \
                <= s.parent.end_ns
    assert {s.attrs['rid'] for s in runtime.SPANS
            if s.name.startswith('main.')} == {3}
    assert {s.attrs['rid'] for s in runtime.SPANS
            if s.name.startswith('worker.')} == {7}


def test_a_span_holds_the_exported_ts_of_an_op_run_inside_it(tmp_path):
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with runtime.span('probe') as sp:
            time.sleep(0.005)
            torch.mm(a, b)
            time.sleep(0.005)
    path = tmp_path / 'trace.json'
    prof.export_chrome_trace(str(path))
    ops = [e for e in json.loads(path.read_text())['traceEvents']
           if e.get('name') == 'aten::mm']
    assert len(ops) == 1
    ts = float(ops[0]['ts'])
    lo, hi = runtime.to_trace_us(sp.start_ns), runtime.to_trace_us(sp.end_ns)
    assert lo <= ts <= ts + float(ops[0]['dur']) <= hi


def test_to_trace_us_is_the_unix_clock_less_the_trimonth():
    t = 1_790_000_000 * 10 ** 9 + 123_456_789
    base = (1_790_000_000 // 7_889_238) * 7_889_238
    assert runtime.to_trace_us(t) == (t - base * 10 ** 9) / 1e3


def test_trace_shows_the_spans_beside_the_operators(tmp_path):
    with runtime.trace(str(tmp_path)):
        with runtime.span('serve.step'):
            torch.randn(32, 32) @ torch.randn(32, 32)
    assert [s.name for s in runtime.SPANS] == ['serve.step']
    text = ''.join(open(f).read() for f in glob.glob(str(tmp_path / '*')))
    assert '"serve.step"' in text and 'aten::mm' in text
    got = json.loads((tmp_path / 'spans.json').read_text())
    assert got['counters'] == {}
    assert list(got['spans']) == ['serve.step']
    assert got['spans']['serve.step']['n'] == 1
    assert got['spans']['serve.step']['ms'] > 0


@pytest.mark.parametrize('cli', ['score', 'serve'])
def test_the_clis_trace_dir_writes_the_trace_and_its_spans(tmp_path, cli):
    out = tmp_path / 'trace'
    if cli == 'score':
        fasta = tmp_path / 'in.fasta'
        fasta.write_text('>a\nACGTACGTAA\n>b\nACG\n')
        score_cli.main(['--tiny', '--device', 'cpu', '--input-fasta',
                        str(fasta), '--output-tsv', str(tmp_path / 'o.tsv'),
                        '--trace-dir', str(out)])
        want = {'score.batch', 'score.prep', 'score.readback',
                'engine.forward', 'layer.hyena', 'layer.attention',
                'layer.mlp'}
        counters = {}
    else:
        reqs = tmp_path / 'reqs.jsonl'
        reqs.write_text('{"prompt": "ACGTACGT", "num_tokens": 4}\n' * 2)
        serve_cli.main(['--tiny', '--device', 'cpu', '--max-slots', '2',
                        '--max-len', '64', '--steps-per-sync', '4',
                        '--requests-jsonl', str(reqs), '--output-jsonl',
                        str(tmp_path / 'out.jsonl'), '--trace-dir', str(out)])
        want = {'serve.step', 'serve.fill', 'serve.decode', 'serve.queued',
                'serve.admit', 'engine.decode_step', 'serve.sample'}
        # the two requests fill as one group of 2 rows, one repeating
        counters = {'serve.fill_rows': 2, 'serve.fill_rows_repeated': 1}
    got = json.loads((out / 'spans.json').read_text())
    assert want <= set(got['spans'])
    assert counters.items() <= got['counters'].items()
    chrome = [f for f in os.listdir(out) if f != 'spans.json']
    assert len(chrome) == 1
    assert f'"{cli}.' in (out / chrome[0]).read_text()


# -- the server ---------------------------------------------------------------

def test_a_server_step_has_the_span_tree(model):
    srv = _server(model, prefill_batch=4)
    prompt = _ids('ACGTACGTACGTAC')
    for temp in (0.0, 0.7):
        srv.submit(input_ids=prompt, num_tokens=6, temperature=temp)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        srv.step()
    sp = runtime.SPANS
    steps = [s for s in sp if s.name == 'serve.step']
    assert len(steps) == 1
    kids = _children(sp, steps[0])
    assert {s.name for s in kids} == STEP_CHILDREN
    assert sum(s.end_ns - s.start_ns for s in kids) <= \
        steps[0].end_ns - steps[0].start_ns
    fill = [s for s in kids if s.name == 'serve.fill']
    assert len(fill) == 1
    assert fill[0].attrs == dict(rows=2, prompt_len=14, rids=[0, 1])
    assert Counter(s.name for s in _children(sp, fill[0])) == Counter(
        {'serve.fill_chunk': 1, 'serve.fill_tail': 1, 'serve.admit': 2})
    admits = [s for s in sp if s.name == 'serve.admit']
    assert [(s.attrs['rid'], s.attrs['prefix']) for s in admits] == [
        (0, False), (1, False)]
    queued = [s for s in sp if s.name == 'serve.queued']
    assert sorted(s.attrs['rid'] for s in queued) == [0, 1]
    assert all(s.parent is None for s in queued)
    fwd = [s for s in sp if s.name == 'engine.forward']
    assert [s.attrs for s in fwd] == [dict(rows=2, len=8, offset=0),
                                      dict(rows=2, len=6, offset=8)]
    decode = [s for s in kids if s.name == 'serve.decode'][0]
    assert Counter(s.name for s in _children(sp, decode)) == Counter(
        {'engine.decode_step': 4, 'serve.sample': 4})
    ds = [s for s in sp if s.name == 'engine.decode_step']
    layers = Counter((s.name, s.attrs['i']) for s in sp
                     if s.parent is ds[0])
    # the tiny model: attention at layer 1, Hyena at 0, 2, 3
    assert layers == Counter({('layer.hyena', 0): 1,
                              ('layer.attention', 1): 1,
                              ('layer.hyena', 2): 1, ('layer.hyena', 3): 1,
                              ('layer.mlp', 0): 1, ('layer.mlp', 1): 1,
                              ('layer.mlp', 2): 1, ('layer.mlp', 3): 1})
    for s in sp:
        if s.parent is not None:
            assert s.parent.start_ns <= s.start_ns <= s.end_ns \
                <= s.parent.end_ns


def test_a_group_of_four_identical_prompts_counts_three_repeated_rows(
        model):
    srv = _server(model, prefill_batch=4)
    prompt = _ids('GATTACAGATTACA')
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        for _ in range(4):
            srv.submit(input_ids=prompt, num_tokens=2)
        srv.step()
    assert runtime.COUNTERS['serve.fill_rows'] == 4
    assert runtime.COUNTERS['serve.fill_rows_repeated'] == 3
    assert runtime.COUNTERS.get('serve.prefix_admissions', 0) == 0


def test_prefix_cache_admissions_are_counted(model):
    srv = _server(model)
    prompt = _ids('CCGGTTAACCGG')
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        srv.submit(input_ids=prompt, num_tokens=2)
        srv.step()
        srv.submit(input_ids=prompt, num_tokens=2)
        srv.step()
    assert runtime.COUNTERS['serve.fill_rows'] == 1
    assert runtime.COUNTERS['serve.fill_rows_repeated'] == 0
    assert runtime.COUNTERS['serve.prefix_admissions'] == 1
    fills = [s for s in runtime.SPANS if s.name == 'serve.fill']
    assert [s.attrs['rows'] for s in fills] == [1, 0]
    assert [(s.attrs['rid'], s.attrs['prefix']) for s in runtime.SPANS
            if s.name == 'serve.admit'] == [(0, False), (1, True)]


def test_wasted_slot_steps_match_hand_arithmetic(model):
    # 4 slots, chunks of 4 steps. Step 1: A (3 tokens) and B (6) are
    # filled and admitted with their first tokens; of the chunk's 16
    # row-steps A keeps 2, B 4, and 2 + 4 + 4 idle are thrown away (10).
    # Step 2: A has ended (4 idle), B keeps 1 and throws 3 away, the two
    # other rows are idle (8): 15.
    srv = _server(model)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        a = srv.submit(input_ids=_ids('ACGTAC'), num_tokens=3)
        b = srv.submit(input_ids=_ids('TTGACCA'), num_tokens=6)
        srv.step()
        assert runtime.COUNTERS['serve.slot_steps'] == 16
        assert runtime.COUNTERS['serve.slot_steps_wasted'] == 10
        srv.step()
    assert runtime.COUNTERS['serve.slot_steps'] == 32
    assert runtime.COUNTERS['serve.slot_steps_wasted'] == 25
    assert len(srv.result(a).token_ids) == 3
    assert len(srv.result(b).token_ids) == 6


def test_tokens_and_logprobs_are_bit_identical_under_a_profiler(model):
    def run(profiled):
        srv = _server(model, prefill_batch=2)
        for i, temp in enumerate((0.0, 0.7, 0.7, 1.0)):
            srv.submit(input_ids=_ids('ACGTTGCA' + 'ACGT'[:i]),
                       num_tokens=5 + 3 * i, temperature=temp, top_k=4)
        srv.submit(input_ids=_ids('ACGTTGCA'), num_tokens=7,
                   temperature=0.7)
        with torch.no_grad():
            if profiled:
                with profile(activities=[ProfilerActivity.CPU]):
                    out = srv.run()
            else:
                out = srv.run()
        return {r: (res.token_ids, res.logps) for r, res in out.items()}

    plain, traced = run(False), run(True)
    assert any(s.name == 'serve.step' for s in runtime.SPANS)
    assert plain.keys() == traced.keys()
    for rid in plain:
        np.testing.assert_array_equal(plain[rid][0], traced[rid][0])
        np.testing.assert_array_equal(plain[rid][1], traced[rid][1])


# -- scoring ------------------------------------------------------------------

def test_score_stream_records_batches_prep_and_padding(model):
    batches = [['ACGTACGTAA', 'ACG'], ['TTTTGGGGCCCCAAAA']]
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        scores = score_stream(batches, model, TOK, prefetch_depth=1)
    assert len(scores) == 3
    sp = runtime.SPANS
    main = threading.get_ident()
    batch = [s for s in sp if s.name == 'score.batch']
    assert [(s.attrs['rows'], s.attrs['len']) for s in batch] == [
        (2, 32), (1, 32)]
    assert all(s.thread == main for s in batch)
    prep = [s for s in sp if s.name == 'score.prep']
    assert len(prep) == 2 and all(s.thread != main for s in prep)
    assert len([s for s in sp if s.name == 'score.readback']) == 2
    assert all(s.parent in batch for s in sp if s.name == 'engine.forward')
    # the rows pad to the 32 bucket (the batches' attrs above); scoring
    # counts nothing
    assert runtime.COUNTERS == {}


def test_segmented_scoring_records_each_segment(model):
    seq = ''.join(np.random.default_rng(0).choice(list('ACGT'), 300))
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        score_sequences_segmented([seq], model, TOK, segment_len=128)
    sp = runtime.SPANS
    segs = [s for s in sp if s.name == 'score.segment']
    # 301 positions: a first segment of 45 + 128 (45 < 64 is merged),
    # then 128
    assert [s.attrs for s in segs] == [dict(index=0, offset=0),
                                       dict(index=1, offset=173)]
    fwd = [s for s in sp if s.name == 'engine.forward']
    assert [(s.parent, s.attrs['len'], s.attrs['offset']) for s in fwd] == [
        (segs[0], 173, 0), (segs[1], 128, 173)]
    assert [s.parent for s in sp if s.name == 'score.readback'] == [None]
    assert runtime.COUNTERS == {}
