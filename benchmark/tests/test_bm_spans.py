"""The readers of the program's spans and counters (`spans.py` and the
metric files that use it): on a synthetic trace and spans with known
answers (the idle time by span, with the rest, sums to `idle_share`),
against a program without spans (every reader None, none raises), with
an earlier profiled session's spans left out of the window, and in CPU
rehearsals of the traced serving and 8k cells, where every new
host-clock and counter metric reads a value."""

import types

import pytest

from benchmark import harness, readers, spans
from benchmark.harness import Record
from benchmark.trace import Kernel, Trace
from benchmark.tests.tiny import run
from evo_tpu_torch import runtime

NEW_GEN_HOST = ['serve.decode_launch_ms', 'serve.readback_wait_ms',
                'serve.harvest_ms', 'hyena.decode_host_ms', 'serve.sample_ms',
                'serve.wasted_slot_share']
NEW_GEN = NEW_GEN_HOST + ['idle_share.gen.decode', 'idle_share.gen.harvest',
                          'idle_share.gen.outside']
NEW_SCORE = ['idle_share.score.engine', 'idle_share.score.outside']
LABELS = ('decode', 'fill', 'harvest', 'outside')
T0 = 1_790_000_000 * 10 ** 9          # a time.time_ns() reading
MAIN = __import__('threading').main_thread().ident


def _span(name, a_ms, b_ms, parent=None, thread=MAIN, **attrs):
    return types.SimpleNamespace(
        name=name, parent=parent, thread=thread, attrs=attrs,
        start_ns=T0 + int(a_ms * 1e6), end_ns=T0 + int(b_ms * 1e6))


def _kernel(a_ms, b_ms):
    start = runtime.to_trace_us(T0) + 1e3 * a_ms
    return Kernel('k', start, 1e3 * (b_ms - a_ms), 'projections', 'kernel')


@pytest.fixture
def served(monkeypatch):
    """A 100 ms window: one step of 80 ms, the benchmark's loop after it;
    the device busy 5-15, 25-35, 62-70 and 85-90 ms."""
    step = _span('serve.step', 0, 80)
    decode = _span('serve.decode', 20, 60, step)
    d1 = _span('engine.decode_step', 20, 40, decode)
    d2 = _span('engine.decode_step', 40, 58, decode)
    sp = [_span('serve.sync', 0, 1, step),
          _span('serve.fill', 1, 20, step, rows=4),
          _span('engine.forward', 2, 18, None),
          decode, d1, d2,
          _span('layer.hyena', 21, 27, d1, i=0),
          _span('layer.hyena', 41, 44, d2, i=0),
          _span('serve.sample', 28, 30, decode),
          _span('serve.sample', 45, 47, decode),
          _span('serve.readback', 60, 70, step),
          _span('serve.harvest', 70, 79, step), step,
          # a request's wait began long before the window
          _span('serve.queued', -500, 10, rid=3),
          _span('serve.queued', -100, 14, rid=4),
          _span('score.prep', 81, 84, thread=MAIN + 1)]
    sp[2].parent = sp[1]
    # an earlier profiled session of the process, 10 s before
    early = _span('serve.step', -10_000, -9_000)
    sp[:0] = [_span('serve.decode', -9_900, -9_100, early),
              _span('engine.decode_step', -9_900, -9_100),
              _span('serve.sample', -9_200, -9_100), early]
    monkeypatch.setattr(runtime, 'SPANS', sp)
    monkeypatch.setattr(runtime, 'COUNTERS', {
        'serve.fill_rows': 8, 'serve.fill_rows_repeated': 3,
        'serve.prefix_admissions': 4, 'serve.slot_steps': 256,
        'serve.slot_steps_wasted': 64})
    trace = Trace([_kernel(5, 15), _kernel(25, 35), _kernel(62, 70),
                   _kernel(85, 90)], 0.100)
    return Record({}, {}, 1.0, {}, trace=trace)


def test_idle_by_span_on_a_synthetic_window(served):
    by = spans.idle_by_label(served, spans.serve_label)
    want = dict(sync=1, fill=9, decode=30, readback=2, harvest=9, step=1,
                outside=15)
    assert by.keys() == want.keys()
    for k, v in want.items():
        assert by[k] == pytest.approx(1e-3 * v, abs=1e-9), k
    assert sum(by.values()) == pytest.approx(
        readers.idle_share(served) / 100 * served.trace.window_s)
    for k in LABELS:
        got = spans.idle_share_in(served, spans.serve_label, k)
        assert got == pytest.approx(float(want[k])), k
        if k != 'fill':
            assert harness.reader(f'idle_share.gen.{k}')(served) == got


def test_idle_parts_with_the_rest_sum_to_idle_share(served):
    parts = sum(harness.reader(f'idle_share.gen.{k}')(served)
                for k in ('decode', 'harvest', 'outside'))
    rest = spans.idle_by_label(served, spans.serve_label)
    rest = 100 * sum(rest[k] for k in ('sync', 'fill', 'readback',
                                       'step')) / 0.1
    assert parts + rest == pytest.approx(readers.idle_share(served))


def test_an_earlier_sessions_spans_are_left_out(served):
    # the process's record holds them; the window's readers do not
    assert len(runtime.SPANS) == 20
    got = spans.spans(served)
    assert len(got) == 16
    assert all(runtime.to_trace_us(s.start_ns) >= runtime.to_trace_us(T0)
               for s in got if s.name != 'serve.queued')
    assert len(spans.named(got, 'serve.step')) == 1


def test_idle_by_engine_span(served):
    # the fill's engine.forward (2-18 ms) holds 3 + 3 ms of idle time,
    # the two decode steps (20-40, 40-58 ms) 5 + 5 and 18
    assert harness.reader('idle_share.score.engine')(served) == \
        pytest.approx(34.0)
    assert harness.reader('idle_share.score.outside')(served) == \
        pytest.approx(67.0 - 34.0)


def test_host_time_and_counters_on_the_synthetic_window(served):
    read = {m: harness.reader(m)(served) for m in NEW_GEN_HOST}
    assert read == pytest.approx({
        'serve.decode_launch_ms': 40.0, 'serve.readback_wait_ms': 10.0,
        'serve.harvest_ms': 9.0, 'hyena.decode_host_ms': 4.5,
        'serve.sample_ms': 2.0, 'serve.wasted_slot_share': 25.0})
    assert spans.ms_per(served, 'serve.fill', 'serve.step') == 19.0


def test_labelled_timeline_takes_the_innermost():
    got = spans.labelled_timeline([(0, 10, 'a'), (2, 4, 'b'), (4, 6, 'c'),
                                   (12, 14, 'a')])
    assert got == [(0, 2, 'a'), (2, 4, 'b'), (4, 6, 'c'), (6, 10, 'a'),
                   (10, 12, 'outside'), (12, 14, 'a')]


def test_a_program_without_spans_reads_nothing(served, monkeypatch):
    # the parent's runtime module has no SPANS: every reader says None
    monkeypatch.delattr(runtime, 'SPANS')
    for m in NEW_GEN + NEW_SCORE:
        assert harness.reader(m)(served) is None, m


def test_an_untraced_record_reads_nothing(served):
    served.trace = None
    for m in NEW_GEN + NEW_SCORE:
        assert harness.reader(m)(served) is None, m


def _host_metrics(cell):
    _, per_layer = harness.cell_metrics(harness.load_spec(), cell)
    return {m['name'] for m in per_layer
            if m['name'] in NEW_GEN + NEW_SCORE
            and m['source'] in ('host_clock', 'program_counter')}


def test_rehearsal_of_the_traced_serving_cell():
    # the cell's own tiny traffic: every new host-side metric reads in
    # each traced run, whether or not its steps admit a request
    r = run('serve-8k-design', trace=True)
    assert r['correct'], r['checks']
    want = _host_metrics('serve-8k-design')
    assert want == set(NEW_GEN_HOST)
    assert want <= set(r['metrics'])
    assert all(r['metrics'][m]['value'] >= 0 for m in want)
    assert r['metrics']['serve.decode_launch_ms']['value'] > 0
    assert r['metrics']['hyena.decode_host_ms']['value'] > 0
    # on the CPU the trace holds no device operation
    assert not {m for m in r['metrics'] if m.startswith('idle_share.gen.')}


def test_rehearsal_of_the_traced_8k_cell():
    # the scoring cells' new metrics are the device's idle time by span:
    # on the CPU there is none, and each reader says so without raising
    r = run('score-8k-mixed', trace=True)
    assert r['correct'], r['checks']
    assert _host_metrics('score-8k-mixed') == set()
    _, per_layer = harness.cell_metrics(harness.load_spec(),
                                        'score-8k-mixed')
    assert set(NEW_SCORE) <= {m['name'] for m in per_layer}
    assert not {m for m in r['metrics'] if m.startswith('idle_share.score.')}
