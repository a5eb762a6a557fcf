"""The port's runtime controls (`evo_tpu_torch/runtime.py`), its prefetch
thread (`io/prefetch.py`) under `score_stream`, its native FASTA scanner
(`io/fastio.py`, `io/_fastio.cpp`) under `read_fasta`, and
`__version__`, on the CPU.

The scanner is held equal to the port's Python parser and to the JAX
package's scanner (`evo_tpu.io.fastio.parse_fasta_bytes`) on the same
bytes: the edge cases of `tests/test_fastio.py`, hypothesis-drawn files
of FASTA lines (`\\n` or `\\r\\n` endings, blanks, tabs, `>` in mid-line,
text before the first header), gzip, and a file of 200 records.
"""

import gzip
import io
import os
import threading
import time

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import evo_tpu
from evo_tpu.io import fastio as jax_fastio
from evo_tpu_torch import __version__, runtime
from evo_tpu_torch.config import cli_tiny_overrides
from evo_tpu_torch.generation import generate
from evo_tpu_torch.io import fasta, fastio
from evo_tpu_torch.io.prefetch import prefetch_map
from evo_tpu_torch.models import Evo
from evo_tpu_torch.ops import _build, fftconv
from evo_tpu_torch.ops.hyena_mixer import hyena_mixer_plain
from evo_tpu_torch import scoring
from evo_tpu_torch.scoring import score_sequences, score_stream

torch.set_num_threads(2)


@pytest.fixture(scope='module')
def evo():
    return Evo('evo-1-8k-base', 'cpu', random_init=True,
               config_overrides=cli_tiny_overrides())


@pytest.fixture
def precision():
    """Restore the float32 matmul precision after a test."""
    before = torch.get_float32_matmul_precision()
    yield
    torch.set_float32_matmul_precision(before)


# -- runtime ------------------------------------------------------------------

def test_configure_round_trip(monkeypatch, precision, tmp_path):
    runtime.configure(debug_nans=True)
    try:
        assert torch.is_anomaly_enabled()
    finally:
        runtime.configure(debug_nans=False)
    assert not torch.is_anomaly_enabled()
    # untouched flags stay untouched
    before = (torch.get_float32_matmul_precision(), _build.BUILD_DIR)
    runtime.configure(debug_nans=False, disable_jit=True)
    runtime.configure(disable_jit=False)
    assert (torch.get_float32_matmul_precision(), _build.BUILD_DIR) == before
    runtime.configure(highest_matmul_precision=False)
    assert torch.get_float32_matmul_precision() == 'high'
    runtime.configure(highest_matmul_precision=True)
    assert torch.get_float32_matmul_precision() == 'highest'
    monkeypatch.setattr(_build, 'BUILD_DIR', _build.BUILD_DIR)
    runtime.configure(compilation_cache_dir=str(tmp_path))
    assert _build.BUILD_DIR == tmp_path
    assert _build.library_path().parent == tmp_path


def _conv_inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    C, S, L = 64, 8, 256
    u = torch.randn(2, C, L, generator=g)
    mag = torch.rand(C, S, generator=g) * 0.39 + 0.6
    ang = (torch.rand(C, S, generator=g) * 2 - 1) * 3.14159
    poles = torch.stack([mag * torch.cos(ang), mag * torch.sin(ang)], -1)
    residues = torch.randn(C, S, 2, generator=g) / S
    state = torch.randn(2, C, S, 2, generator=g)
    return u, poles, residues, state, torch.randn(C, generator=g)


@pytest.mark.parametrize('setting', ['configure', 'medium'])
def test_long_conv_keeps_full_float32(precision, setting):
    """The long conv's products hold full float32 whatever the global
    precision: `configure(highest_matmul_precision=False)` (TF32 on the
    card) and even 'medium' (bf16 products in oneDNN on this CPU) leave
    its output bit for bit as it was, and the caller's setting stands
    after the call. The unpinned function does move under 'medium',
    which shows the setting reaches these einsums here."""
    u, poles, residues, state, d = _conv_inputs()
    want = fftconv.conv_matmul_chunked(u, poles, residues, 64, state=state,
                                       d_skip=d)
    z = torch.randn(2, 3, 64, 128, generator=torch.Generator().manual_seed(1))
    w = torch.randn(3, 64, 3, generator=torch.Generator().manual_seed(2))
    mixer = hyena_mixer_plain(z, w, None, poles, residues, d, chunk=64)
    if setting == 'configure':
        runtime.configure(highest_matmul_precision=False)
        lowered = 'high'
    else:
        torch.set_float32_matmul_precision('medium')
        lowered = 'medium'
    got = fftconv.conv_matmul_chunked(u, poles, residues, 64, state=state,
                                      d_skip=d)
    assert torch.get_float32_matmul_precision() == lowered
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    for g, w_ in zip(hyena_mixer_plain(z, w, None, poles, residues, d,
                                       chunk=64), mixer):
        assert torch.equal(g, w_)
    if setting == 'medium':
        raw, _ = fftconv.conv_matmul_chunked.__wrapped__(
            u, poles, residues, 64, state=state, d_skip=d)
        if torch.backends.mkldnn.is_available() and \
                torch.backends.mkldnn.matmul.fp32_precision == 'bf16':
            assert not torch.equal(raw, want[0])


def test_precision_pin_is_shared_by_overlapping_calls(precision):
    """Two threads inside the pinned region at once: the one that entered
    first and leaves first does not put the caller's setting back under
    the other, and the last to leave restores it."""
    torch.set_float32_matmul_precision('medium')
    a_in, b_in, a_out = (threading.Event() for _ in range(3))
    seen = {}

    @fftconv.full_float32
    def held(tag):
        if tag == 'a':
            a_in.set()
            assert b_in.wait(10)
        else:
            assert a_in.wait(10)
            b_in.set()
            assert a_out.wait(10)
        seen[tag] = torch.get_float32_matmul_precision()

    def a():
        held('a')
        seen['after a'] = torch.get_float32_matmul_precision()
        a_out.set()

    ta = threading.Thread(target=a)
    ta.start()
    held('b')
    ta.join(10)
    assert seen == {'a': 'highest', 'b': 'highest', 'after a': 'highest'}
    assert torch.get_float32_matmul_precision() == 'medium'


def test_device_memory_report_on_the_cpu():
    if torch.cuda.is_available():
        pytest.skip('this host has a CUDA device')
    assert runtime.device_memory_report() == 'cpu: n/a'


def test_trace_noop_without_dir():
    with runtime.trace(None):
        x = torch.ones(8) * 2
    with runtime.trace(''):
        x = x + 1
    assert float(x.sum()) == 24


def test_trace_writes_files(tmp_path):
    with runtime.trace(str(tmp_path)):
        torch.randn(64, 64) @ torch.randn(64, 64)
    files = list(tmp_path.iterdir())
    assert files, 'the profiler should write a trace file'
    assert any(f.stat().st_size > 0 for f in files)


def test_log_prefix(capsys, monkeypatch):
    runtime.log('hello')
    assert capsys.readouterr().out == '[host 0] hello\n'
    monkeypatch.setattr(runtime, '_rank', lambda: 3)
    runtime.log('quiet')
    assert capsys.readouterr().out == ''
    runtime.log('loud', all_hosts=True)
    assert capsys.readouterr().out == '[host 3] loud\n'
    buf = io.StringIO()
    runtime.log('to a file', all_hosts=True, file=buf)
    assert buf.getvalue() == '[host 3] to a file\n'


def test_generate_verbose_prints_the_memory_report(evo, capsys):
    """verbose > 1 reaches `Generator.generate`, which prints the device
    memory before and after generation, as the JAX package does; lower
    levels print no report."""
    generate(['ACGTACGT'], evo.model, evo.tokenizer, n_tokens=4, verbose=2)
    out = capsys.readouterr().out
    report = runtime.device_memory_report()
    assert f'Memory before generation: {report}\n' in out
    assert f'Memory after generation: {report}\n' in out
    assert out.index('Memory before') < out.index('Memory after')
    generate(['ACGTACGT'], evo.model, evo.tokenizer, n_tokens=4, verbose=1)
    assert 'Memory' not in capsys.readouterr().out


def test_version_is_exported():
    assert __version__ == '0.1.0' == evo_tpu.__version__
    import evo_tpu_torch
    assert evo_tpu_torch.__version__ is __version__


# -- prefetch -----------------------------------------------------------------

@pytest.mark.parametrize('depth', [-1, 0, 1, 2, 5])
def test_prefetch_keeps_order(depth):
    items = list(range(40))
    assert list(prefetch_map(lambda x: x * x, iter(items), depth=depth)) == \
        [x * x for x in items]
    assert list(prefetch_map(lambda x: x, [], depth=depth)) == []


@pytest.mark.parametrize('depth,inline', [(0, True), (-3, True), (1, False),
                                          (3, False)])
def test_prefetch_depth_below_one_runs_in_line(depth, inline):
    seen = []
    list(prefetch_map(lambda x: seen.append(threading.current_thread()),
                      range(5), depth=depth))
    main = threading.current_thread()
    assert all((t is main) == inline for t in seen)


@pytest.mark.parametrize('depth', [0, 1, 2])
def test_prefetch_error_surfaces_at_the_consumer(depth):
    def fn(x):
        if x == 3:
            raise KeyError('bad item')
        return x
    got = []
    with pytest.raises(KeyError, match='bad item'):
        for y in prefetch_map(fn, range(10), depth=depth):
            got.append(y)
    assert got == [0, 1, 2]


def test_prefetch_abandoned_generator_stops_the_worker():
    calls = []

    def fn(x):
        calls.append(x)
        return x

    before = threading.active_count()
    gen = prefetch_map(fn, range(10_000), depth=2)
    assert next(gen) == 0
    gen.close()
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.02)
    assert threading.active_count() == before
    # the worker stopped a few items ahead, not at the end of the input
    assert len(calls) < 10


# -- score_stream on the prefetch thread ---------------------------------------

@pytest.mark.parametrize('depth', [0, 1, 2])
def test_score_stream_equals_score_sequences(evo, monkeypatch, depth):
    rng = np.random.default_rng(depth)
    seqs = [''.join(rng.choice(list('ACGT'), n))
            for n in (5, 40, 33, 7, 64, 12, 90)]
    batches = [seqs[i:i + 2] for i in range(0, len(seqs), 2)]
    want = []
    for b in batches:
        want += score_sequences(b, evo.model, evo.tokenizer)
    threads = []
    real = scoring.prepare_batch

    def prep(*a, **kw):
        threads.append(threading.current_thread())
        return real(*a, **kw)

    monkeypatch.setattr(scoring, 'prepare_batch', prep)
    seen = []
    got = score_stream(iter(batches), evo.model, evo.tokenizer,
                       prefetch_depth=depth, progress=seen.append)
    # bucketing pads further to the right, which a causal model ignores
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert seen == [2, 4, 6, 7]
    main = threading.current_thread()
    assert len(threads) == len(batches)
    assert all((t is main) == (depth < 1) for t in threads)


# -- the native FASTA scanner ---------------------------------------------------

CASES = [
    '>a\nACGT\n',
    '>a desc here\nACGT\nGGTT\n>b\nTTAA\n',
    '>a\r\nACGT\r\nGG\r\n',                       # CRLF
    'junk before\n>a\nACGT\n',                    # leading junk
    '>empty\n>b\nAC\n',                           # empty record
    '>a\n  ACGT  \n',                             # per-line edge blanks
    '>a\nAC GT\n',                                # interior space (EOS)
    '>a\nACGT',                                   # no trailing newline
    '',                                           # empty file
    '>s1\nAC >GT\n>s2\nTT\n',                     # '>' in mid-line
    '\n\n>a\n\nAC\n\n',                           # blank lines
    '>\tname\t\nA\tC\n',                          # tabs
]


def _python_parse(text: str):
    names, seqs = [], []
    for n, s in fasta.iter_fasta(io.StringIO(text)):
        names.append(n)
        seqs.append(s)
    return names, seqs


def test_scanner_builds_into_the_build_directory():
    assert fastio.available()
    so = fastio.library_path()
    assert so.exists() and so.parent == fastio.BUILD_DIR
    assert so.parent.name == 'build' and so.parent.parent.name == \
        'evo_tpu_torch'
    # nothing beside the module
    here = os.path.dirname(fastio.__file__)
    assert not [f for f in os.listdir(here) if f.endswith('.so')]


@pytest.mark.parametrize('text', CASES)
def test_scanner_matches_both_parsers(text):
    got = fastio.parse_fasta_bytes(text.encode())
    assert got == _python_parse(text)
    assert got == jax_fastio.parse_fasta_bytes(text.encode())


_LINE = st.text(alphabet='ACGTN> \tacgtx', max_size=12)


@settings(max_examples=150, deadline=None, database=None)
@given(lines=st.lists(st.one_of(_LINE, _LINE.map(lambda s: '>' + s)),
                      max_size=12),
       crlf=st.booleans(), trailing=st.booleans())
def test_scanner_matches_both_parsers_on_drawn_files(lines, crlf, trailing):
    end = '\r\n' if crlf else '\n'
    text = end.join(lines) + (end if trailing else '')
    data = text.encode()
    got = fastio.parse_fasta_bytes(data)
    assert got == jax_fastio.parse_fasta_bytes(data)
    assert got == _python_parse(text)


def test_read_fasta_takes_the_scanner(tmp_path, monkeypatch):
    path = tmp_path / 'x.fasta'
    path.write_text('>s1 d\nACGT\nACGT\n>s2\nTT\n')
    want = (['s1 d', 's2'], ['ACGTACGT', 'TT'])
    assert fasta.read_fasta(str(path)) == want
    assert fasta.read_fasta(path) == want          # a path-like too

    def refuse(*a, **kw):
        raise AssertionError('the Python parser ran')

    monkeypatch.setattr(fasta, 'iter_fasta', refuse)
    assert fasta.read_fasta(str(path)) == want
    # a handle takes the Python parser
    monkeypatch.undo()
    with open(path) as f:
        assert fasta.read_fasta(f) == want


def test_read_fasta_gzip_and_mid_line_gt(tmp_path):
    content = '>seq1 desc\nACGT\nACGT\n>seq2\nTT >TT\n'
    gz = tmp_path / 'x.fa.gz'
    with gzip.open(gz, 'wt') as f:
        f.write(content)
    want = (['seq1 desc', 'seq2'], ['ACGTACGT', 'TT >TT'])
    assert fasta.read_fasta(str(gz)) == want
    assert fastio.read_fasta_fast(str(gz)) == want
    assert jax_fastio.read_fasta_fast(str(gz)) == want
    assert _python_parse(content) == want


def test_large_file_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    records = []
    for i in range(200):
        seq = ''.join(rng.choice(list('ACGT'), size=5000))
        wrapped = '\n'.join(seq[j:j + 70] for j in range(0, len(seq), 70))
        records.append(f'>genome_{i} sample\n{wrapped}\n')
    text = ''.join(records)
    path = tmp_path / 'big.fasta'
    path.write_text(text)
    names, seqs = fastio.read_fasta_fast(str(path))
    assert len(names) == 200 and all(len(s) == 5000 for s in seqs)
    assert (names, seqs) == _python_parse(text)
    assert (names, seqs) == fasta.read_fasta(str(path))
