"""Runtime debug, tracing and observability controls (port of
`evo_tpu/runtime.py`), in PyTorch's idiom:

  * `configure(...)`: the JAX package's flags, each mapped onto its
    PyTorch counterpart (the docstring names them);
  * `trace(dir)`: a `torch.profiler` trace of the CPU and, where there is
    one, the CUDA device, written to `dir`, with the spans below shown
    beside the operators and kernels they launched, and the window's
    counters and span totals in `dir/spans.json` (the score and serve
    CLIs' `--trace-dir`);
  * `span(name, **attrs)` and `count(name, n=1)`: the program's own spans
    and counters at its layer boundaries (below);
  * `device_memory_report()`: the bytes each visible CUDA device holds
    (the `memory_allocated` print of generation's verbose mode);
  * `log(msg)`: a print that carries the process's rank, so interleaved
    output of several processes stays attributable.

Spans and counters are on exactly while a `torch.profiler` session is
active (`torch.autograd.profiler._is_profiler_enabled`, which both
`trace()` and any other `torch.profiler.profile` set); there is no other
switch. Off, `span` returns one shared `contextlib.nullcontext` and
`count` returns at once: nothing is recorded. `trace()` starts a new
record, so `SPANS` and `COUNTERS` then hold its window's alone; under
any other profiler session they go on from the last `trace()` (or the
process's start), and a reader of one window keeps the spans that start
inside it (`benchmark/spans.py` does). A span (`Span`) records its name,
its parent (the enclosing span on the same thread, or None), the thread,
its start and end from `time.time_ns()` and its attrs; a request's spans
carry its id as `rid`.
`to_trace_us(t_ns)` puts a span time on the clock of the profiler's
exported Chrome trace (`ts`, microseconds), on which the device's kernels
lie too, so a device interval can be put down to the span the host was
in. Under `trace()` every span also enters
`torch.profiler.record_function(name)`.

The spans, by layer (children indented under their parent):

    serve.step                   one `GenerationServer.step()`
      serve.sync                 the mesh broadcast of the lead's intake
      serve.fill                 a fill started or advanced, or an
                                 admission from the prefix cache: rows,
                                 prompt_len, rids (rows 0 for the cache)
        serve.fill_chunk         one whole prompt chunk of the head
        serve.fill_tail          the tail that gives the first logits
        serve.admit              first token's sample + row copy: rid,
                                 prefix (from the prefix cache or not)
      serve.decode               the decode chunk's launches
        engine.decode_step       each of its steps, then
        serve.sample             each step's sampling
      serve.readback             the chunk's one read to the host
      serve.harvest              recording the tokens, the first ones too
    serve.queued                 submit() to admission: rid (no parent)
    engine.forward               a full-sequence pass (forward, fresh or
                                 resumed prefill): rows, len, offset
    engine.decode_step           one decode step
      layer.hyena, layer.attention, layer.mlp   each block's mixer
                                 (with its norm) and MLP: the layer i
    score.batch                  one batch of `score_stream`
    score.prep                   its tokenizing and padding, on the
                                 prefetch thread
    score.segment                one segment of a segmented score: index,
                                 offset
    score.readback               each read of log-probabilities to the host

The counters: `serve.fill_rows` (rows prefilled), `serve.fill_rows_repeated`
(rows whose token ids equal an earlier row's of the same fill),
`serve.prefix_admissions`, `serve.slot_steps` (decode steps x rows
harvested) and `serve.slot_steps_wasted` (of those, the row-steps whose
token was thrown away: an idle row, or one past its request's end).
"""

from __future__ import annotations

import contextlib
import json
import sys
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler


def configure(*, debug_nans: Optional[bool] = None,
              disable_jit: Optional[bool] = None,
              compilation_cache_dir: Optional[str] = None,
              highest_matmul_precision: Optional[bool] = None) -> None:
    """Set global runtime flags; only what is passed is touched. The
    JAX package's flags and their counterparts here:

      debug_nans               `torch.autograd.set_detect_anomaly`
      disable_jit              accepted, no counterpart: the port compiles
                               no Python (its kernels are CUDA sources)
      compilation_cache_dir    where kernels not yet built go
                               (`ops/_build.BUILD_DIR`); a library already
                               loaded stays loaded
      highest_matmul_precision `torch.set_float32_matmul_precision`:
                               'highest' (full float32), or 'high' (TF32
                               on the card) when False. The long conv
                               holds full float32 for its own products
                               either way (`ops/fftconv.py`), as the JAX
                               package pins `Precision.HIGHEST` there.
    """
    if debug_nans is not None:
        torch.autograd.set_detect_anomaly(debug_nans)
    if compilation_cache_dir is not None:
        from evo_tpu_torch.ops import _build
        _build.BUILD_DIR = Path(compilation_cache_dir)
    if highest_matmul_precision is not None:
        torch.set_float32_matmul_precision(
            'highest' if highest_matmul_precision else 'high')


@contextlib.contextmanager
def trace(trace_dir: Optional[str]):
    """Capture a `torch.profiler` trace into `trace_dir` (no-op when
    None): the CPU's operators, and the CUDA device's kernels where a
    card is present, as a Chrome trace file, with every span of the
    window as a `record_function` range beside them; the window's
    `summary()` goes to `trace_dir/spans.json`."""
    global _OPERATOR_VIEW
    if not trace_dir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(trace_dir))):
        _restart()
        _OPERATOR_VIEW = True
        try:
            yield
        finally:
            _OPERATOR_VIEW = False
            Path(trace_dir).mkdir(parents=True, exist_ok=True)
            (Path(trace_dir) / 'spans.json').write_text(
                json.dumps(summary(), indent=1))


# ---------------------------------------------------------------------------
# Spans and counters (module docstring)
# ---------------------------------------------------------------------------

SPANS: List['Span'] = []          # since the last restart, as they end
COUNTERS: Dict[str, int] = {}     # since the last restart
_OFF = contextlib.nullcontext()
_OPERATOR_VIEW = False            # inside trace(): record_function ranges
_SESSION = 0                      # restarts so far
_LOCK = threading.Lock()
_OPEN = threading.local()         # .stack: this thread's open spans
# kineto's Chrome trace writes times from the start of a "trimonth" of
# this many seconds of the unix clock (libkineto's ChromeTraceBaseTime)
_TRIMONTH_S = 7_889_238


class Span:
    """One span of a profiled session (module docstring). `parent` is the
    enclosing `Span` on the same thread; times are `time.time_ns()`."""

    __slots__ = ('name', 'attrs', 'parent', 'thread', 'start_ns', 'end_ns',
                 '_session', '_range', '_stack')

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self.parent: Optional[Span] = None
        self.thread = 0
        self.start_ns = self.end_ns = 0
        self._session = _SESSION
        self._range = self._stack = None

    def __enter__(self) -> 'Span':
        stack = self._stack = _stack()
        self.parent = stack[-1] if stack else None
        self.thread = threading.get_ident()
        stack.append(self)
        if _OPERATOR_VIEW:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        # off its own thread's stack, where a generator that holds it open
        # and is closed late leaves it below the top
        self._stack.remove(self)
        if self._session == _SESSION:
            SPANS.append(self)
        return False


def _stack() -> list:
    stack = getattr(_OPEN, 'stack', None)
    if stack is None:
        stack = _OPEN.stack = []
    return stack


def span(name: str, **attrs):
    """A context manager that records a `Span` while a profiler session
    is active; otherwise one shared no-op context. On, it yields the
    `Span` (its `attrs` may still be added to inside), off None."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return Span(name, attrs)


def record_span(name: str, start_ns: int, **attrs) -> None:
    """Record a span from `start_ns` (`time.time_ns()`) to now that was
    not opened as a context, such as a request's wait in a queue: it has
    no parent. Nothing while no profiler session is active."""
    if not _profiler._is_profiler_enabled:
        return
    sp = Span(name, attrs)
    sp.thread = threading.get_ident()
    sp.start_ns, sp.end_ns = start_ns, time.time_ns()
    SPANS.append(sp)


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name` while a profiler session is active."""
    if not _profiler._is_profiler_enabled:
        return
    with _LOCK:
        COUNTERS[name] = COUNTERS.get(name, 0) + n


def to_trace_us(t_ns: int) -> float:
    """A `time.time_ns()` time on the exported Chrome trace's clock: the
    unix clock less the start of its trimonth, in microseconds."""
    base_ns = (t_ns // 10 ** 9 // _TRIMONTH_S) * _TRIMONTH_S * 10 ** 9
    return (t_ns - base_ns) / 1e3


def summary() -> Dict[str, Any]:
    """The record in totals: each counter, and for each span name the
    number of its spans and their host ms."""
    totals: Dict[str, List[float]] = {}
    for s in SPANS:
        t = totals.setdefault(s.name, [0, 0.0])
        t[0] += 1
        t[1] += (s.end_ns - s.start_ns) / 1e6
    return {'counters': dict(COUNTERS),
            'spans': {k: {'n': n, 'ms': ms}
                      for k, (n, ms) in sorted(totals.items())}}


def _restart() -> None:
    """Start a new record; a span open across it is dropped when it
    ends."""
    global _SESSION
    _SESSION += 1
    SPANS.clear()
    with _LOCK:
        COUNTERS.clear()


def device_memory_report() -> str:
    """One entry per visible CUDA device: the bytes PyTorch has allocated
    there / the device's total memory, in GiB; `cpu: n/a` without one."""
    if not torch.cuda.is_available():
        return 'cpu: n/a'
    gib = 1024 ** 3
    lines = []
    for i in range(torch.cuda.device_count()):
        used = torch.cuda.memory_allocated(i)
        _free, total = torch.cuda.mem_get_info(i)
        lines.append(f'{torch.cuda.get_device_name(i)} {i}: '
                     f'{used / gib:.2f}/{total / gib:.2f} GiB')
    return '; '.join(lines)


def _rank() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def log(msg: str, *, all_hosts: bool = False, file=None) -> None:
    """Per-process print, `[host {rank}] msg`; rank 0 only unless
    `all_hosts`. The rank is `torch.distributed`'s when it is
    initialized, else 0."""
    idx = _rank()
    if idx == 0 or all_hosts:
        print(f'[host {idx}] {msg}', file=file or sys.stdout, flush=True)
