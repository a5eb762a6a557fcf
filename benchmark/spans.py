"""The program's own spans and counters (`evo_tpu_torch.runtime`) of the
traced window, for the metrics that read them: host time in named spans,
the program's counters, and the device's idle time put down to the span
the host's main thread was in.

The program records spans and counters only while a profiler session is
active, into a record that only `runtime.trace` restarts. So the readers
keep the spans that start inside the traced window, which ends with its
last device operation or span, whichever ends later, and lasts its
host-clock length. The counters are summed over every profiled session
of the process: in a benchmark run the traced window is the only one. A
program without them (a runtime module with no `SPANS`) leaves every
reader here None.

Idle by span: the traced window on the trace's clock starts at its first
span or device operation, whichever is first, and lasts the window's
host-clock length; the device is idle where no operation runs. Each idle
stretch is cut where the main thread's innermost labelled span changes,
and each piece goes to that span's label, or to 'outside' where no
labelled span is open. The parts sum to the idle time of the window.
"""

from __future__ import annotations

import sys
import threading
from typing import Callable, Dict, List, Optional, Tuple

# spans that begin before the window they are recorded in (a request's
# wait in the queue): they neither start the window nor hold the host
OPEN_ENDED = ('serve.queued',)
# the children of `serve.step` that the idle time is put down to
SERVE_CHILDREN = ('serve.sync', 'serve.fill', 'serve.decode',
                  'serve.readback', 'serve.harvest')


def _runtime():
    mod = sys.modules.get('evo_tpu_torch.runtime')
    return mod if mod is not None and hasattr(mod, 'SPANS') else None


def spans(record) -> Optional[list]:
    """The traced window's spans, or None (an untraced run, a program
    without spans): those that start inside it, and the open-ended ones
    that end inside it."""
    rt = _runtime()
    if record.trace is None or rt is None:
        return None
    t, conv = record.trace, rt.to_trace_us
    sp = list(rt.SPANS)
    ends = [conv(s.end_ns) for s in sp if s.name not in OPEN_ENDED]
    ends += [k.start_us + k.dur_us for k in t.kernels]
    if not ends:
        return []
    w0 = max(ends) - 1e6 * t.window_s
    return [s for s in sp if conv(
        s.end_ns if s.name in OPEN_ENDED else s.start_ns) >= w0]


def counter_share(record, part: str, *whole: str) -> Optional[float]:
    """100 x counter `part` / the sum of counters `whole`; None where the
    program counts nothing or the whole is 0."""
    rt = _runtime()
    if record.trace is None or rt is None:
        return None
    c = rt.COUNTERS
    total = sum(c.get(w, 0) for w in whole)
    return 100.0 * c.get(part, 0) / total if total else None


def ms(s) -> float:
    return (s.end_ns - s.start_ns) / 1e6


def named(sp: list, name: str, parent: Optional[str] = None) -> list:
    return [s for s in sp if s.name == name and (
        parent is None or (s.parent is not None and s.parent.name == parent))]


def ms_per(record, name: str, per: str, parent: Optional[str] = None,
           per_parent: Optional[str] = None) -> Optional[float]:
    """Host ms in the spans `name` (under `parent`) for each span `per`
    (under `per_parent`); None without a `per` span."""
    sp = spans(record)
    if sp is None:
        return None
    n = len(named(sp, per, per_parent))
    if not n:
        return None
    return sum(ms(s) for s in named(sp, name, parent)) / n


# -- idle time by span ------------------------------------------------------

Interval = Tuple[float, float]


def serve_label(s) -> Optional[str]:
    """The child of `serve.step` a span is ('step' for the step's own
    glue); None for the spans under them, which take their label."""
    if s.name in SERVE_CHILDREN:
        return s.name.split('.', 1)[1]
    return 'step' if s.name == 'serve.step' else None


def score_label(s) -> Optional[str]:
    """'engine' for an `engine.*` span, 'score' for a `score.*` one; the
    layers' spans take their engine span's label."""
    head = s.name.split('.', 1)[0]
    return head if head in ('engine', 'score') else None


def labelled_timeline(intervals: List[Tuple[float, float, str]]
                      ) -> List[Tuple[float, float, str]]:
    """Disjoint (start, end, label) pieces from nested labelled intervals:
    each piece carries the label of the innermost interval open over it,
    'outside' between them."""
    events = []
    for k, (a, b, _) in enumerate(intervals):
        events.append((a, 1, -b, k))
        events.append((b, 0, 0.0, k))
    events.sort()
    out, stack, at = [], [], None
    for t, kind, _, k in events:
        if at is not None and t > at:
            out.append((at, t, intervals[stack[-1]][2] if stack
                        else 'outside'))
        at = t
        if kind:
            stack.append(k)
        elif stack and stack[-1] == k:
            stack.pop()
        elif k in stack:
            stack.remove(k)
    return out


def idle_intervals(kernels, w0: float, w1: float) -> List[Interval]:
    """[w0, w1] less the union of the device operations (trace.Kernel)."""
    out, at = [], w0
    for k in sorted(kernels, key=lambda k: k.start_us):
        s, e = k.start_us, k.start_us + k.dur_us
        if s > at:
            out.append((at, min(s, w1)))
        at = max(at, e)
        if at >= w1:
            break
    if at < w1:
        out.append((at, w1))
    return [(a, b) for a, b in out if b > a]


def idle_by_label(record, label: Callable, thread: Optional[int] = None
                  ) -> Optional[Dict[str, float]]:
    """Seconds of device idle time in the traced window by the label of
    the span the main thread (or `thread`) was innermost in, with
    'outside' where it was in no labelled span; None without device
    operations or spans."""
    sp = spans(record)
    t = record.trace
    if sp is None or not t.kernels:
        return None
    conv = _runtime().to_trace_us
    thread = threading.main_thread().ident if thread is None else thread
    starts = [conv(s.start_ns) for s in sp if s.name not in OPEN_ENDED]
    w0 = min(starts + [min(k.start_us for k in t.kernels)])
    w1 = w0 + 1e6 * t.window_s
    mine = [(conv(s.start_ns), conv(s.end_ns), label(s)) for s in sp
            if s.thread == thread and s.name not in OPEN_ENDED]
    pieces = labelled_timeline([x for x in mine if x[2] is not None])
    by: Dict[str, float] = {}
    idle = idle_intervals(t.kernels, w0, w1)
    covered = 0.0
    j = 0
    for a, b, lab in pieces:
        while j < len(idle) and idle[j][1] <= a:
            j += 1
        i = j
        while i < len(idle) and idle[i][0] < b:
            part = min(b, idle[i][1]) - max(a, idle[i][0])
            if part > 0:
                by[lab] = by.get(lab, 0.0) + 1e-6 * part
                covered += 1e-6 * part
            i += 1
    total = 1e-6 * sum(b - a for a, b in idle)
    by['outside'] = by.get('outside', 0.0) + total - covered
    return by


def idle_share_in(record, label: Callable, which: str) -> Optional[float]:
    """Device idle time while the main thread's innermost labelled span
    was `which`, over the traced window's host-clock length, %."""
    by = idle_by_label(record, label)
    if by is None or record.trace.window_s <= 0:
        return None
    return 100.0 * by.get(which, 0.0) / record.trace.window_s
