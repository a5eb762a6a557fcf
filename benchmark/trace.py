"""The traced window: `torch.profiler` over the card's activity, reduced
to device kernels with their layers.

Only CUDA activity is recorded (the kernels, copies and sets of the
device, with start and duration); the trace is written under `TMPDIR` as
a Chrome trace, read back and deleted. Each kernel's layer comes from the
first pattern of `kernel_layers.json` that its name contains; a name that
no pattern names is reported as unmapped, so a renamed kernel shows as a
jump in that share.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
UNMAPPED = 'unmapped'


@dataclasses.dataclass
class Kernel:
    name: str
    start_us: float
    dur_us: float
    layer: str
    cat: str                    # 'kernel', 'gpu_memcpy' or 'gpu_memset'


@dataclasses.dataclass
class Trace:
    kernels: List[Kernel]
    window_s: float             # host clock around the traced work

    def seconds(self, layer: Optional[str] = None,
                contains: Optional[str] = None) -> float:
        """Summed device seconds of the kernels of `layer` and/or whose
        name contains `contains`."""
        return 1e-6 * sum(k.dur_us for k in self.select(layer, contains))

    def count(self, layer: Optional[str] = None,
              contains: Optional[str] = None) -> int:
        return len(self.select(layer, contains))

    def select(self, layer=None, contains=None) -> List[Kernel]:
        return [k for k in self.kernels
                if (layer is None or k.layer == layer)
                and (contains is None or contains in k.name)]

    def launches(self) -> int:
        """Kernels launched (copies and sets left out)."""
        return sum(k.cat == 'kernel' for k in self.kernels)

    @property
    def device_s(self) -> float:
        """Summed durations of every device operation."""
        return 1e-6 * sum(k.dur_us for k in self.kernels)

    @property
    def busy_s(self) -> float:
        """The union of the operations' intervals."""
        busy, end = 0.0, float('-inf')
        for k in sorted(self.kernels, key=lambda k: k.start_us):
            s, e = k.start_us, k.start_us + k.dur_us
            if e <= end:
                continue
            busy += e - max(s, end)
            end = e
        return 1e-6 * busy

    def unmapped(self, n: int = 5) -> List[Tuple[str, float]]:
        """The largest kernels that `kernel_layers.json` does not name."""
        by: Dict[str, float] = {}
        for k in self.select(UNMAPPED):
            by[short_name(k.name)] = by.get(short_name(k.name), 0.0) \
                + 1e-6 * k.dur_us
        return sorted(by.items(), key=lambda kv: -kv[1])[:n]

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        by: Dict[str, float] = {}
        for k in self.kernels:
            key = f'{k.layer}: {short_name(k.name)}'
            by[key] = by.get(key, 0.0) + 1e-6 * k.dur_us
        return sorted(by.items(), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> List[Tuple[str, float]]:
        """The longest stretches with no device operation, named by the
        operations on either side (what the host had launched last and
        what it launched next)."""
        ks = sorted(self.kernels, key=lambda k: k.start_us)
        gaps, end, last = [], None, None
        for k in ks:
            if end is not None and k.start_us > end:
                gaps.append((f'after {short_name(last.name)} -> before '
                             f'{short_name(k.name)}',
                             1e-6 * (k.start_us - end)))
            if end is None or k.start_us + k.dur_us > end:
                end, last = k.start_us + k.dur_us, k
        return sorted(gaps, key=lambda g: -g[1])[:n]


def short_name(name: str, limit: int = 72) -> str:
    """A kernel's name without its return type and arguments."""
    head = name.replace('(anonymous namespace)::', '')
    head = head.split('(')[0] or head
    if head.startswith('void '):
        head = head[5:]
    return head[:limit]


def load_layers(path: Optional[str] = None) -> List[Tuple[str, str]]:
    with open(path or os.path.join(HERE, 'kernel_layers.json')) as f:
        table = json.load(f)
    return [(pat, layer) for layer, pats in table['layers'].items()
            for pat in pats]


def layer_of(name: str, table: List[Tuple[str, str]]) -> str:
    for pat, layer in table:
        if pat in name:
            return layer
    return UNMAPPED


@contextlib.contextmanager
def profiled(sync, out: list):
    """Profile the card's activity inside the block; on exit append a
    `Trace` to `out`. `sync` waits for the device (the window ends when
    the last kernel has)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    table = load_layers()
    # the card's activity only; on the CPU (the tests' rehearsals) the
    # host's, which holds no device operation
    activity = (ProfilerActivity.CUDA if torch.cuda.is_available()
                else ProfilerActivity.CPU)
    sync()
    with profile(activities=[activity]) as prof:
        t0 = time.perf_counter()
        yield
        sync()
        window = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix='.json')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)['traceEvents']
    finally:
        os.unlink(path)
    kernels = [Kernel(e['name'], float(e['ts']), float(e['dur']),
                      layer_of(e['name'], table), e['cat'])
               for e in events
               if e.get('cat') in ('kernel', 'gpu_memcpy', 'gpu_memset')]
    out.append(Trace(kernels, window))
