"""Runtime debug, tracing and observability controls (port of
`evo_tpu/runtime.py`), in PyTorch's idiom:

  * `configure(...)`: the JAX package's flags, each mapped onto its
    PyTorch counterpart (the docstring names them);
  * `trace(dir)`: a `torch.profiler` trace of the CPU and, where there is
    one, the CUDA device, written to `dir`;
  * `device_memory_report()`: the bytes each visible CUDA device holds
    (the `memory_allocated` print of generation's verbose mode);
  * `log(msg)`: a print that carries the process's rank, so interleaved
    output of several processes stays attributable.
"""

from __future__ import annotations

import contextlib
import sys
from pathlib import Path
from typing import Optional

import torch


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
    card is present, as a Chrome trace file."""
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
        yield


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
