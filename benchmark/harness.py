"""One run of one cell: set-up, the measured window, the traced window,
the comparison with the reference, and the result line.

Everything that belongs to one configuration, traffic mix or metric is
found by name: `BENCHMARK.json` names the cell's configuration file and
traffic mix, `traffic/<mix>.json` names its driver (`drivers/<driver>.py`,
the entry it drives), `limits/<cell>.json` holds the limits of its
comparison, and every metric is read by `metrics/<metric>.py`. A new
cell, mix, configuration or metric is a new file and a new entry.

A driver module has five functions:

    setup(ctx, model) -> state        build the entry over the program and
                                      warm up every shape the mix uses
    window(ctx, state, seconds) -> counters     the measured window
    traced(ctx, state) -> work        more of the same traffic, under the
                                      profiler (the `--trace 1` run)
    release(state) -> kept            what the check needs; the program
                                      and its state are dropped
    check(ctx, kept, sd) -> [(name, value, limit), ...]   against the
                                      reference, on the regenerated weights
                                      (sd None: the checks that need none)

A metric module has `read(record) -> float | None`.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import sys
import time
from typing import Any, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'evo_tpu')


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def host_usage() -> dict:
    """The calling thread's CPU seconds and context switches, and the
    host's load: what the window's log line compares, to tell a host that
    took cores from the run from a run that did more work."""
    import resource
    u = resource.getrusage(resource.RUSAGE_THREAD)
    try:        # the time the host ran other guests on this one's cpus
        with open('/proc/stat') as f:
            steal = int(f.readline().split()[8]) / os.sysconf('SC_CLK_TCK')
    except (OSError, IndexError, ValueError):
        steal = float('nan')
    return dict(t=time.perf_counter(), cpu_s=u.ru_utime + u.ru_stime,
                involuntary=u.ru_nivcsw, voluntary=u.ru_nvcsw,
                load=os.getloadavg()[0], steal=steal)


def log_host_usage(before: dict, after: dict) -> None:
    wall = after['t'] - before['t']
    log(f'window host: main thread {after["cpu_s"] - before["cpu_s"]:.2f} '
        f'cpu s of {wall:.2f} s, involuntary switches '
        f'{after["involuntary"] - before["involuntary"]}, voluntary '
        f'{after["voluntary"] - before["voluntary"]}, steal '
        f'{after["steal"] - before["steal"]:.2f} cpu s, load '
        f'{before["load"]:.2f} -> {after["load"]:.2f}, '
        f'{len(os.sched_getaffinity(0))} cpus')


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole: `evo_tpu_torch` is not `evo_tpu`."""
    return sorted(m for m in list(sys.modules)
                  if m.split('.')[0] in FORBIDDEN)


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict          # the configuration's file
    traffic: dict         # traffic/<mix>.json
    limits: dict          # limits/<cell>.json
    spec: dict            # BENCHMARK.json


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, 'BENCHMARK.json')) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT, base: str = HERE) -> Cell:
    spec = load_spec(root)
    found = [w for w in spec['workloads'] if w['name'] == name]
    if not found:
        raise SystemExit(f'no workload {name!r} in BENCHMARK.json')
    w = found[0]
    entry = [c for c in spec['configs'] if c['name'] == w['config']][0]
    return Cell(name, w, _json(os.path.join(root, entry['file'])),
                _json(os.path.join(base, 'traffic', w['traffic'] + '.json')),
                _json(os.path.join(base, 'limits', name + '.json')), spec)


def cell_metrics(spec: dict, name: str):
    """(end-to-end, per-layer) metric entries that the cell reports."""
    e2e = [m for m in spec['end_to_end']
           if name in m.get('workloads', [name])]
    moved = {m['name'] for m in e2e}
    per_layer = [m for m in spec['per_layer']
                 if (name in m['workloads'] if 'workloads' in m
                     else m['moves'] in moved)]
    return e2e, per_layer


def load_file(path: str, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, base: str = HERE):
    """The `read` function of metrics/<name>.py."""
    path = os.path.join(base, 'metrics', name + '.py')
    return load_file(path, 'benchmark_metric_' + name.replace('.', '_')
                     .replace('-', '_')).read


def driver(name: str, base: str = HERE):
    path = os.path.join(base, 'drivers', name + '.py')
    return load_file(path, 'benchmark_driver_' + name)


@dataclasses.dataclass
class Context:
    cell: Cell
    seed: int
    device: Any                    # torch.device
    cfg: Any                       # the port's ModelConfig
    model_cfg: dict                # its model keys, for the yardstick
    peaks: dict

    def sync(self) -> None:
        import torch
        if self.device.type == 'cuda':
            torch.cuda.synchronize()


@dataclasses.dataclass
class Record:
    """What the metric readers read."""
    cfg: dict                      # the configuration's model keys
    peaks: dict
    setup_s: float
    counters: dict                 # the measured window's
    work: dict = dataclasses.field(default_factory=dict)   # the traced
    trace: Any = None              # trace.Trace of the traced window


def port_config(cell: Cell, overrides: Optional[dict] = None):
    from evo_tpu_torch.config import ModelConfig
    raw = dict(cell.config['config'])
    raw.update(overrides or {})
    return ModelConfig.from_dict(raw)


def build_program(cfg, sd, device):
    """The system under test from the drawn weights: the port's model,
    quantized as the config says, behind its engine facade."""
    from evo_tpu_torch.checkpoint import params_from_state_dict
    from evo_tpu_torch.models import EvoModel
    module = params_from_state_dict(sd, cfg, device)
    if cfg.weight_quant != 'none':
        from evo_tpu_torch.quant import quantize_params
        module = quantize_params(module, free_source=True,
                                 mode=cfg.weight_quant)
    return EvoModel(cfg, module)


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = 'cuda', overrides: Optional[dict] = None,
             t_start: Optional[float] = None, root: str = ROOT,
             base: str = HERE, traffic: Optional[dict] = None,
             reference: bool = True) -> dict:
    """One run; returns the result object (the last line's JSON). The
    program runs under the cell's configuration with `overrides` on top
    (the control's lower precision, or the tests' tiny sizes), and the
    mix's parameters with `traffic` on top (the tests' short mixes).
    Without `reference` only the checks that need no reference are made
    (readings of those alone)."""
    import torch

    from benchmark import roofline, weights
    from benchmark.trace import profiled

    t0 = time.perf_counter() if t_start is None else t_start
    cell = load_cell(name, root, base)
    cell.traffic.update(traffic or {})
    dev = torch.device(device)
    cfg = port_config(cell, overrides)
    model_keys = dict(cell.config['config'], **(overrides or {}))
    if dev.type == 'cuda':
        from evo_tpu_torch.ops import _build
        _build.library()
        peaks = roofline.peaks_for(torch.cuda.get_device_name(0))
    else:
        peaks = roofline.H100_SXM
    ctx = Context(cell, seed, dev, cfg, model_keys, peaks)
    drv = driver(cell.traffic['driver'], base)

    sd = weights.draw(model_keys, seed, dev, getattr(torch, cfg.param_dtype))
    stamp = weights.fingerprint(sd)
    model = build_program(cfg, sd, dev)
    del sd
    state = drv.setup(ctx, model)
    del model
    ctx.sync()
    setup_s = time.perf_counter() - t0
    log(f'set-up {setup_s:.3f} s')

    if dev.type == 'cuda':
        torch.cuda.reset_peak_memory_stats()
    usage = host_usage()
    counters = drv.window(ctx, state, seconds)
    ctx.sync()
    log_host_usage(usage, host_usage())
    peak = (torch.cuda.max_memory_allocated() if dev.type == 'cuda'
            else 0)
    loaded = forbidden_modules()
    counters['peak_bytes'] = peak
    record = Record(model_keys, peaks, setup_s, counters)
    if trace:
        traces: list = []
        with profiled(ctx.sync, traces):
            record.work = drv.traced(ctx, state)
        record.trace = traces[0]

    kept = drv.release(state)
    del state
    gc.collect()
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = []
    sd = None
    if reference:
        sd = weights.draw(model_keys, seed, dev,
                          getattr(torch, cfg.param_dtype))
        checks.append(('weights_redrawn', 0.0 if weights.fingerprint(sd)
                       == stamp else 1.0, 0.0))
    checks += drv.check(ctx, kept, sd)
    del sd
    log(f'check {time.perf_counter() - t_check:.3f} s')

    e2e, per_layer = cell_metrics(cell.spec, name)
    metrics = {}
    for m in (per_layer if trace else e2e):
        value = reader(m['name'], base)(record)
        if value is None:
            if not trace:
                raise RuntimeError(f'no reading of {m["name"]}')
            log(f'metric {m["name"]}: nothing to read')
            continue
        metrics[m['name']] = {'value': value, 'unit': m['unit']}
    loaded = sorted(set(loaded) | set(forbidden_modules()))
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    result = {'correct': correct,
              'attempted': counters['attempted'],
              'failed': counters['failed'],
              'metrics': metrics,
              'device': device_info(dev, cell.workload['chips'], peak,
                                    record.trace)}
    if record.trace is not None:
        result['breakdown'] = {
            'device_ops': [list(x) for x in record.trace.top_ops(10)],
            'idle_gaps': [list(x) for x in record.trace.idle_gaps(10)]}
        log(f'traced window: {record.trace.window_s:.4f} s, busy '
            f'{record.trace.busy_s:.4f} s, unmapped '
            f'{record.trace.seconds("unmapped"):.6f} s of '
            f'{record.trace.device_s:.4f} s: {record.trace.unmapped()}')
    result['forbidden_modules'] = loaded
    result['checks'] = {n: {'value': v, 'limit': lim}
                        for n, v, lim in checks}
    for n, v, lim in checks:
        log(f'check {n} {v!r} limit {lim!r}')
    return result


def device_info(dev, chips: int, peak: int, trace) -> dict:
    import torch
    if dev.type == 'cuda':
        info = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                'count': chips, 'memory_peak_bytes': int(peak)}
    else:
        info = {'platform': 'cpu', 'kind': 'cpu', 'count': 1,
                'memory_peak_bytes': 0}
    if trace is not None:
        info['busy_s'] = trace.busy_s
        info['window_s'] = trace.window_s
    return info
