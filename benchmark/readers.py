"""What the metric files read, for the metrics that two kinds of cell
report alike (`idle_share.score` and `idle_share.gen` and so on): a
metric file names its reader here. Every reader returns None where the
run has nothing for it to read (an untraced run, a kernel the path does
not launch), and never 0 in place of a share it could not read."""

from __future__ import annotations

import json
import os

from benchmark import roofline

HERE = os.path.dirname(os.path.abspath(__file__))


def _classes():
    with open(os.path.join(HERE, 'kernel_layers.json')) as f:
        table = json.load(f)
    return table['library_gemm'], table['port_kernels']


def rate(record, work: str):
    c = record.counters
    if work not in c:
        return None
    return c[work] / c['window_s']


def idle_share(record):
    t = record.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def peak_gib(record):
    peak = record.counters.get('peak_bytes', 0)
    return peak / 2 ** 30 if peak else None


def mfu(record):
    c = record.counters
    if not c.get('model_flops'):
        return None
    return 100.0 * c['model_flops'] / c['window_s'] / record.peaks['bf16']


def unmapped_share(record):
    t = record.trace
    if t is None or t.device_s <= 0:
        return None
    return 100.0 * t.seconds('unmapped') / t.device_s


def plain_ops_share(record):
    """Device time in kernels that are neither library products nor the
    port's own kernels, over all device time."""
    t = record.trace
    if t is None or t.device_s <= 0:
        return None
    library, port = _classes()
    named = sum(t.seconds(layer) for layer in library + port)
    return 100.0 * (t.device_s - named) / t.device_s


def share_of_bound(bound_s: float, kernel_s: float):
    if kernel_s <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / kernel_s


def per_forward(record, layer: str, contains: str, per_fwd: int, bound):
    """A kernel launched `per_fwd` times in each forward (or segment) of
    the traced window, `bound(rows, offset)` seconds a launch: its share
    of the summed bound. None unless the launches are those counted."""
    t = record.trace
    forwards = record.work.get('segments') or [
        (b * n, 0) for b, n in record.work.get('forwards', [])]
    if t is None or not forwards:
        return None
    if t.count(layer, contains) != per_fwd * len(forwards):
        return None
    total = sum(per_fwd * bound(rows, off) for rows, off in forwards)
    return share_of_bound(total, t.seconds(layer, contains))


def gemm_roofline_score(record):
    """The bf16 projections of every traced forward: their summed bounds
    over the cuBLAS bf16 kernels' time."""
    t = record.trace
    fwd = record.work.get('forwards')
    if t is None or not fwd:
        return None
    bound = sum(roofline.projections_bound(b * n, record.cfg, record.peaks)
                for b, n in fwd)
    return share_of_bound(bound, t.seconds('projections'))


def decode_prefixes(work: dict):
    """(row-steps, summed live prefixes) of the traced decode chunks: a
    slot's request with `before` tokens had its offset at P + max(before,
    1) - 1 when the chunk began, and decode step j reads keys [0, offset
    + j]; an empty slot starts at offset 0."""
    S, slots = work['steps_per_sync'], work['slots']
    rows, keys = 0, 0
    tri = S * (S + 1) // 2
    for live in work['live']:
        for P, before, _after in live:
            keys += S * (P + max(before, 1) - 1) + tri
        keys += (slots - len(live)) * tri
        rows += slots * S
    return rows, keys
