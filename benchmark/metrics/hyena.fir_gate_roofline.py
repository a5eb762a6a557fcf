"""Kernel 2 (FIR + gate) in the traced window: the summed bound of its
launches, one a Hyena layer of every forward or segment, at that pass's
rows (`roofline.fir_gate_bound`, bytes-bound), over its device time, %."""

from benchmark import roofline
from benchmark.readers import per_forward


def read(record):
    cfg = record.cfg
    n = cfg['num_layers'] - len(cfg['attn_layer_idxs'])
    return per_forward(
        record, 'hyena', 'fir_gate_kernel', n,
        lambda rows, _off: roofline.fir_gate_bound(
            rows, cfg['hidden_size'], record.peaks)[0])
