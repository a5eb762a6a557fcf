"""Kernel 1 (RMSNorm) in the traced window: two a layer and the final
norm in every forward or segment, bytes-bound at that pass's rows
(`roofline.rmsnorm_bound`), over its device time, %."""

from benchmark import roofline
from benchmark.readers import per_forward


def read(record):
    cfg = record.cfg
    return per_forward(
        record, 'norms', 'rmsnorm_kernel', 2 * cfg['num_layers'] + 1,
        lambda rows, _off: roofline.rmsnorm_bound(
            rows, cfg['hidden_size'], record.peaks)[0])
