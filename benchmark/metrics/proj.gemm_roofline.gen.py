"""The bf16 projections of the traced window: every decode step's
products at the slot batch's rows (bound by the weights' bytes), plus
each admitted prompt's products at their operations alone (a lower
bound for the fills, whose row grouping the benchmark does not see),
over the cuBLAS bf16 kernels' device time, %."""

from benchmark import roofline
from benchmark.readers import share_of_bound


def read(record):
    t, w = record.trace, record.work
    if t is None or not w.get('decode_steps'):
        return None
    bound = w['decode_steps'] * roofline.projections_bound(
        w['slots'], record.cfg, record.peaks)
    bound += sum(roofline.projection_flops(P, record.cfg)
                 for P in w['admitted_prompts']) / record.peaks['bf16']
    return share_of_bound(bound, t.seconds('projections'))
