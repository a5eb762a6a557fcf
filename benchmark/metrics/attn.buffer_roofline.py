"""Kernels 3 and 4 over the traced sequence's segments: each attention
layer of each segment of 8,192 query rows at its offset over the KV
buffer (the first segment fresh, the causal kernel), operations-bound
(`roofline.attention_buffer_bound`), summed over the segments, over
their device time, %."""

from benchmark import roofline
from benchmark.readers import per_forward


def read(record):
    cfg = record.cfg
    if not record.work.get('segments'):
        return None
    H = cfg['num_attention_heads']
    return per_forward(
        record, 'attention', 'flash_sm90_kernel',
        len(cfg['attn_layer_idxs']),
        lambda rows, off: roofline.attention_buffer_bound(
            rows, off, H, cfg['hidden_size'] // H, record.peaks)[0])
