"""Kernel 4 at one query row (the split key range and the combine
kernel) in the traced window's decode chunks: the K and V bytes of every
slot's live prefix at every decode step, with its query and output, in
each attention layer, over the 3.35 TB/s memory rate, over the split and
combine kernels' device time, %. The few split launches of fill tails
(at most 16 rows) are in the time and not in the bound, so the share
reads low by their part."""

from benchmark.readers import decode_prefixes, share_of_bound


def read(record):
    t, w = record.trace, record.work
    if t is None or not w.get('live'):
        return None
    cfg = record.cfg
    rows, keys = decode_prefixes(w)
    per_pos = cfg['hidden_size'] * 2            # one head set, bf16
    nbytes = (2 * keys + 2 * rows) * per_pos * len(cfg['attn_layer_idxs'])
    time_s = (t.seconds('attention', 'flash_buffer_bf16_split_kernel')
              + t.seconds('attention', 'combine_partials_kernel'))
    return share_of_bound(nbytes / record.peaks['bytes_s'], time_s)
