"""Scored nucleotides (padding and BOS left out) of every call completed
in the window, over the time to complete them."""

from benchmark.readers import rate


def read(record):
    return rate(record, 'scored_nt')
