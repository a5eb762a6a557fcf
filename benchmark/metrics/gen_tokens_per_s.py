"""Generated tokens delivered to requests by every `step()` of the
window, over the window."""

from benchmark.readers import rate


def read(record):
    return rate(record, 'tokens')
