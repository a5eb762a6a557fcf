"""Device idle time while the main thread was in none of the program's
spans (the benchmark's own loop, the wait for the prefetch thread, a
cache's allocation), over the traced window's host-clock length, %."""

from benchmark import spans


def read(record):
    return spans.idle_share_in(record, spans.score_label, 'outside')
