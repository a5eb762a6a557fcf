"""Device idle time while the main thread was inside an `engine.*` span
(a forward or a segment's pass), over the traced window's host-clock
length, %."""

from benchmark import spans


def read(record):
    return spans.idle_share_in(record, spans.score_label, 'engine')
