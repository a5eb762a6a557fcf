"""Device idle time while the main thread was in no `serve.step` at all
(the benchmark's own loop), over the traced window's host-clock length,
%."""

from benchmark import spans


def read(record):
    return spans.idle_share_in(record, spans.serve_label, 'outside')
