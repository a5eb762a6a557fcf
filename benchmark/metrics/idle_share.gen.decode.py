"""Device idle time while the main thread's innermost child span of
`serve.step` was `serve.decode` (launching the decode chunk), over the
traced window's host-clock length, %."""

from benchmark import spans


def read(record):
    return spans.idle_share_in(record, spans.serve_label, 'decode')
