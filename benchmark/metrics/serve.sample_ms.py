"""Host ms a decode step of the server spends sampling (`serve.sample`),
in the traced window."""

from benchmark import spans


def read(record):
    return spans.ms_per(record, 'serve.sample', 'engine.decode_step',
                        per_parent='serve.decode')
