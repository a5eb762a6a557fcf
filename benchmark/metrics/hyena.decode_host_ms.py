"""Host ms a decode step of the server spends in the Hyena layers' spans
(`layer.hyena` under `engine.decode_step`), in the traced window."""

from benchmark import spans


def read(record):
    return spans.ms_per(record, 'layer.hyena', 'engine.decode_step',
                        parent='engine.decode_step', per_parent='serve.decode')
