"""Host ms a `GenerationServer.step()` spends in its `serve.decode` span:
launching the decode chunk (its `steps_per_sync` decode steps and their
sampling), in the traced window."""

from benchmark import spans


def read(record):
    return spans.ms_per(record, 'serve.decode', 'serve.step')
