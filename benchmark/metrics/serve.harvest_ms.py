"""Host ms a `GenerationServer.step()` spends in its `serve.harvest` span:
recording the chunk's tokens and the deferred first tokens, in the traced
window."""

from benchmark import spans


def read(record):
    return spans.ms_per(record, 'serve.harvest', 'serve.step')
