"""Host ms a `GenerationServer.step()` spends in its `serve.readback` span:
the decode chunk's one read to the host, where the host waits for the
device, in the traced window."""

from benchmark import spans


def read(record):
    return spans.ms_per(record, 'serve.readback', 'serve.step')
