"""Host clock over the window's `GenerationServer.step()` calls: window
over steps, ms."""


def read(record):
    c = record.counters
    if not c.get('steps'):
        return None
    return 1e3 * c['window_s'] / c['steps']
