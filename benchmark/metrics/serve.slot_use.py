"""Decoded tokens delivered to live requests over decode steps times
slots, in the window, %."""


def read(record):
    c = record.counters
    if not c.get('decode_steps'):
        return None
    return 100.0 * c['decode_tokens'] / (c['decode_steps'] * c['slots'])
