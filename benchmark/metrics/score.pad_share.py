"""Share of the positions that `score_stream` handed the model which are
padding (neither BOS nor a nucleotide), from the shapes of its calls in
the window, %."""


def read(record):
    c = record.counters
    if not c.get('handed_positions'):
        return None
    return 100.0 * c['pad_positions'] / c['handed_positions']
