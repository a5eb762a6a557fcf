"""Row-steps of the decode chunks whose token was thrown away (an idle
row, or one past its request's end), over the row-steps, in the traced
window (the program's counters), %."""

from benchmark import spans


def read(record):
    return spans.counter_share(record, 'serve.slot_steps_wasted',
                               'serve.slot_steps')
