"""The 95th percentile, over every delivery of new tokens to a request in
the window, of the time since that request's previous delivery (or its
submission) divided by the tokens it carried, ms. A per-layer metric:
its runs on unchanged code spread by 16-26 % (the 95th percentile sits
where the first deliveries, which carry the queue's wait, begin), too
wide for an end-to-end bound."""

import numpy as np


def read(record):
    gaps = record.counters.get('gaps_ms')
    return float(np.percentile(gaps, 95)) if gaps else None
