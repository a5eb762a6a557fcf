"""Threaded map-ahead prefetching, the host half of a data pipeline (the
port's own copy of `evo_tpu/io/prefetch.py`).

CUDA launches return before the card is done, so the host's preparation
of batch i+1 and the readback of batch i-1 can both hide under the
device time of batch i. `prefetch_map` is the preparation half: a worker
thread applies `fn` up to `depth` items ahead of the consumer.

Exceptions raised by `fn` surface at the consumer's next iteration step
(not silently on the worker thread).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar('T')
U = TypeVar('U')

_SENTINEL = object()


def prefetch_map(fn: Callable[[T], U], items: Iterable[T],
                 depth: int = 2) -> Iterator[U]:
    """Yield fn(item) for each item, in order, computed up to `depth`
    ahead on a worker thread; a depth below 1 runs in line. A consumer
    that abandons the generator stops the worker."""
    if depth < 1:
        for item in items:
            yield fn(item)
        return

    q: 'queue.Queue' = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def _put(msg) -> bool:
        # bounded put that gives up when the consumer abandoned the
        # generator (a plain q.put would block the worker forever)
        while not stop.is_set():
            try:
                q.put(msg, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in items:
                if stop.is_set():
                    return
                if not _put(('ok', fn(item))):
                    return
        except BaseException as e:          # noqa: BLE001 - re-raised below
            _put(('err', e))
        finally:
            _put((_SENTINEL, None))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            kind, val = q.get()
            if kind is _SENTINEL:
                break
            if kind == 'err':
                raise val
            yield val
        t.join()
    finally:
        stop.set()
