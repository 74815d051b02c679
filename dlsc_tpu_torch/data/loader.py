"""Host loader: batches prepared ahead on a background thread.

The port's copy of ``dlsc_tpu/data/loader.py`` ``prefetch``: one thread
stays ``size`` items ahead of the loop, computing ``transfer(item)`` for
each, with the same ordering, exception forwarding and early-close
semantics. The Trainer's ``transfer`` copies a batch to the card through
pinned memory on the step's stream (``train/loop.py``), so the copy of
batch i + 1 overlaps step i.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

_SENTINEL = object()


class _Error:
    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetch(iterator: Iterable, transfer: Callable, size: int = 2) -> Iterator:
    """Yield ``transfer(item)`` for each item, computed ``size`` items ahead
    on a daemon thread. An exception in the iterator or in ``transfer`` is
    raised in the consumer; closing the generator early (break,
    GeneratorExit) stops and unblocks the thread, and drops what it had
    queued."""
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()

    def put(obj) -> bool:
        while not stop.is_set():
            try:
                q.put(obj, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not put(transfer(item)):
                    return
        except BaseException as e:  # noqa: BLE001 — forwarded to the consumer
            put(_Error(e))
            return
        put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            if isinstance(item, _Error):
                raise item.exc
            yield item
    finally:
        stop.set()
        while not q.empty():  # drop staged items so their buffers free promptly
            try:
                q.get_nowait()
            except queue.Empty:
                break
