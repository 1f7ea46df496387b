"""Background-thread batch prefetching (the port's copy of
``vaenar_tts_tpu/utils/prefetch.py``).

Host-side batch assembly (memmap reads and padding) overlaps with device
compute through a small bounded queue, so memory stays flat. A consumer
that abandons the generator early (break or exception, such as the
training loop's mid-epoch stop on SIGTERM) releases the worker: close()
sets a stop flag and drains the queue, so that a blocked put() wakes up and
the thread exits instead of holding depth + 1 batches for the rest of the
process.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


def prefetch(iterable: Iterable[T], depth: int = 2) -> Iterator[T]:
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    err: list = []
    stop = threading.Event()

    def _put(item) -> bool:
        while True:
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                if stop.is_set():
                    return False

    def worker():
        try:
            for item in iterable:
                if stop.is_set() or not _put(item):
                    return
        except BaseException as e:  # raised again in the consumer
            err.append(e)
        finally:
            _put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        # the consumer finished or abandoned the generator: unblock the
        # worker and reap it either way
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        t.join(timeout=5.0)
