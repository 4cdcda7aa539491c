"""Host input pipeline: background prefetching, copied from
``rcgan_tpu/data/pipeline.py::Prefetcher``, so that batch assembly on the
host overlaps the device's work."""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator


class Prefetcher:
    """Wrap an iterator; a daemon thread keeps ``depth`` items ready.  An
    exception in the wrapped iterator is raised to the consumer."""

    _DONE = object()

    def __init__(self, it: Iterable, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err = None

        def worker():
            try:
                for item in it:
                    self._q.put(item)
            except BaseException as e:  # propagate into the consumer
                self._err = e
            finally:
                self._q.put(self._DONE)

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item
