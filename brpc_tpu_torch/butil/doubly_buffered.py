"""DoublyBufferedData: read-mostly data with lock-free reads (the port of
brpc_tpu/butil/doubly_buffered.py; butil/containers/doubly_buffered_data.h:86).

The reference's C++ keeps a foreground and a background copy and a lock
per reading thread; it backs every load balancer's server list. Under
the interpreter lock one attribute read is already atomic, so readers
take the current snapshot with one load, and a writer builds the next
snapshot under a lock and publishes it with one store: readers always
see a whole value and writers never block them.
"""

from __future__ import annotations

import threading
from typing import Callable, Generic, TypeVar

T = TypeVar("T")


class DoublyBufferedData(Generic[T]):
    def __init__(self, initial: T) -> None:
        self._snapshot = initial
        self._write_lock = threading.Lock()

    def read(self) -> T:
        """Lock-free; treat the result as immutable."""
        return self._snapshot

    def modify(self, fn: Callable[[T], T]) -> T:
        """Writers one at a time; ``fn`` maps the old snapshot to the new
        one and must not change the old one in place (readers may still
        hold it)."""
        with self._write_lock:
            new = fn(self._snapshot)
            self._snapshot = new
            return new
