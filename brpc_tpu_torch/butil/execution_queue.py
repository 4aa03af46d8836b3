"""ExecutionQueue: run a consumer over submitted items one at a time, in
submission order, on a thread of the queue's own (the thread-backed
stand-in for brpc_tpu/fiber/execution_queue.py until the port has a
fiber scheduler).

``execute`` never blocks and never runs the consumer on the caller's
thread, so a connection's reader can hand frames over and go on
reading. The drain thread starts with the first item and ends after
``IDLE_S`` without one; a consumer that raises is logged and the drain
goes on with the next item.
"""

from __future__ import annotations

import logging
import threading
from collections import deque
from typing import Any, Callable

log = logging.getLogger("brpc_tpu_torch.butil")

IDLE_S = 1.0    # a drain thread outlives its last item by this long


class ExecutionQueue:
    def __init__(self, consumer: Callable[[Any], None], name: str = "xq"):
        self._consumer = consumer
        self._name = name
        self._items: deque = deque()
        self._cond = threading.Condition()
        self._running = False       # a drain thread owns the queue

    def execute(self, item: Any) -> None:
        with self._cond:
            self._items.append(item)
            if self._running:
                self._cond.notify()
                return
            self._running = True
        threading.Thread(target=self._drain, name=self._name,
                         daemon=True).start()

    def _drain(self) -> None:
        while True:
            with self._cond:
                if not self._items:
                    self._cond.wait(IDLE_S)
                if not self._items:
                    self._running = False
                    return
                item = self._items.popleft()
            try:
                self._consumer(item)
            except Exception:           # boundary: keep draining
                log.exception("%s: consumer failed", self._name)
