"""ExecutionQueue: an MPSC serialized executor (the port of
brpc_tpu/fiber/execution_queue.py; bthread/execution_queue.h).

Producers append to a deque (GIL-atomic) and, when no drainer runs,
spawn one fiber that hands the consumer everything queued as one batch,
again until the queue is empty. Exactly one drainer runs at a time, so
items from one producer are consumed in the order it pushed them: the
property the stream's ordered delivery and the HTTP path's one answer
at a time rest on.
"""

from __future__ import annotations

import inspect
import logging
import threading
from collections import deque
from typing import Any, Callable, Iterable, Optional

from .scheduler import TaskControl, global_control

log = logging.getLogger("brpc_tpu_torch.fiber")


class ExecutionQueue:
    def __init__(self, execute: Callable[[Iterable[Any]], Any],
                 control: Optional[TaskControl] = None,
                 name: str = "execq"):
        """``execute(tasks)`` receives a list of tasks, called from a
        fiber; it may be sync or async (then it is awaited)."""
        self._execute = execute
        self._control = control
        self._q: deque = deque()
        self._flag_lock = threading.Lock()
        self._draining = False
        self._stopped = False
        self._name = name
        self._idle = threading.Event()
        self._idle.set()

    def execute(self, task: Any) -> bool:
        """Push a task; False if the queue is stopped."""
        if self._stopped:
            return False
        self._q.append(task)
        self._maybe_start_drainer()
        return True

    def _maybe_start_drainer(self) -> None:
        with self._flag_lock:
            if self._draining or not self._q:
                return
            self._draining = True
            self._idle.clear()
        ctrl = self._control or global_control()
        ctrl.spawn(self._drain, name=self._name)

    async def _drain(self) -> None:
        while True:
            batch = []
            while True:
                try:
                    batch.append(self._q.popleft())
                except IndexError:
                    break
            if batch:
                try:
                    r = self._execute(batch)
                    if inspect.isawaitable(r):
                        await r
                except Exception:       # boundary: the queue keeps draining
                    log.exception("%s: consumer failed", self._name)
            with self._flag_lock:
                if not self._q:
                    self._draining = False
                    self._idle.set()
                    return

    def stop(self) -> None:
        """Refuse further tasks; what is queued is still consumed."""
        self._stopped = True

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait (from a plain thread) until the queue is drained."""
        return self._idle.wait(timeout)
