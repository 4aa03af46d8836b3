"""PeriodicTask: a callback run on an interval by the fiber timer, with
no thread of its own (the port of brpc_tpu/rpc/periodic_task.py;
brpc/periodic_task.{h,cpp}).

The delay is fixed: the next run is scheduled once the current one has
returned, so a slow run never piles runs up. ``interval_s`` may be a
callable, read before each wait. ``destroy()`` stops the task; a run in
progress finishes and schedules nothing. ``live_tasks()`` counts the
tasks not destroyed.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Optional, Union

from brpc_tpu_torch.fiber.timer import global_timer

log = logging.getLogger("brpc_tpu_torch.rpc")

_live: set = set()
_live_lock = threading.Lock()


def live_tasks() -> int:
    """PeriodicTasks created and not destroyed."""
    with _live_lock:
        return len(_live)


class PeriodicTask:
    def __init__(self, fn: Callable[[], None],
                 interval_s: Union[float, Callable[[], float]],
                 run_immediately: bool = False):
        self._fn = fn
        self._interval = interval_s
        self._lock = threading.Lock()
        self._stopped = False
        self._timer_id: Optional[int] = None
        with _live_lock:
            _live.add(self)
        if run_immediately:
            self._run()
        else:
            self._schedule()

    def _delay(self) -> float:
        return self._interval() if callable(self._interval) \
            else float(self._interval)

    def _schedule(self) -> None:
        with self._lock:
            if self._stopped:
                return
            self._timer_id = global_timer().schedule_after(
                self._delay(), self._run)

    def _run(self) -> None:
        try:
            self._fn()
        except Exception:               # boundary: the task keeps its turn
            log.exception("periodic task failed")
        self._schedule()

    def destroy(self) -> None:
        with self._lock:
            self._stopped = True
            tid, self._timer_id = self._timer_id, None
        with _live_lock:
            _live.discard(self)
        if tid is not None:
            global_timer().unschedule(tid)
