"""TimerThread: one thread, nearest-deadline sleep (the port of
brpc_tpu/fiber/timer.py; bthread/timer_thread.h:53). Backs fiber sleeps,
butex wait timeouts and periodic tasks."""

from __future__ import annotations

import heapq
import itertools
import logging
import threading
import time
from typing import Callable, Dict, Optional

from .scheduler import Fiber, SchedAwaitable

log = logging.getLogger("brpc_tpu_torch.fiber")


class TimerThread:
    def __init__(self, name: str = "fiber_timer"):
        self._cond = threading.Condition()
        self._heap: list = []          # (deadline, tid, [fn]): fn boxed so
        #                                unschedule can drop it at once
        self._boxes: Dict[int, list] = {}
        self._ndead = 0                # cancelled entries still heaped
        self._seq = itertools.count()
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._name = name

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._stop = False
            self._thread = threading.Thread(target=self._run,
                                            name=self._name, daemon=True)
            self._thread.start()

    def schedule_at(self, deadline: float, fn: Callable[[], None]) -> int:
        """``deadline`` in time.monotonic() seconds; returns a timer id."""
        with self._cond:
            tid = next(self._seq)
            box = [fn]
            self._boxes[tid] = box
            # wake the thread only when this deadline beats the current
            # front: its sleep already covers any later one
            wake = not self._heap or deadline < self._heap[0][0]
            heapq.heappush(self._heap, (deadline, tid, box))
            self._ensure_thread()
            if wake:
                self._cond.notify()
        return tid

    def schedule_after(self, delay_s: float, fn: Callable[[], None]) -> int:
        return self.schedule_at(time.monotonic() + max(0.0, delay_s), fn)

    def unschedule(self, tid: int) -> None:
        """Cancel a timer and drop its callback now: a callback holds
        what it closes over until its deadline otherwise."""
        with self._cond:
            box = self._boxes.pop(tid, None)
            if box is not None:
                box[0] = None
                self._ndead += 1
                # compact when dead entries dominate, so a stream of
                # armed-and-cancelled waits does not pile up dead fronts
                if self._ndead > 64 and self._ndead * 2 > len(self._heap):
                    self._heap = [e for e in self._heap
                                  if e[2][0] is not None]
                    heapq.heapify(self._heap)
                    self._ndead = 0

    def _run(self) -> None:
        while not self._stop:
            with self._cond:
                now = time.monotonic()
                while self._heap and self._heap[0][0] <= now:
                    _, tid, box = heapq.heappop(self._heap)
                    self._boxes.pop(tid, None)
                    fn = box[0]
                    if fn is None:
                        if self._ndead > 0:
                            self._ndead -= 1
                        continue
                    self._cond.release()
                    try:
                        fn()
                    except Exception:   # boundary: the timer goes on
                        log.exception("timer callback failed")
                    finally:
                        self._cond.acquire()
                    now = time.monotonic()
                wait = (self._heap[0][0] - now) if self._heap else 1.0
                self._cond.wait(min(max(wait, 0.0), 1.0))

    def pending(self) -> int:
        """Live (not cancelled) timers."""
        with self._cond:
            return len(self._boxes)

    def stop(self) -> None:
        self._stop = True
        with self._cond:
            self._cond.notify()


_global_timer: Optional[TimerThread] = None
_lock = threading.Lock()


def global_timer() -> TimerThread:
    global _global_timer
    if _global_timer is None:
        with _lock:
            if _global_timer is None:
                _global_timer = TimerThread()
    return _global_timer


def _postfork_reset() -> None:
    """Fork hygiene: the timer thread died with the parent, and every
    heaped callback closes over the parent's state. Not registered yet:
    the port's postfork registry comes with shard groups (ROADMAP §1)."""
    global _global_timer, _lock
    _global_timer = None
    _lock = threading.Lock()


from brpc_tpu_torch.butil import resource_census as _census  # noqa: E402
#   (the census registration ships with the singleton it measures;
#   it peeks: a census read must not start the timer thread)

_census.register("timers", lambda: {
    "count": _global_timer.pending() if _global_timer is not None else 0})


def sleep(seconds: float) -> SchedAwaitable:
    """Awaitable fiber sleep (bthread_usleep)."""

    class _Sleep(SchedAwaitable):
        def _register(self, fiber: Fiber):
            global_timer().schedule_after(
                seconds, lambda: fiber.control.schedule(fiber, None))
    return _Sleep()


def sleep_us(us: float) -> SchedAwaitable:
    return sleep(us / 1e6)


class PeriodicTask:
    """Re-arms itself after each run until ``fn`` returns False or
    ``stop`` is called (brpc/periodic_task.*)."""

    def __init__(self, interval_s: float, fn: Callable[[], bool | None],
                 timer: Optional[TimerThread] = None):
        self._interval = interval_s
        self._fn = fn
        self._timer = timer or global_timer()
        self._stopped = False
        self._arm()

    def _arm(self):
        self._tid = self._timer.schedule_after(self._interval, self._tick)

    def _tick(self):
        if self._stopped:
            return
        keep = self._fn()
        if keep is not False and not self._stopped:
            self._arm()

    def stop(self):
        self._stopped = True
        self._timer.unschedule(self._tid)
