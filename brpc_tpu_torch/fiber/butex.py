"""Butex: the futex of the fiber runtime (the port of
brpc_tpu/fiber/butex.py; bthread/butex.h:36-71).

A word with a wait queue that fibers and plain threads can both block
on: the base of every blocking primitive (mutex, condition, countdown,
join, stream credits).

Fiber waiters:  ``await butex.wait(expected)`` suspends the fiber unless
                the value already differs; ``wake`` puts it back on a
                run queue. The value is re-checked under the butex's
                lock at registration, which closes the check-then-sleep
                race as butex_wait's value test does.
Thread waiters: ``butex.wait_pthread(expected, timeout)`` parks the OS
                thread on an Event (the reference's pthread waiter).

Fiber wait timeouts go through the timer thread (``timer.py``).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Deque, Optional

from .scheduler import Fiber, SchedAwaitable

WAIT_OK = "ok"
WAIT_VALUE_CHANGED = "value_changed"
WAIT_TIMEOUT = "timeout"


class _FiberWaiter:
    __slots__ = ("fiber", "timer_id", "active")

    def __init__(self, fiber: Fiber):
        self.fiber = fiber
        self.timer_id = None
        self.active = True


class Butex:
    def __init__(self, value: int = 0):
        self._value = value
        self._lock = threading.Lock()
        self._fiber_waiters: Deque[_FiberWaiter] = deque()
        self._thread_waiters: Deque[threading.Event] = deque()

    # -------------------------------------------------------------- value
    @property
    def value(self) -> int:
        return self._value

    def set_value(self, v: int) -> None:
        with self._lock:
            self._value = v

    def fetch_add(self, delta: int) -> int:
        with self._lock:
            old = self._value
            self._value = old + delta
            return old

    def compare_exchange(self, expected: int, new: int) -> bool:
        with self._lock:
            if self._value != expected:
                return False
            self._value = new
            return True

    # --------------------------------------------------------------- wait
    def wait(self, expected: int,
             timeout_s: Optional[float] = None) -> SchedAwaitable:
        """Awaitable: park the current fiber while value == expected.
        Resumes with WAIT_OK / WAIT_VALUE_CHANGED / WAIT_TIMEOUT."""
        butex = self

        class _Wait(SchedAwaitable):
            def _register(self, fiber: Fiber):
                butex.add_waiter(fiber, expected, timeout_s)
        return _Wait()

    def add_waiter(self, fiber: Fiber, expected: int,
                   timeout_s: Optional[float] = None) -> None:
        """Register a suspended fiber; wake it at once if the value
        already changed (the butex_wait value test)."""
        with self._lock:
            if self._value != expected:
                fiber.control.schedule(fiber, WAIT_VALUE_CHANGED)
                return
            w = _FiberWaiter(fiber)
            self._fiber_waiters.append(w)
        if timeout_s is not None:
            from .timer import global_timer
            w.timer_id = global_timer().schedule_after(
                timeout_s, lambda: self._on_timeout(w))

    def _on_timeout(self, w: _FiberWaiter) -> None:
        with self._lock:
            if not w.active:
                return
            w.active = False
            try:
                self._fiber_waiters.remove(w)
            except ValueError:
                return
        w.fiber.control.schedule(w.fiber, WAIT_TIMEOUT)

    def wait_pthread(self, expected: int,
                     timeout_s: Optional[float] = None) -> str:
        """Blocking wait for plain threads."""
        with self._lock:
            if self._value != expected:
                return WAIT_VALUE_CHANGED
            ev = threading.Event()
            self._thread_waiters.append(ev)
        if ev.wait(timeout_s):
            return WAIT_OK
        with self._lock:
            try:
                self._thread_waiters.remove(ev)
            except ValueError:
                return WAIT_OK          # woken as the timeout fired
        return WAIT_TIMEOUT

    # --------------------------------------------------------------- wake
    def wake(self, n: int = 1) -> int:
        """Wake up to n waiters (fibers first); returns how many woke."""
        fibers = []
        events = []
        with self._lock:
            while n > 0 and self._fiber_waiters:
                w = self._fiber_waiters.popleft()
                w.active = False
                fibers.append(w)
                n -= 1
            while n > 0 and self._thread_waiters:
                events.append(self._thread_waiters.popleft())
                n -= 1
        for w in fibers:
            if w.timer_id is not None:
                from .timer import global_timer
                global_timer().unschedule(w.timer_id)
            w.fiber.control.schedule(w.fiber, WAIT_OK)
        for ev in events:
            ev.set()
        return len(fibers) + len(events)

    def wake_all(self) -> int:
        return self.wake(1 << 30)

    def set_and_wake_all(self, value: int) -> int:
        with self._lock:
            self._value = value
        return self.wake_all()
