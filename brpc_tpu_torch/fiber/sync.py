"""Blocking primitives on Butex (the port of brpc_tpu/fiber/sync.py;
bthread's mutex, condition variable and countdown event, all
butex-based in the reference).

Every primitive is dual-mode: awaitable from fibers, blocking from plain
threads, as the butex serves both kinds of waiter.
"""

from __future__ import annotations

import time
from typing import Optional

from .butex import WAIT_TIMEOUT, Butex
from .contention import record_contention


class FiberMutex:
    """bthread_mutex: a contended lock from a fiber suspends the fiber,
    never its worker thread.

    Contended acquisitions are sampled into the contention profiler
    (``contention.py``, bounded by its collector's budget per second),
    as bthread/mutex.cpp hooks its own: an uncontended lock pays one
    compare-exchange, a contended one one submit attempt."""

    def __init__(self):
        self._butex = Butex(0)  # 0 = unlocked, 1 = locked

    async def lock(self):
        if self._butex.compare_exchange(0, 1):
            return
        t0 = time.monotonic_ns()
        while not self._butex.compare_exchange(0, 1):
            await self._butex.wait(expected=1)
        record_contention(self, (time.monotonic_ns() - t0) / 1e3)

    def unlock(self):
        self._butex.set_value(0)
        self._butex.wake(1)

    def lock_pthread(self, timeout_s: Optional[float] = None) -> bool:
        if self._butex.compare_exchange(0, 1):
            return True
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        t0 = time.monotonic_ns()
        while not self._butex.compare_exchange(0, 1):
            remain = None if deadline is None else deadline - time.monotonic()
            if remain is not None and remain <= 0:
                return False
            self._butex.wait_pthread(expected=1, timeout_s=remain)
        record_contention(self, (time.monotonic_ns() - t0) / 1e3)
        return True

    async def __aenter__(self):
        await self.lock()
        return self

    async def __aexit__(self, *exc):
        self.unlock()
        return False


class FiberEvent:
    """One-shot event (set stays set)."""

    def __init__(self):
        self._butex = Butex(0)

    def is_set(self) -> bool:
        return self._butex.value == 1

    def set(self):
        self._butex.set_and_wake_all(1)

    async def wait(self, timeout_s: Optional[float] = None) -> bool:
        if self._butex.value == 1:
            return True
        res = await self._butex.wait(expected=0, timeout_s=timeout_s)
        return res != WAIT_TIMEOUT or self._butex.value == 1

    def wait_pthread(self, timeout_s: Optional[float] = None) -> bool:
        if self._butex.value == 1:
            return True
        res = self._butex.wait_pthread(expected=0, timeout_s=timeout_s)
        return res != WAIT_TIMEOUT or self._butex.value == 1


class CountdownEvent:
    """bthread::CountdownEvent: waiters wake when the count reaches 0."""

    def __init__(self, count: int = 1):
        self._butex = Butex(count)

    def signal(self, n: int = 1):
        with self._butex._lock:
            self._butex._value = max(0, self._butex._value - n)
            done = self._butex._value == 0
        if done:
            # wake only at zero: a waiter parked on a nonzero count
            # re-checked the value when it registered, so no decrement
            # can be missed
            self._butex.wake_all()

    def add_count(self, n: int = 1):
        self._butex.fetch_add(n)

    @property
    def count(self) -> int:
        return self._butex.value

    async def wait(self, timeout_s: Optional[float] = None) -> bool:
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while True:
            v = self._butex.value
            if v == 0:
                return True
            remain = None if deadline is None else deadline - time.monotonic()
            if remain is not None and remain <= 0:
                return False
            res = await self._butex.wait(expected=v, timeout_s=remain)
            if res == WAIT_TIMEOUT:
                return self._butex.value == 0

    def wait_pthread(self, timeout_s: Optional[float] = None) -> bool:
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while True:
            v = self._butex.value
            if v == 0:
                return True
            remain = None if deadline is None else deadline - time.monotonic()
            if remain is not None and remain <= 0:
                return False
            self._butex.wait_pthread(expected=v, timeout_s=remain)


class FiberCondition:
    """Condition variable over a FiberMutex (bthread_cond)."""

    def __init__(self, mutex: FiberMutex):
        self._mutex = mutex
        self._butex = Butex(0)

    async def wait(self, timeout_s: Optional[float] = None) -> bool:
        seq = self._butex.value
        self._mutex.unlock()
        res = await self._butex.wait(expected=seq, timeout_s=timeout_s)
        await self._mutex.lock()
        return res != WAIT_TIMEOUT

    def notify(self, n: int = 1):
        self._butex.fetch_add(1)
        self._butex.wake(n)

    def notify_all(self):
        self._butex.fetch_add(1)
        self._butex.wake_all()
