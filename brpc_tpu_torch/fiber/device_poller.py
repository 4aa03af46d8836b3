"""DeviceEventPoller: fibers park on device work and futures (the port of
brpc_tpu/fiber/device_poller.py).

``await device_ready(obj)`` parks the calling fiber until ``obj`` is
ready and never blocks a worker. The wait takes the object's own
completion signal:

* a ``concurrent.futures.Future`` (``add_done_callback``): its done
  callback, at no cost;
* an object with ``synchronize()`` (a ``torch.cuda.Event``) or
  ``block_until_ready()``: one daemon waiter thread per wait, blocked in
  the object's own wait (``cudaEventSynchronize`` releases the
  interpreter lock), up to ``_MAX_WAITERS`` at once;
* anything else with ``query()`` or ``is_ready()``, and every wait over
  the cap: the poll pump, one thread that spins a few rounds and then
  sleeps 200 us between sweeps.

An object already ready resumes the fiber at once. The fiber resumes
with the object itself, or with a Future's result. The waiter and pump
threads carry a device thread label while they run
(``transport/device_stats.stamp_device_thread``).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, List, Optional, Tuple

from brpc_tpu_torch.transport.device_stats import (stamp_device_thread,
                                                   unstamp_device_thread)

from .scheduler import Fiber, SchedAwaitable

log = logging.getLogger("brpc_tpu_torch.fiber")

# waiter threads parked at once; beyond, waits go to the fair poll pump
# (a bounded executor queue would let stalled waits starve ready ones)
_MAX_WAITERS = 128


def _readiness(obj: Any) -> Optional[bool]:
    """Whether ``obj`` is ready; None when it has no way to say."""
    for name in ("is_ready", "query", "done"):
        fn = getattr(obj, name, None)
        if fn is not None:
            return bool(fn())
    return None


def _is_ready(obj: Any) -> bool:
    return _readiness(obj) is not False


def _blocking_wait(obj: Any) -> Optional[Callable[[], Any]]:
    for name in ("synchronize", "block_until_ready"):
        fn = getattr(obj, name, None)
        if fn is not None:
            return fn
    return None


class DeviceEventPoller:
    """Event-driven waits with a polling pump behind them."""

    def __init__(self, name: str = "device_poller"):
        self._cond = threading.Condition()
        self._pending: List[Tuple[Any, Callable[[], None]]] = []
        self._thread: Optional[threading.Thread] = None
        self._name = name
        self._stop = False
        self._active_waiters = 0
        self._waiter_lock = threading.Lock()
        # statistics: waits by way, and the most waiter threads at once
        self.nwaits = {"callback": 0, "ready": 0, "waiter": 0, "pump": 0}
        self.max_active_waiters = 0

    @property
    def active_waiters(self) -> int:
        return self._active_waiters

    def watch(self, obj: Any, on_ready: Callable[[], None]) -> None:
        """``on_ready()`` once ``obj`` is ready, from whichever thread saw
        it."""
        add_cb = getattr(obj, "add_done_callback", None)
        if add_cb is not None:
            self.nwaits["callback"] += 1
            add_cb(lambda _f: on_ready())
            return
        block = _blocking_wait(obj)
        ready = _readiness(obj)
        if ready or (ready is None and block is None):
            self.nwaits["ready"] += 1
            on_ready()
            return
        if block is not None:
            with self._waiter_lock:
                can_wait = self._active_waiters < _MAX_WAITERS
                if can_wait:
                    self._active_waiters += 1
                    self.max_active_waiters = max(self.max_active_waiters,
                                                  self._active_waiters)
            if can_wait:
                self.nwaits["waiter"] += 1
                threading.Thread(target=self._wait_and_fire,
                                 args=(block, on_ready),
                                 name=f"{self._name}_wait",
                                 daemon=True).start()
                return
        self.nwaits["pump"] += 1
        with self._cond:
            self._pending.append((obj, on_ready))
            self._ensure_thread()
            self._cond.notify()

    def _wait_and_fire(self, block, on_ready) -> None:
        stamp_device_thread("device:wait")
        try:
            block()             # the device's own wait, lock released
        except Exception:       # an error shows where the result is used
            log.debug("device wait raised", exc_info=True)
        finally:
            with self._waiter_lock:
                self._active_waiters -= 1
        try:
            on_ready()
        except Exception:       # boundary: the waiter thread ends here
            log.exception("device waiter callback failed")
        finally:
            # the thread ends here: a label left behind would pin an
            # entry for a dead thread id
            unstamp_device_thread()

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._stop = False
            self._thread = threading.Thread(target=self._run,
                                            name=self._name, daemon=True)
            self._thread.start()

    def _run(self) -> None:
        # the pump's sweeps belong to the device lane; the unstamp is in
        # a finally, so a pump that dies leaves no stale label
        stamp_device_thread(f"device:{self._name}")
        try:
            self._run_inner()
        finally:
            unstamp_device_thread()

    def _run_inner(self) -> None:
        idle_spins = 0
        while not self._stop:
            with self._cond:
                if not self._pending:
                    self._cond.wait(0.5)
                    continue
                pending, self._pending = self._pending, []
            still = []
            fired = 0
            for obj, cb in pending:
                if _is_ready(obj):
                    fired += 1
                    try:
                        cb()
                    except Exception:   # boundary: the pump goes on
                        log.exception("device poller callback failed")
                else:
                    still.append((obj, cb))
            if still:
                with self._cond:
                    self._pending.extend(still)
            if fired:
                idle_spins = 0
            else:
                # device events complete in microseconds: spin a few
                # rounds, then sleep a little to spare the host
                idle_spins += 1
                if idle_spins > 64:
                    time.sleep(0.0002)

    def stop(self) -> None:
        self._stop = True
        with self._cond:
            self._cond.notify()


_global_poller: Optional[DeviceEventPoller] = None
_lock = threading.Lock()


def global_poller() -> DeviceEventPoller:
    global _global_poller
    if _global_poller is None:
        with _lock:
            if _global_poller is None:
                _global_poller = DeviceEventPoller()
    return _global_poller


def _postfork_reset() -> None:
    """Fork hygiene: the pump and the parked fibers belong to the parent.
    Not registered, as the other fiber modules' resets are not
    (scheduler.py ``_postfork_reset``)."""
    global _global_poller, _lock
    _global_poller = None
    _lock = threading.Lock()


class _Ready(SchedAwaitable):
    def __init__(self, obj: Any):
        self._obj = obj

    def _register(self, fiber: Fiber) -> None:
        obj = self._obj

        def on_ready():
            result = obj
            if hasattr(obj, "done") and hasattr(obj, "result"):
                try:
                    result = obj.result()
                except Exception:
                    result = obj
            fiber.control.schedule(fiber, result)
        global_poller().watch(obj, on_ready)


def device_ready(obj: Any) -> SchedAwaitable:
    """Awaitable: park the fiber until ``obj`` (a ``torch.cuda.Event``,
    a Future, anything with ``synchronize``/``query``) is ready, then
    resume with it (a Future's result for a Future)."""
    return _Ready(obj)
