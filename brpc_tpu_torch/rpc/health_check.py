"""Health checking (the port of brpc_tpu/rpc/health_check.py;
details/health_check.cpp:59-146).

A failed endpoint joins the dead set and a fiber probes it, with a
jittered exponential backoff (50 ms to 5 s), until a connect succeeds;
then it is revived. With ``app_check`` (``rpc_health_check``) revival
also needs one call to succeed, so a server that accepts connections but
cannot answer stays dead. A probe fiber waits on the checker's stop
event, so ``stop`` ends every probe at once; ``live_checks()`` counts
the probe fibers still running.
"""

from __future__ import annotations

import random
import threading
from typing import Callable, Optional, Set

from brpc_tpu_torch.butil.endpoint import EndPoint
from brpc_tpu_torch.fiber import TaskControl, global_control
from brpc_tpu_torch.fiber.sync import FiberEvent
from brpc_tpu_torch.transport.base import get_transport

from .channel import Channel, ChannelOptions

_live = 0
_live_lock = threading.Lock()


def live_checks() -> int:
    """Probe fibers still running, in every HealthChecker."""
    with _live_lock:
        return _live


def _count(n: int) -> None:
    global _live
    with _live_lock:
        _live += n


def rpc_health_check(service: str = "health", method: str = "Check",
                     timeout_ms: float = 1000.0, request: bytes = b""
                     ) -> Callable[[EndPoint], bool]:
    """An ``app_check`` that calls the endpoint once, on a connection of
    its own, and wants the call to succeed (health_check.cpp:59)."""

    def check(ep: EndPoint) -> bool:
        ch = Channel(str(ep), ChannelOptions(timeout_ms=timeout_ms,
                                             max_retry=0,
                                             name="health_probe",
                                             share_connections=False))
        try:
            return not ch.call_sync(service, method, request).failed()
        except Exception:
            return False
        finally:
            ch.close()

    return check


class HealthChecker:
    BASE_BACKOFF_S = 0.05
    MAX_BACKOFF_S = 5.0
    # each wait is backoff * [1 - J, 1 + J): without it the endpoints of a
    # mass death would all probe a recovering server at the same moments
    JITTER = 0.5

    def __init__(self, control: Optional[TaskControl] = None,
                 app_check: Optional[Callable[[EndPoint], bool]] = None,
                 rng: Optional[random.Random] = None,
                 on_event: Optional[Callable[[str, EndPoint], None]] = None):
        self._control = control or global_control()
        self._dead: Set[EndPoint] = set()
        self._checking: Set[EndPoint] = set()
        self._lock = threading.Lock()
        self._stopped = False
        self._stop_event = FiberEvent()
        self._app_check = app_check
        self._rng = rng or random.Random()
        # ("dead" | "revived", endpoint), outside the lock; it may not
        # raise into the check fiber
        self._on_event = on_event

    def _emit(self, event: str, ep: EndPoint) -> None:
        cb = self._on_event
        if cb is None:
            return
        try:
            cb(event, ep)
        except Exception:
            pass

    def _jittered(self, backoff: float) -> float:
        return backoff * (1.0 + self.JITTER
                          * (2.0 * self._rng.random() - 1.0))

    def dead_set(self) -> Set[EndPoint]:
        with self._lock:
            return set(self._dead)

    def mark_dead(self, ep: EndPoint) -> None:
        with self._lock:
            if self._stopped or ep in self._checking:
                if ep in self._checking:
                    self._dead.add(ep)
                return
            self._dead.add(ep)
            self._checking.add(ep)
        self._emit("dead", ep)
        _count(1)
        self._control.spawn(self._check_loop, ep, name=f"health_{ep.host}")

    def retain(self, servers) -> None:
        """Forget endpoints no longer named."""
        keep = set(servers)
        with self._lock:
            self._dead &= keep

    def _probe(self, ep: EndPoint) -> bool:
        try:
            get_transport(ep.scheme).connect(ep).close()
        except Exception:
            return False
        if self._app_check is None:
            return True
        # the connect works; revival wants a call that works too (it
        # may block: it runs in this check fiber)
        try:
            return bool(self._app_check(ep))
        except Exception:
            return False

    async def _check_loop(self, ep: EndPoint):
        backoff = self.BASE_BACKOFF_S
        while not self._stopped:
            with self._lock:
                if ep not in self._dead:
                    break               # dropped from naming, or revived
            await self._stop_event.wait(self._jittered(backoff))
            if self._stopped:
                break
            if not self._probe(ep):
                backoff = min(backoff * 2, self.MAX_BACKOFF_S)
                continue
            with self._lock:
                self._dead.discard(ep)
            self._emit("revived", ep)
            break
        with self._lock:
            self._checking.discard(ep)
            # marked dead again between the revival and here: mark_dead
            # saw it checking and spawned nothing, so check it again
            respawn = not self._stopped and ep in self._dead
            if respawn:
                self._checking.add(ep)
        if respawn:
            self._control.spawn(self._check_loop, ep,
                                name=f"health_{ep.host}")
        else:
            _count(-1)

    def stop(self):
        self._stopped = True
        self._stop_event.set()
