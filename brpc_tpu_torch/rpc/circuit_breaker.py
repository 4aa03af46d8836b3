"""Circuit breakers (the port of brpc_tpu/rpc/circuit_breaker.py;
brpc/circuit_breaker.h:25-52, cluster_recover_policy.*).

One breaker an endpoint keeps two EWMAs of its error rate, a short
twitchy one and a long stable one; either over its threshold isolates
the endpoint for an isolation that doubles with each trip (0.1 s to 30
s). ``ClusterBreakers`` holds a channel's breakers and its recovery
gate: when half the cluster or more is isolated it isolates none, so a
full outage can recover.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Dict

from brpc_tpu_torch.butil.endpoint import EndPoint


class CircuitBreaker:
    SHORT_ALPHA = 0.3
    LONG_ALPHA = 0.02
    ERROR_THRESHOLD = 0.5      # short-window trip
    LONG_THRESHOLD = 0.2       # long-window trip
    MIN_SAMPLES = 5
    BASE_ISOLATION_S = 0.1
    MAX_ISOLATION_S = 30.0

    def __init__(self):
        self._short = 0.0
        self._long = 0.0
        self._samples = 0
        self._isolated_until = 0.0
        self._isolation_s = self.BASE_ISOLATION_S
        self._trips = 0
        self._lock = threading.Lock()

    def on_call(self, failed: bool) -> None:
        x = 1.0 if failed else 0.0
        with self._lock:
            self._samples += 1
            self._short = ((1 - self.SHORT_ALPHA) * self._short
                           + self.SHORT_ALPHA * x)
            self._long = ((1 - self.LONG_ALPHA) * self._long
                          + self.LONG_ALPHA * x)
            if self._samples >= self.MIN_SAMPLES and (
                    self._short > self.ERROR_THRESHOLD
                    or self._long > self.LONG_THRESHOLD):
                now = time.monotonic()
                if now >= self._isolated_until:
                    self._isolated_until = now + self._isolation_s
                    self._isolation_s = min(self._isolation_s * 2,
                                            self.MAX_ISOLATION_S)
                    self._trips += 1
                self._short = 0.0
                self._samples = 0

    def on_success_streak(self) -> None:
        """Sustained health halves the next isolation."""
        with self._lock:
            self._isolation_s = max(self.BASE_ISOLATION_S,
                                    self._isolation_s / 2)

    def isolated(self) -> bool:
        return time.monotonic() < self._isolated_until

    def error_rate(self) -> float:
        return self._short

    @property
    def isolated_until(self) -> float:
        """When the isolation ends, monotonic seconds (0.0: never)."""
        return self._isolated_until

    @property
    def isolation_s(self) -> float:
        """The next trip's isolation."""
        return self._isolation_s

    def snapshot(self) -> dict:
        with self._lock:
            now = time.monotonic()
            return {
                "isolated": now < self._isolated_until,
                "isolated_for_s": max(0.0, self._isolated_until - now),
                "isolation_s": self._isolation_s,
                "error_rate_short": self._short,
                "error_rate_long": self._long,
                "samples": self._samples,
                "trips": self._trips,
            }


# every live ClusterBreakers of the process, weakly held, for the
# breaker pane of /connections: breakers belong to client channels, but
# are read from whatever server the process runs
_registry: "weakref.WeakSet[ClusterBreakers]" = weakref.WeakSet()


def all_breaker_snapshots() -> Dict[str, dict]:
    """Endpoint -> breaker snapshot over every cluster channel (an
    endpoint two channels reach shows the last one's)."""
    out: Dict[str, dict] = {}
    for cb in list(_registry):
        out.update(cb.snapshot())
    return out


class ClusterBreakers:
    RECOVER_FRACTION = 0.5

    def __init__(self):
        self._breakers: Dict[EndPoint, CircuitBreaker] = {}
        self._lock = threading.Lock()
        _registry.add(self)

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            items = list(self._breakers.items())
        return {str(ep): b.snapshot() for ep, b in items}

    def items(self):
        with self._lock:
            return list(self._breakers.items())

    def breaker(self, ep: EndPoint) -> CircuitBreaker:
        b = self._breakers.get(ep)
        if b is None:
            with self._lock:
                b = self._breakers.setdefault(ep, CircuitBreaker())
        return b

    def on_call(self, ep: EndPoint, failed: bool) -> None:
        self.breaker(ep).on_call(failed)

    def isolated_set(self, servers) -> set:
        """The endpoints to exclude, under the recovery gate."""
        iso = {s for s in servers
               if s in self._breakers and self._breakers[s].isolated()}
        if servers and len(iso) >= max(
                1, int(len(servers) * self.RECOVER_FRACTION)):
            return set()        # too many down: let traffic probe all
        return iso
