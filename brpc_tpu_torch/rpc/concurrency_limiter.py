"""Concurrency limiters (the port of brpc_tpu/rpc/concurrency_limiter.py;
brpc/concurrency_limiter.h:29, policy/auto_concurrency_limiter.cpp,
policy/timeout_concurrency_limiter.cpp).

``constant``: a fixed limit of requests in flight. ``auto``: a gradient
limit: it grows while latency stays near the best seen and shrinks when
it inflates. ``timeout``: a request is admitted while the queueing it
would meet (in flight x the latency EWMA) fits the timeout.

The Server drives the limiter its ``max_concurrency`` spec names, and
the method's own from ``method_max_concurrency``, through
``on_requested`` / ``on_responded`` (``Server.on_request_start`` and
``on_request_end``). A slot may weigh more than one
(``ServerOptions(request_costs=True)``, ``admission.CostModel``); a
release passes the cost its admission charged.
"""

from __future__ import annotations

import threading
import time
from typing import Optional


class ConcurrencyLimiter:
    def on_requested(self, cost: float = 1.0) -> bool:
        """False: reject with ELIMIT."""
        raise NotImplementedError

    def on_responded(self, latency_us: float, failed: bool,
                     cost: float = 1.0) -> None:
        raise NotImplementedError

    @property
    def max_concurrency(self) -> int:
        raise NotImplementedError


class ConstantLimiter(ConcurrencyLimiter):
    def __init__(self, limit: int):
        self._limit = limit
        self._inflight = 0.0
        self._lock = threading.Lock()

    def on_requested(self, cost: float = 1.0) -> bool:
        # admitted while the weighted load sits below the limit: a heavy
        # request at the edge may overshoot by its own cost (a weighted
        # semaphore: light traffic cannot starve it)
        with self._lock:
            if self._inflight >= self._limit:
                return False
            self._inflight += cost
            return True

    def on_responded(self, latency_us, failed, cost: float = 1.0):
        with self._lock:
            self._inflight = max(0.0, self._inflight - cost)

    @property
    def inflight(self) -> float:
        return self._inflight

    @property
    def max_concurrency(self):
        return self._limit


class AutoLimiter(ConcurrencyLimiter):
    """A Vegas-like gradient limit. Windows close on time as well as on
    count (a limit shrunk under light traffic must not wait forever for
    SAMPLE_WINDOW responses), and a failed response returns its slot
    but feeds no latency (a reject's near-zero latency would grow the
    limit into the overload)."""

    MIN_LIMIT = 2
    MAX_LIMIT = 4096
    SAMPLE_WINDOW = 100
    MIN_WINDOW_SAMPLES = 8      # a window closed by time needs this many
    WINDOW_S = 1.0
    INFLATE_TOLERANCE = 1.5     # latency may inflate this much
    GROW = 1.1
    SHRINK = 0.8

    def __init__(self, initial: int = 32, min_concurrency: int = 4,
                 max_concurrency: int = 4096):
        self.min_concurrency = max(self.MIN_LIMIT, int(min_concurrency))
        self.max_limit = min(self.MAX_LIMIT, max(int(max_concurrency),
                                                 self.min_concurrency))
        self._limit = float(min(max(initial, self.min_concurrency),
                                self.max_limit))
        self._inflight = 0.0
        self._lock = threading.Lock()
        self._best_latency = float("inf")
        self._lat_sum = 0.0
        self._lat_n = 0
        self._win_start = time.monotonic()

    def on_requested(self, cost: float = 1.0) -> bool:
        with self._lock:
            if self._inflight >= int(self._limit):
                return False
            self._inflight += cost
            return True

    def on_responded(self, latency_us, failed, cost: float = 1.0):
        with self._lock:
            self._inflight = max(0.0, self._inflight - cost)
            if failed:
                return
            self._lat_sum += latency_us
            self._lat_n += 1
            if self._lat_n < self.SAMPLE_WINDOW:
                now = time.monotonic()
                if (now - self._win_start < self.WINDOW_S
                        or self._lat_n < self.MIN_WINDOW_SAMPLES):
                    return
            self._close_window_locked()

    def _close_window_locked(self) -> None:
        avg = self._lat_sum / self._lat_n
        self._lat_sum = 0.0
        self._lat_n = 0
        self._win_start = time.monotonic()
        self._best_latency = min(self._best_latency, avg)
        if avg > self._best_latency * self.INFLATE_TOLERANCE:
            self._limit = max(self.min_concurrency, self._limit * self.SHRINK)
            # forgive the past: latency regimes change
            self._best_latency = min(avg, self._best_latency * 1.1)
        else:
            self._limit = min(self.max_limit, self._limit * self.GROW)

    @property
    def inflight(self) -> float:
        return self._inflight

    @property
    def max_concurrency(self):
        return int(self._limit)


class TimeoutLimiter(ConcurrencyLimiter):
    """Admit while the expected wait, in flight x the latency EWMA,
    still fits the timeout: a request that would time out in the queue
    is shed at the door instead of holding a slot."""

    MIN_LIMIT = 2
    EMA_ALPHA = 0.2

    def __init__(self, timeout_ms: float):
        self._timeout_us = float(timeout_ms) * 1e3
        self._ema_us = 0.0
        self._inflight = 0.0
        self._lock = threading.Lock()

    def on_requested(self, cost: float = 1.0) -> bool:
        with self._lock:
            if self._inflight >= self.MIN_LIMIT and self._ema_us > 0:
                if (self._inflight + cost) * self._ema_us > self._timeout_us:
                    return False
            self._inflight += cost
            return True

    def on_responded(self, latency_us, failed, cost: float = 1.0):
        # failures count: in a sustained overload every request dies at
        # the timeout, and the EWMA must see it
        with self._lock:
            self._inflight = max(0.0, self._inflight - cost)
            if latency_us > 0:
                if self._ema_us == 0:
                    self._ema_us = latency_us
                else:
                    self._ema_us += self.EMA_ALPHA * (latency_us
                                                      - self._ema_us)

    @property
    def max_concurrency(self):
        with self._lock:
            if self._ema_us <= 0:
                return 1 << 30
            return max(self.MIN_LIMIT, int(self._timeout_us / self._ema_us))


def new_limiter(spec) -> Optional[ConcurrencyLimiter]:
    """None | an int | ``constant:N`` | ``N`` | ``auto[:initial[:min[:max]]]``
    | ``timeout:MS`` (the reference's ``-max_concurrency`` vocabulary)."""
    if spec is None:
        return None
    if isinstance(spec, int):
        return ConstantLimiter(spec)
    if isinstance(spec, str):
        if spec == "auto" or spec.startswith("auto:"):
            args = [int(p) for p in spec.split(":")[1:]]
            names = ("initial", "min_concurrency", "max_concurrency")
            return AutoLimiter(**dict(zip(names, args)))
        if spec.startswith("constant:"):
            return ConstantLimiter(int(spec.split(":", 1)[1]))
        if spec.startswith("timeout:"):
            return TimeoutLimiter(float(spec.split(":", 1)[1]))
        if spec.isdigit():
            return ConstantLimiter(int(spec))
    raise ValueError(f"bad concurrency limiter spec {spec!r}")
