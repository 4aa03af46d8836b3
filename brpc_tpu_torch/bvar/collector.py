"""Collector (the port of brpc_tpu/bvar/collector.py): the global
sampling funnel for heavyweight samples with a
per-second budget (bvar/collector.{h,cpp} — what bounds rpcz span and
rpc_dump overhead in the reference).

Submission is lock-cheap and never blocks the caller: a token bucket
admits at most ``samples_per_second``; admitted samples land in a
bounded ring. Consumers drain() or snapshot()."""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Deque, List, Optional

from brpc_tpu_torch.bvar.reducer import Adder


class Collector:
    def __init__(self, samples_per_second: int = 1000,
                 max_pending: int = 10_000, name: str = ""):
        self._rate = samples_per_second
        self._ring: Deque[Any] = deque(maxlen=max_pending)
        self._lock = threading.Lock()
        self._window_start = time.monotonic()
        self._window_used = 0
        self.nsubmitted = Adder(0)
        self.nsampled = Adder(0)
        self.ndropped = Adder(0)
        if name:
            self.nsubmitted.expose(f"{name}_submitted")
            self.nsampled.expose(f"{name}_sampled")
            self.ndropped.expose(f"{name}_dropped")

    def submit(self, sample: Any) -> bool:
        """True if admitted within this second's budget."""
        self.nsubmitted.add(1)
        now = time.monotonic()
        with self._lock:
            if now - self._window_start >= 1.0:
                self._window_start = now
                self._window_used = 0
            if self._window_used >= self._rate:
                admitted = False
            else:
                self._window_used += 1
                self._ring.append(sample)
                admitted = True
        if admitted:
            self.nsampled.add(1)
        else:
            self.ndropped.add(1)
        return admitted

    def drain(self) -> List[Any]:
        with self._lock:
            out, self._ring = list(self._ring), deque(
                maxlen=self._ring.maxlen)
        return out

    def snapshot(self, n: Optional[int] = None) -> List[Any]:
        with self._lock:
            items = list(self._ring)
        return items[-n:] if n else items

    def set_rate(self, samples_per_second: int) -> None:
        with self._lock:
            self._rate = samples_per_second
