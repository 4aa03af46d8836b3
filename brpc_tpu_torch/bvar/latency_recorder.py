"""LatencyRecorder: qps + latency avg + percentiles + max in one composite
(the port of brpc_tpu/bvar/latency_recorder.py;
bvar/latency_recorder.h:75)."""

from __future__ import annotations

from typing import Optional

from brpc_tpu_torch.bvar.reducer import Adder, IntRecorder, Maxer
from brpc_tpu_torch.bvar.percentile import Percentile
from brpc_tpu_torch.bvar.variable import Variable
from brpc_tpu_torch.bvar.window import PerSecond, Sampler


class LatencyRecorder(Variable):
    def __init__(self, window_size: int = 10, sampler: Optional[Sampler] = None):
        super().__init__()
        self._latency = IntRecorder()
        self._max_latency = Maxer()
        self._percentile = Percentile()
        self._count = Adder(0)
        self._qps = PerSecond(self._count, window_size, sampler)

    def record(self, latency_us: float):
        self._latency.record(latency_us)
        self._max_latency.update(latency_us)
        self._percentile.add(latency_us)
        self._count.add(1)

    def record_batch(self, avg_latency_us: float, n: int):
        """Account ``n`` calls served as one batch (the native serving
        loop measures the batch, not each call): the average lands in
        sum/count exactly, and contributes one percentile sample —
        reservoir percentiles are sampled estimates either way."""
        self._latency.record(avg_latency_us, n)
        self._max_latency.update(avg_latency_us)
        self._percentile.add(avg_latency_us)
        self._count.add(n)

    __lshift__ = lambda self, v: (self.record(v), self)[1]

    def latency(self) -> float:
        return self._latency.average()

    def latency_percentile(self, ratio: float) -> float:
        return self._percentile.get_percentile(ratio)

    def max_latency(self) -> float:
        return self._max_latency.get_value() or 0

    def count(self) -> int:
        return self._count.get_value()

    def qps(self) -> float:
        return self._qps.get_value()

    def get_value(self):
        return {
            "count": self.count(),
            "qps": self.qps(),
            "latency_avg_us": self.latency(),
            "latency_p50_us": self.latency_percentile(0.5),
            "latency_p90_us": self.latency_percentile(0.9),
            "latency_p99_us": self.latency_percentile(0.99),
            "latency_p999_us": self.latency_percentile(0.999),
            "max_latency_us": self.max_latency(),
        }

    def expose(self, name: str):
        super().expose(name)
        return self
