"""Percentile estimator: per-thread reservoir samples combined on read
(the port of brpc_tpu/bvar/percentile.py; bvar/detail/percentile.{h,cpp}).

Each thread keeps a bounded reservoir; get_percentile merges reservoirs.
Like the reference, accuracy degrades gracefully under load instead of the
write path ever blocking.
"""

from __future__ import annotations

import threading
from typing import List

from brpc_tpu_torch.butil.fast_rand import fast_rand_less_than
from brpc_tpu_torch.bvar.variable import Variable

_RESERVOIR_SIZE = 1024


class _Reservoir:
    __slots__ = ("samples", "num_added")

    def __init__(self):
        self.samples: List[float] = []
        self.num_added = 0

    def add(self, v: float):
        self.num_added += 1
        s = self.samples  # snapshot the binding: reset() may swap in a new list
        if len(s) < _RESERVOIR_SIZE:
            s.append(v)
        else:
            i = fast_rand_less_than(self.num_added)
            if i < _RESERVOIR_SIZE:
                try:
                    s[i] = v
                except IndexError:
                    pass  # lost the race with reset(); drop one sample


class Percentile(Variable):
    def __init__(self):
        super().__init__()
        self._lock = threading.Lock()
        self._reservoirs: dict = {}
        # samples from dead threads whose ids were reused (bounded fold)
        self._folded: List[float] = []
        self._tls = threading.local()

    def _local(self) -> _Reservoir:
        r = getattr(self._tls, "res", None)
        if r is None:
            r = _Reservoir()
            self._tls.res = r
            tid = threading.get_ident()
            with self._lock:
                stale = self._reservoirs.get(tid)
                if stale is not None:
                    self._folded.extend(stale.samples)
                    del self._folded[:-_RESERVOIR_SIZE * 4]
                self._reservoirs[tid] = r
        return r

    def add(self, v: float):
        self._local().add(v)

    __lshift__ = lambda self, v: (self.add(v), self)[1]

    def merged_samples(self) -> List[float]:
        with self._lock:
            rs = list(self._reservoirs.values())
            out: List[float] = list(self._folded)
        for r in rs:
            out.extend(r.samples)
        return out

    @staticmethod
    def _pick(sorted_samples: List[float], ratio: float) -> float:
        if not sorted_samples:
            return 0.0
        idx = min(len(sorted_samples) - 1, int(ratio * len(sorted_samples)))
        return sorted_samples[idx]

    def get_percentile(self, ratio: float) -> float:
        """ratio in [0,1], e.g. 0.99 for p99."""
        return self._pick(sorted(self.merged_samples()), ratio)

    def get_value(self):
        s = sorted(self.merged_samples())  # merge+sort once for all quantiles
        return {
            "p50": self._pick(s, 0.5),
            "p90": self._pick(s, 0.9),
            "p99": self._pick(s, 0.99),
            "p999": self._pick(s, 0.999),
        }

    def reset(self):
        with self._lock:
            rs = list(self._reservoirs.values())
            out: List[float] = self._folded
            self._folded = []
        for r in rs:
            out.extend(r.samples)
            r.samples = []
            r.num_added = 0
        return out
