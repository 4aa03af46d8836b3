"""MultiDimension: labeled (prometheus-style) metrics (the port of
brpc_tpu/bvar/multi_dimension.py) — the reference's mbvar
(bvar/multi_dimension{_inl}.h, mvariable.cpp).

One MultiDimension owns a family of per-label-combination stats created
on demand from a factory: ``qps = MultiDimension(["method", "status"],
Adder); qps.get_stats(("Echo", "ok")).add(1)``. get_value() snapshots
{labels_tuple: value}; the prometheus dumper renders proper
``name{method="Echo",status="ok"} N`` lines."""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from brpc_tpu_torch.bvar.variable import Variable


class MultiDimension(Variable):
    def __init__(self, label_names: Sequence[str],
                 stat_factory: Callable[[], Variable]):
        super().__init__()
        self._label_names = tuple(label_names)
        self._factory = stat_factory
        self._stats: Dict[Tuple, Variable] = {}
        self._lock = threading.Lock()

    @property
    def label_names(self) -> Tuple[str, ...]:
        return self._label_names

    def _key(self, label_values: Sequence) -> Tuple:
        key = tuple(str(v) for v in label_values)
        if len(key) != len(self._label_names):
            raise ValueError(
                f"expected {len(self._label_names)} labels "
                f"{self._label_names}, got {len(key)}")
        return key

    def get_stats(self, label_values: Sequence) -> Variable:
        """The per-combination stat, created on first use (mbvar
        get_stats). Hot path after creation is one dict lookup."""
        key = self._key(label_values)
        stat = self._stats.get(key)
        if stat is not None:
            return stat
        with self._lock:
            stat = self._stats.get(key)
            if stat is None:
                stat = self._factory()
                # publish under the lock; dict assignment is atomic so
                # lock-free readers see either nothing or the final stat
                self._stats[key] = stat
            return stat

    def has_stats(self, label_values: Sequence) -> bool:
        return self._key(label_values) in self._stats

    def delete_stats(self, label_values: Sequence) -> None:
        with self._lock:
            self._stats.pop(self._key(label_values), None)

    def count_stats(self) -> int:
        return len(self._stats)

    def list_stats(self) -> List[Tuple]:
        return sorted(self._stats.keys())

    def get_value(self) -> Dict[Tuple, object]:
        with self._lock:
            items = list(self._stats.items())
        return {k: v.get_value() for k, v in items}

    def labeled_items(self) -> List[Tuple[Tuple, object]]:
        """(label_values_tuple, value) pairs — the prometheus dumper
        reads labels through this instead of get_value(), so a subclass
        may flatten get_value() keys for JSON consumers (/vars) without
        losing its label structure in the metrics dump."""
        with self._lock:
            items = list(self._stats.items())
        return [(k, v.get_value()) for k, v in items]

    def describe(self) -> str:
        return (f"MultiDimension({','.join(self._label_names)}: "
                f"{self.count_stats()} series)")
