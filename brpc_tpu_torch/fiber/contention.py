"""Contention profiler (the port of brpc_tpu/fiber/contention.py):
samples FiberMutex lock-wait events through a
budgeted Collector (the reference's contention profiler lives inside
bthread/mutex.cpp and renders at /hotspots; here /contentions).

Each admitted sample records (site, wait_us) where site is the caller
frame that requested the lock — aggregation by site shows which lock
acquisition points hurt."""

from __future__ import annotations

import sys
from collections import defaultdict
from typing import Dict, List, NamedTuple, Tuple

from brpc_tpu_torch.butil.flags import define_flag, flag
from brpc_tpu_torch.bvar.collector import Collector

define_flag("contention_profiler_enabled", True,
            "sample FiberMutex contention events")
define_flag("contention_samples_per_second", 200,
            "budget for contention sampling")


class ContentionSample(NamedTuple):
    site: str
    wait_us: float


global_contention_collector = Collector(200, name="contention")


def _postfork_reset() -> None:
    """Fork hygiene: the samples describe the parent's lock waits and the
    budget lock may have been held by a dead thread; a shard starts with
    a clean contention profile."""
    import threading
    global_contention_collector._lock = threading.Lock()
    global_contention_collector._ring.clear()
    global_contention_collector._window_used = 0


from brpc_tpu_torch.butil import postfork as _postfork  # noqa: E402

_postfork.register("fiber.contention", _postfork_reset)


def record_contention(mutex, wait_us: float) -> None:
    if not flag("contention_profiler_enabled"):
        return
    rate = flag("contention_samples_per_second")
    if global_contention_collector._rate != rate:
        global_contention_collector.set_rate(rate)
    # caller site: frame(0)=here, frame(1)=lock/lock_pthread, frame(2)=user
    try:
        frame = sys._getframe(2)
    except ValueError:
        frame = sys._getframe(1)
    code = frame.f_code
    site = f"{code.co_name} ({code.co_filename.rsplit('/', 1)[-1]}:{frame.f_lineno})"
    global_contention_collector.submit(ContentionSample(site, wait_us))


def contention_report(top: int = 30) -> List[Tuple[str, int, float]]:
    """[(site, count, total_wait_us)] sorted by total wait."""
    agg: Dict[str, List[float]] = defaultdict(list)
    for s in global_contention_collector.snapshot():
        agg[s.site].append(s.wait_us)
    rows = [(site, len(waits), sum(waits)) for site, waits in agg.items()]
    rows.sort(key=lambda r: -r[2])
    return rows[:top]
