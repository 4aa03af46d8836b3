"""Trend rings over every exposed variable (the port of
brpc_tpu/bvar/series.py; bvar/detail/series.h): the time axis under
/vars and /timeline.

One ring set per exposed variable, stamped on the global sampler's tick
(``bvar/window.py``, the thread that already samples every window once a
second): 60 one-second buckets cascade into 60 one-minute buckets, which
cascade into 24 one-hour buckets. A bucket's value by kind:

  delta    — counters (Adder, a declared monotone PassiveStatus): the
             difference of two readings; cascades sum.
  last     — gauges: the last reading; cascades keep the last.
  max/min  — Maxer readings and instant-quantile gauges keep the max,
             Miner readings the min (told apart by the reducer's op), so
             a p99 spike survives into the minute ring.
  quantile — LatencyRecorders: {count: the interval's delta, p50/p99/max:
             instant readings}; cascades sum the counts and keep each
             field's maximum, never an average.

``BRPC_TPU_TORCH_BVAR_SERIES=0`` in the environment, or the
``bvar_series_enabled`` flag, parks the engine. A name re-exposed under
a new variable object (``unexpose_all``, then ``Server.start``) keeps its
history and re-baselines its delta, so a restart never makes a spike.

The anomaly watchdog (``bvar/anomaly.py``) rides the same tick: each
stored bucket of a watch key feeds its pass. Everything the tick reaches
binds its imports at module load, never on the sampler thread.
``merge_timeline_states`` is the shard groups' merge of the shards'
rings (``rpc/shard_group.py``).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from brpc_tpu_torch.butil.flags import define_flag, flag
from brpc_tpu_torch.bvar.anomaly import (bind_watchdog_imports,
                                         is_watch_key as _is_watch_key,
                                         watchdog_sample_pass)
from brpc_tpu_torch.bvar.variable import dump_exposed_variables

define_flag("bvar_series_enabled", True,
            "attach trend rings (60x1s -> 60x1m -> 24x1h) to every "
            "exposed bvar on the sampler tick; serves /timeline and the "
            "/vars sparklines. BRPC_TPU_TORCH_BVAR_SERIES=0 in the "
            "environment overrides to off")
define_flag("bvar_series_max_vars", 256,
            "most exposed variables tracked by the series engine "
            "(sorted by name; the rest are skipped, never sampled)")

SEC_BUCKETS = 60
MIN_BUCKETS = 60
HOUR_BUCKETS = 24

KIND_DELTA = "delta"
KIND_LAST = "last"
KIND_MAX = "max"
KIND_MIN = "min"
KIND_QUANTILE = "quantile"

_SPARK = "▁▂▃▄▅▆▇█"


def series_enabled() -> bool:
    """The engine's one gate: the environment first (it wins over a
    /flags change), then the flag."""
    if os.environ.get("BRPC_TPU_TORCH_BVAR_SERIES", "1") == "0":
        return False
    return bool(flag("bvar_series_enabled"))


def sparkline(values, width: int = 30) -> str:
    """Unicode sparkline of the last ``width`` numeric values: "" for no
    numbers, the floor glyph for a constant series, min..max over the
    whole glyph ramp otherwise."""
    vals = [float(v) for v in values
            if isinstance(v, (int, float)) and not isinstance(v, bool)]
    vals = vals[-width:]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    if hi <= lo:
        return _SPARK[0] * len(vals)
    span = hi - lo
    return "".join(_SPARK[min(len(_SPARK) - 1,
                              int((v - lo) / span * len(_SPARK)))]
                   for v in vals)


def _combine(kind: str, a, b):
    """Fold bucket ``b`` into accumulator ``a`` (the cascade's op)."""
    if a is None:
        return b
    if b is None:
        return a
    if kind == KIND_DELTA:
        return a + b
    if kind == KIND_LAST:
        return b
    if kind == KIND_MAX:
        return max(a, b)
    if kind == KIND_MIN:
        return min(a, b)
    # quantile: counts sum, the percentile fields keep the worst
    out = dict(a)
    out["count"] = (a.get("count", 0) or 0) + (b.get("count", 0) or 0)
    for k in ("p50", "p99", "max"):
        out[k] = max(a.get(k, 0) or 0, b.get(k, 0) or 0)
    return out


class _Ring:
    """One variable's three levels: seconds cascade into minutes, minutes
    into hours."""

    __slots__ = ("kind", "sec", "min", "hr",
                 "_min_acc", "_min_n", "_hr_acc", "_hr_n")

    def __init__(self, kind: str):
        self.kind = kind
        self.sec: deque = deque(maxlen=SEC_BUCKETS)
        self.min: deque = deque(maxlen=MIN_BUCKETS)
        self.hr: deque = deque(maxlen=HOUR_BUCKETS)
        self._min_acc = None
        self._min_n = 0
        self._hr_acc = None
        self._hr_n = 0

    def push(self, t: int, value) -> None:
        self.sec.append((t, value))
        self._min_acc = _combine(self.kind, self._min_acc, value)
        self._min_n += 1
        if self._min_n >= SEC_BUCKETS:
            self.min.append((t, self._min_acc))
            self._hr_acc = _combine(self.kind, self._hr_acc,
                                    self._min_acc)
            self._hr_n += 1
            self._min_acc, self._min_n = None, 0
            if self._hr_n >= MIN_BUCKETS:
                self.hr.append((t, self._hr_acc))
                self._hr_acc, self._hr_n = None, 0

    def to_dict(self) -> dict:
        # live_sec/live_min: buckets not yet cascaded into the level
        # above (the seconds ring slides, so it still shows buckets a
        # rolled minute holds: exact sums read minutes + live_sec)
        return {"kind": self.kind,
                "sec": [[t, v] for t, v in self.sec],
                "min": [[t, v] for t, v in self.min],
                "hr": [[t, v] for t, v in self.hr],
                "live_sec": self._min_n, "live_min": self._hr_n}


class _Entry:
    __slots__ = ("ring", "vid", "prev", "touched")

    def __init__(self, kind: str, vid: int):
        self.ring = _Ring(kind)
        self.vid = vid          # id() of the variable: a re-exposed name
        #                         re-baselines instead of making a delta
        self.prev = None        # the previous cumulative reading
        self.touched = 0.0


def detect_kind(var) -> Optional[str]:
    """By shape, with no import of the other bvar modules: a
    LatencyRecorder first, then the reducer's ``SERIES_MODE``, then a
    gauge."""
    if hasattr(var, "_percentile") and hasattr(var, "latency_percentile"):
        return KIND_QUANTILE
    mode = getattr(var, "SERIES_MODE", None)
    if mode == "cumulative":
        return KIND_DELTA
    if mode == "delta":
        # Maxer and Miner share the shape; the op tells them apart
        op = getattr(var, "_op", None)
        if op is not None:
            try:
                if op(0, 1) == 0:
                    return KIND_MIN
            except Exception:
                pass
        return KIND_MAX
    return KIND_LAST


class SeriesCollector:
    """The process's ring registry. ``_lock`` is a leaf: it guards the
    rings only; every variable read happens before it is taken."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[str, _Entry] = {}
        self._declared: Dict[str, str] = {}

    def declare_kind(self, name: str, kind: str) -> None:
        """A declared kind wins over detection: a monotone PassiveStatus
        (``server_processed``) graphs as a rate only when declared a
        counter."""
        with self._lock:
            self._declared[name] = kind

    def collect_readings(self) -> List[Tuple[str, int, str, object]]:
        """Phase 1, no lock held: read every tracked variable, skipping
        the readings that are not numbers."""
        cap = max(1, int(flag("bvar_series_max_vars")))
        with self._lock:
            declared = dict(self._declared)
        pairs = dump_exposed_variables("")
        if len(pairs) > cap:
            # the watch keys and the declared series keep their places
            # first; the rest fill the cap by name
            priority = [(n, v) for n, v in pairs
                        if n in declared or _is_watch_key(n)]
            rest = [(n, v) for n, v in pairs
                    if n not in declared and not _is_watch_key(n)]
            pairs = (priority + rest)[:cap]
        out: List[Tuple[str, int, str, object]] = []
        for name, var in pairs:
            kind = declared.get(name) or detect_kind(var)
            try:
                if kind == KIND_QUANTILE:
                    raw = {"count": int(var.count()),
                           "p50": float(var.latency_percentile(0.5)),
                           "p99": float(var.latency_percentile(0.99)),
                           "max": float(var.max_latency() or 0)}
                else:
                    v = var.get_value()
                    if not isinstance(v, (int, float)) or \
                            isinstance(v, bool):
                        continue
                    raw = v
            except Exception:
                continue    # a raising passive must not end the tick
            out.append((name, id(var), kind, raw))
        return out

    def store_readings(self, readings, t: int) -> Dict[str, float]:
        """Phase 2, under the lock: readings become buckets. Returns the
        watch points for the watchdog (key -> the bucket just stored)."""
        points: Dict[str, float] = {}
        now = time.monotonic()
        with self._lock:
            for name, vid, kind, raw in readings:
                e = self._entries.get(name)
                if e is None or e.ring.kind != kind:
                    e = self._entries[name] = _Entry(kind, vid)
                if e.vid != vid:
                    # re-exposed under a new object: keep the ring,
                    # re-baseline
                    e.vid = vid
                    e.prev = None
                e.touched = now
                if kind == KIND_DELTA:
                    prev, e.prev = e.prev, raw
                    bucket = raw - prev if prev is not None else 0
                    if bucket < 0:      # a counter reset: re-baseline
                        bucket = 0
                elif kind == KIND_QUANTILE:
                    prev, e.prev = e.prev, raw["count"]
                    dc = raw["count"] - prev if prev is not None else 0
                    bucket = {"count": max(0, dc), "p50": raw["p50"],
                              "p99": raw["p99"], "max": raw["max"]}
                else:
                    bucket = raw
                e.ring.push(t, bucket)
                if kind == KIND_QUANTILE:
                    # the .p99 track passes the same predicate, so a
                    # pinned anomaly_watch_filter silences it too
                    key = name + ".p99"
                    if _is_watch_key(key):
                        points[key] = bucket["p99"]
                elif _is_watch_key(name):
                    points[name] = float(bucket)
            self._prune_locked(now)
        return points

    def _prune_locked(self, now: float) -> None:
        cap = max(1, int(flag("bvar_series_max_vars")))
        if len(self._entries) <= cap:
            return
        # the least recently touched names go first
        for name in sorted(self._entries,
                           key=lambda n: self._entries[n].touched):
            if len(self._entries) <= cap:
                break
            del self._entries[name]

    def has_series(self, name: str) -> bool:
        with self._lock:
            return name in self._entries

    def tracked_names(self) -> List[str]:
        with self._lock:
            return sorted(self._entries)

    def spark(self, name: str, width: int = 30) -> str:
        """The seconds ring's sparkline for /vars (a quantile series
        draws its p99 track)."""
        with self._lock:
            e = self._entries.get(name)
            if e is None or len(e.ring.sec) < 2:
                return ""
            vals = [v for _, v in e.ring.sec]
            kind = e.ring.kind
        if kind == KIND_QUANTILE:
            vals = [v.get("p99", 0) for v in vals]
        return sparkline(vals, width)

    def dump_series(self, names: Optional[List[str]] = None,
                    prefix: str = "",
                    max_vars: Optional[int] = None) -> Dict[str, dict]:
        with self._lock:
            picked = []
            for name in sorted(self._entries):
                if names is not None and name not in names:
                    continue
                if prefix and not name.startswith(prefix):
                    continue
                picked.append(name)
                if max_vars is not None and len(picked) >= max_vars:
                    break
            return {n: self._entries[n].ring.to_dict() for n in picked}

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()


_collector: Optional[SeriesCollector] = None
_collector_lock = threading.Lock()


def global_series() -> SeriesCollector:
    global _collector
    if _collector is None:
        with _collector_lock:
            if _collector is None:
                _collector = SeriesCollector()
    return _collector


def declare_series_kind(name: str, kind: str) -> None:
    global_series().declare_kind(name, kind)


# two tickers (the sampler thread, a test driving time by hand) must not
# interleave collect and store: an out-of-order store would re-baseline
# a delta downwards. The loser skips its stamp.
_tick_serial = threading.Lock()


def series_sample_tick(wall_t: Optional[int] = None) -> None:
    """The per-second stamp, from the global sampler's tick and from
    tests driving time by hand (``wall_t`` pins the bucket's stamp;
    stamps are wall-clock seconds). Never raises."""
    if not series_enabled():
        return
    if not _tick_serial.acquire(blocking=False):
        return
    try:
        col = global_series()
        t = int(time.time()) if wall_t is None else int(wall_t)
        points = col.store_readings(col.collect_readings(), t)
        watchdog_sample_pass(points, t)
    except Exception:
        pass
    finally:
        _tick_serial.release()


def ensure_series() -> None:
    """``Server.start``'s hook, on the caller's thread: bind the
    watchdog's imports before the sampler can need them, and make sure
    the global sampler's thread runs even with no window yet."""
    bind_watchdog_imports()
    if not series_enabled():
        return
    from brpc_tpu_torch.bvar import window as _window
    _window.global_sampler._ensure_thread()


# --------------------------------------------------------------- merges

def merge_timeline_states(states: List[Tuple[Optional[int], dict]],
                          names: Optional[List[str]] = None,
                          prefix: str = "") -> dict:
    """A shard group supervisor's ``/timeline`` (brpc_tpu/bvar/series.py:
    441-510): ``states`` are (shard index, ``timeline_page_payload``)
    pairs from the dumps. A bucket's counters sum, maxima max, quantile
    series keep each field's worst case with the counts summed (never
    an average), and gauges take the rules of merged ``/vars``
    (``shard_group.merge_var_values``), so the two merged views agree.
    Incidents concatenate, each tagged with its shard."""
    from brpc_tpu_torch.rpc.shard_group import merge_var_values
    out: dict = {"mode": "shard_group", "shards_reporting": len(states),
                 "enabled": any(s.get("enabled") for _, s in states),
                 "resolution": {"sec": SEC_BUCKETS, "min": MIN_BUCKETS,
                                "hr": HOUR_BUCKETS}}
    merged: Dict[str, dict] = {}
    # each shard rolls its minute and hour buckets at its own 60th push,
    # so coarse buckets align on the epoch grid here: else two shards'
    # minutes would interleave instead of summing
    grid = {"sec": 1, "min": 60, "hr": 3600}
    for _, st in states:
        for name, ser in (st.get("series") or {}).items():
            if names is not None and name not in names:
                continue
            if prefix and not name.startswith(prefix):
                continue
            m = merged.setdefault(name, {"kind": ser.get("kind"),
                                         "sec": {}, "min": {}, "hr": {}})
            kind = m["kind"]
            for level in ("sec", "min", "hr"):
                buckets = m[level]
                step = grid[level]
                for t, v in ser.get(level) or ():
                    t -= t % step
                    if kind == KIND_LAST:
                        buckets.setdefault(t, []).append(v)
                    else:
                        buckets[t] = _combine(kind, buckets.get(t), v)
    series: Dict[str, dict] = {}
    for name, m in merged.items():
        d = {"kind": m["kind"]}
        for level in ("sec", "min", "hr"):
            if m["kind"] == KIND_LAST:
                d[level] = [[t, merge_var_values(vals, name=name)]
                            for t, vals in sorted(m[level].items())]
            else:
                d[level] = [[t, v] for t, v in sorted(m[level].items())]
        series[name] = d
    out["series"] = series
    incidents = []
    for shard, st in states:
        for inc in st.get("incidents") or ():
            row = dict(inc)
            row["shard"] = shard
            incidents.append(row)
    incidents.sort(key=lambda r: (r.get("opened_t") or 0,
                                  r.get("shard") or 0))
    out["incidents"] = incidents
    keys = set()
    for _, st in states:
        keys.update(st.get("watch_keys") or ())
    out["watch_keys"] = sorted(keys)
    return out


def _postfork_reset() -> None:
    """Fork hygiene: the rings describe the parent's counters and the
    locks may be held at the fork."""
    global _collector, _collector_lock, _tick_serial
    _collector = None
    _collector_lock = threading.Lock()
    _tick_serial = threading.Lock()


from brpc_tpu_torch.butil import postfork as _postfork  # noqa: E402

_postfork.register("bvar.series", _postfork_reset)
