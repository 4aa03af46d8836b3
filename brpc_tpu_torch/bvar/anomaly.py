"""The anomaly watchdog (the port of brpc_tpu/bvar/anomaly.py): EWMA+MAD
z-scores over the watch keys, on the bvar sampler's tick
(``bvar/series.py`` hands it every stored bucket of a watch key).

The watch keys are what an operator would watch: error and shed
counters, latency p99 tracks, queue delay, the device lanes' leaked
bytes, capture drops. A statistical break in any of them opens an
incident:

  * per key, an exponentially weighted mean and mean absolute deviation;
    a bucket whose z-score ``(x - mean) / (1.4826 * mad)`` clears
    ``anomaly_z_open`` after ``anomaly_warmup_ticks`` readings alerts
    (upward breaks only: a quiet error counter is recovery);
  * one tick's alerts make ONE incident; later alerting keys join the
    open one; it closes after ``anomaly_close_ticks`` calm ticks; the
    bounded ring keeps the stamps, keys, peak z and values;
  * an opening incident annotates the rpcz spans that ended in the last
    5 s (``incident #N`` in /rpcz), stamps the flight recorder's live
    window, and hands the tick to the incident manager
    (``incident/manager.py``), which may start a capture window.

Sampler-thread rule: the collaborators are bound by
``bind_watchdog_imports`` on the thread that calls ``Server.start``
(``series.ensure_series``), and the tick never imports. Open and close
are a pure function of the value sequence.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

from brpc_tpu_torch.butil.flags import define_flag, flag

define_flag("anomaly_watchdog_enabled", True,
            "run the EWMA+MAD anomaly watchdog over the watch keys on "
            "every series tick")
define_flag("anomaly_z_open", 6.0,
            "z-score a watched bucket must clear to raise an alert")
define_flag("anomaly_z_close", 3.0,
            "z-score below which a tick counts as calm for an open "
            "incident")
define_flag("anomaly_warmup_ticks", 5,
            "readings a key needs before it may alert (a fresh key's "
            "first reading is not an anomaly)")
define_flag("anomaly_close_ticks", 5,
            "consecutive calm ticks that close an open incident")
define_flag("anomaly_max_incidents", 64,
            "incident records kept in the bounded ring")
define_flag("anomaly_watch_filter", "",
            "comma-separated allowlist that replaces the watch-key "
            "predicate (empty = the full predicate); runs pin it for "
            "determinism")

_EWMA_ALPHA = 0.25
_MAD_SCALE = 1.4826            # MAD -> sigma under normality
_SPAN_WINDOW_US = 5_000_000    # annotate spans that ended in the last 5 s
_SPAN_ANNOTATE_MAX = 16

# bound on the caller's thread by bind_watchdog_imports, never at sample
# time: rpc.span's collector, the flight recorder, the incident manager
_span_mod = None
_fr_mod = None
_inc_mod = None


def bind_watchdog_imports() -> None:
    """Bind the watchdog's annotation targets, once, on the thread that
    starts the server."""
    global _span_mod, _fr_mod, _inc_mod
    if _fr_mod is not None:
        return
    from brpc_tpu_torch.builtin import flight_recorder as fr
    from brpc_tpu_torch.incident import manager as im
    from brpc_tpu_torch.rpc import span as sm
    im.bind_incident_imports()
    _span_mod, _fr_mod, _inc_mod = sm, fr, im


def is_watch_key(name: str) -> bool:
    """The watch predicate: error counters, sheds, queue delay, leaked
    or unpulled device bytes, capture drops, the p99 tracks (``*_p99_us``
    gauges and every quantile series' ``<name>.p99``), the serving TTFT
    and token-rate keys. A set ``anomaly_watch_filter`` replaces it
    (exact names), the quantile tracks included."""
    filt = flag("anomaly_watch_filter")
    if filt:
        return name in {k.strip() for k in str(filt).split(",")
                        if k.strip()}
    return (name.endswith("_shed") or "error" in name
            or "queue_delay" in name or name.endswith("_p99_us")
            or name.endswith(".p99")
            or name.endswith("dropped_queue")
            or name.endswith("dropped_budget")
            or "leaked" in name or "unpulled" in name
            or name.startswith("chaos_injected")
            or name.startswith("serving_ttft")
            or name.startswith("serving_tokens_per_second"))


class _KeyState:
    __slots__ = ("mean", "mad", "n")

    def __init__(self):
        self.mean = 0.0
        self.mad = 0.0
        self.n = 0


class Incident:
    __slots__ = ("id", "opened_t", "closed_t", "keys", "peak_z",
                 "peak_value", "peak_key", "baseline", "calm",
                 "spans_annotated")

    def __init__(self, iid: int, t: int):
        self.id = iid
        self.opened_t = t
        self.closed_t: Optional[int] = None
        self.keys: List[str] = []
        self.peak_z = 0.0
        self.peak_value = 0.0
        self.peak_key = ""
        self.baseline = 0.0
        self.calm = 0
        self.spans_annotated = 0

    def to_dict(self) -> dict:
        return {"id": self.id, "opened_t": self.opened_t,
                "closed_t": self.closed_t,
                "state": "closed" if self.closed_t is not None
                else "open",
                "keys": list(self.keys),
                "peak_key": self.peak_key,
                "peak_z": round(self.peak_z, 2),
                "peak_value": round(self.peak_value, 3),
                "baseline": round(self.baseline, 3),
                "spans_annotated": self.spans_annotated}


class AnomalyWatchdog:
    """``_lock`` is a leaf: it guards the key states and the incident
    ring; annotation runs after it is released."""

    def __init__(self):
        self._lock = threading.Lock()
        self._keys: Dict[str, _KeyState] = {}
        self._incidents: deque = deque(
            maxlen=int(flag("anomaly_max_incidents")))
        self._open: Optional[Incident] = None
        self._next_id = 1

    def watchdog_pass(self, points: Dict[str, float], t: int) -> None:
        """One tick: ``points`` is {watch key: the bucket just stored}."""
        if not flag("anomaly_watchdog_enabled"):
            return
        warmup = int(flag("anomaly_warmup_ticks"))
        z_open = float(flag("anomaly_z_open"))
        z_close = float(flag("anomaly_z_close"))
        close_ticks = int(flag("anomaly_close_ticks"))
        opened: Optional[Incident] = None
        closed: Optional[Incident] = None
        with self._lock:
            alerts = []
            any_hot = False
            for key in sorted(points):
                x = float(points[key])
                st = self._keys.get(key)
                if st is None:
                    st = self._keys[key] = _KeyState()
                dev = abs(x - st.mean)
                denom = max(_MAD_SCALE * st.mad, 1.0,
                            0.02 * abs(st.mean))
                z = (x - st.mean) / denom          # upward breaks only
                if st.n >= warmup:
                    if z >= z_open:
                        alerts.append((key, x, z, st.mean))
                    if z >= z_close:
                        any_hot = True
                # updated after scoring: the spike must not vote on the
                # baseline it is judged against
                st.mean += _EWMA_ALPHA * (x - st.mean)
                st.mad += _EWMA_ALPHA * (dev - st.mad)
                st.n += 1
            if alerts:
                inc = self._open
                if inc is None:
                    inc = Incident(self._next_id, t)
                    self._next_id += 1
                    self._incidents.append(inc)
                    self._open = inc
                    opened = inc
                inc.calm = 0
                for key, x, z, mean in alerts:
                    if key not in inc.keys:
                        inc.keys.append(key)
                    if z > inc.peak_z:
                        inc.peak_z, inc.peak_value = z, x
                        inc.peak_key, inc.baseline = key, mean
            elif self._open is not None and not any_hot:
                self._open.calm += 1
                if self._open.calm >= close_ticks:
                    self._open.closed_t = t
                    closed = self._open
                    self._open = None
        if opened is not None:
            self._stamp_incident(opened)
        # the incident manager every tick (its idle early-out is one
        # attribute read), so an armed window counts down on calm ticks
        im = _inc_mod
        if im is not None:
            im.incident_sample_tick(opened, closed, t)

    def _stamp_incident(self, inc: Incident) -> None:
        """Outside every lock: mark the spans that ended inside the break
        and the flight recorder's live window. Best effort."""
        label = f"incident #{inc.id}: " + ",".join(inc.keys)
        sm, fr = _span_mod, _fr_mod
        if sm is not None:
            try:
                cutoff = time.monotonic_ns() // 1000 - _SPAN_WINDOW_US
                n = 0
                for span in reversed(sm.global_collector.recent(64)):
                    if span.end_us and span.end_us >= cutoff:
                        span.annotate(
                            f"{label} z={inc.peak_z:.1f} "
                            f"peak={inc.peak_value:g}")
                        n += 1
                        if n >= _SPAN_ANNOTATE_MAX:
                            break
                inc.spans_annotated = n
            except Exception:
                pass
        if fr is not None:
            try:
                fr.global_recorder().note_incident(
                    f"#{inc.id} {inc.peak_key or inc.keys[0]}")
            except Exception:
                pass

    def incident_snapshot(self) -> List[dict]:
        with self._lock:
            return [inc.to_dict() for inc in self._incidents]

    def tracked_keys(self) -> List[str]:
        with self._lock:
            return sorted(self._keys)

    def reset(self) -> None:
        with self._lock:
            self._keys.clear()
            self._incidents.clear()
            self._open = None
            self._next_id = 1


_watchdog: Optional[AnomalyWatchdog] = None
_watchdog_lock = threading.Lock()


def global_watchdog() -> AnomalyWatchdog:
    global _watchdog
    if _watchdog is None:
        with _watchdog_lock:
            if _watchdog is None:
                _watchdog = AnomalyWatchdog()
    return _watchdog


def watchdog_sample_pass(points: Dict[str, float], t: int) -> None:
    """The series tick's entry (``bvar/series.py``)."""
    global_watchdog().watchdog_pass(points, t)


def _postfork_reset() -> None:
    """Fork hygiene: the baselines and incidents describe the parent's
    traffic. Not registered: the postfork registry comes with shard
    groups (ROADMAP section 1)."""
    global _watchdog, _watchdog_lock
    _watchdog = None
    _watchdog_lock = threading.Lock()
