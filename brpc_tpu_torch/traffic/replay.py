"""Open-loop replay/press engine over a captured corpus (the port of
brpc_tpu/traffic/replay.py, with its names and report keys).

OPEN loop: issue times come from a precomputed schedule (the recorded
inter-arrival profile scaled by a time-warp factor, a constant qps, or
a seeded Poisson process) and are never gated on completions — a
closed sync loop measures the CLIENT's round-trip, not the server
(the lesson of a closed-loop qps client), and worse, it mercy-throttles
when the server slows down, hiding the overload the replay exists to
reproduce. Completions land on done-callbacks; the engine tracks how
far behind schedule issuing ever fell (``behind_ms_max``) so a
client-bound replay is visible instead of silently lying.

One process is one GIL: the multi-process fan-out lives in
``brpc_tpu_torch.tools.rpc_replay`` / ``rpc_press`` (each worker runs
this engine on a round-robin slice of the corpus; reports merge with
merge_reports — counts sum, latency samples pool, never averaged
percentiles).

Replayed requests preserve the recorded method, payload, attachment
(``cntl.request_attachment``), priority tag, and deadline: timeout_ms
re-derives from the recorded budget (scaled by ``timeout_scale``; warp
does NOT rescale deadlines — compressing arrival gaps changes offered
load, not caller patience).

The schedule, the latency reservoirs and ``synthesize_records`` draw from
``random.Random(seed)`` exactly as the reference does, so one seed gives
the same offsets and the same bytes in both packages. The channels a
replay holds are listed by ``live_channels()`` until it closes them (the
tests' leak check).
"""

from __future__ import annotations

import contextlib
import random
import threading
import time
from typing import Dict, List, Optional

from brpc_tpu_torch.traffic.corpus import CapturedRequest

_LAT_CAP = 1024          # pooled-percentile reservoir per class

# the channels of every replay in flight (closed when it ends)
_live_lock = threading.Lock()
_live: list = []


def live_channels() -> int:
    """Channels that replays in flight hold (0 once they ended)."""
    with _live_lock:
        return len(_live)


@contextlib.contextmanager
def _holding(chs):
    """List ``chs`` in ``live_channels`` while the replay runs, and
    close them when it ends, however it ends."""
    with _live_lock:
        _live.extend(chs)
    try:
        yield
    finally:
        for ch in chs:
            ch.close()
        with _live_lock:
            for ch in chs:
                _live.remove(ch)


class PaceSpec:
    """mode: 'recorded' (inter-arrival x 1/warp), 'qps', 'poisson'."""

    def __init__(self, mode: str = "recorded", warp: float = 1.0,
                 qps: float = 0.0, seed: int = 0):
        if mode not in ("recorded", "qps", "poisson"):
            raise ValueError(f"unknown pace mode {mode!r}")
        if mode == "recorded" and warp <= 0.0:
            raise ValueError("warp must be > 0")
        if mode in ("qps", "poisson") and qps <= 0.0:
            raise ValueError(f"{mode} pacing needs qps > 0")
        self.mode = mode
        self.warp = warp
        self.qps = qps
        self.seed = seed

    def schedule_s(self, records: List[CapturedRequest]) -> List[float]:
        """Issue offsets (seconds from replay start), one per record,
        non-decreasing. Recorded mode anchors at the first record's
        arrival stamp; records without stamps issue immediately."""
        n = len(records)
        if self.mode == "qps":
            return [i / self.qps for i in range(n)]
        if self.mode == "poisson":
            rng = random.Random(self.seed)
            t = 0.0
            out = []
            for _ in range(n):
                out.append(t)
                t += rng.expovariate(self.qps)
            return out
        t0 = records[0].arrival_mono_ns if records else 0
        return [max(0.0, (r.arrival_mono_ns - t0) / 1e9 / self.warp)
                for r in records]

    def to_dict(self) -> dict:
        return {"mode": self.mode, "warp": self.warp, "qps": self.qps,
                "seed": self.seed}


class _ClassStats:
    __slots__ = ("ok", "fail", "error_codes", "lat_ms", "_seen", "_rng")

    def __init__(self, seed: int = 0):
        self.ok = 0
        self.fail = 0
        self.error_codes: Dict[str, int] = {}
        self.lat_ms: List[float] = []
        self._seen = 0
        self._rng = random.Random(seed)

    def record(self, code: int, lat_ms: float) -> None:
        if code:
            self.fail += 1
            k = str(code)
            self.error_codes[k] = self.error_codes.get(k, 0) + 1
            return
        self.ok += 1
        # bounded reservoir (unbiased): pooled percentiles across
        # workers need SAMPLES, and an unbounded list is a leak on a
        # long replay
        self._seen += 1
        if len(self.lat_ms) < _LAT_CAP:
            self.lat_ms.append(lat_ms)
        else:
            j = self._rng.randrange(self._seen)
            if j < _LAT_CAP:
                self.lat_ms[j] = lat_ms

    def to_dict(self) -> dict:
        return {"ok": self.ok, "fail": self.fail,
                "error_codes": dict(self.error_codes),
                "lat_ms_samples": [round(v, 3) for v in self.lat_ms]}


def _pct(sorted_vals: List[float], ratio: float) -> Optional[float]:
    if not sorted_vals:
        return None
    return sorted_vals[min(len(sorted_vals) - 1,
                           int(ratio * len(sorted_vals)))]


def run_open_loop(records: List[CapturedRequest], address: str,
                  pace: PaceSpec, conns: int = 4,
                  timeout_scale: float = 1.0,
                  default_timeout_ms: float = 2000.0,
                  bucket_width_s: float = 0.0,
                  drain_s: float = 10.0,
                  channel_options=None, warm: bool = True) -> dict:
    """Replay ``records`` against ``address`` on ``conns`` private
    connections (round-robin), open-loop on ``pace``'s schedule.
    Returns the per-class report (merge-ready: counts + bounded
    latency samples + schedule/issue bucket arrays)."""
    from brpc_tpu_torch.rpc import Channel, ChannelOptions
    from brpc_tpu_torch.rpc.controller import Controller

    if not records:
        return {"records": 0, "issued": 0, "ok": 0, "fail": 0,
                "elapsed_s": 0.0, "fidelity_pct": None, "classes": {}}
    sched = pace.schedule_s(records)
    span = max(sched[-1], 1e-3)
    if bucket_width_s <= 0.0:
        # 10..200 buckets: fine enough to see the recorded qps shape,
        # coarse enough that scheduler jitter doesn't drown it
        bucket_width_s = max(span / 200.0, min(0.1, span / 10.0))
    nbuckets = int(span / bucket_width_s) + 2
    sched_hist = [0] * nbuckets
    for t in sched:
        sched_hist[min(nbuckets - 1, int(t / bucket_width_s))] += 1

    if channel_options is None:
        channel_options = ChannelOptions(share_connections=False,
                                         name="traffic_replay")
    chs = [Channel(address, channel_options) for _ in range(conns)]
    with _holding(chs):
        if warm:
            # first-call channel setup costs milliseconds (connect + socket
            # plumbing) and would smear the schedule's first buckets into a
            # false fidelity loss. Warm with a nonexistent method: the
            # ENOSERVICE round trip pays the whole setup without touching
            # any real handler (replay determinism asserts count handler
            # hits, so a real-method warm call would pollute them).
            for ch in chs:
                ch.call_sync("__traffic_warm__", "Ping", b"")
        lock = threading.Lock()
        classes: Dict[str, _ClassStats] = {}
        issue_hist = [0] * nbuckets
        inflight = [0]
        done_ev = threading.Event()
        issued = [0]
        behind_max = [0.0]
        issue_done = [False]

        def _class(rec: CapturedRequest) -> _ClassStats:
            key = f"{rec.method_key}|p{rec.priority}"
            cs = classes.get(key)
            if cs is None:
                cs = classes[key] = _ClassStats(seed=pace.seed + len(classes))
            return cs

        def _issue(rec: CapturedRequest, i: int) -> None:
            cntl = Controller()
            if rec.timeout_ms > 0:
                cntl.timeout_ms = rec.timeout_ms * timeout_scale
            else:
                cntl.timeout_ms = default_timeout_ms
            if rec.priority:
                cntl.request_priority = rec.priority
            if rec.attachment:
                cntl.request_attachment.append(rec.attachment)
            cs = _class(rec)
            t_issue = time.perf_counter()

            def _done(c) -> None:
                lat_ms = (time.perf_counter() - t_issue) * 1e3
                with lock:
                    cs.record(c.error_code if c.failed() else 0, lat_ms)
                    inflight[0] -= 1
                    last = inflight[0] <= 0 and issue_done[0]
                if last:
                    done_ev.set()

            with lock:
                inflight[0] += 1
            try:
                chs[i % conns].call(rec.service, rec.method, rec.payload,
                                    cntl=cntl, done=_done)
            except Exception as e:  # noqa: BLE001 - a dead conn is a result
                with lock:
                    cs.record(-1, 0.0)
                    cs.error_codes[f"issue:{type(e).__name__}"] = \
                        cs.error_codes.get(f"issue:{type(e).__name__}", 0) + 1
                    inflight[0] -= 1

        t0 = time.perf_counter()
        for i, (rec, t_s) in enumerate(zip(records, sched)):
            now = time.perf_counter() - t0
            if t_s > now:
                time.sleep(t_s - now)
                now = time.perf_counter() - t0
            elif now - t_s > behind_max[0]:
                # behind schedule: the OPEN loop issues anyway (that burst
                # IS the offered load); the gap is the client-bound signal
                behind_max[0] = now - t_s
            issue_hist[min(nbuckets - 1, int(now / bucket_width_s))] += 1
            _issue(rec, i)
            issued[0] += 1
        with lock:
            issue_done[0] = True
            drained = inflight[0] <= 0
        if not drained:
            done_ev.wait(drain_s + default_timeout_ms / 1e3)
        elapsed = time.perf_counter() - t0

    report = _summarize(classes, sched_hist, issue_hist, bucket_width_s)
    report.update({
        "records": len(records), "issued": issued[0],
        "elapsed_s": round(elapsed, 3),
        "behind_ms_max": round(behind_max[0] * 1e3, 2),
        "undrained": max(0, inflight[0]),
        "pace": pace.to_dict(),
    })
    return report


def _summarize(classes: Dict[str, _ClassStats], sched_hist: List[int],
               issue_hist: List[int], bucket_width_s: float) -> dict:
    per_method: Dict[str, dict] = {}
    per_priority: Dict[str, dict] = {}
    cls_out = {}
    total_ok = total_fail = 0
    for key, cs in sorted(classes.items()):
        d = cs.to_dict()
        lat = sorted(cs.lat_ms)
        d["p50_ms"] = round(_pct(lat, 0.5), 3) if lat else None
        d["p99_ms"] = round(_pct(lat, 0.99), 3) if lat else None
        cls_out[key] = d
        total_ok += cs.ok
        total_fail += cs.fail
        mk, _, p = key.rpartition("|p")
        for table, tkey in ((per_method, mk), (per_priority, p)):
            t = table.setdefault(tkey, {"ok": 0, "fail": 0})
            t["ok"] += cs.ok
            t["fail"] += cs.fail
    return {
        "ok": total_ok, "fail": total_fail, "classes": cls_out,
        "per_method": per_method, "per_priority": per_priority,
        "bucket_width_s": round(bucket_width_s, 4),
        "sched_hist": sched_hist, "issue_hist": issue_hist,
        "fidelity_pct": fidelity_pct(sched_hist, issue_hist),
    }


def fidelity_pct(sched_hist: List[int],
                 issue_hist: List[int]) -> Optional[float]:
    """How faithfully the issue times tracked the schedule: histogram
    overlap, 100 x sum(min(scheduled_b, issued_b)) / total scheduled.
    100 = every bucket got exactly its scheduled share; a client that
    fell behind and burst later scores low even though counts match."""
    total = sum(sched_hist)
    if not total:
        return None
    n = max(len(sched_hist), len(issue_hist))
    s = sched_hist + [0] * (n - len(sched_hist))
    a = issue_hist + [0] * (n - len(issue_hist))
    return round(100.0 * sum(min(x, y) for x, y in zip(s, a)) / total, 2)


def merge_reports(reports: List[dict]) -> dict:
    """Merge per-worker open-loop reports: counters sum, class latency
    SAMPLES pool (percentiles recomputed, never averaged), bucket
    histograms sum element-wise, fidelity recomputed from the merged
    histograms. behind_ms_max takes the max."""
    reports = [r for r in reports if r and r.get("records")]
    if not reports:
        return {"records": 0, "issued": 0, "ok": 0, "fail": 0,
                "workers": 0, "fidelity_pct": None, "classes": {}}
    out: dict = {"workers": len(reports)}
    for k in ("records", "issued", "ok", "fail", "undrained"):
        out[k] = sum(r.get(k, 0) or 0 for r in reports)
    out["elapsed_s"] = round(max(r.get("elapsed_s", 0.0)
                                 for r in reports), 3)
    out["behind_ms_max"] = round(max(r.get("behind_ms_max", 0.0)
                                     for r in reports), 2)
    out["pace"] = reports[0].get("pace")

    classes: Dict[str, dict] = {}
    for r in reports:
        for key, d in (r.get("classes") or {}).items():
            m = classes.setdefault(key, {"ok": 0, "fail": 0,
                                         "error_codes": {},
                                         "lat_ms_samples": []})
            m["ok"] += d.get("ok", 0)
            m["fail"] += d.get("fail", 0)
            for ec, n in (d.get("error_codes") or {}).items():
                m["error_codes"][ec] = m["error_codes"].get(ec, 0) + n
            m["lat_ms_samples"].extend(
                d.get("lat_ms_samples") or ())
    per_method: Dict[str, dict] = {}
    per_priority: Dict[str, dict] = {}
    for key, m in classes.items():
        lat = sorted(m["lat_ms_samples"])
        m["p50_ms"] = round(_pct(lat, 0.5), 3) if lat else None
        m["p99_ms"] = round(_pct(lat, 0.99), 3) if lat else None
        del m["lat_ms_samples"]
        mk, _, p = key.rpartition("|p")
        for table, tkey in ((per_method, mk), (per_priority, p)):
            t = table.setdefault(tkey, {"ok": 0, "fail": 0})
            t["ok"] += m["ok"]
            t["fail"] += m["fail"]
    out["classes"] = dict(sorted(classes.items()))
    out["per_method"] = per_method
    out["per_priority"] = per_priority

    widths = {r.get("bucket_width_s") for r in reports}
    if len(widths) == 1 and None not in widths:
        n = max(len(r.get("sched_hist") or []) for r in reports)
        sched = [0] * n
        issued = [0] * n
        for r in reports:
            for i, v in enumerate(r.get("sched_hist") or []):
                sched[i] += v
            for i, v in enumerate(r.get("issue_hist") or []):
                issued[i] += v
        out["bucket_width_s"] = widths.pop()
        out["fidelity_pct"] = fidelity_pct(sched, issued)
    else:
        # workers paced on different bucket widths: fall back to the
        # worst single-worker fidelity rather than inventing alignment
        fids = [r.get("fidelity_pct") for r in reports
                if r.get("fidelity_pct") is not None]
        out["fidelity_pct"] = min(fids) if fids else None
    return out


# ------------------------------------------------------ synthetic press

def parse_mix(spec: str, cast=int) -> List[tuple]:
    """'64:0.8,4096:0.2' -> [(64, 0.8), (4096, 0.2)] (weights
    normalized by the sampler, not here)."""
    out = []
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        v, _, w = part.partition(":")
        out.append((cast(v), float(w) if w else 1.0))
    return out


def synthesize_records(n: int, sizes: List[tuple], priorities: List[tuple],
                       qps: float, mode: str = "qps", seed: int = 0,
                       service: str = "Bench", method: str = "PyEcho",
                       timeout_ms: float = 0.0) -> List[CapturedRequest]:
    """A synthetic corpus for press mode: ``n`` requests whose sizes
    and priority tags draw from weighted mixes and whose arrival
    stamps follow the pacing mode — the same CapturedRequest shape the
    capture lane records, so press and replay share one engine and a
    synthetic corpus can be written to .brpccap and inspected with
    rpc_view like a recorded one."""
    rng = random.Random(seed)
    sizes = sizes or [(64, 1.0)]
    priorities = priorities or [(0, 1.0)]
    sw = [w for _, w in sizes]
    pw = [w for _, w in priorities]
    t = 0.0
    out = []
    for i in range(n):
        size = rng.choices([s for s, _ in sizes], weights=sw)[0]
        prio = rng.choices([p for p, _ in priorities], weights=pw)[0]
        out.append(CapturedRequest(
            method_key=f"{service}.{method}", service=service,
            method=method,
            payload=bytes([65 + (i + size) % 26]) * size,
            attachment=b"", arrival_mono_ns=int(t * 1e9),
            arrival_wall_ns=0, timeout_ms=timeout_ms, priority=prio,
            log_id=i + 1, status=0, latency_us=0.0))
        t += rng.expovariate(qps) if mode == "poisson" else 1.0 / qps
    return out
