"""The port's trend rings and anomaly watchdog against brpc_tpu's, on the
CPU.

- Fresh ``SeriesCollector`` instances of both fed the same readings at
  injected stamps hold equal rings (seconds, minutes and an hour), hand
  the watchdog equal points, and prune alike over the cap; readings of
  real variables of each kind collect alike; ``detect_kind`` agrees.
- ``sparkline`` draws equal strings; ``is_watch_key`` agrees over one
  list of names, with and without a filter.
- Fresh ``AnomalyWatchdog`` instances fed one synthetic series open and
  close equal incidents (ticks, keys, peak z) and annotate alike, their
  collaborators pointed at stand-ins for the case.
- A port server: ``/timeline`` and ``/vars?series=`` serve the rings,
  ``server_processed``'s seconds ring sums to the calls served, the
  declared kinds hold, and the payload's keys are brpc_tpu's.

The cases run inside one collected test (``_run_cases`` of
test_torch_cluster.py), each under a time limit of its own, with its
checks for sockets and threads left behind. The brpc_tpu flags and
watchdog collaborators a case sets are restored; the rings and watchdogs
compared are fresh instances of both.
"""

import http.client
import json
import threading

import numpy as np

from brpc_tpu.builtin import services as ref_services
from brpc_tpu.butil import flags as ref_flags
from brpc_tpu.bvar import anomaly as ref_anomaly
from brpc_tpu.bvar import series as ref_series
from brpc_tpu.bvar.latency_recorder import LatencyRecorder as RefLR
from brpc_tpu.bvar.reducer import Adder as RefAdder
from brpc_tpu.bvar.reducer import Maxer as RefMaxer
from brpc_tpu.bvar.reducer import Miner as RefMiner
from brpc_tpu.bvar.reducer import PassiveStatus as RefPassive
from brpc_tpu.bvar.reducer import Status as RefStatus
from brpc_tpu.bvar.window import Sampler as RefSampler

import brpc_tpu_torch.rpc as port_rpc
from brpc_tpu_torch.builtin import services as port_services
from brpc_tpu_torch.butil import flags as port_flags
from brpc_tpu_torch.bvar import anomaly as port_anomaly
from brpc_tpu_torch.bvar import series as port_series
from brpc_tpu_torch.bvar.latency_recorder import LatencyRecorder as PortLR
from brpc_tpu_torch.bvar.reducer import Adder as PortAdder
from brpc_tpu_torch.bvar.reducer import Maxer as PortMaxer
from brpc_tpu_torch.bvar.reducer import Miner as PortMiner
from brpc_tpu_torch.bvar.reducer import PassiveStatus as PortPassive
from brpc_tpu_torch.bvar.reducer import Status as PortStatus
from brpc_tpu_torch.bvar.window import Sampler as PortSampler

from test_torch_cluster import _run_cases, _wait_for

SIDES = (("port", port_series, port_anomaly, port_flags),
         ("ref", ref_series, ref_anomaly, ref_flags))


class _Flags:
    """Set flags on both sides for a block, and restore them."""

    def __init__(self, **values):
        self.values, self.old = values, []

    def __enter__(self):
        for mod in (port_flags, ref_flags):
            for k, v in self.values.items():
                self.old.append((mod, k, mod.flag(k)))
                assert mod.set_flag(k, v), (k, v)
        return self

    def __exit__(self, *exc):
        for mod, k, v in reversed(self.old):
            mod.set_flag(k, v)


def _readings(rng, t):
    """One tick's readings of six variables, one of each kind, with a
    counter reset and a re-exposed object along the way."""
    out = []
    total = int(t * 7 + rng.randint(0, 5))
    if 1800 <= t < 1900:
        total -= 12000                  # a counter reset: re-baselines
    out.append(("req_count", 1 if t < 2500 else 2, "delta", total))
    out.append(("queue_depth", 3, "last", float(rng.randint(0, 40))))
    out.append(("rpc_latency_p99_us", 4, "max",
                float(rng.exponential(200.0))))
    out.append(("free_min", 5, "min", float(rng.randint(5, 500))))
    n = int(t * 3)
    out.append(("method_lat", 6, "quantile",
                {"count": n, "p50": float(rng.randint(10, 90)),
                 "p99": float(rng.randint(100, 900)),
                 "max": float(rng.randint(900, 2000))}))
    out.append(("server_errors", 7, "delta", int(t // 40)))
    return out


def _rings_equal():
    """3,700 ticks at injected stamps into fresh collectors: equal rings
    at every level, equal watch points each tick; then a cap of 3
    prunes alike."""
    cols = {name: ser.SeriesCollector() for name, ser, _, _ in SIDES}
    rng = np.random.RandomState(20260803)
    for t in range(3700):
        readings = _readings(rng, t)
        points = {name: col.store_readings(readings, 1_700_000_000 + t)
                  for name, col in cols.items()}
        assert points["port"] == points["ref"], t
    dumps = {name: col.dump_series() for name, col in cols.items()}
    assert dumps["port"] == dumps["ref"]
    ring = dumps["port"]["req_count"]
    assert len(ring["min"]) == 60 and len(ring["hr"]) == 1
    assert ring["live_sec"] == 3700 % 60
    assert dumps["port"]["method_lat"]["hr"][0][1]["count"] > 0
    for name in ("req_count", "method_lat", "queue_depth"):
        assert cols["port"].spark(name) == cols["ref"].spark(name)
    with _Flags(bvar_series_max_vars=3):
        for t in range(3700, 3705):
            readings = _readings(rng, t)[:2] + _readings(rng, t)[4:]
            for col in cols.values():
                col.store_readings(readings, 1_700_000_000 + t)
        assert cols["port"].tracked_names() == cols["ref"].tracked_names()
        assert len(cols["port"].tracked_names()) == 3


def _variables(kind):
    """One exposed variable of each shape on one side, its sampler
    private; returns (names, variables, hide)."""
    if kind == "port":
        Adder, Maxer, Miner, Passive, Status, LR, Sampler = (
            PortAdder, PortMaxer, PortMiner, PortPassive, PortStatus,
            PortLR, PortSampler)
    else:
        Adder, Maxer, Miner, Passive, Status, LR, Sampler = (
            RefAdder, RefMaxer, RefMiner, RefPassive, RefStatus, RefLR,
            RefSampler)
    a, mx, mn = Adder(), Maxer(), Miner()
    lr = LR(sampler=Sampler())
    for v in (3, 11, 5):
        a.add(v)
        mx.update(v)
        mn.update(v)
    for us in (120.0, 80.0, 400.0, 95.0):
        lr.record(us)
    made = {"tl_case_adder": a, "tl_case_maxer": mx, "tl_case_miner": mn,
            "tl_case_passive": Passive(lambda: 42.5),
            "tl_case_status": Status("text"), "tl_case_lat": lr}
    for name, var in made.items():
        var.expose(name)
    return made


def _collect_equal():
    """Real variables of each shape: detect_kind agrees, and a fresh
    collector reads them alike (strings skipped)."""
    got = {}
    for name, ser, _, _ in SIDES:
        made = _variables(name)
        try:
            col = ser.SeriesCollector()
            col.declare_kind("tl_case_passive", "delta")
            got[name] = (
                {n: ser.detect_kind(v) for n, v in made.items()},
                sorted((n, k, r) for n, _, k, r in col.collect_readings()
                       if n.startswith("tl_case_")))
        finally:
            for var in made.values():
                var.hide()
    assert got["port"] == got["ref"], got
    kinds, readings = got["port"]
    assert kinds["tl_case_adder"] == "delta"
    assert kinds["tl_case_miner"] == "min" and kinds["tl_case_maxer"] == \
        "max" and kinds["tl_case_lat"] == "quantile"
    assert "tl_case_status" not in {n for n, _, _ in readings}
    assert ("tl_case_passive", "delta", 42.5) in readings


def _sparklines():
    rng = np.random.RandomState(7)
    cases = [[], [3, 3, 3], [1, True, "x", 2.5, 9], list(range(100)),
             list(rng.exponential(10.0, 45)), [0.0, -5.0, 5.0]]
    for vals in cases:
        for width in (30, 5):
            assert port_series.sparkline(vals, width) == \
                ref_series.sparkline(vals, width), (vals, width)
    assert port_series.sparkline([1, 2]) == "▁█"


WATCH_NAMES = [
    "server_limit_shed", "server_errors", "rpc_queue_delay_us",
    "server_latency_p99_us", "method.p99", "capture_dropped_queue",
    "capture_dropped_budget", "ici_leaked_bytes", "ici_unpulled",
    "chaos_injected_delay", "serving_ttft_us.p99", "serving_tokens_per_s",
    "serving_tokens_per_second", "serving_ttft_p99_us", "server_processed",
    "fiber_wake", "process_cpu_usage", "iobuf_pool_hit_ratio"]


def _watch_keys():
    for filt in ("", "server_limit_shed", " server_errors , method.p99 "):
        with _Flags(anomaly_watch_filter=filt):
            port = [n for n in WATCH_NAMES if port_anomaly.is_watch_key(n)]
            ref = [n for n in WATCH_NAMES if ref_anomaly.is_watch_key(n)]
            assert port == ref, (filt, port, ref)
            if filt:
                assert port == [n for n in WATCH_NAMES
                                if n in filt.replace(" ", "").split(",")]


class _Span:
    def __init__(self, end_us):
        self.end_us, self.notes = end_us, []

    def annotate(self, text):
        self.notes.append(text)


class _Stand:
    """The watchdog's three collaborators, recording what they get from
    the case's thread only (the process's own watchdog, on the sampler
    thread, reaches them too while they are bound)."""

    def __init__(self, now_us):
        self.owner = threading.get_ident()
        self.spans = [_Span(now_us - 60_000_000), _Span(0),
                      _Span(now_us - 1000), _Span(now_us)]
        self.global_collector = self
        self.incidents, self.ticks = [], []

    def _mine(self):
        return threading.get_ident() == self.owner

    def recent(self, n):
        return self.spans[-n:] if self._mine() else []

    def global_recorder(self):
        return self

    def note_incident(self, text):
        if self._mine():
            self.incidents.append(text)

    def incident_sample_tick(self, opened, closed, t):
        if self._mine():
            self.ticks.append((opened.id if opened else None,
                               closed.id if closed else None, t))


def _series(rng):
    """Ticks of three watched keys with breaks: sheds spike, errors step
    up and decay, a p99 wanders and spikes twice."""
    ticks = []
    for t in range(120):
        shed = 100.0 * rng.randint(2, 5) if t in (20, 21, 70) else \
            float(rng.randint(0, 2))
        err = 40.0 if 45 <= t < 48 else float(rng.randint(0, 3))
        p99 = float(rng.normal(500, 20)) * (8 if t in (90, 91) else 1)
        pts = {"server_limit_shed": shed, "server_errors": err,
               "m.p99": p99}
        if t < 3:
            del pts["m.p99"]            # a key that appears later
        ticks.append(pts)
    return ticks


def _incidents_equal():
    """Fresh watchdogs, one synthetic series: equal incident records and
    keys, equal annotations, the same hand-offs to the manager."""
    import time
    for flags in ({}, {"anomaly_z_open": 4.0, "anomaly_close_ticks": 2,
                       "anomaly_warmup_ticks": 8}):
        got = {}
        with _Flags(**flags):
            for name, _, an, _ in SIDES:
                stand = _Stand(time.monotonic_ns() // 1000)
                saved = (an._span_mod, an._fr_mod, an._inc_mod)
                an._span_mod = an._fr_mod = an._inc_mod = stand
                try:
                    wd = an.AnomalyWatchdog()
                    for t, pts in enumerate(_series(
                            np.random.RandomState(11))):
                        wd.watchdog_pass(pts, 5000 + t)
                    got[name] = (wd.incident_snapshot(), wd.tracked_keys(),
                                 stand.incidents, stand.ticks,
                                 [s.notes for s in stand.spans])
                finally:
                    an._span_mod, an._fr_mod, an._inc_mod = saved
        assert got["port"] == got["ref"], flags
        incs = got["port"][0]
        assert len(incs) >= 3 and all(i["state"] == "closed" for i in incs)
        assert incs[0]["keys"] == ["server_limit_shed"]
        notes = got["port"][4]
        assert not notes[0] and not notes[1] and notes[3][0].startswith(
            "incident #1: server_limit_shed")
        opened = [o for o, _, _ in got["port"][3] if o]
        assert opened == [i["id"] for i in incs]


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _pushes(ser):
    return len(ser["min"]) * port_series.SEC_BUCKETS + ser["live_sec"]


def _timeline_pages():
    """A port server, ticked by hand: /timeline and /vars serve the rings,
    server_processed's new buckets sum to the calls, the kinds are the
    declared ones, and the payloads have brpc_tpu's keys."""
    svc = port_rpc.Service("Tl")
    svc.register_method("Echo", lambda cntl, req: req)
    srv = port_rpc.Server()
    srv.add_service(svc)
    port = srv.start("tcp://127.0.0.1:0").port
    ch = port_rpc.Channel(f"tcp://127.0.0.1:{port}")
    try:
        def ring(name):
            return port_series.global_series().dump_series(
                names=[name]).get(name, {"min": [], "live_sec": 0})

        def tick():
            """A tick that stored: a hand tick skips while the sampler's
            own runs, which then stores within a second."""
            p0 = _pushes(ring("server_processed"))
            port_series.series_sample_tick()
            assert _wait_for(
                lambda: _pushes(ring("server_processed")) > p0, 3.0)
            return ring("server_processed")
        tick()                                  # re-baselines the triple
        r0 = tick()
        for i in range(5):
            assert not ch.call_sync("Tl", "Echo", b"x").failed()
        tick()
        for i in range(3):
            assert not ch.call_sync("Tl", "Echo", b"y").failed()
        for _ in range(3):          # until a tick after the calls stored
            r1 = tick()
            new = _pushes(r1) - _pushes(r0)
            assert 2 <= new <= 60, new
            if sum(v for _, v in r1["sec"][-new:]) == 8:
                break
        assert sum(v for _, v in r1["sec"][-new:]) == 8
        assert r1["kind"] == "delta"
        assert ring("server_errors")["kind"] == "delta"
        assert ring("server_latency_p99_us")["kind"] == "max"
        status, body = _get(port, "/timeline?name=server_processed,"
                                  "server_errors")
        assert status == 200
        page = json.loads(body)
        assert sorted(page["series"]) == ["server_errors",
                                          "server_processed"]
        ref_page = ref_services.timeline_page_payload(None, names=[])
        assert set(page) == set(ref_page)
        assert set(page["series"]["server_processed"]) == set(
            ref_series._Ring("delta").to_dict())
        assert set(page["resolution"]) == set(ref_page["resolution"])
        assert set(port_anomaly.Incident(1, 0).to_dict()) == set(
            ref_anomaly.Incident(1, 0).to_dict())
        status, body = _get(port, "/timeline?prefix=server_proc")
        assert status == 200 and list(json.loads(body)["series"]) == [
            "server_processed"]
        assert _get(port, "/timeline?name=no_such_var")[0] == 400
        status, body = _get(port, "/vars?series=server_processed")
        assert status == 200 and json.loads(body)["server_processed"][
            "kind"] == "delta"
        assert _get(port, "/vars?series=no_such_var")[0] == 400
        # the page against the spark of the same tick: a read that a
        # sampler tick split is taken again
        spark = port_series.global_series().spark
        for _ in range(5):
            want = spark("server_processed")
            status, body = _get(port, "/vars?prefix=server_processed")
            if spark("server_processed") == want:
                break
        line = body.decode().splitlines()[0]
        assert line.startswith("server_processed : ") and \
            line.endswith(want), line
        # the builtin service's twin
        r = ch.call_sync("builtin", "timeline", b"server_proc")
        assert not r.failed() and list(json.loads(r.response)["series"]) \
            == ["server_processed"]
        assert port_services.timeline_page_payload()["enabled"] is True
    finally:
        ch.close()
        srv.stop()
        srv.join(2)


CASES = [
    ("rings at injected stamps", _rings_equal, ()),
    ("readings of real variables", _collect_equal, ()),
    ("sparklines", _sparklines, ()),
    ("the watch keys", _watch_keys, ()),
    ("incidents from one series", _incidents_equal, ()),
    ("/timeline and /vars?series=", _timeline_pages, ()),
]


def test_timeline():
    _run_cases(CASES)
