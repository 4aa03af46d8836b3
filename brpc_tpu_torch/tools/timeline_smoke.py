"""The trend rings' smoke (the port of tools/timeline_smoke.py; the gate
``timeline_smoke`` of ``tools.preflight --gate``)::

    python3 -m brpc_tpu_torch.tools.timeline_smoke

Five invariants, one JSON line:

  1. exact bucket math: a paced loopback burst's 1 s buckets of
     ``server_processed`` sum to the counter's delta exactly (the
     snapshot deltas partition the counter whatever the tick phase);
  2. one incident: a method that fails every call opens exactly one
     incident that names ``server_errors`` and annotates at least one
     in-window rpcz span (the watch filter is pinned to that key, so a
     noisy host's p99 cannot open a second);
  3. twin parity: HTTP ``/timeline`` and the builtin RPC ``timeline``
     return the same structure, built by one function;
  4. merged == sum: ``ShardAggregator.merged_timeline`` over two shard
     dumps sums the counters bucket by bucket and takes the max of p99
     (never the average);
  5. overhead <= 5%: two echo server processes, the rings on and off
     (``BRPC_TPU_TORCH_BVAR_SERIES``), loaded at once
     (``smoke_util.simultaneous_overhead``; the reference alternates
     windows). ``BRPC_TPU_TORCH_PERF_SMOKE=0`` skips this criterion only.

Exit 0 iff every criterion held.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time


def _tick(n: int = 1) -> None:
    from brpc_tpu_torch.bvar.series import series_sample_tick
    for _ in range(n):
        series_sample_tick()


def run_checks(out: dict) -> None:
    from brpc_tpu_torch.butil.flags import set_flag
    from brpc_tpu_torch.bvar.anomaly import global_watchdog
    from brpc_tpu_torch.bvar.series import global_series
    from brpc_tpu_torch.rpc import (Channel, ChannelOptions, Server,
                                    ServerOptions, Service)
    from brpc_tpu_torch.rpc import errno_codes as berr
    from brpc_tpu_torch.rpc.span import global_collector
    from brpc_tpu_torch.tools.smoke_util import OVERHEAD_PCT_MAX, perf_off
    from brpc_tpu_torch.tools.spawn_util import http_get_local

    set_flag("rpcz_enabled", "true")
    # only the fault key feeds the watchdog: a host's p99 jitter must
    # not open a second incident under the exactly-one check
    set_flag("anomaly_watch_filter", "server_errors")
    set_flag("anomaly_warmup_ticks", "3")
    set_flag("anomaly_close_ticks", "3")
    global_watchdog().reset()

    server = Server(ServerOptions(enable_builtin_services=True))
    svc = Service("Smoke")

    @svc.method()
    def PyEcho(cntl, request):
        return bytes(request)

    @svc.method()
    def Boom(cntl, request):
        cntl.set_failed(berr.EINTERNAL, "injected fault")
        return b""

    server.add_service(svc)
    ep = server.start("tcp://127.0.0.1:0")
    ch = Channel(f"tcp://127.0.0.1:{ep.port}",
                 ChannelOptions(timeout_ms=4000))
    try:
        # ---- 1. exact bucket math under a paced burst
        assert not ch.call_sync("Smoke", "PyEcho", b"w").failed()
        _tick(4)                       # settle: baseline + warm-up
        col = global_series()
        ser0 = col.dump_series(names=["server_processed"])
        sum0 = sum(v for _, v in ser0["server_processed"]["sec"])
        c0 = server.nprocessed
        calls = 0
        for burst in (7, 19, 3, 31):
            for _ in range(burst):
                if not ch.call_sync("Smoke", "PyEcho", b"x").failed():
                    calls += 1
            _tick()
        _tick()                        # flush the last partial bucket
        c1 = server.nprocessed
        ser1 = col.dump_series(names=["server_processed"])
        sum1 = sum(v for _, v in ser1["server_processed"]["sec"])
        out["burst_calls"] = calls
        out["bucket_sum_delta"] = sum1 - sum0
        out["counter_delta"] = c1 - c0
        # the background 1/s tick interleaves freely: the partition
        # makes the equality exact all the same
        out["bucket_exact"] = (sum1 - sum0) == (c1 - c0) and calls > 0

        # ---- 2. one incident, span-annotated
        before = len(global_watchdog().incident_snapshot())
        for _ in range(25):
            ch.call_sync("Smoke", "Boom", b"f")
        _tick()                        # the error spike's bucket
        incidents = global_watchdog().incident_snapshot()[before:]
        out["incidents_opened"] = len(incidents)
        inc = incidents[0] if incidents else {}
        out["incident_keys"] = inc.get("keys")
        out["incident_spans_annotated"] = inc.get("spans_annotated")
        annotated = any(
            any("incident #" in a for _, a in s.annotations)
            for s in global_collector.recent(64))
        out["incident_ok"] = (
            len(incidents) == 1
            and "server_errors" in (inc.get("keys") or ())
            and (inc.get("spans_annotated") or 0) >= 1 and annotated)

        # ---- 3. the HTTP page and the builtin twin agree
        st, body = http_get_local(ep.port, "/timeline")
        http_page = json.loads(body)
        r = ch.call_sync("builtin", "timeline", b"")
        twin = json.loads(r.response)
        out["twin_parity"] = bool(
            st == 200 and not r.failed()
            and set(http_page) == set(twin)
            and set(http_page["series"]) == set(twin["series"]))
        st, body = http_get_local(ep.port, "/timeline?name=nope")
        out["bad_name_400"] = st == 400
    finally:
        try:
            ch.close()
        except Exception:
            pass
        try:
            server.stop()
            server.join(2)
        except Exception:
            pass
        set_flag("anomaly_watch_filter", "")
        set_flag("rpcz_enabled", "false")

    out["merged_ok"] = merged_timeline_ok()

    # ---- 5. overhead: rings on and off, loaded at once
    skip_perf = perf_off()
    if not skip_perf:
        _overhead(out)
    ok = bool(out.get("bucket_exact") and out.get("incident_ok")
              and out.get("twin_parity") and out.get("bad_name_400")
              and out.get("merged_ok")
              and (skip_perf or out.get("series_overhead_pct", 100.0)
                   <= OVERHEAD_PCT_MAX))
    out["ok"] = ok
    if not ok:
        out["invariant"] = ("bucket/incident/twin/merged/overhead "
                            "check failed")


SHARD_SERIES = [
    {"server_processed": {"kind": "delta", "sec": [[100, 5], [101, 7]],
                          "min": [], "hr": []},
     "server_latency_p99_us": {"kind": "max",
                               "sec": [[100, 900.0], [101, 120.0]],
                               "min": [], "hr": []}},
    {"server_processed": {"kind": "delta", "sec": [[100, 11], [102, 2]],
                          "min": [], "hr": []},
     "server_latency_p99_us": {"kind": "max",
                               "sec": [[100, 150.0], [101, 130.0]],
                               "min": [], "hr": []}},
]


def merged_timeline_ok(aggregator_cls=None) -> bool:
    """4. The supervisor's merged series over two shard dumps: the
    per-bucket sum for a counter, the per-bucket max for p99.
    ``aggregator_cls`` defaults to the port's ``ShardAggregator``."""
    if aggregator_cls is None:
        from brpc_tpu_torch.rpc.shard_group import ShardAggregator
        aggregator_cls = ShardAggregator
    with tempfile.TemporaryDirectory(prefix="tl-smoke-") as tmp:
        for i, ser in enumerate(SHARD_SERIES):
            with open(os.path.join(tmp, f"shard-{i}.json"), "w") as f:
                json.dump({"shard": i, "pid": 1000 + i, "seq": 1,
                           "time": time.time(), "vars": {}, "status": {},
                           "latency_samples": {},
                           "timeline": {"enabled": True, "series": ser,
                                        "incidents": [],
                                        "watch_keys": []}}, f)
        merged = aggregator_cls(tmp, 2).merged_timeline()
    mp = dict((t, v) for t, v in
              merged["series"]["server_processed"]["sec"])
    mq = dict((t, v) for t, v in
              merged["series"]["server_latency_p99_us"]["sec"])
    return (mp == {100: 16, 101: 7, 102: 2}
            and mq == {100: 900.0, 101: 130.0}
            and merged["shards_reporting"] == 2)


def _overhead(out: dict) -> None:
    from brpc_tpu_torch.tools.smoke_util import (simultaneous_overhead,
                                                 spawn_echo_servers,
                                                 stop_all)
    procs, ports = spawn_echo_servers(
        {"on": {"BRPC_TPU_TORCH_BVAR_SERIES": "1"},
         "off": {"BRPC_TPU_TORCH_BVAR_SERIES": "0"}})
    try:
        got = simultaneous_overhead(ports["on"], ports["off"])
    finally:
        stop_all(procs)
    out["series_overhead_pct"] = got["overhead_pct"]
    out["overhead_qps"] = got


def main() -> int:
    t0 = time.monotonic()
    out: dict = {}
    try:
        run_checks(out)
    except Exception as e:  # noqa: BLE001 - one JSON line either way
        out["ok"] = False
        out["error"] = f"{type(e).__name__}: {e}"[:300]
    out["elapsed_s"] = round(time.monotonic() - t0, 2)
    print(json.dumps(out))
    sys.stdout.flush()
    return 0 if out.get("ok") else 1


if __name__ == "__main__":
    rc = main()
    os._exit(rc)   # skip the runtime threads' teardown
