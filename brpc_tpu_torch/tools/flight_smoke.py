"""The flight recorder's smoke (the port of tools/flight_smoke.py; the
gate ``flight_smoke`` of ``tools.preflight --gate``)::

    python3 -m brpc_tpu_torch.tools.flight_smoke [--shards N] [--seconds S]

Three invariants over a loopback PyEcho load:

  1. capture: with continuous profiling on (20 Hz), the merged profile
     gives at least 80% of the busy samples to ``Bench.PyEcho`` and its
     folded stacks hold PyEcho frames;
  2. overhead: qps with the profiler on stays within 5% of the profiler
     off; two echo servers, one at 20 Hz and one at 0, loaded at once
     (``smoke_util.simultaneous_overhead``; the reference alternates
     windows on one server, which reads the host's drift);
  3. census: ``/census``'s server socket totals equal the sum of the
     per-connection rows of ``/connections``.

``--shards N`` drives an N-shard group (``tools.shard_server``) instead
and checks the supervisor's merged continuous profile. One JSON line;
``BRPC_TPU_TORCH_PERF_SMOKE=0`` skips the overhead criterion only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ECHO_ATTRIBUTION_FLOOR = 0.8


def http_get(port: int, path: str):
    from brpc_tpu_torch.tools.spawn_util import http_get_local
    _, body = http_get_local(port, path)
    try:
        return json.loads(body)
    except ValueError:
        return body.decode("latin1")


def echo_ratio(prof: dict) -> float:
    """The share of the profile's busy samples labelled with an Echo
    RPC method."""
    labels = prof.get("labels", {})
    nbusy = prof.get("nbusy") or 0
    echo = sum(n for k, n in labels.items()
               if k.startswith("rpc:") and "Echo" in k)
    return echo / nbusy if nbusy else 0.0


def _census_consistent(port: int, tries: int = 4):
    """``/census``'s server socket totals against the ``/connections``
    rows: the same accounting and the same scope, so they agree but for
    a connection that appears between the two reads (retried)."""
    last = None
    for _ in range(tries):
        census = http_get(port, "/census")
        conns = http_get(port, "/connections")
        rows = conns["connections"]
        row_sum = sum(r["resident_bytes"] for r in rows)
        sub = census["subsystems"]["sockets"]
        last = {"census_bytes": sub["server_bytes"],
                "rows_bytes": row_sum,
                "census_count": sub["server_count"],
                "rows_count": len(rows)}
        if sub["server_bytes"] == row_sum and \
                sub["server_count"] == len(rows):
            return True, last
        time.sleep(0.3)
    return False, last


def _profile(out: dict, port: int) -> None:
    prof = http_get(port, "/hotspots?mode=continuous&format=json")
    out["profile_nbusy"] = prof.get("nbusy")
    out["attribution_ratio"] = round(echo_ratio(prof), 3)
    out["pyecho_in_folded"] = any(
        "PyEcho" in k for k in prof.get("folded", {}))
    out["stall_ms_max_10s"] = prof.get("stall_ms_max_10s")


def run_single(out: dict, seconds: float) -> None:
    from brpc_tpu_torch.tools.qps_client import drive_multiproc
    from brpc_tpu_torch.tools.smoke_util import (OVERHEAD_PCT_MAX,
                                                 perf_off,
                                                 simultaneous_overhead,
                                                 spawn_echo_servers,
                                                 stop_all)
    procs, ports = spawn_echo_servers({"on": {}, "off": {}})
    try:
        for tag, hz in (("on", 20), ("off", 0)):
            r = http_get(ports[tag],
                         f"/flags/continuous_profiler_hz?setvalue={hz}")
            assert r == "OK", r
        skip_perf = perf_off()
        if skip_perf:
            # the profile still needs a load to sample: as long as the
            # reference's two profiled windows
            nprocs = min(4, max(2, (os.cpu_count() or 2) // 4))
            drive_multiproc(ports["on"], nprocs=nprocs,
                            seconds=2 * seconds, conns=2, inflight=8,
                            method="PyEcho")
        else:
            got = simultaneous_overhead(ports["on"], ports["off"],
                                        window_s=seconds)
            out["qps_on"], out["qps_off"] = got["qps_on"], got["qps_off"]
            out["profiler_overhead_pct"] = got["overhead_pct"]
            out["overhead_rounds"] = got["rounds"]
        _profile(out, ports["on"])
        ok, detail = _census_consistent(ports["on"])
        out["census_ok"] = ok
        out["census_detail"] = detail
        out["ok"] = bool(
            out.get("pyecho_in_folded")
            and out.get("attribution_ratio", 0) >= ECHO_ATTRIBUTION_FLOOR
            and out.get("census_ok")
            and (skip_perf
                 or out.get("profiler_overhead_pct", 100.0)
                 <= OVERHEAD_PCT_MAX))
        if not out["ok"]:
            out["invariant"] = "capture/overhead/census check failed"
    finally:
        stop_all(procs)


def run_sharded(out: dict, shards: int, seconds: float) -> None:
    from brpc_tpu_torch.tools.qps_client import drive_multiproc
    from brpc_tpu_torch.tools.smoke_util import stop_all
    from brpc_tpu_torch.tools.spawn_util import (package_root,
                                                 spawn_announcing_server)
    sproc, got = spawn_announcing_server(
        ["-m", "brpc_tpu_torch.tools.shard_server", "--shards",
         str(shards)], wall_s=60.0, keys=("ADMIN", "PORT"),
        cwd=package_root())
    if got is None:
        out["error"] = "shard server spawn failed"
        return
    try:
        nprocs = min(shards + 2, max(2, (os.cpu_count() or 2) // 2))
        res = drive_multiproc(got["PORT"], nprocs=nprocs, seconds=seconds,
                              conns=2, inflight=8, method="PyEcho")
        out["qps_sharded"] = res["qps"]
        time.sleep(0.6)   # one dump interval: the recorders' states flush
        out["shards"] = shards
        _profile(out, got["ADMIN"])
        out["ok"] = bool(
            out.get("pyecho_in_folded")
            and out.get("attribution_ratio", 0) >= ECHO_ATTRIBUTION_FLOOR)
        if not out["ok"]:
            out["invariant"] = "merged shard profile failed attribution"
    finally:
        stop_all([sproc])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shards", type=int, default=0,
                    help="drive an N-shard group and check the merged "
                         "continuous profile instead of the single-"
                         "process overhead/census lane")
    ap.add_argument("--seconds", type=float, default=1.3,
                    help="load window length per measurement")
    args = ap.parse_args()
    out: dict = {"mode": f"sharded:{args.shards}" if args.shards
                 else "single"}
    try:
        if args.shards:
            run_sharded(out, args.shards, args.seconds)
        else:
            run_single(out, args.seconds)
    except Exception as e:  # noqa: BLE001 - one JSON line either way
        out["ok"] = False
        out["error"] = f"{type(e).__name__}: {e}"[:300]
    print(json.dumps(out))
    sys.stdout.flush()
    return 0 if out.get("ok") else 1


if __name__ == "__main__":
    rc = main()
    os._exit(rc)
