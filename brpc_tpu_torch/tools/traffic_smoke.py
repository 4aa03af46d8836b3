"""The traffic engine's smoke: capture, corpus and a time-warped replay,
and the capture's price (the port of tools/traffic_smoke.py; the gate
``traffic_smoke`` of ``tools.preflight --gate``)::

    python3 -m brpc_tpu_torch.tools.traffic_smoke [--smoke|--bench|--serve]

``--smoke`` (the default): record a paced burst of mixed sizes and
priorities through the live capture path; the corpus holds the driven
per-method counts exactly and the recorder leaks nothing; replayed at
2x time-warp, the handlers see the same counts, the wall lands near
half the recorded span and the schedule's fidelity is at least 85.
Exit 1 with a ``problems`` list on any violation.

``--bench``: one JSON line, ``replay_fidelity_pct`` of a 1x replay and
``capture_overhead_pct``, capture at its defaults against capture off
(and ``capture_overhead_full_pct``, every request recorded), each pair
of echo nodes loaded at once by worker processes
(``smoke_util.simultaneous_overhead``; the reference alternates
windows). Nothing reads the line but its caller.

``--serve``: one PyEcho node (for ``--bench``); it captures when
``BRPC_TPU_TORCH_TRAFFIC_CAPTURE_DIR`` is set, every request when
``BRPC_TPU_TORCH_TRAFFIC_CAPTURE_FULL`` is set too.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time


# ------------------------------------------------------------- node
def run_serve() -> None:
    from brpc_tpu_torch.rpc import Server, ServerOptions, Service
    from brpc_tpu_torch.tools.bench_echo_server import add_echo_methods
    from brpc_tpu_torch.tools.spawn_util import parent_death_watchdog_loop

    server = Server(ServerOptions(enable_builtin_services=False))
    svc = Service("Bench")
    add_echo_methods(svc)
    server.add_service(svc)
    ep = server.start("tcp://127.0.0.1:0")
    cap_dir = os.environ.get("BRPC_TPU_TORCH_TRAFFIC_CAPTURE_DIR")
    if cap_dir:
        from brpc_tpu_torch.traffic.capture import start_capture
        if os.environ.get("BRPC_TPU_TORCH_TRAFFIC_CAPTURE_FULL"):
            # corpus-recording mode: every request, no budget
            start_capture(dir=cap_dir, default_rate=1.0,
                          max_per_second=0)
        else:
            start_capture(dir=cap_dir)      # the budgeted defaults
    print(f"PORT {ep.port}", flush=True)
    parent_death_watchdog_loop()


# ---------------------------------------------------- record + replay
def smoke_records(qps: float, seconds: float):
    """The recorded drive's records: Traffic.Small at 3/4 of ``qps``
    (16 B and 512 B, priorities 1 and 9) and Traffic.Big at 1/4 (2 KiB,
    priorities 0 and 5), seeded, in arrival order."""
    from brpc_tpu_torch.traffic.replay import parse_mix, synthesize_records
    n = max(20, int(qps * seconds))
    recs = (synthesize_records(
                n * 3 // 4, parse_mix("16:0.6,512:0.4"),
                parse_mix("1:0.8,9:0.2"), qps=qps * 3 / 4,
                mode="poisson", seed=11, service="Traffic",
                method="Small", timeout_ms=3000)
            + synthesize_records(
                n - n * 3 // 4, parse_mix("2048:1.0"),
                parse_mix("0:0.5,5:0.5"), qps=qps / 4,
                mode="poisson", seed=12, service="Traffic",
                method="Big", timeout_ms=3000))
    recs.sort(key=lambda r: r.arrival_mono_ns)
    return recs


def _record_and_replay(qps: float, seconds: float, warp: float,
                       problems: list) -> dict:
    """One record -> corpus -> replay round trip in this process: the
    measurements, with each violation appended to ``problems``."""
    import shutil

    from brpc_tpu_torch.rpc import Server, ServerOptions, Service
    from brpc_tpu_torch.traffic import capture
    from brpc_tpu_torch.traffic.corpus import read_corpus
    from brpc_tpu_torch.traffic.replay import PaceSpec, run_open_loop

    hits: dict = {}
    server = Server(ServerOptions(enable_builtin_services=False))
    svc = Service("Traffic")

    def _count(name):
        hits[name] = hits.get(name, 0) + 1

    @svc.method()
    async def Small(cntl, request):
        _count("Traffic.Small")
        return request

    @svc.method()
    async def Big(cntl, request):
        _count("Traffic.Big")
        return bytes(request)[:64]

    server.add_service(svc)
    ep = server.start("tcp://127.0.0.1:0")
    addr = f"tcp://127.0.0.1:{ep.port}"
    cap_dir = tempfile.mkdtemp(prefix="traffic-smoke-")
    out: dict = {}
    try:
        recs = smoke_records(qps, seconds)
        capture.start_capture(dir=cap_dir, default_rate=1.0,
                              max_per_second=0)
        drive = run_open_loop(recs, addr, PaceSpec("recorded"), conns=4)
        if drive["fail"]:
            problems.append(f"record drive failures: {drive['fail']}")
        snap = capture.stop_capture()
        if snap["pending"]:
            problems.append(f"recorder left {snap['pending']} pending")
        if snap["dropped_queue"]:
            problems.append(
                f"recorder dropped {snap['dropped_queue']} in-queue")
        corpus = read_corpus(cap_dir)
        counts: dict = {}
        for r in corpus:
            counts[r.method_key] = counts.get(r.method_key, 0) + 1
        out["recorded"] = dict(sorted(counts.items()))
        out["driven"] = dict(sorted(hits.items()))
        if counts != hits:
            problems.append(
                f"corpus counts {counts} != driven counts {hits}")
        bad_status = sum(1 for r in corpus if r.status != 0)
        if bad_status:
            problems.append(f"{bad_status} corpus records non-OK")
        prios = {r.priority for r in corpus}
        if not {1, 9} <= prios:
            problems.append(f"priority tags lost in capture: {prios}")
        span_s = (corpus[-1].arrival_mono_ns
                  - corpus[0].arrival_mono_ns) / 1e9 if corpus else 0.0
        out["recorded_span_s"] = round(span_s, 3)

        # ---- replay at ``warp`` against the same server, capture off
        before = dict(hits)
        rep = run_open_loop(corpus, addr, PaceSpec("recorded", warp=warp),
                            conns=4)
        replayed = {k: hits.get(k, 0) - before.get(k, 0) for k in hits}
        out["replayed"] = dict(sorted(replayed.items()))
        out["replay_fidelity_pct"] = rep["fidelity_pct"]
        out["replay_elapsed_s"] = rep["elapsed_s"]
        out["behind_ms_max"] = rep["behind_ms_max"]
        if replayed != counts:
            problems.append(
                f"replayed counts {replayed} != corpus {counts}")
        if rep["fail"]:
            problems.append(f"replay failures: {rep['fail']}")
        if rep["fidelity_pct"] is None or rep["fidelity_pct"] < 85:
            problems.append(
                f"replay fidelity {rep['fidelity_pct']} < 85")
        expect = span_s / warp
        if expect > 0.2 and not (0.5 * expect <= rep["elapsed_s"]
                                 <= 2.0 * expect + 0.5):
            problems.append(
                f"{warp}x-warp replay took {rep['elapsed_s']}s, "
                f"expected ~{round(expect, 2)}s (interarrival error "
                f"out of tolerance)")
    finally:
        server.stop()
        server.join(2)
        shutil.rmtree(cap_dir, ignore_errors=True)
    return out


def run_smoke() -> dict:
    t0 = time.monotonic()
    problems: list = []
    out = _record_and_replay(qps=150.0, seconds=1.6, warp=2.0,
                             problems=problems)
    out["problems"] = problems
    out["elapsed_s"] = round(time.monotonic() - t0, 2)
    return out


# ------------------------------------------------------------- bench
def measure_overhead() -> dict:
    """``capture_overhead_pct``: a capture-off node against one at the
    capture's defaults (the budgeted sampler), and against one that
    records every request, each pair loaded at once."""
    import shutil

    from brpc_tpu_torch.traffic.corpus import read_corpus
    from brpc_tpu_torch.tools.smoke_util import (simultaneous_overhead,
                                                 spawn_echo_servers,
                                                 stop_all)
    cap_dir = tempfile.mkdtemp(prefix="traffic-bench-cap-")
    full_dir = tempfile.mkdtemp(prefix="traffic-bench-capfull-")
    dir_key = "BRPC_TPU_TORCH_TRAFFIC_CAPTURE_DIR"
    full_key = "BRPC_TPU_TORCH_TRAFFIC_CAPTURE_FULL"
    procs, ports = spawn_echo_servers(
        {"off": {dir_key: None, full_key: None},
         "on": {dir_key: cap_dir, full_key: None},
         "full": {dir_key: full_dir, full_key: "1"}},
        argv=["-m", "brpc_tpu_torch.tools.traffic_smoke", "--serve"])
    try:
        on = simultaneous_overhead(ports["on"], ports["off"])
        full = simultaneous_overhead(ports["full"], ports["off"])
    finally:
        stop_all(procs)
    out = {
        "qps_capture_on": on["qps_on"], "qps_capture_off": on["qps_off"],
        "qps_capture_full": full["qps_on"],
        "captured_under_load": len(read_corpus(cap_dir)),
        "captured_full_rate": len(read_corpus(full_dir)),
        "capture_overhead_pct": on["overhead_pct"],
        "capture_overhead_full_pct": full["overhead_pct"],
    }
    shutil.rmtree(cap_dir, ignore_errors=True)
    shutil.rmtree(full_dir, ignore_errors=True)
    return out


def run_bench() -> dict:
    t0 = time.monotonic()
    problems: list = []
    out = _record_and_replay(qps=200.0, seconds=1.5, warp=1.0,
                             problems=problems)
    out.update(measure_overhead())
    out["problems"] = problems
    out["elapsed_s"] = round(time.monotonic() - t0, 2)
    return out


def main() -> int:
    args = sys.argv[1:]
    if "--serve" in args:
        run_serve()
        return 0
    if "--bench" in args:
        rep = run_bench()
        print(json.dumps(rep), flush=True)
        return 0
    rep = run_smoke()
    print(json.dumps(rep), flush=True)
    return 1 if rep["problems"] else 0


if __name__ == "__main__":
    rc = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)    # skip the runtime threads' teardown
