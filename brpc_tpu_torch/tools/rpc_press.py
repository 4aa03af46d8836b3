"""rpc_press: synthetic load press (the port of tools/rpc_press.py),
over the traffic engine's open-loop generator.

    python3 -m brpc_tpu_torch.tools.rpc_press tcp://127.0.0.1:8000 \
        Bench PyEcho --qps 2000 --duration 10 \
        --size-mix 64:0.8,4096:0.2 --priority-mix 1:0.9,9:0.1 --procs 4

Sizes and priority tags draw from weighted mixes (seeded), pacing is
constant-qps or Poisson, and the press is OPEN loop: the schedule is
fixed up front and a slowing server shows up as latency/errors, not as
silently reduced load. --save writes the synthetic corpus to .brpccap
first — the same format capture records and rpc_replay/rpc_view read,
so a press scenario is a shareable artifact, not a command line.

Legacy aliases kept from the seed tool: --payload-size (a one-entry
size mix) and --fibers (connection count). ``--protocol http`` presses
``POST /<service>/<method>`` through the HTTP client
(``protocol/http_client.py``): one keep-alive connection a fiber
(``--conns``), each taking its share of the same synthetic schedule at
its stamps, or as soon as its last call ended when the server is behind
(HTTP/1.1 answers a connection's requests in order, so a connection
carries one call at a time). Its report has the open-loop engine's
shape (a class a method and priority tag, which HTTP does not send;
an answer other than 200 is a failure under its status code), so
--procs merges it the same way. --procs starts each worker as
``python3 -m brpc_tpu_torch.tools.rpc_press``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

from brpc_tpu_torch.tools.spawn_util import package_root


def build_records(args, worker: int = 0, nprocs: int = 1):
    from brpc_tpu_torch.traffic.replay import parse_mix, synthesize_records
    n = args.count or max(1, int(args.qps * args.duration))
    n_slice = len(range(worker, n, nprocs))
    return synthesize_records(
        n_slice, parse_mix(args.size_mix), parse_mix(args.priority_mix),
        qps=args.qps / nprocs, mode=args.mode,
        seed=args.seed + worker, service=args.service,
        method=args.method, timeout_ms=args.timeout_ms)


def run_worker(args) -> dict:
    if args.protocol == "http":
        return run_http_press(args)
    from brpc_tpu_torch.traffic.replay import PaceSpec, run_open_loop
    records = build_records(args, args.worker, args.nprocs)
    pace = PaceSpec("recorded", warp=1.0)   # stamps carry the pacing
    return run_open_loop(records, args.address, pace, conns=args.conns,
                         default_timeout_ms=args.timeout_ms or 2000.0,
                         bucket_width_s=args.bucket_width)


def run_http_press(args) -> dict:
    """This worker's share of the schedule as ``POST
    /<service>/<method>`` over ``--conns`` keep-alive HTTP connections,
    one fiber each (tools/rpc_press.py:52-70)."""
    from brpc_tpu_torch.fiber import CountdownEvent, global_control, sleep
    from brpc_tpu_torch.protocol.http_client import (HttpClient,
                                                     HttpClientError)
    records = build_records(args, args.worker, args.nprocs)
    address = args.address
    if address.startswith("http://"):
        address = "tcp://" + address[len("http://"):]
    path = f"/{args.service}/{args.method}"
    timeout_s = (args.timeout_ms or 2000.0) / 1e3
    conns = max(1, min(args.conns, len(records)))
    classes: dict = {}
    totals = {"issued": 0, "ok": 0, "fail": 0, "behind_ms_max": 0.0}
    lock = threading.Lock()             # the fibers run on many workers
    done = CountdownEvent(conns)
    t0 = time.monotonic()

    def note(rec, code, lat_ms, behind_ms):
        with lock:
            _note(rec, code, lat_ms, behind_ms)

    def _note(rec, code, lat_ms, behind_ms):
        totals["issued"] += 1
        totals["behind_ms_max"] = max(totals["behind_ms_max"], behind_ms)
        c = classes.setdefault(f"{rec.method_key}|p{rec.priority}", {
            "ok": 0, "fail": 0, "error_codes": {}, "lat_ms_samples": []})
        if code == 200:
            c["ok"] += 1
            totals["ok"] += 1
            c["lat_ms_samples"].append(round(lat_ms, 3))
        else:
            c["fail"] += 1
            totals["fail"] += 1
            c["error_codes"][str(code)] = c["error_codes"].get(
                str(code), 0) + 1

    async def worker(share):
        cl = HttpClient(address, timeout_s=timeout_s)
        try:
            for rec in share:
                wait = t0 + rec.arrival_mono_ns / 1e9 - time.monotonic()
                if wait > 0:
                    await sleep(wait)
                s0 = time.perf_counter()
                try:
                    status, _, _ = await cl.request_async(
                        "POST", path, body=rec.payload)
                except HttpClientError:
                    status = "transport"
                note(rec, status, (time.perf_counter() - s0) * 1e3,
                     max(0.0, -wait * 1e3))
        finally:
            cl.close()
            done.signal()

    control = global_control()
    for i in range(conns):
        control.spawn(worker, records[i::conns], name="http_press")
    drained = done.wait_pthread(
        (records[-1].arrival_mono_ns / 1e9 if records else 0.0)
        + len(records) * timeout_s + 10)
    return {"records": len(records), "issued": totals["issued"],
            "ok": totals["ok"], "fail": totals["fail"],
            "undrained": 0 if drained else conns, "protocol": "http",
            "elapsed_s": round(time.monotonic() - t0, 3),
            "behind_ms_max": round(totals["behind_ms_max"], 2),
            "classes": classes}


def run_multiproc(args) -> dict:
    from brpc_tpu_torch.traffic.replay import merge_reports
    width = max(args.duration / 200.0, min(0.1, args.duration / 10.0))
    procs = []
    for i in range(args.procs):
        argv = [sys.executable, "-m", "brpc_tpu_torch.tools.rpc_press",
                args.address, args.service, args.method,
                "--qps", str(args.qps), "--duration", str(args.duration),
                "--count", str(args.count), "--mode", args.mode,
                "--size-mix", args.size_mix,
                "--priority-mix", args.priority_mix,
                "--timeout-ms", str(args.timeout_ms),
                "--seed", str(args.seed), "--conns", str(args.conns),
                "--bucket-width", str(width),
                "--protocol", args.protocol,
                "--worker", str(i), "--nprocs", str(args.procs)]
        procs.append(subprocess.Popen(argv, stdout=subprocess.PIPE,
                                      stderr=subprocess.DEVNULL,
                                      cwd=package_root()))
    reports = []
    deadline = time.monotonic() + args.duration + 60.0
    dead = 0
    for p in procs:
        try:
            out, _ = p.communicate(
                timeout=max(5.0, deadline - time.monotonic()))
            reports.append(json.loads(out.strip().splitlines()[-1]))
        except Exception:
            dead += 1
            try:
                p.kill()
                p.wait(5)
            except Exception:
                pass
    merged = merge_reports(reports)
    merged["dead_workers"] = dead
    return merged


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("address")
    ap.add_argument("service")
    ap.add_argument("method")
    ap.add_argument("--qps", type=float, default=1000.0,
                    help="offered rate (open loop)")
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--count", type=int, default=0,
                    help="request count (overrides qps*duration)")
    ap.add_argument("--mode", choices=["qps", "poisson"], default="qps")
    ap.add_argument("--size-mix", default="64:1.0",
                    help="payload sizes, 'bytes:weight,...'")
    ap.add_argument("--priority-mix", default="0:1.0",
                    help="priority tags, 'prio:weight,...'")
    ap.add_argument("--timeout-ms", type=float, default=2000.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--procs", type=int, default=1)
    ap.add_argument("--conns", type=int, default=4)
    ap.add_argument("--save", default="",
                    help="also write the synthetic corpus here (.brpccap)")
    ap.add_argument("--json", action="store_true")
    # legacy seed-tool aliases
    ap.add_argument("--protocol", choices=["tpu_std", "http"],
                    default="tpu_std",
                    help="http presses POST /<service>/<method> "
                         "through the HTTP client, a keep-alive "
                         "connection a fiber")
    ap.add_argument("--payload-size", type=int, default=0,
                    help="legacy: single payload size (= --size-mix N:1)")
    ap.add_argument("--fibers", type=int, default=0,
                    help="legacy: connection count (= --conns)")
    ap.add_argument("--worker", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--nprocs", type=int, default=1,
                    help=argparse.SUPPRESS)
    ap.add_argument("--bucket-width", type=float, default=0.0,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.payload_size:
        args.size_mix = f"{args.payload_size}:1.0"
    if args.fibers:
        args.conns = args.fibers

    if args.save:
        from brpc_tpu_torch.traffic.corpus import CorpusWriter
        w = CorpusWriter(args.save)
        for r in build_records(args):
            w.write(r)
        w.close()
        print(f"# corpus saved: {args.save} ({w.records} records)",
              file=sys.stderr, flush=True)

    if args.procs > 1 and args.nprocs == 1:
        rep = run_multiproc(args)
    else:
        rep = run_worker(args)
        if args.protocol == "http" and args.nprocs == 1:
            from brpc_tpu_torch.traffic.replay import merge_reports
            rep = merge_reports([rep])  # the percentiles, as --procs's
    if args.json or args.nprocs > 1:
        print(json.dumps(rep), flush=True)
    else:
        elapsed = rep.get("elapsed_s") or 1e-9
        per_prio = rep.get("per_priority", {})
        for p, d in sorted(per_prio.items()):
            print(f"priority {p}: ok={d['ok']} fail={d['fail']}")
        print(f"total={rep.get('ok', 0) + rep.get('fail', 0)} "
              f"ok={rep.get('ok', 0)} fail={rep.get('fail', 0)} "
              f"qps={rep.get('ok', 0) / elapsed:.0f} "
              f"fidelity={rep.get('fidelity_pct')}% "
              f"behind_ms_max={rep.get('behind_ms_max')}", flush=True)
    return 0 if rep.get("ok", 0) > 0 else 1


if __name__ == "__main__":
    rc = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)    # skip the runtime threads' teardown
