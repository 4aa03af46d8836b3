"""rpc_replay: time-warped open-loop replay of a captured corpus (the
port of tools/rpc_replay.py, over the traffic engine).

    python3 -m brpc_tpu_torch.tools.rpc_replay CORPUS tcp://host:port --warp 2
    python3 -m brpc_tpu_torch.tools.rpc_replay capture_dir/ tcp://host:port \
        --mode qps --qps 500 --procs 4

CORPUS is a .brpccap file, a capture directory (shard files merge in
arrival order), or a legacy rpc_dump JSONL file. Pacing: recorded
inter-arrival intervals x 1/--warp (default), constant --qps, or a
seeded Poisson process. Replayed calls preserve the recorded method,
payload, attachment, priority tag and deadline (--timeout-scale
rescales the recorded budgets; records without one use
--default-timeout-ms).

Multi-process: --procs N spawns N workers (own GIL each, each started
as ``python3 -m brpc_tpu_torch.tools.rpc_replay``), round-robin record
slices, reports merged with pooled percentiles — the engine is OPEN loop
(``brpc_tpu_torch/traffic/replay.py``), so a slow server shows up as
latency/errors, never as silently reduced offered load.

CAUTION: if the target server is capturing into the SAME corpus being
replayed, every replayed request is re-sampled — a self-amplifying
loop. Stop capture (or replay a downloaded copy) first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from brpc_tpu_torch.tools.spawn_util import package_root


def load_records(path: str):
    """Corpus file / capture dir / legacy JSONL -> CapturedRequest
    list in arrival order."""
    from brpc_tpu_torch.traffic.corpus import (CapturedRequest, read_corpus)
    if os.path.isdir(path) or path.endswith(".brpccap"):
        return read_corpus(path)
    with open(path, "rb") as f:
        if f.read(4) == b"RIO1":
            return read_corpus(path)
    # legacy JSONL: synthesize stamps at a nominal 100/s so recorded
    # pacing still means something
    from brpc_tpu_torch.rpc.rpc_dump import load_dump
    out = []
    for i, (service, method, payload, log_id) in enumerate(
            load_dump(path)):
        out.append(CapturedRequest(
            method_key=f"{service}.{method}", service=service,
            method=method, payload=payload, attachment=b"",
            arrival_mono_ns=i * 10_000_000, arrival_wall_ns=0,
            timeout_ms=0.0, priority=0, log_id=log_id, status=0,
            latency_us=0.0))
    return out


def make_pace(args, nprocs: int = 1):
    from brpc_tpu_torch.traffic.replay import PaceSpec
    qps = args.qps / nprocs if args.qps else 0.0
    return PaceSpec(args.mode, warp=args.warp, qps=qps, seed=args.seed)


def run_worker(args) -> dict:
    from brpc_tpu_torch.traffic.replay import run_open_loop
    records = load_records(args.corpus)
    if args.nprocs > 1:
        records = records[args.worker::args.nprocs]
    return run_open_loop(
        records, args.address, make_pace(args, args.nprocs),
        conns=args.conns, timeout_scale=args.timeout_scale,
        default_timeout_ms=args.default_timeout_ms,
        bucket_width_s=args.bucket_width)


def run_multiproc(args) -> dict:
    from brpc_tpu_torch.traffic.replay import merge_reports
    # one bucket width for every worker, derived from the whole
    # corpus's schedule span, so the merged fidelity histograms align
    records = load_records(args.corpus)
    if not records:
        return {"records": 0, "error": "empty corpus"}
    span = make_pace(args).schedule_s(records)[-1] or 1e-3
    width = max(span / 200.0, min(0.1, span / 10.0))
    procs = []
    for i in range(args.procs):
        argv = [sys.executable, "-m", "brpc_tpu_torch.tools.rpc_replay",
                os.path.abspath(args.corpus), args.address,
                "--mode", args.mode,
                "--warp", str(args.warp), "--qps", str(args.qps),
                "--seed", str(args.seed + i),
                "--conns", str(args.conns),
                "--timeout-scale", str(args.timeout_scale),
                "--default-timeout-ms", str(args.default_timeout_ms),
                "--bucket-width", str(width),
                "--worker", str(i), "--nprocs", str(args.procs),
                "--json"]
        procs.append(subprocess.Popen(argv, stdout=subprocess.PIPE,
                                      stderr=subprocess.DEVNULL,
                                      cwd=package_root()))
    reports = []
    deadline = time.monotonic() + args.wall_s
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
    ap.add_argument("corpus", help=".brpccap file / capture dir / "
                                   "legacy jsonl dump")
    ap.add_argument("address")
    ap.add_argument("--mode", choices=["recorded", "qps", "poisson"],
                    default="recorded")
    ap.add_argument("--warp", type=float, default=1.0,
                    help="time-warp factor for recorded pacing "
                         "(2 = replay twice as fast)")
    ap.add_argument("--qps", type=float, default=0.0,
                    help="target rate for qps/poisson pacing")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--procs", type=int, default=1,
                    help="worker processes (own GIL each)")
    ap.add_argument("--conns", type=int, default=4)
    ap.add_argument("--timeout-scale", type=float, default=1.0,
                    help="rescale recorded deadline budgets")
    ap.add_argument("--default-timeout-ms", type=float, default=2000.0,
                    help="deadline for records with no recorded budget")
    ap.add_argument("--timeout-ms", type=float, default=None,
                    help="legacy alias of --default-timeout-ms (the "
                         "seed tool's per-call timeout)")
    ap.add_argument("--wall-s", type=float, default=300.0)
    ap.add_argument("--json", action="store_true",
                    help="one JSON report line (tooling mode)")
    ap.add_argument("--worker", type=int, default=0,
                    help=argparse.SUPPRESS)   # internal fan-out slice
    ap.add_argument("--nprocs", type=int, default=1,
                    help=argparse.SUPPRESS)
    ap.add_argument("--bucket-width", type=float, default=0.0,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.timeout_ms is not None:
        args.default_timeout_ms = args.timeout_ms
    if args.qps > 0 and args.mode == "recorded" \
            and "--mode" not in (argv if argv is not None
                                 else sys.argv[1:]):
        # the seed tool's `--qps N` meant "replay at N qps" with no
        # mode concept: honor it instead of silently ignoring it
        args.mode = "qps"
    if args.mode in ("qps", "poisson") and args.qps <= 0:
        ap.error(f"--mode {args.mode} needs --qps > 0")
    if args.procs > 1 and args.nprocs == 1:
        rep = run_multiproc(args)
    else:
        rep = run_worker(args)
    if args.json or args.nprocs > 1:
        print(json.dumps(rep), flush=True)
    else:
        print(json.dumps(rep, indent=2), flush=True)
        print(f"replayed ok={rep.get('ok', 0)} fail={rep.get('fail', 0)} "
              f"in {rep.get('elapsed_s', 0)}s "
              f"fidelity={rep.get('fidelity_pct')}%", flush=True)
    return 0 if rep.get("ok", 0) > 0 and rep.get("fail", 0) == 0 else 1


if __name__ == "__main__":
    rc = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)    # skip the runtime threads' teardown
