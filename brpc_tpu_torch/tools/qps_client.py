"""Load in qps from several client processes (the port of
tools/qps_client.py). One Python client process is bound by its
interpreter lock as much as one server process is, so a load that must
grow with the cores runs this tool N times as processes, each driving
``conns`` connections of pipelined async echoes (each completion issues
the next call from its done callback) for a fixed window.

    python3 -m brpc_tpu_torch.tools.qps_client PORT SECONDS CONNS \
        [INFLIGHT] [METHOD]

(one worker) prints one JSON line ``{"calls": n, "failures": f,
"elapsed_s": dt, "qps": q}``. ``drive_multiproc(port, nprocs, seconds,
conns)`` starts nprocs workers as ``python3 -m
brpc_tpu_torch.tools.qps_client`` and sums their windows.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from typing import Optional

from brpc_tpu_torch.tools.spawn_util import package_root


def drive_window(port, seconds: float, conns: int,
                 inflight: int = 8, method: str = "Echo") -> dict:
    """Drive ``conns`` connections of their own for ``seconds``: calls,
    failures (counted apart, so that a dead window shows as one and not
    as a slow one), elapsed and qps.

    ``port`` may be a comma list ("5001,5002"): each connection slot is
    then a ClusterChannel over ``list://`` with round-robin, so that the
    load spreads over the backends and their stat cells.

    Each connection keeps ``inflight`` calls in flight, each completion
    issuing the next from its done callback (the reference's async
    client): a sync call at a time is bound by the round trip and would
    measure that, not the server; ``inflight=1`` is that shape.
    """
    from brpc_tpu_torch.rpc import Channel, ChannelOptions, ClusterChannel

    ports = [int(p) for p in str(port).split(",")]
    if len(ports) > 1:
        naming = "list://" + ",".join(
            f"tcp://127.0.0.1:{p}" for p in ports)
        chs = [ClusterChannel(naming, "rr",
                              ChannelOptions(timeout_ms=5000, max_retry=2,
                                             share_connections=False,
                                             name=f"qps-{i}"))
               for i in range(conns)]
    else:
        chs = [Channel(f"tcp://127.0.0.1:{ports[0]}",
                       ChannelOptions(timeout_ms=5000, max_retry=2,
                                      share_connections=False))
               for _ in range(conns)]
    for c in chs:
        for _ in range(10):
            c.call_sync("Bench", method, b"w")
    counts = [0] * conns
    failures = [0] * conns
    stop_at = time.perf_counter() + seconds
    done_ev = threading.Event()
    live = [conns * inflight]          # in-flight lanes still running
    # completions land on several threads (the dispatcher, fiber
    # workers): the counters need a lock, since a lost decrement of
    # live[0] would park the window until its timeout
    lock = threading.Lock()

    def lane_done() -> None:
        with lock:
            live[0] -= 1
            last = live[0] <= 0
        if last:
            done_ev.set()

    def issue(i: int) -> None:
        ch = chs[i]

        def _done(cntl) -> None:
            with lock:
                if cntl.failed():
                    failures[i] += 1
                else:
                    counts[i] += 1
            if time.perf_counter() < stop_at:
                issue(i)
            else:
                lane_done()

        try:
            ch.call("Bench", method, b"q", done=_done)
        except Exception:
            with lock:
                failures[i] += 1
            lane_done()

    t0 = time.perf_counter()
    for i in range(conns):
        for _ in range(inflight):
            issue(i)
    done_ev.wait(seconds + 20)
    dt = time.perf_counter() - t0
    for c in chs:
        c.close()
    return {"calls": sum(counts), "failures": sum(failures),
            "elapsed_s": round(dt, 3),
            "qps": round(sum(counts) / dt, 1) if dt > 0 else 0.0}


def drive_multiproc(port, nprocs: int, seconds: float,
                    conns: int, inflight: int = 8,
                    method: str = "Echo",
                    wall_s: float = 60.0,
                    env: Optional[dict] = None) -> dict:
    """The qps of ``nprocs`` worker processes summed (each its own
    interpreter); ``port`` as in drive_window. A worker that reports
    nothing counts in ``dead_workers`` instead of quietly shrinking the
    load. ``env`` replaces this process's environment in the workers
    (two loads that differ in a switch can then run at once)."""
    procs = []
    for _ in range(nprocs):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "brpc_tpu_torch.tools.qps_client",
             str(port), str(seconds), str(conns), str(inflight),
             method],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            cwd=package_root(), env=env))
    total_calls = 0
    total_failures = 0
    dead = 0
    max_dt = 0.0
    deadline = time.monotonic() + wall_s
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(5.0,
                                               deadline - time.monotonic()))
            rec = json.loads(out.strip().splitlines()[-1])
            total_calls += rec["calls"]
            total_failures += rec.get("failures", 0)
            max_dt = max(max_dt, rec["elapsed_s"])
        except Exception:
            dead += 1
            try:
                p.kill()
            except Exception:
                pass
    return {"calls": total_calls, "failures": total_failures,
            "workers": nprocs, "dead_workers": dead,
            "elapsed_s": round(max_dt, 3),
            "qps": round(total_calls / max_dt, 1) if max_dt > 0 else 0.0}


def main() -> int:
    port = sys.argv[1]          # "5001", or "5001,5002" for a cluster
    seconds = float(sys.argv[2]) if len(sys.argv) > 2 else 1.5
    conns = int(sys.argv[3]) if len(sys.argv) > 3 else 2
    inflight = int(sys.argv[4]) if len(sys.argv) > 4 else 8
    method = sys.argv[5] if len(sys.argv) > 5 else "Echo"
    print(json.dumps(drive_window(port, seconds, conns, inflight, method)),
          flush=True)
    return 0


if __name__ == "__main__":
    rc = main()
    os._exit(rc)   # skip the runtime threads' teardown
