"""The device lane's perf smoke (the port of tools/device_perf_smoke.py;
the gate ``device_perf`` of ``tools.preflight --gate`` holds its ratios
to floors)::

    python3 -m brpc_tpu_torch.tools.device_perf_smoke [--device cpu]

Over an in-process ``ici://`` loopback on ``--device`` (``cuda:0``
unless given), each request's tensor copied onto the device fresh:

  ici_small_batch_us   pipelined 4 B-16 KiB device echo, mean latency
  ici_headline_GBps    pipelined 1 MiB device echo, both legs, GB/s
  small_latency_ratio  ici_small_batch_us over a host-payload 4 KiB
                       echo's mean latency on the same channel
  headline_ratio       ici_headline_GBps over a host-payload 1 MiB
                       echo's GB/s

The ratios against host payloads on the same channel in the same
process transfer across machines where absolute numbers do not. One
JSON line; exit 1 only on a measurement failure (the floors are the
gate's).
"""

from __future__ import annotations

import json
import os
import threading
import time


def _pipelined(n: int, inflight: int, issue) -> float:
    """Issue ``n`` calls keeping ``inflight`` outstanding: the wall
    seconds. ``issue(i, on_done)`` fires ``on_done(err)`` once."""
    sem = threading.Semaphore(inflight)
    done = threading.Event()
    state = {"left": n, "err": None}
    lock = threading.Lock()

    def on_done(err):
        sem.release()
        with lock:
            if err is not None and state["err"] is None:
                state["err"] = err
            state["left"] -= 1
            if state["left"] == 0:
                done.set()

    t0 = time.perf_counter()
    for i in range(n):
        sem.acquire()
        issue(i, on_done)
    if not done.wait(120.0):
        raise TimeoutError("pipelined burst never drained")
    if state["err"] is not None:
        raise RuntimeError(f"burst call failed: {state['err']}")
    return time.perf_counter() - t0


def main() -> int:
    import argparse

    import torch

    from brpc_tpu_torch.rpc import (Channel, ChannelOptions, Server,
                                    ServerOptions, Service)
    from brpc_tpu_torch.tools.smoke_util import lane_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="the lane's device: cuda:0 unless given")
    args = ap.parse_args()
    out: dict = {}
    server = ch = None
    try:
        dev, spec = lane_device(args.device)
        server = Server(ServerOptions(enable_builtin_services=False))
        svc = Service("Bench")

        @svc.method()
        def Echo(cntl, request):
            if cntl.request_device_arrays:
                cntl.response_device_arrays = list(
                    cntl.request_device_arrays)
            return bytes(request)

        server.add_service(svc)
        ep = server.start(f"ici://127.0.0.1:0#device={spec}")
        ch = Channel(f"ici://127.0.0.1:{ep.port}#device={spec}",
                     ChannelOptions(timeout_ms=30000))

        def device_burst(nbytes: int, n: int, inflight: int):
            host = torch.ones(max(1, nbytes // 4), dtype=torch.float32)
            lats = []

            def issue(i, on_done):
                t = time.perf_counter_ns()

                def cb(cntl):
                    lats.append((time.perf_counter_ns() - t) / 1e3)
                    on_done(None if not cntl.failed() else cntl.error_text)

                ch.call("Bench", "Echo", b"", done=cb,
                        request_device_arrays=[host.to(dev)])

            dt = _pipelined(n, inflight, issue)
            return dt, sum(lats) / len(lats)

        def host_burst(nbytes: int, n: int, inflight: int):
            payload = b"x" * nbytes
            lats = []

            def issue(i, on_done):
                t = time.perf_counter_ns()

                def cb(cntl):
                    lats.append((time.perf_counter_ns() - t) / 1e3)
                    on_done(None if not cntl.failed() else cntl.error_text)

                ch.call("Bench", "Echo", payload, done=cb)

            dt = _pipelined(n, inflight, issue)
            return dt, sum(lats) / len(lats)

        # warm both paths (the copy, the dial, the hello)
        device_burst(4, 4, 4)
        host_burst(4, 8, 4)

        # the small sizes, which coalesce
        small_lats = []
        for sz in (4, 256, 4096, 16384):
            _, avg = device_burst(sz, 32, 16)
            small_lats.append(avg)
        out["ici_small_batch_us"] = round(sum(small_lats)
                                          / len(small_lats), 1)
        _, host_small = host_burst(4096, 64, 16)
        out["host_small_us"] = round(host_small, 1)
        out["small_latency_ratio"] = round(
            out["ici_small_batch_us"] / host_small, 2)

        # the headline: 1 MiB both legs
        n = 24
        dt, _ = device_burst(1 << 20, n, 8)
        out["ici_headline_GBps"] = round(n * (1 << 20) * 2 / dt / 1e9, 4)
        dt, _ = host_burst(1 << 20, n, 8)
        host_gbps = n * (1 << 20) * 2 / dt / 1e9
        out["host_1mb_GBps"] = round(host_gbps, 4)
        out["headline_ratio"] = round(
            out["ici_headline_GBps"] / host_gbps, 3)

        intro = ch._get_socket().conn.lane_introspection()
        out["lane_kind"] = intro["lane_kind"]
        out["coalesced_frames"] = intro["coalesced_frames"]
        out["idle_acks"] = intro["idle_acks"]
        out["ok"] = True
    except BaseException as e:  # noqa: BLE001 - report, don't traceback
        out["ok"] = False
        out["error"] = f"{type(e).__name__}: {e}"[:300]
    finally:
        try:
            if ch is not None:
                ch.close()
            if server is not None:
                server.stop()
                server.join(2)
        except Exception:
            pass
    print(json.dumps(out), flush=True)
    return 0 if out.get("ok") else 1


if __name__ == "__main__":
    rc = main()
    os._exit(rc)    # skip the runtime threads' teardown
