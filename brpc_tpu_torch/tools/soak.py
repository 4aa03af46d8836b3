"""The mixed-traffic soak (the port of tools/soak.py): the hygiene check
of a long-lived server.

Four client loops run at once against ``tools.bench_echo_server`` in a
process of its own: small sync calls (the native echo lane), 1 MiB
attachment echoes, connection churn (a new channel a call), and streams
that open, push 8 MB and close. Meanwhile the server's and the client's
RSS, open fds and live fibers are sampled; a leak in any lane shows as
growth. One JSON line gives the verdict::

    python3 -m brpc_tpu_torch.tools.soak [--seconds 60]
    python3 -m brpc_tpu_torch.tools.soak --idle-conns N [--settle S]

``--idle-conns N`` holds N idle connections instead and reports what
each costs the server (``bytes_per_idle_conn``) beside its ``/census``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

from brpc_tpu_torch.tools.spawn_util import (http_get_local, package_root,
                                             spawn_port_server)

ECHO_SERVER = ["-m", "brpc_tpu_torch.tools.bench_echo_server"]


def _rss_mb(pid: int) -> int:
    with open(f"/proc/{pid}/status") as f:
        for ln in f:
            if ln.startswith("VmRSS"):
                return int(ln.split()[1]) // 1024
    return 0


def _nfds(pid: int) -> int:
    return len(os.listdir(f"/proc/{pid}/fd"))


def _http_get_json(port: int, path: str):
    _, body = http_get_local(port, path)
    try:
        return json.loads(body)
    except ValueError:
        return body.decode("latin1")   # the plain-text pages ("OK")


def idle_conn_soak(nconns: int, settle_s: float) -> int:
    """Hold ``nconns`` idle connections against an echo server and report
    what each costs: the server's RSS growth a connection
    (``bytes_per_idle_conn``) beside the census' own accounting of its
    connections and buffers (``/census``), so that fixed object cost
    and buffer growth can be told apart."""
    import resource
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    want = nconns + 512
    if soft < want:
        try:
            resource.setrlimit(resource.RLIMIT_NOFILE,
                               (min(want, hard), hard))
        except (ValueError, OSError):
            pass
    soft, _ = resource.getrlimit(resource.RLIMIT_NOFILE)
    nconns = min(nconns, max(256, soft - 512))

    proc, port = spawn_port_server(ECHO_SERVER, wall_s=20,
                                   cwd=package_root())
    if port is None:
        print(json.dumps({"ok": False, "error": "server spawn failed"}))
        return 1
    import socket as pysock
    conns: list = []
    result: dict = {"mode": "idle_conns", "requested": nconns}
    try:
        # the baseline after one warm call: what is made at first use
        # (pools, fiber workers) is not the connections' cost
        from brpc_tpu_torch.rpc import Channel, ChannelOptions
        ch = Channel(f"tcp://127.0.0.1:{port}",
                     ChannelOptions(timeout_ms=5000))
        c = ch.call_sync("Bench", "Echo", b"warm")
        ch.close()
        if c.failed():
            print(json.dumps({"ok": False, "error": "warm rpc failed"}))
            return 1
        time.sleep(0.5)
        rss0_kb = _rss_mb(proc.pid) * 1024
        t_open0 = time.monotonic()
        refused = 0
        while len(conns) < nconns:
            # in batches: a connect storm at full speed overflows the
            # listen backlog into refusals and timeouts
            for _ in range(min(200, nconns - len(conns))):
                try:
                    s = pysock.create_connection(("127.0.0.1", port),
                                                 timeout=10)
                    conns.append(s)
                except OSError:
                    refused += 1
                    if refused > nconns // 10 + 20:
                        raise
            time.sleep(0.02)
        open_s = time.monotonic() - t_open0
        # let the server accept them all and pass the idle threshold
        # (lowered through /flags, so that the census counts them idle)
        _http_get_json(port, "/flags/census_idle_s?setvalue=1")
        deadline = time.monotonic() + max(settle_s, 3.0) + 30.0
        census = None
        while time.monotonic() < deadline:
            time.sleep(1.0)
            census = _http_get_json(port, "/census")
            if census["connections"]["count"] >= nconns and \
                    census["connections"]["idle"] >= nconns:
                break
        rss1_kb = _rss_mb(proc.pid) * 1024
        per_conn = (rss1_kb - rss0_kb) * 1024 / max(1, len(conns))
        result.update({
            "ok": census is not None
            and census["connections"]["count"] >= len(conns) > 0,
            "idle_conns": len(conns),
            "open_s": round(open_s, 1),
            "refused": refused,
            "bytes_per_idle_conn": round(per_conn, 1),
            "srv_rss_before_mb": rss0_kb // 1024,
            "srv_rss_after_mb": rss1_kb // 1024,
            "census_connections": census["connections"] if census else None,
            "census_total_bytes": census.get("total_bytes")
            if census else None,
        })
    except Exception as e:  # noqa: BLE001 - a report, not a traceback
        result.update({"ok": False,
                       "error": f"{type(e).__name__}: {e}"[:300]})
    finally:
        for s in conns:
            try:
                s.close()
            except OSError:
                pass
        proc.terminate()
    print(json.dumps(result))
    return 0 if result.get("ok") else 1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--idle-conns", type=int, default=0,
                    help="idle-connection cost mode: hold N idle conns "
                         "and report bytes_per_idle_conn instead of the "
                         "mixed-traffic soak")
    ap.add_argument("--settle", type=float, default=3.0)
    args = ap.parse_args()
    if args.idle_conns:
        return idle_conn_soak(args.idle_conns, args.settle)

    proc, port = spawn_port_server(ECHO_SERVER, wall_s=20,
                                   cwd=package_root())
    if port is None:
        print(json.dumps({"ok": False, "error": "server spawn failed"}))
        return 1

    from brpc_tpu_torch.butil.iobuf import IOBuf
    from brpc_tpu_torch.fiber.stacks import live_fibers
    from brpc_tpu_torch.rpc import Channel, ChannelOptions, Controller

    stop = [False]
    counts = [0, 0, 0, 0]
    errors: list = []

    def small_loop():
        ch = Channel(f"tcp://127.0.0.1:{port}",
                     ChannelOptions(timeout_ms=5000))
        while not stop[0]:
            c = ch.call_sync("Bench", "Echo", b"ping")
            if c.failed():
                errors.append(c.error_text)
            counts[0] += 1
        ch.close()

    def big_loop():
        ch = Channel(f"tcp://127.0.0.1:{port}",
                     ChannelOptions(timeout_ms=30000))
        pay = b"\xa5" * (1 << 20)
        while not stop[0]:
            cntl = Controller()
            att = IOBuf()
            att.append(pay)
            cntl.request_attachment = att
            c = ch.call_sync("Bench", "Echo", b"", cntl=cntl)
            if c.failed():
                errors.append(c.error_text)
            counts[1] += 1
        ch.close()

    def churn_loop():
        while not stop[0]:
            ch = Channel(f"tcp://127.0.0.1:{port}",
                         ChannelOptions(timeout_ms=5000))
            c = ch.call_sync("Bench", "Echo", b"c")
            if c.failed():
                errors.append(c.error_text)
            ch.close()
            counts[2] += 1
            time.sleep(0.01)

    def stream_loop():
        # the stream's life and the native stream-frame lane: open, push
        # 8 MB of 64 KB frames, wait for the sink's answer, close; a
        # leaked stream entry, credit or queue shows as fiber or RSS
        # growth
        from brpc_tpu_torch import fiber
        from brpc_tpu_torch.rpc.stream import StreamOptions
        frame = b"\x33" * (64 << 10)
        n = 128
        while not stop[0]:
            done = threading.Event()
            ch = Channel(f"tcp://127.0.0.1:{port}",
                         ChannelOptions(timeout_ms=15000))
            cntl = ch.call_sync(
                "Bench", "StreamSink", str(len(frame) * n).encode(),
                stream_options=StreamOptions(
                    on_received=lambda s, m: done.set()))
            stream = cntl.stream
            if cntl.failed() or stream is None:
                errors.append(f"stream open: {cntl.error_text}")
                ch.close()
                continue

            async def producer():
                for _ in range(n):
                    if not await stream.write(frame):
                        break

            f = fiber.spawn(producer)
            f.join(20)
            if not done.wait(10):
                errors.append("stream sink never acked")
            stream.close()
            ch.close()
            counts[3] += 1

    ths = [threading.Thread(target=f, daemon=True)
           for f in (small_loop, big_loop, churn_loop, stream_loop)]
    for t in ths:
        t.start()
    samples = []
    t_end = time.monotonic() + args.seconds
    while time.monotonic() < t_end:
        time.sleep(min(10.0, max(1.0, t_end - time.monotonic())))
        snap = {"t": round(args.seconds - (t_end - time.monotonic()), 0),
                "srv_rss_mb": _rss_mb(proc.pid), "srv_fds": _nfds(proc.pid),
                "cli_rss_mb": _rss_mb(os.getpid()),
                "cli_fds": _nfds(os.getpid()),
                "live_fibers": len(live_fibers())}
        samples.append(snap)
        print(json.dumps({"progress": snap, "calls": list(counts)}),
              file=sys.stderr, flush=True)
    stop[0] = True
    time.sleep(1.0)
    proc.terminate()

    first, last = samples[0], samples[-1]
    growth = {k: last[k] - first[k] for k in
              ("srv_rss_mb", "srv_fds", "cli_rss_mb", "cli_fds",
               "live_fibers")}
    # RSS moves with the pools' high-water marks; growth of fds or
    # fibers, or of more than 64 MB of RSS over the window, is a leak
    ok = (not errors and growth["srv_fds"] == 0 and growth["cli_fds"] == 0
          and growth["live_fibers"] <= 2
          and growth["srv_rss_mb"] < 64 and growth["cli_rss_mb"] < 64)
    print(json.dumps({
        "ok": ok,
        "calls": {"small_sync": counts[0], "big_1mb": counts[1],
                  "conn_churn": counts[2], "stream_8mb": counts[3]},
        "moved_GB": round(counts[1] * 2 / 1024 + counts[3] * 8 / 1024, 1),
        "errors": len(errors),
        "first_sample": first, "last_sample": last, "growth": growth,
    }))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
