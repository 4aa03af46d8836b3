"""The fast hot-path perf smoke (the port of tools/perf_smoke.py; the
gate ``perf_smoke`` of ``tools.preflight --gate`` holds its ratios to
floors)::

    python3 -m brpc_tpu_torch.tools.perf_smoke

Each ratio is normalised against a raw-socket calibration taken in the
same run on the same host, so that it transfers across machines where
absolute qps and GB/s do not:

  qps_ratio   one connection's sequential sync 4 B calls a second over
              a raw two-process TCP ping-pong's
  mb_eff      a pooled channel's 1 MiB echo GB/s (8 in flight) over a
              raw boundary-less two-process stream echo's
  shard_scaling  PyEcho qps of a shard group over one process's, at
              the same multi-process client load (4 cores or more),
              driven in turns: one, group, group, one

Prints one JSON line; the floors are the gate's.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

_RAW_PING_SRC = r"""
import socket
s = socket.socket(); s.bind(("127.0.0.1", 0)); s.listen(1)
print(f"PORT {s.getsockname()[1]}", flush=True)
c, _ = s.accept()
c.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
while True:
    d = c.recv(4096)
    if not d: break
    c.sendall(d)
"""

_RAW_ECHO_SRC = r"""
import socket
s = socket.socket(); s.bind(("127.0.0.1", 0)); s.listen(1)
print(f"PORT {s.getsockname()[1]}", flush=True)
c, _ = s.accept()
c.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
buf = bytearray(1 << 20); mv = memoryview(buf)
while True:
    n = c.recv_into(mv)
    if not n: break
    c.sendall(mv[:n])
"""


def _raw_peer(src: str):
    proc = subprocess.Popen([sys.executable, "-c", src],
                            stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL)
    port = int(proc.stdout.readline().split()[1])
    return proc, port


def measure_raw_ping(n: int = 600) -> float:
    """Raw two-process loopback ping-pong qps: the host's floor for a
    sync call (two syscalls and a cross-process wake each way)."""
    import socket as pysock
    proc, port = _raw_peer(_RAW_PING_SRC)
    try:
        c = pysock.create_connection(("127.0.0.1", port))
        c.setsockopt(pysock.IPPROTO_TCP, pysock.TCP_NODELAY, 1)
        c.settimeout(10.0)
        for _ in range(50):
            c.sendall(b"warm")
            c.recv(4096)
        t0 = time.perf_counter()
        for _ in range(n):
            c.sendall(b"ping")
            c.recv(4096)
        dt = time.perf_counter() - t0
        c.close()
        return n / dt
    finally:
        proc.terminate()
        proc.wait(5)


def measure_raw_loopback(window_s: float = 1.5) -> float:
    """A bare two-process socket echo of 1 MiB writes (the reference's
    ``bench.measure_raw_loopback``): echoed bytes x2 over the wall, in
    GB/s, or 0.0 on any failure."""
    import socket as pysock
    proc = c = None
    gbps = 0.0
    try:
        proc, port = _raw_peer(_RAW_ECHO_SRC)
        c = pysock.create_connection(("127.0.0.1", port))
        c.setsockopt(pysock.IPPROTO_TCP, pysock.TCP_NODELAY, 1)
        # a dead child would leave sendall blocked on full buffers
        c.settimeout(window_s + 5.0)
        payload = b"r" * (1 << 20)
        got = [0]
        stop = [False]

        def drain():
            mv = memoryview(bytearray(1 << 20))
            try:
                while not stop[0]:
                    n = c.recv_into(mv)
                    if not n:
                        return
                    got[0] += n
            except OSError:
                return      # the socket closed under it: done

        th = threading.Thread(target=drain, daemon=True)
        th.start()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < window_s:
            c.sendall(payload)
        dt = time.perf_counter() - t0
        stop[0] = True
        gbps = got[0] * 2 / dt / 1e9
    except Exception:
        pass
    finally:
        if c is not None:
            c.close()
        if proc is not None:
            proc.terminate()
            proc.wait(5)
    return gbps


def _shard_scaling(out: dict, port: int) -> None:
    """Shard group qps over one process's on PyEcho, at equal load from
    client processes (the interpreter lock binds clients too). The two
    are driven in turns, one, group, group, one, and their sums
    compared: the reference drives each once, and one window of a
    shared host's drift then reads as the ratio."""
    from brpc_tpu_torch.tools.qps_client import drive_multiproc
    from brpc_tpu_torch.tools.smoke_util import stop_all
    from brpc_tpu_torch.tools.spawn_util import (package_root,
                                                 spawn_announcing_server)
    cores = os.cpu_count() or 1
    if cores < 4:
        out["shard_skipped"] = f"only {cores} cores"
        return
    nsh = max(2, min(4, cores // 3))
    nclients = nsh + 2
    sproc, got = spawn_announcing_server(
        ["-m", "brpc_tpu_torch.tools.shard_server", "--shards", str(nsh)],
        wall_s=60.0, keys=("ADMIN", "PORT"), cwd=package_root())
    if got is None:
        out["shard_error"] = "shard server spawn failed"
        return
    try:
        runs = {"single": [], "sharded": []}
        for key in ("single", "sharded", "sharded", "single"):
            runs[key].append(drive_multiproc(
                port if key == "single" else got["PORT"],
                nprocs=nclients, seconds=1.3, conns=2, inflight=8,
                method="PyEcho"))
        single = sum(r["qps"] for r in runs["single"])
        sharded = sum(r["qps"] for r in runs["sharded"])
        out["qps_single_mp"] = round(single / 2, 1)
        out["qps_sharded_4B"] = round(sharded / 2, 1)
        out["shard_count"] = nsh
        out["shard_client_failures"] = sum(r["failures"]
                                           for r in runs["sharded"])
        if single:
            out["shard_scaling"] = round(sharded / single, 2)
    finally:
        stop_all([sproc])


def main() -> int:
    from brpc_tpu_torch.tools.smoke_util import stop_all
    from brpc_tpu_torch.tools.spawn_util import (package_root,
                                                 spawn_port_server)

    out: dict = {}
    out["raw_ping_qps"] = round(measure_raw_ping(), 1)
    out["raw_stream_GBps"] = round(measure_raw_loopback(1.5), 3)

    proc, port = spawn_port_server(
        ["-m", "brpc_tpu_torch.tools.bench_echo_server"], wall_s=30.0,
        cwd=package_root())
    if port is None:
        print(json.dumps({"error": "echo server spawn failed"}))
        return 1
    try:
        from brpc_tpu_torch.rpc import Channel, ChannelOptions, Controller
        from brpc_tpu_torch.tools.pipeline_runner import run_pipelined

        ch = Channel(f"tcp://127.0.0.1:{port}",
                     ChannelOptions(timeout_ms=5000))
        for _ in range(100):
            ch.call_sync("Bench", "Echo", b"w")
        n = 800
        t0 = time.perf_counter()
        for _ in range(n):
            ch.call_sync("Bench", "Echo", b"p")
        out["rpc_1c_qps"] = round(n / (time.perf_counter() - t0), 1)
        ch.close()

        pooled = Channel(f"tcp://127.0.0.1:{port}",
                         ChannelOptions(timeout_ms=60000,
                                        connection_type="pooled"))
        payload = b"\xa5" * (1 << 20)
        expect = len(payload)

        def issue(on_done):
            cntl = Controller()
            cntl.request_attachment.append(payload)

            def _done(c):
                if c.failed():
                    on_done(RuntimeError(c.error_text))
                elif c.response_attachment.size != expect:
                    on_done(RuntimeError("size mismatch"))
                else:
                    on_done(None)

            pooled.call("Bench", "Echo", b"", cntl=cntl, done=_done)

        run_pipelined(24, 8, issue, 30.0)           # warm the pool
        best = 0.0
        for _ in range(2):
            k = 60
            dt = run_pipelined(k, 8, issue, 30.0)
            best = max(best, k * (1 << 20) * 2 / dt / 1e9)
        out["mb_echo_GBps"] = round(best, 3)
        pooled.close()
        _shard_scaling(out, port)
    finally:
        stop_all([proc])
    if out["raw_ping_qps"]:
        out["qps_ratio"] = round(out["rpc_1c_qps"] / out["raw_ping_qps"], 3)
    if out["raw_stream_GBps"]:
        out["mb_eff"] = round(out["mb_echo_GBps"] / out["raw_stream_GBps"],
                              3)
    print(json.dumps(out))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    rc = main()
    # skip the runtime threads' teardown
    os._exit(rc)
