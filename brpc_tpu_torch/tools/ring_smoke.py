"""The ring lane's gate (the port of tools/ring_smoke.py, its
``--smoke`` mode; the gate ``ring_lane`` of ``tools.preflight --gate``)::

    python3 -m brpc_tpu_torch.tools.ring_smoke --smoke
    python3 -m brpc_tpu_torch.tools.ring_smoke --lane ring|selector --parity

The ``event_ring_lane`` flag is read once, when a process's dispatcher
is built, so each lane runs in a child of its own and this process
compares their JSON reports.

``--smoke``: the native core's probe (the auto backend, and the forced
uring backend's verdict: on a kernel without io_uring it must raise
ENOSYS, EPERM or ENOMEM and the auto backend be ``batch``), the ring
dispatcher's bring-up in a lane child, and byte-for-byte echo parity
between ring and selector. Exit 0/1.

``--lane L --parity``: a seeded framed-echo corpus (sync calls of
growing sizes, then pipelined calls folded in issue order) over lane
``L``; the sha256 of every response byte.

The reference's ``--burst`` and ``--burst-pair`` are phase ``ring`` (c)
of ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import threading

PARITY_CALLS = 96
PARITY_PIPELINED = 128


def _set_lane_env(lane: str) -> None:
    os.environ["BRPC_TPU_FLAG_EVENT_RING_LANE"] = \
        "1" if lane == "ring" else "0"


def _make_server():
    from brpc_tpu_torch.rpc import Server, ServerOptions, Service
    svc = Service("Bench")

    @svc.method()
    def PyEcho(cntl, request):
        return bytes(request)

    @svc.method()
    def Scramble(cntl, request):
        # parity corpus: a response the wire cannot produce by luck —
        # length-stamped reversed payload
        b = bytes(request)
        return len(b).to_bytes(4, "big") + b[::-1]

    server = Server(ServerOptions(enable_builtin_services=False))
    server.add_service(svc)
    server.start("tcp://127.0.0.1:0")
    return server


def _lane_report_base():
    from brpc_tpu_torch.transport.event_dispatcher import global_dispatcher
    d = global_dispatcher()
    return {
        "dispatcher": type(d).__name__,
        "backend": getattr(d, "backend", "selector"),
    }


def run_parity(lane: str) -> dict:
    """Deterministic corpus -> digest of every response byte. Sizes
    cross the small-frame/turbo thresholds and the ring's short-read
    heuristic; the pipelined phase exercises completion-batch ordering
    (digest folds responses in issue order, which both lanes must
    preserve per call id)."""
    _set_lane_env(lane)
    from brpc_tpu_torch.rpc import Channel, ChannelOptions

    server = _make_server()
    port = server.endpoint.port
    h = hashlib.sha256()
    ch = Channel(f"tcp://127.0.0.1:{port}",
                 ChannelOptions(timeout_ms=10000,
                                share_connections=False))
    # sequential phase: exact request/response pairing, growing and
    # boundary-straddling sizes
    sizes = [0, 1, 3, 16, 255, 1024, 4096, 65536, 262144]
    for i in range(PARITY_CALLS):
        sz = sizes[i % len(sizes)]
        req = bytes((i + j) % 256 for j in range(min(sz, 512))) * \
            (1 if sz <= 512 else sz // 512)
        req = req[:sz]
        cntl = ch.call_sync("Bench", "Scramble", req)
        if cntl.failed():
            raise RuntimeError(f"parity call {i} failed: "
                               f"{cntl.error_text}")
        resp = cntl.response or b""
        expect = len(req).to_bytes(4, "big") + req[::-1]
        if resp != expect:
            raise RuntimeError(f"parity mismatch at call {i} "
                               f"(size {sz})")
        h.update(resp)
    # pipelined phase: responses may COMPLETE out of order; fold in
    # issue order from a slot table
    slots = [None] * PARITY_PIPELINED
    done_evt = threading.Event()
    left = [PARITY_PIPELINED]
    lock = threading.Lock()

    def issue(i):
        req = (b"%06d" % i) * (1 + i % 17)

        def _done(c, idx=i, expect=req):
            if c.failed():
                slots[idx] = b"FAILED:" + c.error_text.encode()
            else:
                slots[idx] = c.response or b""
            with lock:
                left[0] -= 1
                if left[0] == 0:
                    done_evt.set()

        ch.call("Bench", "PyEcho", req, done=_done)

    for i in range(PARITY_PIPELINED):
        issue(i)
    if not done_evt.wait(60):
        raise RuntimeError("parity pipelined phase hung")
    for i, resp in enumerate(slots):
        expect = (b"%06d" % i) * (1 + i % 17)
        if resp != expect:
            raise RuntimeError(f"pipelined parity mismatch at {i}")
        h.update(resp)
    out = {"lane": lane, **_lane_report_base(),
           "calls": PARITY_CALLS + PARITY_PIPELINED,
           "digest": h.hexdigest()}
    ch.close()
    server.stop()
    return out


def _child(lane: str, mode: str, timeout: int = 300) -> dict:
    from brpc_tpu_torch.tools.spawn_util import package_root
    proc = subprocess.run(
        [sys.executable, "-m", "brpc_tpu_torch.tools.ring_smoke",
         "--lane", lane, mode],
        cwd=package_root(), capture_output=True, text=True,
        timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(
            f"{lane} {mode} child failed: "
            f"{(proc.stdout + proc.stderr)[-500:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def run_smoke() -> dict:
    """gate_ring_lane: probe + fallback proof + bring-up + parity."""
    _set_lane_env("selector")          # this process stays off-ring
    report: dict = {"ok": True}
    from brpc_tpu_torch.native import fastcore
    fc = fastcore.get()
    if fc is None or not hasattr(fc, "Ring"):
        report["ok"] = False
        report["error"] = "fastcore extension lacks Ring"
        return report
    r = fc.Ring()
    report["auto_backend"] = r.backend_name()
    r.close()
    # forced-uring verdict: on kernels without usable io_uring the
    # constructor must surface ENOSYS/EPERM (never silently serve the
    # batch loop as "uring"); where io_uring exists, auto already
    # picked it
    try:
        r2 = fc.Ring(2)
        report["forced_uring"] = r2.backend_name()
        r2.close()
        report["uring_native"] = True
    except OSError as e:
        import errno as _errno
        report["forced_uring_errno"] = e.errno
        report["uring_native"] = False
        if e.errno not in (_errno.ENOSYS, _errno.EPERM, _errno.ENOMEM):
            report["ok"] = False
            report["error"] = f"unexpected probe errno {e.errno}"
            return report
        if report["auto_backend"] != "batch":
            report["ok"] = False
            report["error"] = ("auto backend must fall back to batch "
                               "when the uring probe fails")
            return report
        report["enosys_fallback_proven"] = True
    # lane bring-up + byte-for-byte parity across lanes
    try:
        ring = _child("ring", "--parity", timeout=180)
        selector = _child("selector", "--parity", timeout=180)
    except (RuntimeError, subprocess.TimeoutExpired, ValueError) as e:
        report["ok"] = False
        report["error"] = f"parity child: {e}"[:500]
        return report
    report["ring_dispatcher"] = ring["dispatcher"]
    report["ring_backend"] = ring["backend"]
    report["parity_calls"] = ring["calls"]
    if ring["dispatcher"] != "RingDispatcher":
        report["ok"] = False
        report["error"] = "event_ring_lane flag did not select the " \
                          "ring dispatcher"
    elif ring["digest"] != selector["digest"]:
        report["ok"] = False
        report["error"] = "response digests diverge between lanes"
    else:
        report["parity"] = "byte-for-byte"
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--lane", choices=("ring", "selector"))
    p.add_argument("--parity", action="store_true")
    p.add_argument("--smoke", action="store_true")
    args = p.parse_args(argv)
    if args.parity:
        if not args.lane:
            p.error("--parity needs --lane")
        print(json.dumps(run_parity(args.lane)))
        return 0
    if args.smoke:
        out = run_smoke()
        print(json.dumps(out, indent=2))
        return 0 if out["ok"] else 1
    p.error("pick a mode")
    return 2


if __name__ == "__main__":
    rc = main()
    sys.stdout.flush()
    os._exit(rc)    # skip the runtime threads' teardown
