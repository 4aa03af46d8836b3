"""The device observatory's smoke (the port of
tools/device_obs_smoke.py; the gate ``device_obs`` of ``tools.preflight
--gate``)::

    python3 -m brpc_tpu_torch.tools.device_obs_smoke [--device cpu]

One process, an ``ici://`` loopback on ``--device`` (``cuda:0`` unless
given; the lane is local-d2d, tensors by reference):

  1. a burst of device echoes under rpcz gives device spans whose
     stage/wire/ack stamps account for at least 90% of each transfer's
     wall (``ici_stage_attribution_pct``), with device-recv child spans,
     each a child of its RPC span;
  2. every (peer, lane) cell balances on a live connection: transfers
     == completed + failed, and ``bytes_out`` is the transfers times
     the payload;
  3. the ``/device`` views agree: the in-process payload, the HTTP
     page of a tcp:// admin server in the same process, and the
     supervisor's merge;
  4. the cells cost at most 5%: two child processes run the same
     loopback at the same time, each timing pipelined windows by their
     per-call median and switching the cells (``device_stats_enabled``)
     window by window in opposite phase, so that one runs with them
     while the other runs without; the median, over each child's
     adjacent windows, of the on window's excess over the off one's,
     with up to two more rounds while it is over the bound, as the
     reference's (which alternates the flag in one process, window
     against window, and so reads the host's drift).
     ``BRPC_TPU_TORCH_PERF_SMOKE=0`` skips this criterion only.

One JSON line; exit 0 iff every criterion held.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import List

ATTRIBUTION_MIN_PCT = 90.0
PAYLOAD_BYTES = 64 << 10
COST_WINDOWS = 12
COST_CALLS = 256


def _make_server(addr: str, builtin: bool = False):
    from brpc_tpu_torch.rpc import Server, ServerOptions, Service
    server = Server(ServerOptions(enable_builtin_services=builtin))
    svc = Service("DevObs")

    @svc.method()
    def EchoDevice(cntl, request):
        cntl.response_device_arrays = list(cntl.request_device_arrays)
        return b"dev"

    server.add_service(svc)
    ep = server.start(addr)
    return server, ep


def _lane(device):
    """An ``ici://`` loopback server and a channel to it, and the
    payload: (server, channel, tensor)."""
    import torch

    from brpc_tpu_torch.rpc import Channel, ChannelOptions
    from brpc_tpu_torch.tools.smoke_util import lane_device
    dev, spec = lane_device(device)
    server, ep = _make_server(f"ici://127.0.0.1:0#device={spec}")
    # a generous deadline: the pipelined windows queue calls well past
    # the default on a loaded host
    ch = Channel(f"ici://127.0.0.1:{ep.port}#device={spec}",
                 ChannelOptions(timeout_ms=30000))
    arr = torch.ones(PAYLOAD_BYTES // 4, dtype=torch.float32, device=dev)
    return server, ch, arr


def _burst(ch, arr, calls: int) -> None:
    # a fresh tensor each call, as the reference stages a fresh copy:
    # the recv pool's budget comes back when a received tensor dies, and
    # on the by-reference lane one tensor sent N times would hold N
    # reservations of the pool (its admission control) for good
    for i in range(calls):
        cntl = ch.call_sync("DevObs", "EchoDevice", b"",
                            request_device_arrays=[arr.clone()])
        if cntl.failed():
            raise RuntimeError(f"call {i} failed: {cntl.error_text}")


def _pipelined_window(ch, arr, iters: int) -> float:
    """A pipelined device-echo window: its median per-call latency (s).
    The median shrugs off the few calls an allocator or gc pause lands
    on, which a wall-clock window swallows whole."""
    from brpc_tpu_torch.tools.pipeline_runner import run_pipelined

    lat: List[float] = []

    def issue(on_done):
        t0 = time.perf_counter_ns()

        def _done(cntl):
            lat.append(time.perf_counter_ns() - t0)
            on_done(RuntimeError(cntl.error_text) if cntl.failed()
                    else None)
        ch.call("DevObs", "EchoDevice", b"", done=_done,
                request_device_arrays=[arr.clone()])

    run_pipelined(iters, 8, issue, 60.0)
    lat.sort()
    return lat[len(lat) // 2] / 1e9


def cost_child(device, first_on: bool) -> int:
    """One side of the cost check (``smoke_util.cost_child_windows``):
    the loopback warmed, then windows with the cells on and off in
    turns, each a window's median per-call latency."""
    from brpc_tpu_torch.butil.flags import set_flag
    from brpc_tpu_torch.tools.smoke_util import cost_child_windows
    server, ch, arr = _lane(device)
    try:
        _burst(ch, arr, 2)
        _pipelined_window(ch, arr, 64)                  # warm
        cost_child_windows(
            first_on, COST_WINDOWS,
            lambda on: set_flag("device_stats_enabled", on),
            lambda: _pipelined_window(ch, arr, COST_CALLS))
    finally:
        ch.close()
        server.stop()
        server.join(2)
    return 0


def run_smoke(out: dict, device=None) -> None:
    from brpc_tpu_torch.butil.flags import set_flag
    from brpc_tpu_torch.rpc.span import global_collector
    from brpc_tpu_torch.tools.smoke_util import (OVERHEAD_PCT_MAX,
                                                 paired_children_cost,
                                                 perf_off)
    from brpc_tpu_torch.tools.spawn_util import http_get_local
    from brpc_tpu_torch.transport import device_stats as ds

    problems: List[str] = []
    set_flag("device_stats_enabled", True)
    server, ch, arr = _lane(device)
    admin, admin_ep = _make_server("tcp://127.0.0.1:0", builtin=True)
    nbytes = arr.numel() * arr.element_size()
    calls = 16

    # ---- 1. stage-resolved spans under rpcz
    _burst(ch, arr, 2)                                  # warm the lane
    set_flag("rpcz_enabled", True)
    global_collector.clear()
    _burst(ch, arr, calls)
    set_flag("rpcz_enabled", False)
    spans = global_collector.recent(600)
    sends = [s.to_dict() for s in spans
             if s.side == "device" and (s.write_done_us or s.first_byte_us)]
    recvs = [s for s in spans
             if s.side == "device" and not (s.write_done_us
                                            or s.first_byte_us)]
    out["device_spans"] = len(sends)
    out["device_recv_spans"] = len(recvs)
    if len(sends) < calls:
        problems.append(f"only {len(sends)} device send spans for "
                        f"{calls} calls")
    if not recvs:
        problems.append("no device-recv child spans")
    ratios = [(d["stage_us"] + d["wire_us"] + d["ack_us"])
              / d["latency_us"] for d in sends if d["latency_us"] > 0]
    att = round(100.0 * sum(ratios) / len(ratios), 1) if ratios else 0.0
    out["ici_stage_attribution_pct"] = att
    if att < ATTRIBUTION_MIN_PCT:
        problems.append(f"stage attribution {att}% < "
                        f"{ATTRIBUTION_MIN_PCT}%")
    orphans = [d for d in sends if d["parent_span_id"] == f"{0:016x}"]
    if orphans:
        problems.append(f"{len(orphans)} device spans with no parent "
                        "RPC span (trace inheritance broken)")

    # ---- 2. cells balance on a live connection: the idle ACK settles
    # a quiet lane by itself (a close first would hide a broken one)
    deadline = time.monotonic() + 5.0
    while True:
        page = ds.device_page_payload()
        bad = [k for k, row in page["cells"].items()
               if row["transfers"] != row["completed"] + row["failed"]]
        if not bad or time.monotonic() >= deadline:
            break
        time.sleep(0.05)
    totals = page["totals"]
    out["cells"] = {k: {kk: v[kk] for kk in
                        ("transfers", "completed", "failed", "bytes_out")}
                    for k, v in page["cells"].items()}
    if bad:
        problems.append(f"cells out of balance without close: {bad}")
    ch.close()
    for k, row in page["cells"].items():
        if row["bytes_out"] != row["transfers"] * nbytes:
            problems.append(
                f"cell {k}: bytes_out {row['bytes_out']} != "
                f"{row['transfers']} transfers x {nbytes}B")

    # ---- 3. the three /device views agree
    status, body = http_get_local(admin_ep.port, "/device")
    if status != 200:
        problems.append(f"/device HTTP {status}")
    elif json.loads(body).get("totals") != totals:
        problems.append("/device HTTP totals != in-process totals")
    if ds.merge_device_payloads([page])["totals"] != totals:
        problems.append("supervisor merge totals != in-process totals")
    out["transfer_lane"] = page.get("transfer_lane")
    server.stop()
    server.join(2)
    admin.stop()
    admin.join(2)

    # ---- 4. the cells' cost, on and off side by side
    if not perf_off():
        got = paired_children_cost("brpc_tpu_torch.tools.device_obs_smoke",
                                   device)
        cost = {"on_ms": round(got["on"] * 1e3, 4),
                "off_ms": round(got["off"] * 1e3, 4),
                "windows": got["windows"], "rounds": got["rounds"],
                "overhead_pct": got["overhead_pct"]}
        out["device_stats_overhead_pct"] = cost["overhead_pct"]
        out["cost"] = cost
        if cost["overhead_pct"] > OVERHEAD_PCT_MAX:
            problems.append(f"device_stats overhead "
                            f"{cost['overhead_pct']}% > "
                            f"{OVERHEAD_PCT_MAX}%")
    else:
        out["overhead_skipped"] = "BRPC_TPU_TORCH_PERF_SMOKE=0"
    out["problems"] = problems
    out["ok"] = not problems


def main() -> int:
    import argparse
    import faulthandler
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="the lane's device: cuda:0 unless given")
    ap.add_argument("--cost-child", choices=("on", "off"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.cost_child:
        return cost_child(args.device, args.cost_child == "on")
    # a wedged lane leaves stacks, not a silent gate timeout
    faulthandler.dump_traceback_later(280, exit=True)
    out: dict = {"ok": False}
    t0 = time.monotonic()
    try:
        run_smoke(out, args.device)
    except BaseException as e:  # noqa: BLE001 - one JSON line always
        out["error"] = f"{type(e).__name__}: {e}"[:500]
    out["elapsed_s"] = round(time.monotonic() - t0, 1)
    print(json.dumps(out, default=str), flush=True)
    return 0 if out.get("ok") else 1


if __name__ == "__main__":
    rc = main()
    sys.stdout.flush()
    os._exit(rc)    # skip the runtime threads' teardown
