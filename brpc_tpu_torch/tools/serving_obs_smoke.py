"""The serving flight deck's smoke (the port of
tools/serving_obs_smoke.py; the gate ``serving_obs`` of
``tools.preflight --gate``)::

    python3 -m brpc_tpu_torch.tools.serving_obs_smoke [--device cpu]

One process, a tcp:// loopback GenerateService whose engine is the
port's TinyDecoder on ``--device`` (``cuda:0`` unless given):

  1. a burst of mixed lengths under rpcz gives serving spans whose
     queue/prefill/decode/emit stages account for at least 90% of each
     generation's latency (the stages telescope, so less means a
     missing stamp);
  2. every serving span is a child of its RPC span;
  3. the in-process ``/serving`` pane, the HTTP page and the
     supervisor's merge over one pane agree on the per-method counters,
     and the step ring holds the burst;
  4. the flight deck costs at most 5% of a step: a full batch stepped
     directly on an engine of dim 128 and 512-token slots (the cost is
     fixed a step; RPC round trips drift more than it costs), each
     window's median step latency, in two children at once that switch
     the deck on and off window by window in opposite phase, the median
     excess of an on window over its neighbour, with up to two more
     rounds while over the bound
     (``smoke_util.paired_children_cost``; the reference alternates
     windows in one process, which on the card read the host's drift:
     20% once for a cost of 0-3%).
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
COST_WINDOWS = 24
METHOD_KEY = "GenerateService.Generate"
# counter keys the three /serving views must agree on exactly
# (rates and reservoir re-exports are time- or shape-variant by design)
_TWIN_KEYS = ("requests", "admitted", "completed", "evicted", "shed",
              "canceled", "rejected", "tokens_out")


def _gen(ch, prompt: str, max_tokens: int):
    cntl = ch.call_sync(
        "GenerateService", "Generate",
        json.dumps({"prompt": prompt,
                    "max_tokens": max_tokens}).encode())
    if cntl.failed():
        raise RuntimeError(f"generate failed: {cntl.error_text}")
    return cntl


def _step_window(batcher, open_gen, ntok: int = 48,
                 nreq: int = 8) -> float:
    """Drive one full-batch generation wave by stepping the batcher
    DIRECTLY -> MEDIAN per-step latency (us). Direct stepping on
    purpose: the flight deck's cost is per-iteration, and an RPC
    round-trip on a loaded host drifts 10-50% of pure scheduling
    noise per window (measured) — far above the cost being gated. The
    per-step median over ~50 steps shrugs off the few steps a gc
    pause or allocator stall lands on."""
    from brpc_tpu_torch.serving.batcher import GenRequest
    done: List[str] = []
    for _ in range(nreq):
        r = GenRequest(list(b"obs!"), ntok,
                       on_finish=lambda r_, s_: done.append(s_))
        r.tracker = open_gen("ServingObs", "Generate", None)
        if not batcher.submit(r):
            raise RuntimeError("overhead window request not admitted")
    steps: List[int] = []
    while len(done) < nreq:
        t0 = time.perf_counter_ns()
        batcher.step(0)
        steps.append(time.perf_counter_ns() - t0)
    steps.sort()
    return steps[len(steps) // 2] / 1e3


def cost_child(device, first_on: bool) -> int:
    """One side of the flight deck's cost check
    (``smoke_util.cost_child_windows``): a private batcher with a decode
    step of realistic size (dim 128, 512-token slots, 8 a batch: the
    deck's cost is fixed a step, so the toy step would overstate it),
    rpcz off, warmed; then windows with the deck on and off in turns,
    each a full-batch wave's median step latency (us)."""
    from brpc_tpu_torch.butil.flags import set_flag
    from brpc_tpu_torch.serving import serving_stats as ss
    from brpc_tpu_torch.serving.batcher import ContinuousBatcher
    from brpc_tpu_torch.serving.model import TinyDecoder, TinyDecoderConfig
    from brpc_tpu_torch.tools.smoke_util import cost_child_windows
    import torch
    from brpc_tpu_torch.butil.device import resolve_device
    if resolve_device(device).type == "cpu":
        # two children at once: half the cores each, not all of them each
        torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    model = TinyDecoder(TinyDecoderConfig(dim=128, cache_len=512, seed=7),
                        device=device)
    ob = ContinuousBatcher(model, max_batch=8, max_waiting=16)
    _step_window(ob, ss.open_generation, ntok=8)        # warm-up
    cost_child_windows(
        first_on, COST_WINDOWS,
        lambda on: set_flag("serving_stats_enabled", on),
        lambda: _step_window(ob, ss.open_generation))
    return 0


def run_smoke(out: dict, device=None) -> None:
    from brpc_tpu_torch.butil.flags import set_flag
    from brpc_tpu_torch.rpc import Channel, ChannelOptions, Server, \
        ServerOptions
    from brpc_tpu_torch.rpc.span import global_collector
    from brpc_tpu_torch.serving import add_generate_service
    from brpc_tpu_torch.serving import serving_stats as ss
    from brpc_tpu_torch.serving.service import serving_page_payload
    from brpc_tpu_torch.tools.smoke_util import (OVERHEAD_PCT_MAX,
                                                 paired_children_cost,
                                                 perf_off)
    from brpc_tpu_torch.tools.spawn_util import http_get_local

    problems: List[str] = []
    set_flag("serving_stats_enabled", True)
    server = Server(ServerOptions(enable_builtin_services=True))
    add_generate_service(server, max_batch=4, max_waiting=16,
                         cache_len=128, device=device)
    ep = server.start("tcp://127.0.0.1:0")
    ch = Channel(f"tcp://127.0.0.1:{ep.port}",
                 ChannelOptions(timeout_ms=30000))
    _gen(ch, "warm", 2)                               # warm-up

    # ---- 1 + 2. stage-resolved serving spans under rpcz
    lengths = (4, 24, 8, 48, 12, 4, 32, 16, 8, 24, 4, 40)
    set_flag("rpcz_enabled", True)
    global_collector.clear()
    for i, n in enumerate(lengths):
        _gen(ch, f"burst-{i}", n)
    set_flag("rpcz_enabled", False)
    spans = [s.to_dict() for s in global_collector.recent(600)
             if s.side == "serving"]
    out["serving_spans"] = len(spans)
    if len(spans) < len(lengths):
        problems.append(f"only {len(spans)} serving spans for "
                        f"{len(lengths)} generations")
    ratios = [(d["queue_us"] + d["prefill_us"] + d["decode_us"]
               + d["emit_us"]) / d["latency_us"]
              for d in spans if d["latency_us"] > 0]
    att = round(100.0 * sum(ratios) / len(ratios), 1) if ratios else 0.0
    out["serving_stage_attribution_pct"] = att
    if att < ATTRIBUTION_MIN_PCT:
        problems.append(f"stage attribution {att}% < "
                        f"{ATTRIBUTION_MIN_PCT}%")
    orphans = [d for d in spans
               if d["parent_span_id"] == f"{0:016x}"]
    if orphans:
        problems.append(f"{len(orphans)} serving spans with no parent "
                        "RPC span (trace inheritance broken)")

    # ---- 3. the three /serving views agree on the counters
    page = serving_page_payload(server)
    row = (page.get("stats", {}).get("methods") or {}).get(METHOD_KEY)
    if row is None:
        problems.append(f"no {METHOD_KEY} cell in the in-process pane")
        row = {}
    if row and (row.get("completed", 0) < len(lengths)
                or row.get("tokens_out", 0) <= 0):
        problems.append(f"cell undercounts the burst: {row}")
    status, body = http_get_local(ep.port, "/serving")
    if status != 200:
        problems.append(f"/serving HTTP {status}")
    else:
        hrow = (json.loads(body).get("stats", {}).get("methods")
                or {}).get(METHOD_KEY) or {}
        if any(hrow.get(k) != row.get(k) for k in _TWIN_KEYS):
            problems.append(
                "HTTP /serving counters != in-process pane: "
                f"{ {k: (row.get(k), hrow.get(k)) for k in _TWIN_KEYS} }")
    mrow = (ss.merge_serving_panes([page["stats"]])["methods"]
            or {}).get(METHOD_KEY) or {}
    if any(mrow.get(k) != row.get(k) for k in _TWIN_KEYS):
        problems.append("single-pane supervisor merge != in-process "
                        f"pane: { {k: (row.get(k), mrow.get(k)) for k in _TWIN_KEYS} }")
    if not page.get("stats", {}).get("steps"):
        problems.append("step ring empty after the burst")

    # ---- 4. overhead: flight deck on vs off (rpcz off — the deck's
    # own cost, not the span collector's), on a private batcher with a
    # REALISTICALLY sized decode step (dim=128, cache 512, batch 8 —
    # ~1.5ms/step; the deck's cost is per-iteration-fixed, so gating
    # it against the microscopic default toy step would quote a 3x
    # pessimistic ratio no real model sees). PAIR-WISE estimator, arm
    # order alternating, MEDIAN over pairs, cumulative retry rounds —
    # the device-observatory gate's discipline.
    if not perf_off():
        got = paired_children_cost(
            "brpc_tpu_torch.tools.serving_obs_smoke", device)
        overhead = got["overhead_pct"]
        out["serving_stats_overhead_pct"] = overhead
        out["cost"] = {"on_us": round(got["on"], 1),
                       "off_us": round(got["off"], 1),
                       "windows": got["windows"],
                       "rounds": got["rounds"]}
        if overhead > OVERHEAD_PCT_MAX:
            problems.append(f"serving_stats overhead {overhead}% > "
                            f"{OVERHEAD_PCT_MAX}%")
    else:
        out["overhead_skipped"] = "BRPC_TPU_TORCH_PERF_SMOKE=0"

    ch.close()
    server.stop()
    server.join(2)
    out["problems"] = problems
    out["ok"] = not problems


def main() -> int:
    import argparse
    import faulthandler
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="the engine's device: cuda:0 unless given")
    ap.add_argument("--cost-child", choices=("on", "off"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.cost_child:
        return cost_child(args.device, args.cost_child == "on")
    # a wedged engine must leave stacks, not a silent gate timeout
    faulthandler.dump_traceback_later(150, exit=True)
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
    sys.exit(main())
