"""Deterministic local reproduction of a frozen incident (the port of
brpc_tpu/incident/replay.py).

The replay half of the incident time machine: take a ``.brpcinc``
artifact, derive the *pressure* that plausibly caused it from the
incident's error classes and trigger keys, re-apply that pressure to a
fresh loopback server replaying the captured corpus, and assert the
anomaly watchdog re-fires on the same key. The fix-forward run — the
same replay WITHOUT the derived pressure — must stay green; together
the pair is a regression test distilled from production evidence.

Derivation map:

  ERPCTIMEDOUT / *deadline_shed / *queue_delay keys
      → chaos ``delay``/``partial_stall`` byte faults on the request
        path (seeded FaultPlan)
  EFAILEDSOCKET / ECLOSE (connect errors)
      → chaos ``refuse``/``flap`` connection faults
  EOVERCROWDED / ELIMIT / EPRIORITYSHED / *limit_shed /
  *overcrowded keys
      → PRESS overload: open-loop pacing at a multiple of the
        server's estimated capacity (no byte fault can make a server
        shed; offered load does)

The press/calm pacing derives from ONE estimate — the corpus's median
recorded service latency — so the faulted run offers
``press_factor``× the server's capacity and the fix-forward run
offers ``calm_factor``× (deterministically under it). The fresh
server replicates the incident server's shape from the artifact's
/status snapshot (concurrency limit), so "re-fires on the same key"
is a statement about the same overload organ, not a lucky race.

This is offline tool code (``brpc_tpu_torch.tools.incident_replay``,
``chip_smoke.py``, the tests), never the sampler or the dispatch path.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

from brpc_tpu_torch.chaos.plan import Fault, FaultPlan
from brpc_tpu_torch.incident.artifact import read_artifact
from brpc_tpu_torch.rpc import errno_codes as berr
from brpc_tpu_torch.traffic.corpus import CapturedRequest
from brpc_tpu_torch.traffic.replay import PaceSpec, run_open_loop

_TIMEOUT_CLASSES = {berr.ERPCTIMEDOUT}
_CONNECT_CLASSES = {berr.EFAILEDSOCKET, berr.ECLOSE}
_PRESS_CLASSES = {berr.EOVERCROWDED, berr.ELIMIT, berr.EPRIORITYSHED}
_MIN_PRESS_RECORDS = 64


def _class_codes(meta: dict) -> set:
    """The incident document's error classes as integer codes (the
    document stores errno NAMES — human-readable in the artifact)."""
    out = set()
    for name in (meta.get("error_classes") or {}):
        code = getattr(berr, name, None)
        if isinstance(code, int):
            out.add(code)
        elif name.startswith("E") and name[1:].isdigit():
            out.add(int(name[1:]))
    return out


def derive_repro(meta: dict, seed: int = 0) -> dict:
    """Classify the pressure an incident implies. Pure function of the
    incident document (error classes + trigger keys) — the endpoint
    addressing happens later, when the fresh server exists."""
    codes = _class_codes(meta)
    keys = [str(k) for k in (meta.get("keys") or ())]
    if meta.get("peak_key"):
        keys.append(str(meta["peak_key"]))
    press = bool(codes & _PRESS_CLASSES) or any(
        "limit_shed" in k or "overcrowded" in k or "priority_shed" in k
        for k in keys)
    timeouts = bool(codes & _TIMEOUT_CLASSES) or any(
        "deadline_shed" in k or "queue_delay" in k for k in keys)
    connect = bool(codes & _CONNECT_CLASSES)
    return {"seed": seed, "press": press, "timeouts": timeouts,
            "connect": connect,
            "classes": sorted(berr.errno_name(c) for c in codes)}


def build_fault_plan(shape: dict, endpoint: str,
                     conns: int = 4) -> Optional[FaultPlan]:
    """The seeded chaos FaultPlan for the byte/connection half of the
    derivation, addressed at the fresh server's endpoint. None when
    the shape needs no transport faults (pure press overload)."""
    plan = FaultPlan(seed=int(shape.get("seed", 0)))
    used = False
    if shape.get("timeouts"):
        # hold every connection's first request bytes long enough to
        # blow a recorded deadline; one connection gets the
        # half-written-frame stall (the worst flavor)
        for idx in range(conns):
            plan.at(endpoint, idx,
                    Fault("delay", at_byte=1, delay_ms=150.0))
        plan.at(endpoint, conns, Fault("partial_stall", at_byte=16))
        used = True
    if shape.get("connect"):
        plan.refuse(endpoint, 0)
        plan.flap(endpoint, at_conn=2, refuse_next=2)
        used = True
    return plan if used else None


def _estimate_work_ms(records: List[CapturedRequest]) -> float:
    """Median recorded service latency of the corpus's OK requests —
    the one number press/calm pacing scales from."""
    lats = sorted(r.latency_us for r in records
                  if not r.status and r.latency_us > 0)
    if not lats:
        return 5.0
    med = lats[len(lats) // 2] / 1000.0
    return max(2.0, min(50.0, med))


def _replayable(records: List[CapturedRequest]) -> List[CapturedRequest]:
    return [r for r in records
            if r.service and r.service != "builtin"
            and not r.service.startswith("__")]


def _tile(records: List[CapturedRequest],
          n: int) -> List[CapturedRequest]:
    """Press mode multiplies a short window corpus up to ``n`` issues:
    overload is a statement about offered RATE, and a dozen records
    cannot offer a rate for long enough to spike a whole tick
    bucket."""
    out = list(records)
    while len(out) < n:
        out.extend(records)
    return out[:max(n, len(records))]


def _run_calm(records: List[CapturedRequest], address: str,
              pace: PaceSpec, default_timeout_ms: float) -> dict:
    """The fix-forward pass: each record on ``pace``'s schedule, but
    issued only once the last one answered (wait, then sleep to the
    next slot), on one private connection. A stall of this process
    that passes a slot delays the next issue instead of stacking two
    calls on a server with ``max_concurrency`` 1. Report keys as
    ``run_open_loop``'s that the replay report reads."""
    from brpc_tpu_torch.rpc import Channel, ChannelOptions
    from brpc_tpu_torch.rpc.controller import Controller
    from brpc_tpu_torch.traffic.replay import _holding

    sched = pace.schedule_s(records)
    per_method: Dict[str, dict] = {}
    ok = fail = 0
    ch = Channel(address, ChannelOptions(share_connections=False,
                                         name="incident_fix_forward"))
    with _holding([ch]):
        # pay the connection's setup with a call no handler counts
        ch.call_sync("__traffic_warm__", "Ping", b"")
        t0 = time.perf_counter()
        for rec, t_s in zip(records, sched):
            wait = t_s - (time.perf_counter() - t0)
            if wait > 0:
                time.sleep(wait)
            cntl = Controller()
            cntl.timeout_ms = (rec.timeout_ms if rec.timeout_ms > 0
                               else default_timeout_ms)
            if rec.priority:
                cntl.request_priority = rec.priority
            if rec.attachment:
                cntl.request_attachment.append(rec.attachment)
            ch.call_sync(rec.service, rec.method, rec.payload, cntl=cntl)
            row = per_method.setdefault(rec.method_key,
                                        {"ok": 0, "fail": 0})
            if cntl.failed():
                fail += 1
                row["fail"] += 1
            else:
                ok += 1
                row["ok"] += 1
        elapsed = time.perf_counter() - t0
    return {"records": len(records), "issued": len(records), "ok": ok,
            "fail": fail, "elapsed_s": round(elapsed, 3),
            "per_method": per_method, "pace": pace.to_dict()}


def replay_incident(artifact_path: str, use_plan: bool = True,
                    seed: int = 7, warmup_ticks: int = 3,
                    press_factor: float = 4.0,
                    calm_factor: float = 0.5,
                    conns: int = 4,
                    server_factory=None) -> dict:
    """One-command reproduction: fresh loopback server shaped from the
    artifact's /status snapshot, corpus replayed under the derived
    pressure (``use_plan=True``) or without it (the fix-forward run),
    watchdog pinned to the incident's trigger keys. Returns a report;
    ``report["refired"]`` is the verdict."""
    from brpc_tpu_torch.butil.flags import flag, set_flag
    from brpc_tpu_torch.bvar.anomaly import global_watchdog
    from brpc_tpu_torch.bvar.series import series_sample_tick
    from brpc_tpu_torch.chaos import inject as chaos_inject
    from brpc_tpu_torch.fiber.timer import sleep as fiber_sleep
    from brpc_tpu_torch.rpc import Server, ServerOptions, Service
    from brpc_tpu_torch.rpc.server_dispatch import expose_shed_vars

    art = read_artifact(artifact_path)
    meta = art["meta"]
    records = _replayable(art["corpus"])
    trigger_keys = [str(k) for k in (meta.get("keys") or ())]
    peak_key = str(meta.get("peak_key") or
                   (trigger_keys[0] if trigger_keys else ""))
    if peak_key and peak_key not in trigger_keys:
        trigger_keys.append(peak_key)
    report: dict = {
        "artifact": artifact_path,
        "incident_id": meta.get("id"),
        "trigger_keys": trigger_keys, "peak_key": peak_key,
        "corpus_records": len(records), "use_plan": use_plan,
        "seed": seed,
    }
    if not records or not trigger_keys:
        report["ok"] = False
        report["error"] = ("artifact has no replayable corpus"
                           if not records
                           else "artifact names no trigger keys")
        report["refired"] = False
        return report

    shape = derive_repro(meta, seed=seed)
    report["derived"] = shape
    work_ms = _estimate_work_ms(records)
    report["work_ms"] = round(work_ms, 2)
    capacity_qps = 1000.0 / work_ms
    status_snap = (art["snapshots"].get("status") or {}) \
        if isinstance(art.get("snapshots"), dict) else {}
    sat = status_snap.get("saturation") or {}

    # ---- watchdog: pinned filter, fresh baselines, no re-arming
    saved = {f: flag(f) for f in (
        "anomaly_watch_filter", "anomaly_warmup_ticks",
        "anomaly_close_ticks", "anomaly_watchdog_enabled",
        "incident_capture_enabled")}
    set_flag("anomaly_watch_filter", ",".join(sorted(set(trigger_keys))))
    set_flag("anomaly_warmup_ticks", str(warmup_ticks))
    set_flag("anomaly_close_ticks", "3")
    set_flag("anomaly_watchdog_enabled", "true")
    set_flag("incident_capture_enabled", "false")
    wd = global_watchdog()
    wd.reset()

    server = None
    plan = None
    installed = False
    try:
        if server_factory is not None:
            server, address = server_factory()
        else:
            opts = ServerOptions(enable_builtin_services=False)
            limit = sat.get("concurrency_limit")
            if shape["press"]:
                # replicate the incident server's overload organ: its
                # concurrency limit, floored at 1 (a press repro
                # against an unlimited server sheds nothing)
                opts.max_concurrency = int(limit) if limit else 1
            server = Server(opts)
            svc_by_name: Dict[str, Service] = {}
            work_s = work_ms / 1000.0

            def _mk_handler(delay_s: float):
                async def replay_echo_handler(cntl, request):
                    await fiber_sleep(delay_s)
                    return bytes(request)
                return replay_echo_handler

            for rec in records:
                svc = svc_by_name.get(rec.service)
                if svc is None:
                    svc = svc_by_name[rec.service] = Service(rec.service)
                if rec.method not in svc.methods:
                    svc.register_method(rec.method, _mk_handler(work_s))
            # the port's server takes a service's methods when it is
            # added, so every method is registered first
            for svc in svc_by_name.values():
                server.add_service(svc)
            ep = server.start("tcp://127.0.0.1:0")
            address = f"tcp://127.0.0.1:{ep.port}"
            # a server without builtin services exposes no shed counter,
            # and the watchdog reads only exposed ones
            expose_shed_vars()
        report["address"] = address

        if use_plan:
            plan = build_fault_plan(shape, address, conns=conns)
            if plan is not None:
                chaos_inject.install(plan)
                installed = True
                report["plan"] = json.loads(plan.to_json())

        # warmup: zero-traffic baselines for the pinned keys
        t0 = int(time.time())
        for i in range(warmup_ticks + 1):
            series_sample_tick(wall_t=t0 + i)
        before = len(wd.incident_snapshot())

        if shape["press"] and use_plan:
            replay_records = _tile(records, _MIN_PRESS_RECORDS)
            pace = PaceSpec("qps", qps=press_factor * capacity_qps,
                            seed=seed)
        elif shape["press"]:
            # fix-forward: same corpus, offered rate deterministically
            # UNDER capacity, closed-loop on one connection so issues
            # never overlap on a drained server, even after a stall of
            # this process
            replay_records = records
            pace = PaceSpec("qps", qps=calm_factor * capacity_qps,
                            seed=seed)
        else:
            replay_records = records
            pace = PaceSpec("recorded", warp=1.0, seed=seed)
        timeout_ms = max(500.0, 20 * work_ms)
        if shape["press"] and not use_plan:
            rep = _run_calm(replay_records, address, pace, timeout_ms)
        else:
            rep = run_open_loop(
                replay_records, address, pace, conns=conns,
                default_timeout_ms=timeout_ms, drain_s=5.0)
        report["replay"] = {
            "records": rep.get("records"), "issued": rep.get("issued"),
            "ok": rep.get("ok"), "fail": rep.get("fail"),
            "elapsed_s": rep.get("elapsed_s"),
            "per_method": rep.get("per_method"),
            "pace": rep.get("pace"),
        }
        if plan is not None:
            report["plan_fired"] = len(plan.fired())

        # the spike's bucket, plus one settling tick
        for i in range(2):
            series_sample_tick(wall_t=t0 + warmup_ticks + 1 + i)
        incidents = wd.incident_snapshot()[before:]
        matched = [inc for inc in incidents
                   if set(inc.get("keys") or ())
                   & set(trigger_keys)]
        report["incidents_opened"] = len(incidents)
        report["refired"] = bool(matched)
        if matched:
            report["matched_key"] = (
                matched[0].get("peak_key")
                or (matched[0].get("keys") or [""])[0])
        report["ok"] = True
        return report
    finally:
        if installed:
            try:
                chaos_inject.uninstall()
            except Exception:
                pass
        if server is not None and server_factory is None:
            try:
                server.stop()
                server.join(2)
            except Exception:
                pass
        for f, v in saved.items():
            try:
                set_flag(f, str(v))
            except Exception:
                pass
        wd.reset()
