"""The incident time machine's smoke (the port of
tools/incident_smoke.py; the gate ``incident_smoke`` of
``tools.preflight --gate``)::

    python3 -m brpc_tpu_torch.tools.incident_smoke

Six invariants, one JSON line:

  1. freeze: a press wave against a ``max_concurrency=1`` server spikes
     ``server_limit_shed``; the watchdog opens an incident, the manager
     arms a bounded capture window, in-window requests land in the
     spool, and the bundler writes one size-capped ``.brpcinc`` artifact
     whose incident names the key and whose corpus replays;
  2. twin parity: HTTP ``/incidents`` and the builtin RPC ``incidents``
     agree, ``/status`` carries the incidents line, and
     ``/incidents?action=download`` serves the artifact's bytes and
     nothing outside the ledger;
  3. the replay re-fires: ``replay_incident`` with the derived pressure
     opens an incident on the same key against a fresh server;
  4. the fix-forward stays quiet: the same replay without the plan;
  5. the merged view: ``ShardAggregator.merged_incidents`` over two
     shard dumps sums the counters and tags the rows with their shard;
  6. overhead <= 5%: arming on against off
     (``BRPC_TPU_TORCH_INCIDENT_ARM``), two echo servers loaded at once
     (``smoke_util.simultaneous_overhead``; the reference alternates
     windows). ``BRPC_TPU_TORCH_PERF_SMOKE=0`` skips this criterion only.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import threading
import time
import urllib.parse

WINDOW_TICKS = 3
ARTIFACT_POLL_S = 12.0


def _tick(n: int = 1):
    from brpc_tpu_torch.bvar.series import series_sample_tick
    for _ in range(n):
        series_sample_tick()


def _press_wave(ch, service: str, method: str, calls: int) -> dict:
    """Issue ``calls`` concurrent requests (open loop, done-callbacks)
    and wait for all completions: against max_concurrency=1 and a slow
    handler most of them shed with ELIMIT — the spike the watchdog
    must catch."""
    lock = threading.Lock()
    done_ev = threading.Event()
    counts = {"ok": 0, "fail": 0, "left": calls}

    def _done(c):
        with lock:
            counts["ok" if not c.failed() else "fail"] += 1
            counts["left"] -= 1
            last = counts["left"] <= 0
        if last:
            done_ev.set()

    for _ in range(calls):
        ch.call(service, method, b"press", done=_done)
    done_ev.wait(15.0)
    return counts


def run_checks(out: dict) -> None:
    from brpc_tpu_torch.butil.flags import flag, set_flag
    from brpc_tpu_torch.bvar.anomaly import global_watchdog
    from brpc_tpu_torch.fiber.timer import sleep as fiber_sleep
    from brpc_tpu_torch.incident.artifact import read_artifact
    from brpc_tpu_torch.incident.manager import global_manager
    from brpc_tpu_torch.rpc import (Channel, ChannelOptions, Server,
                                    ServerOptions, Service)
    from brpc_tpu_torch.tools.smoke_util import OVERHEAD_PCT_MAX, perf_off
    from brpc_tpu_torch.tools.spawn_util import http_get_local

    tmp = tempfile.mkdtemp(prefix="inc-smoke-")
    art_dir = os.path.join(tmp, "artifacts")

    saved = {f: flag(f) for f in (
        "anomaly_watch_filter", "anomaly_warmup_ticks",
        "anomaly_close_ticks", "incident_dir",
        "incident_window_ticks", "incident_capture_enabled",
        "incident_max_artifact_mb")}
    # determinism: only the press key feeds the watchdog; small window
    # so the seal rides a handful of ticks
    set_flag("anomaly_watch_filter", "server_limit_shed")
    set_flag("anomaly_warmup_ticks", "3")
    set_flag("anomaly_close_ticks", "3")
    set_flag("incident_dir", art_dir)
    set_flag("incident_window_ticks", str(WINDOW_TICKS))
    set_flag("incident_capture_enabled", "true")
    set_flag("incident_max_artifact_mb", "4")
    global_watchdog().reset()

    server = Server(ServerOptions(enable_builtin_services=True,
                                  max_concurrency=1))
    svc = Service("IncSmoke")

    @svc.method()
    async def Slow(cntl, request):
        await fiber_sleep(0.05)
        return bytes(request)

    server.add_service(svc)
    ep = server.start("tcp://127.0.0.1:0")
    ch = Channel(f"tcp://127.0.0.1:{ep.port}",
                 ChannelOptions(timeout_ms=8000))
    art_path = ""
    try:
        # ---- 1. e2e: press -> incident -> window -> artifact
        assert not ch.call_sync("IncSmoke", "Slow", b"w").failed()
        _tick(4)                      # settle: baseline + warmup
        wave = _press_wave(ch, "IncSmoke", "Slow", 24)
        out["press_sheds"] = wave["fail"]
        _tick()                       # the spike's bucket
        mgr = global_manager()
        # the window arms on whichever tick saw the spike (ours or the
        # background 1/s sampler's)
        deadline = time.monotonic() + 3.0
        while not mgr.window_engaged and time.monotonic() < deadline:
            time.sleep(0.05)
        out["window_armed"] = bool(mgr.window_engaged)
        out["capture_flipped"] = bool(
            mgr.incidents_state_payload().get("capturing"))
        # in-window evidence: requests that ride into the corpus
        captured_ok = 0
        for _ in range(6):
            if not ch.call_sync("IncSmoke", "Slow", b"evidence").failed():
                captured_ok += 1
        out["in_window_ok"] = captured_ok
        # calm ticks run the window down; the bundler then writes the
        # artifact on its own thread — poll, never count ticks exactly
        # (the background sampler interleaves freely)
        deadline = time.monotonic() + ARTIFACT_POLL_S
        arts = []
        while time.monotonic() < deadline:
            _tick()
            arts = [r for r in mgr.artifact_rows()]
            if arts and not mgr.window_engaged:
                break
            time.sleep(0.2)
        out["artifacts"] = len(arts)
        if not arts:
            out["e2e_ok"] = False
            out["manager_error"] = mgr.last_error
            return
        art_path = arts[0]["path"]
        art = read_artifact(art_path)
        meta = art["meta"]
        cap_bytes = int(flag("incident_max_artifact_mb")) << 20
        out["artifact_bytes"] = os.stat(art_path).st_size
        out["corpus_records"] = len(art["corpus"])
        out["snapshot_names"] = sorted(art["snapshots"])
        out["incident_keys"] = meta.get("keys")
        out["e2e_ok"] = (
            "server_limit_shed" in (meta.get("keys") or ())
            and out["artifact_bytes"] <= cap_bytes
            and len(art["corpus"]) >= 1
            and "status" in art["snapshots"])

        # ---- 2. twin parity + /status line + download
        st, body = http_get_local(ep.port, "/incidents")
        page = json.loads(body)
        r = ch.call_sync("builtin", "incidents", b"")
        twin = json.loads(r.response)
        out["twin_parity"] = bool(
            st == 200 and not r.failed()
            and set(page) == set(twin)
            and len(page.get("artifacts") or ()) == len(arts))
        st, body = http_get_local(ep.port, "/status")
        status_line = (json.loads(body).get("incidents") or {})
        out["status_line_ok"] = (
            st == 200 and status_line.get("url") == "/incidents"
            and (status_line.get("total") or 0) >= 1)
        q = urllib.parse.quote(art_path, safe="")
        st, body = http_get_local(
            ep.port, f"/incidents?action=download&path={q}")
        out["download_ok"] = (st == 200
                              and len(body) == out["artifact_bytes"])
        st, _ = http_get_local(
            ep.port, "/incidents?action=download&path=/etc/passwd")
        out["download_denied"] = st != 200
    finally:
        try:
            ch.close()
        except Exception:
            pass
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
        global_watchdog().reset()

    # ---- 3+4. replay re-fires; fix-forward stays green
    from brpc_tpu_torch.incident.replay import replay_incident
    rep = replay_incident(art_path, use_plan=True, seed=11)
    out["replay_refired"] = bool(rep.get("refired"))
    out["replay_matched_key"] = rep.get("matched_key")
    out["replay_issued"] = (rep.get("replay") or {}).get("issued")
    if not rep.get("ok"):
        out["replay_error"] = rep.get("error")
    fix = replay_incident(art_path, use_plan=False, seed=11)
    out["fix_forward_quiet"] = bool(fix.get("ok")) \
        and not fix.get("refired")
    shutil.rmtree(tmp, ignore_errors=True)

    out["merged_ok"] = merged_incidents_ok()

    # ---- 6. overhead: arming on and off, loaded at once
    skip_perf = perf_off()
    if not skip_perf:
        _overhead(out)
    ok = bool(out.get("e2e_ok") and out.get("twin_parity")
              and out.get("status_line_ok") and out.get("download_ok")
              and out.get("download_denied")
              and out.get("replay_refired")
              and out.get("fix_forward_quiet") and out.get("merged_ok")
              and (skip_perf or out.get("arm_overhead_pct", 100.0)
                   <= OVERHEAD_PCT_MAX))
    out["ok"] = ok
    if not ok:
        out["invariant"] = ("e2e/twin/status/download/replay/"
                            "fix-forward/merged/overhead check failed")


SHARD_SECTIONS = [
    {"enabled": True, "open": 1, "total": 2, "evicted": 1,
     "skipped": 0, "artifact_bytes": 1000,
     "artifacts": [
         {"path": "/a/i2.brpcinc", "bytes": 600, "opened_t": 200},
         {"path": "/a/i1.brpcinc", "bytes": 400, "opened_t": 100}]},
    {"enabled": False, "open": 0, "total": 1, "evicted": 0,
     "skipped": 2, "artifact_bytes": 500,
     "artifacts": [
         {"path": "/b/j1.brpcinc", "bytes": 500, "opened_t": 150}]},
]


def merged_incidents_ok(aggregator_cls=None) -> bool:
    """5. ``ShardAggregator.merged_incidents`` over two shard dumps sums
    the counters and bytes, and tags the artifact rows with their shard
    in the order they opened. ``aggregator_cls`` defaults to the
    port's."""
    if aggregator_cls is None:
        from brpc_tpu_torch.rpc.shard_group import ShardAggregator
        aggregator_cls = ShardAggregator
    with tempfile.TemporaryDirectory(prefix="inc-smoke-dumps-") as d:
        for i, sec in enumerate(SHARD_SECTIONS):
            with open(os.path.join(d, f"shard-{i}.json"), "w") as f:
                json.dump({"shard": i, "pid": 1000 + i, "seq": 1,
                           "time": time.time(), "vars": {}, "status": {},
                           "latency_samples": {}, "incidents": sec}, f)
        merged = aggregator_cls(d, 2).merged_incidents()
    rows = merged.get("artifacts") or []
    return (merged.get("shards_reporting") == 2
            and merged.get("enabled") is True
            and merged.get("open") == 1
            and merged.get("total") == 3
            and merged.get("evicted") == 1
            and merged.get("artifact_bytes") == 1500
            and [r.get("opened_t") for r in rows] == [100, 150, 200]
            and [r.get("shard") for r in rows] == [0, 1, 0])


def _overhead(out: dict) -> None:
    """Arming on against off (``BRPC_TPU_TORCH_INCIDENT_ARM``: the flag
    check rides the server's sampler tick, so the switch rides the
    server's environment), the two servers loaded at once."""
    from brpc_tpu_torch.tools.smoke_util import (simultaneous_overhead,
                                                 spawn_echo_servers,
                                                 stop_all)
    procs, ports = spawn_echo_servers(
        {"on": {"BRPC_TPU_TORCH_INCIDENT_ARM": "1"},
         "off": {"BRPC_TPU_TORCH_INCIDENT_ARM": "0"}})
    try:
        got = simultaneous_overhead(ports["on"], ports["off"])
    finally:
        stop_all(procs)
    out["arm_overhead_pct"] = got["overhead_pct"]
    out["overhead_qps"] = got


def main() -> int:
    t0 = time.monotonic()
    out: dict = {}
    try:
        run_checks(out)
    except Exception as e:  # noqa: BLE001 - one JSON line either way
        out["ok"] = False
        out["error"] = f"{type(e).__name__}: {e}"[:300]
    out["elapsed_s"] = round(time.monotonic() - t0, 2)
    print(json.dumps(out))
    sys.stdout.flush()
    return 0 if out.get("ok") else 1


if __name__ == "__main__":
    rc = main()
    os._exit(rc)   # skip the runtime threads' teardown
