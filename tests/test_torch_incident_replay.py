"""The port's incident replay (``incident/replay.py``,
``tools/incident_replay``, ``tools/rpc_view --incident``) against
brpc_tpu's, on the CPU.

- ``derive_repro`` and ``build_fault_plan`` equal brpc_tpu's on the same
  incident documents (error classes and trigger keys, made from a seed,
  and the artifact of the run below): the same shape, and the same
  ``FaultPlan.to_json`` bytes or none.
- End to end, as tests/test_incident.py runs it on brpc_tpu: a shed
  storm on a port server with ``max_concurrency=1`` opens an incident on
  ``server_limit_shed`` and leaves an artifact; ``replay_incident`` with
  its pressure (an open-loop press) makes the watchdog fire again on the
  same key, and the fix-forward run at 0.5x the load stays quiet; the
  command line says the same with ``--expect refire`` and ``--no-plan
  --expect quiet``; ``rpc_view --incident --json`` reads the artifact as
  brpc_tpu's tool does.
- An artifact whose classes imply timeouts replays with a chaos
  ``FaultPlan`` installed (its delays fire) and uninstalled after.

One collected test over the cases (``_run_cases`` of
test_torch_cluster.py, whose leak check also fails a case that leaves a
plan installed or a replay's channels open).
"""

import importlib.util
import json
import subprocess
import sys
import tempfile
import time

import numpy as np

from brpc_tpu.incident import replay as ref_replay

import brpc_tpu_torch.fiber as port_fiber
import brpc_tpu_torch.rpc as port_rpc
from brpc_tpu_torch.butil import flags as port_flags
from brpc_tpu_torch.bvar.anomaly import global_watchdog
from brpc_tpu_torch.bvar.series import series_sample_tick
from brpc_tpu_torch.chaos import installed_plan
from brpc_tpu_torch.incident import artifact as port_art
from brpc_tpu_torch.incident import manager as port_mgr
from brpc_tpu_torch.incident import replay as port_replay
from brpc_tpu_torch.rpc import errno_codes as berr
from brpc_tpu_torch.traffic import capture as port_cap
from brpc_tpu_torch.traffic.corpus import CapturedRequest

from test_torch_cluster import ROOT, _run_cases, _wait_for

CASE_LIMIT_S = 120.0
_NAMES = ["ERPCTIMEDOUT", "EFAILEDSOCKET", "ECLOSE", "EOVERCROWDED",
          "ELIMIT", "EPRIORITYSHED", "EREQUEST", "E1999"]
_KEYS = ["server_limit_shed", "server_deadline_shed", "rpc_queue_delay",
         "socket_overcrowded", "server_priority_shed", "rpc_server_qps"]


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_ref_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Flags:
    def __init__(self, **values):
        self.values, self.old = values, {}

    def __enter__(self):
        for k, v in self.values.items():
            self.old[k] = port_flags.flag(k)
            assert port_flags.set_flag(k, v), (k, v)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            port_flags.set_flag(k, v)


def _metas(seed=17, n=40):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        classes = {str(x): int(rng.integers(1, 9)) for x in
                   rng.choice(_NAMES, int(rng.integers(0, 4)),
                              replace=False)}
        keys = [str(k) for k in rng.choice(_KEYS, int(rng.integers(0, 3)),
                                           replace=False)]
        meta = {"error_classes": classes, "keys": keys}
        if rng.random() < 0.5:
            meta["peak_key"] = str(rng.choice(_KEYS))
        out.append(meta)
    return out


def _derive_against_reference(metas):
    for i, meta in enumerate(metas):
        got = port_replay.derive_repro(meta, seed=i)
        assert got == ref_replay.derive_repro(meta, seed=i), meta
        for ep in ("tcp://127.0.0.1:7000", "mem://inc"):
            for conns in (1, 4):
                a = port_replay.build_fault_plan(got, ep, conns=conns)
                b = ref_replay.build_fault_plan(got, ep, conns=conns)
                assert (a is None) == (b is None), meta
                if a is not None:
                    assert a.to_json() == b.to_json()


def case_derive_and_plan():
    metas = _metas()
    _derive_against_reference(metas)
    shapes = [port_replay.derive_repro(m) for m in metas]
    # the seeds cover every branch
    assert any(s["press"] for s in shapes) and \
        any(s["timeouts"] for s in shapes) and \
        any(s["connect"] for s in shapes) and \
        any(not (s["press"] or s["timeouts"] or s["connect"])
            for s in shapes)


async def _slow(cntl, request):
    await port_fiber.sleep(0.02)
    return bytes(request)


def _shed_storm(d):
    """A shed storm on a port server with ``max_concurrency=1`` (the
    verify skill's incident drive): the artifact's path."""
    wd = global_watchdog()
    with _Flags(anomaly_watch_filter="server_limit_shed",
                anomaly_warmup_ticks=3, anomaly_close_ticks=3,
                incident_capture_enabled=True, incident_dir=d,
                incident_window_ticks=3):
        wd.reset()
        svc = port_rpc.Service("IncE2E")
        svc.register_method("Slow", _slow)
        srv = port_rpc.Server(port_rpc.ServerOptions(max_concurrency=1))
        srv.add_service(svc)
        port = srv.start("tcp://127.0.0.1:0").port
        ch = port_rpc.Channel(f"tcp://127.0.0.1:{port}",
                              port_rpc.ChannelOptions(timeout_ms=10000,
                                                      max_retry=0))
        stamp = [int(time.time()) - 100_000]

        def tick():
            stamp[0] += 1
            series_sample_tick(stamp[0])
        mgr = port_mgr.global_manager()
        try:
            assert not ch.call_sync("IncE2E", "Slow", b"warm").failed()
            for _ in range(4):
                tick()
            calls = [ch.call("IncE2E", "Slow", b"press%d" % i)
                     for i in range(24)]
            for c in calls:
                c.join()
            assert any(c.error_code == berr.ELIMIT for c in calls)
            tick()
            rec = port_cap.global_recorder()
            assert _wait_for(lambda: mgr.window_open_now() == 1 and
                             rec.capturing(), 5.0), wd.incident_snapshot()
            for i in range(6):
                assert not ch.call_sync("IncE2E", "Slow",
                                        b"evidence%d" % i).failed()
            for _ in range(8):
                tick()
                if not mgr.window_open_now():
                    break
            assert _wait_for(lambda: bool(mgr.artifact_rows()), 10.0)
            assert _wait_for(lambda: wd.incident_snapshot()[0]["state"] ==
                             "closed", 10.0)
            return mgr.artifact_rows()[0]["path"]
        finally:
            ch.close()
            srv.stop()
            srv.join(2)
            wd.reset()


def _tool(argv, timeout=120):
    p = subprocess.run([sys.executable, "-m", *argv], cwd=ROOT,
                       capture_output=True, text=True, timeout=timeout)
    return p.returncode, p.stdout, p.stderr


def case_fault_to_artifact_to_replay():
    with tempfile.TemporaryDirectory() as d:
        path = _shed_storm(d)
        art = port_art.read_artifact(path)
        assert "server_limit_shed" in art["meta"]["keys"]
        assert len(art["corpus"]) >= 1
        _derive_against_reference([art["meta"]])
        shape = port_replay.derive_repro(art["meta"])
        assert shape["press"] and not shape["timeouts"]
        rep = port_replay.replay_incident(path, use_plan=True, seed=11)
        assert rep["ok"] and rep["refired"], rep
        assert "server_limit_shed" in str(rep.get("matched_key"))
        assert rep["replay"]["issued"] >= 64 and \
            rep["replay"]["fail"] > 0, rep["replay"]
        fix = port_replay.replay_incident(path, use_plan=False, seed=11)
        assert fix["ok"] and not fix["refired"], fix
        assert fix["replay"]["fail"] == 0 and fix["replay"]["ok"] == \
            fix["replay"]["issued"] == fix["corpus_records"], fix
        assert fix["replay"]["pace"]["qps"] == \
            rep["replay"]["pace"]["qps"] * 0.5 / 4.0
        assert installed_plan() is None
        # the command lines
        rc, out, err = _tool(["brpc_tpu_torch.tools.incident_replay",
                              path, "--json"])
        assert rc == 0, (out + err)[-3000:]
        r = json.loads(out.strip().splitlines()[-1])
        assert r["passed"] and r["expect"] == "refire", r
        rc, out, err = _tool(["brpc_tpu_torch.tools.incident_replay",
                              path, "--no-plan", "--expect", "quiet",
                              "--json"])
        assert rc == 0, (out + err)[-3000:]
        assert json.loads(out.strip().splitlines()[-1])["passed"]
        rc, out, err = _tool(["brpc_tpu_torch.tools.rpc_view",
                              "--incident", path, "--json"])
        assert rc == 0, err[-3000:]
        ref_view = _load_tool("rpc_view")
        want = subprocess.run(
            [sys.executable, str(ROOT / "tools" / "rpc_view.py"),
             "--incident", path, "--json"], cwd=ROOT, capture_output=True,
            text=True, timeout=120)
        assert want.returncode == 0, want.stderr[-3000:]
        assert json.loads(out) == json.loads(want.stdout)
        assert json.loads(out)["corpus"] == ref_view.summarize(
            art["corpus"])


def case_timeout_artifact_installs_a_plan():
    """Timeout classes derive chaos delays: the replay installs the
    plan on the fresh server's endpoint, its delays fire, and it is
    gone after."""
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/incident-9.brpcinc"
        w = port_art.ArtifactWriter(path)
        w.put_incident_meta({"id": 9, "keys": ["server_deadline_shed"],
                             "peak_key": "server_deadline_shed",
                             "error_classes": {"ERPCTIMEDOUT": 4}})
        w.put_snapshot("status", {"saturation": {}})
        for i in range(6):
            w.put_request(CapturedRequest(
                "Inc.Call", "Inc", "Call", b"t%d" % i, b"",
                1_000_000 * i, 0, 400.0, 0, i, 0, 3000.0))
        w.close()
        rep = port_replay.replay_incident(path, use_plan=True, seed=3)
        assert rep["ok"] and rep["derived"]["timeouts"], rep
        plan = rep["plan"]
        assert set(plan["scripts"]) == {rep["address"]}
        assert rep["plan_fired"] >= 1, rep
        assert rep["replay"]["issued"] == 6
        assert installed_plan() is None
        fix = port_replay.replay_incident(path, use_plan=False, seed=3)
        assert "plan" not in fix and fix["replay"]["ok"] == 6, fix


class _StallOnce:
    """A stand-in for a replay module's ``time``: its first ``sleep``
    oversleeps by ``stall_s``, as a stall of the replaying process
    would (the rest is the real module)."""

    def __init__(self, stall_s):
        self.stall_s, self.stalls = stall_s, 0

    def sleep(self, s):
        if not self.stalls:
            self.stalls = 1
            s += self.stall_s
        time.sleep(s)

    def __getattr__(self, name):
        return getattr(time, name)


def case_a_stall_sheds_no_fix_forward_call():
    """An 80 ms stall of the replay's issuing loop, at a pace of one
    call each 40 ms against a server with ``max_concurrency`` 1 and 20
    ms of work a call, sheds no fix-forward call."""
    from brpc_tpu_torch.traffic import replay as traffic_replay

    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/incident-5.brpcinc"
        w = port_art.ArtifactWriter(path)
        w.put_incident_meta({"id": 5, "keys": ["server_limit_shed"],
                             "peak_key": "server_limit_shed",
                             "error_classes": {"ELIMIT": 9}})
        w.put_snapshot("status", {"saturation": {"concurrency_limit": 1}})
        for i in range(7):
            w.put_request(CapturedRequest(
                "IncStall.Slow", "IncStall", "Slow", b"s%d" % i, b"",
                40_000_000 * i, 0, 0.0, 0, i, 0, 20_000.0))
        w.close()
        stall = _StallOnce(0.08)
        mods = (traffic_replay, port_replay)
        saved = [m.time for m in mods]
        for m in mods:
            m.time = stall
        try:
            fix = port_replay.replay_incident(path, use_plan=False, seed=5)
        finally:
            for m, t in zip(mods, saved):
                m.time = t
        assert stall.stalls == 1, "the replay never slept"
        assert fix["ok"] and fix["work_ms"] == 20.0, fix
        assert fix["replay"]["pace"]["qps"] == 25.0, fix["replay"]
        assert fix["replay"]["fail"] == 0 and fix["replay"]["ok"] == \
            fix["replay"]["issued"] == 7, fix["replay"]
        assert not fix["refired"], fix


CASES = [
    ("derive_repro and build_fault_plan against brpc_tpu's",
     case_derive_and_plan, ()),
    ("fault, artifact, refire, quiet", case_fault_to_artifact_to_replay,
     ()),
    ("a timeout artifact replays under a FaultPlan",
     case_timeout_artifact_installs_a_plan, ()),
    ("a stall of the replay sheds no fix-forward call",
     case_a_stall_sheds_no_fix_forward_call, ()),
]


def test_incident_replay():
    _run_cases(CASES, limit_s=CASE_LIMIT_S)
