"""The port's preflight (``brpc_tpu_torch/tools/preflight.py``) against
brpc_tpu's ``tools/preflight.py``, on the CPU.

- The pidfile reaper: ``kill_stale_repo_servers`` of both over the same
  shape of pidfile directory (a live child the test spawned and
  recorded, a recycled pid whose live command line differs, a dead pid,
  a malformed file) takes the same actions: the child alone is
  signalled, every stale record is removed, the test process lives.
  ``python3 -m brpc_tpu_torch.tools.preflight`` kills a child that wrote
  its own pidfile with ``butil.pidfile.write_pidfile``.
- The card scan names a child that maps a ``libcuda.so`` and no process
  without one.
- The lock and guard lanes' mutations each fire on the port's file (the
  batcher's callbacks under its lock, ici's flush without
  ``mv.release()``, the capture writer's counters without its lock, the
  teardown without its lock raced by the racelane); the unmutated tree
  lints clean in tests/test_torch_graftlint.py.
- Each gate that parses a tool's line gives brpc_tpu's gate's report
  for the same canned output (passing and failing), the port's extra
  keys aside; each skip switch skips under the port's prefix.
- ``gate_serving_smoke --device cpu`` for real (a 2-shard group), and
  ``fabric_smoke --smoke --shards 2 --corpus auto`` beside it: every
  invariant of the storm but the fault window's goodput bar. That bar
  (>= 0.7x the baseline) reads how fast the client is against one
  node: brpc_tpu's own storm fails it on this host's CPU as well
  (0.46-0.64), so here the ratio is reported, and the card's run of the
  gate holds it.

One collected test over the cases (``_run_cases`` of
test_torch_cluster.py, whose leak check also fails a case that leaves a
child process behind).
"""

import importlib.util
import json
import mmap
import os
import signal
import subprocess
import sys
import tempfile
import threading
import types

from brpc_tpu_torch.butil import pidfile as port_pidfile
from brpc_tpu_torch.tools import preflight

from test_torch_cluster import ROOT, _run_cases, _wait_for

CASE_LIMIT_S = 240.0


def _load_ref():
    spec = importlib.util.spec_from_file_location(
        "brpc_tpu_tool_preflight", str(ROOT / "tools" / "preflight.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load_ref()


def _sleeper(seconds=60):
    return subprocess.Popen([sys.executable, "-c",
                             f"import time; time.sleep({seconds})"])


def _reaped(proc):
    """Reap ``proc`` as soon as it exits (a zombie child would still
    look alive to a reaper that polls /proc): a thread whose join
    returns its exit code in ``proc.returncode``."""
    t = threading.Thread(target=proc.wait, daemon=True)
    t.start()
    return t


def _record(d, name, pid, cmd):
    with open(os.path.join(d, name), "w") as f:
        f.write(f"{pid}\n{cmd}\n")


def _reaper_dir(d):
    """A live child recorded as it runs, a recycled pid (this process,
    recorded with another command line), a dead pid and a malformed
    file: (the child, {pid: role})."""
    child = _sleeper()
    assert _wait_for(lambda: "time.sleep" in port_pidfile.cmdline(child.pid))
    dead = _sleeper(0)
    dead.wait(10)
    _record(d, f"server-a.{child.pid}.pid", child.pid,
            port_pidfile.cmdline(child.pid))
    _record(d, f"server-b.{os.getpid()}.pid", os.getpid(),
            "python3 -m some.other.server")
    _record(d, f"server-c.{dead.pid}.pid", dead.pid, "python3 -c gone")
    with open(os.path.join(d, "server-d.pid"), "w") as f:
        f.write("not a pid\n")
    return child, {child.pid: "child", os.getpid(): "self",
                   dead.pid: "dead"}


def _roles(actions, roles):
    return sorted((roles.get(a["pid"], "other"), a.get("signal"),
                   "error" in a) for a in actions)


def case_reaper_against_reference():
    with tempfile.TemporaryDirectory() as a, \
            tempfile.TemporaryDirectory() as b:
        port_child, port_roles = _reaper_dir(a)
        ref_child, ref_roles = _reaper_dir(b)
        waits = [_reaped(port_child), _reaped(ref_child)]
        saved = (port_pidfile.PID_DIR, ref.PID_DIR)
        try:
            port_pidfile.PID_DIR, ref.PID_DIR = a, b
            ours = preflight.kill_stale_repo_servers()
            theirs = ref.kill_stale_repo_servers()
        finally:
            port_pidfile.PID_DIR, ref.PID_DIR = saved
        for child, t in zip((port_child, ref_child), waits):
            t.join(10)
            assert child.returncode == -signal.SIGTERM
        assert _roles(ours, port_roles) == _roles(theirs, ref_roles) == \
            [("child", "TERM", False)], (ours, theirs)
        assert os.listdir(a) == os.listdir(b) == []


def case_preflight_cli_kills_a_recorded_stray():
    with tempfile.TemporaryDirectory() as d:
        env = dict(os.environ, BRPC_TPU_TORCH_PID_DIR=d)
        env.pop("PYTHONPATH", None)
        stray = subprocess.Popen(
            [sys.executable, "-c",
             "import time\n"
             "from brpc_tpu_torch.butil.pidfile import write_pidfile\n"
             "write_pidfile('stray')\n"
             "time.sleep(60)\n"], cwd=ROOT, env=env)
        wait = _reaped(stray)
        try:
            assert _wait_for(lambda: len(os.listdir(d)) == 1, 20.0)
            proc = subprocess.run(
                [sys.executable, "-m", "brpc_tpu_torch.tools.preflight"],
                cwd=ROOT, env=env, capture_output=True, text=True,
                timeout=60)
            assert proc.returncode == 0, proc.stderr[-2000:]
            report = json.loads(proc.stdout)
            assert [a["pid"] for a in report["killed"]] == [stray.pid], \
                report
            wait.join(10)
            assert stray.returncode == -signal.SIGTERM
            assert os.listdir(d) == []
            assert isinstance(report["card_holders"], list)
        finally:
            if stray.poll() is None:
                stray.kill()
                stray.wait(10)


def case_card_scan_names_a_libcuda_holder():
    with tempfile.TemporaryDirectory() as d:
        lib = os.path.join(d, "libcuda.so.1")
        with open(lib, "wb") as f:
            f.write(b"\0" * mmap.PAGESIZE)
        holder = subprocess.Popen(
            [sys.executable, "-c",
             "import mmap, sys, time\n"
             f"f = open({lib!r}, 'rb')\n"
             "m = mmap.mmap(f.fileno(), 0, prot=mmap.PROT_READ)\n"
             "print('mapped', flush=True)\n"
             "time.sleep(60)\n"], stdout=subprocess.PIPE, text=True)
        plain = _sleeper()
        try:
            assert holder.stdout.readline().strip() == "mapped"
            found = {h["pid"]: h for h in preflight.scan_card_holders()}
            assert holder.pid in found, found
            assert found[holder.pid]["libcuda_mapped"]
            assert plain.pid not in found and os.getpid() not in found
        finally:
            for p in (holder, plain):
                p.kill()
                p.wait(10)
            holder.stdout.close()


def case_lock_and_guard_lanes():
    muts = preflight.locklint_mutations()
    assert muts == {"callback-under-lock": True,
                    "memoryview-release": True}, muts
    muts = preflight.guard_lint_mutations()
    assert muts == {"Recorder.written": True,
                    "TaskControl._threads": True}, muts


# (gate, canned stdout lines of a pass and a failure); each line is what
# the port's tool prints, which is what brpc_tpu's prints for these keys
_SMOKE_LINE = {"elapsed_s": 1.5}
CANNED = {
    "trace_smoke": ({"spans": 12, "chains": 4, "perfetto_slices": 12},
                    {"invariant": "chains broken"}),
    "shard_smoke": ({"smoke": {"elapsed_s": 2.0, "restart_s": 0.5,
                               "survivor_calls": 900}},
                    {"invariant": "killed shard not restarted"}),
    "ring_lane": ({"ok": True, "auto_backend": "batch",
                   "uring_native": False, "enosys_fallback_proven": True,
                   "parity": "byte-for-byte", "parity_calls": 224},
                  {"ok": False, "auto_backend": "uring",
                   "uring_native": True, "error": "digests diverge"}),
    "chaos_smoke": ({"smoke": {"elapsed_s": 3.1,
                               "deadline": {"expired_shed_ratio": 1.0}}},
                    {"invariant": "leaks"}),
    "flight_smoke": ({"ok": True, "profiler_overhead_pct": 1.2,
                      "attribution_ratio": 0.9, "pyecho_in_folded": True,
                      "census_ok": True, "qps_on": 10.0, "qps_off": 11.0,
                      "mode": "single"},
                     {"ok": False, "invariant": "capture failed",
                      "attribution_ratio": 0.1}),
    "cluster_top": ({"ok": True, "backends": 2, "attempts": 80,
                     "scrape_matches_bvars": True, "attributed": True,
                     "merge_matches": True,
                     "backend_stats_overhead_pct": 2.0},
                    {"ok": False, "error": "echo server spawn failed"}),
    "fabric_smoke": ({"fault_goodput_ratio": 0.9, "fault_p99_ms": 80.0,
                      "outage_amplification": 1.05, "hedges_armed": 100,
                      "hedges_past_budget": 0, "revived": True,
                      "priority_goodput_hi_ratio": 0.99,
                      "press_client_shed_frac": [0.9, 0.95],
                      "press_priority_sheds": 500, "problems": []},
                     {"fault_goodput_ratio": 0.4, "problems": ["fault "
                                                               "goodput"]}),
    "traffic_smoke": ({"recorded": {"a": 3}, "replayed": {"a": 3},
                       "replay_fidelity_pct": 100.0,
                       "replay_elapsed_s": 0.8, "recorded_span_s": 1.6,
                       "problems": [], **_SMOKE_LINE},
                      {"recorded": {"a": 3}, "problems": ["lost one"]}),
    "device_obs": ({"ok": True, "device_spans": 31,
                    "ici_stage_attribution_pct": 100.0,
                    "device_stats_overhead_pct": 0.5,
                    "transfer_lane": "up", "problems": [], **_SMOKE_LINE},
                   {"ok": False, "error": "RuntimeError: x"}),
    "serving_obs": ({"ok": True, "serving_spans": 12,
                     "serving_stage_attribution_pct": 100.0,
                     "serving_stats_overhead_pct": 0.0, "problems": [],
                     **_SMOKE_LINE},
                    {"ok": False, "problems": ["stage attribution"]}),
    "timeline_smoke": ({"ok": True, "bucket_exact": True,
                        "incidents_opened": 1, "incident_ok": True,
                        "twin_parity": True, "merged_ok": True,
                        **_SMOKE_LINE},
                       {"ok": False, "bucket_exact": False,
                        "invariant": "bucket check failed"}),
    "incident_smoke": ({"ok": True, "press_sheds": 19, "e2e_ok": True,
                        "artifacts": 1, "corpus_records": 6,
                        "twin_parity": True, "status_line_ok": True,
                        "download_ok": True, "replay_refired": True,
                        "fix_forward_quiet": True, "merged_ok": True,
                        **_SMOKE_LINE},
                       {"ok": False, "error": "KeyError: 'x'"}),
    "perf_smoke": ({"qps_ratio": 0.3, "mb_eff": 0.5, "shard_scaling": 1.8,
                    "shard_count": 2},
                   {"error": "echo server spawn failed"}),
    "device_perf": ({"ok": True, "headline_ratio": 6.7,
                     "small_latency_ratio": 2.1},
                    {"ok": False, "error": "TimeoutError: never drained"}),
}
# lines that pass their tool and fail the gate's floors (exit 0)
REGRESSIONS = {
    "perf_smoke": [{"qps_ratio": 0.01, "mb_eff": 0.5,
                    "shard_skipped": "only 2 cores"},
                   {"qps_ratio": 0.3, "mb_eff": 0.5, "shard_scaling": 0.5,
                    "shard_count": 2},
                   {"qps_ratio": 0.3, "mb_eff": 0.01}],
    "device_perf": [{"ok": True, "headline_ratio": 0.5,
                     "small_latency_ratio": 2.0},
                    {"ok": True, "headline_ratio": 6.0,
                     "small_latency_ratio": 9.0}],
}
# the port's report keys brpc_tpu's gates do not have
PORT_ONLY = {"serving_smoke": {"merged_serving", "shards"}}


class _Canned:
    """A ``subprocess`` stand-in whose ``run`` answers every call with
    one canned line and exit code."""

    def __init__(self, line, rc):
        self.line, self.rc = line, rc
        self.argv = []

    def run(self, argv, **kw):
        self.argv.append(argv)
        return subprocess.CompletedProcess(
            argv, self.rc, json.dumps(self.line) + "\n", "")


def _gate(mod, name, line, rc):
    fake = _Canned(line, rc)
    saved = mod.subprocess
    mod.subprocess = types.SimpleNamespace(run=fake.run)
    try:
        out = getattr(mod, f"gate_{name}")()
    finally:
        mod.subprocess = saved
    out.pop("gate_s", None)
    return out, fake.argv


def case_gates_parse_like_the_reference():
    saved = (dict(preflight.PERF_FLOORS),
             preflight.DEVICE_PERF_FLOOR_HEADLINE_RATIO,
             preflight.DEVICE_PERF_CEIL_SMALL_RATIO)
    skips = {k: os.environ.pop(k) for k in list(os.environ)
             if k.startswith(("BRPC_TPU_TORCH_", "BRPC_TPU_"))
             and k.endswith(("_SMOKE", "_LINT", "_FLOOR_SCALE"))}
    try:
        # the same floors on both sides: the parsing is what is held
        preflight.PERF_FLOORS.update(ref.PERF_FLOORS)
        preflight.DEVICE_PERF_FLOOR_HEADLINE_RATIO = \
            ref.DEVICE_PERF_FLOOR_HEADLINE_RATIO
        preflight.DEVICE_PERF_CEIL_SMALL_RATIO = \
            ref.DEVICE_PERF_CEIL_SMALL_RATIO
        serving = ({"smoke": {"outcomes": {"completed": 12, "evicted": 4,
                                           "shed": 8},
                              "ttft_p50_ms": 5.0, "full_gen_p50_ms": 90.0,
                              "elapsed_s": 9.0, "merged_serving": {},
                              "shards": [{"flash_decode": 3}]},
                    "ok": True},
                   {"ok": False, "invariant": "verdicts lost"})
        for name, (good, bad) in dict(CANNED, serving_smoke=serving).items():
            for line, rc in ((good, 0), (bad, 1),
                             *((r, 0) for r in REGRESSIONS.get(name, ()))):
                ours, argv = _gate(preflight, name, line, rc)
                theirs, _ = _gate(ref, name, line, rc)
                extra = set(ours) - set(theirs)
                assert extra <= PORT_ONLY.get(name, set()), (name, extra)
                assert {k: ours[k] for k in theirs} == theirs, \
                    (name, rc, ours, theirs)
                assert all(a[1] == "-m" and a[2].startswith(
                    "brpc_tpu_torch.") for a in argv), argv
        # each skip switch, under the port's prefix
        for name, var in (("flight_smoke", "FLIGHT_SMOKE"),
                          ("cluster_top", "CLUSTER_SMOKE"),
                          ("serving_smoke", "SERVING_SMOKE"),
                          ("fabric_smoke", "FABRIC_SMOKE"),
                          ("traffic_smoke", "TRAFFIC_SMOKE"),
                          ("device_obs", "DEVICE_OBS_SMOKE"),
                          ("serving_obs", "SERVING_OBS_SMOKE"),
                          ("timeline_smoke", "TIMELINE_SMOKE"),
                          ("incident_smoke", "INCIDENT_SMOKE"),
                          ("guard_lint", "GUARD_LINT"),
                          ("racelane", "RACELANE_SMOKE"),
                          ("perf_smoke", "PERF_SMOKE"),
                          ("device_perf", "PERF_SMOKE")):
            os.environ[f"BRPC_TPU_TORCH_{var}"] = "0"
            os.environ[f"BRPC_TPU_{var}"] = "0"
            try:
                ours, argv = _gate(preflight, name, {}, 1)
                theirs, _ = _gate(ref, name, {}, 1)
            finally:
                del os.environ[f"BRPC_TPU_TORCH_{var}"]
                del os.environ[f"BRPC_TPU_{var}"]
            assert argv == [] and ours == {
                "ok": True, "skipped": f"BRPC_TPU_TORCH_{var}=0"}, ours
            assert theirs == {"ok": True, "skipped": f"BRPC_TPU_{var}=0"}
    finally:
        preflight.PERF_FLOORS.clear()
        preflight.PERF_FLOORS.update(saved[0])
        preflight.DEVICE_PERF_FLOOR_HEADLINE_RATIO = saved[1]
        preflight.DEVICE_PERF_CEIL_SMALL_RATIO = saved[2]
        os.environ.update(skips)


def case_the_gate_lists_the_references_gates_in_order():
    assert [n for n, _ in preflight.gates()] == [
        "graftlint", "locklint", "guard_lint", "racelane",
        "sanitizer_smoke", "ring_lane", "chaos_smoke", "trace_smoke",
        "shard_smoke", "flight_smoke", "cluster_top", "serving_smoke",
        "fabric_smoke", "traffic_smoke", "device_obs", "serving_obs",
        "timeline_smoke", "incident_smoke", "device_perf", "perf_smoke"]


def case_serving_gate_and_the_storm():
    """The serving gate for real on the CPU, and the fabric storm beside
    it (both are minutes of host work one after the other)."""
    storm = {}

    def run_storm():
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        p = subprocess.run(
            [sys.executable, "-m", "brpc_tpu_torch.tools.fabric_smoke",
             "--smoke", "--shards", "2", "--corpus", "auto"], cwd=ROOT,
            env=env, capture_output=True, text=True, timeout=200)
        storm["rc"] = p.returncode
        storm["out"] = p.stdout + p.stderr[-2000:]
        storm["report"] = json.loads(p.stdout.strip().splitlines()[-1])

    t = threading.Thread(target=run_storm)
    t.start()
    try:
        out = preflight.gate_serving_smoke(device="cpu")
    finally:
        t.join(220)
    assert out["ok"], out
    assert sum(out["outcomes"].values()) == 24, out
    assert out["outcomes"]["shed"] > 0 and out["outcomes"]["evicted"] > 0
    assert out["ttft_p50_ms"] < out["full_gen_p50_ms"] * 0.6, out
    m = out["merged_serving"]
    assert m["shards_reporting"] == 2, m
    assert m["completed"] + m["evicted"] + m["canceled"] >= \
        out["outcomes"]["completed"] + out["outcomes"]["evicted"] - 1, out
    assert len(out["shards"]) == 2 and all(
        s["decode_steps"] > 0 and s["warmup_steps"] >= 1
        and s["flash_decode"] == 0 for s in out["shards"]), out
    rep = storm["report"]
    others = [p for p in rep["problems"]
              if not p.startswith("fault goodput ")]
    assert others == [] and storm["rc"] == (1 if rep["problems"] else 0), \
        storm["out"][-3000:]
    assert 0 < rep["fault_goodput_ratio"] and rep["revived"], rep
    assert rep["hedges_armed"] > 0 and rep["hedges_past_budget"] == 0, rep
    assert rep["phases"]["press2"]["calls"] > 0, rep


CASES = [
    ("the pidfile reaper against brpc_tpu's",
     case_reaper_against_reference, ()),
    ("the CLI kills a recorded stray",
     case_preflight_cli_kills_a_recorded_stray, ()),
    ("the card scan names a libcuda holder",
     case_card_scan_names_a_libcuda_holder, ()),
    ("the lock and guard lanes' mutations fire",
     case_lock_and_guard_lanes, ()),
    ("gates parse like brpc_tpu's",
     case_gates_parse_like_the_reference, ()),
    ("the reference's gates in its order",
     case_the_gate_lists_the_references_gates_in_order, ()),
    ("the serving gate and the fabric storm",
     case_serving_gate_and_the_storm, ()),
]


def test_preflight():
    _run_cases(CASES, limit_s=CASE_LIMIT_S)
