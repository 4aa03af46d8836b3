"""The port's smokes (``brpc_tpu_torch/tools/*_smoke.py``, ``ring_smoke``
and ``shard_server --smoke``) on the CPU, against brpc_tpu's where they
have pure parts.

- Each smoke runs as ``python3 -m brpc_tpu_torch.tools.<smoke>`` in a
  subprocess (tests/test_torch_isolation.py holds each module to import
  no jax, brpc_tpu or protobuf), at its smallest flags, with
  ``BRPC_TPU_TORCH_PERF_SMOKE=0`` (the perf criteria off) and
  ``--device cpu`` where it builds an engine or a device lane; it exits
  0 and its JSON line holds its invariants.
- Pure parts against brpc_tpu's on the same inputs: the merged timeline
  and incident views over the same shard dumps (the port's and
  brpc_tpu's ``ShardAggregator``), the flight smoke's attribution ratio
  over seeded profiles, and the traffic smoke's recorded drive against
  brpc_tpu's ``synthesize_records`` with the same seeds.
- ``perf_smoke`` measures (its floors are the gate's, held in
  tests/test_torch_preflight.py): every ratio present and positive.

One collected test over the cases (``_run_cases`` of
test_torch_cluster.py, whose leak check also fails a case that leaves a
child process, a socket or a timer behind).
"""

import importlib.util
import json
import os
import random
import subprocess
import sys
import tempfile

from brpc_tpu.rpc.shard_group import ShardAggregator as RefAggregator
from brpc_tpu.traffic import replay as ref_replay

from brpc_tpu_torch.rpc.shard_group import ShardAggregator
from brpc_tpu_torch.tools import (flight_smoke, incident_smoke,
                                  timeline_smoke, traffic_smoke)

from test_torch_cluster import ROOT, _run_cases

CASE_LIMIT_S = 240.0


def _load_ref(name):
    """brpc_tpu's ``tools/<name>.py`` under another module name."""
    spec = importlib.util.spec_from_file_location(
        f"brpc_tpu_tool_{name}", str(ROOT / "tools" / f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def smoke(name, *args, rc=0, timeout=180):
    """``python3 -m brpc_tpu_torch.tools.<name> args...`` with the perf
    criteria off: its JSON report (the last line, or the whole indented
    output)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["BRPC_TPU_TORCH_PERF_SMOKE"] = "0"
    proc = subprocess.run(
        [sys.executable, "-m", f"brpc_tpu_torch.tools.{name}", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == rc, (proc.stdout + proc.stderr)[-3000:]
    out = proc.stdout.strip()
    return json.loads(out) if out.startswith("{\n") \
        else json.loads(out.splitlines()[-1])


# ------------------------------------------------------------- smokes

def case_timeline():
    r = smoke("timeline_smoke")
    assert r["ok"] and r["bucket_exact"] and r["incident_ok"], r
    assert r["incidents_opened"] == 1 and r["twin_parity"], r
    assert r["merged_ok"] and r["bad_name_400"], r
    assert r["bucket_sum_delta"] == r["counter_delta"] == r["burst_calls"]
    assert "series_overhead_pct" not in r


def _dumps(d, sections, key):
    for i, sec in enumerate(sections):
        with open(os.path.join(d, f"shard-{i}.json"), "w") as f:
            json.dump({"shard": i, "pid": 1000 + i, "seq": 1, "time": 1.0,
                       "vars": {}, "status": {}, "latency_samples": {},
                       key: sec}, f)


def case_merged_views_against_reference():
    assert timeline_smoke.merged_timeline_ok(ShardAggregator)
    assert timeline_smoke.merged_timeline_ok(RefAggregator)
    assert incident_smoke.merged_incidents_ok(ShardAggregator)
    assert incident_smoke.merged_incidents_ok(RefAggregator)
    with tempfile.TemporaryDirectory() as d:
        _dumps(d, [{"enabled": True, "series": s, "incidents": [],
                    "watch_keys": []}
                   for s in timeline_smoke.SHARD_SERIES], "timeline")
        ours = ShardAggregator(d, 2).merged_timeline()
        theirs = RefAggregator(d, 2).merged_timeline()
        assert ours["series"] == theirs["series"], (ours, theirs)
    with tempfile.TemporaryDirectory() as d:
        _dumps(d, incident_smoke.SHARD_SECTIONS, "incidents")
        assert ShardAggregator(d, 2).merged_incidents() == \
            RefAggregator(d, 2).merged_incidents()


def case_flight():
    r = smoke("flight_smoke")
    assert r["ok"] and r["mode"] == "single", r
    assert r["pyecho_in_folded"] and r["census_ok"], r
    assert r["attribution_ratio"] >= flight_smoke.ECHO_ATTRIBUTION_FLOOR
    r = smoke("flight_smoke", "--shards", "2")
    assert r["ok"] and r["shards"] == 2 and r["pyecho_in_folded"], r


def case_flight_ratio_against_reference():
    ref = _load_ref("flight_smoke")
    rng = random.Random(20260803)
    for _ in range(50):
        labels = {f"{rng.choice(['rpc:', 'thread:'])}"
                  f"{rng.choice(['Bench.PyEcho', 'Bench.Echo', 'X.Y'])}"
                  f"{i}": rng.randrange(0, 40) for i in range(6)}
        prof = {"labels": labels,
                "nbusy": rng.choice([0, sum(labels.values()) + 3])}
        assert flight_smoke.echo_ratio(prof) == ref._echo_ratio(prof)


def case_traffic():
    r = smoke("traffic_smoke", "--smoke", timeout=120)
    assert r["problems"] == [], r
    assert r["recorded"] == r["driven"] == r["replayed"], r
    assert r["replay_fidelity_pct"] >= 85, r


def case_traffic_records_against_reference():
    for qps, seconds in ((150.0, 1.6), (200.0, 1.5), (40.0, 0.5)):
        ours = traffic_smoke.smoke_records(qps, seconds)
        n = max(20, int(qps * seconds))
        theirs = (ref_replay.synthesize_records(
                      n * 3 // 4, ref_replay.parse_mix("16:0.6,512:0.4"),
                      ref_replay.parse_mix("1:0.8,9:0.2"), qps=qps * 3 / 4,
                      mode="poisson", seed=11, service="Traffic",
                      method="Small", timeout_ms=3000)
                  + ref_replay.synthesize_records(
                      n - n * 3 // 4, ref_replay.parse_mix("2048:1.0"),
                      ref_replay.parse_mix("0:0.5,5:0.5"), qps=qps / 4,
                      mode="poisson", seed=12, service="Traffic",
                      method="Big", timeout_ms=3000))
        theirs.sort(key=lambda r: r.arrival_mono_ns)
        assert [tuple(r) for r in ours] == [tuple(r) for r in theirs]


def case_incident():
    r = smoke("incident_smoke")
    assert r["ok"] and r["e2e_ok"] and r["artifacts"] == 1, r
    for k in ("twin_parity", "status_line_ok", "download_ok",
              "download_denied", "replay_refired", "fix_forward_quiet",
              "merged_ok"):
        assert r[k], (k, r)
    assert r["press_sheds"] > 0 and r["corpus_records"] >= 1, r


def case_perf():
    r = smoke("perf_smoke")
    for k in ("raw_ping_qps", "raw_stream_GBps", "rpc_1c_qps",
              "mb_echo_GBps", "qps_ratio", "mb_eff"):
        assert r[k] > 0, (k, r)
    if (os.cpu_count() or 1) >= 4:
        assert r["shard_scaling"] > 0 and r["shard_client_failures"] == 0
    else:
        assert "shard_skipped" in r, r


def case_serving_obs():
    r = smoke("serving_obs_smoke", "--device", "cpu")
    assert r["ok"] and r["problems"] == [], r
    assert r["serving_spans"] >= 12, r
    assert r["serving_stage_attribution_pct"] >= 90.0, r


def case_device_obs():
    r = smoke("device_obs_smoke", "--device", "cpu")
    assert r["ok"] and r["problems"] == [], r
    assert r["device_spans"] >= 16 and r["device_recv_spans"] > 0, r
    assert r["ici_stage_attribution_pct"] >= 90.0, r
    assert all(c["transfers"] == c["completed"] and not c["failed"]
               for c in r["cells"].values()), r


def case_device_perf():
    r = smoke("device_perf_smoke", "--device", "cpu")
    assert r["ok"] and r["lane_kind"] == "local-d2d", r
    for k in ("ici_small_batch_us", "host_small_us", "small_latency_ratio",
              "ici_headline_GBps", "host_1mb_GBps", "headline_ratio"):
        assert r[k] > 0, (k, r)


def case_ici():
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "ici.json")
        r = smoke("ici_smoke", "--device", "cpu", "--out", out,
                  timeout=240)
        assert json.load(open(out)) == r
    assert r["ok"] and r["card"]["skipped"], r
    cpu = r["cpu_fabric"]
    assert cpu["ok"] and cpu["lane_kind"] == "staged", cpu
    assert cpu["stage_breakdown"]["n"] >= 5, cpu
    # the repo's own evidence file is never written
    assert not os.path.exists(ROOT / "brpc_tpu_torch" / "ICI_SMOKE.json")


def case_ring():
    r = smoke("ring_smoke", "--smoke")
    assert r["ok"] and r["parity"] == "byte-for-byte", r
    assert r["ring_dispatcher"] == "RingDispatcher", r
    assert r["parity_calls"] == 224, r


def case_shard_server():
    r = smoke("shard_server", "--smoke", timeout=120)["smoke"]
    assert len(r["conn_spread"]) == 2 and r["survivor_calls"] > 0, r
    assert r["merged_var"][next(iter(r["merged_var"]))] == \
        sum(r["merged_var"]["shards"]), r


CASES = [
    ("timeline_smoke", case_timeline, ()),
    ("merged timeline and incidents against brpc_tpu's",
     case_merged_views_against_reference, ()),
    ("flight_smoke, single and sharded", case_flight, ()),
    ("the attribution ratio against brpc_tpu's",
     case_flight_ratio_against_reference, ()),
    ("traffic_smoke --smoke", case_traffic, ()),
    ("the recorded drive against brpc_tpu's records",
     case_traffic_records_against_reference, ()),
    ("incident_smoke", case_incident, ()),
    ("perf_smoke", case_perf, ()),
    ("serving_obs_smoke --device cpu", case_serving_obs, ()),
    ("device_obs_smoke --device cpu", case_device_obs, ()),
    ("device_perf_smoke --device cpu", case_device_perf, ()),
    ("ici_smoke --device cpu", case_ici, ()),
    ("ring_smoke --smoke", case_ring, ()),
    ("shard_server --smoke", case_shard_server, ()),
]


def test_smokes():
    _run_cases(CASES, limit_s=CASE_LIMIT_S)
