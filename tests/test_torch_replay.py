"""The port's replay and press (``rpc/rpc_dump.py``,
``traffic/replay.py``, ``tools/rpc_view``, ``rpc_replay`` and
``rpc_press``) against brpc_tpu's, on the CPU.

- ``PaceSpec`` schedules (recorded with a warp, constant qps, seeded
  Poisson), ``parse_mix`` and ``synthesize_records`` equal brpc_tpu's for
  the same seed, record for record.
- ``merge_reports``, ``_summarize`` and ``fidelity_pct`` equal brpc_tpu's
  on the same reports, made from a seed.
- One corpus written once by brpc_tpu's ``CorpusWriter`` and once by the
  port's: ``load_dump`` and ``rpc_view``'s ``summarize`` read the same
  from both files with either package, and ``load_dump`` reads an old
  JSONL dump alike; the ``rpc_dump_dir`` alias starts the recorder and
  its clearing stops it.
- Capture, then replay, of Generate on a port server on the CPU: the
  corpus holds every call, an open-loop replay at a constant qps issues
  and answers every record, and re-issued records' tokens equal
  brpc_tpu's ``TinyDecoder``.
- ``rpc_press`` and ``rpc_replay`` as ``python3 -m`` subprocesses with
  ``--procs 2``: the merged counts are exact sums of the workers'; and
  ``rpc_press --protocol http`` POSTs through the port's HTTP client.
- Records that carry an attachment are replayed with it (the port's
  engine and brpc_tpu's alike).

Schedules and counts are asserted, never the wall clock (brpc_tpu's
pacing tests that read it fail on parent trees too); times are bounded
loosely. One collected test over the cases (``_run_cases`` of
test_torch_cluster.py, whose leak check also fails a case that leaves a
replay's channels open).
"""

import base64
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

from brpc_tpu.rpc import rpc_dump as ref_dump
from brpc_tpu.serving import TinyDecoder as RefDecoder
from brpc_tpu.serving import TinyDecoderConfig as RefConfig
from brpc_tpu.traffic import corpus as ref_corpus
from brpc_tpu.traffic import replay as ref_replay

from brpc_tpu_torch.butil import flags as port_flags
from brpc_tpu_torch.rpc import (Channel, ChannelOptions, Server, Service,
                                rpc_dump as port_dump)
from brpc_tpu_torch.serving import add_generate_service
from brpc_tpu_torch.tools import rpc_view as port_view
from brpc_tpu_torch.traffic import capture as port_cap
from brpc_tpu_torch.traffic import corpus as port_corpus
from brpc_tpu_torch.traffic import replay as port_replay

from test_torch_cluster import ROOT, _run_cases, _wait_for


def _load_tool(name):
    """The repo's ``tools/<name>.py`` (brpc_tpu's tool), loaded from its
    file without putting ``tools/`` on the import path."""
    spec = importlib.util.spec_from_file_location(
        f"_ref_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref_view = _load_tool("rpc_view")

CASE_LIMIT_S = 90.0


def _records(mod, rng, n):
    """Seeded records with arrival stamps, timeouts and priorities."""
    t, out = 1_000_000_000, []
    for i in range(n):
        t += int(rng.integers(0, 5_000_000))
        out.append(mod.CapturedRequest(
            method_key=["A.b", "G.Generate"][i % 2],
            service=["A", "G"][i % 2], method=["b", "Generate"][i % 2],
            payload=bytes(rng.integers(0, 256, int(rng.integers(0, 900)),
                                       dtype=np.uint8)),
            attachment=b"", arrival_mono_ns=t,
            arrival_wall_ns=1_700_000_000_000_000_000 + i,
            timeout_ms=float(i % 3) * 100.0, priority=i % 4, log_id=i,
            status=[0, 0, 1003][i % 3], latency_us=float(i) * 7.5))
    return out


# --------------------------------------------------------------- seeded
def case_schedules_and_synthesis():
    for seed in (0, 7, 20260803):
        rng = np.random.default_rng(seed)
        port_recs = _records(port_corpus, rng, 60)
        ref_recs = [ref_corpus.CapturedRequest(*r) for r in port_recs]
        for kw in ({"mode": "recorded", "warp": 1.0},
                   {"mode": "recorded", "warp": 2.5},
                   {"mode": "qps", "qps": 333.0},
                   {"mode": "poisson", "qps": 120.0}):
            a = port_replay.PaceSpec(seed=seed, **kw)
            b = ref_replay.PaceSpec(seed=seed, **kw)
            assert a.schedule_s(port_recs) == b.schedule_s(ref_recs), kw
            assert a.to_dict() == b.to_dict()
    for spec in ("64:0.8,4096:0.2", "1,2:3, 9:0.5,", ""):
        assert port_replay.parse_mix(spec) == ref_replay.parse_mix(spec)
    assert port_replay.parse_mix("1.5:2", float) == \
        ref_replay.parse_mix("1.5:2", float)
    for seed, mode in ((1, "qps"), (2, "poisson"), (3, "qps")):
        args = (97, [(64, 0.7), (300, 0.2), (4096, 0.1)],
                [(0, 0.5), (3, 0.3), (9, 0.2)], 250.0)
        kw = {"mode": mode, "seed": seed, "timeout_ms": 40.0}
        a = port_replay.synthesize_records(*args, **kw)
        b = ref_replay.synthesize_records(*args, **kw)
        assert [tuple(r) for r in a] == [tuple(r) for r in b]
    for bad in ({"mode": "nope"}, {"mode": "qps"},
                {"mode": "recorded", "warp": 0.0}):
        for mod in (port_replay, ref_replay):
            try:
                mod.PaceSpec(**bad)
                raise AssertionError(bad)
            except ValueError:
                pass


def _report(rng, classes, nb, width):
    """A worker's report, made from ``rng``: per-class counts and
    latency samples, and the two histograms."""
    cls, ok, fail = {}, 0, 0
    for key in classes:
        o, f = int(rng.integers(0, 40)), int(rng.integers(0, 5))
        cls[key] = {"ok": o, "fail": f,
                    "error_codes": {"1003": f} if f else {},
                    "lat_ms_samples": [round(float(x), 3) for x in
                                       rng.gamma(2.0, 3.0, o)]}
        ok, fail = ok + o, fail + f
    sched = [int(x) for x in rng.integers(0, 9, nb)]
    issue = [max(0, v + int(d)) for v, d in
             zip(sched, rng.integers(-2, 3, nb))]
    return {"records": ok + fail, "issued": ok + fail, "ok": ok,
            "fail": fail, "undrained": int(rng.integers(0, 2)),
            "elapsed_s": float(rng.random() * 5),
            "behind_ms_max": float(rng.random() * 20),
            "pace": {"mode": "qps"}, "classes": cls,
            "bucket_width_s": width, "sched_hist": sched,
            "issue_hist": issue,
            "fidelity_pct": port_replay.fidelity_pct(sched, issue)}


def case_merge_and_fidelity():
    rng = np.random.default_rng(11)
    keys = ["A.b|p0", "A.b|p3", "G.Generate|p0"]
    for width_mix in ((0.05, 0.05, 0.05), (0.05, 0.1, 0.05)):
        reports = [_report(rng, keys[:1 + i], 12 + i, w)
                   for i, w in enumerate(width_mix)]
        reports.append({})                      # a dead worker's nothing
        got = port_replay.merge_reports(json.loads(json.dumps(reports)))
        want = ref_replay.merge_reports(json.loads(json.dumps(reports)))
        assert got == want
        assert got["workers"] == 3 and \
            got["ok"] == sum(r.get("ok", 0) for r in reports)
    assert port_replay.merge_reports([]) == ref_replay.merge_reports([])
    for s, a in (([3, 0, 2], [1, 2, 2]), ([], []), ([5], [0, 0, 5]),
                 ([1, 1], [1, 1])):
        assert port_replay.fidelity_pct(s, a) == \
            ref_replay.fidelity_pct(s, a)
    # _summarize over the same class stats
    stats = []
    for mod in (port_replay, ref_replay):
        r = np.random.default_rng(4)
        classes = {}
        for key in keys:
            cs = classes[key] = mod._ClassStats(seed=5)
            for code, lat in zip(r.integers(0, 4, 3000) * 1001,
                                 r.gamma(2.0, 2.0, 3000)):
                cs.record(int(code) if code > 2000 else 0, float(lat))
        stats.append(mod._summarize(classes, [4, 5, 1], [3, 6, 1], 0.1))
    assert stats[0] == stats[1]


# --------------------------------------------------------------- corpus
def case_corpus_views():
    recs = _records(port_corpus, np.random.default_rng(5), 40)
    with tempfile.TemporaryDirectory() as d:
        paths = {}
        for name, mod in (("port", port_corpus), ("ref", ref_corpus)):
            p = paths[name] = os.path.join(d, f"{name}.brpccap")
            w = mod.CorpusWriter(p)
            for r in recs:
                w.write(mod.CapturedRequest(*r))
            w.close()
        with open(paths["port"], "rb") as a, open(paths["ref"], "rb") as b:
            assert a.read() == b.read()
        jl = os.path.join(d, "legacy.jsonl")
        with open(jl, "w") as f:
            for r in recs[:10]:
                f.write(json.dumps({
                    "service": r.service, "method": r.method,
                    "payload": base64.b64encode(r.payload).decode(),
                    "log_id": r.log_id}) + "\n\n")
        for p in (paths["port"], paths["ref"], jl):
            got = list(port_dump.load_dump(p))
            assert got == list(ref_dump.load_dump(p)) and got
            views = [list(port_view._load(p)), list(ref_view._load(p))]
            assert [tuple(r) for r in views[0]] == \
                [tuple(r) for r in views[1]]
            assert port_view.summarize(views[0]) == \
                ref_view.summarize(views[1])
        assert port_view.summarize(recs)["records"] == 40
        # the command line reads the port's corpus
        out = subprocess.run(
            [sys.executable, "-m", "brpc_tpu_torch.tools.rpc_view",
             paths["port"], "--json"], cwd=ROOT, capture_output=True,
            text=True, timeout=60)
        assert out.returncode == 0, out.stderr[-2000:]
        assert json.loads(out.stdout.strip().splitlines()[-1]) == \
            ref_view.summarize(list(ref_view._load(paths["port"])))


def _echo_server():
    svc = Service("Bench")
    svc.register_method("PyEcho", lambda cntl, req: bytes(req))
    svc.register_method("Slow", lambda cntl, req: bytes(req))
    server = Server()
    server.add_service(svc)
    return server, str(server.start("tcp://127.0.0.1:0"))


def case_legacy_rpc_dump_dir():
    rec = port_cap.global_recorder()
    assert not rec.capturing()
    server, addr = _echo_server()
    ch = Channel(addr, ChannelOptions(timeout_ms=5000,
                                      share_connections=False))
    try:
        with tempfile.TemporaryDirectory() as d:
            assert port_flags.set_flag("rpc_dump_dir", d)
            try:
                for i in range(5):
                    assert ch.call_sync("Bench", "PyEcho",
                                        b"d%d" % i).response == b"d%d" % i
                snap = rec.snapshot()
                assert snap["active"] and snap["legacy"], snap
                assert snap["config"]["dir"] == os.path.normpath(d)
                assert port_dump.global_dumper.maybe_dump(
                    "Bench", "PyEcho", b"by hand", log_id=9)
            finally:
                port_flags.set_flag("rpc_dump_dir", "")
            # the cleared flag is the legacy session's off switch
            assert ch.call_sync("Bench", "PyEcho", b"off").response == b"off"
            assert _wait_for(lambda: not rec.capturing())
            assert _wait_for(lambda: rec.snapshot()["pending"] == 0)
            rec.stop()
            got = [x for f in port_corpus.corpus_files(d)
                   for x in port_dump.load_dump(f)]
            want = [("Bench", "PyEcho", b"d%d" % i, 0) for i in range(5)]
            assert sorted(got) == sorted(want +
                                         [("Bench", "PyEcho", b"by hand",
                                           9)]), got
            assert got == list(ref_dump.load_dump(
                port_corpus.corpus_files(d)[0])) + [
                x for f in port_corpus.corpus_files(d)[1:]
                for x in ref_dump.load_dump(f)]
            assert not port_dump.global_dumper.maybe_dump("Bench", "PyEcho",
                                                          b"x")
    finally:
        ch.close()
        server.stop()
        server.join(5)


# ------------------------------------------------------------- Generate
def _generate_bodies(n, seed=20260803):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        prompt = "".join(chr(int(c)) for c in
                         rng.integers(97, 123, int(rng.integers(3, 12))))
        out.append((prompt, json.dumps({"prompt": prompt,
                                        "max_tokens": 8}).encode()))
    return out


def case_capture_then_replay_generate():
    bodies = _generate_bodies(12)
    with tempfile.TemporaryDirectory() as d:
        server = Server()
        add_generate_service(server, device="cpu")
        addr = str(server.start("tcp://127.0.0.1:0"))
        ch = Channel(addr, ChannelOptions(timeout_ms=60000,
                                          share_connections=False))
        try:
            port_cap.start_capture(dir=d, max_per_second=0,
                                   default_rate=1.0)
            for _, body in bodies:
                c = ch.call_sync("GenerateService", "Generate", body)
                assert not c.failed(), c.error_text
        finally:
            port_cap.stop_capture()
            ch.close()
            server.stop()
            server.join(5)
        records = port_corpus.read_corpus(d)
        assert [r.payload for r in records] == [b for _, b in bodies]
        assert {r.method_key for r in records} == \
            {"GenerateService.Generate"}
        # the replay, against a fresh server
        server = Server()
        gs = add_generate_service(server, device="cpu")
        addr = str(server.start("tcp://127.0.0.1:0"))
        try:
            rep = port_replay.run_open_loop(
                records, addr, port_replay.PaceSpec("qps", qps=40.0),
                conns=2, default_timeout_ms=30000.0)
            assert port_replay.live_channels() == 0
            assert (rep["records"], rep["issued"], rep["ok"], rep["fail"],
                    rep["undrained"]) == (12, 12, 12, 0, 0), rep
            assert sum(rep["sched_hist"]) == sum(rep["issue_hist"]) == 12
            assert rep["per_method"] == {
                "GenerateService.Generate": {"ok": 12, "fail": 0}}
            assert 0.2 < rep["elapsed_s"] < 30.0, rep["elapsed_s"]
            # the answers: re-issued records against the CPU oracle
            oracle = RefDecoder(RefConfig(cache_len=160))
            ch = Channel(addr, ChannelOptions(timeout_ms=60000,
                                              share_connections=False))
            try:
                pick = np.random.default_rng(3).choice(12, 5, replace=False)
                for i in pick:
                    c = ch.call_sync("GenerateService", "Generate",
                                     records[i].payload)
                    toks = json.loads(c.response)["tokens"]
                    assert toks == oracle.generate(
                        list(bodies[i][0].encode()), 8), i
            finally:
                ch.close()
            assert gs.batcher is not None
        finally:
            server.stop()
            server.join(5)


def _tool(argv, timeout=120):
    p = subprocess.run([sys.executable, "-m", *argv], cwd=ROOT,
                       capture_output=True, text=True, timeout=timeout)
    return p.returncode, p.stdout, p.stderr


def case_tools_fan_out():
    server, addr = _echo_server()
    try:
        with tempfile.TemporaryDirectory() as d:
            save = os.path.join(d, "press.brpccap")
            rc, out, err = _tool(
                ["brpc_tpu_torch.tools.rpc_press", addr, "Bench", "PyEcho",
                 "--count", "60", "--qps", "300", "--procs", "2",
                 "--size-mix", "16:0.5,700:0.5", "--priority-mix",
                 "0:0.5,4:0.5", "--seed", "5", "--save", save, "--json"])
            assert rc == 0, err[-3000:]
            rep = json.loads(out.strip().splitlines()[-1])
            assert (rep["workers"], rep["records"], rep["issued"],
                    rep["ok"], rep["fail"], rep["dead_workers"]) == \
                (2, 60, 60, 60, 0, 0), rep
            assert sum(d_["ok"] for d_ in rep["per_priority"].values()) \
                == 60
            # the saved corpus is the synthetic one, as brpc_tpu draws it
            want = ref_replay.synthesize_records(
                60, ref_replay.parse_mix("16:0.5,700:0.5"),
                ref_replay.parse_mix("0:0.5,4:0.5"), 300.0, seed=5,
                service="Bench", method="PyEcho", timeout_ms=2000.0)
            assert [tuple(r) for r in port_corpus.read_corpus(save)] == \
                [tuple(r) for r in want]
            rc, out, err = _tool(
                ["brpc_tpu_torch.tools.rpc_replay", save, addr, "--mode",
                 "qps", "--qps", "300", "--procs", "2", "--json"])
            assert rc == 0, err[-3000:]
            rep = json.loads(out.strip().splitlines()[-1])
            assert (rep["workers"], rep["records"], rep["issued"],
                    rep["ok"], rep["fail"]) == (2, 60, 60, 60, 0), rep
            assert rep["per_method"] == {
                "Bench.PyEcho": {"ok": 60, "fail": 0}}
            rc, out, err = _tool(
                ["brpc_tpu_torch.tools.rpc_press", addr, "Bench", "PyEcho",
                 "--protocol", "http", "--count", "2"])
            assert rc == 0 and "total=2 ok=2 fail=0" in out, out + err
    finally:
        server.stop()
        server.join(5)


def case_replay_with_attachments():
    """Records that carry an attachment are replayed with it, by the
    port's engine as by brpc_tpu's."""
    seen = []

    def Att(cntl, req):
        seen.append((bytes(req), cntl.request_attachment.to_bytes()))
        return b"ok"
    svc = Service("Bench")
    svc.register_method("Att", Att)
    server = Server()
    server.add_service(svc)
    addr = str(server.start("tcp://127.0.0.1:0"))
    try:
        rng = np.random.default_rng(23)
        for mod, engine in ((port_corpus, port_replay),
                            (ref_corpus, ref_replay)):
            records = [r._replace(method_key="Bench.Att", service="Bench",
                                  method="Att", timeout_ms=5000.0,
                                  attachment=rng.bytes(int(
                                      rng.integers(1, 5000))))
                       for r in _records(mod, rng, 24)]
            seen.clear()
            rep = engine.run_open_loop(records, addr,
                                       engine.PaceSpec("qps", qps=400.0),
                                       conns=2)
            assert (rep["issued"], rep["ok"], rep["fail"]) == (24, 24, 0), \
                rep
            assert sorted(seen) == sorted((r.payload, r.attachment)
                                          for r in records)
    finally:
        server.stop()
        server.join(5)


CASES = [
    ("schedules and synthesis against brpc_tpu's",
     case_schedules_and_synthesis, ()),
    ("merge_reports and fidelity against brpc_tpu's",
     case_merge_and_fidelity, ()),
    ("load_dump and rpc_view of one corpus", case_corpus_views, ()),
    ("the rpc_dump_dir alias", case_legacy_rpc_dump_dir, ()),
    ("capture, then replay, of Generate",
     case_capture_then_replay_generate, ()),
    ("rpc_press and rpc_replay with --procs 2", case_tools_fan_out, ()),
    ("records with attachments", case_replay_with_attachments, ()),
]


def test_replay():
    _run_cases(CASES, limit_s=CASE_LIMIT_S)
