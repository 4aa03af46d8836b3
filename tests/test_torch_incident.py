"""The port's recordio, capture corpus, capture recorder and incidents
against brpc_tpu's, on the CPU.

- recordio: the same records make the same bytes, and each side's
  reader reads the other's, resyncing past the same corruption.
- The .brpccap corpus and the .brpcinc artifact: files one side writes
  the other reads (records, sidecar index, summaries), byte for byte
  equal for the same input; brpc_tpu's corpus reader reads a port
  artifact's requests.
- The recorder: fresh instances of both with one seed sample alike;
  rotation, the disk budget and the rate budget; an incident window
  gives back the session it found; the writer thread ends with stop.
- End to end on a port server, the incident recipe with a ``Slow``
  handler: a shed storm opens incident #1 on ``server_limit_shed``, the
  window's calls are captured, the artifact is on /incidents and
  downloads byte for byte, both readers find the in-window requests,
  spans and the profile window are marked, and the incident closes;
  /capture starts, stops and downloads a corpus brpc_tpu reads. The
  payloads' keys are brpc_tpu's.

The cases run inside one collected test (``_run_cases`` of
test_torch_cluster.py), each under a time limit of its own, with its
checks for sockets and threads (the capture writer, the incident
bundler) left behind. No case changes brpc_tpu's global state.
"""

import http.client
import io
import json
import os
import tempfile
import time

import numpy as np

from brpc_tpu.butil import recordio as ref_rio
from brpc_tpu.incident import artifact as ref_art
from brpc_tpu.incident import manager as ref_mgr
from brpc_tpu.traffic import capture as ref_cap
from brpc_tpu.traffic import corpus as ref_corpus

import brpc_tpu_torch.fiber as port_fiber
import brpc_tpu_torch.rpc as port_rpc
from brpc_tpu_torch.builtin import flight_recorder as port_fr
from brpc_tpu_torch.butil import flags as port_flags
from brpc_tpu_torch.butil import recordio as port_rio
from brpc_tpu_torch.bvar.anomaly import global_watchdog
from brpc_tpu_torch.bvar.series import series_sample_tick
from brpc_tpu_torch.incident import artifact as port_art
from brpc_tpu_torch.incident import manager as port_mgr
from brpc_tpu_torch.rpc import errno_codes as berr
from brpc_tpu_torch.rpc.span import global_collector
from brpc_tpu_torch.traffic import capture as port_cap
from brpc_tpu_torch.traffic import corpus as port_corpus

from test_torch_cluster import _run_cases, _wait_for

CASE_LIMIT_S = 60.0


def _payloads(rng, n):
    out = []
    for i in range(n):
        size = int(rng.choice([0, 5, 300, 70_000]))
        out.append((bytes(rng.randint(0, 256, size, dtype=np.uint8)),
                    json.dumps({"i": i}).encode() if i % 3 else b""))
    return out


def _rio_bytes(mod, recs):
    f = io.BytesIO()
    w = mod.RecordWriter(f)
    for i, (data, meta) in enumerate(recs):
        if i % 2:
            w.write(data, meta)
        else:
            w.write_chunks((data[:7], data[7:]), meta)
    w.flush()
    return f.getvalue()


def _rio_read(mod, blob):
    r = mod.RecordReader(io.BytesIO(blob))
    return [tuple(x) for x in r], r.skipped_bytes


def _recordio():
    recs = _payloads(np.random.RandomState(3), 24)
    blob = _rio_bytes(port_rio, recs)
    assert blob == _rio_bytes(ref_rio, recs)
    good = [(m, d) for d, m in recs]
    assert _rio_read(port_rio, blob) == _rio_read(ref_rio, blob) == \
        (good, 0)
    # garbage ahead, a flipped byte in record 3, a false magic, a torn
    # tail: both readers keep the same records and skip the same bytes
    bad = bytearray(b"junk" + blob)
    third = 4 + sum(16 + len(m) + len(d) for m, d in good[:3]) + 20
    bad[third] ^= 0xFF
    bad = bytes(bad[:-9]) + b"RIO1" + b"\x00" * 3
    port, ref = _rio_read(port_rio, bad), _rio_read(ref_rio, bad)
    assert port == ref and port[1] > 0
    assert good[3] not in port[0] and good[4] in port[0]


def _records(rng, n, t0=1_000_000_000):
    out = []
    for i, (pay, att) in enumerate(_payloads(rng, n)):
        out.append(port_corpus.CapturedRequest(
            method_key=["A.b", "A.c", "Gen.Generate"][i % 3],
            service=["A", "A", "Gen"][i % 3], method=["b", "c",
                                                      "Generate"][i % 3],
            payload=pay, attachment=att, arrival_mono_ns=t0 + i * 1000,
            arrival_wall_ns=1_700_000_000_000_000_000 + i,
            timeout_ms=float(i % 4) * 250.5, priority=i % 3, log_id=i,
            status=[0, 0, berr.ELIMIT][i % 3], latency_us=12.5 * i))
    return out


def _write_corpus(mod, path, recs):
    w = mod.CorpusWriter(path)
    for r in recs:
        w.write(r)
    w.close()


def _read_corpus(mod, path):
    r = mod.CorpusReader(path)
    return [tuple(x) for x in r], r.index(), r.index(rebuild=True)


def _corpus():
    recs = _records(np.random.RandomState(9), 30)
    with tempfile.TemporaryDirectory() as d:
        p_port = os.path.join(d, "a.brpccap")
        p_ref = os.path.join(d, "b.brpccap")
        _write_corpus(port_corpus, p_port, recs)
        _write_corpus(ref_corpus, p_ref, recs)
        with open(p_port, "rb") as f1, open(p_ref, "rb") as f2:
            assert f1.read() == f2.read()
        for p in (p_port, p_ref):
            port, ref = _read_corpus(port_corpus, p), \
                _read_corpus(ref_corpus, p)
            assert port[0] == ref[0] == [tuple(r) for r in recs]
            assert port[1] == ref[1] and port[1]["source"] == "sidecar"
            assert port[2] == ref[2] and port[2]["records"] == 30
        # a torn tail: both lose the last record, and rebuild the index
        with open(p_port, "r+b") as f:
            f.truncate(os.path.getsize(p_port) - 5)
        port, ref = _read_corpus(port_corpus, p_port), \
            _read_corpus(ref_corpus, p_port)
        assert port == ref and len(port[0]) == 29
        assert port[1]["source"] == "scan"
        out_port, out_ref = os.path.join(d, "m1"), os.path.join(d, "m2")
        assert port_corpus.merge_corpora([p_ref, p_port], out_port) == \
            ref_corpus.merge_corpora([p_ref, p_port], out_ref)
        with open(out_port, "rb") as f1, open(out_ref, "rb") as f2:
            assert f1.read() == f2.read()


def _write_artifact(mod, path, recs):
    w = mod.ArtifactWriter(path)
    w.put_incident_meta({"id": 7, "keys": ["server_limit_shed"],
                         "peak_key": "server_limit_shed",
                         "opened_t": 1234, "error_classes": {"ELIMIT": 3}})
    w.put_snapshot("status", {"running": True, "n": [1, 2]})
    w.put_snapshot("timeline", {"series": {}})
    for r in recs:
        w.put_request(r)
    w.close()


def _artifacts():
    recs = _records(np.random.RandomState(21), 12)
    with tempfile.TemporaryDirectory() as d:
        paths = {}
        for name, mod in (("port", port_art), ("ref", ref_art)):
            paths[name] = os.path.join(d, f"incident-{name}.brpcinc")
            _write_artifact(mod, paths[name], recs)
        with open(paths["port"], "rb") as f1, \
                open(paths["ref"], "rb") as f2:
            assert f1.read() == f2.read()
        for p in paths.values():
            a, b = port_art.read_artifact(p), ref_art.read_artifact(p)
            assert a["meta"] == b["meta"] and a["snapshots"] == \
                b["snapshots"] and a["bad_records"] == b["bad_records"] == 0
            assert [tuple(r) for r in a["corpus"]] == \
                [tuple(r) for r in b["corpus"]] == [tuple(r) for r in recs]
            assert port_art.artifact_summary(p) == ref_art.artifact_summary(p)
            # a corpus reader skips the incident's own records
            assert [tuple(r) for r in ref_corpus.CorpusReader(p)] == \
                [tuple(r) for r in recs]
        os.remove(paths["port"] + ".idx")
        s_port = port_art.artifact_summary(paths["port"])
        assert s_port == ref_art.artifact_summary(paths["port"])
        assert s_port["source"] == "scan" and s_port["incident_id"] == 7
        assert port_art.artifact_files(d) == ref_art.artifact_files(d)


def _sample_all(rec, n=300):
    """n requests through sample_request/record_complete; which ones
    were taken."""
    took = []
    for i in range(n):
        key = ["A.b", "A.c", "A.d"][i % 3]
        r = rec.sample_request(key, "", "", b"p%d" % i, b"att" * (i % 2),
                               5_000_000 + i, 100.0, i, i % 2)
        took.append(r is not None)
        rec.record_complete(r, 0, 3.5)
    return took


def _recorder():
    """Fresh recorders with one seed take the same requests and write the
    same records; rotation, the disk budget, the rate budget, and the
    incident window's hand-back."""
    with tempfile.TemporaryDirectory() as d:
        took, files = {}, {}
        for name, mod in (("port", port_cap), ("ref", ref_cap)):
            rec = mod.Recorder()
            cfg = mod.CaptureConfig(
                os.path.join(d, name), default_rate=0.5,
                method_rates={"A.b": 1.0, "A.c": 0.0}, seed=5)
            rec.start(cfg)
            try:
                took[name] = _sample_all(rec)
            finally:
                rec.stop()
            assert rec._thread is None, name
            snap = rec.snapshot()
            files[name] = [tuple(r)[:6] + tuple(r)[7:] for r in
                           ref_corpus.read_corpus(os.path.join(d, name))]
            assert snap["written"] == sum(took[name]) and snap["active"] \
                is False
            if name == "port":
                keys = set(snap)
        assert took["port"] == took["ref"]
        assert files["port"] == files["ref"] and len(files["port"]) == \
            sum(took["port"])
        assert keys == set(ref_cap.Recorder().snapshot())
        # rotation and the disk budget: tiny files, the oldest deleted
        rec = port_cap.Recorder()
        rec.start(port_cap.CaptureConfig(
            os.path.join(d, "rot"), rotate_bytes=200,
            disk_budget_bytes=600))
        for i in range(40):
            r = rec.sample_request("A.b", "", "", b"x" * 60, None,
                                   time.monotonic_ns())
            rec.record_complete(r, 0, 1.0)
            if i % 10 == 9:
                rec._wake.set()
                time.sleep(0.15)
        rec.stop()
        snap = rec.snapshot()
        assert snap["rotations"] >= 5 and snap["deleted_files"] >= 1
        on_disk = sum(f["bytes"] for f in snap["files"])
        assert on_disk <= 600 + 400, snap["files"]
        # the rate budget: a burst in one second takes at most 5
        rec = port_cap.Recorder()
        rec.start(port_cap.CaptureConfig(os.path.join(d, "budget"),
                                         max_per_second=5))
        n = sum(_sample_all(rec, 60))
        rec.stop()
        assert 5 <= n <= 10 and rec.dropped_budget == 60 - n
        # an incident window gives back the operator's session
        rec = port_cap.Recorder()
        op = port_cap.CaptureConfig(os.path.join(d, "op"),
                                    default_rate=0.25)
        rec.start(op)
        try:
            win = port_cap.CaptureConfig(os.path.join(d, "win"))
            assert rec.begin_incident_capture(win)
            assert not rec.begin_incident_capture(win)
            assert rec.incident_capturing() and rec._cfg is win
            assert rec.end_incident_capture()
            assert rec._cfg is op and rec.capturing()
            assert not rec.end_incident_capture()
        finally:
            rec.stop()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


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


async def _slow(cntl, request):
    await port_fiber.sleep(0.05)
    return b"slow:" + bytes(request)


def _incident_recipe():
    """The verify skill's incident drive on a port server."""
    wd = global_watchdog()
    with tempfile.TemporaryDirectory() as d, _Flags(
            anomaly_watch_filter="server_limit_shed",
            anomaly_warmup_ticks=3, anomaly_close_ticks=3,
            incident_capture_enabled=True, incident_dir=d,
            incident_window_ticks=3, rpcz_enabled=True):
        wd.reset()
        svc = port_rpc.Service("S")
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
        try:
            assert not ch.call_sync("S", "Slow", b"warm").failed()
            for _ in range(4):
                tick()
            calls = [ch.call("S", "Slow", b"burst%d" % i)
                     for i in range(24)]
            for c in calls:
                c.join()
            sheds = [c for c in calls if c.failed()]
            assert sheds and all(c.error_code == berr.ELIMIT
                                 for c in sheds)
            tick()
            # the tick may have been the sampler thread's (a hand tick
            # skips while one runs), and the recorder starts just after
            # the window opens: wait until it records
            mgr = port_mgr.global_manager()
            rec = port_cap.global_recorder()
            assert _wait_for(lambda: mgr.window_open_now() == 1 and
                             rec.incident_capturing() and rec.capturing(),
                             5.0), wd.incident_snapshot()
            inc = wd.incident_snapshot()
            assert [i["keys"] for i in inc] == [["server_limit_shed"]]
            window = [b"in-window %d" % i for i in range(3)]
            for body in window:
                assert not ch.call_sync("S", "Slow", body).failed()
            for _ in range(8):
                tick()
                if not mgr.window_open_now():
                    break
            assert _wait_for(lambda: bool(mgr.artifact_rows()), 10.0)
            assert _wait_for(lambda: wd.incident_snapshot()[0]["state"] ==
                             "closed", 10.0)
            status, body = _get(port, "/incidents")
            page = json.loads(body)
            assert status == 200 and set(page) == set(
                ref_mgr.IncidentManager().incidents_state_payload())
            assert page["total"] >= 1 and page["open"] == 0
            rows = page["artifacts"]
            ref_rows = ref_mgr.IncidentManager()
            ref_rows._refresh_ledger_locked(d)    # brpc_tpu reads our dir
            assert rows == ref_rows._artifacts and len(rows) == 1
            path = rows[0]["path"]
            status, blob = _get(port, "/incidents?action=download&path=" +
                                path)
            with open(path, "rb") as f:
                assert status == 200 and blob == f.read()
            assert _get(port, "/incidents?action=download&path=" +
                        __file__)[0] == 404
            assert _get(port, "/incidents?action=nope")[0] == 400
            art, ref_a = port_art.read_artifact(path), \
                ref_art.read_artifact(path)
            assert art["meta"] == ref_a["meta"]
            assert art["meta"]["keys"] == ["server_limit_shed"] and \
                art["meta"]["id"] == 1
            got = [r.payload for r in art["corpus"]]
            assert [r.payload for r in ref_a["corpus"]] == got
            assert set(window) <= set(got), got
            assert all(r.method_key == "S.Slow" for r in art["corpus"])
            assert {"status", "timeline", "hotspots", "spans"} <= set(
                art["snapshots"])
            marked = [s for s in global_collector.recent(256) if any(
                "incident #1" in t for _, t in s.annotations)]
            assert marked
            assert any(k.startswith("incident:#1 server_limit_shed")
                       for k in port_fr.global_recorder().merged()["labels"])
            status, body = _get(port, "/status")
            line = json.loads(body)["incidents"]
            assert set(line) == set(ref_mgr.incident_status_line())
            assert line["total"] >= 1
        finally:
            ch.close()
            srv.stop()
            srv.join(2)
            wd.reset()


def _capture_page():
    """/capture: state, start, stop and the download, read by brpc_tpu's
    reader; the payload has brpc_tpu's keys."""
    svc = port_rpc.Service("C")
    svc.register_method("Echo", lambda cntl, req: req)
    srv = port_rpc.Server()
    srv.add_service(svc)
    port = srv.start("tcp://127.0.0.1:0").port
    ch = port_rpc.Channel(f"tcp://127.0.0.1:{port}")
    try:
        with tempfile.TemporaryDirectory() as d:
            status, body = _get(port, "/capture")
            assert status == 200 and set(json.loads(body)) == set(
                ref_cap.Recorder().snapshot())
            assert _get(port, "/capture?action=nope")[0] == 400
            status, body = _get(port, f"/capture?action=start&dir={d}"
                                      "&rate=1.0&max_per_second=0")
            snap = json.loads(body)
            assert status == 200 and snap["active"] and set(
                snap["config"]) == set(ref_cap.CaptureConfig(d).to_dict())
            sent = [b"req-%d" % i for i in range(6)]
            for body in sent:
                assert not ch.call_sync("C", "Echo", body).failed()
            status, body = _get(port, "/capture?action=stop")
            assert status == 200 and json.loads(body)["written"] == 6
            status, blob = _get(port, "/capture?action=download")
            assert status == 200
            p = os.path.join(d, "down.brpccap")
            with open(p, "wb") as f:
                f.write(blob)
            got = [r for r in ref_corpus.CorpusReader(p)]
            assert [r.payload for r in got] == sent
            assert {r.method_key for r in got} == {"C.Echo"}
            assert [r.service for r in got] == ["C"] * 6
            r = ch.call_sync("builtin", "capture", b"")
            assert not r.failed() and not json.loads(r.response)["active"]
            assert not port_cap.global_recorder().capturing()
    finally:
        port_cap.global_recorder().stop()
        ch.close()
        srv.stop()
        srv.join(2)


CASES = [
    ("recordio both ways", _recordio, ()),
    ("the corpus both ways", _corpus, ()),
    ("artifacts both ways", _artifacts, ()),
    ("the recorder", _recorder, ()),
    ("the incident recipe", _incident_recipe, ()),
    ("/capture", _capture_page, ()),
]


def test_incidents():
    _run_cases(CASES, limit_s=CASE_LIMIT_S)
