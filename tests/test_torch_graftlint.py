"""The port's graftlint (``brpc_tpu_torch/analysis/``) against brpc_tpu's,
on the CPU.

- The same findings: on every fixture of tests/graftlint_fixtures/ (the
  35 modules and ``cxx/``) the port's Analyzer gives brpc_tpu's
  ``(rule, line, message)`` lists, active and waived.
- Mutated copies of the port's own files, at the sites where
  tests/test_graftlint.py mutates brpc_tpu's (the limiter parser,
  fastcore.cc's guards, server_dispatch.py, tpu_std.py, the postfork
  registrations of backend_stats.py, device_stats.py, worker_module.py,
  event_dispatcher.py, capture.py, series.py and channel.py, the
  controller's arb/lb pair, the batcher, the ring lane, the flight
  recorder, the shard supervisor, the ici flush): the same rule fires,
  and the unmutated file is clean.
- judge-defer's field table, read from the port's meta codec, equals
  what brpc_tpu reads from its ``.proto``; its walker check examines
  more than 0 cases; walkers with no table beside them are a finding.
- The port's tree is clean: 0 unwaived findings, every waiver has a
  reason and suppresses something.
- The published tables: INVARIANTS.md's field guards equal the live
  inference and its lock table equals ``LOCK_ORDER``; the lock graph is
  acyclic with its edge count pinned; every ``LOCK_ORDER`` row names a
  lock the model found, and every edge of the model keeps the order.
- The CLI: exit codes, ``--format=json`` and ``sarif``, the baseline
  round trip, ``--list-rules`` naming brpc_tpu's rules in their order.
- The racelane, in subprocesses that import no jax, under the port's
  env hook (``BRPC_TPU_TORCH_LOCK_DEBUG``): install and uninstall, site
  naming and rank, the strict assert; the Controller's locks ranked at
  runtime; the fiber pool's teardown race on the port's ``TaskControl``
  (a buggy twin races at the same seeds in two processes, the fixed
  class holds at every seed).

The port's whole-tree model is built once and shared. One collected test
over the cases (``_run_cases`` of test_torch_cluster.py).
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

from brpc_tpu.analysis.core import Analyzer as RefAnalyzer
from brpc_tpu.analysis.racelane import LOCK_ORDER as REF_LOCK_ORDER
from brpc_tpu.analysis.rules import default_rules as ref_default_rules
from brpc_tpu.analysis.rules.judge_defer import _parse_proto

from brpc_tpu_torch.analysis import racelane
from brpc_tpu_torch.analysis.core import (Analyzer, Context, SourceFile,
                                          iter_source_files)
from brpc_tpu_torch.analysis.lockmodel import get_lock_model
from brpc_tpu_torch.analysis.rules import default_rules
from brpc_tpu_torch.analysis.rules.block_recycle import BlockRecycleRule
from brpc_tpu_torch.analysis.rules.event_wait import EventWaitNotSleepRule
from brpc_tpu_torch.analysis.rules.fiber_blocking import FiberBlockingRule
from brpc_tpu_torch.analysis.rules.guarded_by import render_field_guards
from brpc_tpu_torch.analysis.rules.judge_defer import (JudgeDeferRule,
                                                       _parse_codec)
from brpc_tpu_torch.analysis.rules.lock_graph import (
    BlockingUnderLockRule, CallbackUnderLockRule, LockCycleRule)
from brpc_tpu_torch.analysis.rules.memoryview_release import (
    MemoryviewReleaseRule)
from brpc_tpu_torch.analysis.rules.postfork_reset import PostforkResetRule
from brpc_tpu_torch.analysis.rules.registry_complete import (
    RegistryCompleteRule)
from brpc_tpu_torch.analysis.rules.sampler_import import (
    SamplerNoLazyImportRule)
from brpc_tpu_torch.analysis.rules.span_finish import SpanFinishRule
from test_torch_cluster import _run_cases

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "brpc_tpu_torch"
FIXTURES = ROOT / "tests" / "graftlint_fixtures"

# The port's lock graph, pinned: update it deliberately, with the
# LOCK_ORDER rows in analysis/racelane.py and analysis/INVARIANTS.md.
# 40: brpc_tpu's pin is 42 at its last change; the port's 40 keeps the
# ici, device-cell, recorder and batcher leaf edges brpc_tpu counts
# and differs where the code does. It has no Channel._socket_lock or
# _pool_lock (one Channel._lock, whose only edge is the transport
# registry's base:_lock) and no Socket.pending_lock; it adds the
# stream-send chain (_StreamSender._lock -> Stream._send_lock ->
# Socket.lane_lock), the RTMP relay's RtmpService._lock ->
# Socket.lane_lock, the TLS lock over the dispatcher's
# (SslConn._ssl_lock -> EventDispatcher._lock, its _glock and the
# DoublyBufferedData write lock), gRPC's GrpcCall._lock -> Butex._lock,
# cudad's flush lock over its conn lock, the CUDA IPC map lock over its
# library lock, the decode lock over flash_decode's split workspace,
# and the call registry under Controller._arb_lock over the pool's
# lock.
PINNED_EDGE_COUNT = 40
# edge ends LOCK_ORDER leaves out, as brpc_tpu's does: the bvar leaf and
# the model's receiver-inferred twins of DeviceCell._lock
UNRANKED_EDGE_ENDS = {"_ReducerBase._lock", "device_stats:?._lock",
                      "device_stats:cell._lock", "inject:base._lock"}

_shared = {}


def _ctx():
    """The port's whole-tree context, built once; the lock and thread
    models the rules build are cached on it."""
    if "ctx" not in _shared:
        _shared["ctx"] = Context(iter_source_files([str(PKG)]))
    return _shared["ctx"]


def _keys(findings):
    return [(f.rule, f.line, f.message) for f in findings]


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("BRPC_TPU_TORCH_LOCK")}
    env["PYTHONPATH"] = str(ROOT)
    env.update(extra)
    return env


def _cli(*args, cwd=ROOT, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "brpc_tpu_torch.analysis", *args],
        cwd=str(cwd), capture_output=True, text=True, timeout=timeout,
        env=_env())


def _py(code: str, env=None, timeout=120):
    """Run ``code`` in a fresh interpreter that imports no jax; its last
    stdout line as JSON. The code runs from a file, so that the racelane
    names a lock from its creating line."""
    with tempfile.NamedTemporaryFile("w", suffix=".py", prefix="driver_",
                                     delete=False) as f:
        f.write(code)
    try:
        out = subprocess.run([sys.executable, f.name], capture_output=True,
                             text=True, timeout=timeout, cwd=str(ROOT),
                             env=env or _env())
    finally:
        os.unlink(f.name)
    assert out.returncode == 0, f"rc {out.returncode}:\n{out.stderr[-3000:]}"
    return json.loads(out.stdout.strip().splitlines()[-1])


# ---------------------------------------------------------- the fixtures

def case_same_findings_on_fixtures():
    names = sorted(p.name for p in FIXTURES.glob("*.py")
                   if p.name != "__init__.py")
    assert len(names) == 35, names
    fired = set()
    for name in names + ["cxx"]:
        path = [str(FIXTURES / name)]
        ref_active, ref_waived = RefAnalyzer().run(path)
        active, waived = Analyzer().run(path)
        assert _keys(active) == _keys(ref_active), (name, _keys(active),
                                                    _keys(ref_active))
        assert _keys(waived) == _keys(ref_waived), (name, _keys(waived),
                                                    _keys(ref_waived))
        assert [f.reason for f in waived] == [f.reason for f in ref_waived]
        fired.update(f.rule for f in active)
    # the fixtures do reach every rule: none is vacuous
    assert fired >= {r.name for r in default_rules()}, fired


# ------------------------------------------------------------ mutations

def _read(rel: str) -> str:
    return (PKG / rel).read_text()


def _one_file(rule, rel: str, src: str, finalize: bool = False):
    sf = SourceFile(str(PKG / rel), f"brpc_tpu_torch/{rel}", src)
    ctx = Context([sf])
    return list(rule.finalize(ctx) if finalize else rule.check(sf, ctx))


def _fires(rule, rel, needle, replacement, want, finalize=False, count=1):
    """Mutate the port's ``rel`` (``needle`` -> ``replacement``): ``rule``
    fires with ``want`` in a message; the real file stays clean."""
    src = _read(rel)
    assert src.count(needle) >= count, (rel, needle)
    mutated = src.replace(needle, replacement, count)
    found = _one_file(rule, rel, mutated, finalize)
    assert any(f.rule == rule.name and want in f.message for f in found), \
        (rel, [f.format() for f in found])
    clean = _one_file(rule, rel, src, finalize)
    assert [f for f in clean if f.rule == rule.name] == [], \
        (rel, [f.format() for f in clean])


def _drop_line(rel: str, marker: str):
    src = _read(rel)
    lines = [ln for ln in src.splitlines() if marker in ln]
    assert len(lines) == 1, (rel, lines)
    return lines[0] + "\n"


def case_mutations_fire_on_port_files():
    # registry-complete: a limiter whose on_responded is the raising stub
    needle = ("    def on_responded(self, latency_us, failed,"
              " cost: float = 1.0):\n"
              "        with self._lock:\n"
              "            self._inflight = max(0.0,"
              " self._inflight - cost)\n"
              "\n"
              "    @property\n")
    _fires(RegistryCompleteRule(), "rpc/concurrency_limiter.py", needle,
           "    def on_responded(self, latency_us, failed,"
           " cost: float = 1.0):\n"
           "        raise NotImplementedError\n\n    @property\n",
           "ConstantLimiter")
    # span-finish: the dispatch's one finish_span (in its finally) gone
    _fires(SpanFinishRule(), "rpc/server_dispatch.py",
           "            _span.finish_span(span, cntl)\n",
           "            pass\n", "returns")
    # block-recycle: the turbo scan's pop moved before the scan reads
    scan = "            consumed, recs = scan(win, MAGIC, SMALL_FRAME_MAX, 128,\n"
    src = _read("protocol/tpu_std.py")
    assert src.count(scan) == 1
    mutated = src.replace(scan, "            portal.pop_front(12)\n" + scan)
    found = _one_file(BlockRecycleRule(), "protocol/tpu_std.py", mutated)
    assert any("'win'" in f.message for f in found), found
    assert _one_file(BlockRecycleRule(), "protocol/tpu_std.py", src) == []
    # postfork-reset: each registration dropped
    for rel, accessor in (("rpc/backend_stats.py", "global_stats"),
                          ("transport/device_stats.py",
                           "global_device_stats"),
                          ("fiber/worker_module.py", "register_module"),
                          ("transport/event_dispatcher.py",
                           "global_dispatcher"),
                          ("traffic/capture.py", "_recorder"),
                          ("bvar/series.py", "global_series"),
                          ("rpc/channel.py", "_client_messenger")):
        _fires(PostforkResetRule(), rel,
               _drop_line(rel, "postfork.register("), "", accessor)
    # ...and the protocol table is exempt with no registration
    for rel in ("protocol/registry.py", "protocol/tpu_std.py"):
        src = _read(rel)
        assert "postfork" not in src
        assert _one_file(PostforkResetRule(), rel, src) == []
    # callback-under-lock: the batcher fires under its lock
    _fires(CallbackUnderLockRule(), "serving/batcher.py",
           "        self._fire(emits, done)\n        if stats_on:",
           "            self._fire(emits, done)\n        if stats_on:",
           "on_token", finalize=True)
    # fiber-blocking: a sleep in the ring tick's sinks
    anchor = ("    def ring_input(self, data, eof: bool = False, "
              "err: int = 0) -> None:\n")
    _fires(FiberBlockingRule(), "transport/socket.py", anchor,
           anchor + "        time.sleep(0.001)\n", "ring_input")
    anchor = "    def _dispatch_completion(self, comp) -> None:\n"
    _fires(FiberBlockingRule(), "transport/ring_lane.py", anchor,
           anchor + "        time.sleep(0.001)\n", "_dispatch_completion")
    # blocking-under-lock and sampler-no-lazy-import: the flight recorder
    _fires(BlockingUnderLockRule(), "builtin/flight_recorder.py",
           "                self._sleep(0.05)\n",
           "                with self._lock:\n"
           "                    self._sleep(0.05)\n",
           "FlightRecorder._lock", finalize=True)
    _fires(SamplerNoLazyImportRule(), "builtin/flight_recorder.py",
           "                cntl = _serving_cntl.peek(fiber)\n",
           "                from brpc_tpu_torch.rpc.server_dispatch import "
           "_serving_cntl as sc\n"
           "                cntl = sc.peek(fiber)\n", "_attribute",
           finalize=True)
    # the capture writer: a wait under its lock, a lazy import in its loop
    _fires(BlockingUnderLockRule(), "traffic/capture.py",
           "            self._wake.wait(0.1)\n",
           "            with self._lock:\n"
           "                self._wake.wait(0.1)\n", "Recorder._lock",
           finalize=True)
    needle = ("            self._wake.wait(0.1)\n"
              "            self._wake.clear()\n")
    _fires(SamplerNoLazyImportRule(), "traffic/capture.py", needle,
           needle + "            from brpc_tpu_torch.rpc import "
           "server_dispatch as _sd\n", "_record_writer_loop",
           finalize=True)
    # event-wait-not-sleep: the shard monitor's tick back on time.sleep
    _fires(EventWaitNotSleepRule(), "rpc/shard_group.py",
           "            park.wait(0.05)\n", "            time.sleep(0.05)\n",
           "_monitor_loop", finalize=True)
    # lock-cycle: the controller nests arb around lb while the cluster
    # channel calls the arb-taking base hook under its lb hold
    rels = ("rpc/controller.py", "rpc/cluster_channel.py", "rpc/channel.py")
    srcs = [_read(r) for r in rels]
    seq = "        with self._lb_lock:\n            self.tried_servers = []"
    tail = ("                cntl._lb_fed.append(ep)\n"
            "        super()._on_attempt_failed(cntl, code, text, ep)\n")
    assert srcs[0].count(seq) == 1 and srcs[1].count(tail) == 1
    mutated = [srcs[0].replace(seq, "        with self._arb_lock, "
                               "self._lb_lock:\n"
                               "            self.tried_servers = []"),
               srcs[1].replace(tail, "                cntl._lb_fed.append("
                               "ep)\n                super()."
                               "_on_attempt_failed(cntl, code, text, ep)\n"),
               srcs[2]]

    def cycles(texts):
        files = [SourceFile(str(PKG / r), f"brpc_tpu_torch/{r}", t)
                 for r, t in zip(rels, texts)]
        return list(LockCycleRule().finalize(Context(files)))
    found = cycles(mutated)
    assert any("Controller._arb_lock" in f.message
               and "Controller._lb_lock" in f.message for f in found), found
    assert cycles(srcs) == []
    # memoryview-release: the ici flush keeps its export
    _fires(MemoryviewReleaseRule(), "transport/ici.py",
           "                    finally:\n"
           "                        mv.release()\n", "", "_wirebuf")


def _walker_tree(tmp: Path, fastcore: str, table: bool = True) -> None:
    (tmp / "native").mkdir(parents=True)
    (tmp / "native" / "fastcore.cc").write_text(fastcore)
    if table:
        (tmp / "protocol").mkdir()
        shutil.copy(PKG / "protocol" / "tpu_std.py",
                    tmp / "protocol" / "tpu_std.py")


def case_judge_defer_table_and_walkers():
    ref = _parse_proto((ROOT / "brpc_tpu" / "protocol" / "proto" /
                        "tpu_rpc_meta.proto").read_text())
    port = _parse_codec(_read("protocol/tpu_std.py"))
    assert port == ref, (port, ref)
    rule = JudgeDeferRule()
    sf = next(f for f in _ctx().files
              if f.relpath == "brpc_tpu_torch/native/src/fastcore.cc")
    assert list(rule.check(sf, _ctx())) == []
    assert rule.examined_cases() > 0, rule.examined
    src = _read("native/src/fastcore.cc")
    with tempfile.TemporaryDirectory() as d:
        # the credits guard and the deadline gate each stripped: fires
        for marker, want in (("s_credits > 0x7FFFFFFFull",
                              "StreamSettings.credits"),
                             ("m->defer_timeout && m->timeout_ms != 0",
                              "RpcRequestMeta.timeout_ms")):
            tree = Path(d) / want
            _walker_tree(tree, src.replace(
                _drop_line("native/src/fastcore.cc", marker), ""))
            active, _ = Analyzer().run([str(tree)])
            assert any(f.rule == "judge-defer" and want in f.message
                       for f in active), [f.format() for f in active]
        # walkers with no table beside them: a finding, not a pass
        tree = Path(d) / "no_table"
        _walker_tree(tree, src, table=False)
        active, _ = Analyzer().run([str(tree)])
        assert [f.rule for f in active] == ["judge-defer"], active
        assert "no field table" in active[0].message


# ------------------------------------------------------- the port's tree

def case_port_tree_is_clean():
    active, waived = Analyzer().run_context(_ctx())
    assert active == [], [f.format() for f in active]
    assert waived and all(f.reason for f in waived), \
        [f.format() for f in waived]
    proc = _cli("--show-waivers", "--format=json", str(PKG))
    assert proc.returncode == 0, proc.stderr
    rows = json.loads(proc.stdout)["waivers"]
    assert rows and all(w["reason"] and w["used"] for w in rows), rows


def case_published_tables():
    doc = (PKG / "analysis" / "INVARIANTS.md").read_text()
    begin = doc.index("<!-- FIELD-GUARDS BEGIN")
    body = doc[doc.index("\n", begin) + 1:doc.index("<!-- FIELD-GUARDS END")]
    assert body.rstrip("\n") == render_field_guards(_ctx()).rstrip("\n"), \
        "INVARIANTS.md's field guards are stale: rerun --field-guards"
    rows = [ln.split("|")[2:4] for ln in doc.splitlines()
            if ln.startswith("| ") and ln.split("|")[1].strip().isdigit()]
    assert [(a.strip().strip("`"), b.strip().strip("`")) for a, b in rows] \
        == racelane.LOCK_ORDER, "INVARIANTS.md's lock table is stale"
    m = get_lock_model(_ctx())
    assert m.cycles() == []
    assert len(m.edges) == PINNED_EDGE_COUNT, sorted(m.edges)
    names = [n for n, _ in racelane.LOCK_ORDER]
    assert len(set(names)) == len(names)
    # brpc_tpu's rows that the port has keep their relative order
    ref = [n for n, _ in REF_LOCK_ORDER]
    assert [n for n in names if n in ref] == [n for n in ref if n in names]
    assert not [n for n in names if n not in m.locks], \
        [n for n in names if n not in m.locks]
    for n, owner in racelane.LOCK_ORDER:
        assert m.locks[n].relpath == f"brpc_tpu_torch/{owner}", (n, owner)
    rank = {n: i for i, n in enumerate(names)}
    for a, b in m.edges:
        if a in UNRANKED_EDGE_ENDS or b in UNRANKED_EDGE_ENDS:
            continue
        assert a in rank and b in rank, (a, b)
        assert rank[a] < rank[b], f"edge {a} -> {b} against LOCK_ORDER"


# ------------------------------------------------------------------- CLI

def case_cli():
    bad = _cli(str(FIXTURES / "bad_iobuf_aliasing.py"))
    assert bad.returncode == 2 and "iobuf-aliasing" in bad.stdout
    four = _cli(str(FIXTURES / "bad_memoryview_release.py"))
    assert four.returncode == 4, four.stdout + four.stderr
    assert _cli(str(FIXTURES / "clean.py")).returncode == 0
    usage = _cli("--rules", "no-such-rule", str(FIXTURES / "clean.py"))
    assert usage.returncode == 120 and "unknown rules" in usage.stderr
    listed = _cli("--list-rules")
    assert listed.returncode == 0
    assert [ln.split()[0] for ln in listed.stdout.splitlines()] == \
        [r.name for r in ref_default_rules()]
    js = _cli("--format=json", str(FIXTURES / "bad_lock_cycle.py"))
    report = json.loads(js.stdout)
    assert js.returncode == len(report["active"]) == 1
    assert report["active"][0]["rule"] == "lock-cycle"
    assert report["files"] == 1 and report["walker_cases"] == 0
    sarif = json.loads(_cli("--format=sarif", str(
        FIXTURES / "bad_memoryview_release.py")).stdout)
    assert sarif["version"] == "2.1.0"
    run = sarif["runs"][0]
    assert run["tool"]["driver"]["name"] == "graftlint"
    ids = {r["id"] for r in run["tool"]["driver"]["rules"]}
    assert len(run["results"]) == 4
    assert all(r["ruleId"] in ids for r in run["results"])
    waived = json.loads(_cli("--format=sarif",
                             str(PKG / "rpc" / "progressive.py")).stdout)
    sup = [r for r in waived["runs"][0]["results"] if r.get("suppressions")]
    assert sup and all(s["suppressions"][0]["justification"] for s in sup)
    with tempfile.TemporaryDirectory() as d:
        base = os.path.join(d, "baseline.json")
        fixture = str(FIXTURES / "bad_guarded_by.py")
        w = _cli(fixture, "--rules", "guarded-by", "--write-baseline", base)
        assert w.returncode == 0, w.stderr
        assert len(json.load(open(base))["findings"]) == 3
        again = _cli(fixture, "--rules", "guarded-by", "--baseline", base,
                     "--json")
        assert again.returncode == 0 and json.loads(again.stdout)[
            "active"] == [], again.stdout
    # the launcher, run by its path from elsewhere
    launched = subprocess.run(
        [sys.executable, str(PKG / "tools" / "graftlint.py"),
         str(FIXTURES / "bad_iobuf_aliasing.py")], cwd=tempfile.gettempdir(),
        capture_output=True, text=True, timeout=120, env=_env())
    assert launched.returncode == 2, launched.stdout + launched.stderr


# -------------------------------------------------------------- racelane

_INSTRUMENTATION = r"""
import json, sys, threading
import brpc_tpu_torch
from brpc_tpu_torch.analysis import racelane
assert "jax" not in sys.modules
armed = racelane.installed()
racelane.uninstall()
real_lock, real_rlock = threading.Lock, threading.RLock
racelane.install(seed=1, perturb=False)
lk = threading.Lock()
swapped = threading.Lock is racelane.DebugLock
with lk:
    held = lk.locked()
racelane.uninstall()
restored = threading.Lock is real_lock and threading.RLock is real_rlock

racelane.install(seed=1, strict=True, perturb=False)
class Holder:
    pass
o = Holder()
o._arb_lock = threading.RLock()
o._lb_lock = threading.Lock()
o._misc_lock = threading.Lock()
names = [o._arb_lock.name, o._lb_lock.name]
ranks = [o._arb_lock.rank, o._lb_lock.rank, o._misc_lock.rank]
with o._arb_lock:
    with o._lb_lock:
        pass
raised = False
with o._lb_lock:
    try:
        o._arb_lock.acquire()
    except racelane.LockOrderViolation:
        raised = True
with o._arb_lock:
    with o._lb_lock:
        pass
cv = threading.Condition(threading.RLock())
hits = []
def waiter():
    with cv:
        hits.append(cv.wait(2.0))
t = threading.Thread(target=waiter)
t.start()
import time
while not hits and t.is_alive():
    with cv:
        cv.notify_all()
    time.sleep(0.01)
t.join(2.0)
racelane.uninstall()
print(json.dumps({"armed": armed, "swapped": swapped, "held": held,
                  "restored": restored, "names": names, "ranks": ranks,
                  "raised": raised, "violations": racelane.violations(),
                  "cv": hits}))
"""

_CONTROLLER = r"""
import json, sys
import brpc_tpu_torch
from brpc_tpu_torch.analysis import racelane
assert racelane.installed() and "jax" not in sys.modules
from brpc_tpu_torch.rpc.controller import Controller
from brpc_tpu_torch.transport.socket import Socket
cntl = Controller()
ranks = {"arb": cntl._arb_lock.rank, "lb": cntl._lb_lock.rank}
with cntl._lb_lock:
    cntl._arb_lock.acquire()
    cntl._arb_lock.release()
print(json.dumps({"ranks": ranks, "names": [cntl._arb_lock.name,
                                            cntl._lb_lock.name],
                  "violations": racelane.violations()}))
"""


def case_racelane_instrumentation():
    doc = _py(_INSTRUMENTATION, env=_env(BRPC_TPU_TORCH_LOCK_DEBUG="1"))
    assert doc["armed"] and doc["swapped"] and doc["held"], doc
    assert doc["restored"], doc
    assert [n.split(":")[1] for n in doc["names"]] == [
        "_arb_lock", "_lb_lock"], doc
    rank = {n: i for i, (n, _) in enumerate(racelane.LOCK_ORDER)}
    assert doc["ranks"] == [rank["Controller._arb_lock"],
                            rank["Controller._lb_lock"], None], doc
    assert doc["raised"], doc
    v = doc["violations"]
    assert len(v) == 1 and v[0]["acquiring"] == "Controller._arb_lock" \
        and v[0]["holding"] == "Controller._lb_lock", v
    assert doc["cv"] == [True], doc
    # the hook arms only under the variable, and imports nothing else
    off = _py("import json, sys\nimport brpc_tpu_torch\n"
              "print(json.dumps({'rl': 'brpc_tpu_torch.analysis.racelane'"
              " in sys.modules, 'torch': 'torch' in sys.modules}))")
    assert off == {"rl": False, "torch": False}, off


def case_racelane_controller_locks_rank():
    doc = _py(_CONTROLLER, env=_env(BRPC_TPU_TORCH_LOCK_DEBUG="1"))
    rank = {n: i for i, (n, _) in enumerate(racelane.LOCK_ORDER)}
    assert doc["ranks"] == {"arb": rank["Controller._arb_lock"],
                            "lb": rank["Controller._lb_lock"]}, doc
    v = doc["violations"]
    assert v and v[0]["acquiring"] == "Controller._arb_lock" \
        and v[0]["holding"] == "Controller._lb_lock", v


_TEARDOWN = r"""
import json, sys, threading, time
import brpc_tpu_torch
from brpc_tpu_torch.analysis import racelane
from brpc_tpu_torch.fiber.scheduler import TaskControl
assert "jax" not in sys.modules

class BuggyTC(TaskControl):
    # the teardown without its lock: the pool claimed and cleared, and
    # the flags dropped, outside any critical section
    def stop_and_join(self, timeout: float = 5.0) -> None:
        self._stop = True
        threads = list(self._threads)
        self._threads.clear()
        for _ in threads:
            self.parking_lot.signal(len(threads))
        for t in threads:
            t.join(timeout)
        self._started = False
        self._stop = False

def storm(cls, seed):
    made = []
    def setup():
        tc = cls(concurrency=2, name="guardrepro_tc")
        made.append(tc)
        return tc
    def starter(tc):
        for _ in range(6):
            tc.start()
            time.sleep(0)
    def stopper(tc):
        for _ in range(6):
            tc.stop_and_join(timeout=2.0)
    def check(tc):
        with tc._start_lock:
            started = tc._started
            alive = [t for t in tc._threads if t.is_alive()]
        assert not started or alive, "pool claims started with no live worker"
    try:
        return racelane.replay_field_race(
            setup, starter, stopper,
            [f"{cls.__name__}.stop_and_join", "TaskControl.start"],
            seed=seed, check=check)
    finally:
        # a raced buggy claim orphans workers with _stop reset
        for tc in made:
            TaskControl.stop_and_join(tc, timeout=2.0)
            tc._stop = True
            tc.parking_lot.signal(64)
        for t in threading.enumerate():
            if t.name.startswith("guardrepro_tc_w"):
                t.join(3.0)

out = {"raced": [], "evidence": [], "fixed": [], "yields": []}
for seed in range(SEEDS):
    r = storm(BuggyTC, seed)
    out["yields"].append(r["site_yields"])
    if not r["ok"]:
        out["raced"].append(seed)
        out["evidence"] += r["evidence"]
    f = storm(TaskControl, seed)
    if not (f["ok"] and f["completed"]):
        out["fixed"].append([seed, f])
out["leaked"] = [t.name for t in threading.enumerate()
                 if t.name.startswith("guardrepro_tc_w")]
print(json.dumps(out))
""".replace("SEEDS", "32")


def case_racelane_teardown_race():
    runs = [_py(_TEARDOWN, env=_env(BRPC_TPU_TORCH_LOCK_DEBUG="1"))
            for _ in range(2)]
    for doc in runs:
        assert len(doc["raced"]) >= 2, doc
        assert doc["fixed"] == [], doc["fixed"]
        assert doc["leaked"] == [], doc["leaked"]
        assert all("cannot join thread" in e or "claims started" in e
                   for e in doc["evidence"]), doc["evidence"]
    # the same seeds race, with the same schedule, in both processes
    assert runs[0]["raced"] == runs[1]["raced"], runs
    assert runs[0]["yields"] == runs[1]["yields"], runs


def test_graftlint():
    _run_cases([
        ("the same findings on every fixture",
         case_same_findings_on_fixtures, ()),
        ("mutations fire on the port's files",
         case_mutations_fire_on_port_files, ()),
        ("judge-defer's table and walkers",
         case_judge_defer_table_and_walkers, ()),
        ("the port's tree is clean", case_port_tree_is_clean, ()),
        ("the published tables", case_published_tables, ()),
        ("the CLI", case_cli, ()),
        ("racelane: install, naming, the strict assert",
         case_racelane_instrumentation, ()),
        ("racelane: the Controller's locks rank at runtime",
         case_racelane_controller_locks_rank, ()),
        ("racelane: the teardown race, seed for seed",
         case_racelane_teardown_race, ()),
    ], limit_s=120.0)
