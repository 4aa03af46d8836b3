"""The port's shard groups and postfork registry against brpc_tpu's, on
the CPU.

- The registry (``butil/postfork.py``) against ``brpc_tpu.butil.
  postfork``: registering a name again replaces its callback, the
  generation is 0 in the parent and 1 in a forked child, and a
  ``subprocess`` spawn runs no reset.
- Every module of the port that defines a ``_postfork_reset`` registers
  it (an AST walk), and the port's names cover brpc_tpu's registrations
  for every module the port has.
- A forked child rebuilds the scheduler, timer, dispatcher, span store
  and census lock, leaves its parent's untouched, and serves an RPC.
  A module that caches an ``InputMessenger``, a ``global_control()`` or
  a dispatcher registers a reset (``rpc/channel.py``'s client messenger
  among them), and a child forked after its parent's burst gets every
  one of its own 400 calls on the pure-Python lane.
- The merges (``merge_var_values``, ``_merge_stat_dict``, pooled
  percentiles, torn and missing dumps, ``merge_timeline_states``,
  ``merge_dump_states``, ``merge_device_payloads``) give brpc_tpu's
  results on the same inputs, and brpc_tpu's aggregator reads a dump the
  port wrote.
- A 2-shard echo group through the port's runner
  (``python -m brpc_tpu_torch.tools.shard_server``): connections spread,
  a shard killed mid-burst costs its siblings' connections no call and
  is restarted, a stopped shard is replaced, the merged ``/vars`` is the
  sum of the ``?shard=i`` views, ``/status``, ``/shards`` and the
  Prometheus dump answer, and a stop drains.
- ``Generate`` on 2 shards with ``device="cpu"`` gives brpc_tpu's
  tokens.
- A supervisor with the default device (``cuda:0``) makes no CUDA call
  before or after it forks; its shards fail loudly here, without a card.
- A shard that finds itself forked from a process that made a CUDA call
  exits with ``EXIT_CUDA_BAD_FORK``, and the group fails at once: no
  restart, every shard stopped, ``/shards`` naming the cause, and
  ``run_until_asked_to_quit`` returning by itself.
- ``num_shards`` needs tcp, and 1 is a plain start;
  ``run_until_asked_to_quit`` writes and removes its pidfile on SIGTERM
  as brpc_tpu's does.

Every fork happens in a subprocess that imports ``brpc_tpu_torch`` and
never ``jax`` (the runner, or a ``python -c`` script): this test worker
holds JAX's threads. The cases run inside one collected test
(``_run_cases`` of test_torch_cluster.py), each under a time limit of
its own; a case fails if it leaves a group process, a socket registered
with the port's dispatcher, or one of the port's loop threads behind.
"""

import ast
import http.client
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import brpc_tpu.rpc as ref_rpc
from brpc_tpu.builtin import flight_recorder as ref_fr
from brpc_tpu.bvar import series as ref_series
from brpc_tpu.rpc import shard_group as ref_sg
from brpc_tpu.serving import add_generate_service as ref_add_generate_service
from brpc_tpu.transport import device_stats as ref_ds

import brpc_tpu_torch.rpc as port_rpc
from brpc_tpu_torch.builtin import flight_recorder as port_fr
from brpc_tpu_torch.bvar import series as port_series
from brpc_tpu_torch.rpc import errno_codes as berr
from brpc_tpu_torch.rpc import shard_group as port_sg
from brpc_tpu_torch.tools.spawn_util import spawn_announcing_server
from brpc_tpu_torch.transport import device_stats as port_ds
from test_torch_cluster import _run_cases, _wait_for

ROOT = Path(__file__).resolve().parent.parent
PORT_PKG = ROOT / "brpc_tpu_torch"
REF_PKG = ROOT / "brpc_tpu"
# brpc_tpu's registrations whose state lives elsewhere in the port: the
# call pool of brpc_tpu's rpc/controller.py is rpc/client_dispatch.py's
MOVED = {"rpc.controller": "rpc.client_dispatch"}
TRANSPORT_ERRORS = {berr.EFAILEDSOCKET, berr.ECLOSE, berr.ELOGOFF}
PROMPTS = ["shard", "the quick brown fox", "b", "kernel launches",
           "SO_REUSEPORT", "0123456789"]
GEN_TOKENS = 8


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.update(extra)
    return env


def _py(code: str, *args, timeout=60, env=None):
    """Run ``code`` in a fresh interpreter (no jax there); its last
    stdout line as JSON, and its stderr."""
    out = subprocess.run([sys.executable, "-c", code, *args],
                         capture_output=True, text=True, timeout=timeout,
                         cwd=str(ROOT), env=env or _env())
    assert out.returncode == 0, f"rc {out.returncode}:\n{out.stderr[-3000:]}"
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


def _processes_with(token: str) -> list:
    """Live processes whose command line holds ``token``."""
    found = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read().decode("utf-8", "replace")
            with open(f"/proc/{d}/stat") as f:
                state = f.read().rsplit(")", 1)[1].split()[0]
        except OSError:
            continue
        if token in cmd and state != "Z":
            found.append(int(d))
    return found


class _Group:
    """A shard group through the port's runner, its shard directory a
    fresh one (every process of the group carries it on its command
    line, which is how a leftover is found)."""

    def __init__(self, root: str, shards: int = 2, generate=False,
                 extra=()):
        self.dir = tempfile.mkdtemp(prefix="group-", dir=root)
        self.err = open(os.path.join(self.dir, "stderr"), "w+")
        argv = ["-m", "brpc_tpu_torch.tools.shard_server", "--shards",
                str(shards), "--shard-dir", self.dir, "--dump-interval",
                "0.1", *extra]
        if generate:
            argv += ["--generate", "--device", "cpu"]
        self.proc, got = spawn_announcing_server(
            argv, 60, keys=("ADMIN", "PORT"), env=_env(), stderr=self.err)
        assert got, f"group never came up: {self.stderr()}"
        self.port, self.admin = got["PORT"], got["ADMIN"]
        self.chans = []

    def stderr(self) -> str:
        self.err.seek(0)
        return self.err.read()[-3000:]

    def get(self, path: str, port=None):
        c = http.client.HTTPConnection("127.0.0.1", port or self.admin,
                                       timeout=10)
        try:
            c.request("GET", path)
            r = c.getresponse()
            return r.status, r.read()
        finally:
            c.close()

    def json(self, path: str):
        status, body = self.get(path)
        assert status == 200, (path, status, body[:300])
        return json.loads(body)

    def channel(self):
        # a connection of its own: the kernel deals each new one to a shard
        ch = port_rpc.Channel(f"tcp://127.0.0.1:{self.port}",
                              port_rpc.ChannelOptions(
                                  timeout_ms=4000, max_retry=3,
                                  share_connections=False))
        self.chans.append(ch)
        return ch

    def chans_by_pid(self, want: int = 2, limit: int = 32) -> dict:
        """Channels until connections landed on ``want`` shards."""
        by_pid = {}
        for _ in range(limit):
            ch = self.channel()
            by_pid.setdefault(_pid_of(ch), []).append(ch)
            if len(by_pid) >= want:
                break
        assert len(by_pid) >= want, f"{len(by_pid)} shards reached"
        return by_pid

    def running_pids(self) -> list:
        return [s["pid"] for s in self.json("/shards")["group"]["shards"]
                if s["state"] == "running"]

    def close(self) -> int:
        for ch in self.chans:
            ch.close()
        self.chans = []
        rc = None
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(30)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait(10)
            self.proc.stdout.close()
            self.err.close()
        assert _wait_for(lambda: not _processes_with(self.dir), 10), \
            f"group processes left: {_processes_with(self.dir)}"
        return rc

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _pid_of(ch) -> int:
    c = ch.call_sync("Bench", "Pid", b"")
    assert not c.failed(), c.error_text
    return int(c.response)


def _shard_sum(g: _Group, name: str, shards: int = 2):
    vals = []
    for i in range(shards):
        _, body = g.get(f"/vars?prefix={name}&shard={i}")
        vals.append(_var_line(body, name))
    return vals


def _var_line(body: bytes, name: str):
    for ln in body.decode().splitlines():
        n, _, v = ln.partition(" : ")
        if n == name:
            return json.loads(v)
    return None


# ------------------------------------------------------------ registry

_REGISTRY_SCRIPT = r"""
import json, os, subprocess, sys
from brpc_tpu_torch.butil import postfork as port_pf
from brpc_tpu.butil import postfork as ref_pf
assert "jax" not in sys.modules
out = {}
for side, pf in (("port", port_pf), ("ref", ref_pf)):
    hits = []
    pf.register("test.dup", lambda h=hits: h.append(1))
    pf.register("test.dup", lambda h=hits: h.append(2))
    doc = {"count": pf.registered_names().count("test.dup"),
           "parent_generation": pf.generation()}
    subprocess.run([sys.executable, "-c", "pass"], check=True)
    doc["after_spawn"] = [pf.generation(), list(hits)]
    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:
        os.write(w, json.dumps([pf.generation(), hits,
                                pf.reset_errors()]).encode())
        os._exit(0)
    os.close(w)
    doc["child"] = json.loads(os.read(r, 65536))
    os.close(r)
    os.waitpid(pid, 0)
    doc["parent_after"] = [pf.generation(), list(hits)]
    out[side] = doc
print(json.dumps(out))
"""


def case_registry_against_reference():
    doc, _ = _py(_REGISTRY_SCRIPT)
    port, ref = doc["port"], doc["ref"]
    assert port == ref, (port, ref)
    assert port["count"] == 1
    assert port["parent_generation"] == 0
    assert port["after_spawn"] == [0, []], "a spawn ran a reset"
    # the child ran the replacing callback once, no other reset failed
    gen, hits, errors = port["child"]
    assert gen == 1 and hits == [2], port["child"]
    assert not [e for e in errors if "test.dup" in e]
    assert port["parent_after"] == [0, []]


def _register_calls(path: Path):
    """{registered name: function name} of ``postfork.register`` calls in
    a module."""
    out = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "register" \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id in ("postfork", "_postfork"):
            fn = node.args[1]
            out[node.args[0].value] = getattr(fn, "id", None) or \
                ast.unparse(fn)
    return out


_PROCESS_STATE_CALLS = {"InputMessenger", "global_control",
                        "global_dispatcher", "global_ring_dispatcher"}


def _cached_process_state(tree) -> set:
    """Module globals a function stores an ``InputMessenger``, a
    ``global_control()`` or a dispatcher in: state that holds the
    threads of the process that made it."""
    out = set()
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        names = {n for g in ast.walk(fn) if isinstance(g, ast.Global)
                 for n in g.names}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call):
                f = node.value.func
                callee = getattr(f, "id", None) or getattr(f, "attr", None)
                for t in node.targets:
                    if isinstance(t, ast.Name) and t.id in names and \
                            callee in _PROCESS_STATE_CALLS:
                        out.add(t.id)
    return out


def case_every_module_registered():
    port_names = {}
    for path in sorted(PORT_PKG.rglob("*.py")):
        tree = ast.parse(path.read_text())
        resets = {n.name for n in tree.body
                  if isinstance(n, ast.FunctionDef)
                  and n.name.startswith("_postfork_reset")}
        regs = _register_calls(path)
        missing = resets - set(regs.values())
        assert not missing, f"{path}: {missing} not registered"
        cached = _cached_process_state(tree)
        assert not cached or regs, \
            f"{path}: caches {sorted(cached)} with no postfork reset"
        for name in regs:
            assert name not in port_names, f"{name} twice"
            port_names[name] = path
    ref_regs = {}
    for path in sorted(REF_PKG.rglob("*.py")):
        if "analysis" in path.parts:
            continue
        for name in _register_calls(path):
            ref_regs[name] = path
    assert len(ref_regs) >= 28, sorted(ref_regs)
    # the client messenger's cache holds its maker's TaskControl
    assert port_names.get("rpc.channel") == PORT_PKG / "rpc" / "channel.py"
    for name, path in ref_regs.items():
        if not (PORT_PKG / path.relative_to(REF_PKG)).exists():
            continue                # brpc_tpu's module not ported yet
        assert MOVED.get(name, name) in port_names, \
            f"brpc_tpu registers {name} ({path}); the port does not"
    # and at run time: importing the modules registers them
    doc, _ = _py(r"""
import importlib, json, pkgutil, sys
import brpc_tpu_torch
for m in pkgutil.walk_packages(brpc_tpu_torch.__path__, "brpc_tpu_torch."):
    importlib.import_module(m.name)
assert "jax" not in sys.modules
from brpc_tpu_torch.butil import postfork
print(json.dumps(postfork.registered_names()))
""")
    assert set(port_names) <= set(doc), set(port_names) - set(doc)


_CHILD_SCRIPT = r"""
import json, os, sys, threading
from brpc_tpu_torch.butil import postfork, resource_census
from brpc_tpu_torch.fiber.scheduler import global_control
from brpc_tpu_torch.fiber.timer import global_timer
from brpc_tpu_torch.rpc import Channel, ChannelOptions, Server, Service
from brpc_tpu_torch.rpc.span import global_collector, global_store
from brpc_tpu_torch.transport.event_dispatcher import global_dispatcher
assert "jax" not in sys.modules

def singletons():
    return {"control": global_control(), "timer": global_timer(),
            "dispatcher": global_dispatcher(),
            "store_lock": global_store._lock,
            "collector_lock": global_collector._lock,
            "census_lock": resource_census._lock}

def same(a, b):
    return all(a[k] is b[k] for k in a)

def serve_one():
    srv = Server()
    svc = Service("Svc")
    svc.register_method("Echo", lambda cntl, req: bytes(req))
    srv.add_service(svc)
    ep = srv.start("tcp://127.0.0.1:0")
    ch = Channel(str(ep), ChannelOptions(timeout_ms=5000))
    try:
        c = ch.call_sync("Svc", "Echo", b"across the fork")
        return None if c.failed() else bytes(c.response).decode()
    finally:
        ch.close()
        srv.stop()
        srv.join(5)

# the parent's machinery is live: a served call made it all. The
# child compares objects, not ids: ``parent`` keeps the old ones alive,
# so a rebuilt singleton cannot take a freed one's address
first = serve_one()
parent = singletons()
r, w = os.pipe()
pid = os.fork()
if pid == 0:
    try:
        child = singletons()
        doc = {"generation": postfork.generation(),
               "errors": postfork.reset_errors(),
               "fresh": sorted(k for k in parent if child[k] is not parent[k]),
               "census": sorted(resource_census.snapshot()),
               "served": serve_one()}
    except BaseException as e:
        doc = {"exc": repr(e)}
    os.write(w, json.dumps(doc).encode())
    os._exit(0)
os.close(w)
child = json.loads(os.read(r, 1 << 20))
os.close(r)
os.waitpid(pid, 0)
print(json.dumps({"first": first, "child": child,
                  "parent_kept": same(singletons(), parent),
                  "parent_generation": postfork.generation(),
                  "served_after": serve_one()}))
"""


# A child forked after its parent used a Channel: the client messenger
# the parent cached holds the parent's TaskControl, whose workers do not
# exist in the child, so the responses a burst spills past the inline
# budget would queue where nothing runs them (the pure-Python lane)
_FORK_BURST_SCRIPT = r"""
import json, os, sys, threading
from brpc_tpu_torch.rpc import Channel, ChannelOptions, Server, Service
assert "jax" not in sys.modules
CALLS = 400

def burst():
    srv = Server()
    svc = Service("Svc")
    svc.register_method("Echo", lambda cntl, req: bytes(req))
    srv.add_service(svc)
    ep = srv.start("tcp://127.0.0.1:0")
    ch = Channel(str(ep), ChannelOptions(timeout_ms=3000, max_retry=0,
                                         share_connections=False))
    try:
        cntls = [ch.call("Svc", "Echo", b"%d" % i) for i in range(CALLS)]
        ok = 0
        for i, c in enumerate(cntls):
            c.join()
            ok += (not c.failed()) and bytes(c.response) == b"%d" % i
        return ok
    finally:
        ch.close()
        srv.stop()
        srv.join(5)

parent_ok = burst()
r, w = os.pipe()
pid = os.fork()
if pid == 0:
    try:
        doc = {"ok": burst()}
    except BaseException as e:
        doc = {"exc": repr(e)}
    os.write(w, json.dumps(doc).encode())
    os._exit(0)
os.close(w)
child = json.loads(os.read(r, 1 << 20))
os.close(r)
os.waitpid(pid, 0)
print(json.dumps({"parent": parent_ok, "child": child}))
"""


def case_forked_child_keeps_its_calls():
    doc, _ = _py(_FORK_BURST_SCRIPT, timeout=90,
                 env=_env(BRPC_TPU_TORCH_NO_NATIVE="1"))
    assert doc["parent"] == 400, doc
    assert doc["child"] == {"ok": 400}, doc


def case_forked_child_rebuilds():
    doc, _ = _py(_CHILD_SCRIPT)
    child = doc["child"]
    assert "exc" not in child, child
    assert child["generation"] == 1 and not child["errors"], child
    assert child["fresh"] == sorted(["control", "timer", "dispatcher",
                                     "store_lock", "collector_lock",
                                     "census_lock"]), child["fresh"]
    assert "sockets" in child["census"], child["census"]
    assert child["served"] == "across the fork"
    assert doc["first"] == doc["served_after"] == "across the fork"
    assert doc["parent_kept"] and doc["parent_generation"] == 0


# -------------------------------------------------------------- merges

def _timeline_state(seed: int) -> dict:
    t0 = 1_700_000_040 + seed
    return {
        "enabled": True,
        "series": {
            "server_processed": {
                "kind": "delta", "sec": [[t0 + i, 3 * i + seed]
                                         for i in range(5)],
                "min": [[t0 - 60, 100 + seed]], "hr": []},
            "server_concurrency_limit": {
                "kind": "last", "sec": [[t0 + i, 8 + seed] for i in range(3)],
                "min": [], "hr": []},
            "dispatcher_stall_ms_max_10s": {
                "kind": "max", "sec": [[t0, 1.5 * seed], [t0 + 1, 0.25]],
                "min": [], "hr": []},
            "serving_ttft_us": {
                "kind": "quantile",
                "sec": [[t0, {"count": 4 + seed, "p50": 100.0 + seed,
                              "p99": 300.0 - seed, "max": 400.0}]],
                "min": [], "hr": []},
        },
        "incidents": [{"opened_t": t0 - seed, "key": "server_limit_shed"}],
        "watch_keys": ["server_limit_shed", f"k{seed}"],
    }


def _device_payload(seed: int) -> dict:
    return {
        "enabled": True,
        "cells": {
            "tcp://h:1|cudad": {
                "transfers": 5 + seed, "completed": 4 + seed, "failed": 1,
                "bytes_out": 1000 * seed, "max_latency_us": 50.0 + seed,
                "stage_us_sum": 10.0, "wire_us_sum": 20.0 * seed,
                "ack_us_sum": 5.0,
                "latency_samples": [float(x) for x in range(seed, 300, 2)]},
            f"tcp://h:{seed}|ici": {"transfers": 1, "completed": 1,
                                   "latency_samples": [7.0]}},
        "totals": {"transfers": 6 + seed, "bytes_out": 1000 * seed},
        "conns": [{"peer": f"p{seed}"}],
        "transfer_lane": ["not loaded", "up", "down: x"][seed % 3],
        "leaks": {"leaked_bytes": seed, "epochs": 1},
    }


def _hotspot_state(seed: int) -> dict:
    return {"folded": {"a;b": 3 + seed, f"c;{seed}": 1},
            "labels": {"Svc.Echo": 2 + seed, "idle": seed},
            "nsamples": 10 * seed, "nbusy": 4 + seed, "windows": seed,
            "span_s": 1.5 * seed, "stall_ms_max_10s": 0.5 * seed}


def _jsonish(x):
    return json.loads(json.dumps(x, default=str, sort_keys=True))


def _synthetic_dump(i: int) -> dict:
    lat = {"count": 10 * (i + 1), "qps": 5 + i, "latency_avg_us": 100.0 * i,
           "latency_max_us": 900.0 + i, "latency_p99_us": 500.0 + i}
    return {
        "shard": i, "pid": 1000 + i, "seq": 3, "time": 1.0,
        "vars": {"server_processed": 10 * (i + 1),
                 "server_concurrency_limit": 4 + i,
                 "iobuf_pool_hit_ratio": 0.5 + 0.25 * i,
                 "retry_tokens_min": [-1, 7][i % 2],
                 "dispatcher_stall_ms_max_10s": 1.5 * i,
                 "version": f"v{i}",
                 "Svc.Echo": lat},
        "status": {"processed": 10 * (i + 1), "errors": i,
                   "concurrency": i, "services": {"Svc": ["Echo"]},
                   "method_status": {"Svc.Echo": lat},
                   "saturation": {"busy_fraction": 0.1 * i,
                                  "runqueue_peak": 3 + i,
                                  "concurrency_limit": 4 + i}},
        "latency_samples": {"Svc.Echo": [float(x) for x in
                                         range(i, 400, 3 + i)]},
        "hotspots": _hotspot_state(i + 1),
        "census": {"subsystems": {"sockets": {"bytes": 10 * i, "count": i},
                                  "iobuf_pool": {"hit_ratio": 0.5 * i}},
                   "total_bytes": 100 + i,
                   "connections": {"count": i, "bytes": 7}},
        "serving": {"enabled": True, "waiting": i, "completed": 3 + i,
                    "tokens_out": 24 * (i + 1), "decode_steps": 9 + i,
                    "running": [{"req_id": i}], "batch_size_hist": {"1": i},
                    "kv_occupancy": 0.25 * i},
        "device": _device_payload(i + 1),
        "timeline": _timeline_state(i + 1),
        "capture": {"active": bool(i), "written": i, "pid": 1000 + i,
                    "files": [{"path": f"/nonexistent/c{i}.rio"}]},
        "incidents": {"enabled": True, "open": i, "total": 2 + i,
                      "artifact_bytes": 100 * i,
                      "artifacts": [{"opened_t": 5 - i, "path": f"a{i}"}]},
    }


def case_merges_against_reference():
    values = [[1, 2, 3], [0.5, 0.25], [{"count": 2, "qps": 1.5,
                                        "latency_p50_us": 10.0},
                                       {"count": 6, "qps": 0.5,
                                        "latency_p50_us": 30.0}],
              ["a", "b"], [True, 1], [], [-1, 3, -1], [-1, -1]]
    names = ["", "x_limit", "admission_threshold", "retry_tokens_min",
             "hit_ratio", "busy_pct", "peak_depth", "lat_max", "a_max_10s"]
    for vs in values:
        for n in names:
            assert _jsonish(port_sg.merge_var_values(vs, n)) == \
                _jsonish(ref_sg.merge_var_values(vs, n)), (vs, n)
    dicts = [{"count": 3, "qps": 1, "max_x": 4, "limit": 2,
              "retry_tokens": 5, "latency_avg_us": 10.0, "p99": 7.0,
              "s": "k", "busy_fraction": 0.2, "other": 1},
             {"count": 1, "qps": 2, "max_x": 9, "limit": 1,
              "retry_tokens": 3, "latency_avg_us": 30.0, "p99": 3.0,
              "s": "z", "busy_fraction": 0.6, "other": 2}]
    assert port_sg._merge_stat_dict(dicts) == ref_sg._merge_stat_dict(dicts)
    # brpc_tpu takes the min of any name holding "tokens" (ROADMAP section
    # 3): a counter of generated tokens sums in the port
    assert port_sg.merge_var_values([256, 256], "serving_tokens") == 512
    assert ref_sg.merge_var_values([256, 256], "serving_tokens") == 256
    assert port_sg._merge_stat_dict([{"tokens_out": 3}, {"tokens_out": 4}]) \
        == {"tokens_out": 7}
    assert port_sg._merge_stat_dict([{"fraction": 0.5}, {"fraction": 1.0}]) \
        == ref_sg._merge_stat_dict([{"fraction": 0.5}, {"fraction": 1.0}])
    for r in (0.0, 0.5, 0.99, 1.0):
        s = sorted(float(x) for x in range(37))
        assert port_sg._percentile(s, r) == ref_sg._percentile(s, r)
        assert port_sg._percentile([], r) == ref_sg._percentile([], r)

    states = [(i, _timeline_state(i)) for i in (1, 2, 3)]
    for kw in ({}, {"names": ["server_processed", "serving_ttft_us"]},
               {"prefix": "server_"}):
        assert _jsonish(port_series.merge_timeline_states(states, **kw)) \
            == _jsonish(ref_series.merge_timeline_states(states, **kw)), kw
    hs = [_hotspot_state(i) for i in (1, 2, 5)]
    assert _jsonish(port_fr.merge_dump_states(hs)) == \
        _jsonish(ref_fr.merge_dump_states(hs))
    dev = [_device_payload(i) for i in (1, 2, 3, 4)]
    assert _jsonish(port_ds.merge_device_payloads(dev)) == \
        _jsonish(ref_ds.merge_device_payloads(dev))
    assert _jsonish(port_ds.merge_device_payloads([])) == \
        _jsonish(ref_ds.merge_device_payloads([]))

    with tempfile.TemporaryDirectory() as d:
        for i in (0, 1, 3):
            with open(os.path.join(d, f"shard-{i}.json"), "w") as f:
                json.dump(_synthetic_dump(i), f)
        # a torn dump (shard 2's write cut short) and a missing one (4)
        with open(os.path.join(d, "shard-2.json"), "w") as f:
            f.write(json.dumps(_synthetic_dump(2))[:200])
        aggs = [port_sg.ShardAggregator(d, 5), ref_sg.ShardAggregator(d, 5)]
        dumps = [a.read_dumps() for a in aggs]
        assert dumps[0] == dumps[1] and \
            [x["shard"] for x in dumps[0]] == [0, 1, 3]
        assert aggs[0].shard_dump(2) is None and aggs[0].shard_dump(4) is None
        for fn in ("merged_vars", "merged_method_status", "merged_serving",
                   "merged_device", "merged_timeline", "merged_capture",
                   "merged_incidents", "merged_census", "merged_hotspots",
                   "capture_paths", "prometheus_text"):
            got = [_jsonish(getattr(a, fn)()) for a in aggs]
            assert got[0] == got[1], (fn, got)
        st = [a.merged_status() for a in aggs]
        for s in st:
            for row in s["shard_breakdown"].values():
                row.pop("heartbeat_age_s")
        assert _jsonish(st[0]) == _jsonish(st[1])
        m = aggs[0].merged_method_status()["Svc.Echo"]
        pooled = sorted(x for dd in dumps[0]
                        for x in dd["latency_samples"]["Svc.Echo"])
        assert m["latency_p99_us"] == round(
            port_sg._percentile(pooled, 0.99), 1)


def case_port_dump_read_by_reference():
    srv = port_rpc.Server()
    svc = port_rpc.Service("Svc")
    svc.register_method("Echo", lambda cntl, req: bytes(req))
    srv.add_service(svc)
    ep = srv.start("tcp://127.0.0.1:0")
    ch = port_rpc.Channel(str(ep), port_rpc.ChannelOptions(timeout_ms=5000))
    try:
        for i in range(7):
            assert not ch.call_sync("Svc", "Echo", b"x" * i).failed()
        with tempfile.TemporaryDirectory() as d:
            port_sg.write_shard_dump(d, 0, srv, 1)
            ref = ref_sg.ShardAggregator(d, 1)
            port = port_sg.ShardAggregator(d, 1)
            st = ref.merged_status()
            assert st["shards_reporting"] == 1 and st["processed"] == 7, st
            assert st["method_status"]["Svc.Echo"]["count"] == 7
            assert st["method_status"]["Svc.Echo"]["latency_p50_us"] > 0
            assert ref.merged_vars("server_processed") == \
                port.merged_vars("server_processed") == \
                {"server_processed": 7}
            assert ref.merged_census()["shards_reporting"] == 1
            assert _jsonish(ref.merged_hotspots()) == \
                _jsonish(port.merged_hotspots())
    finally:
        ch.close()
        srv.stop()
        srv.join(5)


# --------------------------------------------------------- echo groups

def case_echo_group_views_and_drain(root):
    g = _Group(root)
    try:
        by_pid = g.chans_by_pid(2)
        assert set(by_pid) == set(g.running_pids())
        # each channel's Pid call counts too: the views settle at the
        # total once every shard's latest dump holds its last call
        calls = sum(len(chans) for chans in by_pid.values())
        for chans in by_pid.values():
            for ch in chans:
                for k in range(5):
                    c = ch.call_sync("Bench", "PyEcho", b"%d" % k)
                    assert not c.failed() and c.response == b"%d" % k
                    calls += 1

        def merged_equals_sum():
            merged = _var_line(g.get("/vars?prefix=server_processed")[1],
                               "server_processed")
            parts = _shard_sum(g, "server_processed")
            return merged is not None and None not in parts \
                and merged == sum(parts) and merged >= calls
        assert _wait_for(merged_equals_sum, 5), (
            g.get("/vars?prefix=server_processed"),
            _shard_sum(g, "server_processed"))
        st = g.json("/status")
        assert st["mode"] == "shard_group" and st["shards_reporting"] == 2
        assert st["processed"] == sum(
            g.json(f"/status?shard={i}")["processed"] for i in range(2))
        assert {int(r["pid"]) for r in st["shard_breakdown"].values()} \
            == set(by_pid)
        assert "Bench.PyEcho" in st["method_status"]
        sh = g.json("/shards")
        assert sh["shards"] == 2 and \
            {s["pid"] for s in sh["group"]["shards"]} == set(by_pid)
        prom = g.get("/brpc_metrics")[1].decode()
        assert any(ln.startswith("server_processed ") for ln in
                   prom.splitlines()), prom[:500]
        assert g.get("/status?shard=2")[0] == 400
        assert g.get("/vars?shard=x")[0] == 400
        # a shard's own data port has no group view
        assert g.get("/shards", port=g.port)[0] == 404
        assert g.json("/census")["shards_reporting"] == 2
        assert g.json("/hotspots?mode=continuous&format=json")[
            "shards_reporting"] == 2
        # stop drains: every process exits, each shard's last dump counts
        # every call it served
        before = {i: g.json(f"/status?shard={i}")["processed"]
                  for i in range(2)}
    finally:
        rc = g.close()
    assert rc == 0, g.stderr()
    agg = port_sg.ShardAggregator(g.dir, 2)
    last = {d["shard"]: d["status"]["processed"] for d in agg.read_dumps()}
    assert all(last[i] >= before[i] for i in range(2)), (last, before)
    assert sum(last.values()) >= calls


def case_group_of_one(root):
    """``--group --shards 1``: one shard under a supervisor, with the
    dump loop's cost counted in the shard's own ``/vars``."""
    with _Group(root, shards=1, extra=("--group",)) as g:
        ch = g.channel()
        pid = _pid_of(ch)
        assert g.running_pids() == [pid] and pid != g.proc.pid
        for k in range(5):
            c = ch.call_sync("Bench", "PyEcho", b"%d" % k)
            assert not c.failed() and c.response == b"%d" % k

        def costs():
            got = {n: _shard_sum(g, n, shards=1)[0] for n in
                   ("shard_dumps", "shard_dump_cpu_us",
                    "shard_dump_wall_us")}
            return got if got["shard_dumps"] and got["shard_dumps"] >= 2 \
                else None
        assert _wait_for(costs, 5), g.get("/vars?prefix=shard_&shard=0")
        got = costs()
        assert got["shard_dump_wall_us"] > 0 and \
            got["shard_dump_cpu_us"] > 0, got
        assert g.json("/status")["shards_reporting"] == 1
    assert g.proc.returncode == 0, g.stderr()


def case_echo_group_kill_mid_burst(root):
    with _Group(root, extra=("--restart-backoff", "0.2")) as g:
        by_pid = g.chans_by_pid(2)
        victim = sorted(by_pid)[0]
        survivors = [c for p, v in by_pid.items() if p != victim for c in v]
        victims = by_pid[victim]
        errors, victim_errors, done = [], [], threading.Event()

        def survivor_loop(ch):
            while not done.is_set():
                c = ch.call_sync("Bench", "PyEcho", b"s")
                if c.failed():
                    errors.append((c.error_code, c.error_text))

        def victim_loop(ch):
            while not done.is_set():
                c = ch.call_sync("Bench", "PyEcho", b"v")
                if c.failed():
                    victim_errors.append(c.error_code)
        threads = [threading.Thread(target=survivor_loop, args=(c,))
                   for c in survivors] + \
            [threading.Thread(target=victim_loop, args=(c,))
             for c in victims]
        for t in threads:
            t.start()
        time.sleep(0.3)
        os.kill(victim, signal.SIGKILL)
        t_kill = time.monotonic()
        time.sleep(1.5)
        done.set()
        for t in threads:
            t.join(10)
        assert not errors, f"survivors' calls failed: {errors[:3]}"
        assert set(victim_errors) <= TRANSPORT_ERRORS, victim_errors
        # the victim's channels reconnect to a live shard
        for ch in victims:
            c = ch.call_sync("Bench", "PyEcho", b"again")
            assert not c.failed(), c.error_text

        def restarted():
            pids = g.running_pids()
            return len(pids) == 2 and victim not in pids
        assert _wait_for(restarted, 10), g.json("/shards")
        assert time.monotonic() - t_kill < 10
        new = [p for p in g.running_pids() if p not in by_pid]
        assert len(new) == 1
        # the new shard serves
        seen = set()
        for _ in range(32):
            seen.add(_pid_of(g.channel()))
            if new[0] in seen:
                break
        assert new[0] in seen, (new, seen)
        sh = g.json("/shards")["group"]["shards"]
        assert sum(s["restarts"] for s in sh) == 1


def case_echo_group_hung_shard_replaced(root):
    with _Group(root, extra=("--heartbeat-timeout", "1.0",
                             "--restart-backoff", "0.1")) as g:
        pids = g.running_pids()
        hung = pids[0]
        os.kill(hung, signal.SIGSTOP)
        t0 = time.monotonic()

        def replaced():
            now = g.running_pids()
            return len(now) == 2 and hung not in now
        assert _wait_for(replaced, 10), g.json("/shards")
        assert time.monotonic() - t0 >= 1.0
        assert not os.path.exists(f"/proc/{hung}"), "hung shard not reaped"


_EARLY_STOP_SCRIPT = r"""
import json, os, signal, sys, time
from brpc_tpu_torch.butil import postfork
from brpc_tpu_torch.rpc import Server, Service
from brpc_tpu_torch.rpc.shard_group import ShardGroupOptions
assert "jax" not in sys.modules
# the runner's handler, which a child holds until it installs its own
signal.signal(signal.SIGTERM, lambda *_: None)
# a slow way through the fork: the stop's SIGTERM lands before the
# shards' drain handlers are in
postfork.register("test.slow_child", lambda: time.sleep(0.5))
srv = Server()
svc = Service("Svc")
svc.register_method("Pid", lambda cntl, req: str(os.getpid()).encode())
srv.add_service(svc)
srv.start("tcp://127.0.0.1:0", num_shards=2, shard_options=ShardGroupOptions(
    shard_dir=sys.argv[1], dump_interval_s=0.1, drain_timeout_s=1.0,
    enable_admin=False))
time.sleep(0.1)
t0 = time.monotonic()
srv.stop()
srv.join()
print(json.dumps({"stop_s": time.monotonic() - t0,
                  "dumps": sorted(n for n in os.listdir(sys.argv[1])
                                  if n.endswith(".json"))}))
"""


def case_stop_right_after_fork_drains(root):
    """A stop whose SIGTERM reaches a shard before its drain handler is
    in: the shard drains (its last dump written) instead of waiting out
    the drain budget for the SIGKILL (1 s + 2 s here)."""
    d = tempfile.mkdtemp(prefix="earlystop-", dir=root)
    doc, _ = _py(_EARLY_STOP_SCRIPT, d)
    assert doc["stop_s"] < 2.5, doc
    assert doc["dumps"] == ["shard-0.json", "shard-1.json"], doc
    assert _wait_for(lambda: not _processes_with(d), 10)


# ------------------------------------------------------------ Generate

def _reference_tokens() -> dict:
    server = ref_rpc.Server(ref_rpc.ServerOptions(
        enable_builtin_services=False))
    ref_add_generate_service(server, cache_len=160, warmup=True)
    ep = server.start("tcp://127.0.0.1:0")
    ch = ref_rpc.Channel(f"tcp://127.0.0.1:{ep.port}")
    try:
        out = {}
        for p in PROMPTS:
            cntl = ref_rpc.Controller()
            cntl.timeout_ms = 30000
            cntl = ch.call_sync("GenerateService", "Generate", json.dumps(
                {"prompt": p, "max_tokens": GEN_TOKENS}).encode(),
                cntl=cntl)
            assert not cntl.failed(), cntl.error_text
            out[p] = json.loads(cntl.response_payload.to_bytes())["tokens"]
        return out
    finally:
        ch.close()
        server.stop()
        server.join(5)


def case_generate_on_two_shards(root):
    want = _reference_tokens()
    with _Group(root, generate=True) as g:
        by_pid = g.chans_by_pid(2)
        chans = [c for v in by_pid.values() for c in v]
        got = {}
        for i, p in enumerate(PROMPTS):
            # every shard serves: the first calls go one to each shard
            ch = by_pid[sorted(by_pid)[i % 2]][0] if i < 2 \
                else chans[i % len(chans)]
            c = ch.call_sync("GenerateService", "Generate", json.dumps(
                {"prompt": p, "max_tokens": GEN_TOKENS}).encode())
            assert not c.failed(), c.error_text
            got[p] = json.loads(c.response)["tokens"]
        assert got == want
        total = sum(len(t) for t in got.values())

        def settled():
            per = [g.json(f"/serving?shard={i}") for i in range(2)]
            return all(s["tokens_out"] > 0 for s in per) and \
                sum(s["tokens_out"] for s in per) == total and \
                g.json("/serving")["tokens_out"] == total
        assert _wait_for(settled, 5), (g.json("/serving"),
                                       g.json("/serving?shard=0"))
        # the plain path on the CPU launches no kernel
        assert _shard_sum(g, "flash_decode_launches") == [0, 0]


# ------------------------------------------------------ CUDA in the parent

_NO_CUDA_SCRIPT = r"""
import json, sys, time
import torch
calls = []

def recorder(name, value=None):
    def fn(*a, **k):
        calls.append(name)
        return value
    return fn

torch.cuda.init = recorder("torch.cuda.init")
torch.cuda._lazy_init = recorder("torch.cuda._lazy_init")
# with it present torch.cuda counts devices through it: 0, no card
torch._C._cuda_getDeviceCount = recorder("_cuda_getDeviceCount", 0)
from brpc_tpu_torch.rpc import Server
from brpc_tpu_torch.rpc.shard_group import ShardGroupOptions
from brpc_tpu_torch.serving import add_generate_service
assert "jax" not in sys.modules
srv = Server()
gs = add_generate_service(srv)          # the default device, cuda:0
srv.start("tcp://127.0.0.1:0", num_shards=2, shard_options=ShardGroupOptions(
    shard_dir=sys.argv[1], dump_interval_s=0.1, restart_backoff_s=0.1,
    heartbeat_timeout_s=5.0))
at_fork = list(calls)
grp = srv._shard_group
deadline = time.monotonic() + 30
while time.monotonic() < deadline:
    st = grp.group_status()
    if all(s["restarts"] >= 1 for s in st["shards"]):
        break
    time.sleep(0.05)
dumps = len(grp.aggregator.read_dumps())
srv.stop()
srv.join()
print(json.dumps({"device": str(gs.device), "at_fork": at_fork,
                  "after": calls, "status": st, "dumps": dumps}))
"""


def case_supervisor_makes_no_cuda_call(root):
    d = tempfile.mkdtemp(prefix="nocuda-", dir=root)
    doc, err = _py(_NO_CUDA_SCRIPT, d)
    assert doc["device"] == "cuda:0"
    assert doc["at_fork"] == [] and doc["after"] == [], doc
    # each shard failed loudly, served nothing, and was restarted
    assert all(s["restarts"] >= 1 for s in doc["status"]["shards"]), doc
    assert doc["dumps"] == 0
    assert "CUDA is not available" in err, err[-2000:]
    assert _wait_for(lambda: not _processes_with(d), 10)


_BAD_FORK_SCRIPT = r"""
import http.client, json, os, sys, time
import torch
# what torch reports in a child whose parent asked the CUDA runtime
torch.cuda._is_in_bad_fork = lambda: True
from brpc_tpu_torch.rpc import Server
from brpc_tpu_torch.rpc.shard_group import (EXIT_CUDA_BAD_FORK,
                                            ShardGroupOptions)
from brpc_tpu_torch.serving import add_generate_service
assert "jax" not in sys.modules
srv = Server()
add_generate_service(srv)               # the default device, cuda:0
srv.start("tcp://127.0.0.1:0", num_shards=2, shard_options=ShardGroupOptions(
    shard_dir=sys.argv[1], dump_interval_s=0.1, restart_backoff_s=0.05))
grp = srv._shard_group
deadline = time.monotonic() + 30
while time.monotonic() < deadline and not grp.failed:
    time.sleep(0.05)
conn = http.client.HTTPConnection("127.0.0.1", grp.admin_endpoint.port,
                                  timeout=10)
conn.request("GET", "/shards")
page = json.loads(conn.getresponse().read())
conn.close()
t0 = time.monotonic()
srv.run_until_asked_to_quit()           # returns by itself
print(json.dumps({"failed": grp.failed, "page": page,
                  "status": grp.group_status(), "code": EXIT_CUDA_BAD_FORK,
                  "quit_s": time.monotonic() - t0}))
"""


def case_bad_fork_fails_the_group(root):
    d = tempfile.mkdtemp(prefix="badfork-", dir=root)
    pids = tempfile.mkdtemp(prefix="badfork-pids-", dir=root)
    doc, err = _py(_BAD_FORK_SCRIPT, d,
                   env=_env(BRPC_TPU_TORCH_PID_DIR=pids))
    assert doc["failed"] and "before the fork" in doc["failed"], doc
    group = doc["page"]["group"]
    assert group["failed"] == doc["failed"], doc
    # no restart: a restart forks from the same poisoned process
    assert [s["restarts"] for s in group["shards"]] == [0, 0], doc
    assert "failed" in {s["state"] for s in group["shards"]}, doc
    assert all(s["pid"] == 0 for s in doc["status"]["shards"]), doc
    assert doc["quit_s"] < 5.0, doc
    assert "made a CUDA call before the fork" in err, err[-2000:]
    assert os.listdir(pids) == []
    assert _wait_for(lambda: not _processes_with(d), 10)


# ------------------------------------------------------ start, pidfile

def case_start_arguments():
    for rpc in (port_rpc, ref_rpc):
        srv = rpc.Server(rpc.ServerOptions(enable_builtin_services=False))
        try:
            srv.start("mem://shards-need-tcp", num_shards=2)
        except ValueError as e:
            assert "tcp" in str(e)
        else:
            raise AssertionError(f"{rpc.__name__}: mem:// group started")
    srv = port_rpc.Server(port_rpc.ServerOptions(
        enable_builtin_services=False))
    svc = port_rpc.Service("Svc")
    svc.register_method("Pid", lambda cntl, req: str(os.getpid()).encode())
    srv.add_service(svc)
    ep = srv.start("tcp://127.0.0.1:0", num_shards=1)
    ch = port_rpc.Channel(str(ep), port_rpc.ChannelOptions(timeout_ms=5000))
    try:
        assert srv._shard_group is None
        c = ch.call_sync("Svc", "Pid", b"")
        assert not c.failed() and int(c.response) == os.getpid()
    finally:
        ch.close()
        srv.stop()
        srv.join(5)


_QUIT_SCRIPT = r"""
import sys
if sys.argv[1] == "port":
    from brpc_tpu_torch.rpc import Server, ServerOptions
else:
    from brpc_tpu.rpc import Server, ServerOptions
srv = Server(ServerOptions(enable_builtin_services=False))
ep = srv.start("tcp://127.0.0.1:0")
print("PORT", ep.port, flush=True)
srv.run_until_asked_to_quit()
print("QUIT", flush=True)
"""


def _quit_run(side: str, pid_dir: str) -> dict:
    env = _env(BRPC_TPU_TORCH_PID_DIR=pid_dir, BRPC_TPU_PID_DIR=pid_dir)
    proc = subprocess.Popen([sys.executable, "-c", _QUIT_SCRIPT, side],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=str(ROOT), env=env)
    try:
        port = int(proc.stdout.readline().split()[1])

        def written():
            # the file appears before its two lines are in it
            for name in os.listdir(pid_dir):
                with open(os.path.join(pid_dir, name)) as f:
                    lines = f.read().splitlines()
                if len(lines) == 2:
                    return name, lines
            return None
        assert _wait_for(written, 20), (side, os.listdir(pid_dir))
        name, lines = written()
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return {"name": name.replace(str(port), "PORT").replace(
                str(proc.pid), "PID"),
            "pid_line": lines[0] == str(proc.pid),
            "cmdline": "run_until_asked_to_quit" in lines[1],
            "rc": proc.returncode, "quit": out.split(), "left":
            os.listdir(pid_dir), "err": err[-1000:]}


def case_run_until_asked_to_quit(root):
    got = {}
    for side in ("port", "ref"):
        d = tempfile.mkdtemp(prefix=f"pids-{side}-", dir=root)
        got[side] = _quit_run(side, d)
    for side, r in got.items():
        assert r["rc"] == 0 and r["quit"] == ["QUIT"], (side, r)
        assert r["left"] == [], (side, r)
        r.pop("err")
    assert got["port"] == got["ref"], got
    assert got["port"]["name"] == "server-tcp---127.0.0.1-PORT.PID.pid"
    assert got["port"]["pid_line"] and got["port"]["cmdline"]


def test_shard_groups():
    with tempfile.TemporaryDirectory(prefix="shard-groups-") as root:
        _run_cases([
            ("registry against brpc_tpu's",
             case_registry_against_reference, ()),
            ("every module registered", case_every_module_registered, ()),
            ("a forked child rebuilds", case_forked_child_rebuilds, ()),
            ("a forked child keeps its calls",
             case_forked_child_keeps_its_calls, ()),
            ("merges against brpc_tpu's",
             case_merges_against_reference, ()),
            ("a port dump read by brpc_tpu",
             case_port_dump_read_by_reference, ()),
            ("echo group: views and drain",
             case_echo_group_views_and_drain, (root,)),
            ("a group of one", case_group_of_one, (root,)),
            ("echo group: SIGKILL mid-burst",
             case_echo_group_kill_mid_burst, (root,)),
            ("a stop right after the fork drains",
             case_stop_right_after_fork_drains, (root,)),
            ("echo group: a hung shard replaced",
             case_echo_group_hung_shard_replaced, (root,)),
            ("Generate on two shards", case_generate_on_two_shards,
             (root,)),
            ("the supervisor makes no CUDA call",
             case_supervisor_makes_no_cuda_call, (root,)),
            ("a shard in a bad fork fails the group",
             case_bad_fork_fails_the_group, (root,)),
            ("start arguments", case_start_arguments, ()),
            ("run_until_asked_to_quit", case_run_until_asked_to_quit,
             (root,)),
        ], limit_s=60.0)
