"""The port's trace and chain tools (``brpc_tpu_torch/tools/trace.py``,
``tools/chain_server.py``) against brpc_tpu's, on the CPU.

- The same trees from the same stores: a store of the port's spans and
  one of brpc_tpu's (each package's own loopback client -> Mid -> Leaf
  burst), and a copy with a duplicated span id and a truncated last
  line, read by both packages' ``load_spans``, ``assemble``,
  ``critical_path``, ``stage_attribution``, ``to_perfetto`` and
  ``summarize``: the outputs are equal.
- Across processes: client -> A -> B over two port ``chain_server``
  processes gives one linear tree a call over three pids; a brpc_tpu
  ``chain_server`` as B behind a port A does too (trace ids ride
  ``RpcMeta`` 8-10 in both). The CLI's ``--perfetto`` and ``--top`` over
  those stores.
- ``python3 -m brpc_tpu_torch.tools.trace --smoke`` in a subprocess that
  imports no jax, brpc_tpu or protobuf exits 0 with the keys and
  invariants of brpc_tpu's ``tools/trace.py --smoke``.

One collected test over the cases (``_run_cases`` of
test_torch_cluster.py).
"""

import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile

from brpc_tpu_torch.butil.flags import flag, set_flag
from brpc_tpu_torch.rpc import Channel, ChannelOptions
from brpc_tpu_torch.rpc.span import global_store
from brpc_tpu_torch.tools import trace as port_trace
from brpc_tpu_torch.tools.spawn_util import package_root, spawn_port_server

from test_torch_cluster import ROOT, _run_cases

FORBIDDEN_MODULES = ("jax", "jaxlib", "brpc_tpu", "google.protobuf")
CHAIN_CALLS = 4

# brpc_tpu's tools/trace.py, loaded under another name: as "trace" it
# would shadow the standard library's module for the whole process
_spec = importlib.util.spec_from_file_location(
    "brpc_tpu_trace_tool", str(ROOT / "tools" / "trace.py"))
ref_trace = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref_trace)


def _shape(node):
    return (node.span["span_id"], [_shape(c) for c in node.children])


def _views(tool, paths, top=None):
    """What one package's tool makes of the stores at ``paths``."""
    spans = tool.load_spans(paths)
    forest = tool.assemble(spans)
    paths_out = {}
    for tid, roots in forest.items():
        total, path = tool.critical_path(roots)
        paths_out[tid] = {
            "total": total,
            "path": [(n.span["span_id"], self_us) for n, self_us in path],
            "stages": tool.stage_attribution(path)}
    return {"spans": spans,
            "forest": {tid: [_shape(r) for r in roots]
                       for tid, roots in forest.items()},
            "critical": paths_out,
            "perfetto": tool.to_perfetto(spans),
            "summary": tool.summarize(forest),
            "top": tool.summarize(forest, top=top or 3)}


def _doctored(src_dir, work):
    """A copy of a store with one span's id given to another line and a
    last line cut halfway."""
    d = os.path.join(work, "doctored")
    os.makedirs(d)
    with open(os.path.join(src_dir, "rpcz_spans.jsonl")) as f:
        lines = f.read().splitlines()
    twin = json.loads(lines[1])
    twin["latency_us"] += 1000          # the first line of an id wins
    twin["method"] = "Twin"
    with open(os.path.join(d, "rpcz_spans.jsonl"), "w") as f:
        f.write("\n".join(lines + [json.dumps(twin)]) + "\n")
        f.write(lines[0][:len(lines[0]) // 2])
    return d


def case_same_trees_from_same_stores():
    work = tempfile.mkdtemp(prefix="trace-tools-")
    try:
        mine = port_trace.run_smoke()
        theirs = ref_trace.run_smoke()
        assert mine["ok"] and theirs["ok"], (mine, theirs)
        stores = {"port": mine["rpcz_dir"], "brpc_tpu": theirs["rpcz_dir"]}
        stores["doctored"] = _doctored(mine["rpcz_dir"], work)
        for name, d in stores.items():
            a = _views(port_trace, [d])
            b = _views(ref_trace, [d])
            assert a == b, name
            assert a["spans"] and port_trace.validate_perfetto(
                a["perfetto"]) == ref_trace.validate_perfetto(b["perfetto"])
        # the duplicate's first line won, the cut line was skipped
        spans = port_trace.load_spans([stores["doctored"]])
        forest = port_trace.assemble(spans)
        assert "Twin" not in [n.span["method"] for roots in forest.values()
                              for r in roots for n in r.walk()]
        assert len(spans) == len(port_trace.load_spans(
            [stores["port"]])) + 1
        # both packages' stores together: one forest, the same again
        both = [stores["port"], stores["brpc_tpu"]]
        assert _views(port_trace, both) == _views(ref_trace, both)
    finally:
        for d in (work, locals().get("mine", {}).get("rpcz_dir"),
                  locals().get("theirs", {}).get("rpcz_dir")):
            if d:
                shutil.rmtree(d, ignore_errors=True)


def _chain_server(kind, dirpath, next_port=None):
    """A chain hop: the port's as ``python3 -m``, brpc_tpu's by path."""
    if kind == "port":
        argv = ["-m", "brpc_tpu_torch.tools.chain_server"]
        env, cwd = None, package_root()
    else:
        argv = [str(ROOT / "tools" / "chain_server.py")]
        env, cwd = dict(os.environ, JAX_PLATFORMS="cpu"), str(ROOT)
    argv += ["0", "--rpcz-dir", dirpath]
    if next_port is not None:
        argv += ["--next", f"tcp://127.0.0.1:{next_port}"]
    proc, port = spawn_port_server(argv, wall_s=30, env=env, cwd=cwd)
    assert port, f"{kind} chain server never came up"
    return proc, port


def _chain(b_kind):
    work = tempfile.mkdtemp(prefix="trace-chain-")
    dir_a, dir_b, dir_c = (os.path.join(work, n) for n in "abc")
    procs, ch = [], None
    before = {f: flag(f) for f in ("rpcz_enabled", "rpcz_dir")}
    try:
        proc_b, port_b = _chain_server(b_kind, dir_b)
        procs.append(proc_b)
        proc_a, port_a = _chain_server("port", dir_a, port_b)
        procs.append(proc_a)
        set_flag("rpcz_enabled", True)
        set_flag("rpcz_dir", dir_c)
        ch = Channel(f"tcp://127.0.0.1:{port_a}",
                     ChannelOptions(timeout_ms=8000))
        traces = []
        for i in range(CHAIN_CALLS):
            cntl = ch.call_sync("Chain", "Hop", b"ping%d" % i)
            assert not cntl.failed(), cntl.error_text
            assert cntl.response == b"hop:leaf:ping%d" % i
            traces.append(f"{cntl.trace_id:016x}")
        global_store.flush()
        for p in procs:                 # SIGTERM: each flushes its store
            p.terminate()
        for p in procs:
            assert p.wait(15) == 0
        dirs = [dir_a, dir_b, dir_c]
        spans = port_trace.load_spans(dirs)
        forest = port_trace.assemble(spans)
        for tid in traces:
            mine = [s for s in spans if s["trace_id"] == tid]
            # client -> A server -> A client -> B server
            assert len(mine) == 4, mine
            assert len({s["pid"] for s in mine}) == 3, mine
            roots = forest[tid]
            assert len(roots) == 1, [r.span for r in roots]
            node, chain = roots[0], []
            while True:
                chain.append(node.span)
                if not node.children:
                    break
                assert len(node.children) == 1
                node = node.children[0]
            assert len(chain) == 4
            assert chain[0]["side"] == "client" and \
                chain[0]["pid"] == os.getpid()
            assert chain[-1]["side"] == "server"
            for parent, child in zip(chain, chain[1:]):
                assert child["parent_span_id"] == parent["span_id"]
            total, path = port_trace.critical_path(roots)
            assert total == chain[0]["latency_us"] and len(path) == 4
        # both packages' tools agree over the three stores
        assert _views(port_trace, dirs) == _views(ref_trace, dirs)
        # the CLI: --perfetto writes a valid document, --top ranks
        out = os.path.join(work, "out.json")
        cli = _run_trace_cli(dirs + ["--perfetto", out])
        assert cli["rc"] == 0 and cli["forbidden"] == "[]", cli
        with open(out) as f:
            assert port_trace.validate_perfetto(json.load(f)) >= 4 * len(
                traces)
        cli = _run_trace_cli(dirs + ["--top", "2"])
        assert cli["rc"] == 0, cli
        assert cli["stdout"].count("\ntrace ") == 2, cli["stdout"]
        assert f"{len(spans)} spans in {len(forest)} traces from 3 " \
               f"store(s)" in cli["stdout"]
    finally:
        if ch is not None:
            ch.close()
        for f, v in before.items():
            set_flag(f, v)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(5)
            p.stdout.close()
        shutil.rmtree(work, ignore_errors=True)


def case_chain_of_port_servers():
    _chain("port")


def case_chain_through_a_brpc_tpu_server():
    _chain("brpc_tpu")


def _run_trace_cli(argv, timeout_s=120):
    """``python3 -m brpc_tpu_torch.tools.trace argv...`` with no
    PYTHONPATH: its exit code, stdout and the forbidden modules it
    imported."""
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['trace'] + {argv!r}\n"
        "rc = 0\n"
        "try:\n"
        "    runpy.run_module('brpc_tpu_torch.tools.trace',\n"
        "                     run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        f"forbidden = {FORBIDDEN_MODULES!r}\n"
        "bad = sorted(m for m in sys.modules if any(\n"
        "    m == f or m.startswith(f + '.') for f in forbidden))\n"
        "print('FORBIDDEN', bad)\n"
        "sys.exit(rc)\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout_s)
    lines = proc.stdout.rstrip("\n").splitlines()
    assert lines and lines[-1].startswith("FORBIDDEN"), \
        proc.stdout + proc.stderr[-2000:]
    return {"rc": proc.returncode, "stdout": "\n".join(lines[:-1]),
            "forbidden": lines[-1][len("FORBIDDEN "):]}


def case_trace_smoke_cli():
    cli = _run_trace_cli(["--smoke"])
    assert cli["rc"] == 0 and cli["forbidden"] == "[]", cli
    mine = json.loads(cli["stdout"])
    ref = subprocess.run([sys.executable, "tools/trace.py", "--smoke"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert ref.returncode == 0, ref.stderr[-2000:]
    theirs = json.loads(ref.stdout)
    assert sorted(mine) == sorted(theirs)
    for d in (mine, theirs):
        shutil.rmtree(d["rpcz_dir"], ignore_errors=True)
    same = ("ok", "traces", "chains", "chain_depth", "spans")
    assert {k: mine[k] for k in same} == {k: theirs[k] for k in same}
    assert mine["perfetto_slices"] >= mine["spans"]


CASES = [
    ("the same trees from the same stores",
     case_same_trees_from_same_stores, ()),
    ("a chain of two port chain servers", case_chain_of_port_servers, ()),
    ("a chain through a brpc_tpu chain server",
     case_chain_through_a_brpc_tpu_server, ()),
    ("trace --smoke against brpc_tpu's", case_trace_smoke_cli, ()),
]


def test_trace_tools():
    _run_cases(CASES, limit_s=60)
