"""The port's load and cluster tools against brpc_tpu's, on the CPU:
``pipeline_runner``, ``bench_echo_server``, ``qps_client``, ``soak``,
``fiber_stacks`` and ``cluster_top`` (``brpc_tpu_torch/tools/``).

- ``run_pipelined``: the port's and brpc_tpu's issue the same calls and
  settle the same way, for a scripted ``issue`` that completes every
  call, one that fails at call k, and one that never completes (a
  timeout).
- ``bench_echo_server`` as ``python3 -m``: ``Echo`` with a 1 MiB
  attachment, ``PyEcho``, ``Slow`` and ``StreamSink`` answer the port's
  client and brpc_tpu's; it exits when its parent dies.
- ``qps_client.drive_multiproc`` over 2 workers for 1 s, on one port and
  on a comma list: calls, no failures, no dead worker.
- ``soak --seconds 12``: two samples, every lane's count above 0, no
  error (the growth verdict of so short a window is printed, not
  asserted); ``--idle-conns 300``: ok.
- ``fiber_stacks``: the ``http://`` mode prints the report, the PID mode
  puts it on the target's stderr.
- ``cluster_top``: ``merge_backends``, ``scrape`` and ``render`` give the
  same from the port and brpc_tpu over the same pages of port servers;
  ``--smoke`` with ``BRPC_TPU_TORCH_PERF_SMOKE=0``; the timeline block of
  ``--json`` (tests/test_timeline.py's case).

Every CLI runs in a subprocess that imports no jax, brpc_tpu or
protobuf. One collected test over the cases (``_run_cases`` of
test_torch_cluster.py).
"""

import importlib.util
import json
import os
import queue
import subprocess
import sys
import tempfile
import threading
import time

from brpc_tpu.butil.iobuf import IOBuf as RefIOBuf
from brpc_tpu.rpc import Channel as RefChannel
from brpc_tpu.rpc import ChannelOptions as RefChannelOptions
from brpc_tpu.rpc import Controller as RefController

from brpc_tpu_torch.bvar.series import series_sample_tick
from brpc_tpu_torch.rpc import (Channel, ChannelOptions, ClusterChannel,
                                Controller, Server, ServerOptions,
                                StreamOptions)
from brpc_tpu_torch.tools import cluster_top, pipeline_runner, qps_client
from brpc_tpu_torch.tools.spawn_util import package_root, spawn_port_server

from test_torch_cluster import ROOT, _run_cases, _wait_for

FORBIDDEN_MODULES = ("jax", "jaxlib", "brpc_tpu", "google.protobuf")
ECHO_SERVER = ["-m", "brpc_tpu_torch.tools.bench_echo_server"]


def _load_ref(name):
    """brpc_tpu's ``tools/<name>.py`` under another module name."""
    spec = importlib.util.spec_from_file_location(
        f"brpc_tpu_tool_{name}", str(ROOT / "tools" / f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref_pipeline = _load_ref("pipeline_runner")


class _EchoServer:
    """The port's bench_echo_server in a process of its own."""

    def __init__(self, stderr=subprocess.DEVNULL):
        self.proc, self.port = spawn_port_server(
            ECHO_SERVER, wall_s=30, stderr=stderr, cwd=package_root())
        assert self.port, "bench_echo_server never came up"
        self.addr = f"tcp://127.0.0.1:{self.port}"

    def close(self):
        if self.proc.poll() is None:
            self.proc.terminate()
        self.proc.wait(10)
        self.proc.stdout.close()


def _run_module(name, argv, timeout_s=120, env=None):
    """The tool's ``main()`` with ``argv``, as ``python3 -m
    brpc_tpu_torch.tools.<name>`` runs it, in a process with no
    PYTHONPATH: exit code, stdout, stderr and the forbidden modules it
    imported (its last stdout line, which the wrapper prints)."""
    code = (
        "import importlib, sys\n"
        f"sys.argv = [{name!r}] + {argv!r}\n"
        f"tool = importlib.import_module('brpc_tpu_torch.tools.{name}')\n"
        "try:\n"
        "    rc = tool.main()\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "sys.stdout.flush()\n"
        f"forbidden = {FORBIDDEN_MODULES!r}\n"
        "bad = sorted(m for m in sys.modules if any(\n"
        "    m == f or m.startswith(f + '.') for f in forbidden))\n"
        "print('FORBIDDEN', bad, flush=True)\n"
        "import os\n"
        "os._exit(rc or 0)\n")
    full = dict(os.environ, **(env or {}))
    full.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=full,
                          capture_output=True, text=True, timeout=timeout_s)
    lines = proc.stdout.rstrip("\n").splitlines()
    assert lines and lines[-1].startswith("FORBIDDEN"), \
        proc.stdout[-2000:] + proc.stderr[-2000:]
    return {"rc": proc.returncode, "stdout": "\n".join(lines[:-1]),
            "stderr": proc.stderr,
            "forbidden": lines[-1][len("FORBIDDEN "):]}


# ------------------------------------------------------ pipeline_runner

def _scripted(fail_at=None, complete=True):
    """An ``issue`` whose calls complete in order on one thread, call
    ``fail_at`` (1-based) with an error; ``complete`` False: none ever
    completes. Returns (issue, issued list, stop)."""
    q = queue.Queue()
    issued = []

    def worker():
        while True:
            item = q.get()
            if item is None:
                return
            n, on_done = item
            on_done(RuntimeError(f"call {n} failed")
                    if n == fail_at else None)

    t = threading.Thread(target=worker, daemon=True)
    t.start()

    def issue(on_done):
        issued.append(len(issued) + 1)
        if complete:
            q.put((len(issued), on_done))

    return issue, issued, lambda: (q.put(None), t.join(5))


def _pipelined(mod, iters, inflight, wait_s, **kw):
    issue, issued, stop = _scripted(**kw)
    try:
        mod.run_pipelined(iters, inflight, issue, wait_s)
        out = "ok"
    except RuntimeError as e:
        out = str(e)
    finally:
        stop()
    return out, len(issued)


def case_run_pipelined():
    for kw in ({}, {"fail_at": 1}, {"fail_at": 37}, {"fail_at": 200}):
        mine = _pipelined(pipeline_runner, 200, 8, 10.0, **kw)
        theirs = _pipelined(ref_pipeline, 200, 8, 10.0, **kw)
        assert mine == theirs, (kw, mine, theirs)
    assert _pipelined(pipeline_runner, 200, 8, 10.0) == ("ok", 200)
    # the calls not issued are settled at the first error: no timeout
    msg, n = _pipelined(pipeline_runner, 200, 8, 10.0, fail_at=37)
    assert msg == "pipelined call failed: call 37 failed" and n < 200
    mine = _pipelined(pipeline_runner, 50, 4, 0.3, complete=False)
    theirs = _pipelined(ref_pipeline, 50, 4, 0.3, complete=False)
    assert mine == theirs == (
        "pipelined batch timed out after 0s (50/50 outstanding)", 4)


# ---------------------------------------------------- bench_echo_server

def _stream_sink(ch, total, frame):
    """Open a StreamSink stream, push ``total`` bytes in ``frame``s, wait
    for its one answer."""
    from brpc_tpu_torch import fiber
    got = []
    done = threading.Event()
    cntl = ch.call_sync("Bench", "StreamSink", str(total).encode(),
                        stream_options=StreamOptions(
                            on_received=lambda s, m: (got.append(m.payload),
                                                      done.set())))
    assert not cntl.failed(), cntl.error_text
    assert cntl.response == b"accepted"
    stream = cntl.stream

    async def producer():
        for _ in range(total // len(frame)):
            assert await stream.write(frame)

    f = fiber.spawn(producer)
    assert f.join(20)
    try:
        assert done.wait(10), "the sink never answered"
    finally:
        stream.close()
    return got


def case_bench_echo_server():
    srv = _EchoServer()
    pay = bytes(range(256)) * 4096          # 1 MiB
    try:
        ch = Channel(srv.addr, ChannelOptions(timeout_ms=10000,
                                              share_connections=False))
        try:
            c = Controller()
            c.request_attachment.append(pay)
            c = ch.call_sync("Bench", "Echo", b"body", cntl=c)
            assert not c.failed(), c.error_text
            assert c.response == b"body"
            assert c.response_attachment.to_bytes() == pay
            assert ch.call_sync("Bench", "Echo", b"x" * 64).response == \
                b"x" * 64
            assert ch.call_sync("Bench", "PyEcho", b"py").response == b"py"
            t0 = time.monotonic()
            c = ch.call_sync("Bench", "Slow", b"slow")
            assert c.response == b"slow" and time.monotonic() - t0 >= 0.05
            frame = b"\x33" * (64 << 10)
            assert _stream_sink(ch, 16 * len(frame), frame) == [
                b"done:%d" % (16 * len(frame))]
        finally:
            ch.close()
        ref = RefChannel(srv.addr, RefChannelOptions(timeout_ms=10000))
        try:
            c = RefController()
            att = RefIOBuf()
            att.append(pay)
            c.request_attachment = att
            c = ref.call_sync("Bench", "Echo", b"body", cntl=c)
            assert not c.failed(), c.error_text
            assert c.response_payload.to_bytes() == b"body"
            assert c.response_attachment.to_bytes() == pay
            assert ref.call_sync("Bench", "PyEcho", b"py") \
                .response_payload.to_bytes() == b"py"
            c = ref.call_sync("Bench", "Slow", b"slow")
            assert c.response_payload.to_bytes() == b"slow"
        finally:
            ref.close()
    finally:
        srv.close()


def case_echo_server_exits_with_its_parent():
    """A parent that starts the server and dies: the server follows."""
    code = ("import subprocess, sys\n"
            "p = subprocess.Popen([sys.executable, '-m', "
            "'brpc_tpu_torch.tools.bench_echo_server'], "
            "stdout=subprocess.PIPE)\n"
            "line = p.stdout.readline().decode().strip()\n"
            "print(p.pid, line, flush=True)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=package_root(),
                         capture_output=True, text=True, timeout=60)
    pid, word, port = out.stdout.split()
    assert word == "PORT" and int(port) > 0, out
    assert _wait_for(lambda: not _alive(int(pid)), 10), \
        f"bench_echo_server {pid} outlived its parent"


def _alive(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


# ------------------------------------------------------------ qps_client

def case_drive_multiproc():
    servers = [_EchoServer(), _EchoServer()]
    try:
        one = qps_client.drive_multiproc(servers[0].port, nprocs=2,
                                         seconds=1.0, conns=2)
        both = qps_client.drive_multiproc(
            ",".join(str(s.port) for s in servers), nprocs=2, seconds=1.0,
            conns=2, method="PyEcho")
    finally:
        for s in servers:
            s.close()
    for r in (one, both):
        assert r["calls"] > 0 and r["failures"] == 0, r
        assert r["dead_workers"] == 0 and r["workers"] == 2, r
        assert r["qps"] > 0 and r["elapsed_s"] >= 1.0, r


# ------------------------------------------------------------------ soak

def case_soak():
    out = _run_module("soak", ["--seconds", "12"], timeout_s=90)
    assert out["forbidden"] == "[]", out["forbidden"]
    doc = json.loads(out["stdout"].splitlines()[-1])
    samples = [json.loads(ln)["progress"] for ln in
               out["stderr"].splitlines() if ln.startswith('{"progress"')]
    assert len(samples) == 2, out["stderr"][-2000:]
    assert doc["first_sample"] == samples[0]
    assert doc["last_sample"] == samples[-1]
    assert sorted(doc["calls"]) == ["big_1mb", "conn_churn", "small_sync",
                                    "stream_8mb"]
    assert all(n > 0 for n in doc["calls"].values()), doc
    assert doc["errors"] == 0, doc
    assert out["rc"] == (0 if doc["ok"] else 1)
    print("soak --seconds 12:", json.dumps(doc))
    idle = _run_module("soak", ["--idle-conns", "300"], timeout_s=90)
    assert idle["forbidden"] == "[]" and idle["rc"] == 0, idle
    doc = json.loads(idle["stdout"].splitlines()[-1])
    assert doc["ok"] and doc["idle_conns"] == 300, doc
    assert doc["census_connections"]["count"] >= 300, doc
    assert "bytes_per_idle_conn" in doc


# ---------------------------------------------------------- fiber_stacks

def case_fiber_stacks():
    err = tempfile.TemporaryFile(mode="w+")
    srv = _EchoServer(stderr=err)
    try:
        out = _run_module("fiber_stacks", [f"http://127.0.0.1:{srv.port}"])
        assert out["rc"] == 0 and out["forbidden"] == "[]", out
        assert "live fibers" in out["stdout"], out["stdout"]
        out = _run_module("fiber_stacks", [str(srv.proc.pid)])
        assert out["rc"] == 0 and out["forbidden"] == "[]", out
        assert out["stdout"].startswith(f"SIGUSR2 sent to {srv.proc.pid}")

        def reported():
            err.seek(0)
            return "live fibers" in err.read()
        assert _wait_for(reported, 10), "no report on the target's stderr"
        assert _run_module("fiber_stacks", ["nonsense"])["rc"] == 2
        assert _run_module("fiber_stacks", [])["rc"] == 2
    finally:
        srv.close()
        err.close()


# ----------------------------------------------------------- cluster_top

def _recorded(nodes, paths):
    """Each node's pages fetched once, so that both packages' tools read
    the very same bytes."""
    pages = {}
    for node in nodes:
        for path in paths:
            pages[(node, path)] = cluster_top.fetch_json(node, path)
    return lambda node, path, timeout_s=5.0: pages.get((node, path))


SCRAPED = ("/backends", "/status", "/device", "/serving",
           "/timeline?prefix=server_")


def case_cluster_top_against_brpc_tpu():
    ref_top = _load_ref("cluster_top")
    servers = [_EchoServer(), _EchoServer()]
    admin = Server(ServerOptions(enable_builtin_services=True))
    ch = None
    try:
        admin_ep = admin.start("tcp://127.0.0.1:0")
        ch = ClusterChannel(
            "list://" + ",".join(s.addr for s in servers), "rr",
            ChannelOptions(timeout_ms=4000, max_retry=2,
                           name="load_tools_cluster"))
        for _ in range(40):
            assert not ch.call_sync("Bench", "PyEcho", b"q").failed()
        for i in range(3):
            series_sample_tick(wall_t=2000 + i)
        nodes = [f"127.0.0.1:{admin_ep.port}"] + \
            [f"127.0.0.1:{s.port}" for s in servers]
        fetch = _recorded(nodes + ["127.0.0.1:1"], SCRAPED)
        saved = (cluster_top.fetch_json, ref_top.fetch_json)
        cluster_top.fetch_json = ref_top.fetch_json = fetch
        try:
            mine = cluster_top.scrape(nodes + ["127.0.0.1:1"])
            theirs = ref_top.scrape(nodes + ["127.0.0.1:1"])
        finally:
            cluster_top.fetch_json, ref_top.fetch_json = saved
        assert mine == theirs
        assert mine["nodes_up"] == 3 and mine["nodes_down"] == ["127.0.0.1:1"]
        # this process's /backends keeps the rows of earlier cases'
        # channels too
        rows = {k: v for k, v in mine["backends"].items()
                if k in {s.addr for s in servers}}
        assert len(rows) == 2 and sum(r["completed"] for r in rows.values()) \
            == 40, rows
        pages = [fetch(n, "/backends") for n in nodes]
        assert cluster_top.merge_backends(pages) == \
            ref_top.merge_backends(pages)
        # the same page twice: the counters double, the percentiles hold
        twice = cluster_top.merge_backends(pages + pages[:1])
        for k, r in rows.items():
            assert twice[k]["completed"] == 2 * r["completed"]
            assert twice[k]["latency_p99_us"] == r["latency_p99_us"]
        text = cluster_top.render(mine)
        assert text == ref_top.render(theirs)
        assert "node 127.0.0.1:1: DOWN" in text and "qps " in text
        assert f"node 127.0.0.1:{admin_ep.port}: processed=" in text
    finally:
        if ch is not None:
            ch.close()
        admin.stop()
        admin.join(2)
        for s in servers:
            s.close()


def case_cluster_top_smoke():
    out = _run_module("cluster_top", ["--smoke"], timeout_s=120,
                      env={"BRPC_TPU_TORCH_PERF_SMOKE": "0"})
    assert out["forbidden"] == "[]", out["forbidden"]
    doc = json.loads(out["stdout"])
    assert out["rc"] == 0 and doc["ok"], doc
    assert doc["scrape_matches_bvars"] and doc["attributed"] and \
        doc["merge_matches"], doc
    assert doc["nodes_up"] == 3 and doc["backends"] == 2, doc
    assert "backend_stats_overhead_pct" not in doc


def case_cluster_top_json_timeline_block():
    server = Server(ServerOptions(enable_builtin_services=True))
    ep = server.start("tcp://127.0.0.1:0")
    try:
        for i in range(3):
            series_sample_tick(wall_t=1000 + i)
        node = f"127.0.0.1:{ep.port}"
        view = cluster_top.scrape([node])
        assert view["nodes_up"] == 1
        tl = view["timeline"].get(node)
        assert tl is not None and "qps" in tl, view["timeline"]
        assert isinstance(tl["qps"], list) and len(tl["qps"]) >= 2
        assert "qps " in cluster_top.render(view)
        # the CLI's --once --json prints the same view's keys
        out = _run_module("cluster_top", [node, "--once", "--json"])
        assert out["rc"] == 0 and out["forbidden"] == "[]", out
        doc = json.loads(out["stdout"])
        assert sorted(doc) == sorted(view) and doc["nodes_up"] == 1
    finally:
        server.stop()
        server.join(2)


CASES = [
    ("run_pipelined against brpc_tpu's", case_run_pipelined, ()),
    ("bench_echo_server's methods, both clients", case_bench_echo_server,
     ()),
    ("bench_echo_server exits with its parent",
     case_echo_server_exits_with_its_parent, ()),
    ("drive_multiproc on a port and a list", case_drive_multiproc, ()),
    ("soak and its idle-connection mode", case_soak, ()),
    ("fiber_stacks over HTTP and by SIGUSR2", case_fiber_stacks, ()),
    ("cluster_top against brpc_tpu's", case_cluster_top_against_brpc_tpu,
     ()),
    ("cluster_top --smoke", case_cluster_top_smoke, ()),
    ("cluster_top's timeline block", case_cluster_top_json_timeline_block,
     ()),
]


def test_load_tools():
    _run_cases(CASES, limit_s=60)
