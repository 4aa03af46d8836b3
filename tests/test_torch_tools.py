"""The port's trackme (``rpc/trackme.py``) and chaos CLI
(``tools/chaos.py``) against brpc_tpu's, on the CPU.

- trackme across the wire both ways: the port's ``maybe_ping`` against a
  brpc_tpu server with ``trackme_service()`` and brpc_tpu's against the
  port's, at the same version (severity 0) and at another one (1, with
  the message naming both versions).
- The rate limit and the backoff, on a test clock: a second ping inside
  ``trackme_interval_s`` answers the last verdict without a call; after
  a failure the next ping waits min(5 s, the interval), not a whole
  interval; the port's and brpc_tpu's answers and server calls match
  step for step.
- ``python3 -m brpc_tpu_torch.tools.chaos --smoke`` in a subprocess that
  imports no jax, brpc_tpu or protobuf: it exits 0 and its invariants
  hold as those of brpc_tpu's ``tools/chaos.py --smoke`` (seed 7) do;
  ``--scheme tcp`` runs the storms over sockets, and a failed invariant
  exits 1 with ``"ok": false``.

One collected test over the cases (``_run_cases`` of
test_torch_cluster.py).
"""

import json
import os
import subprocess
import sys

import brpc_tpu
from brpc_tpu.butil.flags import set_flag as ref_set_flag
from brpc_tpu.rpc import Server as RefServer
from brpc_tpu.rpc import trackme as ref_trackme

import brpc_tpu_torch
from brpc_tpu_torch.butil.flags import set_flag
from brpc_tpu_torch.rpc import Server
from brpc_tpu_torch.rpc import trackme

from test_torch_cluster import ROOT, _FakeClock, _run_cases

FORBIDDEN_MODULES = ("jax", "jaxlib", "brpc_tpu", "google.protobuf")


class _Side:
    """A trackme server and the other package's client settings."""

    def __init__(self, server_kind):
        self.srv = Server() if server_kind == "port" else RefServer()
        mod = trackme if server_kind == "port" else ref_trackme
        self.srv.add_service(mod.trackme_service())
        self.ep = self.srv.start("tcp://127.0.0.1:0")

    def close(self):
        self.srv.stop()
        self.srv.join(5)


def _fresh(mod):
    mod._last_result = None
    mod._last_ping = float("-inf")


def _ping(kind, server, interval=30.0):
    if kind == "port":
        set_flag("trackme_server", server)
        set_flag("trackme_interval_s", interval)
        return trackme.maybe_ping()
    ref_set_flag("trackme_server", server)
    ref_set_flag("trackme_interval_s", interval)
    return ref_trackme.maybe_ping()


def _off():
    set_flag("trackme_server", "")
    ref_set_flag("trackme_server", "")


def case_across_the_wire():
    for server_kind, client_kind in (("ref", "port"), ("port", "ref")):
        side = _Side(server_kind)
        try:
            client = trackme if client_kind == "port" else ref_trackme
            _fresh(client)
            assert _ping(client_kind, str(side.ep)) == \
                {"severity": 0, "message": ""}
            # the client at another version
            pkg = brpc_tpu_torch if client_kind == "port" else brpc_tpu
            saved = pkg.__version__
            pkg.__version__ = "9.9.9"
            try:
                _fresh(client)
                got = _ping(client_kind, str(side.ep))
            finally:
                pkg.__version__ = saved
            assert got["severity"] == trackme.TRACKME_WARNING == \
                ref_trackme.TRACKME_WARNING, got
            assert "9.9.9" in got["message"] and \
                saved in got["message"], got
        finally:
            _off()
            side.close()
    # off: no ping at all
    _fresh(trackme)
    assert trackme.maybe_ping() is None


def case_rate_limit_and_backoff():
    """The same clock steps through both packages' ``maybe_ping``: the
    answers and the server's calls match."""
    side = _Side("port")
    calls = []
    m = side.srv.find_method("TrackMeService", "Ping")
    real = m.handler

    def counted(cntl, request):
        calls.append(1)
        return real(cntl, request)
    m.handler = counted
    # a port that nothing listens on: the failure
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = f"tcp://127.0.0.1:{s.getsockname()[1]}"
    live = str(side.ep)
    steps = [(0.0, live), (10.0, live), (31.0, live), (40.0, dead),
             (62.0, dead), (63.0, dead), (67.5, live), (70.0, live),
             (97.0, live)]
    out = {}
    try:
        for kind, mod in (("port", trackme), ("ref", ref_trackme)):
            clock = _FakeClock(5000.0)
            saved = mod.time
            mod.time = clock
            _fresh(mod)
            mod._last_ping = 0.0        # the reference's first stamp
            n0 = len(calls)
            rows = []
            try:
                for t, server in steps:
                    clock.t = 5000.0 + t
                    got = _ping(kind, server)
                    rows.append((t, got, len(calls) - n0))
            finally:
                mod.time = saved
                _off()
            out[kind] = rows
    finally:
        side.close()
    assert out["port"] == out["ref"], out
    ok = {"severity": 0, "message": ""}
    # a call at 0, none at 10 (the interval), one at 31; the failures at
    # 62, none at 63 (the last verdict), one at 67.5 (the 5 s backoff)
    assert [c for _, _, c in out["port"]] == [1, 1, 2, 2, 2, 2, 3, 3, 3], \
        out["port"]
    assert out["port"][1][1] == ok and out["port"][4][1] is None


def _run_cli(argv, timeout_s=300):
    """The port's CLI run as ``python3 -m``, with no PYTHONPATH: its JSON
    report, exit code, and the forbidden modules it imported."""
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['chaos'] + {argv!r}\n"
        "rc = 0\n"
        "try:\n"
        "    runpy.run_module('brpc_tpu_torch.tools.chaos',\n"
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
    lines = proc.stdout.strip().splitlines()
    assert lines and lines[-1].startswith("FORBIDDEN"), \
        proc.stdout + proc.stderr[-2000:]
    return (json.loads("\n".join(lines[:-1])), proc.returncode,
            lines[-1][len("FORBIDDEN "):])


def _invariants(report):
    d, m = report["deadline"], report["mixed"]
    return {"ok": report.get("ok", True),
            "deadline_keys": sorted(d),
            "expired_shed_ratio_ok": d["expired_shed_ratio"] >= 0.99,
            "served_expired": d["served_expired"],
            "mixed_keys": sorted(set(m) - {"scheme"}),
            "isolated_then_revived": m["isolated_then_revived"],
            "leaks": m["leaks"],
            "every_call_a_verdict": sum(m["verdicts"].values()) ==
            m["calls"],
            "some_ok": m["verdicts"]["ok"] > 0,
            "seed": m["seed"]}


def case_chaos_cli():
    ref = subprocess.Popen(
        [sys.executable, "tools/chaos.py", "--smoke"], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    try:
        mine, rc, bad = _run_cli(["--smoke"])
        ref_out, ref_err = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert rc == 0 and bad == "[]", (rc, bad)
    assert ref.returncode == 0, ref_err[-2000:]
    theirs = json.loads(ref_out)
    assert mine["ok"] is True and theirs["ok"] is True
    assert _invariants(dict(mine["smoke"], ok=mine["ok"])) == \
        _invariants(dict(theirs["smoke"], ok=theirs["ok"]))
    assert mine["smoke"]["mixed"]["scheme"] == "mem"
    # over sockets, and a failed invariant's exit
    tcp, rc, bad = _run_cli(["--scheme", "tcp", "--calls", "60"])
    assert rc == 0 and bad == "[]" and tcp["ok"] is True
    assert tcp["mixed"]["scheme"] == "tcp" and \
        tcp["mixed"]["isolated_then_revived"]
    assert _invariants(tcp)["expired_shed_ratio_ok"]


def case_chaos_cli_failure_exit():
    """An invariant that fails prints ``"ok": false`` and exits 1."""
    code = (
        "import json, sys\n"
        "from brpc_tpu_torch.tools import chaos\n"
        "def bad(*a, **k):\n"
        "    assert False, 'flapped peer never revived after the storm'\n"
        "chaos.mixed_storm = bad\n"
        "chaos.deadline_storm = lambda *a, **k: {}\n"
        "sys.exit(chaos.main(['--seed', '7']))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stderr[-2000:]
    doc = json.loads(proc.stdout)
    assert doc == {"ok": False,
                   "invariant": "flapped peer never revived after the "
                                "storm"}, doc


CASES = [
    ("trackme across the wire", case_across_the_wire, ()),
    ("trackme's rate limit and backoff", case_rate_limit_and_backoff, ()),
    ("the chaos CLI against brpc_tpu's", case_chaos_cli, ()),
    ("the chaos CLI's failure exit", case_chaos_cli_failure_exit, ()),
]


def test_tools():
    _run_cases(CASES, limit_s=120)
