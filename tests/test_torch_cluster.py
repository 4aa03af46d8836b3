"""The port's cluster client against brpc_tpu's, on the CPU.

- The balancers pick as brpc_tpu's do under the same servers,
  exclusions and feedback: ``rr`` and ``wrr`` in the same order,
  ``c_hash`` and ``c_murmurhash`` the same server for each of 1,000 keys
  (``c_murmurhash`` also against brpc_tpu's pure-Python hash, in a
  process with ``BRPC_TPU_NO_NATIVE=1``), ``la`` the same weights after
  the same feedback, ``random`` and ``wr`` the same coverage.
- The breakers and the health checker reach the same state after the
  same calls, on an injected clock and a seeded jitter.
- Retry decisions by error code, an exhausted ``max_retry``, and a
  backup request's winner, the same both ways across the wire.
- A ClusterChannel over ``list://`` and ``file://`` keeps every call
  while a server is killed with calls in flight, and follows a naming
  update; DynamicPartitionChannel rebuilds its partitions from naming
  tags.
- The wire both ways: a port ClusterChannel to brpc_tpu servers and a
  brpc_tpu ClusterChannel to port servers, one server killed with
  calls in flight: every call succeeds, and each retried call's
  ``tried_servers`` names the killed server before the one that served
  it.

The cases run inside one collected test (``_run_cases``), each under a
time limit of its own, so every other test file keeps its place in
pytest-xdist's ``--dist loadfile`` queue (see test_torch_iobuf.py). No
case may leave a socket registered with the port's dispatcher, a lease
on a shared connection (``transport/socket_map.py``), nor a naming
thread, a health-check probe, a PeriodicTask, a ring dispatcher's thread
or one of the port's sampler, capture-writer and bundler threads
running, a chaos plan installed, a replay's channels open, or an h2
session, a gRPC channel, an HTTP client connection or a pipelined
client's socket (thrift, redis, memcache) left open.
"""

import json
import os
import random
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path

import brpc_tpu.fiber as ref_fiber
import brpc_tpu.rpc as ref_rpc
from brpc_tpu.butil.endpoint import str2endpoint as ref_ep
from brpc_tpu.rpc import circuit_breaker as ref_cb
from brpc_tpu.rpc import combo_channels as ref_combo
from brpc_tpu.rpc import errno_codes as ref_berr
from brpc_tpu.rpc import health_check as ref_hc
from brpc_tpu.rpc import load_balancer as ref_lb
from brpc_tpu.rpc import naming as ref_naming
from brpc_tpu.rpc import retry_policy as ref_retry

import brpc_tpu_torch.fiber as port_fiber
import brpc_tpu_torch.rpc as port_rpc
from brpc_tpu_torch.butil.endpoint import str2endpoint as port_ep
from brpc_tpu_torch.rpc import circuit_breaker as port_cb
from brpc_tpu_torch.rpc import errno_codes as berr
from brpc_tpu_torch.rpc import health_check as port_hc
from brpc_tpu_torch.rpc import load_balancer as port_lb
from brpc_tpu_torch.rpc import naming as port_naming
from brpc_tpu_torch.rpc import periodic_task as port_periodic
from brpc_tpu_torch.rpc import retry_policy as port_retry
from brpc_tpu_torch.chaos import inject as port_chaos
from brpc_tpu_torch.protocol import esp as port_esp
from brpc_tpu_torch.protocol import rtmp as port_rtmp
from brpc_tpu_torch.protocol import h2 as port_h2
from brpc_tpu_torch.protocol import http_client as port_http_client
from brpc_tpu_torch.traffic import replay as port_replay
from brpc_tpu_torch.transport import pipelined as port_pipelined
from brpc_tpu_torch.transport.socket_map import global_socket_map
from brpc_tpu_torch.transport.event_dispatcher import global_dispatcher

ROOT = Path(__file__).resolve().parent.parent
CASE_LIMIT_S = 30.0
KEYS = [f"user-{i}".encode() for i in range(1000)]


def _wait_for(cond, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.002)
    return cond()


# the port's threads that run until stopped: the flight recorder's
# sampler, a capture recorder's writer and the incident bundler
_PORT_LOOP_THREADS = ("flight_recorder", "capture_writer",
                      "incident_bundler")


def _port_loop_threads():
    """Live threads of those names whose target is the port's (brpc_tpu
    names its own the same), and every ring dispatcher's thread of the
    port, whatever its name."""
    out = []
    for t in threading.enumerate():
        mod = getattr(getattr(t, "_target", None), "__module__", "") or ""
        if (t.name in _PORT_LOOP_THREADS and
                mod.startswith("brpc_tpu_torch.")) or \
                mod == "brpc_tpu_torch.transport.ring_lane":
            out.append(t.name)
    return sorted(out)


def _child_processes():
    """The live (not zombie) processes descended from this one, as "pid
    command line": a spawned server or a load tool's worker left
    running."""
    parents, cmds = {}, {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(
                    "utf-8", "replace").strip()
        except OSError:
            continue
        if fields[0] != "Z":
            parents[int(d)] = int(fields[1])
            cmds[int(d)] = cmd
    mine, frontier = set(), {os.getpid()}
    while frontier:
        frontier = {p for p, pp in parents.items()
                    if pp in frontier and p not in mine}
        mine |= frontier
    return sorted(f"{p} {cmds[p][:200]}" for p in mine)


def _running_loops():
    """The port's fibers, timers, threads and leases that live until
    stopped or returned: naming services, health-check probes,
    PeriodicTasks, leases on shared connections, ring dispatchers, the
    flight recorder's sampler, capture writers and the incident
    bundler; an installed chaos plan and the channels of a replay in
    flight; h2 sessions, gRPC channels, HTTP client connections and the
    sockets of pipelined clients (thrift, redis, memcache, nshead), esp
    clients and RTMP clients left open, and an RTMP relay's entries
    whose socket has closed; and the child processes of this one (a
    spawned server, a load tool's worker)."""
    return {"naming threads": port_naming.live_naming_threads(),
            "health checks": port_hc.live_checks(),
            "PeriodicTasks": port_periodic.live_tasks(),
            "socket map leases": global_socket_map().leases(),
            "threads": _port_loop_threads(),
            "chaos installed": port_chaos.installed_schemes(),
            "replay channels": port_replay.live_channels(),
            "h2 sessions": port_h2.live_sessions(),
            "gRPC channels": port_h2.live_channels(),
            "HTTP client connections": port_http_client.live_clients(),
            "pipelined client sockets": port_pipelined.live_sockets(),
            "esp client sockets": port_esp.live_sockets(),
            "RTMP client sockets": port_rtmp.live_sockets(),
            "RTMP relay entries of closed sockets":
                port_rtmp.stale_entries(),
            "child processes": _child_processes()}


def _settled(before) -> bool:
    """``_running_loops()`` is back to ``before``, but for a child process
    that was there before and has ended since (an earlier test's server
    on its way out): only one that was not there may not be left."""
    now = _running_loops()
    pids = [{c.split()[0] for c in d.pop("child processes")}
            for d in (now, dict(before))]
    return now == {k: v for k, v in before.items()
                   if k != "child processes"} and pids[0] <= pids[1]


def _run_cases(cases, limit_s=CASE_LIMIT_S):
    """Run every (name, fn, args) case in order, each in a thread of its
    own under ``limit_s``; none may leave an fd registered with the
    port's dispatcher, nor a naming thread, health check, PeriodicTask,
    flight recorder, capture writer or incident bundler running. Every
    failure is reported with its traceback."""
    d = global_dispatcher()
    failed = []
    for name, fn, args in cases:
        before = set(d._handlers)
        loops = _running_loops()
        box = []

        def run():
            try:
                fn(*args)
                assert _wait_for(lambda: set(d._handlers) <= before), \
                    f"fds left registered: {set(d._handlers) - before}"
                assert _wait_for(lambda: _settled(loops)), \
                    f"left running: {_running_loops()}, before: {loops}"
            except Exception:
                box.append(traceback.format_exc())
        t = threading.Thread(target=run, daemon=True, name=f"case {name}")
        t.start()
        t.join(limit_s)
        if t.is_alive():
            failed.append(f"--- {name}\nover its {limit_s} s limit")
        elif box:
            failed.append(f"--- {name}\n{box[0]}")
    assert not failed, "\n".join(failed)


def _b(x) -> bytes:
    """A request or response body as bytes (brpc_tpu hands out IOBufs)."""
    if x is None or isinstance(x, (bytes, bytearray)):
        return bytes(x or b"")
    return x.to_bytes()


class _FakeClock:
    """A ``time`` stand-in for a module: ``monotonic`` is the test's."""

    def __init__(self, t=1000.0):
        self.t = t

    def monotonic(self):
        return self.t


class _Side:
    """The port or brpc_tpu: servers and channels of one case, closed
    when it ends."""

    def __init__(self, kind):
        self.kind = kind
        self.rpc = port_rpc if kind == "port" else ref_rpc
        self.fiber = port_fiber if kind == "port" else ref_fiber
        self.berr = berr if kind == "port" else ref_berr
        self.ep = port_ep if kind == "port" else ref_ep
        self.items = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for x in reversed(self.items):
            try:
                x.close()
            except Exception:
                pass

    def server(self, tag, delay_s=0.0, fail_code=0, address=None,
               seen=None):
        """A server whose ``Svc.Who`` answers its tag (after
        ``delay_s``), or fails ``fail_code``; ``seen`` counts requests."""
        fiber = self.fiber

        async def Who(cntl, request):
            if seen is not None:
                seen.append(tag)
            if delay_s:
                await fiber.sleep(delay_s)
            if fail_code:
                cntl.set_failed(fail_code, f"{tag} refuses")
                return b""
            return tag.encode() + b":" + _b(request)
        srv = self.rpc.Server(self.rpc.ServerOptions(
            enable_builtin_services=False))
        svc = self.rpc.Service("Svc")
        svc.register_method("Who", Who)
        srv.add_service(svc)
        ep = srv.start(address or "tcp://127.0.0.1:0")

        class _Srv:
            def __init__(self):
                self.srv, self.ep, self.alive = srv, ep, True

            def kill(self):
                """A replica that dies: its connections drop first, so
                nothing it was doing answers, then it stops."""
                self.alive = False
                for s in srv.connections():
                    s.set_failed(ConnectionError("replica killed"))
                srv.stop()
                srv.join(0)

            def close(self):
                if self.alive:
                    self.alive = False
                    srv.stop()
                    srv.join(2)
        h = _Srv()
        self.items.append(h)
        return h

    def options(self, **kw):
        if self.kind == "ref":
            kw.setdefault("share_connections", False)
        return self.rpc.ChannelOptions(**kw)

    def cluster(self, url, lb="rr", **kw):
        kw.setdefault("timeout_ms", 5000)
        ch = self.rpc.ClusterChannel(url, lb, self.options(**kw))
        self.items.append(ch)
        return ch

    def channel(self, address, **kw):
        kw.setdefault("timeout_ms", 5000)
        ch = self.rpc.Channel(address, self.options(**kw))
        self.items.append(ch)
        return ch

    def controller(self):
        return self.rpc.Controller()

    def body(self, cntl):
        if cntl.failed():
            return None
        return cntl.response if self.kind == "port" \
            else _b(cntl.response_payload)


def _key(ep) -> str:
    return f"{ep.host}:{ep.port}"


# ------------------------------------------------------------ balancers

def _picks(lb_mod, parse, name, eps, exclude_idx=(), n=24, keys=None):
    lb = lb_mod.new_load_balancer(name)
    servers = [parse(e) for e in eps]
    lb.reset_servers(servers)
    ex = {servers[i] for i in exclude_idx} or None
    if keys is not None:
        return [str(lb.select_server(ex, request_key=k)) for k in keys]
    return [str(lb.select_server(ex)) for _ in range(n)]


def _load_balancers():
    eps = [f"tcp://10.0.0.{i}:80" for i in range(1, 5)]
    weighted = [f"tcp://10.0.1.{i}:80#w={i}" for i in range(1, 4)]
    sides = (("port", port_lb, port_ep), ("ref", ref_lb, ref_ep))
    for name, servers, ex in (("rr", eps, ()), ("rr", eps, (1,)),
                              ("wrr", weighted, ()), ("wrr", weighted, (2,))):
        got = {k: _picks(m, p, name, servers, ex) for k, m, p in sides}
        assert got["port"] == got["ref"], (name, ex, got)
    for name in ("c_hash", "c_murmurhash"):
        for ex in ((), (0, 3)):
            got = {k: _picks(m, p, name, eps, ex, keys=KEYS)
                   for k, m, p in sides}
            assert got["port"] == got["ref"], (name, ex)
            assert len(set(got["port"])) == len(eps) - len(ex)
    for name in ("random", "wr"):
        got = {k: (set(_picks(m, p, name, weighted, n=400)),
                   set(_picks(m, p, name, weighted, (0,), n=200)))
               for k, m, p in sides}
        assert got["port"] == got["ref"], got
        assert len(got["port"][0]) == 3 and len(got["port"][1]) == 2
    # la: the same weights after the same feedback, rejects, abandons,
    # forced picks and a revival
    out = {}
    for kind, m, parse in sides:
        lb = m.new_load_balancer("la")
        a, b, c = (parse(e) for e in eps[:3])
        lb.reset_servers([a, b, c])
        lb.feedback(a, 800.0, False)
        lb.feedback(b, 2500.0, False)
        lb.feedback(c, 0.0, True)
        steps = []
        for only in (a, a, b, c):
            ex = {a, b, c} - {only}
            steps.append(str(lb.select_server(ex)))
        lb.feedback_reject(a)
        lb.abandon(b)
        lb.feedback(c, 0.0, True)
        lb.revive(c)
        lb.reset_servers([a, b, c, parse(eps[3])])
        steps.append([lb.decision_info(s) for s in (a, b, c)])
        steps.append([round(lb._tree.get(i), 6) for i in range(4)])
        out[kind] = steps
    assert out["port"] == out["ref"], out
    for m in (port_lb, ref_lb):
        m.register_load_balancer("first", lambda m=m: _First(m))
        lb = m.new_load_balancer("first")
        lb.reset_servers([port_ep(eps[2]), port_ep(eps[0])])
        assert str(lb.select_server()) == eps[2]
        try:
            m.new_load_balancer("no-such-balancer")
        except ValueError:
            continue
        raise AssertionError("an unknown balancer name must raise")


def _First(m):
    class First(m.RoundRobinLB):
        def select_server(self, exclude=None, request_key=None):
            servers = self._alive(exclude)
            return servers[0] if servers else None
    return First()


def _ref_murmur_ring(eps, native: bool):
    """brpc_tpu's c_murmurhash ring over ``eps`` in a fresh process: its
    picks of KEYS, through its native hash (asserted loaded there) or
    its pure-Python one (``BRPC_TPU_NO_NATIVE``)."""
    code = (
        "import json, sys\n"
        "from brpc_tpu.butil.endpoint import str2endpoint\n"
        "from brpc_tpu import native\n"
        "from brpc_tpu.rpc import load_balancer\n"
        f"assert (native.murmur3_x64_128(b'x', 0) is not None) is {native}"
        ", 'brpc_tpu native hash loaded: not ' + str({native})\n"
        "lb = load_balancer.new_load_balancer('c_murmurhash')\n"
        f"lb.reset_servers([str2endpoint(e) for e in {eps!r}])\n"
        "keys = [f'user-{i}'.encode() for i in range(1000)]\n"
        "print(json.dumps([str(lb.select_server(None, request_key=k))\n"
        "                  for k in keys]))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("BRPC_TPU_NO_NATIVE", None)
    if not native:
        env["BRPC_TPU_NO_NATIVE"] = "1"
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _murmur_without_native():
    """brpc_tpu's c_murmurhash ring through its pure-Python hash (no
    native library in that process) and through its native one (in a
    process of its own, where it must load) against the port's."""
    eps = [f"tcp://10.0.0.{i}:80" for i in range(1, 6)]
    pure = _ref_murmur_ring(eps, native=False)
    native_ring = _ref_murmur_ring(eps, native=True)
    mine = _picks(port_lb, port_ep, "c_murmurhash", eps, keys=KEYS)
    assert mine == pure == native_ring


# ------------------------------------------------ breakers and health

def _breakers(clock):
    eps = [f"tcp://10.0.0.{i}:80" for i in range(1, 5)]
    out = {}
    for kind, m, parse in (("port", port_cb, port_ep),
                           ("ref", ref_cb, ref_ep)):
        clock.t = 1000.0
        cb = m.ClusterBreakers()
        servers = [parse(e) for e in eps]
        trail = []
        pattern = [False, True, True, False, True, True, True, False]
        for i, failed in enumerate(pattern * 2):
            cb.on_call(servers[0], failed)
            cb.on_call(servers[1], i % 5 == 0)
            clock.t += 0.03
            trail.append(sorted(str(s) for s in cb.isolated_set(servers)))
        trail.append(cb.snapshot())
        clock.t += 0.5                  # the first isolation ends
        trail.append(sorted(str(s) for s in cb.isolated_set(servers)))
        for _ in range(6):              # two of four down: the gate opens
            cb.on_call(servers[2], True)
            cb.on_call(servers[0], True)
        trail.append((cb.snapshot(),
                      sorted(str(s) for s in cb.isolated_set(servers))))
        b = cb.breaker(servers[0])
        b.on_success_streak()
        trail.append((b.isolation_s, b.isolated_until, b.error_rate()))
        out[kind] = trail
    assert out["port"] == out["ref"], out
    assert any(out["port"][:16]), "no isolation in the sequence"


def _health(side_kind):
    """The dead -> revived sequence of a real endpoint: refused while
    nothing listens, revived once a server starts on its port; with an
    ``rpc_health_check`` app check, revived only by a call that works
    (a checker probing a method the server lacks keeps it dead)."""
    import socket as pysocket
    s = pysocket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    with _Side(side_kind) as side:
        m = port_hc if side_kind == "port" else ref_hc
        events = {"connect": [], "rpc": [], "bad rpc": []}
        checks = {"connect": None,
                  "rpc": m.rpc_health_check("Svc", "Who", timeout_ms=500),
                  "bad rpc": m.rpc_health_check("Svc", "Nope",
                                                timeout_ms=500)}
        hcs = {}
        for name, check in checks.items():
            hc = m.HealthChecker(
                rng=random.Random(7), app_check=check,
                on_event=lambda e, ep, name=name: events[name].append(e))
            hc.BASE_BACKOFF_S = 0.01
            hcs[name] = hc
        ep = side.ep(f"tcp://127.0.0.1:{port}")
        for hc in hcs.values():
            hc.mark_dead(ep)
        time.sleep(0.1)
        dead_before = [[_key(x) == f"127.0.0.1:{port}"
                        for x in hc.dead_set()] for hc in hcs.values()]
        side.server("revived", address=f"tcp://127.0.0.1:{port}")
        assert _wait_for(lambda: not hcs["connect"].dead_set()
                         and not hcs["rpc"].dead_set(), 5.0)
        time.sleep(0.3)
        still_dead = bool(hcs["bad rpc"].dead_set())
        for hc in hcs.values():
            hc.stop()
        return dead_before, events, still_dead


def _health_checker():
    got = {k: _health(k) for k in ("port", "ref")}
    assert got["port"] == got["ref"], got
    assert got["port"][1] == {"connect": ["dead", "revived"],
                              "rpc": ["dead", "revived"],
                              "bad rpc": ["dead"]}
    assert got["port"][2]
    # the probes' backoff schedule under the same seed
    jit = {}
    for kind, m in (("port", port_hc), ("ref", ref_hc)):
        hc = m.HealthChecker(rng=random.Random(11))
        jit[kind] = [hc._jittered(0.05 * 2 ** i) for i in range(8)]
    assert jit["port"] == jit["ref"], jit


def _with_clock(fn):
    """Run ``fn(clock)`` with both breaker modules on one fake clock."""
    clock = _FakeClock()
    saved = (port_cb.time, ref_cb.time)
    port_cb.time = ref_cb.time = clock
    try:
        fn(clock)
    finally:
        port_cb.time, ref_cb.time = saved


# -------------------------------------------------------------- retries

class _View:
    def __init__(self, code, current_try=0):
        self.error_code = code
        self.current_try = current_try


def _retry_decisions():
    codes = sorted({v for k, v in vars(berr).items()
                    if k.isupper() and isinstance(v, int)})
    mine = [port_retry.RpcRetryPolicy().do_retry(_View(c)) for c in codes]
    ref = [ref_retry.RpcRetryPolicy().do_retry(_View(c)) for c in codes]
    assert mine == ref
    assert {c for c, r in zip(codes, mine) if r} == {
        berr.EFAILEDSOCKET, berr.ECLOSE, berr.ELOGOFF, berr.ELIMIT,
        berr.EOVERCROWDED, berr.EPRIORITYSHED}
    waits = {k: [m.RetryBackoffPolicy(base_ms=10, max_ms=200,
                                      rng=random.Random(5)
                                      ).retry_backoff_s(_View(0, t))
                 for t in range(7)]
             for k, m in (("port", port_retry), ("ref", ref_retry))}
    assert waits["port"] == waits["ref"]
    # end to end: every client/server pair, ELIMIT retries until
    # max_retry is spent, EINTERNAL never retries
    for cli, srv in (("port", "port"), ("port", "ref"), ("ref", "port"),
                     ("ref", "ref")):
        with _Side(cli) as c, _Side(srv) as s:
            for code, want_seen in ((berr.ELIMIT, 3), (berr.EINTERNAL, 1)):
                seen = []
                h = s.server("r", fail_code=code, seen=seen)
                ch = c.channel(f"tcp://127.0.0.1:{h.ep.port}", max_retry=2)
                cntl = ch.call_sync("Svc", "Who", b"x")
                assert cntl.error_code == code, (cli, srv, cntl.error_code)
                assert len(seen) == want_seen, (cli, srv, code, seen)
                assert cntl.current_try == want_seen - 1


def _backup_winner():
    """rr over a slow and a fast server, backup after 30 ms: a call
    first sent to the slow one is answered by the fast one."""
    got = {}
    for kind in ("port", "ref"):
        with _Side(kind) as side:
            slow = side.server("slow", delay_s=0.3)
            fast = side.server("fast")
            ch = side.cluster(f"list://tcp://127.0.0.1:{slow.ep.port},"
                              f"tcp://127.0.0.1:{fast.ep.port}", "rr",
                              backup_request_ms=30)
            rows = []
            for i in range(4):
                cntl = ch.call_sync("Svc", "Who", b"%d" % i)
                assert not cntl.failed(), (kind, cntl.error_text)
                first = cntl.tried_servers[0].port == slow.ep.port
                rows.append((first, cntl.used_backup,
                             side.body(cntl).split(b":")[0],
                             cntl.responded_server.port == fast.ep.port))
            assert any(r[0] for r in rows) and not all(r[0] for r in rows)
            got[kind] = rows
    assert got["port"] == got["ref"], got
    for first, used_backup, who, by_fast in got["port"]:
        assert used_backup == first and who == b"fast" and by_fast


# ---------------------------------------------------- cluster channels

def _burst(ch, n):
    """``n`` calls, all in flight at once; returns the controllers."""
    cntls = [ch.call("Svc", "Who", b"%d" % i) for i in range(n)]
    for c in cntls:
        assert c.join(10)
    return cntls


def _failover(kind, url_of, killer_side=None):
    """Three servers behind a ClusterChannel of ``kind``; a burst with
    every server busy 150 ms; the middle server is killed 50 ms into it.
    Every call must succeed; the ones that were on the killed server
    retried elsewhere, its endpoint first in ``tried_servers``."""
    srv_kind = killer_side or kind
    with _Side(kind) as cli, _Side(srv_kind) as srv:
        hs = [srv.server(f"s{i}", delay_s=0.15) for i in range(3)]
        ch = cli.cluster(url_of([h.ep.port for h in hs]), "rr")
        timer = threading.Timer(0.05, hs[1].kill)
        timer.start()
        cntls = _burst(ch, 9)
        timer.join()
        assert all(not c.failed() for c in cntls), \
            [(c.error_code, c.error_text) for c in cntls if c.failed()]
        killed = hs[1].ep.port
        retried = [c for c in cntls if c.current_try]
        assert retried, "no call was on the killed server"
        for c in retried:
            ports = [e.port for e in c.tried_servers]
            assert ports[0] == killed and ports[-1] != killed, ports
            assert cli.body(c).split(b":")[0] != b"s1"
        # later calls skip the dead server
        later = [ch.call_sync("Svc", "Who", b"later") for _ in range(6)]
        assert all(not c.failed() and c.tried_servers[0].port != killed
                   for c in later)
        return len(retried)


def _list_url(ports):
    return "list://" + ",".join(f"tcp://127.0.0.1:{p}" for p in ports)


def _cluster_list_and_file():
    for kind in ("port", "ref"):
        _failover(kind, _list_url)
    saved = (port_naming.FileNamingService.interval_s,
             ref_naming.FileNamingService.interval_s)
    port_naming.FileNamingService.interval_s = 0.05
    ref_naming.FileNamingService.interval_s = 0.05
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for kind in ("port", "ref"):
                path = Path(tmp) / f"{kind}.txt"
                with _Side(kind) as side:
                    hs = [side.server(f"f{i}") for i in range(3)]
                    path.write_text("".join(
                        f"tcp://127.0.0.1:{h.ep.port}\n" for h in hs[:2]))
                    ch = side.cluster(f"file://{path}", "rr")
                    who = {side.body(ch.call_sync("Svc", "Who", b""))
                           for _ in range(6)}
                    assert who == {b"f0:", b"f1:"}, (kind, who)
                    path.write_text(f"# one left\n"
                                    f"tcp://127.0.0.1:{hs[2].ep.port}\n")
                    assert _wait_for(lambda: len(ch.servers()) == 1, 5)
                    who = {side.body(ch.call_sync("Svc", "Who", b""))
                           for _ in range(4)}
                    assert who == {b"f2:"}, (kind, who)
    finally:
        (port_naming.FileNamingService.interval_s,
         ref_naming.FileNamingService.interval_s) = saved


def _wire_both_ways():
    n = {}
    n["port->ref"] = _failover("port", _list_url, killer_side="ref")
    n["ref->port"] = _failover("ref", _list_url, killer_side="port")
    assert all(n.values()), n


def _naming_empty():
    for kind in ("port", "ref"):
        with _Side(kind) as side:
            rb = (port_retry if kind == "port" else ref_retry).RetryBudget(
                max_tokens=10)
            ch = side.cluster("list://", "rr", retry_budget=rb,
                              naming_wait_s=0.5, timeout_ms=500)
            c = ch.call_sync("Svc", "Who", b"")
            assert c.error_code == berr.ENAMINGEMPTY, (kind, c.error_code)
            assert rb.tokens() == 10.0


def _dynamic_partitions():
    got = {}
    saved = (port_naming.FileNamingService.interval_s,
             ref_naming.FileNamingService.interval_s)
    port_naming.FileNamingService.interval_s = 0.05
    ref_naming.FileNamingService.interval_s = 0.05
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for kind in ("port", "ref"):
                path = Path(tmp) / f"{kind}.txt"
                with _Side(kind) as side:
                    hs = [side.server(f"p{i}") for i in range(3)]

                    def write(nparts):
                        path.write_text("".join(
                            f"tcp://127.0.0.1:{h.ep.port}"
                            f"#partition={i}/{nparts}\n"
                            for i, h in enumerate(hs[:nparts])))
                    write(2)
                    mod = port_rpc if kind == "port" else ref_combo
                    dpc = mod.DynamicPartitionChannel(
                        f"file://{path}",
                        options=side.options(timeout_ms=5000))
                    side.items.append(dpc)
                    assert dpc.wait_ready(5)
                    rows = []
                    for nparts in (2, 3):
                        if nparts == 3:
                            gen = dpc._generation
                            write(3)
                            assert _wait_for(
                                lambda: dpc._generation > gen, 5)
                        cntl = side.controller()
                        dpc.call("Svc", "Who", b"q", cntl=cntl)
                        cntl.join(5)
                        assert not cntl.failed(), cntl.error_text
                        subs = (cntl.sub_responses if kind == "port" else
                                [_b(r) for r in cntl.sub_responses])
                        rows.append((dpc.partition_count, sorted(subs)))
                    got[kind] = rows
    finally:
        (port_naming.FileNamingService.interval_s,
         ref_naming.FileNamingService.interval_s) = saved
    assert got["port"] == got["ref"], got
    assert got["port"][1] == (3, [b"p0:q", b"p1:q", b"p2:q"])


def _stopped_replica_seen_idle():
    """A ClusterChannel sees a stopped replica with no call in flight,
    while the sticky pause is on in the process: a plain Channel's
    socket sticks after its sync calls, the ClusterChannel's never do,
    so the replica's FIN reaches the dispatcher (the socket fails
    unprobed)."""
    with _Side("port") as side:
        a, b = side.server("a"), side.server("b")
        url = f"list://tcp://127.0.0.1:{a.ep.port},tcp://127.0.0.1:{b.ep.port}"
        ch = side.cluster(url, "rr")
        plain = side.channel(f"tcp://127.0.0.1:{a.ep.port}")
        for i in range(6):
            assert side.body(ch.call_sync("Svc", "Who", b"%d" % i))
        assert side.body(plain.call_sync("Svc", "Who", b"p"))
        assert plain._socket.sticky_ok and plain._socket._pluck_sticky
        socks = dict(ch._sockets)
        assert len(socks) == 2 and not any(
            s.sticky_ok or s._pluck_sticky for s in socks.values())
        dead = socks[port_ep(f"tcp://127.0.0.1:{a.ep.port}")]
        assert not dead.client_cids
        a.kill()
        assert _wait_for(lambda: dead.failed), "the stop went unseen"
        for i in range(4):
            assert side.body(ch.call_sync("Svc", "Who", b"%d" % i)) \
                == b"b:%d" % i


CASES = [
    ("load balancers", _load_balancers, ()),
    ("c_murmurhash without the native library", _murmur_without_native,
     ()),
    ("breakers on an injected clock", _with_clock, (_breakers,)),
    ("health checker", _health_checker, ()),
    ("retry decisions and max_retry", _retry_decisions, ()),
    ("a backup request's winner", _backup_winner, ()),
    ("list:// and file:// with a server killed", _cluster_list_and_file,
     ()),
    ("an empty naming list", _naming_empty, ()),
    ("DynamicPartitionChannel", _dynamic_partitions, ()),
    ("the wire both ways, a server killed", _wire_both_ways, ()),
    ("a stopped replica seen with no call in flight",
     _stopped_replica_seen_idle, ()),
]


def test_cluster_client():
    _run_cases(CASES)
