"""The port's chaos lane (``brpc_tpu_torch/chaos/``) against brpc_tpu's,
on the CPU.

- ``FaultPlan.to_json`` of the same script is byte for byte brpc_tpu's,
  scripted and ``random(seed)`` alike, and each side's ``from_json``
  reads the other's document back to the same bytes.
- The seeded schedule: the same cloned plan against the same call
  sequence fires the same ``(kind, connection)`` faults in the port as
  in brpc_tpu, and again in a second port run.
- Each fault kind on ``mem://`` and ``tcp://`` reaches its verdict (a
  delay delivers late, a drop, a corruption and a stall fail the call,
  a refusal and a flap are retried past) and moves its
  ``chaos_injected_*`` counter by one; the counters are on
  ``/connections``' robustness pane.
- A wrapped conn is never ring-native: on the ring's batch backend a
  chaos-wrapped tcp socket is not ring-attached and its calls answer.
- The native lanes move no byte past the script: ``serve_drain``'s and
  ``serve_scan``'s responses (tcp and ``mem://``), the turbo lane's
  response and the pluck lane's small-frame requests are delayed by a
  ``delay``, and cut by a ``drop``.
- ``install``/``uninstall`` restores the transport registry, and a
  seeded storm leaves no socket, attempt, lease or installed plan.

One collected test over the cases (``_run_cases`` of
test_torch_cluster.py, whose leak check also fails a case that leaves a
plan installed).
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time

from brpc_tpu import chaos as ref_chaos
from brpc_tpu.rpc import (Channel as RefChannel,
                          ChannelOptions as RefChannelOptions,
                          Server as RefServer,
                          ServerOptions as RefServerOptions,
                          Service as RefService)

from brpc_tpu_torch import chaos
from brpc_tpu_torch.builtin.services import connections_page
from brpc_tpu_torch.butil.endpoint import str2endpoint
from brpc_tpu_torch.chaos import Fault, FaultPlan
from brpc_tpu_torch.chaos.inject import ChaosConn, chaos_counters
from brpc_tpu_torch.rpc import (Channel, ChannelOptions, Server, Service,
                                client_dispatch, server_dispatch)
from brpc_tpu_torch.rpc import errno_codes as berr
from brpc_tpu_torch.transport import base as port_base
from brpc_tpu_torch.transport import socket as port_socket
from brpc_tpu_torch.transport.socket_map import global_socket_map

from test_torch_cluster import ROOT, _run_cases, _wait_for

_seq = iter(range(100000))


def _address(scheme):
    """A fresh address, known before the server starts: accept-side
    faults wrap a listener only when the plan is installed before it
    listens, and the plan is keyed on the address."""
    if scheme == "mem":
        return f"mem://port-chaos-{next(_seq)}"
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def _serve(scheme="mem", native=False, addr=None):
    """A port server whose ``C.Echo`` echoes (the C echo loop's method
    with ``native``) at ``addr`` or a fresh address; its address,
    canonical for a plan."""
    server = Server()
    svc = Service("C")
    if native:
        svc.register_method("Echo", lambda cntl, req: req, native="echo")
    else:
        svc.register_method("Echo", lambda cntl, req: bytes(req))
    server.add_service(svc)
    return server, str(server.start(addr or _address(scheme)))


def _stop(server):
    server.stop()
    server.join(5)


def _channel(addr, **kw):
    kw.setdefault("share_connections", False)
    return Channel(addr, ChannelOptions(**kw))


def _counts():
    return {k: v.get_value() for k, v in chaos_counters.items()}


def _moved(before):
    return {k: v - before[k] for k, v in _counts().items()
            if v != before[k]}


class _Installed:
    """``chaos.install(plan)`` for the block, ``uninstall`` after it."""

    def __init__(self, plan):
        self.plan = plan

    def __enter__(self):
        chaos.install(self.plan)
        return self.plan

    def __exit__(self, *exc):
        chaos.uninstall()


# ------------------------------------------------------------------ plans
def _scripted(mod):
    F, P = mod.Fault, mod.FaultPlan
    return (P(seed=3)
            .at("mem://a", 1, F("corrupt", at_byte=8, xor_mask=0x41))
            .at("tcp://127.0.0.1:7001", 0,
                F("delay", at_byte=5, delay_ms=40.5),
                F("drop", at_byte=90, side="accept"))
            .at("mem://a", 4, F("partial_stall", at_byte=16))
            .refuse("mem://a", 2, 9)
            .flap("tcp://127.0.0.1:7001", at_conn=3, refuse_next=4))


def case_plan_json():
    eps = ["mem://x", "tcp://127.0.0.1:9000", "mem://y"]
    pairs = [(_scripted(chaos), _scripted(ref_chaos))]
    for seed in range(24):
        kinds = ("delay", "drop", "corrupt", "partial_stall")[:1 + seed % 4]
        pairs.append((FaultPlan.random(seed, eps, conns=8,
                                       fault_rate=0.5, kinds=kinds),
                      ref_chaos.FaultPlan.random(seed, eps, conns=8,
                                                 fault_rate=0.5,
                                                 kinds=kinds)))
    for port, ref in pairs:
        doc = port.to_json()
        assert doc == ref.to_json()
        assert FaultPlan.from_json(ref.to_json()).to_json() == doc
        assert ref_chaos.FaultPlan.from_json(doc).to_json() == doc
        assert port.clone().to_json() == doc
        assert port.schemes() == ref.schemes()
    assert json.loads(pairs[0][0].to_json())["flaps"] == {
        "tcp://127.0.0.1:7001": {"3": 4}}


def _schedule_run(side, plan, addr):
    """The reference's determinism drive: six channels, one call each,
    under the plan; the fired log."""
    mod = chaos if side == "port" else ref_chaos
    mod.install(plan)
    try:
        for i in range(6):
            if side == "port":
                ch = _channel(addr, timeout_ms=500, max_retry=2)
            else:
                ch = RefChannel(addr, RefChannelOptions(
                    timeout_ms=500, max_retry=2, share_connections=False))
            c = ch.call_sync("C", "Echo", b"m%d" % i)
            assert c.error_code is not None
            ch.close()
    finally:
        mod.uninstall()
    return plan.fired()


def _ref_serve():
    server = RefServer(RefServerOptions(enable_builtin_services=False))
    svc = RefService("C")

    @svc.method()
    def Echo(cntl, request):
        return bytes(request)
    server.add_service(svc)
    addr = f"mem://ref-chaos-{next(_seq)}"
    server.start(addr)
    return server, addr


def case_fired_schedule():
    def script(mod, addr):
        F = mod.Fault
        return (mod.FaultPlan(seed=3)
                .at(addr, 1, F("corrupt", at_byte=8))
                .refuse(addr, 2)
                .at(addr, 3, F("drop", at_byte=10))
                .at(addr, 4, F("delay", at_byte=5, delay_ms=40)))
    server, addr = _serve()
    ref_server, ref_addr = _ref_serve()
    try:
        runs = [_schedule_run("port", script(chaos, addr).clone(), addr)
                for _ in range(2)]
        ref = _schedule_run("ref", script(ref_chaos, ref_addr), ref_addr)
    finally:
        _stop(server)
        ref_server.stop()
    # the same faults fire at the same connections; the log's order may
    # interleave, since a write records its fault after the peer (on the
    # dispatcher) may already have failed the call and its retry fired
    # the next one
    strip = sorted((k, i) for k, _, i in runs[0])
    assert sorted(runs[0]) == sorted(runs[1]), runs
    assert strip == sorted((k, i) for k, _, i in ref), (runs[0], ref)
    assert strip == [("corrupt", 1), ("delay", 4), ("drop", 3),
                     ("refuse", 2)], strip


# -------------------------------------------------------------- the kinds
def _kind(kind, scheme):
    """One fault kind on one scheme: its verdict and its counter."""
    server, addr = _serve(scheme)
    before = _counts()
    try:
        if kind == "refuse":
            with _Installed(FaultPlan(seed=1).refuse(addr, 0)):
                ch = _channel(addr, timeout_ms=2000, max_retry=2)
                c = ch.call_sync("C", "Echo", b"hello")
                ch.close()
            assert not c.failed() and c.current_try >= 1, c.error_text
        elif kind == "drop":
            with _Installed(FaultPlan(seed=1).at(
                    addr, 0, Fault("drop", at_byte=10))):
                ch = _channel(addr, timeout_ms=800, max_retry=0)
                c = ch.call_sync("C", "Echo", b"x" * 64)
                ch.close()
            assert c.error_code in (berr.EFAILEDSOCKET, berr.ECLOSE,
                                    berr.ERPCTIMEDOUT), c.error_code
        elif kind == "delay":
            with _Installed(FaultPlan(seed=1).at(
                    addr, 0, Fault("delay", at_byte=5, delay_ms=80))):
                ch = _channel(addr, timeout_ms=3000)
                t0 = time.monotonic()
                c = ch.call_sync("C", "Echo", b"delayed")
                dt = time.monotonic() - t0
                ch.close()
            assert c.response == b"delayed" and dt >= 0.07, (c.error_text,
                                                             dt)
        elif kind == "corrupt":
            with _Installed(FaultPlan(seed=1).at(
                    addr, 0, Fault("corrupt", at_byte=2, xor_mask=0x41))):
                ch = _channel(addr, timeout_ms=800, max_retry=0)
                c = ch.call_sync("C", "Echo", b"payload")
                ch.close()
            assert c.failed() or c.response != b"payload"
        elif kind == "partial_stall":
            with _Installed(FaultPlan(seed=1).at(
                    addr, 0, Fault("partial_stall", at_byte=8))):
                ch = _channel(addr, timeout_ms=200, max_retry=0)
                t0 = time.monotonic()
                c = ch.call_sync("C", "Echo", b"stalled-forever")
                ch.close()
            assert c.error_code == berr.ERPCTIMEDOUT and \
                time.monotonic() - t0 < 5.0, c.error_code
        else:
            plan = FaultPlan(seed=1).flap(addr, at_conn=1, refuse_next=2)
            with _Installed(plan):
                ch0 = _channel(addr, timeout_ms=800, max_retry=0)
                assert ch0.call_sync("C", "Echo", b"pre").response == \
                    b"pre"
                try:
                    port_base.get_transport(scheme).connect(
                        str2endpoint(addr))
                    raise AssertionError("the flap's connect went through")
                except ConnectionError:
                    pass
                # the dropped conn is seen (the probe before reuse, on a
                # sticky socket) and its redial is refused
                time.sleep(0.01)
                assert ch0.call_sync("C", "Echo", b"down").failed()
                ch = _channel(addr, timeout_ms=1000, max_retry=0)
                c = ch.call_sync("C", "Echo", b"back")
                ch.close()
                ch0.close()
            assert c.response == b"back", c.error_text
            kinds = [k for k, _, _ in plan.fired()]
            assert kinds.count("flap") == 1 and kinds.count("refuse") >= 1
        moved = _moved(before)
        name = {"partial_stall": "partial"}.get(kind, kind)
        assert moved.get(name) == 1, moved
        if kind != "flap":
            assert set(moved) == {name}, moved
        # the counters stand on /connections' robustness pane
        pane = connections_page(server)["robustness"]
        assert pane[f"chaos_injected_{name}"] == \
            chaos_counters[name].get_value()
    finally:
        _stop(server)


# --------------------------------------------------------- ring and lanes
_RING = r"""
import json, os, sys
sys.path.insert(0, os.getcwd())
from brpc_tpu_torch.transport import event_dispatcher as ped, ring_lane
ped._global = ring_lane.RingDispatcher(backend=1)
from brpc_tpu_torch import chaos
from brpc_tpu_torch.chaos import Fault, FaultPlan
from brpc_tpu_torch.chaos.inject import ChaosConn
from brpc_tpu_torch.rpc import Channel, ChannelOptions, Server, Service

svc = Service("C")
svc.register_method("Echo", lambda cntl, req: bytes(req))
server = Server()
server.add_service(svc)
ep = server.start("tcp://127.0.0.1:0")
addr = str(ep)
plain = Channel(addr, ChannelOptions(timeout_ms=5000,
                                     share_connections=False))
assert plain.call_sync("C", "Echo", b"p").response == b"p"
chaos.install(FaultPlan(seed=1).at(addr, 0,
                                   Fault("delay", at_byte=5, delay_ms=60)))
try:
    ch = Channel(addr, ChannelOptions(timeout_ms=5000,
                                      share_connections=False))
    got = [ch.call_sync("C", "Echo", b"c%d" % i).response
           for i in range(8)]
    s = ch._socket
    out = {"plain_attached": plain._socket._ring_attached,
           "wrapped": isinstance(s.conn, ChaosConn),
           "attached": s._ring_attached, "sink": s.conn.supports_ring_sink,
           "answers": got == [b"c%d" % i for i in range(8)],
           "dispatcher": type(ped.global_dispatcher()).__name__}
    ch.close()
finally:
    chaos.uninstall()
plain.close()
server.stop()
print(json.dumps(out))
"""


def case_never_ring_native():
    conn = ChaosConn(object(), None, FaultPlan(), "tcp://x:1", 0)
    assert conn.supports_ring_sink is False and conn.ring_attached is False
    assert conn.writev is None
    env = dict(os.environ, BRPC_TPU_FLAG_EVENT_RING_LANE="0")
    p = subprocess.run([sys.executable, "-c", _RING], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, (p.stdout + p.stderr)[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r == {"plain_attached": True, "wrapped": True,
                 "attached": False, "sink": False, "answers": True,
                 "dispatcher": "RingDispatcher"}, r


def _timed_call(ch, body, **kw):
    t0 = time.monotonic()
    c = ch.call_sync("C", "Echo", body, **kw)
    return c, time.monotonic() - t0


def case_native_lanes_cross_the_script():
    """Every native lane's outbound bytes go through the wrapped conn:
    a delay holds them, a drop cuts them."""
    # serve_drain: the server's C echo loop answers; its responses are
    # the accept side's writes, wrapped from a listener started under
    # the plan
    for scheme in ("tcp", "mem"):
        addr = _address(scheme)
        plan = (FaultPlan(seed=1)
                .at(addr, 0, Fault("delay", at_byte=1, delay_ms=120,
                                   side="accept"))
                .at(addr, 1, Fault("drop", at_byte=0, side="accept")))
        d0 = server_dispatch.nserve_drain.get_value()
        with _Installed(plan):
            server, _ = _serve(scheme, native=True, addr=addr)
            try:
                ch = _channel(addr, timeout_ms=None)
                c, dt = _timed_call(ch, b"held")
                assert c.response == b"held" and dt >= 0.1, \
                    (scheme, c.error_text, dt)
                c, _ = _timed_call(ch, b"again")
                assert c.response == b"again"
                ch.close()
                ch = _channel(addr, timeout_ms=800, max_retry=0)
                c, _ = _timed_call(ch, b"cut")
                # the server counts a drain after its response's write,
                # which the drop cuts: the client can read the EOF (or
                # time out) before that thread adds it
                _wait_for(lambda: server_dispatch.nserve_drain.get_value()
                          - d0 == 3)
                ch.close()
            finally:
                _stop(server)
        assert c.error_code in (berr.EFAILEDSOCKET, berr.ECLOSE,
                                berr.ERPCTIMEDOUT), (scheme, c.error_code)
        assert server_dispatch.nserve_drain.get_value() - d0 == 3, scheme
        assert [k for k, _, _ in plan.fired()] == ["delay", "drop"]
    # the turbo lane: a deadline-less request to a plain handler is
    # served by the slim body, whose response is the accept side's write
    addr = _address("tcp")
    t0_turbo = server_dispatch.nturbo_requests.get_value()
    with _Installed(FaultPlan(seed=1).at(
            addr, 0, Fault("delay", at_byte=1, delay_ms=120,
                           side="accept"))):
        server, _ = _serve("tcp", addr=addr)
        try:
            ch = _channel(addr, timeout_ms=None)
            c, dt = _timed_call(ch, b"turbo")
            ch.close()
        finally:
            _stop(server)
    assert c.response == b"turbo" and dt >= 0.1, (c.error_text, dt)
    assert server_dispatch.nturbo_requests.get_value() - t0_turbo == 1
    # the sync pluck lane: requests are the connect side's writes (the
    # small-frame pack path), the response is plucked off the fd
    server, addr = _serve("tcp")
    try:
        p0 = port_socket.npluck_fast.get_value()
        with _Installed(FaultPlan(seed=1).at(
                addr, 0, Fault("delay", at_byte=3, delay_ms=100))):
            ch = _channel(addr, timeout_ms=3000)
            c, dt = _timed_call(ch, b"plucked")
            ch.close()
        assert c.response == b"plucked" and dt >= 0.09, (c.error_text, dt)
        assert port_socket.npluck_fast.get_value() - p0 == 1
        with _Installed(FaultPlan(seed=1).at(
                addr, 0, Fault("drop", at_byte=3))):
            ch = _channel(addr, timeout_ms=800, max_retry=0)
            c, _ = _timed_call(ch, b"plucked")
            ch.close()
        assert c.error_code in (berr.EFAILEDSOCKET, berr.ECLOSE), \
            c.error_code
    finally:
        _stop(server)


def case_install_and_storm():
    before = dict(port_base._transports)
    leases = global_socket_map().leases()
    servers = [_serve("mem"), _serve("tcp")]
    addrs = [a for _, a in servers]
    plan = FaultPlan.random(29, addrs, conns=24, fault_rate=0.5)
    assert plan.schemes() == {"mem", "tcp"}
    results, lock = [], threading.Lock()
    try:
        chaos.install(plan)
        try:
            assert chaos.installed_plan() is plan
            try:
                chaos.install(FaultPlan())
                raise AssertionError("a second plan was installed")
            except RuntimeError:
                pass
            assert {s: type(t).__name__ for s, t in
                    port_base._transports.items() if s in ("mem", "tcp")} \
                == {"mem": "ChaosTransport", "tcp": "ChaosTransport"}

            def client(k):
                ch = _channel(addrs[k % 2], timeout_ms=300, max_retry=1)
                for i in range(6):
                    c = ch.call_sync("C", "Echo", b"%d-%d" % (k, i))
                    with lock:
                        results.append(c.error_code)
                ch.close()
            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(30)
            assert not any(t.is_alive() for t in threads), "a call hung"
        finally:
            chaos.uninstall()
        chaos.uninstall()               # idempotent
        assert port_base._transports == before
        assert chaos.installed_plan() is None
        # every call reached a verdict, some were hit and some answered
        assert len(results) == 48 and 0 in results and \
            any(results), results
        assert plan.fired()
        assert _wait_for(lambda: client_dispatch.inflight_attempts() == 0)
        assert global_socket_map().leases() == leases
    finally:
        for server, _ in servers:
            _stop(server)


CASES = [
    ("FaultPlan.to_json against brpc_tpu's", case_plan_json, ()),
    ("the fired schedule against brpc_tpu's", case_fired_schedule, ()),
]
CASES += [(f"{kind} on {scheme}://", _kind, (kind, scheme))
          for scheme in ("mem", "tcp")
          for kind in ("refuse", "drop", "delay", "corrupt",
                       "partial_stall", "flap")]
CASES += [
    ("a wrapped conn is never ring-native", case_never_ring_native, ()),
    ("the native lanes cross the script",
     case_native_lanes_cross_the_script, ()),
    ("install, uninstall and a storm", case_install_and_storm, ()),
]


def test_chaos():
    try:
        _run_cases(CASES)
    finally:
        chaos.uninstall()
