"""The port's async client against brpc_tpu's, on the CPU.

Each case runs the same calls, with the same payloads made from a numpy
seed, through the port and through brpc_tpu, and wants the same outcome:

- ``call(done=)``: every done runs once, with the response of its own
  call; ``join`` on a thread; ``join_async`` in a fiber handler that
  awaits ``call_async`` to a second server;
- the deadline timer (ERPCTIMEDOUT near the timeout, the late response
  dropped, the timer unscheduled once the call completes, none armed for
  a call that completed before ``call`` returned); responses racing the
  timer (each call completes once, OK or ERPCTIMEDOUT); ``start_cancel``
  (ECANCELED at once, done once, the late response dropped);
- ``notify_on_cancel`` and ``is_canceled`` in a handler whose client
  dies;
- deadline and trace inheritance along a chain client -> A -> B, where
  B is a brpc_tpu server that reads the request meta's ``timeout_ms``
  and ``trace_id``: A a port server calling with a port Channel, and the
  same chain of brpc_tpu servers and Channels; a parent whose budget is
  spent fails the nested call ERPCTIMEDOUT and B sees no request;
- the wire both ways: a port Channel's ``call(done=)`` to a brpc_tpu
  server, a brpc_tpu Channel to a port server whose async handler
  awaits ``call_async``;
- a reused controller starts clean, and the port's
  ``current_serving_controller()`` is set in place, after a plain
  handler's hop to a worker, and over HTTP.

The cases run inside one collected test (``_run_cases``), so every other
test file keeps its place in pytest-xdist's ``--dist loadfile`` queue
(see test_torch_iobuf.py).
"""

import threading
import time
import traceback

import numpy as np

from brpc_tpu import fiber as ref_fiber
from brpc_tpu.fiber.timer import global_timer as ref_global_timer
from brpc_tpu.rpc import Channel as RefChannel
from brpc_tpu.rpc import ChannelOptions as RefChannelOptions
from brpc_tpu.rpc import Controller as RefController
from brpc_tpu.rpc import Server as RefServer
from brpc_tpu.rpc import ServerOptions as RefServerOptions
from brpc_tpu.rpc import Service as RefService
from brpc_tpu.rpc import errno_codes as ref_berr
from brpc_tpu.rpc import server_dispatch as ref_dispatch
from brpc_tpu_torch import fiber as port_fiber
from brpc_tpu_torch.fiber.timer import global_timer
from brpc_tpu_torch.rpc import (Channel, ChannelOptions, Controller, Server,
                                ServerOptions, Service, errno_codes as berr)
from brpc_tpu_torch.transport.event_dispatcher import global_dispatcher

SIDES = ("port", "ref")


def _wait_for(cond, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.002)
    return cond()


def _run_cases(cases):
    """Run every (name, fn, args) case in order; none may leave an fd
    registered with the port's dispatcher. Every failure is reported,
    each with its traceback."""
    d = global_dispatcher()
    failed = []
    for name, fn, args in cases:
        before = set(d._handlers)
        try:
            fn(*args)
            assert _wait_for(lambda: set(d._handlers) <= before), \
                f"fds left registered: {set(d._handlers) - before}"
        except Exception:
            failed.append(f"--- {name}\n{traceback.format_exc()}")
    assert not failed, "\n".join(failed)


def _payloads(seed, n=8):
    rng = np.random.RandomState(seed)
    return [rng.bytes(int(rng.randint(1, 64))) for _ in range(n)]


class _Side:
    """The port or brpc_tpu: servers, channels and controllers of one
    case, closed when it ends."""

    def __init__(self, kind):
        self.kind = kind
        self.fiber = port_fiber if kind == "port" else ref_fiber
        self.berr = berr if kind == "port" else ref_berr
        self.items = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for x in reversed(self.items):
            x.close()

    def server(self, methods, address="tcp://127.0.0.1:0"):
        if self.kind == "port":
            srv = Server(ServerOptions(enable_builtin_services=False))
            svc = Service("Svc")
        else:
            srv = RefServer(RefServerOptions(enable_builtin_services=False))
            svc = RefService("Svc")
        for name, fn in methods.items():
            svc.register_method(name, fn)
        srv.add_service(svc)
        ep = srv.start(address)

        class _Srv:
            def close(self):
                srv.stop()
                srv.join(2)
        self.items.append(_Srv())
        return str(ep)

    def channel(self, address, timeout_ms=5000):
        if self.kind == "port":
            ch = Channel(address, ChannelOptions(timeout_ms=timeout_ms))
        else:
            ch = RefChannel(address, RefChannelOptions(
                timeout_ms=timeout_ms, max_retry=0,
                share_connections=False))
        self.items.append(ch)
        return ch

    def controller(self):
        return Controller() if self.kind == "port" else RefController()

    @staticmethod
    def body(cntl):
        """The response's bytes (None when failed)."""
        if cntl.failed():
            return None
        r = getattr(cntl, "response", None)
        if isinstance(r, (bytes, bytearray)):
            return bytes(r)
        return cntl.response_payload.to_bytes()

    def timer_pending(self):
        if self.kind == "port":
            return global_timer().pending()
        return ref_global_timer().pending()


def _echo(tag):
    def Echo(cntl, req):
        return tag + bytes(req)
    return Echo


def _slow(delay_s, seen=None):
    def Slow(cntl, req):
        time.sleep(delay_s)
        if seen is not None:
            seen.append(bytes(req))
        return b"late"
    return Slow


def _both(fn, *args):
    """fn(side, *args) for the port and brpc_tpu; their results must be
    equal."""
    got = {}
    for kind in SIDES:
        with _Side(kind) as side:
            got[kind] = fn(side, *args)
    assert got["port"] == got["ref"], got


# ------------------------------------------------------------------ cases

def _done_and_join(side, seed):
    """call(done=) for every payload: each done runs once, with its own
    response; then join on a thread."""
    addr = side.server({"Echo": _echo(b"e:")})
    ch = side.channel(addr)
    payloads = _payloads(seed)
    results = {}
    lock = threading.Lock()
    all_done = threading.Event()

    def cb_for(i):
        def cb(cntl):
            with lock:
                results.setdefault(i, []).append(
                    (cntl.error_code, side.body(cntl)))
                if len(results) == len(payloads):
                    all_done.set()
        return cb
    cntls = [ch.call("Svc", "Echo", p, done=cb_for(i))
             for i, p in enumerate(payloads)]
    assert all_done.wait(10)
    time.sleep(0.05)            # a second done would show here
    for c in cntls:
        assert c.join(5)
        assert c.latency_us() > 0
    joined = []
    for p in payloads:
        c = ch.call("Svc", "Echo", p)
        assert c.join(5)
        joined.append(side.body(c))
    return ([results[i] for i in range(len(payloads))], joined)


def _join_async_in_handler(side, seed):
    """A fiber handler awaits call_async to a second server."""
    back = side.server({"Echo": _echo(b"b:")})
    bch = side.channel(back)

    async def Front(cntl, req):
        c = await bch.call_async("Svc", "Echo", bytes(req))
        if c.failed():
            cntl.set_failed(c.error_code, c.error_text)
            return b""
        return b"f:" + side.body(c)
    front = side.server({"Front": Front})
    ch = side.channel(front)
    out = []
    for p in _payloads(seed, 4):
        c = ch.call_sync("Svc", "Front", p)
        out.append((c.error_code, side.body(c)))
    return out


def _deadline_timer(side):
    """A call past its timeout fails ERPCTIMEDOUT near the timeout; the
    late response is dropped; the timer goes once the call completes,
    and a call that completes inside ``call`` arms none."""
    seen = []
    addr = side.server({"Slow": _slow(0.3, seen), "Echo": _echo(b"")})
    ch = side.channel(addr, timeout_ms=60)
    pending0 = side.timer_pending()
    done = []
    t0 = time.monotonic()
    c = ch.call("Svc", "Slow", b"x", done=done.append)
    assert c.join(5)
    took = time.monotonic() - t0
    assert c.error_code == side.berr.ERPCTIMEDOUT, c.error_text
    assert 0.05 <= took < 0.29, took
    assert _wait_for(lambda: seen == [b"x"], 2)
    time.sleep(0.05)
    assert done == [c] and side.body(c) is None
    c = ch.call_sync("Svc", "Echo", b"y")
    assert side.body(c) == b"y"
    assert _wait_for(lambda: side.timer_pending() <= pending0, 2)
    # no socket to write on: the call completes before call returns
    dead = side.channel("tcp://127.0.0.1:1", timeout_ms=5000)
    c = dead.call("Svc", "Echo", b"z")
    assert c.join(5) and c.failed()
    assert side.timer_pending() <= pending0
    return (c.error_code == side.berr.EFAILEDSOCKET,)


def _racing_the_timer(side, seed):
    """Responses that race their deadline: each call completes exactly
    once, OK with its own response or ERPCTIMEDOUT."""
    rng = np.random.RandomState(seed)

    def Jitter(cntl, req):
        time.sleep(float(req[0]) / 1000.0)
        return bytes(req)
    addr = side.server({"Jitter": Jitter})
    ch = side.channel(addr, timeout_ms=20)
    counts = {}
    lock = threading.Lock()
    reqs = [bytes([int(rng.randint(10, 30)), i]) for i in range(24)]
    cntls = []
    for r in reqs:
        def cb(cntl, r=r):
            with lock:
                counts.setdefault(r, []).append(
                    (cntl.error_code, side.body(cntl)))
        cntls.append(ch.call("Svc", "Jitter", r, done=cb))
    for c in cntls:
        assert c.join(5)
    time.sleep(0.1)
    assert sorted(counts) == sorted(reqs)
    for r, got in counts.items():
        assert len(got) == 1, got
        code, body = got[0]
        assert (code, body) in ((0, r), (side.berr.ERPCTIMEDOUT, None)), got
    return True


def _start_cancel(side):
    seen = []
    addr = side.server({"Slow": _slow(0.2, seen)})
    ch = side.channel(addr)
    done = []
    c = ch.call("Svc", "Slow", b"c", done=done.append)
    t0 = time.monotonic()
    c.start_cancel()
    assert c.join(1) and time.monotonic() - t0 < 0.1
    c.start_cancel()                    # completed: nothing happens
    assert _wait_for(lambda: seen == [b"c"], 2)
    time.sleep(0.05)
    assert done == [c]
    return (c.error_code == side.berr.ECANCELED, side.body(c))


def _notify_on_cancel(side):
    """A handler parked with notify_on_cancel hears its client die."""
    state = {"fired": threading.Event(), "canceled": None}

    async def Park(cntl, req):
        cntl.notify_on_cancel(state["fired"].set)
        state["parked"] = True
        for _ in range(200):
            if cntl.is_canceled():
                state["canceled"] = True
                break
            await side.fiber.sleep(0.01)
        return b"gone"
    addr = side.server({"Park": Park})
    ch = side.channel(addr, timeout_ms=10000)
    ch.call("Svc", "Park", b"")
    assert _wait_for(lambda: state.get("parked"), 5)
    ch.close()
    assert state["fired"].wait(5)
    assert _wait_for(lambda: state["canceled"], 5)
    return True


def _spy_ref_requests():
    """Record (method, meta timeout_ms, meta trace_id) of every request a
    brpc_tpu server processes; returns (records, undo)."""
    seen = []
    orig = ref_dispatch.process_request

    def spy(proto, msg, socket):
        r = msg.meta.request
        seen.append((r.method_name, r.timeout_ms, msg.meta.trace_id))
        return orig(proto, msg, socket)
    ref_dispatch.process_request = spy

    def undo():
        ref_dispatch.process_request = orig
    return seen, undo


def _inheritance(side, b_addr, seen):
    """client -> A (this side) -> B (a brpc_tpu server): the nested call's
    meta timeout is at most what A had left, and carries the trace."""
    bch = side.channel(b_addr, timeout_ms=30000)
    left = []

    async def Relay(cntl, req):
        await side.fiber.sleep(0.05)
        left.append(cntl.remaining_ms())
        c = bch.call("Svc", "Echo", bytes(req))
        await c.join_async(5)
        if c.failed():
            cntl.set_failed(c.error_code, c.error_text)
            return b""
        return side.body(c)

    async def Spent(cntl, req):
        await side.fiber.sleep(0.12)    # past the client's 80 ms
        c = bch.call("Svc", "Echo", b"never")
        left.append((c.error_code, c.latency_us()))
        return b""
    a = side.server({"Relay": Relay, "Spent": Spent})
    ch = side.channel(a, timeout_ms=2000)
    cntl = side.controller()
    cntl.trace_id = 0x5EED
    del seen[:]
    c = ch.call_sync("Svc", "Relay", b"r", cntl=cntl)
    assert side.body(c) == b"b:r", c.error_text
    (meta_timeout,) = [t for m, t, _ in seen if m == "Echo"]
    (trace,) = [tr for m, _, tr in seen if m == "Echo"]
    assert 0 < meta_timeout <= left[0] <= 2000 - 50, (meta_timeout, left)
    ch2 = side.channel(a, timeout_ms=80)
    c = ch2.call_sync("Svc", "Spent", b"")
    assert c.error_code == side.berr.ERPCTIMEDOUT
    assert _wait_for(lambda: len(left) == 2, 2)
    code, latency_us = left[1]
    assert code == side.berr.ERPCTIMEDOUT and latency_us < 20000, left
    assert [m for m, _, _ in seen].count("Echo") == 1   # no write
    return (trace, code == side.berr.ERPCTIMEDOUT)


def _inheritance_case():
    seen, undo = _spy_ref_requests()
    try:
        with _Side("ref") as ref:
            b_addr = ref.server({"Echo": _echo(b"b:")})
            got = {kind: None for kind in SIDES}
            for kind in SIDES:
                with _Side(kind) as side:
                    got[kind] = _inheritance(side, b_addr, seen)
            assert got["port"] == got["ref"] == (0x5EED, True), got
    finally:
        undo()


def _wire_both_ways(seed):
    payloads = _payloads(seed, 6)
    with _Side("ref") as ref, _Side("port") as port:
        # a port Channel's call(done=) to a brpc_tpu server
        addr = ref.server({"Echo": _echo(b"r:")})
        ch = port.channel(addr)
        got = []
        ev = threading.Event()

        def cb(c):
            got.append(port.body(c))
            if len(got) == len(payloads):
                ev.set()
        for p in payloads:
            ch.call("Svc", "Echo", p, done=cb)
        assert ev.wait(10)
        assert sorted(got) == sorted(b"r:" + p for p in payloads)
        # a brpc_tpu Channel to a port server awaiting call_async
        back = port.server({"Echo": _echo(b"p:")})
        bch = port.channel(back)

        async def Front(cntl, req):
            c = await bch.call_async("Svc", "Echo", bytes(req))
            return b"f:" + port.body(c)
        front = port.server({"Front": Front})
        rch = ref.channel(front)
        for p in payloads:
            c = rch.call_sync("Svc", "Front", p)
            assert ref.body(c) == b"f:p:" + p, c.error_text


def _reuse_controller():
    """A controller used for a second call starts clean: its join waits
    for the new response, not the last one's."""
    with _Side("port") as side:
        addr = side.server({"Echo": _echo(b""), "Slow": _slow(0.1)})
        ch = side.channel(addr)
        c = ch.call_sync("Svc", "Echo", b"one")
        assert c.response == b"one"
        ch.call("Svc", "Slow", b"two", cntl=c)
        assert not c._finalized and c.response is None
        assert c.join(5) and c.response == b"late"


def _serving_controller_paths():
    """current_serving_controller() is the handler's own controller in
    place (a coroutine handler), after the hop to a worker (a plain
    one) and over HTTP, and None outside a handler."""
    import http.client

    from brpc_tpu_torch.rpc import current_serving_controller

    def Plain(cntl, req):
        return b"1" if current_serving_controller() is cntl else b"0"

    async def InPlace(cntl, req):
        here = current_serving_controller() is cntl
        await port_fiber.yield_now()
        return b"1" if here and current_serving_controller() is cntl \
            else b"0"
    with _Side("port") as side:
        addr = side.server({"Plain": Plain, "InPlace": InPlace})
        ch = side.channel(addr)
        for m in ("Plain", "InPlace"):
            assert ch.call_sync("Svc", m, b"").response == b"1", m
        port = int(addr.rsplit(":", 1)[1])
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
        try:
            conn.request("POST", "/Svc/Plain", body=b"")
            assert conn.getresponse().read() == b"1"
        finally:
            conn.close()
    assert current_serving_controller() is None


CASES = [
    ("done and join", _both, (_done_and_join, 101)),
    ("join_async in a fiber handler", _both, (_join_async_in_handler, 102)),
    ("deadline timer", _both, (_deadline_timer,)),
    ("responses racing the timer", _both, (_racing_the_timer, 103)),
    ("start_cancel", _both, (_start_cancel,)),
    ("notify_on_cancel on a dead client", _both, (_notify_on_cancel,)),
    ("deadline and trace inheritance", _inheritance_case, ()),
    ("the wire both ways", _wire_both_ways, (104,)),
    ("a reused controller", _reuse_controller, ()),
    ("the serving controller on every path", _serving_controller_paths,
     ()),
]


def test_async_client():
    _run_cases(CASES)
