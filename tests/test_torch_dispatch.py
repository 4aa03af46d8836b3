"""Server and client dispatch over the port's Socket path, on the CPU,
across the wire both ways (a brpc_tpu Channel to a port Server, a port
Channel to a brpc_tpu Server) and over raw sockets.

Pipelined requests on one connection, tpu_std and HTTP on one port, a
prefix that no protocol claims (dropped) against a short one that may
still become a request (kept), the deadline shed before the handler
(``ERPCTIMEDOUT``), a server with 16 connections and no thread per
connection (counting the threads the port started, with a control whose
accept path starts one per connection), and the last message of a read
processed in place on the dispatcher thread until its handler first
suspends; of a burst's earlier messages, the responses run in place and
the requests spawn.

Every case tears down what it made. The cases run inside one collected
test (``_run_cases`` reports every failing case, with its traceback, and
checks that none leaves a socket registered with the port's
dispatcher); one item per file keeps the place of every other file in
pytest-xdist's ``--dist loadfile`` queue (see test_torch_iobuf.py).
"""

import http.client
import socket
import threading
import time
import traceback

import pytest

from brpc_tpu import fiber as ref_fiber
from brpc_tpu.fiber.timer import TimerThread as RefTimerThread
from brpc_tpu.rpc import Channel as RefChannel
from brpc_tpu.rpc import ChannelOptions as RefChannelOptions
from brpc_tpu.rpc import Controller as RefController
from brpc_tpu.rpc import Server as RefServer
from brpc_tpu.rpc import ServerOptions as RefServerOptions
from brpc_tpu.rpc import Service as RefService
from brpc_tpu.rpc import server_dispatch as ref_dispatch
from brpc_tpu_torch import fiber as port_fiber
from brpc_tpu_torch.butil.flags import flag, set_flag
from brpc_tpu_torch.butil.iobuf import IOPortal
from brpc_tpu_torch.protocol import tpu_std
from brpc_tpu_torch.rpc import (Channel, ChannelOptions, Server,
                                ServerOptions, Service, errno_codes as berr)
from brpc_tpu_torch.rpc import server_dispatch as port_dispatch
from brpc_tpu_torch.transport import tcp as port_tcp
from brpc_tpu_torch.transport.event_dispatcher import global_dispatcher
from brpc_tpu_torch.transport.input_messenger import InputMessenger

WIRINGS = ["ref-client-port-server", "port-client-ref-server"]
SERVERS = ["port", "ref"]


def _wait_for(cond, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.002)
    return cond()


def _run_cases(cases):
    """Run every (name, fn, args) case in order; none may leave a socket
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


class _Calls:
    """What the handlers saw: names of the methods run, and threads."""

    def __init__(self):
        self.lock = threading.Lock()
        self.ran = []
        self.threads = []

    def note(self, name, *threads):
        with self.lock:
            self.ran.append(name)
            self.threads.append(threads)


def _methods(calls, yield_now):
    def Echo(cntl, req):
        calls.note("Echo", threading.current_thread().name)
        return bytes(req)

    def Block(cntl, req):
        calls.note("Block")
        time.sleep(0.4)
        return b"blocked"

    async def Where(cntl, req):
        before = threading.current_thread().name
        await yield_now()
        after = threading.current_thread().name
        calls.note("Where", before, after)
        return f"{before}|{after}".encode()

    return {"Echo": Echo, "Block": Block, "Where": Where}


class _Server:
    """A port or brpc_tpu server with the Echo service; ``workers`` gives
    it a TaskControl of its own."""

    def __init__(self, kind: str, workers=None):
        self.kind = kind
        self.calls = _Calls()
        if kind == "port":
            self.control = (port_fiber.TaskControl(workers, name="disp")
                            if workers else None)
            self.server = Server(ServerOptions(enable_builtin_services=False),
                                 control=self.control)
            svc = Service("Echo")
            for name, fn in _methods(self.calls,
                                     port_fiber.yield_now).items():
                svc.register_method(name, fn)
            self.shed = port_dispatch.nshed
        else:
            self.control = (ref_fiber.TaskControl(workers, name="disp")
                            if workers else None)
            self.server = RefServer(RefServerOptions(
                enable_builtin_services=False), control=self.control)
            svc = RefService("Echo")
            for name, fn in _methods(self.calls,
                                     ref_fiber.yield_now).items():
                svc.method(name)(fn)
            self.shed = ref_dispatch.nshed
        self.server.add_service(svc)
        self.port = self.server.start("tcp://127.0.0.1:0").port
        self.address = f"tcp://127.0.0.1:{self.port}"

    def close(self):
        self.server.stop()
        self.server.join(2)
        if self.control is not None:
            # let the fibers the teardown spawned finish before the
            # workers go
            _wait_for(lambda: self.control.nfibers.get_value() == 0, 2.0)
            self.control.stop_and_join()


class _Client:
    """A port or brpc_tpu Channel: ``call`` gives (error_code, bytes).
    Each has a connection of its own, as a port Channel has (a brpc_tpu
    Channel shares one per endpoint unless told not to)."""

    def __init__(self, kind: str, address: str, timeout_ms=5000):
        self.kind, self.timeout_ms = kind, timeout_ms
        if kind == "port":
            self.ch = Channel(address, ChannelOptions(timeout_ms=timeout_ms))
        else:
            self.ch = RefChannel(address, RefChannelOptions(
                timeout_ms=timeout_ms, share_connections=False))

    def call(self, method, req=b""):
        if self.kind == "port":
            c = self.ch.call_sync("Echo", method, req)
            return c.error_code, c.response
        cntl = RefController()
        cntl.timeout_ms = self.timeout_ms
        c = self.ch.call_sync("Echo", method, req, cntl=cntl)
        return c.error_code, (None if c.failed()
                              else c.response_payload.to_bytes())

    def close(self):
        self.ch.close()


class _Made:
    """The servers and clients of one case, closed when it ends."""

    def __init__(self):
        self.items = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for x in reversed(self.items):
            x.close()

    def server(self, kind, workers=None):
        self.items.append(_Server(kind, workers))
        return self.items[-1]

    def client(self, kind, address, timeout_ms=5000):
        self.items.append(_Client(kind, address, timeout_ms))
        return self.items[-1]

    def wired(self, wiring, workers=None):
        srv = self.server("port" if wiring.endswith("port-server")
                          else "ref", workers)
        cli = self.client("port" if wiring.startswith("port-client")
                          else "ref", srv.address)
        return srv, cli


def _request(cid, method, payload=b"", timeout_ms=0):
    return tpu_std.pack_frame(tpu_std.RpcMeta(
        request=tpu_std.RpcRequestMeta("Echo", method,
                                       timeout_ms=timeout_ms),
        correlation_id=cid), payload)[0]


def _read_frames(sock, n, timeout_s=10.0):
    """n response frames off a raw socket: {cid: (error_code, payload)}."""
    sock.settimeout(timeout_s)
    buf, out = b"", {}
    while len(out) < n:
        chunk = sock.recv(65536)
        assert chunk, "server closed the connection"
        buf += chunk
        while len(buf) >= tpu_std.HEADER_SIZE:
            body, meta_size = tpu_std.parse_header(buf[:12])
            if len(buf) < 12 + body:
                break
            meta, payload, _ = tpu_std.unpack_body(buf[12:12 + body],
                                                   meta_size)
            buf = buf[12 + body:]
            code = meta.response.error_code if meta.response else 0
            out[meta.correlation_id] = (code, payload)
    return out


# -------------------------------------------------------------- pipelining

def case_pipelined_calls(wiring):
    """16 threads share one channel: their requests interleave on one
    connection, and every response reaches its own caller."""
    with _Made() as m:
        srv, cli = m.wired(wiring)
        out, errors = {}, []

        def caller(t):
            for i in range(8):
                req = b"t%d-%d" % (t, i)
                code, resp = cli.call("Echo", req)
                if code or resp != req:
                    errors.append((req, code, resp))
                out[req] = resp

        threads = [threading.Thread(target=caller, args=(t,))
                   for t in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
        assert not errors and len(out) == 128
        if srv.kind == "port":
            assert len(srv.server.connections()) == 1


def case_pipelined_burst(kind):
    with _Made() as m:
        srv = m.server(kind)
        sock = socket.create_connection(("127.0.0.1", srv.port))
        try:
            sock.sendall(b"".join(_request(i + 1, "Echo", b"p%d" % i)
                                  for i in range(32)))
            got = _read_frames(sock, 32)
            assert got == {i + 1: (0, b"p%d" % i) for i in range(32)}
        finally:
            sock.close()


# --------------------------------------------------- protocols on one port

def case_tpu_std_and_http(wiring):
    with _Made() as m:
        srv, cli = m.wired(wiring)
        assert cli.call("Echo", b"rpc") == (0, b"rpc")
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=10)
        try:
            conn.request("POST", "/Echo/Echo", body=b"over http")
            r = conn.getresponse()
            assert r.status == 200 and r.read() == b"over http"
            conn.request("POST", "/Echo/Echo", body=b"again")
            r = conn.getresponse()
            assert r.status == 200 and r.read() == b"again"
        finally:
            conn.close()
        assert cli.call("Echo", b"rpc again") == (0, b"rpc again")


def case_unparsable_prefix(first):
    with _Made() as m:
        srv = m.server("port")
        sock = socket.create_connection(("127.0.0.1", srv.port))
        try:
            sock.sendall(first)
            sock.settimeout(5)
            assert sock.recv(16) == b""
            assert _wait_for(lambda: not srv.server.connections())
        finally:
            sock.close()


def case_short_prefix(kind, proto):
    with _Made() as m:
        srv = m.server(kind)
        if proto == "http":
            wire = b"POST /Echo/Echo HTTP/1.1\r\nContent-Length: 2\r\n\r\nhi"
        else:
            wire = _request(7, "Echo", b"hi")
        sock = socket.create_connection(("127.0.0.1", srv.port))
        try:
            sock.sendall(wire[:1])
            sock.settimeout(0.2)
            with pytest.raises(socket.timeout):
                sock.recv(16)               # neither dropped nor answered
            sock.sendall(wire[1:3])
            with pytest.raises(socket.timeout):
                sock.recv(16)
            sock.sendall(wire[3:])
            if proto == "http":
                sock.settimeout(5)
                data = b""
                while not data.endswith(b"hi"):
                    chunk = sock.recv(4096)
                    assert chunk
                    data += chunk
                assert data.startswith(b"HTTP/1.1 200")
            else:
                assert _read_frames(sock, 1) == {7: (0, b"hi")}
        finally:
            sock.close()


# ------------------------------------------------------------ deadlines

def case_deadline_shed(kind):
    """One worker: Block holds it; the Echo behind it in the same read
    waits for the worker past its 100 ms and is shed unrun."""
    with _Made() as m:
        srv = m.server(kind, workers=1)
        shed0 = srv.shed.get_value()
        sock = socket.create_connection(("127.0.0.1", srv.port))
        try:
            sock.sendall(_request(1, "Block") +
                         _request(2, "Echo", b"late", timeout_ms=100))
            got = _read_frames(sock, 2)
            assert got[1] == (0, b"blocked")
            assert got[2][0] == berr.ERPCTIMEDOUT
            assert srv.calls.ran == ["Block"]
            assert srv.shed.get_value() == shed0 + 1
        finally:
            sock.close()


def case_deadline_across_the_wire(wiring):
    with _Made() as m:
        srv, cli = m.wired(wiring, workers=1)
        shed0 = srv.shed.get_value()
        other = _Client(cli.kind, srv.address)
        box = []
        t = threading.Thread(target=lambda: box.append(other.call("Block")))
        try:
            t.start()
            assert _wait_for(lambda: srv.calls.ran == ["Block"])
            slow = _Client(cli.kind, srv.address, timeout_ms=100)
            try:
                code, _ = slow.call("Echo", b"late")
            finally:
                slow.close()
            assert code == berr.ERPCTIMEDOUT
            t.join(10)
            assert box == [(0, b"blocked")]
            assert _wait_for(lambda: srv.shed.get_value() == shed0 + 1)
            assert srv.calls.ran == ["Block"]
        finally:
            t.join(10)
            other.close()


# -------------------------------------------------------------- threads

def _thread_names():
    return sorted(t.name for t in threading.enumerate())


def _started_by_the_port(t) -> bool:
    """Whether the port started thread ``t``: the module of its target, or
    of its ``Thread`` subclass, is one of brpc_tpu_torch's. A thread that
    a brpc_tpu module started (brpc_tpu shares this process) is not."""
    target = getattr(t, "_target", None)
    return any(m == "brpc_tpu_torch" or m.startswith("brpc_tpu_torch.")
               for m in (getattr(target, "__module__", None) or "",
                         type(t).__module__))


def _port_thread_names():
    return sorted(t.name for t in threading.enumerate()
                  if _started_by_the_port(t))


def case_no_thread_per_connection():
    """16 connections add no thread that the port started. A brpc_tpu
    thread that starts meanwhile (a control of the JAX package that a late
    socket event restarts does so) is not the port's, and is not
    counted."""
    with _Made() as m:
        srv = m.server("port")
        warm = Channel(srv.address)
        channels = []
        ref_timer = RefTimerThread("ref_timer_in_window")
        try:
            assert warm.call_sync("Echo", "Echo", b"w").response == b"w"
            before = _port_thread_names()
            ref_timer.schedule_after(60.0, lambda: None)  # starts a thread
            for i in range(16):
                ch = Channel(srv.address)
                channels.append(ch)
                assert ch.call_sync("Echo", "Echo", b"%d" % i).response \
                    == b"%d" % i
            assert len(srv.server.connections()) == 17
            after = _port_thread_names()
            names = _thread_names()
            assert not [n for n in names if n.endswith(("-reader", "-writer"))
                        or n == "tcp-accept"], names
            assert "ref_timer_in_window" in names
            assert "ref_timer_in_window" not in after
            assert len(after) == len(before), \
                f"threads the port started: {before} -> {after}"
        finally:
            ref_timer.stop()
            if ref_timer._thread is not None:
                ref_timer._thread.join(5)
            for ch in channels + [warm]:
                ch.close()
        assert _wait_for(lambda: not srv.server.connections())


def _hold_the_connection(stop):
    stop.wait(30)


# the thread that the patched accept path below starts runs code of that
# path, so it carries the accept path's module
_hold_the_connection.__module__ = port_tcp.__name__


def case_thread_per_connection_fails_the_count():
    """Control: with the port's accept path patched to start one thread
    per connection, ``case_no_thread_per_connection`` fails its count."""
    stop = threading.Event()
    started = []
    accept = port_tcp._TcpListener._on_acceptable

    def on_acceptable(self):
        if not getattr(self, "_one_thread_each", False):
            inner = self._on_new_conn

            def on_new_conn(conn):
                t = threading.Thread(target=_hold_the_connection,
                                     args=(stop,), daemon=True,
                                     name=f"conn-thread-{len(started)}")
                started.append(t)
                t.start()
                inner(conn)
            self._on_new_conn = on_new_conn
            self._one_thread_each = True
        accept(self)

    port_tcp._TcpListener._on_acceptable = on_acceptable
    try:
        with pytest.raises(AssertionError) as failed:
            case_no_thread_per_connection()
        assert len(started) == 17
        assert "conn-thread-16" in str(failed.value)
    finally:
        port_tcp._TcpListener._on_acceptable = accept
        stop.set()
        for t in started:
            t.join(5)


def case_last_message_in_place(client):
    """A coroutine handler starts on the dispatcher thread that read its
    request and moves to a fiber worker at its first suspension; a plain
    handler hops to a worker before it runs."""
    with _Made() as m:
        srv = m.server("port")
        cli = _Client(client, srv.address)
        try:
            code, resp = cli.call("Where")
            assert code == 0
            before, after = resp.decode().split("|")
            assert before == global_dispatcher().thread.name
            assert after.startswith("fiber_w")
            assert cli.call("Echo", b"x") == (0, b"x")
            assert srv.calls.threads[-1][0].startswith("fiber_w")
        finally:
            cli.close()


def case_inline_processing_off():
    """``socket_inline_process`` off (read when a socket is made): every
    input pass, the client's too, runs as a fiber, so even a coroutine
    handler starts on a worker, and a burst is still answered whole."""
    with _Made() as m:
        was = flag("socket_inline_process")
        assert set_flag("socket_inline_process", False)
        try:
            srv = m.server("port")
            cli = _Client("port", srv.address)
            sock = socket.create_connection(("127.0.0.1", srv.port))
            try:
                code, resp = cli.call("Where")
                assert code == 0
                before, after = resp.decode().split("|")
                assert before.startswith("fiber_w")
                assert after.startswith("fiber_w")
                sock.sendall(b"".join(_request(i + 1, "Echo", b"q%d" % i)
                                      for i in range(8)))
                assert _read_frames(sock, 8) == {i + 1: (0, b"q%d" % i)
                                                 for i in range(8)}
            finally:
                sock.close()
                cli.close()
        finally:
            set_flag("socket_inline_process", was)


class _RecordingStd(tpu_std.TpuStdProtocol):
    """tpu_std's parse; ``process`` notes the frame and its thread."""

    def __init__(self, seen):
        self.seen = seen

    def process(self, msg, socket):
        self.seen.append((msg.meta.correlation_id, msg.is_response,
                          threading.current_thread().name))


class _BurstSocket:
    """What the InputMessenger reads of a socket: one portal of frames."""

    def __init__(self, wire):
        self.input_portal = IOPortal()
        self.input_portal.append(wire)
        self.input_need = 0
        self.preferred_protocol = -1

    def set_failed(self, err):
        raise AssertionError(f"burst socket failed: {err}")

    def take_device_payload(self):
        return None


def case_burst_responses_in_place():
    """Of one read's burst, the responses run in place on the reading
    thread (``dispatch_inline_budget``), in parse order; the requests
    spawn as fibers; the last message is processed in place."""
    responses = [tpu_std.pack_small_frame(b"", i + 1, b"r%d" % i)
                 for i in range(4)]
    burst = (responses[:2] + [_request(10, "Echo", b"q")] + responses[2:]
             + [_request(11, "Echo", b"last")])
    seen = []
    proto = _RecordingStd(seen)
    messenger = InputMessenger(protocols=[proto])
    me = threading.current_thread().name
    assert messenger.on_new_messages(_BurstSocket(b"".join(burst))) is None
    assert _wait_for(lambda: len(seen) == 6)
    in_place = [(cid, resp) for cid, resp, th in seen if th == me]
    assert in_place == [(1, True), (2, True), (3, True), (4, True),
                        (11, False)], seen
    (spawned,) = [(cid, resp, th) for cid, resp, th in seen if th != me]
    assert spawned[:2] == (10, False) and spawned[2].startswith("fiber_w")
    # a response frame off the wire is a response, a request is not
    meta, payload, att = tpu_std.unpack_body(responses[0][12:],
                                             tpu_std.parse_header(
                                                 responses[0][:12])[1])
    assert tpu_std.RpcMessage(meta, payload, att).is_response


CASES = (
    [("no_thread_per_connection", case_no_thread_per_connection, ()),
     ("thread_per_connection_fails_the_count",
      case_thread_per_connection_fails_the_count, ())]
    + [(f"pipelined_calls[{w}]", case_pipelined_calls, (w,))
       for w in WIRINGS]
    + [(f"pipelined_burst[{k}]", case_pipelined_burst, (k,))
       for k in SERVERS]
    + [(f"tpu_std_and_http[{w}]", case_tpu_std_and_http, (w,))
       for w in WIRINGS]
    + [(f"unparsable_prefix[{f[:4]!r}]", case_unparsable_prefix, (f,))
       for f in (b"XXXXXXXXX junk\r\n\r\n",
                 b"\x00\x01\x02\x03\x04\x05\x06\x07\x08")]
    + [(f"short_prefix[{k}-{p}]", case_short_prefix, (k, p))
       for k in SERVERS for p in ("http", "tpu_std")]
    + [(f"deadline_shed[{k}]", case_deadline_shed, (k,)) for k in SERVERS]
    + [(f"deadline_across_the_wire[{w}]", case_deadline_across_the_wire,
        (w,)) for w in WIRINGS]
    + [(f"last_message_in_place[{c}]", case_last_message_in_place, (c,))
       for c in ("port", "ref")]
    + [("inline_processing_off", case_inline_processing_off, ())]
    + [("burst_responses_in_place", case_burst_responses_in_place, ())])


def test_dispatch_across_the_wire():
    _run_cases(CASES)
