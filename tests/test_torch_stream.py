"""The port's streaming RPC against brpc_tpu.rpc.stream, on the CPU.

Stream frames are byte-identical to the reference's hand-encoded fast
pack and to the protobuf serializer. The cases of tests/test_stream.py
that need no device arrays run over three wirings: port Channel to port
Server, a brpc_tpu Channel to a port Server, and a port Channel to a
brpc_tpu Server. Below them: the Socket's write queue and failure subscriptions,
the InputMessenger's protocol sniffing, and the HTTP path's ordering.
"""

import array
import http.client
import socket
import threading
import time

import pytest

from brpc_tpu import fiber
from brpc_tpu.protocol.proto import tpu_rpc_meta_pb2 as pb
from brpc_tpu.protocol.tpu_std import _HDR, MAGIC
from brpc_tpu.rpc import Channel as RefChannel
from brpc_tpu.rpc import ChannelOptions as RefChannelOptions
from brpc_tpu.rpc import Server as RefServer
from brpc_tpu.rpc import ServerOptions as RefServerOptions
from brpc_tpu.rpc import Service as RefService
from brpc_tpu.rpc.stream import Stream as RefStream
from brpc_tpu.rpc.stream import StreamOptions as RefStreamOptions
from brpc_tpu.rpc.stream import stream_accept as ref_stream_accept
from brpc_tpu_torch import fiber as port_fiber
from brpc_tpu_torch.protocol import tpu_std
from brpc_tpu_torch.rpc import (Channel, ChannelOptions, Server, Service,
                                StreamOptions, stream_accept)
from brpc_tpu_torch.rpc.stream import (CREDIT_BATCH, DEFAULT_CREDITS,
                                       address_stream)
from brpc_tpu_torch.butil.endpoint import EndPoint
from brpc_tpu_torch.transport.input_messenger import InputMessenger
from brpc_tpu_torch.transport.socket import Socket
from brpc_tpu_torch.transport.tcp import TcpConn

WIRINGS = ["port-port", "ref-client-port-server", "port-client-ref-server"]


def _wait_for(cond, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.005)
    return cond()


# ------------------------------------------------------------ frame bytes

class _Rec:
    def __init__(self):
        self.wires = []

    def write(self, w):
        self.wires.append(w if isinstance(w, bytes) else w.to_bytes())


FRAME_CASES = [
    # (peer id, data, credits, close, payload)
    (0x1234, True, 0, False, b"body"),
    (0x1234, True, 0, False, b""),
    (0x1234, False, 37, False, b""),
    (0x1234, False, 0, True, b""),
    (0x1234, True, 300, False, b"x" * 100),
    (1, True, 0, False, b"t\x07"),
    (2 ** 40 + 3, True, 2 ** 20, False, b"big ids"),
    (0x1234, True, 0, False,
     bytes(memoryview(array.array("I", [1, 2, 3])))),
]


@pytest.mark.parametrize("case", FRAME_CASES,
                         ids=[f"case{i}" for i in range(len(FRAME_CASES))])
def test_stream_frame_bytes_equal_reference(case):
    """pack_stream_frame against brpc_tpu's fast pack (Stream._send_frame)
    and against RpcMeta.SerializeToString()."""
    peer, data, credits, close, payload = case
    s = RefStream()
    try:
        s.peer_id = peer
        s.socket = _Rec()
        for _ in range(3 if data else 0):   # seq 1, 2, then this frame's 3
            s._send_frame(b"", None)
        s._send_frame(payload, None, close=close, credits=credits, data=data)
        ref_fast = s.socket.wires[-1]
    finally:
        s.socket = None
        s.close()
    seq = 4 if data else 0
    meta = pb.RpcMeta()
    ss = meta.stream_settings
    ss.stream_id = peer
    if seq:
        ss.frame_seq = seq
    if credits:
        ss.credits = credits
    if close:
        ss.close = True
    mb = meta.SerializeToString()
    want = _HDR.pack(MAGIC, len(mb) + len(payload), len(mb)) + mb + payload
    got = tpu_std.pack_stream_frame(peer, seq, credits, close, payload)
    assert got == want == ref_fast, (got.hex(), want.hex(), ref_fast.hex())


def test_stream_settings_codec_equals_protobuf():
    """Every StreamSettings field, on a request meta and alone, encodes as
    protobuf does (negative credits as a 10-byte varint) and decodes
    back, past fields the port does not read."""
    for kw in (dict(stream_id=7), dict(stream_id=7, need_feedback=True),
               dict(stream_id=2 ** 63, frame_seq=2 ** 33, credits=-1,
                    close=True),
               dict(credits=2 ** 31 - 1)):
        ref = pb.RpcMeta()
        ref.request.service_name = "S"
        ref.request.method_name = "M"
        ref.correlation_id = 99
        for k, v in kw.items():
            setattr(ref.stream_settings, k, v)
        mine = tpu_std.RpcMeta(
            request=tpu_std.RpcRequestMeta("S", "M"), correlation_id=99,
            stream_settings=tpu_std.StreamSettings(**kw))
        assert mine.encode() == ref.SerializeToString(), kw
        # a device payload (field 7) and trace ids ride along: skipped
        ref.device_payloads.add(dtype="float32", shape=[2], nbytes=8)
        ref.trace_id = 5
        back = tpu_std.RpcMeta.decode(ref.SerializeToString())
        assert back.stream_settings == tpu_std.StreamSettings(**kw)
        assert back.correlation_id == 99 and not back.is_stream_frame()
    bare = tpu_std.RpcMeta.decode(pb.RpcMeta(
        stream_settings=pb.StreamSettings(stream_id=3, frame_seq=1))
        .SerializeToString())
    assert bare.is_stream_frame()
    assert bare.stream_settings == tpu_std.StreamSettings(3, False, 1)


# ------------------------------------------------------------ the wirings

class _PortServer:
    def __init__(self, received, echo_back=False):
        self.server_closed = threading.Event()
        self.server = Server()
        svc = Service("StreamService")

        def on_received(stream, msg):
            received.append(msg.payload)
            if echo_back:
                stream.write_nowait(b"echo:" + msg.payload)

        def Open(cntl, request):
            st = stream_accept(cntl, StreamOptions(on_received=on_received))
            assert st is not None
            st.on_close(lambda s: self.server_closed.set())
            return b"accepted"

        def OpenEarly(cntl, request):
            st = stream_accept(cntl, StreamOptions(on_received=on_received))
            for i in range(3):
                assert st.write_nowait(b"early-%d" % i)
            time.sleep(0.05)            # the frames go well before this
            return b"accepted"

        def NoStream(cntl, request):
            assert stream_accept(cntl) is None
            return b"no-stream"

        for fn in (Open, OpenEarly, NoStream):
            svc.register_method(fn.__name__, fn)
        self.server.add_service(svc)
        ep = self.server.start("tcp://127.0.0.1:0")
        self.address = f"tcp://127.0.0.1:{ep.port}"

    def kill_connections(self):
        for c in self.server.connections():
            c.set_failed(ConnectionError("chaos: server died"))

    def stop(self):
        self.server.stop()
        self.server.join(2)


class _RefServer:
    def __init__(self, received, echo_back=False):
        self.server_closed = threading.Event()
        self.server = RefServer(RefServerOptions(
            enable_builtin_services=False))
        svc = RefService("StreamService")

        def on_received(stream, msg):
            payload = msg.payload.to_bytes()
            received.append(payload)
            if echo_back:
                stream.write_nowait(b"echo:" + payload)

        @svc.method()
        def Open(cntl, request):
            st = ref_stream_accept(cntl, RefStreamOptions(
                on_received=on_received))
            assert st is not None
            st.on_close(lambda s: self.server_closed.set())
            return b"accepted"

        @svc.method()
        def OpenEarly(cntl, request):
            st = ref_stream_accept(cntl, RefStreamOptions(
                on_received=on_received))
            for i in range(3):
                assert st.write_nowait(b"early-%d" % i)
            time.sleep(0.05)
            return b"accepted"

        @svc.method()
        def NoStream(cntl, request):
            assert ref_stream_accept(cntl) is None
            return b"no-stream"

        self.server.add_service(svc)
        ep = self.server.start("tcp://127.0.0.1:0")
        self.address = f"tcp://127.0.0.1:{ep.port}"

    def kill_connections(self):
        for s in self.server.connections():
            s.set_failed(ConnectionError("chaos: server died"))

    def stop(self):
        self.server.stop()
        self.server.join(2)


class _PortClient:
    def __init__(self, address):
        self.ch = Channel(address, ChannelOptions(timeout_ms=5000))

    def open(self, method="Open", on_received=None,
             initial_credits=DEFAULT_CREDITS):
        """(controller, stream); ``on_received(payload)``."""
        cb = None if on_received is None else \
            (lambda s, msg: on_received(msg.payload))
        cntl = self.ch.call_sync("StreamService", method, b"",
                                 stream_options=StreamOptions(
                                     cb, initial_credits))
        assert not cntl.failed(), cntl.error_text
        return cntl, cntl.stream

    def call(self, method):
        cntl = self.ch.call_sync("StreamService", method, b"")
        return cntl.failed(), cntl.response, cntl.stream

    def write_all(self, stream, payloads, timeout_s=5.0):
        async def writer():
            sent = 0
            for p in payloads:
                if await stream.write(p, timeout_s=timeout_s):
                    sent += 1
            return sent
        f = port_fiber.spawn(writer)
        assert f.join(timeout_s * 4 + 10)
        return f.value()

    def close(self):
        self.ch.close()


class _RefClient:
    def __init__(self, address):
        self.ch = RefChannel(address, RefChannelOptions(timeout_ms=5000))

    def open(self, method="Open", on_received=None,
             initial_credits=DEFAULT_CREDITS):
        cb = None if on_received is None else \
            (lambda s, msg: on_received(msg.payload.to_bytes()))
        cntl = self.ch.call_sync("StreamService", method, b"",
                                 stream_options=RefStreamOptions(
                                     cb, initial_credits))
        assert not cntl.failed(), cntl.error_text
        return cntl, cntl.stream

    def call(self, method):
        cntl = self.ch.call_sync("StreamService", method, b"")
        return (cntl.failed(), cntl.response_payload.to_bytes(),
                getattr(cntl, "stream", None))

    def write_all(self, stream, payloads, timeout_s=5.0):
        async def writer():
            sent = 0
            for p in payloads:
                if await stream.write(p, timeout_s=timeout_s):
                    sent += 1
            return sent
        f = fiber.spawn(writer)
        assert f.join(timeout_s * 4 + 10)
        return f.value()

    def close(self):
        self.ch.close()


@pytest.fixture(params=WIRINGS)
def wiring(request):
    """start(echo_back=False) -> (server side, client, received)."""
    made = []

    def start(echo_back=False):
        received = []
        server_cls = (_RefServer if request.param == "port-client-ref-server"
                      else _PortServer)
        client_cls = (_RefClient if request.param == "ref-client-port-server"
                      else _PortClient)
        server = server_cls(received, echo_back)
        client = client_cls(server.address)
        made.append((server, client))
        return server, client, received

    yield start
    for server, client in made:
        client.close()
        server.stop()


class TestStreaming:
    def test_client_to_server_frames(self, wiring):
        server, client, received = wiring()
        cntl, stream = client.open()
        assert stream.peer_id != 0
        frames = [f"frame-{i}".encode() for i in range(20)]
        assert client.write_all(stream, frames) == 20
        assert _wait_for(lambda: len(received) >= 20)
        assert received == frames
        stream.close()

    def test_bidirectional_echo(self, wiring):
        server, client, received = wiring(echo_back=True)
        got = []
        cntl, stream = client.open(on_received=got.append)
        assert client.write_all(stream, [b"m%d" % i for i in range(10)]) \
            == 10
        assert _wait_for(lambda: len(got) >= 10)
        assert got == [b"echo:m%d" % i for i in range(10)]
        stream.close()

    def test_flow_control_blocks_writer(self, wiring):
        """A 4-credit window and no grants (under CREDIT_BATCH frames
        delivered): write_nowait stops at 4."""
        server, client, received = wiring()
        cntl, stream = client.open(initial_credits=4)
        sent = 0
        for i in range(10):
            if not stream.write_nowait(b"f%d" % i):
                break
            sent += 1
        assert sent == 4
        stream.close()

    def test_credits_replenish(self, wiring):
        """Grants every CREDIT_BATCH delivered frames sustain a stream
        longer than the initial window."""
        server, client, received = wiring()
        n = DEFAULT_CREDITS + CREDIT_BATCH * 2
        cntl, stream = client.open()
        assert client.write_all(stream, [b"x%d" % i for i in range(n)]) == n
        assert _wait_for(lambda: len(received) >= n)
        assert received == [b"x%d" % i for i in range(n)]
        stream.close()

    def test_close_propagates(self, wiring):
        server, client, received = wiring()
        cntl, stream = client.open()
        stream.close()
        assert stream.closed
        assert server.server_closed.wait(5), "server never saw the close"
        assert not stream.write_nowait(b"after close")

    def test_no_stream_requested(self, wiring):
        server, client, received = wiring()
        failed, response, stream = client.call("NoStream")
        assert not failed and response == b"no-stream" and stream is None

    def test_frames_before_response_are_delivered(self, wiring):
        """The handler writes three frames, then waits before it answers:
        they reach the client ahead of the response and must be
        delivered, in order; the stream works after the response too."""
        server, client, received = wiring()
        got = []
        cntl, stream = client.open("OpenEarly", on_received=got.append)
        assert _wait_for(lambda: len(got) >= 3)
        assert got == [b"early-0", b"early-1", b"early-2"]
        assert client.write_all(stream, [b"late"]) == 1
        assert _wait_for(lambda: received == [b"late"])
        stream.close()

    def test_peer_death_closes_stream(self, wiring):
        """The server's connections dropping mid-stream fire the client's
        on_close, and writes fail at once rather than wait out a credit
        timeout."""
        server, client, received = wiring()
        closed = threading.Event()
        cntl, stream = client.open()
        stream.on_close(lambda s: closed.set())
        assert stream.write_nowait(b"frame-1")
        server.kill_connections()
        assert closed.wait(5), "client never observed stream closure"
        assert stream.remote_closed
        t0 = time.monotonic()
        assert stream.write_nowait(b"after-death") is False
        assert client.write_all(stream, [b"after-death"], 10.0) == 0
        assert time.monotonic() - t0 < 1.0


def test_close_frame_and_eof_close_once():
    """A close frame and the connection's end race on a hang-up: on_close
    fires exactly once, and a parked writer wakes with False."""
    fired = []
    server = Server()
    svc = Service("S")
    accepted = []

    def Open(cntl, request):
        accepted.append(stream_accept(cntl))
        return b"ok"

    svc.register_method("Open", Open)
    server.add_service(svc)
    ep = server.start("tcp://127.0.0.1:0")
    ch = Channel(str(ep))
    try:
        cntl = ch.call_sync("S", "Open", b"", stream_options=StreamOptions(
            initial_credits=0))
        st = cntl.stream
        st.on_close(lambda s: fired.append(s.id))
        box = []

        async def write():
            box.append(await st.write(b"x", timeout_s=30))

        writer = port_fiber.spawn(write)
        time.sleep(0.05)                # parked on the empty window
        accepted[0].close()             # close frame ...
        ch.close()                      # ... and the connection's end
        assert writer.join(5) and box == [False]
        assert _wait_for(lambda: fired == [st.id])
        time.sleep(0.1)
        assert fired == [st.id]
        assert address_stream(st.id) is st and st.remote_closed
        st.close()
        assert address_stream(st.id) is None
    finally:
        ch.close()
        server.stop()
        server.join(2)


# -------------------------------------------------------------- transport

def _pair(on_input=None, sndbuf=None):
    """(server-side Socket, client socket) over loopback."""
    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    cli = socket.create_connection(lst.getsockname())
    srv, addr = lst.accept()
    lst.close()
    if sndbuf is not None:
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, sndbuf)
    conn = TcpConn(srv, EndPoint("tcp", *srv.getsockname()[:2]),
                   EndPoint("tcp", *addr[:2]))
    return Socket(conn, on_input=on_input), cli


def test_send_never_blocks_on_a_peer_that_stopped_reading():
    conn, cli = _pair(sndbuf=4096)
    try:
        # 2 MiB: well past what the socket buffers hold unread
        frames = [bytes([i % 251]) * 65536 for i in range(32)]
        t0 = time.monotonic()
        for f in frames:
            assert conn.write(f)
        assert time.monotonic() - t0 < 1.0
        assert conn.write_backlog() > 0
        want = b"".join(frames)
        got = bytearray()
        cli.settimeout(10)
        while len(got) < len(want):
            got += cli.recv(1 << 20)
        assert bytes(got) == want       # whole frames, in order
        assert _wait_for(lambda: conn.write_backlog() == 0)
    finally:
        cli.close()
        conn.set_failed()


def test_failure_subscriptions_fire_once():
    conn, cli = _pair()
    fired = []
    cb_a, cb_b = (lambda c: fired.append("a")), (lambda c: fired.append("b"))
    conn.on_failed(cb_a)
    conn.on_failed(cb_b)
    conn.off_failed(cb_b)
    cli.close()                         # the dispatcher reads EOF
    assert _wait_for(lambda: conn.failed)
    conn.set_failed()
    # set_failed runs the callbacks after it publishes ``failed``
    assert _wait_for(lambda: fired == ["a"])
    assert fired == ["a"]
    conn.on_failed(lambda c: fired.append("late"))  # after the end: at once
    assert fired == ["a", "late"]
    done = []
    assert conn.write(b"x", on_done=done.append) is False
    assert isinstance(done[0], ConnectionError)


@pytest.mark.parametrize("first", [b"XXXX", b"\x00\x01\x02\x03", b"SSH-"])
def test_unknown_protocol_closes_the_connection(first):
    conn, cli = _pair(on_input=InputMessenger().on_new_messages)
    try:
        cli.sendall(first + b" junk\r\n\r\n")
        cli.settimeout(5)
        assert cli.recv(16) == b""
        assert _wait_for(lambda: conn.failed)
    finally:
        cli.close()
        conn.set_failed()


def test_http_pipelined_requests_answered_in_order():
    server = Server()
    svc = Service("Echo")
    svc.register_method("Slow", lambda cntl, req: (time.sleep(0.1), req)[1])
    svc.register_method("Fast", lambda cntl, req: req)
    server.add_service(svc)
    ep = server.start("tcp://127.0.0.1:0")
    sock = socket.create_connection(("127.0.0.1", ep.port))
    try:
        reqs = b"".join(
            b"POST /Echo/%s HTTP/1.1\r\nContent-Length: %d\r\n\r\n%s"
            % (m, len(body), body)
            for m, body in ((b"Slow", b"first"), (b"Fast", b"second"),
                            (b"Nope", b""), (b"Fast", b"third")))
        sock.sendall(reqs)
        sock.settimeout(5)
        data = b""
        while data.count(b"HTTP/1.1") < 4 or not data.endswith(b"third"):
            chunk = sock.recv(65536)
            assert chunk
            data += chunk
        assert data.index(b"first") < data.index(b"second") \
            < data.index(b"404 Not Found") < data.index(b"third")
    finally:
        sock.close()
        server.stop()
        server.join(2)


def test_http_connection_close_after_response():
    server = Server()
    svc = Service("Echo")
    svc.register_method("Fast", lambda cntl, req: req)
    server.add_service(svc)
    ep = server.start("tcp://127.0.0.1:0")
    try:
        c = http.client.HTTPConnection("127.0.0.1", ep.port, timeout=5)
        c.request("POST", "/Echo/Fast", body=b"bye",
                  headers={"Connection": "close"})
        r = c.getresponse()
        assert r.status == 200 and r.read() == b"bye"
        assert r.getheader("Connection") == "close"
        assert _wait_for(lambda: not server.connections())
        c.close()
    finally:
        server.stop()
        server.join(2)
