"""The port's EventDispatcher and Socket, on the CPU.

The dispatcher: read callbacks that pause, resume and stop, and a
one-shot writable event. The Socket's writes: frames from many threads
leave whole and in queue order, ``on_done`` fires once per write in that
order, and a writer whose peer stops reading parks (no thread blocks)
and drains once the peer reads. Its failure: the SocketId goes stale,
the callbacks fire once, a late one fires at once. Its input: frames cut
from bytes that arrive one at a time, or many in one write, equal the
frames brpc_tpu's tpu_std parse cuts from the same bytes.

Every case closes what it opened. The cases run inside one collected
test (``_run_cases`` reports every failing case, with its traceback, and
checks that none leaves a socket registered with the port's global
dispatcher); one item per file keeps the place of every other file in
pytest-xdist's ``--dist loadfile`` queue (see test_torch_iobuf.py).
"""

import random
import socket
import threading
import time
import traceback

import numpy as np
import pytest

from brpc_tpu.butil.iobuf import IOPortal as RefPortal
from brpc_tpu.protocol import registry as ref_registry
from brpc_tpu.protocol.tpu_std import TpuStdProtocol as RefTpuStd
from brpc_tpu_torch.butil.endpoint import EndPoint
from brpc_tpu_torch.protocol import tpu_std
from brpc_tpu_torch.transport.event_dispatcher import (EventDispatcher,
                                                       global_dispatcher)
from brpc_tpu_torch.transport.input_messenger import InputMessenger
from brpc_tpu_torch.transport.socket import Socket, address_socket
from brpc_tpu_torch.transport.tcp import TcpConn


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


def _pair(on_input=None, sndbuf=None, rcvbuf=None):
    """(server-side Socket, client socket) over loopback."""
    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    cli = socket.create_connection(lst.getsockname())
    srv, addr = lst.accept()
    lst.close()
    if sndbuf is not None:
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, sndbuf)
    if rcvbuf is not None:
        cli.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, rcvbuf)
    conn = TcpConn(srv, EndPoint("tcp", *srv.getsockname()[:2]),
                   EndPoint("tcp", *addr[:2]))
    return Socket(conn, on_input=on_input), cli


def _recv_exactly(sock, n, timeout_s=10.0):
    sock.settimeout(timeout_s)
    out = bytearray()
    while len(out) < n:
        chunk = sock.recv(min(1 << 20, n - len(out)))
        assert chunk, "peer closed early"
        out += chunk
    return bytes(out)


# ---------------------------------------------------------- dispatcher

def case_dispatcher():
    d = EventDispatcher(name="test_dispatcher")
    a, b = socket.socketpair()
    a.setblocking(False)
    got, writable = [], []

    def on_readable():
        try:
            got.append(a.recv(64))
        except BlockingIOError:
            pass

    try:
        d.add_consumer(a.fileno(), on_readable)
        b.send(b"one")
        assert _wait_for(lambda: got == [b"one"])
        d.pause_read(a.fileno())
        b.send(b"two")
        time.sleep(0.15)
        assert got == [b"one"]          # paused: the bytes wait
        d.resume_read(a.fileno())       # level-triggered: fires now
        assert _wait_for(lambda: got == [b"one", b"two"])
        d.request_writable(a.fileno(), lambda: writable.append(1))
        assert _wait_for(lambda: writable == [1])
        time.sleep(0.15)
        assert writable == [1]          # one-shot, though still writable
        d.remove_consumer(a.fileno())
        assert d.nconsumers() == 0
        b.send(b"three")
        time.sleep(0.15)
        assert got == [b"one", b"two"]
        with pytest.raises(ConnectionError):
            d.request_writable(a.fileno(), lambda: None)
    finally:
        d.remove_consumer(a.fileno())
        d.stop()
        a.close()
        b.close()
    assert not d.thread.is_alive()


# --------------------------------------------------------------- writes

def case_write_order():
    """8 threads x 200 frames: every frame leaves whole, each thread's in
    its own order, and on_done fires once per write in wire order."""
    conn, cli = _pair()
    done, done_lock = [], threading.Lock()
    nthreads, nframes = 8, 200

    def frame(t, i):
        body = b"%d:%04d|" % (t, i)
        return body + bytes([65 + t]) * (13 * (i % 7)) + b";"

    def writer(t):
        for i in range(nframes):
            def cb(err, key=(t, i)):
                with done_lock:
                    done.append((key, err))
            assert conn.write(frame(t, i), on_done=cb)

    want_bytes = sum(len(frame(t, i)) for t in range(nthreads)
                     for i in range(nframes))
    try:
        threads = [threading.Thread(target=writer, args=(t,))
                   for t in range(nthreads)]
        for t in threads:
            t.start()
        data = _recv_exactly(cli, want_bytes)
        for t in threads:
            t.join(10)
        wire = []
        for part in data.split(b";")[:-1]:
            head, _, pad = part.partition(b"|")
            t, i = (int(x) for x in head.split(b":"))
            assert pad == bytes([65 + t]) * (13 * (i % 7)), "interleaved"
            wire.append((t, i))
        assert len(wire) == nthreads * nframes
        for t in range(nthreads):
            assert [i for tt, i in wire if tt == t] == list(range(nframes))
        assert _wait_for(lambda: len(done) == len(wire))
        assert [k for k, _ in done] == wire
        assert all(err is None for _, err in done)
        assert conn.write_backlog() == 0
    finally:
        cli.close()
        conn.set_failed()


def case_writer_parks():
    # 64 KiB buffers: tiny windows would add TCP's delayed-ack stalls
    conn, cli = _pair(sndbuf=65536, rcvbuf=65536)
    frames = [bytes([i % 251]) * 65536 for i in range(32)]
    done = []
    threads_before = {t.name for t in threading.enumerate()}
    try:
        t0 = time.monotonic()
        for f in frames:
            assert conn.write(f, on_done=done.append)
        assert time.monotonic() - t0 < 1.0
        time.sleep(0.1)
        # the kernel took a little; the rest waits on the writable event
        assert conn._handoff is not None
        assert conn.write_backlog() > len(frames[0])
        assert len(done) < len(frames)
        # no writer thread: the only threads are the runtime's own
        new = {t.name for t in threading.enumerate()} - threads_before
        assert all(n.startswith(("fiber_", "bvar_")) for n in new), new
        want = b"".join(frames)
        assert _recv_exactly(cli, len(want)) == want
        assert _wait_for(lambda: len(done) == len(frames))
        assert done == [None] * len(frames)
        assert conn.write_backlog() == 0 and conn._handoff is None
    finally:
        cli.close()
        conn.set_failed()


def case_failure():
    conn, cli = _pair()
    fired = []
    try:
        sid = conn.id
        assert address_socket(sid) is conn
        conn.on_failed(lambda s: fired.append("a"))
        conn.on_failed(lambda s: fired.append("b"))
        reason = ConnectionError("test")
        conn.set_failed(reason)
        conn.set_failed(ConnectionError("again"))
        assert fired == ["a", "b"]
        assert address_socket(sid) is None and conn.fail_reason is reason
        conn.on_failed(lambda s: fired.append("late"))
        assert fired == ["a", "b", "late"]
        cli.settimeout(5)
        assert cli.recv(16) == b""      # the conn was closed
    finally:
        cli.close()


def case_peer_eof():
    conn, cli = _pair(sndbuf=65536, rcvbuf=65536)
    done = []
    try:
        for i in range(32):
            conn.write(bytes([i]) * 65536, on_done=done.append)
        assert _wait_for(lambda: conn._handoff is not None)
        cli.close()                     # the peer goes away unread
        assert _wait_for(lambda: conn.failed)
        assert _wait_for(lambda: len(done) == 32)
        assert all(isinstance(e, OSError) for e in done[-2:])
        assert conn.write_backlog() == 0
    finally:
        conn.set_failed()


# ---------------------------------------------------------------- input

class _Recorder(tpu_std.TpuStdProtocol):
    """The port's tpu_std, recording each frame instead of processing."""

    def __init__(self):
        self.got = []

    def process_inline(self, msg, socket):
        self.got.append(_key(msg.meta, msg.payload, msg.attachment))
        return True


def _key(meta, payload, attachment):
    req, resp, ss = meta.request, meta.response, meta.stream_settings
    return (meta.correlation_id,
            (req.service_name, req.method_name, req.timeout_ms,
             req.log_id) if req else None,
            (resp.error_code, resp.error_text) if resp else None,
            (ss.stream_id, ss.frame_seq, ss.credits, ss.close)
            if ss else None,
            payload, attachment)


def _ref_key(meta, payload, attachment):
    hf = meta.HasField
    req, resp, ss = meta.request, meta.response, meta.stream_settings
    return (meta.correlation_id,
            (req.service_name, req.method_name, req.timeout_ms,
             req.log_id) if hf("request") else None,
            (resp.error_code, resp.error_text) if hf("response") else None,
            (ss.stream_id, ss.frame_seq, ss.credits, ss.close)
            if hf("stream_settings") else None,
            payload, attachment)


def _frames(seed: int, n: int):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        payload = rng.integers(0, 256, int(rng.integers(0, 300)),
                               dtype=np.uint8).tobytes()
        att = rng.integers(0, 256, int(rng.integers(0, 3)) * 20,
                           dtype=np.uint8).tobytes()
        kind = int(rng.integers(3))
        if kind == 0:
            meta = tpu_std.RpcMeta(
                request=tpu_std.RpcRequestMeta(
                    "Svc", f"M{i}", log_id=int(rng.integers(1 << 40)),
                    timeout_ms=int(rng.integers(0, 5000))),
                correlation_id=i + 1)
            out.append(tpu_std.pack_frame(meta, payload, att)[0])
        elif kind == 1:
            meta = tpu_std.RpcMeta(
                response=tpu_std.RpcResponseMeta(int(rng.integers(2)) * 1008,
                                                 "t" * int(rng.integers(4))),
                correlation_id=i + 1)
            out.append(tpu_std.pack_frame(meta, payload, att)[0])
        else:
            out.append(tpu_std.pack_stream_frame(
                int(rng.integers(1, 1 << 30)), i, int(rng.integers(4)),
                bool(rng.integers(2)), payload))
    return out


class _FakeRefSocket:
    input_need = 0

    def set_failed(self, e):
        raise AssertionError(f"reference parse failed the socket: {e}")


def _ref_parse(data: bytes, split: int):
    """brpc_tpu's tpu_std parse over its IOPortal, fed ``split`` bytes at
    a time."""
    proto, portal, sock, got = RefTpuStd(), RefPortal(), _FakeRefSocket(), []
    for i in range(0, len(data), split):
        portal.append(data[i:i + split])
        while portal:
            status, msg = proto.parse(portal, sock)
            if status != ref_registry.PARSE_OK:
                break
            got.append(_ref_key(msg.meta, msg.payload.to_bytes(),
                                msg.attachment.to_bytes()))
    assert not portal
    return got


def case_input(mode):
    frames = _frames(7 if mode == "one_write" else 11,
                     40 if mode == "one_write" else 12)
    data = b"".join(frames)
    rec = _Recorder()
    conn, cli = _pair(on_input=InputMessenger(protocols=[rec])
                      .on_new_messages)
    try:
        if mode == "one_write":
            cli.sendall(data)
        else:
            for i in range(len(data)):
                cli.send(data[i:i + 1])
                if random.Random(i).random() < 0.3:
                    time.sleep(0.0005)
        assert _wait_for(lambda: len(rec.got) == len(frames), 20.0)
        assert rec.got == _ref_parse(data, 1 if mode == "byte_by_byte"
                                     else len(data))
        assert not conn.input_portal and not conn.failed
    finally:
        cli.close()
        conn.set_failed()


CASES = [("dispatcher", case_dispatcher, ()),
         ("write_order", case_write_order, ()),
         ("writer_parks", case_writer_parks, ()),
         ("failure", case_failure, ()),
         ("peer_eof", case_peer_eof, ()),
         ("input[byte_by_byte]", case_input, ("byte_by_byte",)),
         ("input[one_write]", case_input, ("one_write",))]


def test_socket_path():
    _run_cases(CASES)
