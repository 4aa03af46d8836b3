"""esp of the port (``protocol/esp.py``) against brpc_tpu's, on the CPU.

- Frames: tests/test_legacy_protocols.py's message and 200 made from a
  seed give bytes equal to brpc_tpu's, and each package's parse reads
  the other's frames to the same fields; a body over 64 MiB fails the
  connection in both.
- Clients and servers both ways across the wire (the port's client to
  the port's and brpc_tpu's servers, brpc_tpu's client to the port's):
  replies a server sends in reverse order reach their callers by
  ``msg_id``; 8 threads share one client; ``call_async`` from more fibers
  than workers; a handler that raises gets no reply; a dropped
  connection fails the calls written to it, and the next call dials
  anew.
- A server without ``esp_service`` answers nothing, and counts nothing.
- The leak check fails a case that leaves an EspClient's socket open.

One collected test over the cases (``_run_cases`` of
test_torch_cluster.py).
"""

import threading

import numpy as np
import pytest

import brpc_tpu.fiber as ref_fiber
from brpc_tpu.butil.iobuf import IOBuf as RefIOBuf
from brpc_tpu.butil.iobuf import IOPortal as RefPortal
from brpc_tpu.fiber.sync import CountdownEvent as RefCountdown
from brpc_tpu.protocol import esp as ref_esp
from brpc_tpu.rpc import Server as RefServer
from brpc_tpu.rpc import ServerOptions as RefServerOptions

import brpc_tpu_torch.fiber as port_fiber
from brpc_tpu_torch.butil.iobuf import IOPortal
from brpc_tpu_torch.fiber.sync import CountdownEvent
from brpc_tpu_torch.protocol import esp
from brpc_tpu_torch.rpc import Server, ServerOptions

from test_torch_cluster import _run_cases

SEED = 20261018
N_REVERSED = 6


class _Sock:
    input_need = 0

    def __init__(self):
        self.failed = False

    def set_failed(self, err=None):
        self.failed = True


def _parse(kind, wire: bytes):
    portal = (IOPortal if kind == "port" else RefPortal)()
    portal.append(wire)
    proto = (esp if kind == "port" else ref_esp).EspProtocol()
    sock = _Sock()
    status, msg = proto.parse(portal, sock)
    if msg is None:
        return status, sock.failed
    return status, (msg.to, msg.from_, msg.flags, msg.msg_id, msg.body)


def case_frames():
    m = esp.EspMessage(b"payload", to=10, from_=20, flags=1, msg_id=33)
    wire = m.pack()
    assert wire[:2] == b"SG" and len(wire) == esp.HEADER_SIZE + 7
    assert wire == ref_esp.EspMessage(b"payload", to=10, from_=20, flags=1,
                                      msg_id=33).pack()
    rng = np.random.default_rng(SEED)
    for _ in range(200):
        kw = {k: int(rng.integers(1 << 32))
              for k in ("to", "from_", "flags", "msg_id")}
        body = rng.bytes(int(rng.integers(0, 200)))
        wire = esp.EspMessage(body, **kw).pack()
        assert wire == ref_esp.EspMessage(body, **kw).pack()
        assert _parse("port", wire) == _parse("ref", wire) == \
            ("ok", (kw["to"], kw["from_"], kw["flags"], kw["msg_id"], body))
        cut = wire[:int(rng.integers(1, len(wire)))]
        assert _parse("port", cut) == _parse("ref", cut)
    huge = esp.EspMessage(b"").pack()[:18] + (65 << 20).to_bytes(4, "little")
    assert _parse("port", huge)[1] is True and _parse("ref", huge)[1] is True


def _reversing_handler(kind, seen):
    """Holds the first N_REVERSED - 1 requests of a connection unanswered
    and answers all N_REVERSED in reverse order at the last; later
    requests are answered at once. ``Crash`` raises."""
    mod = esp if kind == "port" else ref_esp
    held = []
    lock = threading.Lock()

    def write(sock, msg):
        wire = mod.EspMessage(b"re-" + msg.body, to=msg.from_,
                              from_=msg.to, msg_id=msg.msg_id).pack()
        if kind == "port":
            sock.write(wire)
        else:
            buf = RefIOBuf()
            buf.append(wire)
            sock.write(buf)

    def handler(sock, msg):
        seen.append(msg.body)
        if msg.body == b"Crash":
            raise RuntimeError("bad day")
        if msg.body == b"Drop":
            sock.set_failed(ConnectionError("dropped by the handler"))
            return None
        with lock:
            if len(seen) <= N_REVERSED:
                held.append(msg)
                if len(held) < N_REVERSED:
                    return None
                batch = list(reversed(held))
            else:
                batch = [msg]
        for m in batch:
            write(sock, m)
        return None
    return handler


def _server(kind, seen):
    handler = _reversing_handler(kind, seen)
    if kind == "port":
        srv = Server(ServerOptions(esp_service=handler))
    else:
        srv = RefServer(RefServerOptions(esp_service=handler))
    return srv, srv.start("tcp://127.0.0.1:0")


def case_e2e(client, server):
    seen = []
    srv, ep = _server(server, seen)
    mod = esp if client == "port" else ref_esp
    fib = port_fiber if client == "port" else ref_fiber
    cd = CountdownEvent if client == "port" else RefCountdown
    c = mod.EspClient(f"127.0.0.1:{ep.port}", stargate_id=7, timeout_s=15)
    try:
        # the first N_REVERSED calls come back in reverse order
        results, errs = {}, []

        def worker(i):
            try:
                r = c.call(to=1, body=f"m{i}".encode())
                results[i] = (r.body, r.to, r.from_)
            except Exception as e:      # pragma: no cover
                errs.append(e)
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(N_REVERSED)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(20)
        assert not errs and results == {
            i: (f"re-m{i}".encode(), 7, 1) for i in range(N_REVERSED)}
        # 8 threads on the shared client
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(N_REVERSED, N_REVERSED + 8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(20)
        assert not errs and len(results) == N_REVERSED + 8
        # call_async from more fibers than workers
        n = fib.global_control().concurrency + 8
        done = cd(n)
        bad = []

        async def one(i):
            try:
                r = await c.call_async(to=1, body=f"q{i}".encode())
                if r.body != f"re-q{i}".encode():
                    bad.append(i)
            except Exception as e:  # noqa: BLE001
                bad.append((i, str(e)))
            finally:
                done.signal()
        for i in range(n):
            fib.spawn(one, i)
        assert done.wait_pthread(30) and not bad, bad[:3]
        # a handler that raises answers nothing
        c2 = mod.EspClient(f"127.0.0.1:{ep.port}", timeout_s=0.5)
        try:
            with pytest.raises(TimeoutError):
                c2.call(to=1, body=b"Crash")
        finally:
            c2.close()
        # a dropped connection fails its calls; the next call dials anew
        with pytest.raises(Exception):
            c.call(to=1, body=b"Drop")
        assert c.call(to=1, body=b"again").body == b"re-again"
    finally:
        c.close()
        srv.stop()
        srv.join(5)


def case_no_esp_service():
    srv = Server(ServerOptions())
    ep = srv.start("tcp://127.0.0.1:0")
    c = esp.EspClient(f"127.0.0.1:{ep.port}", timeout_s=0.3)
    try:
        with pytest.raises(TimeoutError):
            c.call(to=1, body=b"nobody")
        assert "esp.process" not in srv.method_status
    finally:
        c.close()
        srv.stop()
        srv.join(5)


def case_leak_check_sees_a_client():
    """A case that leaves an EspClient's socket open fails ``_run_cases``,
    on mem:// too, where no fd is registered; closing it passes."""
    srv = Server(ServerOptions(esp_service=lambda sock, msg: msg.body))
    ep = srv.start("mem://port-esp-leak")
    try:
        left = []

        def leaky():
            c = esp.EspClient(ep)
            c._get_socket()
            left.append(c)
        with pytest.raises(AssertionError, match="esp client sockets"):
            _run_cases([("leaky", leaky, ())], limit_s=20.0)
        assert esp.live_sockets() == 1
        left[0].close()
        assert esp.live_sockets() == 0
    finally:
        srv.stop()
        srv.join(5)


CASES = ([("frames against brpc_tpu's", case_frames, ())]
         + [(f"e2e {c} client, {s} server", case_e2e, (c, s))
            for c, s in (("port", "port"), ("port", "ref"), ("ref", "port"))]
         + [("no esp_service", case_no_esp_service, ()),
            ("the leak check sees a client", case_leak_check_sees_a_client,
             ())])


def test_esp():
    _run_cases(CASES, limit_s=60.0)
