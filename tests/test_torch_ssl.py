"""ssl:// (``brpc_tpu_torch/transport/ssl.py``) against brpc_tpu's, on the
CPU: the cases of tests/test_ssl_and_limits.py's ``TestSslTransport``
(calls over TLS, a 1 MiB payload, a plaintext client refused, a listener
without a certificate refused) four ways, port -> port, brpc_tpu ->
brpc_tpu and both ways across the wire, on the selector lane and on the
ring lane (where an ssl conn registers poll-only: its decrypted bytes
wait above the fd). The lane is chosen when a process's dispatcher is
built, so each lane runs in a process of its own. The certificate pair
is made with ``openssl req``, as the reference's test makes it.

A writer that TLS asks to read first on an established connection
parks until the read path runs (``SslConn._wake_parked_writer``): with a
stand-in SSL object whose ``send`` wants a read until one came, the
write is tried once before the read, where a writable event, firing at
once on an open socket, would retry it without bound.

One collected test over the cases (``_run_cases`` of
test_torch_cluster.py).
"""

import json
import os
import socket as pysocket
import ssl as pyssl
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import brpc_tpu_torch.rpc as port_rpc
from brpc_tpu_torch.butil.endpoint import EndPoint
from brpc_tpu_torch.transport.socket import Socket
from brpc_tpu_torch.transport.ssl import SslConn

from test_torch_cluster import _run_cases

ROOT = Path(__file__).resolve().parent.parent

_CHILD = r"""
import json, os, sys
sys.path.insert(0, os.getcwd())
cert, key = sys.argv[1], sys.argv[2]
import brpc_tpu.rpc as ref_rpc
import brpc_tpu_torch.rpc as port_rpc
from brpc_tpu.transport.event_dispatcher import (
    global_dispatcher as ref_dispatcher)
from brpc_tpu_torch.transport.event_dispatcher import (
    global_dispatcher as port_dispatcher)


def server(kind):
    rpc = port_rpc if kind == "port" else ref_rpc
    srv = rpc.Server() if kind == "port" else rpc.Server(
        rpc.ServerOptions(enable_builtin_services=False))
    svc = rpc.Service("EchoService")

    def Echo(cntl, request):
        return bytes(request)
    svc.method()(Echo)
    srv.add_service(svc)
    ep = srv.start(f"ssl://127.0.0.1:0#cert={cert}&key={key}")
    return srv, ep.port


def body(kind, c):
    if c.failed():
        return None
    return bytes(c.response) if kind == "port" else \
        c.response_payload.to_bytes()


out = {"lanes": [type(port_dispatcher()).__name__,
                 type(ref_dispatcher()).__name__]}
for ck, sk in (("port", "port"), ("ref", "ref"), ("port", "ref"),
               ("ref", "port")):
    rpc = port_rpc if ck == "port" else ref_rpc
    srv, port = server(sk)
    row = {}
    try:
        ch = rpc.Channel(f"ssl://127.0.0.1:{port}",
                         rpc.ChannelOptions(timeout_ms=30000))
        row["small"] = all(
            body(ck, ch.call_sync("EchoService", "Echo", b"tls-%d" % i))
            == b"tls-%d" % i for i in range(3))
        big = bytes(range(256)) * 4096
        row["large"] = body(ck, ch.call_sync("EchoService", "Echo",
                                             big)) == big
        ch.close()
        plain = rpc.Channel(f"tcp://127.0.0.1:{port}",
                            rpc.ChannelOptions(timeout_ms=2000,
                                               max_retry=0))
        row["plaintext_refused"] = plain.call_sync(
            "EchoService", "Echo", b"nope").failed()
        plain.close()
    finally:
        srv.stop()
        srv.join(2)
    out[f"{ck}->{sk}"] = row
print(json.dumps(out))
"""


def _certpair(d: str):
    cert, key = os.path.join(d, "cert.pem"), os.path.join(d, "key.pem")
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", key, "-out", cert, "-days", "2", "-subj",
         "/CN=localhost"], check=True, capture_output=True)
    return cert, key


def case_tls_on_both_lanes():
    with tempfile.TemporaryDirectory() as d:
        cert, key = _certpair(d)
        procs = {}
        for flag in ("0", "1"):
            env = dict(os.environ, JAX_PLATFORMS="cpu",
                       BRPC_TPU_FLAG_EVENT_RING_LANE=flag)
            procs[flag] = subprocess.Popen(
                [sys.executable, "-c", _CHILD, cert, key], cwd=ROOT,
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)
        got = {}
        for flag, p in procs.items():
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, (out + err)[-3000:]
            got[flag] = json.loads(out.strip().splitlines()[-1])
    assert got["0"]["lanes"] == ["EventDispatcher"] * 2, got["0"]
    assert got["1"]["lanes"] == ["RingDispatcher"] * 2, got["1"]
    want = {"small": True, "large": True, "plaintext_refused": True}
    for flag, doc in got.items():
        for wiring in ("port->port", "ref->ref", "port->ref", "ref->port"):
            assert doc[wiring] == want, (flag, wiring, doc[wiring])


def case_listener_requires_cert():
    srv = port_rpc.Server()
    try:
        srv.start("ssl://127.0.0.1:0")
    except ValueError as e:
        assert "cert" in str(e)
    else:
        srv.stop()
        raise AssertionError("an ssl:// listener without #cert started")


class _WantsReadSsl:
    """An SSL object's stand-in over one end of a socketpair: ``send``
    raises SSLWantReadError until ``recv_into`` has read bytes."""

    def __init__(self, raw):
        self.raw = raw
        self.sends = 0
        self.read_seen = False
        self.sent = bytearray()

    def setblocking(self, flag):
        self.raw.setblocking(flag)

    def fileno(self):
        return self.raw.fileno()

    def do_handshake(self):
        pass

    def send(self, mv):
        self.sends += 1
        if not self.read_seen:
            raise pyssl.SSLWantReadError("records to read first")
        self.sent += bytes(mv)
        return len(mv)

    def recv_into(self, mv):
        n = self.raw.recv_into(mv)      # BlockingIOError when empty
        if n:
            self.read_seen = True
        return n

    def pending(self):
        return 0

    def close(self):
        self.raw.close()


def case_writer_parks_until_a_read():
    a, b = pysocket.socketpair()
    fake = _WantsReadSsl(a)
    conn = SslConn(fake, EndPoint("ssl", "127.0.0.1", 1),
                   EndPoint("ssl", "127.0.0.1", 2))
    conn._handshaken = True             # established
    read = []
    sock = Socket(conn, on_input=lambda s: read.append(
        s.input_portal.cut(s.input_portal.size).to_bytes()))
    done = threading.Event()
    try:
        assert sock.write(b"payload", on_done=lambda err: done.set())
        time.sleep(0.3)
        tries = fake.sends
        assert not done.is_set() and tries <= 2, \
            f"{tries} sends before any read"
        b.sendall(b"r")                 # the read the writer waits for
        assert done.wait(5), f"the write stayed parked ({fake.sends})"
        assert bytes(fake.sent) == b"payload" and read == [b"r"]
        assert fake.sends <= tries + 1, (tries, fake.sends)
    finally:
        sock.set_failed(ConnectionError("case over"))
        b.close()


CASES = [
    ("TLS both ways on both lanes", case_tls_on_both_lanes, ()),
    ("a listener needs a certificate", case_listener_requires_cert, ()),
    ("a writer that wants a read parks until one",
     case_writer_parks_until_a_read, ()),
]


def test_ssl():
    _run_cases(CASES, limit_s=150.0)
