"""The port's HTTP/1.1 client (``protocol/http_client.py``) against
brpc_tpu's, on the CPU.

- The cases of tests/test_http_client.py three ways: the port's client
  to a port server, brpc_tpu's client to a port server and the port's
  client to a brpc_tpu server: keep-alive pages, a POST to a method, a
  chunked body read progressively, then the connection reused; a dead
  server and a silent one fail the call.
- Framings the servers never send, from a raw socket server: a HEAD
  answer with a Content-Length and no body, a negative Content-Length
  refused, a body that ends at the close, gzip and deflate bodies.
- The response head: fastcore's ``http_parse_resp_head`` and the pure
  twin (``BRPC_TPU_TORCH_NO_NATIVE``'s lane) give brpc_tpu's classic
  loop's statuses, events, bytes left and state on the golden heads of
  tests/test_http_native.py and 500 seeded fuzzed ones.
- A progressive chunk whose send fails returns, and the next write is
  refused (the socket's failure runs the attachment's subscriber under
  the lock the write holds).
- Generate's chunked body through ``on_chunk`` equals the plain model's
  tokens; calls from fibers through ``request_async``; a server with an
  Authenticator refuses the client without ``Authorization`` and
  answers it with.
- ``rpc_press --protocol http`` and ``parallel_http`` against a port
  server: every call answered, and the press's count the server's.

One collected test over the cases (``_run_cases`` of
test_torch_cluster.py).
"""

import json
import random
import socket as pysocket
import socketserver
import subprocess
import sys
import threading
import time
import zlib
import gzip
from pathlib import Path

from brpc_tpu.butil.iobuf import IOPortal as RefPortal
from brpc_tpu.protocol import http_client as ref_hc
from brpc_tpu.rpc import Server as RefServer
from brpc_tpu.rpc import ServerOptions as RefServerOptions
from brpc_tpu.rpc import Service as RefService

import brpc_tpu_torch.fiber as port_fiber
from brpc_tpu_torch.butil.iobuf import IOPortal
from brpc_tpu_torch.fiber import CountdownEvent, global_control
from brpc_tpu_torch.native import fastcore
from brpc_tpu_torch.protocol import http_client as port_hc
from brpc_tpu_torch.protocol.registry import PARSE_OK
from brpc_tpu_torch.rpc import (Server, ServerOptions, Service,
                                TokenAuthenticator)
from brpc_tpu_torch.serving import (TinyDecoder, TinyDecoderConfig,
                                    add_generate_service)

from test_http_native import GOLDEN_RESPONSES, _random_response
from test_torch_cluster import _run_cases, _wait_for

ROOT = Path(__file__).resolve().parent.parent
CLIENTS = {"port": port_hc, "ref": ref_hc}


def _server(kind):
    """A server of ``kind`` with ``EchoService.Echo`` and ``Stream`` (a
    progressive body of four parts) and its builtin pages."""
    if kind == "port":
        server, svc, fiber = Server(ServerOptions()), Service("EchoService"), \
            port_fiber
    else:
        server, svc = RefServer(RefServerOptions()), RefService("EchoService")
        import brpc_tpu.fiber as fiber

    def Echo(cntl, request):
        return bytes(request)

    def Stream(cntl, request):
        pa = cntl.create_progressive_attachment("text/plain")

        async def feed():
            for i in range(4):
                pa.write(f"part-{i};".encode())
                await fiber.sleep(0.01)
            pa.close()
        fiber.spawn(feed)
        return None
    svc.method()(Echo)
    svc.method()(Stream)
    server.add_service(svc)
    return server, server.start("tcp://127.0.0.1:0")


def _stop(server):
    server.stop()
    server.join(5)


def case_buffered_and_progressive(client, server_kind):
    server, ep = _server(server_kind)
    cl = CLIENTS[client].HttpClient(f"tcp://127.0.0.1:{ep.port}")
    try:
        status, headers, body = cl.get("/health")
        assert status == 200 and body == b"OK", (status, body)
        sock = cl._socket
        status, _, body = cl.get("/status")
        assert status == 200 and b"running" in body
        assert cl._socket is sock              # keep-alive
        status, _, body = cl.post("/EchoService/Echo", b"payload-bytes")
        assert status == 200 and b"payload-bytes" in body
        chunks = []
        status, headers, body = cl.get("/EchoService/Stream",
                                       on_chunk=chunks.append)
        assert status == 200 and body == b""
        assert headers.get("transfer-encoding") == "chunked"
        assert b"".join(chunks) == b"part-0;part-1;part-2;part-3;"
        assert len(chunks) >= 2, chunks      # delivered as they came
        status, _, body = cl.get("/health")
        assert status == 200 and body == b"OK" and cl._socket is sock
    finally:
        cl.close()
        _stop(server)


def case_failures(client, server_kind):
    mod = CLIENTS[client]
    server, ep = _server(server_kind)
    cl = mod.HttpClient(f"tcp://127.0.0.1:{ep.port}", timeout_s=5.0)
    try:
        assert cl.get("/health")[0] == 200
        _stop(server)
        try:
            cl.get("/health")
            raise AssertionError("a dead server answered")
        except mod.HttpClientError:
            pass
    finally:
        cl.close()
    ls = pysocket.socket()
    ls.bind(("127.0.0.1", 0))
    ls.listen(1)
    cl = mod.HttpClient(f"tcp://127.0.0.1:{ls.getsockname()[1]}",
                        timeout_s=0.5)
    try:
        t0 = time.monotonic()
        try:
            cl.get("/never")
            raise AssertionError("a silent server answered")
        except mod.HttpClientError:
            pass
        assert time.monotonic() - t0 < 3.0
    finally:
        cl.close()
        ls.close()


class _RawHttpServer(socketserver.ThreadingTCPServer):
    """Answers every connection with ``response`` and closes it."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, response: bytes):
        outer = self

        class H(socketserver.BaseRequestHandler):
            def handle(self):
                self.request.recv(65536)
                self.request.sendall(outer.response)
                self.request.close()
        super().__init__(("127.0.0.1", 0), H)
        self.response = response

    def __enter__(self):
        threading.Thread(target=self.serve_forever, daemon=True).start()
        return f"tcp://127.0.0.1:{self.server_address[1]}"

    def __exit__(self, *exc):
        self.shutdown()
        self.server_close()


def case_raw_framings():
    head = (b"HTTP/1.1 200 OK\r\nContent-Type: text/plain\r\n"
            b"Content-Length: 12345\r\n\r\n")
    with _RawHttpServer(head) as addr:
        cl = port_hc.HttpClient(addr, timeout_s=3.0)
        try:
            t0 = time.monotonic()
            status, headers, body = cl.request("HEAD", "/x")
            assert status == 200 and body == b""
            assert headers["content-length"] == "12345"
            assert time.monotonic() - t0 < 2.0
        finally:
            cl.close()
    with _RawHttpServer(b"HTTP/1.1 200 OK\r\nContent-Length: -1\r\n\r\n"
                        b"sneaky body") as addr:
        cl = port_hc.HttpClient(addr, timeout_s=3.0)
        try:
            cl.request("GET", "/x")
            raise AssertionError("a negative Content-Length was taken")
        except port_hc.HttpClientError:
            pass
        finally:
            cl.close()
    with _RawHttpServer(b"HTTP/1.1 200 OK\r\nContent-Type: text/plain\r\n"
                        b"\r\nbody-until-close") as addr:
        cl = port_hc.HttpClient(addr)
        try:
            assert cl.get("/") == (200, {"content-type": "text/plain"},
                                   b"body-until-close")
        finally:
            cl.close()
    text = b"compressed body " * 64
    for enc, data in (("gzip", gzip.compress(text)),
                      ("deflate", zlib.compress(text))):
        raw = (f"HTTP/1.1 200 OK\r\nContent-Encoding: {enc}\r\n"
               f"Content-Length: {len(data)}\r\n\r\n").encode() + data
        with _RawHttpServer(raw) as addr:
            # the raw server closes each connection after one answer: a
            # client a request
            with port_hc.HttpClient(addr) as cl:
                status, _, body = cl.get("/")
                assert status == 200 and body == text, enc
            chunks = []
            with port_hc.HttpClient(addr) as cl:
                cl.get("/", on_chunk=chunks.append)
            # progressive parts are delivered as they came, encoded
            assert b"".join(chunks) == data


class _Sock:
    def __init__(self):
        self.failed = False
        self.preferred_protocol = -1
        self.user_data = {}

    def set_failed(self, e):
        self.failed = True


def _drive(proto, portal, data: bytes):
    portal.append(data)
    sock = _Sock()
    events, statuses = [], []
    for _ in range(30):
        status, msgs = proto.parse(portal, sock)
        statuses.append(status)
        if status != PARSE_OK:
            break
        events.extend(msgs)
    st = sock.user_data.get("http_resp_state")
    snap = (st.phase, st.status, sorted(st.headers.items()), st.mode,
            st.remaining) if st is not None else None
    return statuses, events, portal.size, snap


def _lanes(data: bytes):
    """(brpc_tpu's classic loop, the port's native lane, its pure lane)."""
    saved_ref, saved_port = ref_hc._FC, port_hc._fc
    try:
        ref_hc._FC = None
        ref = _drive(ref_hc.HttpResponseProtocol(), RefPortal(), data)
        port_hc._fc = fastcore.get()
        native = _drive(port_hc.HttpResponseProtocol(), IOPortal(), data)
        port_hc._fc = None
        pure = _drive(port_hc.HttpResponseProtocol(), IOPortal(), data)
    finally:
        ref_hc._FC, port_hc._fc = saved_ref, saved_port
    return ref, native, pure


def case_response_head_parity():
    assert fastcore.get() is not None and hasattr(
        fastcore.get(), "http_parse_resp_head"), fastcore.load_error
    before = port_hc.nnative_resp_heads.get_value()
    rng = random.Random(0x5EED)
    corpus = list(GOLDEN_RESPONSES) + [_random_response(rng)
                                       for _ in range(500)]
    for data in corpus:
        ref, native, pure = _lanes(data)
        assert native == ref, (data[:120], native, ref)
        assert pure == ref, (data[:120], pure, ref)
    # the native lane read heads itself, not only by deferring
    assert port_hc.nnative_resp_heads.get_value() > before + 10


def case_generate_progressive():
    server = Server()
    add_generate_service(server, device="cpu", cache_len=96)
    ep = server.start("tcp://127.0.0.1:0")
    model = TinyDecoder(TinyDecoderConfig(cache_len=96), device="cpu")
    cl = port_hc.HttpClient(f"tcp://127.0.0.1:{ep.port}", timeout_s=30)
    try:
        for prompt in ("hello world", "a"):
            chunks = []
            status, headers, body = cl.post(
                "/GenerateService/Generate",
                json.dumps({"prompt": prompt, "max_tokens": 12}).encode(),
                on_chunk=chunks.append)
            assert status == 200 and body == b""
            raw = b"".join(chunks)
            tokens, _, footer = raw.partition(b"\n#")
            assert list(tokens) == model.generate(list(prompt.encode()), 12)
            assert footer == b"completed n=12", footer
    finally:
        cl.close()
        _stop(server)


def case_request_async_from_fibers():
    server, ep = _server("port")
    n = global_control().concurrency + 8
    done = CountdownEvent(n)
    bad = []

    async def one(i):
        cl = port_hc.HttpClient(f"tcp://127.0.0.1:{ep.port}")
        try:
            status, _, body = await cl.request_async(
                "POST", "/EchoService/Echo", body=b"m%d" % i)
            if status != 200 or body != b"m%d" % i:
                bad.append((i, status, body))
        except Exception as e:
            bad.append((i, -1, str(e)))
        finally:
            cl.close()
            done.signal()
    try:
        for i in range(n):
            global_control().spawn(one, i, name="http_client_case")
        assert done.wait_pthread(30)
        assert not bad, bad[:3]
    finally:
        _stop(server)


def case_auth_through_the_client():
    server = Server(ServerOptions(auth=TokenAuthenticator("t0k")))
    svc = Service("EchoService")
    svc.register_method("Echo", lambda cntl, req: bytes(req))
    server.add_service(svc)
    ep = server.start("tcp://127.0.0.1:0")
    addr = f"tcp://127.0.0.1:{ep.port}"
    try:
        with port_hc.HttpClient(addr) as cl:
            assert cl.post("/EchoService/Echo", b"x")[0] == 403
            assert cl.get("/health")[0] == 200
        with port_hc.HttpClient(addr) as cl:
            status, _, body = cl.post(
                "/EchoService/Echo", b"x",
                headers={"Authorization": "Bearer t0k"})
            assert status == 200 and body == b"x"
            assert cl.get("/status")[0] == 200     # once a connection
    finally:
        _stop(server)


def _run_tool(argv, timeout_s=120):
    out = subprocess.run([sys.executable, "-m", *argv], capture_output=True,
                         text=True, timeout=timeout_s, cwd=ROOT)
    return out.returncode, out.stdout, out.stderr


def case_press_and_parallel_http():
    server = Server()
    add_generate_service(server, device="cpu", cache_len=96)
    ep = server.start("tcp://127.0.0.1:0")
    try:
        rc, out, err = _run_tool([
            "brpc_tpu_torch.tools.rpc_press", f"tcp://127.0.0.1:{ep.port}",
            "GenerateService", "Generate", "--protocol", "http",
            "--qps", "200", "--count", "40", "--conns", "4",
            "--procs", "2", "--json"])
        assert rc == 0, (out + err)[-2000:]
        rep = json.loads(out.strip().splitlines()[-1])
        served = server.method_status["GenerateService.Generate"].count()
        assert rep["workers"] == 2 and rep["dead_workers"] == 0
        assert rep["records"] == rep["issued"] == rep["ok"] == 40 == served
        assert rep["classes"]["GenerateService.Generate|p0"]["p50_ms"] > 0
        urls = [f"http://127.0.0.1:{ep.port}{p}"
                for p in ("/health", "/status", "/vars", "/serving")]
        rc, out, err = _run_tool(["brpc_tpu_torch.tools.parallel_http",
                                  *urls, "--concurrency", "3", "--json"])
        assert rc == 0, (out + err)[-2000:]
        doc = json.loads(out.strip().splitlines()[-1])
        assert doc["ok"] == 4 and [r["status"] for r in doc["results"]] \
            == [200] * 4
        rc, out, _ = _run_tool(["brpc_tpu_torch.tools.parallel_http",
                                f"http://127.0.0.1:{ep.port}/health",
                                "http://127.0.0.1:1/nothing"])
        assert rc == 1 and "1/2 succeeded" in out, out
    finally:
        _stop(server)


class _ResetConn:
    """A connection whose peer has reset: every send raises."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def write(self, data):
        raise ConnectionResetError(104, "Connection reset by peer")

    writev = write


def case_progressive_send_fails():
    """A chunk whose send fails: the socket's failure runs the
    attachment's own subscriber where the send failed, under the lock
    the write holds. The write returns, the next one is refused, and
    the body counts as finished."""
    server = Server(ServerOptions())
    svc = Service("EchoService")
    got, bound = {}, threading.Event()

    def Stream(cntl, request):
        pa = cntl.create_progressive_attachment("text/plain")
        got["pa"] = pa

        def feed():
            _wait_for(lambda: pa._conn is not None, 5.0)
            bound.set()
        threading.Thread(target=feed, daemon=True).start()
        return None
    svc.method()(Stream)
    server.add_service(svc)
    ep = server.start("tcp://127.0.0.1:0")
    c = pysocket.create_connection(("127.0.0.1", ep.port))
    try:
        c.sendall(b"GET /EchoService/Stream HTTP/1.1\r\nHost: x\r\n\r\n")
        assert bound.wait(5.0)
        pa = got["pa"]
        pa._conn.conn = _ResetConn(pa._conn.conn)
        writer = threading.Thread(
            target=lambda: got.setdefault("first", pa.write(b"chunk")),
            daemon=True)
        writer.start()
        writer.join(5.0)
        assert "first" in got, "the write hung on its own failure"
        assert pa._conn.failed
        assert pa.write(b"more") is False
        assert pa._finished.is_set()
    finally:
        c.close()
        _stop(server)


CASES = [
    *[(f"{kind} client -> {srv} server: {name}", fn, (kind, srv))
      for kind, srv in (("port", "port"), ("ref", "port"), ("port", "ref"))
      for name, fn in (("buffered and progressive",
                        case_buffered_and_progressive),
                       ("failures", case_failures))],
    ("raw framings", case_raw_framings, ()),
    ("response head parity", case_response_head_parity, ()),
    ("Generate read progressively", case_generate_progressive, ()),
    ("a progressive send that fails", case_progressive_send_fails, ()),
    ("request_async from fibers", case_request_async_from_fibers, ()),
    ("auth through the client", case_auth_through_the_client, ()),
    ("rpc_press --protocol http and parallel_http",
     case_press_and_parallel_http, ()),
]


def test_http_client():
    _run_cases(CASES, limit_s=60.0)
