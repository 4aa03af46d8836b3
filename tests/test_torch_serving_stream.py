"""The stream and HTTP paths of the port's GenerateService, on the CPU.

The cases of tests/test_serving.py's TestServingE2E that drive a stream
or HTTP chunks, against the port's server on the plain CPU path: tokens
as they decode, and the first one well before the last; deadline
eviction mid-generation (``e1008``), then a fresh request; HTTP chunked
transfer with its ``#completed`` footer; shedding behind stream hogs;
a consumer that stops granting credits still getting its ``d`` frame;
a request that expires in the queue while the batch is full. Tokens are
exact integers and must equal the JAX package's ``TinyDecoder.generate``
(the server's weights carry over bit for bit, ``serving/convert.py``).
Added here: one stream across the wire each way, an HTTP peer that dies
mid-body and frees its slot, and a peer that stops reading, which must
not hold up another request's decode.

The reference's fiber assertion (``batcher.steps_by_group``) holds
here too, and a server with two fiber workers in all answers unary,
stream and HTTP calls at once: nothing that waits may hold a worker,
or decode would starve. Left out until the port has it: the
``/serving`` builtin page (ROADMAP §1).
Long generations use ``cache_len`` 1024, not the reference's 4096,
which would make the CPU plain path slow.
"""

import http.client
import json
import socket
import threading
import time

import pytest

from brpc_tpu.rpc import Channel as RefChannel
from brpc_tpu.rpc import Server as RefServer
from brpc_tpu.rpc import ServerOptions as RefServerOptions
from brpc_tpu.rpc.controller import Controller as RefController
from brpc_tpu.rpc.stream import StreamOptions as RefStreamOptions
from brpc_tpu.serving import TinyDecoder as RefDecoder
from brpc_tpu.serving import TinyDecoderConfig as RefConfig
from brpc_tpu.serving import add_generate_service as ref_add_generate_service
from brpc_tpu_torch.rpc import Channel, ChannelOptions, Controller, Server
from brpc_tpu_torch.rpc import errno_codes as berr
from brpc_tpu_torch.serving import StreamOptions, add_generate_service
from brpc_tpu_torch.serving import service as service_mod
from brpc_tpu_torch.serving.convert import same_weights
from brpc_tpu_torch.serving.model import PARAM_NAMES

LONG_CACHE = 1024
LONG = 1000                 # tokens: seconds of CPU decode at LONG_CACHE


@pytest.fixture(scope="module")
def oracle():
    ref = RefDecoder(RefConfig(cache_len=160))
    return ref


def _body(prompt: str, max_tokens: int) -> bytes:
    return json.dumps({"prompt": prompt, "max_tokens": max_tokens}).encode()


def _wait_for(cond, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.005)
    return cond()


@pytest.fixture
def serving():
    servers = []

    def start(**kw):
        server = Server()
        gs = add_generate_service(server, device="cpu", **kw)
        ep = server.start("tcp://127.0.0.1:0")
        servers.append(server)
        return server, gs, ep

    yield start
    for s in servers:
        s.stop()
        s.join(5)


class _StreamClient:
    """One streaming Generate call: collects the tagged frames."""

    def __init__(self, ch, prompt: str, max_tokens: int,
                 timeout_ms: float = 30000, hold=None):
        self.tokens, self.token_ns = [], []
        self.done = None            # ("d", doc) | ("e", errno)
        self._hold = hold           # an Event each frame waits for
        self.t0 = time.monotonic_ns()
        self.cntl = ch.call_sync(
            "GenerateService", "Generate", _body(prompt, max_tokens),
            cntl=Controller(timeout_ms=timeout_ms),
            stream_options=StreamOptions(on_received=self._on_frame))
        self.stream = self.cntl.stream

    def _on_frame(self, s, msg):
        if self._hold is not None:
            self._hold.wait(30)
        p = msg.payload
        tag, rest = p[:1], p[1:]
        if tag == b"t":
            self.tokens.append(rest[0])
            self.token_ns.append(time.monotonic_ns())
        elif tag == b"d":
            self.done = ("d", json.loads(rest.decode()))
        elif tag == b"e":
            self.done = ("e", int(rest.decode()))

    def wait_done(self, timeout_s=15.0) -> bool:
        return _wait_for(lambda: self.done is not None, timeout_s)


def _http_generate(port, prompt, max_tokens):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=15)
    try:
        conn.request("POST", "/GenerateService/Generate",
                     body=_body(prompt, max_tokens))
        resp = conn.getresponse()
        return resp.status, resp.getheader("Transfer-Encoding"), resp.read()
    finally:
        conn.close()


class TestServingStreamE2E:
    def test_stream_tokens_and_ttft(self, serving, oracle):
        server, gs, ep = serving()
        assert same_weights(gs.batcher.model,
                            {n: getattr(oracle, n) for n in PARAM_NAMES})
        want = oracle.generate(list(b"hello world"), 60)
        ch = Channel(str(ep))
        try:
            # the first call on a fresh channel pays the connect
            assert _StreamClient(ch, "w", 2).wait_done()
            c = _StreamClient(ch, "hello world", 60)
            assert not c.cntl.failed(), c.cntl.error_text
            assert c.cntl.response == b"accepted"
            assert c.wait_done()
            assert c.done == ("d", {"n": 60, "status": "completed"})
            assert c.tokens == want
            # streaming is real: the first token landed well before the
            # last
            ttft = c.token_ns[0] - c.t0
            total = c.token_ns[-1] - c.t0
            assert ttft < total * 0.5, (ttft, total)
            assert gs.engine.steps > 0
            assert sum(gs.batcher.steps_by_group.values()) > 0
            assert gs._payload()["ttft_ms"]["count"] == 2
        finally:
            ch.close()

    def test_stream_deadline_eviction(self, serving):
        server, gs, ep = serving(cache_len=LONG_CACHE)
        ch = Channel(str(ep))
        try:
            c = _StreamClient(ch, "slow one", LONG, timeout_ms=400)
            assert not c.cntl.failed(), c.cntl.error_text
            assert c.wait_done()
            assert c.done == ("e", berr.ERPCTIMEDOUT)
            assert 0 < len(c.tokens) < LONG     # evicted MID-generation
            assert _wait_for(lambda: gs.batcher.running_count() == 0)
            c2 = _StreamClient(ch, "after", 5)
            assert c2.wait_done() and c2.done[0] == "d"
            assert len(c2.tokens) == 5
        finally:
            ch.close()

    def test_http_chunked_streaming(self, serving, oracle):
        server, gs, ep = serving()
        status, te, body = _http_generate(ep.port, "http body", 16)
        assert status == 200 and te == "chunked"
        payload, _, footer = body.rpartition(b"\n#")
        assert footer == b"completed n=16"
        assert list(payload) == oracle.generate(list(b"http body"), 16)
        # errors answer as plain HTTP
        conn = http.client.HTTPConnection("127.0.0.1", ep.port, timeout=5)
        try:
            conn.request("POST", "/GenerateService/Generate", body=b"{bad")
            r = conn.getresponse()
            assert r.status == 400 and r.read().startswith(b"[1003] ")
            conn.request("POST", "/GenerateService/Nope", body=b"")
            r = conn.getresponse()
            assert r.status == 404 and r.read() == b"no such service/method"
        finally:
            conn.close()

    def test_shed_when_engine_full(self, serving):
        server, gs, ep = serving(max_batch=1, max_waiting=1,
                                 cache_len=LONG_CACHE)
        ch = Channel(str(ep), ChannelOptions(timeout_ms=5000))
        try:
            # the slot, then the whole wait queue, taken by long streams
            hogs = [_StreamClient(ch, "hog0", LONG)]
            assert _wait_for(lambda: gs.batcher.running_count() == 1)
            hogs.append(_StreamClient(ch, "hog1", LONG))
            for h in hogs:
                assert not h.cntl.failed(), h.cntl.error_text
            c = ch.call_sync("GenerateService", "Generate",
                             _body("extra", 4))
            assert c.error_code == berr.ELIMIT, (c.error_code, c.error_text)
            assert gs.batcher.shed >= 1
            for h in hogs:              # the clients walk away: slots free
                h.stream.close()
            assert _wait_for(lambda: gs.batcher.running_count()
                             + gs.batcher.waiting_count() == 0)
            assert gs.batcher.canceled == 2
        finally:
            ch.close()

    def test_slow_consumer_still_gets_terminal_frame(self, serving, oracle,
                                                     monkeypatch):
        """The consumer delivers nothing until the sequence has retired,
        so the credit window runs dry mid-tail: the held remainder, the
        d frame included, must still arrive, through the drain fiber."""
        drains = []
        real_drain = service_mod._StreamSender._drain_then_close

        def counted(self):
            drains.append(len(self._pending))
            return real_drain(self)

        monkeypatch.setattr(service_mod._StreamSender, "_drain_then_close",
                            counted)
        server, gs, ep = serving()
        want = oracle.generate(list(b"slow reader"), 120)
        ch = Channel(str(ep))
        hold = threading.Event()
        try:
            c = _StreamClient(ch, "slow reader", 120, timeout_ms=60000,
                              hold=hold)
            assert not c.cntl.failed(), c.cntl.error_text
            assert _wait_for(lambda: gs.batcher.completed == 1, 30)
            assert _wait_for(lambda: drains, 5)
            # 64 credits went out, the other 56 tokens and d were held
            assert drains == [120 - 64 + 1]
            hold.set()
            assert c.wait_done(30)
            assert c.done == ("d", {"n": 120, "status": "completed"})
            assert c.tokens == want
            assert _wait_for(lambda: c.stream.remote_closed)
        finally:
            hold.set()
            ch.close()

    def test_expired_in_queue_evicted_while_batch_full(self, serving):
        """A deadline-dead request gets its e1008 from the queue sweep,
        not after the batch ahead of it."""
        server, gs, ep = serving(max_batch=1, max_waiting=4,
                                 cache_len=LONG_CACHE)
        ch = Channel(str(ep))
        try:
            hog = _StreamClient(ch, "hog", LONG)        # owns the slot
            assert not hog.cntl.failed(), hog.cntl.error_text
            assert _wait_for(lambda: gs.batcher.running_count() == 1)
            victim = _StreamClient(ch, "queued", 50, timeout_ms=300)
            assert not victim.cntl.failed(), victim.cntl.error_text
            t0 = time.monotonic()
            assert victim.wait_done(10)
            verdict_s = time.monotonic() - t0
            assert victim.done == ("e", berr.ERPCTIMEDOUT), victim.done
            assert victim.tokens == []      # never admitted
            assert verdict_s < 2.0, verdict_s
            hog.stream.close()
        finally:
            ch.close()


# -------------------------------------------------------- across the wire

def test_reference_channel_streams_from_port_server(serving, oracle):
    server, gs, ep = serving()
    want = oracle.generate(list(b"cross wire"), 24)
    tokens, done = [], []

    def on_frame(s, msg):
        p = msg.payload.to_bytes()
        if p[:1] == b"t":
            tokens.append(p[1])
        else:
            done.append(p)

    ch = RefChannel(f"tcp://127.0.0.1:{ep.port}")
    try:
        cntl = RefController()
        cntl.timeout_ms = 20000
        cntl = ch.call_sync("GenerateService", "Generate",
                            _body("cross wire", 24), cntl=cntl,
                            stream_options=RefStreamOptions(
                                on_received=on_frame))
        assert not cntl.failed(), cntl.error_text
        assert cntl.response_payload.to_bytes() == b"accepted"
        assert _wait_for(lambda: done, 15)
        assert done == [b'd{"n": 24, "status": "completed"}']
        assert tokens == want
    finally:
        ch.close()


def test_port_channel_streams_from_reference_server(oracle):
    server = RefServer(RefServerOptions(enable_builtin_services=False))
    ref_add_generate_service(server, cache_len=160, warmup=True)
    ep = server.start("tcp://127.0.0.1:0")
    ch = Channel(f"tcp://127.0.0.1:{ep.port}",
                 ChannelOptions(timeout_ms=30000))
    try:
        c = _StreamClient(ch, "cross wire", 24)
        assert not c.cntl.failed(), c.cntl.error_text
        assert c.cntl.response == b"accepted"
        assert c.wait_done()
        assert c.done == ("d", {"n": 24, "status": "completed"})
        assert c.tokens == oracle.generate(list(b"cross wire"), 24)
    finally:
        ch.close()
        server.stop()
        server.join(5)


# -------------------------------------------------------------- dead peers

def _read_first_chunk(sock) -> bytes:
    sock.settimeout(10)
    data = b""
    while b"\r\n\r\n" not in data or \
            data.index(b"\r\n\r\n") + 4 >= len(data):
        part = sock.recv(4096)
        assert part, "server closed before the first chunk"
        data += part
    return data


def test_http_dead_peer_frees_its_slot(serving):
    server, gs, ep = serving(cache_len=LONG_CACHE)
    sock = socket.create_connection(("127.0.0.1", ep.port))
    body = _body("doomed", LONG)
    sock.sendall(b"POST /GenerateService/Generate HTTP/1.1\r\n"
                 b"Content-Length: %d\r\n\r\n%s" % (len(body), body))
    head = _read_first_chunk(sock)
    assert head.startswith(b"HTTP/1.1 200") and b"chunked" in head
    assert gs.batcher.running_count() == 1
    sock.close()                        # the peer dies mid-body
    assert _wait_for(lambda: gs.batcher.running_count() == 0)
    assert gs.batcher.canceled == 1 and gs.batcher.completed == 0
    status, _, payload = _http_generate(ep.port, "next", 8)
    assert status == 200 and payload.endswith(b"\n#completed n=8")


class _StuckSocket:
    """A socket whose peer stopped reading: nothing more fits (a
    non-blocking send takes no byte, a blocking one waits) until it is
    shut down."""

    def __init__(self, sock):
        self._sock = sock
        self._down = threading.Event()

    def send(self, data, flags=0):
        raise BlockingIOError("peer not reading")

    def sendall(self, data):
        self._down.wait()
        raise BrokenPipeError("shut down")

    def shutdown(self, how):
        self._down.set()
        self._sock.shutdown(how)

    def __getattr__(self, name):
        return getattr(self._sock, name)


def test_reader_that_stops_draining_does_not_stall_decode(serving, oracle):
    """An HTTP peer stops reading its socket while its tokens decode; the
    decode thread only queues its chunks, so another request's stream
    still runs to the end, and so does the stuck one's generation."""
    server, gs, ep = serving()
    sock = socket.create_connection(("127.0.0.1", ep.port))
    ch = Channel(str(ep))
    try:
        assert _wait_for(lambda: len(server.connections()) == 1)
        stuck = server.connections()[0]
        stuck.sock = _StuckSocket(stuck.sock)
        body = _body("never read", 120)
        sock.sendall(b"POST /GenerateService/Generate HTTP/1.1\r\n"
                     b"Content-Length: %d\r\n\r\n%s" % (len(body), body))
        assert _wait_for(lambda: gs.batcher.running_count() == 1)
        c = _StreamClient(ch, "hello world", 60)
        assert c.wait_done(15)
        assert c.done == ("d", {"n": 60, "status": "completed"})
        assert c.tokens == oracle.generate(list(b"hello world"), 60)
        assert _wait_for(lambda: gs.batcher.completed == 2)
        assert stuck.write_backlog() > 120
    finally:
        ch.close()
        sock.close()


_TWO_WORKER_SERVER = """
import json, sys, threading
from brpc_tpu_torch.fiber import global_control, set_concurrency
set_concurrency(2)
from brpc_tpu_torch.rpc import Server
from brpc_tpu_torch.serving import add_generate_service
server = Server()
gs = add_generate_service(server, device="cpu", max_waiting=64)
ep = server.start("tcp://127.0.0.1:0")
print(json.dumps({"port": ep.port}), flush=True)
sys.stdin.readline()
names = {t.ident: t.name for t in threading.enumerate()}
print(json.dumps({
    "concurrency": server.control.concurrency,
    "decode_threads": sorted(names.get(i, "?") for i in gs.engine.threads_seen),
    "steps_by_group": sum(gs.batcher.steps_by_group.values()),
    "decode_steps": gs.batcher.decode_steps,
    "completed": gs.batcher.completed,
    "threads": sorted(names.values())}), flush=True)
server.stop(); server.join(5)
"""


def test_two_fiber_workers_serve_every_transport_at_once(oracle):
    """16 unary, 16 stream and 16 HTTP Generates of 32 tokens each, all at
    once, against a server whose process has two fiber workers in all
    (``set_concurrency(2)``, in a subprocess: the module registry is one
    per process). Handlers, stream delivery, HTTP order and every decode
    step share those two threads, so a wait that blocked a worker would
    starve decode and hang the calls. Tokens must equal the reference's
    ``TinyDecoder.generate``; the whole exchange has 120 s."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen([sys.executable, "-c", _TWO_WORKER_SERVER],
                            cwd=root, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, text=True)
    try:
        port = json.loads(proc.stdout.readline())["port"]
        prompts = [f"starve {i:02d}" for i in range(16)]
        want = {p: oracle.generate(list(p.encode()), 32) for p in prompts}
        got = {}

        def unary(p):
            ch = Channel(f"tcp://127.0.0.1:{port}",
                         ChannelOptions(timeout_ms=60000))
            try:
                c = ch.call_sync("GenerateService", "Generate", _body(p, 32))
                got[("unary", p)] = (None if c.failed()
                                     else json.loads(c.response)["tokens"])
            finally:
                ch.close()

        def stream(p):
            ch = Channel(f"tcp://127.0.0.1:{port}")
            try:
                c = _StreamClient(ch, p, 32, timeout_ms=60000)
                ok = not c.cntl.failed() and c.wait_done(60) and \
                    c.done == ("d", {"n": 32, "status": "completed"})
                got[("stream", p)] = c.tokens if ok else None
            finally:
                ch.close()

        def http_(p):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            try:
                conn.request("POST", "/GenerateService/Generate",
                             body=_body(p, 32))
                data = conn.getresponse().read()
                payload, _, footer = data.rpartition(b"\n#")
                got[("http", p)] = (list(payload)
                                    if footer == b"completed n=32" else None)
            finally:
                conn.close()

        threads = [threading.Thread(target=fn, args=(p,))
                   for fn in (unary, stream, http_) for p in prompts]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(max(0.1, 120 - (time.monotonic() - t0)))
        assert not any(t.is_alive() for t in threads), "calls hung"
        assert len(got) == 48
        wrong = [k for k, v in got.items() if v != want[k[1]]]
        assert not wrong, wrong
        out, _ = proc.communicate("report\n", timeout=30)
        stats = json.loads(out.strip().splitlines()[-1])
        assert stats["concurrency"] == 2 and stats["completed"] == 48
        assert set(stats["decode_threads"]) <= {"fiber_w0", "fiber_w1"}
        assert stats["steps_by_group"] == stats["decode_steps"] > 0
        assert "serving-decode" not in stats["threads"]
        assert not any(n.startswith("rpc-handler")
                       for n in stats["threads"])
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(10)
