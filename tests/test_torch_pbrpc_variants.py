"""hulu_pbrpc and sofa_pbrpc of the port (``protocol/pbrpc_variants.py``,
``ChannelOptions.protocol``) against brpc_tpu's, on the CPU.

- Framing: the same meta, payload and attachment framed by brpc_tpu's
  ``HuluPbrpcProtocol.frame`` / ``SofaPbrpcProtocol.frame`` and by the
  port's give equal bytes, over 200 seeded frames each; each side parses
  the other's frames to the same fields; a sofa frame whose
  ``attachment_size`` lies fails the connection on both.
- A unary echo and an attachment echo (4 B, 64 KiB, 4 MiB) over each
  variant, port to port and both ways across the wire: the port's
  Channel to brpc_tpu's Server, brpc_tpu's Channel to the port's Server.
- Generate, unary and streamed, over each variant, port to port and both
  ways across the wire, with tokens equal to the JAX TinyDecoder's under
  carried-across weights; one call with a request attachment answers the
  same.
- A hulu channel and a tpu_std channel to one endpoint hold two
  connections, each named on ``/connections``; a Channel refuses a
  protocol it cannot frame and names its client.
- The native lanes stand down for a variant: the turbo scan takes no
  hulu frame, and a ``native="echo"`` method's hulu calls are served by
  its handler, not by the C loops. On the ring lane (batch backend, in a
  child process) a variant's sync calls pay no fence after the first.

One collected test over the cases (``_run_cases`` of
test_torch_cluster.py).
"""

import json
import threading

import numpy as np

from brpc_tpu.butil.iobuf import IOBuf as RefIOBuf
from brpc_tpu.butil.iobuf import IOPortal as RefPortal
from brpc_tpu.protocol import pbrpc_variants as ref_variants
from brpc_tpu.protocol.proto import tpu_rpc_meta_pb2 as pb
from brpc_tpu.rpc import Channel as RefChannel
from brpc_tpu.rpc import ChannelOptions as RefChannelOptions
from brpc_tpu.rpc import Server as RefServer
from brpc_tpu.rpc import ServerOptions as RefServerOptions
from brpc_tpu.rpc import Service as RefService
from brpc_tpu.rpc.controller import Controller as RefController
from brpc_tpu.rpc.stream import StreamOptions as RefStreamOptions
from brpc_tpu.serving import TinyDecoder as RefDecoder
from brpc_tpu.serving import TinyDecoderConfig as RefConfig
from brpc_tpu.serving import add_generate_service as ref_add_generate

from brpc_tpu_torch.butil.iobuf import IOPortal
from brpc_tpu_torch.protocol import pbrpc_variants, tpu_std
from brpc_tpu_torch.protocol.registry import (PARSE_NOT_ENOUGH_DATA,
                                              PARSE_OK, find_protocol)
from brpc_tpu_torch.rpc import (Channel, ChannelOptions, Controller, Server,
                                ServerOptions, Service, StreamOptions)
from brpc_tpu_torch.rpc import server_dispatch
from brpc_tpu_torch.serving import add_generate_service
from brpc_tpu_torch.serving.convert import same_weights
from brpc_tpu_torch.serving.model import PARAM_NAMES

from test_torch_cluster import _b, _run_cases, _wait_for

SEED = 20261018
VARIANTS = ("hulu_pbrpc", "sofa_pbrpc")
ATT_SIZES = (4, 64 << 10, 4 << 20)
CACHE_LEN = 96
MAX_TOKENS = 8
PROMPTS = ["hello world", "a"]


# ---------------------------------------------------------------- framing

def _metas(rng, n):
    """``n`` (port meta, protobuf meta, payload, attachment) from a seed:
    requests and responses with every unary field the codec knows."""
    out = []
    for _ in range(n):
        cid = int(rng.integers(1, 1 << 40))
        port = tpu_std.RpcMeta(correlation_id=cid)
        ref = pb.RpcMeta()
        ref.correlation_id = cid
        if rng.random() < 0.6:
            req = tpu_std.RpcRequestMeta(
                service_name=f"Svc{int(rng.integers(100))}",
                method_name=f"M{int(rng.integers(100))}",
                log_id=int(rng.integers(0, 1 << 20)),
                timeout_ms=int(rng.integers(0, 60000)),
                auth_token="tok" if rng.random() < 0.3 else "",
                priority=int(rng.integers(0, 8)))
            port.request = req
            for f in ("service_name", "method_name", "log_id", "timeout_ms",
                      "auth_token", "priority"):
                setattr(ref.request, f, getattr(req, f))
        else:
            code = int(rng.integers(0, 3)) * 1001
            text = "no" if code else ""
            port.response = tpu_std.RpcResponseMeta(code, text)
            ref.response.error_code = code
            ref.response.error_text = text
        if rng.random() < 0.3:
            port.trace_id = ref.trace_id = int(rng.integers(1, 1 << 60))
            port.span_id = ref.span_id = int(rng.integers(1, 1 << 60))
        payload = rng.bytes(int(rng.integers(0, 300)))
        att = rng.bytes(int(rng.integers(0, 300))) if rng.random() < 0.5 \
            else b""
        out.append((port, ref, payload, att))
    return out


class _Sock:
    """What a parse touches of a socket."""

    def __init__(self):
        self.user_data = {}
        self.input_need = 0
        self.failed = None

    def set_failed(self, e=None):
        self.failed = e

    def take_device_payload_with_recv(self):
        return None, None


def _ref_frame(proto, meta, payload, att):
    buf = RefIOBuf()
    buf.append(att)
    return proto.frame(meta, payload, attachment=buf)[0].to_bytes()


def case_frame_bytes_equal():
    rng = np.random.default_rng(SEED)
    ref_hulu, ref_sofa = ref_variants.HuluPbrpcProtocol(), \
        ref_variants.SofaPbrpcProtocol()
    port_hulu, port_sofa = pbrpc_variants.HuluPbrpcProtocol(), \
        pbrpc_variants.SofaPbrpcProtocol()
    for ref_p, port_p in ((ref_hulu, port_hulu), (ref_sofa, port_sofa)):
        for port_meta, ref_meta, payload, att in _metas(rng, 200):
            want = _ref_frame(ref_p, ref_meta, payload, att)
            got = port_p.frame(port_meta, payload, att)[0]
            assert got == want, (port_p.name, got[:40], want[:40])
            assert got[:4] == port_p.MAGIC
            # the port parses brpc_tpu's frame, split anywhere
            cut = int(rng.integers(1, len(want)))
            portal, sock = IOPortal(), _Sock()
            portal.append(want[:cut])
            status, msg = port_p.parse(portal, sock)
            assert status == PARSE_NOT_ENOUGH_DATA, status
            portal.append(want[cut:])
            sock.input_need = 0
            status, msg = port_p.parse(portal, sock)
            assert status == PARSE_OK and not portal.size
            assert msg.meta.encode() == ref_meta.SerializeToString()
            assert (msg.payload, msg.attachment) == (payload, att)
            # and brpc_tpu parses the port's
            rportal = RefPortal()
            rportal.append(got)
            status, rmsg = ref_p.parse(rportal, _Sock())
            assert status == "ok"
            assert rmsg.meta == ref_meta
            assert (rmsg.payload.to_bytes(), rmsg.attachment.to_bytes()) \
                == (payload, att)
        # tpu_std's own frames are another protocol's to both
        port_meta, ref_meta, payload, att = _metas(rng, 1)[0]
        trpc = tpu_std.pack_frame(port_meta, payload, att)[0]
        portal = IOPortal()
        portal.append(trpc)
        assert port_p.parse(portal, _Sock())[0] == "try_others"
    # a lying attachment_size fails the connection on both
    meta = tpu_std.RpcMeta(correlation_id=7, attachment_size=999)
    mb = meta.encode()
    lie = pbrpc_variants._SOFA_HDR.pack(b"SOFA", len(mb), 4, 0) + mb + b"abcd"
    portal, sock = IOPortal(), _Sock()
    portal.append(lie)
    assert port_sofa.parse(portal, sock)[0] == PARSE_NOT_ENOUGH_DATA
    assert isinstance(sock.failed, ConnectionError)
    rportal, rsock = RefPortal(), _Sock()
    rportal.append(lie)
    assert ref_sofa.parse(rportal, rsock)[0] == "not_enough_data"
    assert isinstance(rsock.failed, ConnectionError)


# ------------------------------------------------------------------ echo

def _port_echo_server(native=False):
    svc = Service("Bench")

    def Echo(cntl, request):
        cntl.response_attachment.append(cntl.request_attachment.to_bytes())
        return bytes(request)
    svc.register_method("Echo", Echo, native="echo" if native else None)
    srv = Server(ServerOptions(enable_builtin_services=True))
    srv.add_service(svc)
    return srv, srv.start("tcp://127.0.0.1:0").port


def _ref_echo_server():
    svc = RefService("Bench")

    def Echo(cntl, request):
        cntl.response_attachment.append_buf(cntl.request_attachment)
        return _b(request)
    svc.register_method("Echo", Echo)
    srv = RefServer(RefServerOptions(enable_builtin_services=False))
    srv.add_service(svc)
    return srv, srv.start("tcp://127.0.0.1:0").port


def _port_echo_calls(port, protocol, rng):
    ch = Channel(f"tcp://127.0.0.1:{port}",
                 ChannelOptions(protocol=protocol, timeout_ms=30000,
                                share_connections=False))
    try:
        c = ch.call_sync("Bench", "Echo", b"plain")
        assert not c.failed(), c.error_text
        assert c.response == b"plain" and not c.response_attachment
        for n in ATT_SIZES:
            att = rng.bytes(n)
            c = Controller()
            c.request_attachment.append(att)
            c = ch.call_sync("Bench", "Echo", b"with", cntl=c)
            assert not c.failed(), (protocol, n, c.error_text)
            assert c.response == b"with"
            assert c.response_attachment.to_bytes() == att, (protocol, n)
    finally:
        ch.close()


def _ref_echo_calls(port, protocol, rng):
    ch = RefChannel(f"tcp://127.0.0.1:{port}",
                    RefChannelOptions(protocol=protocol, timeout_ms=30000))
    try:
        c = ch.call_sync("Bench", "Echo", b"plain")
        assert not c.failed(), c.error_text
        assert c.response_payload.to_bytes() == b"plain"
        for n in ATT_SIZES:
            att = rng.bytes(n)
            c = RefController()
            c.request_attachment.append(att)
            c = ch.call_sync("Bench", "Echo", b"with", cntl=c)
            assert not c.failed(), (protocol, n, c.error_text)
            assert c.response_payload.to_bytes() == b"with"
            assert c.response_attachment.to_bytes() == att, (protocol, n)
    finally:
        ch.close()


def case_echo(protocol, wiring):
    rng = np.random.default_rng(SEED + len(wiring))
    if wiring == "port->ref":
        srv, port = _ref_echo_server()
        call = _port_echo_calls
    else:
        srv, port = _port_echo_server()
        call = _ref_echo_calls if wiring == "ref->port" else _port_echo_calls
    try:
        call(port, protocol, rng)
    finally:
        srv.stop()
        srv.join(5)


# -------------------------------------------------------------- Generate

def _body(prompt):
    return json.dumps({"prompt": prompt, "max_tokens": MAX_TOKENS}).encode()


class _Tokens:
    """A streamed Generate's token frames and its verdict."""

    def __init__(self, ref=False):
        self.tokens, self.done = [], threading.Event()
        self.verdict = None
        self.ref = ref

    def on_received(self, stream, msg):
        p = msg.payload.to_bytes() if self.ref else bytes(msg.payload)
        if p[:1] == b"t":
            self.tokens.append(p[1])
        else:
            self.verdict = p
            self.done.set()


def _port_generate(port, protocol, oracle):
    ch = Channel(f"tcp://127.0.0.1:{port}",
                 ChannelOptions(protocol=protocol, timeout_ms=60000,
                                share_connections=False))
    try:
        for p in PROMPTS:
            c = ch.call_sync("GenerateService", "Generate", _body(p))
            assert not c.failed(), (protocol, c.error_text)
            assert json.loads(c.response)["tokens"] == oracle[p], p
            t = _Tokens()
            c = ch.call_sync("GenerateService", "Generate", _body(p),
                             stream_options=StreamOptions(
                                 on_received=t.on_received))
            assert not c.failed(), (protocol, c.error_text)
            try:
                assert t.done.wait(60) and t.tokens == oracle[p], p
            finally:
                c.stream.close()
        # a request attachment changes nothing of the answer
        c = Controller()
        c.request_attachment.append(b"\x00" * 4096)
        c = ch.call_sync("GenerateService", "Generate", _body(PROMPTS[0]),
                         cntl=c)
        assert not c.failed() and \
            json.loads(c.response)["tokens"] == oracle[PROMPTS[0]]
    finally:
        ch.close()


def _ref_generate(port, protocol, oracle):
    ch = RefChannel(f"tcp://127.0.0.1:{port}",
                    RefChannelOptions(protocol=protocol, timeout_ms=60000))
    try:
        for p in PROMPTS:
            c = ch.call_sync("GenerateService", "Generate", _body(p))
            assert not c.failed(), (protocol, c.error_text)
            doc = json.loads(c.response_payload.to_bytes())
            assert doc["tokens"] == oracle[p], p
            t = _Tokens(ref=True)
            c = ch.call_sync("GenerateService", "Generate", _body(p),
                             stream_options=RefStreamOptions(
                                 on_received=t.on_received))
            assert not c.failed(), (protocol, c.error_text)
            assert t.done.wait(60) and t.tokens == oracle[p], p
            c.stream.close()
    finally:
        ch.close()


def case_generate(protocol):
    oracle_model = RefDecoder(RefConfig(cache_len=CACHE_LEN))
    oracle = {p: oracle_model.generate(list(p.encode()), MAX_TOKENS)
              for p in PROMPTS}
    srv = Server(ServerOptions(enable_builtin_services=False))
    gs = add_generate_service(srv, device="cpu", cache_len=CACHE_LEN)
    port = srv.start("tcp://127.0.0.1:0").port
    ref = RefServer(RefServerOptions(enable_builtin_services=False))
    ref_add_generate(ref, cache_len=CACHE_LEN, warmup=True)
    rport = ref.start("tcp://127.0.0.1:0").port
    try:
        assert same_weights(gs.batcher.model, {
            n: getattr(oracle_model, n) for n in PARAM_NAMES})
        _port_generate(port, protocol, oracle)
        _ref_generate(port, protocol, oracle)
        _port_generate(rport, protocol, oracle)
    finally:
        srv.stop()
        srv.join(10)
        ref.stop()
        ref.join(10)


# ------------------------------------------------------- connections, lanes

def case_two_connections_and_refusals():
    srv, port = _port_echo_server()
    addr = f"tcp://127.0.0.1:{port}"
    hulu = Channel(addr, ChannelOptions(protocol="hulu_pbrpc"))
    plain = Channel(addr, ChannelOptions())
    try:
        assert not hulu.call_sync("Bench", "Echo", b"h").failed()
        assert not plain.call_sync("Bench", "Echo", b"t").failed()
        assert hulu._socket is not plain._socket
        assert _wait_for(lambda: len(srv.connections()) == 2)
        import http.client
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        conn.request("GET", "/connections")
        rows = json.loads(conn.getresponse().read())["connections"]
        conn.close()
        assert sorted(r["protocol"] for r in rows) == \
            ["http", "hulu_pbrpc", "tpu_std"], rows
    finally:
        hulu.close()
        plain.close()
        srv.stop()
        srv.join(5)
    for proto, client in (("thrift", "ThriftClient"), ("redis", "RedisClient"),
                          ("memcache", "MemcacheClient"),
                          ("h2", "GrpcChannel"), ("http", "HttpClient")):
        try:
            Channel(addr, ChannelOptions(protocol=proto))
        except ValueError as e:
            assert client in str(e), e
        else:
            raise AssertionError(f"a {proto} Channel was made")
    assert find_protocol("hulu_pbrpc").MAGIC == b"HULU"


def case_native_lanes_stand_down():
    hulu = find_protocol("hulu_pbrpc")

    class _S:
        user_data = {"server": None}
    portal = IOPortal()
    frame = hulu.frame(tpu_std.RpcMeta(
        request=tpu_std.RpcRequestMeta("Bench", "Echo"),
        correlation_id=3), b"x")[0]
    portal.append(frame)
    assert hulu.turbo_scan(portal, _S()) is None
    assert not hulu.native_serve(portal, _S())
    assert portal.size == len(frame)
    # a native="echo" method: hulu calls reach its handler
    srv, port = _port_echo_server(native=True)
    before = (server_dispatch.nserve_drain.get_value(),
              server_dispatch.nserve_scan.get_value(),
              tpu_std.nscan_records.get_value())
    try:
        _port_echo_calls(port, "hulu_pbrpc", np.random.default_rng(SEED))
        assert (server_dispatch.nserve_drain.get_value(),
                server_dispatch.nserve_scan.get_value(),
                tpu_std.nscan_records.get_value()) == before
        assert srv.method_status["Bench.Echo"].count() == 1 + len(ATT_SIZES)
    finally:
        srv.stop()
        srv.join(5)


_RING_CHILD = """
import sys
from brpc_tpu_torch.transport import event_dispatcher as ed, ring_lane
ed._global = ring_lane.RingDispatcher(backend=1)
from brpc_tpu_torch.rpc import Channel, ChannelOptions, Server, Service
svc = Service("Bench")
svc.register_method("Echo", lambda cntl, req: bytes(req))
srv = Server()
srv.add_service(svc)
ep = srv.start("tcp://127.0.0.1:0")
for p in ("hulu_pbrpc", "sofa_pbrpc"):
    ch = Channel(str(ep), ChannelOptions(protocol=p, timeout_ms=10000,
                                         share_connections=False))
    before = ring_lane.counters()["ring_read_barriers"]
    for i in range(20):
        c = ch.call_sync("Bench", "Echo", b"r%d" % i)
        assert not c.failed() and c.response == b"r%d" % i, c.error_text
    fences = ring_lane.counters()["ring_read_barriers"] - before
    ch.close()
    assert fences <= 1, (p, fences)
assert type(ed.global_dispatcher()).__name__ == "RingDispatcher"
srv.stop()
srv.join(5)
print("ok")
"""


def case_variants_on_the_ring():
    """On the ring lane's batch backend a variant's sync calls wait for
    the dispatcher instead of plucking: 20 calls pay at most the
    connection's first fence (in a child process: the lane is chosen
    when a process builds its dispatcher)."""
    import os
    import subprocess
    import sys
    from test_torch_cluster import ROOT
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", _RING_CHILD], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=90)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", \
        proc.stdout + proc.stderr[-3000:]


CASES = ([("frame bytes equal brpc_tpu's", case_frame_bytes_equal, ())]
         + [(f"echo {p} {w}", case_echo, (p, w)) for p in VARIANTS
            for w in ("port->port", "port->ref", "ref->port")]
         + [(f"Generate over {p}", case_generate, (p,)) for p in VARIANTS]
         + [("two connections, refusals", case_two_connections_and_refusals,
             ()),
            ("native lanes stand down", case_native_lanes_stand_down, ()),
            ("variants on the ring lane", case_variants_on_the_ring, ())])


def test_pbrpc_variants():
    _run_cases(CASES, limit_s=120.0)
