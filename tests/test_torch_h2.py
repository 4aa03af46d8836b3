"""HPACK, HTTP/2 and gRPC of the port (``protocol/hpack.py``,
``protocol/h2.py``) against brpc_tpu's, on the CPU.

- HPACK: the RFC 7541 examples (C.3 and C.4 requests encoded and decoded
  byte for byte, C.6 responses with a 256-byte table and its evictions),
  the port's coder against brpc_tpu's both ways over 200 seeded header
  lists on one connection's tables (sizes changed on the way), and
  random and bit-flipped blocks that both decoders read alike or both
  refuse.
- gRPC port to port, port client to brpc_tpu server and brpc_tpu client
  to port server: echo, NOT_FOUND, a 1 MiB payload through the windows,
  a deadline the server sees, and a timeout that answers
  DEADLINE_EXCEEDED; many calls at once from fibers on one connection;
  a dead connection failing its calls with UNAVAILABLE; grpcio both ways
  where it imports.
- Generate over the port's gRPC (and plain h2) answers the tokens of
  brpc_tpu's tpu_std unary Generate from the same weights, where
  brpc_tpu's own gRPC Generate answers an empty body (ROADMAP section
  3). A server with an Authenticator answers a gRPC call without the
  credential with UNAUTHENTICATED and runs no handler; ``/health``
  stays open over h2.
- The registry: ``h2`` after ``http``, the preface disclaimed by HTTP
  and by tpu_std's turbo scan, the connection's protocol sticky and
  named on ``/connections``, the gRPC calls counted under their method
  on ``/status``; gRPC over ``ssl://``.

One collected test over the cases (``_run_cases`` of
test_torch_cluster.py), whose leak check covers h2 sessions, gRPC
channels and HTTP client connections left open.
"""

import json
import os
import random
import socket as pysocket
import struct
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

import brpc_tpu.fiber as ref_fiber
from brpc_tpu.protocol import h2 as ref_h2
from brpc_tpu.protocol import hpack as ref_hpack
from brpc_tpu.rpc import Channel as RefChannel
from brpc_tpu.rpc import ChannelOptions as RefChannelOptions
from brpc_tpu.rpc import Server as RefServer
from brpc_tpu.rpc import ServerOptions as RefServerOptions
from brpc_tpu.serving import add_generate_service as ref_add_generate

import brpc_tpu_torch.fiber as port_fiber
from brpc_tpu_torch.fiber import CountdownEvent, global_control
from brpc_tpu_torch.protocol import h2, hpack, http, tpu_std
from brpc_tpu_torch.protocol.registry import get_protocols
from brpc_tpu_torch.butil.iobuf import IOPortal
from brpc_tpu_torch.rpc import (Server, ServerOptions, Service,
                                TokenAuthenticator)
from brpc_tpu_torch.serving import add_generate_service
from brpc_tpu_torch.serving.convert import same_weights
from brpc_tpu_torch.serving.model import PARAM_NAMES

from test_torch_cluster import _run_cases, _wait_for

ROOT = Path(__file__).resolve().parent.parent
SEED = 20260803
CACHE_LEN = 96
MAX_TOKENS = 12
PROMPTS = ["hello world", "a", "the second prompt"]


# ------------------------------------------------------------------ HPACK

C3 = [  # RFC 7541 C.3: three requests on one connection, no Huffman
    ([(":method", "GET"), (":scheme", "http"), (":path", "/"),
      (":authority", "www.example.com")],
     "828684410f7777772e6578616d706c652e636f6d"),
    ([(":method", "GET"), (":scheme", "http"), (":path", "/"),
      (":authority", "www.example.com"), ("cache-control", "no-cache")],
     "828684be58086e6f2d6361636865"),
    ([(":method", "GET"), (":scheme", "https"), (":path", "/index.html"),
      (":authority", "www.example.com"), ("custom-key", "custom-value")],
     "828785bf400a637573746f6d2d6b65790c637573746f6d2d76616c7565"),
]
C4 = [  # C.4: the same requests with Huffman
    "828684418cf1e3c2e5f23a6ba0ab90f4ff",
    "828684be5886a8eb10649cbf",
    "828785bf408825a849e95ba97d7f8925a849e95bb8e8b4bf",
]
_C6_DATE1 = "Mon, 21 Oct 2013 20:13:21 GMT"
C6 = [  # C.6: responses, Huffman, a 256-byte table that evicts
    ([(":status", "302"), ("cache-control", "private"),
      ("date", _C6_DATE1), ("location", "https://www.example.com")],
     "488264025885aec3771a4b6196d07abe941054d444a8200595040b8166e082a6"
     "2d1bff6e919d29ad171863c78f0b97c8e9ae82ae43d3"),
    ([(":status", "307"), ("cache-control", "private"),
      ("date", _C6_DATE1), ("location", "https://www.example.com")],
     "4883640effc1c0bf"),
    ([(":status", "200"), ("cache-control", "private"),
      ("date", "Mon, 21 Oct 2013 20:13:22 GMT"),
      ("location", "https://www.example.com"),
      ("content-encoding", "gzip"),
      ("set-cookie",
       "foo=ASDJKHQKBZXOQWEOPIUAXQWEOIU; max-age=3600; version=1")],
     "88c16196d07abe941054d444a8200595040b8166e084a62d1bffc05a839bd9ab"
     "77ad94e7821dd7f2e6c7b335dfdfcd5b3960d5af27087f3672c1ab270fb5291f"
     "9587316065c003ed4ee5b1063d5007"),
]


def case_hpack_rfc_vectors():
    for raw, hexenc in ((b"www.example.com", "f1e3c2e5f23a6ba0ab90f4ff"),
                        (b"no-cache", "a8eb10649cbf"),
                        (b"custom-key", "25a849e95ba97d7f"),
                        (b"custom-value", "25a849e95bb8e8b4bf")):
        assert hpack.huffman_encode(raw).hex() == hexenc
        assert hpack.huffman_decode(bytes.fromhex(hexenc)) == raw
    for huffman, blocks in ((False, [b for _, b in C3]), (True, C4)):
        enc, dec = hpack.HpackEncoder(huffman=huffman), hpack.HpackDecoder()
        for (headers, _), want in zip(C3, blocks):
            assert enc.encode(headers).hex() == want
            assert dec.decode(bytes.fromhex(want)) == headers
    # (the RFC codes "307" in Huffman at no gain; both coders keep a
    # string raw unless Huffman is shorter, so C.6 is checked decoding,
    # and the encoder's tables against the decoder's)
    enc = hpack.HpackEncoder(max_table_size=256)
    dec = hpack.HpackDecoder(max_table_size=256)
    rdec = ref_hpack.HpackDecoder(max_table_size=256)
    for headers, want in C6:
        assert dec.decode(bytes.fromhex(want)) == headers
        assert rdec.decode(enc.encode(headers)) == headers
        assert list(enc._table.entries) == list(dec._table.entries) == \
            list(rdec._table.entries)
    # C.6's end state: three entries, 215 bytes (RFC 7541 C.6.3)
    assert dec._table.size == enc._table.size == 215
    assert len(dec._table.entries) == 3
    # zero padding bits are not an EOS prefix; a table bigger than the
    # SETTINGS cap is refused
    code, length = hpack.HUFFMAN_TABLE[ord("0")]
    for mod in (hpack, ref_hpack):
        try:
            mod.huffman_decode(bytes([(code << (8 - length)) & 0xFF]))
            raise AssertionError("zero padding decoded")
        except mod.HpackError as e:
            assert "padding" in str(e)
    for mod in (hpack, ref_hpack):
        try:
            mod.HpackDecoder().decode(bytes([0x3F, 0xFF, 0xFF, 0xFF, 0xFF,
                                             0x7F]))
            raise AssertionError("a huge table size update was taken")
        except mod.HpackError:
            pass
    # sensitive headers are never indexed (section 6.2.3)
    enc = hpack.HpackEncoder()
    out = enc.encode([("authorization", "secret")],
                     sensitive={"authorization"})
    assert out[0] & 0xF0 == 0x10 and not enc._table.entries


_NAMES = [n for n, _ in hpack.STATIC_TABLE[:20]] + [
    "x-trace", "x-request-id", "grpc-timeout", "te", "content-type",
    "authorization", "x-" + "long" * 20]


def _header_lists(n: int, seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        hs = []
        for _ in range(int(rng.integers(1, 12))):
            name = _NAMES[int(rng.integers(len(_NAMES)))]
            kind = int(rng.integers(4))
            if kind == 0:               # a static pair when there is one
                value = hpack.STATIC_TABLE[int(rng.integers(61))][1]
            elif kind == 1:             # bytes 0..255 as latin1
                value = bytes(rng.integers(0, 256, int(rng.integers(0, 40)),
                                           dtype=np.uint8)).decode("latin1")
            else:                       # a few repeating values
                value = f"v{int(rng.integers(6))}" * int(rng.integers(1, 30))
            hs.append((name, value))
        out.append(hs)
    return out


def case_hpack_parity_both_ways():
    """One connection's worth of header lists through the port's encoder
    into brpc_tpu's decoder and back: the same bytes, the same headers,
    the same tables (an eviction out of step would change an index)."""
    rng = random.Random(SEED)
    pe, re_ = hpack.HpackEncoder(), ref_hpack.HpackEncoder()
    pd, rd = hpack.HpackDecoder(), ref_hpack.HpackDecoder()
    for i, hs in enumerate(_header_lists(200, SEED)):
        if i % 50 == 49:                # the peer's SETTINGS changes
            size = rng.choice([0, 256, 1024, 4096])
            for enc in (pe, re_):
                enc.set_max_table_size(size)
            for dec in (pd, rd):
                dec.set_max_table_size(4096)
        sensitive = {"authorization"} if i % 7 == 0 else ()
        mine = pe.encode(hs, sensitive=sensitive)
        ref = re_.encode(hs, sensitive=sensitive)
        assert mine == ref, (i, hs)
        assert rd.decode(mine) == hs, i
        assert pd.decode(ref) == hs, i
        assert list(pd._table.entries) == list(rd._table.entries)
        assert pd._table.size == rd._table.size == pe._table.size


def _decode_or_error(mod, block):
    try:
        return ("ok", mod.HpackDecoder().decode(block))
    except mod.HpackError:
        return ("error", None)


def case_hpack_fuzz_parity():
    rng = random.Random(0x4850)
    for _ in range(500):
        block = bytes(rng.randrange(256) for _ in range(rng.randrange(120)))
        assert _decode_or_error(hpack, block) == \
            _decode_or_error(ref_hpack, block), block.hex()
    base = hpack.HpackEncoder().encode([
        (":method", "POST"), (":path", "/svc/M"),
        ("content-type", "application/grpc"),
        ("x-custom-header", "value-with-data")])
    for _ in range(400):
        block = bytearray(base)
        for _ in range(rng.randrange(1, 4)):
            block[rng.randrange(len(block))] ^= 1 << rng.randrange(8)
        assert _decode_or_error(hpack, bytes(block)) == \
            _decode_or_error(ref_hpack, bytes(block)), block.hex()


def case_grpc_helpers():
    assert h2.parse_grpc_timeout("5S") == 5.0
    assert abs(h2.parse_grpc_timeout("100m") - 0.1) < 1e-12
    assert h2.parse_grpc_timeout("") is None
    assert h2.parse_grpc_timeout("12") is None
    for s in (0.25, 1e-6, 250.0):
        assert h2.format_grpc_timeout(s) == ref_h2.format_grpc_timeout(s)
    import gzip
    body = h2.pack_grpc_message(b"abc") + h2.pack_grpc_message(b"") + \
        h2.pack_grpc_message(gzip.compress(b"zipped"), compressed=True)
    assert h2.unpack_grpc_messages(body) == \
        ref_h2.unpack_grpc_messages(body) == [b"abc", b"", b"zipped"]
    for bad in (b"\x00\x00\x00\x00\x05ab", b"\x00\x00\x00\x00\x00x"):
        for mod in (h2, ref_h2):
            try:
                mod.unpack_grpc_messages(bad)
                raise AssertionError("a bad body unpacked")
            except ValueError:
                pass
    for msg in ("plain", "100% sure\n", "unicode é"):
        assert h2.percent_encode(msg) == ref_h2.percent_encode(msg)
        assert h2.percent_decode(h2.percent_encode(msg)) == msg
    from brpc_tpu_torch.rpc import errno_codes as berr
    from brpc_tpu.rpc import errno_codes as ref_berr
    for code in (0, berr.ENOMETHOD, berr.ENOSERVICE, berr.EREQUEST,
                 berr.ERPCTIMEDOUT, berr.ELIMIT, berr.ECANCELED,
                 berr.EINTERNAL, berr.ERPCAUTH):
        assert h2.errno_to_grpc_status(code) == \
            ref_h2.errno_to_grpc_status(code), code
    assert h2.errno_to_grpc_status(berr.ERPCTIMEDOUT) == \
        h2.GRPC_DEADLINE_EXCEEDED
    assert ref_berr.ERPCTIMEDOUT == berr.ERPCTIMEDOUT


# ------------------------------------------------------------ gRPC, wires

class _Side:
    """A server of one package with ``EchoService.RawEcho``, ``Slow``
    (sleeps ``?`` seconds, then echoes) and ``Deadline`` (the deadline
    the handler sees, in ms), and that package's gRPC channel."""

    def __init__(self, kind, scheme="tcp", extras=""):
        self.kind = kind
        rpc = __import__("brpc_tpu_torch.rpc" if kind == "port"
                         else "brpc_tpu.rpc", fromlist=["Server"])
        self.server = rpc.Server() if kind == "port" else rpc.Server(
            rpc.ServerOptions(enable_builtin_services=False))
        svc = rpc.Service("EchoService")
        fiber = port_fiber if kind == "port" else ref_fiber

        def RawEcho(cntl, request):
            return bytes(request)

        async def Slow(cntl, request):
            await fiber.sleep(float(bytes(request)))
            return bytes(request)

        def Deadline(cntl, request):
            if kind == "port":
                return b"%d" % int(cntl.remaining_ms() or -1)
            return b"%d" % int(cntl.timeout_ms or -1)
        for fn in (RawEcho, Slow, Deadline):
            svc.method()(fn)
        self.server.add_service(svc)
        self.ep = self.server.start(f"{scheme}://127.0.0.1:0{extras}")
        self.addr = f"{scheme}://127.0.0.1:{self.ep.port}"

    def close(self):
        self.server.stop()
        self.server.join(5)


def _channel(kind, addr):
    if kind == "port":
        return h2.GrpcChannel(addr)
    return ref_h2.GrpcChannel(addr.replace("tcp://", ""))


def _wire_cases(client, server_kind):
    srv = _Side(server_kind)
    ch = _channel(client, srv.addr)
    try:
        c = ch.call("/EchoService/RawEcho", b"hi")
        assert c.ok() and c.response == b"hi", (c.status, c.message)
        # package-qualified, and the HPACK tables of a second call
        c = ch.call("/brpc.test.EchoService/RawEcho", b"again")
        assert c.ok() and c.response == b"again", (c.status, c.message)
        c = ch.call("/nope.Nothing/Missing", b"")
        assert c.status == h2.GRPC_NOT_FOUND, (c.status, c.message)
        # a 1 MiB message (its 5-byte prefix included): a stream window
        # of data each way. brpc_tpu's server sends its trailers ahead of
        # DATA a window holds back (ROADMAP section 3), so more than the
        # window goes to the port's servers only: 4 MiB, its trailers
        # queued behind the body
        big = (bytes(range(256)) * 4096)[:-5]
        c = ch.call("/EchoService/RawEcho", big, timeout=30)
        assert c.ok() and c.response == big, (c.status, c.message)
        if server_kind == "port":
            huge = bytes(range(256)) * (4 * 4096)
            c = ch.call("/EchoService/RawEcho", huge, timeout=30)
            assert c.ok() and c.response == huge, (c.status, c.message)
        c = ch.call("/EchoService/Deadline", b"", timeout=2.0)
        assert c.ok() and 0 < int(c.response) <= 2000, c.response
        t0 = time.monotonic()
        c = ch.call("/EchoService/Slow", b"1.5", timeout=0.2)
        assert c.status == h2.GRPC_DEADLINE_EXCEEDED, (c.status, c.message)
        assert time.monotonic() - t0 < 1.4
    finally:
        ch.close()
        srv.close()


def case_grpc_port_to_port():
    _wire_cases("port", "port")
    srv = _Side("port")
    try:
        # the port's server answers at the deadline itself, long before
        # the client's one-second grace
        with h2.GrpcChannel(srv.addr) as ch:
            t0 = time.monotonic()
            c = ch.call("/EchoService/Slow", b"1.5", timeout=0.2)
            assert c.status == h2.GRPC_DEADLINE_EXCEEDED
            assert c.message == "deadline exceeded"
            assert time.monotonic() - t0 < 0.9
    finally:
        srv.close()


def case_grpc_port_client_to_reference_server():
    _wire_cases("port", "ref")


def case_grpc_reference_client_to_port_server():
    _wire_cases("ref", "port")


def case_grpc_many_calls_on_one_connection():
    """More calls at once than workers, from fibers, with payloads that
    take many frames: two writers on one socket never cut into each
    other's frames."""
    srv = _Side("port")
    ch = h2.GrpcChannel(srv.addr)
    n = global_control().concurrency + 16
    done = CountdownEvent(n)
    bad = []

    async def one(i):
        body = bytes([i % 256]) * (40000 + i)
        try:
            c = await ch.call_async("/EchoService/RawEcho", body, timeout=20)
            if not c.ok() or c.response != body:
                bad.append((i, c.status, c.message))
        finally:
            done.signal()
    try:
        for i in range(n):
            global_control().spawn(one, i, name="h2_case")
        assert done.wait_pthread(30), "calls never completed"
        assert not bad, bad[:3]
        session = ch._session
        assert session.window_updates_received > 0
        assert session.window_updates_sent > 0
    finally:
        ch.close()
        srv.close()


def case_dead_connection_fails_calls():
    srv = _Side("port")
    ch = h2.GrpcChannel(srv.addr)
    try:
        assert ch.call("/EchoService/RawEcho", b"x").ok()
        box = []
        t = threading.Thread(target=lambda: box.append(ch.call(
            "/EchoService/Slow", b"3", timeout=20)))
        t.start()
        assert _wait_for(lambda: srv.server.concurrency == 1)
        t0 = time.monotonic()
        for s in srv.server.connections():
            s.set_failed(ConnectionError("killed by the case"))
        t.join(10)
        assert box and box[0].status == h2.GRPC_UNAVAILABLE, \
            box and (box[0].status, box[0].message)
        assert time.monotonic() - t0 < 2.0
        # the next call dials anew
        c = ch.call("/EchoService/RawEcho", b"y")
        assert c.ok() and c.response == b"y"
    finally:
        ch.close()
        srv.close()
    # a refused dial is UNAVAILABLE, not an exception
    with h2.GrpcChannel(srv.addr) as ch:
        c = ch.call("/EchoService/RawEcho", b"z")
        assert c.status == h2.GRPC_UNAVAILABLE, (c.status, c.message)


def case_big_frame_fails_the_connection():
    srv = _Side("port")
    s = pysocket.create_connection(("127.0.0.1", srv.ep.port))
    try:
        s.sendall(h2.PREFACE + h2.pack_frame(h2.SETTINGS, 0, 0)
                  + bytes((0x00, 0x80, 0x00, h2.DATA, 0)) +
                  struct.pack(">I", 1))
        s.settimeout(5)                 # no close in 5 s raises here
        got = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            got += chunk
        assert got[3] == h2.SETTINGS, got[:9]     # its SETTINGS, then EOF
    finally:
        s.close()
        srv.close()


# --------------------------------------------------------------- Generate

def _generate_body(prompt: str) -> bytes:
    return json.dumps({"prompt": prompt, "max_tokens": MAX_TOKENS}).encode()


def case_generate_over_grpc_equals_reference():
    ref = RefServer(RefServerOptions(enable_builtin_services=False))
    rgs = ref_add_generate(ref, cache_len=CACHE_LEN, warmup=True)
    rep = ref.start("tcp://127.0.0.1:0")
    srv = Server()
    gs = add_generate_service(srv, device="cpu", cache_len=CACHE_LEN)
    ep = srv.start("tcp://127.0.0.1:0")
    rch = RefChannel(f"tcp://127.0.0.1:{rep.port}",
                     RefChannelOptions(timeout_ms=60000))
    ch = h2.GrpcChannel(f"tcp://127.0.0.1:{ep.port}")
    hc = h2.Http2Client(f"tcp://127.0.0.1:{ep.port}")
    rg = ref_h2.GrpcChannel(f"127.0.0.1:{rep.port}")
    try:
        assert same_weights(gs.batcher.model, {
            n: getattr(rgs.batcher.model, n) for n in PARAM_NAMES})
        for p in PROMPTS:
            c = rch.call_sync("GenerateService", "Generate",
                              _generate_body(p))
            assert not c.failed(), c.error_text
            want = json.loads(c.response_payload.to_bytes())["tokens"]
            g = ch.call("/GenerateService/Generate", _generate_body(p),
                        timeout=60)
            assert g.ok(), (g.status, g.message)
            doc = json.loads(g.response)
            assert doc["status"] == "completed" and doc["tokens"] == want
            assert doc["n"] == MAX_TOKENS
            r = hc.request("POST", "/GenerateService/Generate",
                           body=_generate_body(p))
            assert r.status == 200 and json.loads(r.body)["tokens"] == want
        # brpc_tpu's gRPC Generate: OK, and the tokens lost (its fault)
        g = rg.call("/GenerateService/Generate", _generate_body(PROMPTS[0]),
                    timeout=60)
        assert g.ok() and g.response == b"", (g.status, g.response)
        # a bad request is INVALID_ARGUMENT, never an empty OK
        g = ch.call("/GenerateService/Generate", b"{bad", timeout=60)
        assert g.status == h2.GRPC_INVALID_ARGUMENT, (g.status, g.message)
        # a deadline shorter than the generation: DEADLINE_EXCEEDED
        g = ch.call("/GenerateService/Generate", json.dumps(
            {"prompt": "x", "max_tokens": 60}).encode(), timeout=0.001)
        assert g.status == h2.GRPC_DEADLINE_EXCEEDED, (g.status, g.message)
    finally:
        for x in (rch, ch, hc, rg):
            x.close()
        srv.stop()
        srv.join(5)
        ref.stop()
        ref.join(5)


def case_grpc_in_flight_at_stop():
    """A gRPC Generate in flight when the server stops gets an answer
    (the engine retires it), never a hang."""
    srv = Server()
    add_generate_service(srv, device="cpu", cache_len=160)
    ep = srv.start("tcp://127.0.0.1:0")
    ch = h2.GrpcChannel(f"tcp://127.0.0.1:{ep.port}")
    box = []
    t = threading.Thread(target=lambda: box.append(ch.call(
        "/GenerateService/Generate",
        json.dumps({"prompt": "p", "max_tokens": 150}).encode(),
        timeout=30)))
    try:
        t.start()
        assert _wait_for(lambda: srv.concurrency == 1)
        srv.stop()
        srv.join(5)
        t.join(10)
        assert box and box[0].status in (h2.GRPC_INTERNAL,
                                         h2.GRPC_UNAVAILABLE), \
            box and (box[0].status, box[0].message)
    finally:
        ch.close()
        srv.stop()
        srv.join(5)


def case_grpc_auth_gate():
    seen = []
    srv = Server(ServerOptions(auth=TokenAuthenticator("s3cret")))
    svc = Service("EchoService")

    def RawEcho(cntl, request):
        seen.append(cntl.auth_context)
        return bytes(request)
    svc.register_method("RawEcho", RawEcho)
    srv.add_service(svc)
    ep = srv.start("tcp://127.0.0.1:0")
    addr = f"tcp://127.0.0.1:{ep.port}"
    try:
        with h2.GrpcChannel(addr) as ch:
            c = ch.call("/EchoService/RawEcho", b"x")
            assert c.status == h2.GRPC_UNAUTHENTICATED, (c.status, c.message)
            # refused before the lookup: no method is revealed either
            c = ch.call("/Nope/Missing", b"x")
            assert c.status == h2.GRPC_UNAUTHENTICATED
            c = ch.call("/EchoService/RawEcho", b"x",
                        metadata=[("authorization", "Bearer wrong")])
            assert c.status == h2.GRPC_UNAUTHENTICATED
        assert seen == [] and "EchoService.RawEcho" not in srv.method_status
        with h2.GrpcChannel(addr) as ch:
            c = ch.call("/EchoService/RawEcho", b"x",
                        metadata=[("authorization", "Bearer s3cret")])
            assert c.ok() and c.response == b"x", (c.status, c.message)
            # once a connection: the next call carries nothing
            assert ch.call("/EchoService/RawEcho", b"y").ok()
        assert len(seen) == 2 and seen[0] is not None
        with h2.Http2Client(addr) as hc:
            assert hc.request("GET", "/health").status == 200
            assert hc.request("GET", "/status").status == 403
            assert hc.request("POST", "/EchoService/RawEcho",
                              body=b"q").status == 403
        assert len(seen) == 2
    finally:
        srv.stop()
        srv.join(5)


# ---------------------------------------------------- registry and pages

def case_registry_and_pages():
    names = [p.name for p in get_protocols()]
    assert names.index("h2") == names.index("http") + 1, names
    for n in range(1, len(h2.PREFACE) + 1):
        assert not http.is_request_start(h2.PREFACE[:n]) or n == 1
    # tpu_std's turbo lane, tried on a connection's first bytes, leaves
    # h2's to the classic loop

    class _Sock:
        user_data = {"server": None}
    portal = IOPortal()
    portal.append(h2.PREFACE + h2.pack_frame(h2.SETTINGS, 0, 0, b"\0" * 12))
    size = portal.size
    proto = tpu_std.TpuStdProtocol()
    assert not proto.turbo_scan(portal, _Sock())
    assert not proto.native_serve(portal, _Sock())
    assert portal.size == size
    srv = _Side("port")
    try:
        with h2.GrpcChannel(srv.addr) as ch, \
                h2.Http2Client(srv.addr) as hc:
            for _ in range(3):
                assert ch.call("/EchoService/RawEcho", b"x").ok()
            conns = json.loads(hc.request("GET", "/connections").body)
            protos = sorted(r["protocol"] for r in conns["connections"])
            assert protos == ["h2", "h2"], conns["connections"]
            idx = names.index("h2")
            assert all(s.preferred_protocol == idx
                       for s in srv.server.connections())
            status = json.loads(hc.request("GET", "/status").body)
            row = status["method_status"]["EchoService.RawEcho"]
            assert row["count"] == 3, row
    finally:
        srv.close()


def case_grpc_over_ssl():
    with tempfile.TemporaryDirectory() as d:
        cert, key = os.path.join(d, "cert.pem"), os.path.join(d, "key.pem")
        subprocess.run(
            ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
             "-keyout", key, "-out", cert, "-days", "2", "-subj",
             "/CN=localhost"], check=True, capture_output=True)
        srv = _Side("port", "ssl", f"#cert={cert}&key={key}")
        try:
            with h2.GrpcChannel(srv.addr) as ch:
                for i in range(3):
                    c = ch.call("/EchoService/RawEcho", b"tls-%d" % i)
                    assert c.ok() and c.response == b"tls-%d" % i
                big = bytes(range(256)) * 4096
                c = ch.call("/EchoService/RawEcho", big, timeout=30)
                assert c.ok() and c.response == big
        finally:
            srv.close()


# ------------------------------------------------------------------ grpcio

# grpcio runs in a child process: its threads must not live on in a test
# worker, where brpc_tpu's tests fork in process
_GRPCIO_CHILD = r"""
import json, sys
from concurrent import futures
import grpc
sys.path.insert(0, sys.argv[1])
from brpc_tpu_torch import fiber
from brpc_tpu_torch.protocol import h2
from brpc_tpu_torch.rpc import Server, Service

out = {}
svc = Service("EchoService")
svc.register_method("RawEcho", lambda cntl, req: bytes(req))


async def Slow(cntl, request):
    await fiber.sleep(1.5)
    return bytes(request)
svc.register_method("Slow", Slow)
srv = Server()
srv.add_service(svc)
port = srv.start("tcp://127.0.0.1:0").port
ch = grpc.insecure_channel(f"127.0.0.1:{port}")
stub = ch.unary_unary("/brpc.test.EchoService/RawEcho")
big = bytes(range(256)) * 4096
out["echo"] = stub(b"interop", timeout=10) == b"interop"
out["big"] = stub(big, timeout=30) == big
for name, path, body, timeout in (("missing", "/no.Svc/Nope", b"", 10),
                                  ("slow", "/EchoService/Slow", b"x", 0.2)):
    try:
        ch.unary_unary(path)(body, timeout=timeout)
        out[name] = "OK"
    except grpc.RpcError as e:
        out[name] = e.code().name
ch.close()
srv.stop()
srv.join(5)


class Handler(grpc.GenericRpcHandler):
    def service(self, details):
        if details.method == "/test.Svc/Echo":
            return grpc.unary_unary_rpc_method_handler(
                lambda req, ctx: req.upper())
        return None
gserver = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
gserver.add_generic_rpc_handlers((Handler(),))
gport = gserver.add_insecure_port("127.0.0.1:0")
gserver.start()
with h2.GrpcChannel(f"127.0.0.1:{gport}") as pch:
    c = pch.call("/test.Svc/Echo", b"hello")
    out["port_client"] = [c.status, c.response.decode()]
    c = pch.call("/test.Svc/Missing", b"")
    out["port_client_missing"] = c.status
gserver.stop(0).wait(5)
print(json.dumps(out), flush=True)
"""


def case_grpcio_both_ways():
    try:
        import grpc  # noqa: F401  (where it imports: not on the card)
    except ImportError:
        return
    p = subprocess.run([sys.executable, "-c", _GRPCIO_CHILD, str(ROOT)],
                       capture_output=True, text=True, timeout=50)
    assert p.returncode == 0, (p.stdout + p.stderr)[-3000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got == {"echo": True, "big": True, "missing": "NOT_FOUND",
                   "slow": "DEADLINE_EXCEEDED",
                   "port_client": [0, "HELLO"],
                   "port_client_missing": 12}, got   # 12: UNIMPLEMENTED


CASES = [
    ("HPACK: RFC 7541 vectors", case_hpack_rfc_vectors, ()),
    ("HPACK: port and brpc_tpu coders both ways",
     case_hpack_parity_both_ways, ()),
    ("HPACK: random and flipped blocks", case_hpack_fuzz_parity, ()),
    ("gRPC helpers", case_grpc_helpers, ()),
    ("gRPC port -> port", case_grpc_port_to_port, ()),
    ("gRPC port -> brpc_tpu", case_grpc_port_client_to_reference_server, ()),
    ("gRPC brpc_tpu -> port", case_grpc_reference_client_to_port_server, ()),
    ("gRPC many calls on one connection",
     case_grpc_many_calls_on_one_connection, ()),
    ("a dead connection fails its calls", case_dead_connection_fails_calls,
     ()),
    ("a frame over 16 KiB fails the connection",
     case_big_frame_fails_the_connection, ()),
    ("Generate over gRPC equals brpc_tpu's tpu_std unary",
     case_generate_over_grpc_equals_reference, ()),
    ("a gRPC call in flight at stop", case_grpc_in_flight_at_stop, ()),
    ("the gRPC auth gate", case_grpc_auth_gate, ()),
    ("registry, /connections and /status", case_registry_and_pages, ()),
    ("gRPC over ssl://", case_grpc_over_ssl, ()),
    ("grpcio both ways", case_grpcio_both_ways, ()),
]


def test_h2():
    _run_cases(CASES, limit_s=60.0)
