"""The nshead family of the port (``protocol/nshead.py``, ``mcpack.py``,
``public_pbrpc_meta.py`` and ``nshead_pbrpc.py``) against brpc_tpu's, on
the CPU.

- Codecs: ``NsheadMessage``, mcpack and the public_pbrpc envelope give
  bytes equal to brpc_tpu's (the envelope's: to its ``*_pb2``) for the
  reference tests' inputs and for 200 seeded inputs each, and read each
  other's bytes alike; 500 random and 400 bit-flipped mcpack bodies are
  decoded alike or refused alike, and so are cut, flipped and random
  envelopes; an envelope that lacks a required field is refused by both
  (pb2's ``ParseFromString`` takes it, and its ``IsInitialized`` and
  ``SerializeToString`` refuse it).
- Probing: the new magics cut at every length, and random bytes, fed to
  the port's InputMessenger and brpc_tpu's (over the same protocols, in
  the same order) are claimed by the same protocol, wait alike or fail
  the connection alike.
- Clients and servers both ways across the wire (the port's client to
  the port's and brpc_tpu's servers, brpc_tpu's client to the port's):
  the nshead cases of tests/test_legacy_protocols.py and the cases of
  tests/test_nshead_pbrpc.py and tests/test_mcpack.py, with bytes
  requests where those use ``echo_pb2``; /connections names the nshead
  connection.
- Generate over nova_pbrpc, public_pbrpc and nshead+mcpack answers the
  JAX TinyDecoder's tokens under carried-across weights; brpc_tpu's
  server of the same shape answers an empty body (ROADMAP section 3).
- A server with ``auth_token`` refuses a nova call and an esp call from
  both packages' clients (the connection dropped, no handler run,
  ``server_auth_refused`` counted), where brpc_tpu's answers them.

One collected test over the cases (``_run_cases`` of
test_torch_cluster.py).
"""

import json
import random
import socket as pysocket
import struct
import time

import numpy as np
import pytest

from brpc_tpu.butil.iobuf import IOPortal as RefPortal
from brpc_tpu.protocol import esp as ref_esp
from brpc_tpu.protocol import mcpack as ref_mcpack
from brpc_tpu.protocol import nshead as ref_nshead
from brpc_tpu.protocol import nshead_pbrpc as ref_npb
from brpc_tpu.protocol import registry as ref_registry
from brpc_tpu.protocol.proto import public_pbrpc_meta_pb2 as ref_ppb
from brpc_tpu.rpc import Server as RefServer
from brpc_tpu.rpc import ServerOptions as RefServerOptions
from brpc_tpu.rpc import Service as RefService
from brpc_tpu.serving import TinyDecoder as RefDecoder
from brpc_tpu.serving import TinyDecoderConfig as RefConfig
from brpc_tpu.serving import add_generate_service as ref_add_generate
from brpc_tpu.transport.input_messenger import \
    InputMessenger as RefMessenger

from brpc_tpu_torch.butil.iobuf import IOPortal
from brpc_tpu_torch.protocol import esp, mcpack, nshead
from brpc_tpu_torch.protocol import nshead_pbrpc as npb
from brpc_tpu_torch.protocol import public_pbrpc_meta as ppb
from brpc_tpu_torch.protocol import registry
from brpc_tpu_torch.rpc import Server, ServerOptions, Service
from brpc_tpu_torch.rpc import server as port_server_mod
from brpc_tpu_torch.serving import add_generate_service
from brpc_tpu_torch.serving.convert import same_weights
from brpc_tpu_torch.serving.model import PARAM_NAMES
from brpc_tpu_torch.transport.input_messenger import InputMessenger

from test_torch_cluster import _run_cases, _wait_for

SEED = 20261018
CACHE_LEN = 96
MAX_TOKENS = 8
PROMPTS = ["hello world", "a"]


# ------------------------------------------------------------------ nshead

def case_nshead_codec():
    m = nshead.NsheadMessage(b"body", id=3, version=1, log_id=99)
    wire = m.pack()
    assert wire == ref_nshead.NsheadMessage(b"body", id=3, version=1,
                                            log_id=99).pack()
    assert len(wire) == 36 + 4
    assert nshead.unpack_head(wire[:36]) == ref_nshead.unpack_head(wire[:36])
    fields = nshead.unpack_head(wire[:36])
    assert fields[0] == 3 and fields[2] == 99
    assert fields[4] == nshead.NSHEAD_MAGIC and fields[6] == 4
    rng = np.random.default_rng(SEED)
    for _ in range(200):
        kw = dict(id=int(rng.integers(1 << 16)),
                  version=int(rng.integers(1 << 16)),
                  log_id=int(rng.integers(1 << 32)),
                  provider=rng.bytes(int(rng.integers(0, 20))),
                  reserved=int(rng.integers(1 << 32)))
        body = rng.bytes(int(rng.integers(0, 300)))
        wire = nshead.NsheadMessage(body, **kw).pack()
        assert wire == ref_nshead.NsheadMessage(body, **kw).pack()
        assert nshead.unpack_head(wire[:36]) == \
            ref_nshead.unpack_head(wire[:36])


# ------------------------------------------------------------------ mcpack

def _mc_value(rng, depth):
    kinds = 8 if depth < 4 else 6
    k = int(rng.integers(kinds))
    if k == 0:
        return int(rng.integers(-(1 << 63), 1 << 63))
    if k == 1:
        return (1 << 63) + int(rng.integers(1 << 62))
    if k == 2:
        return float(rng.standard_normal())
    if k == 3:
        return "".join(chr(int(c)) for c in
                       rng.integers(32, 0x2000, int(rng.integers(0, 8))))
    if k == 4:
        return rng.bytes(int(rng.integers(0, 12)))
    if k == 5:
        return [None, True, False][int(rng.integers(3))]
    if k == 6:
        return _mc_doc(rng, depth + 1)
    return [_mc_value(rng, depth + 1) for _ in range(int(rng.integers(0, 4)))]


def _mc_doc(rng, depth=0):
    return {f"k{int(rng.integers(1000))}": _mc_value(rng, depth)
            for _ in range(int(rng.integers(0, 5)))}


def _outcome(fn, data):
    try:
        return ("ok", repr(fn(data)))
    except Exception as e:
        assert not isinstance(e, (RecursionError, MemoryError)), e
        return ("refused",)


def _mutations(rng, base: bytes, count: int):
    for _ in range(count):
        data = bytearray(base)
        for _ in range(rng.randrange(1, 4)):
            data[rng.randrange(len(data))] ^= 1 << rng.randrange(8)
        yield bytes(data)


def case_mcpack_codec():
    # tests/test_mcpack.py's inputs
    doc = {"s": "hello", "i": -42, "u": (1 << 63) + 5, "d": 2.5, "b": True,
           "n": None, "raw": b"\x00\x01\x02",
           "obj": {"nested": "yes", "deep": {"x": 1}},
           "arr": [1, "two", 3.0, {"four": 4}]}
    wire = mcpack.encode(doc)
    assert wire == ref_mcpack.encode(doc)
    assert mcpack.decode(wire) == ref_mcpack.decode(wire) == doc
    for bad in (b"\xff\x00", mcpack.encode({"a": 1}) + b"trailing",
                b"\x50\x00\x04\x00\x00\x00ab"):
        with pytest.raises(mcpack.McpackError):
            mcpack.decode(bad)
        with pytest.raises(ref_mcpack.McpackError):
            ref_mcpack.decode(bad)
    deep = cur = {}
    for _ in range(100):
        cur["x"] = {}
        cur = cur["x"]
    with pytest.raises(mcpack.McpackError, match="deep"):
        mcpack.encode(deep)
    with pytest.raises(ref_mcpack.McpackError, match="deep"):
        ref_mcpack.encode(deep)
    bomb = b"".join(bytes([mcpack.OBJECT, 0]) + struct.pack("<I", 1)
                    for _ in range(100))
    for mod in (mcpack, ref_mcpack):
        with pytest.raises(mod.McpackError, match="deep"):
            mod.decode(bomb)
    rng = np.random.default_rng(SEED)
    for _ in range(200):
        doc = _mc_doc(rng)
        wire = mcpack.encode(doc)
        assert wire == ref_mcpack.encode(doc)
        assert mcpack.decode(wire) == ref_mcpack.decode(wire) == doc
    # tests/test_decoder_fuzz.py's generators, at 500 and 400 inputs
    r = random.Random(0x3CAC)
    for _ in range(500):
        data = bytes(r.randrange(256) for _ in range(r.randrange(0, 120)))
        assert _outcome(mcpack.decode, data) == \
            _outcome(ref_mcpack.decode, data), data.hex()
    r = random.Random(0x3CAD)
    base = mcpack.encode({"cmd": "echo", "n": 7, "u": 1 << 63, "d": 0.5,
                          "sub": {"k": "v", "raw": b"\x01\x02"},
                          "arr": [True, None, "x"]})
    decoded = 0
    for data in _mutations(r, base, 400):
        got = _outcome(mcpack.decode, data)
        assert got == _outcome(ref_mcpack.decode, data), data.hex()
        decoded += got[0] == "ok"
    assert 0 < decoded < 400


# ---------------------------------------------------------- the envelope

def _pb_dict(msg):
    out = {}
    for fd in msg.DESCRIPTOR.fields:
        v = getattr(msg, fd.name)
        if fd.is_repeated:
            out[fd.name] = [_pb_dict(x) for x in v]
        elif msg.HasField(fd.name):
            out[fd.name] = _pb_dict(v) if fd.message_type else v
        else:
            out[fd.name] = None
    return out


def _port_dict(msg):
    out = {}
    for _num, name, kind, label in msg.FIELDS:
        v = getattr(msg, name)
        if isinstance(kind, type):
            out[name] = [_port_dict(x) for x in v] if label == ppb.REPEATED \
                else (None if v is None else _port_dict(v))
        else:
            out[name] = v
    return out


def _scalar(rng, kind):
    if kind == "string":
        return "".join(chr(int(c)) for c in
                       rng.integers(32, 0x3000, int(rng.integers(0, 6))))
    if kind == "bytes":
        return rng.bytes(int(rng.integers(0, 12)))
    if kind == "uint32":
        return int(rng.integers(0, 1 << 32))
    if kind == "uint64":
        return int(rng.integers(0, 1 << 63)) * int(rng.integers(1, 3))
    if kind == "bool":
        return bool(rng.integers(2))
    return int(rng.integers(-(1 << 31), 1 << 31))    # int32, sint32


def _fill(rng, cls, pb_msg):
    """The same random message built in the port's class and in pb2."""
    mine = cls()
    for _num, name, kind, label in cls.FIELDS:
        if isinstance(kind, type):
            if label == ppb.REPEATED:
                for _ in range(int(rng.integers(0, 3))):
                    getattr(mine, name).append(
                        _fill(rng, kind, getattr(pb_msg, name).add()))
            elif rng.random() < 0.7:
                getattr(pb_msg, name).SetInParent()
                setattr(mine, name, _fill(rng, kind, getattr(pb_msg, name)))
        elif label == ppb.REQUIRED or rng.random() < 0.5:
            v = _scalar(rng, kind)
            setattr(pb_msg, name, v)
            setattr(mine, name, v)
    return mine


def _pb_parse(cls, data):
    msg = cls()
    msg.ParseFromString(data)
    return msg


def case_envelope_codec():
    # the adaptor's and the client's own envelopes
    env = ppb.PublicPbrpcRequest(
        requestHead=ppb.RequestHead(log_id=7),
        requestBody=[ppb.RequestBody(service="EchoService", method_id=0,
                                     id=1, serialized_request=b"hi")])
    ref = ref_ppb.PublicPbrpcRequest()
    ref.requestHead.log_id = 7
    b = ref.requestBody.add()
    b.service, b.method_id, b.id, b.serialized_request = \
        "EchoService", 0, 1, b"hi"
    assert env.encode() == ref.SerializeToString()
    res = ppb.PublicPbrpcResponse(
        responseHead=ppb.ResponseHead(code=0, from_host="brpc-tpu"),
        responseBody=[ppb.ResponseBody(id=1, error=-1)])
    rres = ref_ppb.PublicPbrpcResponse()
    rres.responseHead.code = 0
    rres.responseHead.from_host = "brpc-tpu"
    rb = rres.responseBody.add()
    rb.id, rb.error = 1, -1
    assert res.encode() == rres.SerializeToString()
    assert ppb.ResponseBody(id=1, error=-1).encode()[:11] == \
        b"\x18" + b"\xff" * 9 + b"\x01"             # ten bytes of int32
    assert ppb.ResponseHead(code=-3).encode() == b"\x08\x05"   # zigzag
    rng = np.random.default_rng(SEED)
    pairs = ((ppb.PublicPbrpcRequest, ref_ppb.PublicPbrpcRequest),
             (ppb.PublicPbrpcResponse, ref_ppb.PublicPbrpcResponse))
    for cls, pcls in pairs:
        for _ in range(200):
            pb_msg = pcls()
            mine = _fill(rng, cls, pb_msg)
            wire = mine.encode()
            assert wire == pb_msg.SerializeToString()
            assert cls.decode(wire) == mine
            assert _port_dict(cls.decode(wire)) == \
                _pb_dict(_pb_parse(pcls, wire))
    # a message that lacks a required field: pb2 parses it and calls it
    # uninitialized; the port's decode refuses it (decode(partial=True)
    # reads it as pb2 does)
    for cls, pcls, wire in (
            (ppb.RequestBody, ref_ppb.RequestBody, b"\x20\x01\x28\x02"),
            (ppb.RequestBody, ref_ppb.RequestBody, b"\x1a\x01a\x28\x02"),
            (ppb.RequestBody, ref_ppb.RequestBody, b"\x1a\x01a\x20\x01"),
            # method_id under the wrong wire type is an unknown field
            (ppb.RequestBody, ref_ppb.RequestBody,
             b"\x1a\x01a\x22\x01\x01\x28\x02"),
            (ppb.PublicPbrpcRequest, ref_ppb.PublicPbrpcRequest,
             b"\x12\x02\x20\x01"),
            (ppb.PublicPbrpcResponse, ref_ppb.PublicPbrpcResponse,
             b"\x0a\x02\x12\x00"),
            (ppb.PublicPbrpcResponse, ref_ppb.PublicPbrpcResponse,
             b"\x0a\x02\x08\x00\x12\x02\x08\x01")):
        pb_msg = _pb_parse(pcls, wire)
        assert not pb_msg.IsInitialized()
        with pytest.raises(Exception, match="required"):
            pb_msg.SerializeToString()
        with pytest.raises(ValueError, match="required"):
            cls.decode(wire)
        partial = cls.decode(wire, partial=True)
        assert _port_dict(partial) == _pb_dict(pb_msg)
        assert partial.missing()
        with pytest.raises(ppb.EncodeError, match="required"):
            partial.encode()
    # cut, flipped and random envelopes: read alike or refused alike
    r = random.Random(SEED)
    bases = (env.encode(), ppb.PublicPbrpcRequest(
        requestHead=ppb.RequestHead(from_host="h", connection=True),
        requestBody=[ppb.RequestBody(service="S", method_id=3, id=1 << 40,
                                     serialized_request=b"abc" * 5),
                     ppb.RequestBody(service="T", method_id=1,
                                     id=2)]).encode())
    rbases = (res.encode(), ppb.PublicPbrpcResponse(
        responseHead=ppb.ResponseHead(code=-5, text="t"),
        responseBody=[ppb.ResponseBody(id=3, error=7,
                                       serialized_response=b"x" * 9)]
    ).encode())
    for (cls, pcls), seeds in zip(pairs, (bases, rbases)):
        for i in range(300):
            base = seeds[i % 2]
            kind = i % 3
            if kind == 0:
                data = base[:r.randrange(len(base))]
            elif kind == 1:
                data = next(_mutations(r, base, 1))
            else:
                data = bytes(r.randrange(256)
                             for _ in range(r.randrange(40)))
            try:
                pb_msg = _pb_parse(pcls, data)
                want = ("ok", _pb_dict(pb_msg), pb_msg.IsInitialized())
            except Exception:
                want = ("refused",)
            try:
                mine = cls.decode(data, partial=True)
                got = ("ok", _port_dict(mine), not mine.missing())
            except ValueError:
                got = ("refused",)
            assert got == want, data.hex()


# ---------------------------------------------------------------- probing

class _ProbeSocket:
    """What an InputMessenger reads of a socket, and its failure."""

    def __init__(self, portal):
        self.input_portal = portal
        self.input_need = 0
        self.preferred_protocol = -1
        self.user_data = {}
        self.failed = False

    def set_failed(self, err=None):
        self.failed = True


class _Probe:
    """A protocol that records its claims and processes nothing."""

    def __init__(self, proto, seen, not_enough):
        self.proto = proto
        self.name = proto.name
        self.min_probe_bytes = getattr(proto, "min_probe_bytes", 0)
        self._seen = seen
        self._not_enough = not_enough

    def parse(self, portal, socket):
        status, msg = self.proto.parse(portal, socket)
        if status in ("ok", self._not_enough):
            self._seen.append((self.name, "claimed" if status == "ok"
                               else "waits"))
        return status, msg

    def process_inline(self, msg, socket):
        return True

    def process(self, msg, socket):
        return None


def _probe(kind, data: bytes):
    seen = []
    if kind == "port":
        names = [p.name for p in registry.get_protocols()]
        protos = [_Probe(p, seen, registry.PARSE_NOT_ENOUGH_DATA)
                  for p in registry.get_protocols()]
        portal = IOPortal()
        portal.append(data)
        sock = _ProbeSocket(portal)
        InputMessenger(protocols=protos).on_new_messages(sock)
    else:
        # brpc_tpu's protocols of the port's names, in its order (all
        # twelve since the port has RTMP)
        names = [p.name for p in registry.get_protocols()]
        protos = [_Probe(p, seen, ref_registry.PARSE_NOT_ENOUGH_DATA)
                  for p in ref_registry.get_protocols() if p.name in names]
        assert [p.name for p in protos] == names
        portal = RefPortal()
        portal.append(data)
        sock = _ProbeSocket(portal)
        RefMessenger(protocols=protos).on_new_messages_sync(sock)
    return ("failed" if sock.failed else "kept", seen)


def case_probing():
    frames = [ref_nshead.NsheadMessage(b"body" * 3, log_id=5).pack(),
              ref_esp.EspMessage(b"payload", to=1, from_=2,
                                 msg_id=9).pack(),
              struct.pack("<iiii", 16 + 5 + 5, 1, 0, 2013)
              + b"\x00" * 5 + b"\x05\x00\x00\x00\x00",
              struct.pack("<iiii", 0x7FFFFFFF, 1, 0, 2013),
              ref_nshead.NsheadMessage(b"").pack()[:32]
              + struct.pack("<I", (64 << 20) + 1)]
    prefixes = [f[:n] for f in frames for n in range(1, len(f) + 1)]
    # the short garbage of test_torch_stream.py, test_torch_dispatch.py
    # and test_torch_redis.py: it waits in both, and past 28 bytes fails
    for junk in (b"XXXX junk\r\n\r\n", b"\x00\x01\x02\x03 junk\r\n\r\n",
                 b"SSH- junk\r\n\r\n", b"XXXXXXXXX junk\r\n\r\n",
                 bytes(range(9)), b"PING now please\r\n"):
        assert _probe("port", junk) == _probe("ref", junk) == ("kept", [])
        prefixes += [junk, junk.ljust(28, b"\x00")]
    r = random.Random(SEED)
    prefixes += [bytes(r.randrange(256) for _ in range(r.randrange(1, 40)))
                 for _ in range(300)]
    outcomes = set()
    for data in prefixes:
        got = _probe("port", data)
        assert got == _probe("ref", data), (data.hex(), got)
        outcomes.add((got[0],) + tuple(got[1][:1]))
    assert {("kept", ("nshead", "claimed")), ("kept", ("nshead", "waits")),
            ("kept", ("esp", "claimed")), ("kept", ("esp", "waits")),
            ("kept", ("mongo", "claimed")), ("kept",), ("failed",),
            ("failed", ("nshead", "waits"))} <= outcomes, outcomes


# ------------------------------------------------------ servers, clients

def _echo_service(kind, seen=None):
    """Echo, Fail, RawEcho and a map echo of the reference tests, with
    bytes where they use echo_pb2, in either package."""
    svc = (Service if kind == "port" else RefService)("EchoService")

    def echo(cntl, req):
        if seen is not None:
            seen.append("Echo")
        if isinstance(req, dict):
            return {"message": "re: " + str(req.get("message"))}
        return b"re: " + bytes(req)

    def fail(cntl, req):
        cntl.set_failed(1007, "induced failure")
        return b""
    svc.register_method("Echo", echo)
    svc.register_method("Fail", fail)
    svc.register_method("RawEcho", lambda cntl, req: req)
    return svc


def _server(kind, adaptor, address="tcp://127.0.0.1:0", **opts):
    svc = _echo_service(kind)
    handler = adaptor(svc) if adaptor is not None else None
    if kind == "port":
        srv = Server(ServerOptions(nshead_service=handler, **opts))
    else:
        srv = RefServer(RefServerOptions(nshead_service=handler, **opts))
    return srv, srv.start(address)


def _stop(srv):
    srv.stop()
    srv.join(5)


def _mods(kind):
    return (nshead, npb, mcpack) if kind == "port" else \
        (ref_nshead, ref_npb, ref_mcpack)


def case_raw_nshead(client, server):
    def upper(sock, msg):
        return msg.body.upper()

    def custom(sock, msg):
        m = (nshead if server == "port" else ref_nshead).NsheadMessage(
            b"custom", id=42, log_id=msg.log_id)
        return m
    ns = _mods(client)[0]
    for handler in (upper, custom):
        if server == "port":
            srv = Server(ServerOptions(nshead_service=handler))
        else:
            srv = RefServer(RefServerOptions(nshead_service=handler))
        ep = srv.start("tcp://127.0.0.1:0")
        c = ns.NsheadClient(f"127.0.0.1:{ep.port}")
        try:
            reply = c.call(ns.NsheadMessage(b"hello", log_id=7, version=3))
            if handler is upper:
                assert reply.body == b"HELLO" and reply.log_id == 7
                assert reply.version == 0       # not the request's
                assert c.call(b"raw bytes ok").body == b"RAW BYTES OK"
            else:
                assert (reply.id, reply.log_id, reply.body) == \
                    (42, 7, b"custom")
        finally:
            c.close()
            _stop(srv)
    if server != "port":
        return
    # no nshead_service: the head back with an empty body
    srv = Server(ServerOptions())
    ep = srv.start("tcp://127.0.0.1:0")
    c = ns.NsheadClient(f"127.0.0.1:{ep.port}")
    try:
        reply = c.call(ns.NsheadMessage(b"x", id=5, log_id=6))
        assert (reply.id, reply.log_id, reply.body) == (5, 6, b"")
    finally:
        c.close()
        _stop(srv)
    # a head in a 10-byte sliver waits for the rest (the magic is at 24)
    srv = Server(ServerOptions(nshead_service=upper))
    ep = srv.start("tcp://127.0.0.1:0")
    try:
        wire = nshead.NsheadMessage(b"sliced", log_id=11).pack()
        with pysocket.create_connection(("127.0.0.1", ep.port), 5) as s:
            s.sendall(wire[:10])
            time.sleep(0.3)
            s.sendall(wire[10:])
            s.settimeout(5)
            got = b""
            while len(got) < 36 + 6:
                chunk = s.recv(4096)
                assert chunk, "connection closed instead of parsing"
                got += chunk
        assert nshead.unpack_head(got[:36])[6] == 6
        assert got[36:] == b"SLICED"
        # a body over 64 MiB fails the connection
        with pysocket.create_connection(("127.0.0.1", ep.port), 5) as s:
            s.sendall(wire[:32] + struct.pack("<I", (64 << 20) + 1))
            s.settimeout(5)
            assert s.recv(100) == b""
        assert srv.method_status["nshead.process"].count() >= 1
    finally:
        _stop(srv)


def case_nova(client, server):
    _, np_mod, _ = _mods(client)
    srv, ep = _server(server, (npb if server == "port" else ref_npb)
                      .nova_adaptor)
    addr = f"127.0.0.1:{ep.port}"
    try:
        c = np_mod.NovaClient(addr)
        try:
            assert c.call_method(0, b"hi nova") == b"re: hi nova"
            assert c.call_method(0, b"compressed nova", snappy=True) == \
                b"re: compressed nova"
            assert c.call_method(2, b"raw") == b"raw"
        finally:
            c.close()
        # a bad index, a failed call and a corrupt snappy body drop the
        # connection (nova cannot answer an error)
        ns = _mods(client)[0]
        for index, version, body in ((99, 0, b"x"), (1, 0, b""),
                                     (0, 1, b"\x0a\x01\x00\x00\x00")):
            c = np_mod.NovaClient(addr, timeout_s=5.0)
            try:
                with pytest.raises(Exception):
                    c.call(ns.NsheadMessage(body, version=version,
                                            reserved=index))
            finally:
                c.close()
    finally:
        _stop(srv)


def case_public_pbrpc(client, server):
    _, np_mod, _ = _mods(client)
    srv, ep = _server(server, (npb if server == "port" else ref_npb)
                      .public_pbrpc_adaptor)
    try:
        c = np_mod.PublicPbrpcClient(f"127.0.0.1:{ep.port}")
        try:
            assert c.call_method("EchoService", 0, b"hi public") == \
                b"re: hi public"
            with pytest.raises(ConnectionError, match="remote error 1007"):
                c.call_method("EchoService", 1, b"")
            with pytest.raises(ConnectionError, match="remote error 1002"):
                c.call_method("EchoService", 42, b"")
            # a per-body error leaves the connection in step
            assert c.call_method("EchoService", 0, b"after") == b"re: after"
        finally:
            c.close()
    finally:
        _stop(srv)
    if client != "port":
        return
    # an envelope whose body lacks its service and id: the port's server
    # drops the connection, brpc_tpu's answers it (Python protobuf's
    # ParseFromString checks no required field; ROADMAP section 3)
    srv, ep = _server(server, (npb if server == "port" else ref_npb)
                      .public_pbrpc_adaptor)
    c = nshead.NsheadClient(f"127.0.0.1:{ep.port}", timeout_s=5.0)
    try:
        if server == "port":
            with pytest.raises(ConnectionError):
                c.call(b"\x12\x02\x20\x00")
        else:
            res = ppb.PublicPbrpcResponse.decode(
                c.call(b"\x12\x02\x20\x00").body)
            assert res.responseBody[0].id == 0 and \
                res.responseBody[0].serialized_response == b"re: "
    finally:
        c.close()
        _stop(srv)


def case_ubrpc(client, server):
    ns, np_mod, mc = _mods(client)
    srv, ep = _server(server, (npb if server == "port" else ref_npb)
                      .ubrpc_adaptor)
    try:
        c = np_mod.UbrpcClient(f"127.0.0.1:{ep.port}")
        try:
            assert c.call_method("EchoService", "Echo",
                                 {"message": "hi ubrpc"}) == \
                {"message": "re: hi ubrpc"}
            with pytest.raises(ConnectionError,
                               match="1007: induced failure"):
                c.call_method("EchoService", "Fail", {})
            with pytest.raises(ConnectionError, match="unknown method"):
                c.call_method("EchoService", "Nope", {})
            reply = c.call(ns.NsheadMessage(b"garbage", version=1000))
            item = mc.decode(reply.body)["content"][0]
            assert item["id"] == 0 and item["error"]["code"] == 2001
        finally:
            c.close()
        if client != "port":
            return
        # a content entry that is no object: the port's server answers
        # 2001, brpc_tpu's raises in its adaptor and answers nothing
        # (ROADMAP section 3)
        c = npb.UbrpcClient(f"127.0.0.1:{ep.port}", timeout_s=0.5)
        try:
            body = ns.NsheadMessage(mc.encode({"content": [5]}),
                                    version=1000)
            if server == "port":
                item = mc.decode(c.call(body).body)["content"][0]
                assert item["error"]["code"] == 2001, item
            else:
                with pytest.raises(TimeoutError):
                    c.call(body)
        finally:
            c.close()
    finally:
        _stop(srv)


def case_nshead_mcpack(client, server):
    ns, _, mc = _mods(client)
    srv, ep = _server(server, (mcpack if server == "port" else ref_mcpack)
                      .nshead_mcpack_adaptor, "tcp://127.0.0.1:0")
    c = ns.NsheadClient(f"127.0.0.1:{ep.port}")

    def ask(doc):
        return mc.decode(c.call(ns.NsheadMessage(mc.encode(doc))).body)
    try:
        reply = ask({"method": "Echo", "request": {"message": "hello"}})
        assert reply == {"error_code": 0,
                         "response": {"message": "re: hello"}}
        assert ask({"method": "RawEcho", "request": b"bytes"})[
            "response"] == b"bytes"
        assert ask({"method": "Nope", "request": {}})["error_code"] == 1002
        assert ask({"method": "Fail", "request": b""}) == {
            "error_code": 1007, "error_text": "induced failure"}
        reply = mc.decode(c.call(ns.NsheadMessage(b"garbage")).body)
        assert reply["error_code"] == 1003
    finally:
        c.close()
        _stop(srv)


def case_connections_page():
    import http.client
    srv, ep = _server("port", npb.nova_adaptor)
    c = npb.NovaClient(f"127.0.0.1:{ep.port}")
    try:
        assert c.call_method(0, b"x") == b"re: x"
        conn = http.client.HTTPConnection("127.0.0.1", ep.port, timeout=10)
        conn.request("GET", "/connections")
        rows = json.loads(conn.getresponse().read())["connections"]
        conn.close()
        assert sorted(r["protocol"] for r in rows) == ["http", "nshead"]
    finally:
        c.close()
        _stop(srv)


# ---------------------------------------------------------------- Generate

def _generate_body(prompt: str) -> bytes:
    return json.dumps({"prompt": prompt, "max_tokens": MAX_TOKENS}).encode()


def _generate_over(kind, flavour, port, prompt):
    """The tokens of one Generate over ``flavour``, by ``kind``'s client;
    None for an answer without them."""
    ns, np_mod, mc = _mods(kind)
    addr = f"127.0.0.1:{port}"
    if flavour == "nova_pbrpc":
        c = np_mod.NovaClient(addr, timeout_s=60)
        call = lambda: c.call_method(0, _generate_body(prompt))  # noqa: E731
    elif flavour == "public_pbrpc":
        c = np_mod.PublicPbrpcClient(addr, timeout_s=60)
        call = lambda: c.call_method(  # noqa: E731
            "GenerateService", 0, _generate_body(prompt))
    else:
        c = ns.NsheadClient(addr, timeout_s=60)

        def call():
            doc = mc.decode(c.call(ns.NsheadMessage(mc.encode(
                {"method": "Generate",
                 "request": _generate_body(prompt)}))).body)
            assert doc["error_code"] == 0, doc
            return doc["response"]
    try:
        body = call()
    finally:
        c.close()
    if not body:
        return body
    doc = json.loads(bytes(body))
    assert doc["status"] == "completed" and doc["n"] == MAX_TOKENS
    return doc["tokens"]


FLAVOURS = {"nova_pbrpc": (npb.nova_adaptor, ref_npb.nova_adaptor),
            "public_pbrpc": (npb.public_pbrpc_adaptor,
                             ref_npb.public_pbrpc_adaptor),
            "nshead_mcpack": (mcpack.nshead_mcpack_adaptor,
                              ref_mcpack.nshead_mcpack_adaptor)}


def case_generate(flavour):
    port_adaptor, ref_adaptor = FLAVOURS[flavour]
    oracle_model = RefDecoder(RefConfig(cache_len=CACHE_LEN))
    oracle = {p: oracle_model.generate(list(p.encode()), MAX_TOKENS)
              for p in PROMPTS}
    srv = Server(ServerOptions(enable_builtin_services=False))
    gs = add_generate_service(srv, device="cpu", cache_len=CACHE_LEN)
    srv.options.nshead_service = port_adaptor(
        srv.services()["GenerateService"])
    port = srv.start("tcp://127.0.0.1:0").port
    ref = RefServer(RefServerOptions(enable_builtin_services=False))
    ref_add_generate(ref, cache_len=CACHE_LEN, warmup=True)
    ref.options.nshead_service = ref_adaptor(ref._services[
        "GenerateService"])
    rport = ref.start("tcp://127.0.0.1:0").port
    try:
        assert same_weights(gs.batcher.model, {
            n: getattr(oracle_model, n) for n in PARAM_NAMES})
        for p in PROMPTS:
            assert _generate_over("port", flavour, port, p) == oracle[p], p
        assert _generate_over("ref", flavour, port, PROMPTS[0]) == \
            oracle[PROMPTS[0]]
        # brpc_tpu's server of the same shape: Generate takes its HTTP
        # path and answers an empty body (its fault, ROADMAP section 3)
        for kind in ("port", "ref"):
            assert _generate_over(kind, flavour, rport, PROMPTS[0]) in \
                (b"", {}), (kind, flavour)
    finally:
        _stop(srv)
        _stop(ref)


# -------------------------------------------------------------------- auth

def case_auth_refuses_nshead_and_esp():
    seen = []
    before = port_server_mod.nauth_refused.get_value()

    def esp_handler(sock, msg):
        seen.append("esp")
        return b"re-" + msg.body
    srv = Server(ServerOptions(
        auth_token="secret", nshead_service=npb.nova_adaptor(
            _echo_service("port", seen)), esp_service=esp_handler))
    ep = srv.start("tcp://127.0.0.1:0")
    addr = f"127.0.0.1:{ep.port}"
    try:
        for mod in (npb, ref_npb):
            c = mod.NovaClient(addr, timeout_s=5.0)
            try:
                with pytest.raises(Exception):
                    c.call_method(0, b"no credential")
            finally:
                c.close()
        for mod in (esp, ref_esp):
            c = mod.EspClient(addr, timeout_s=5.0)
            try:
                with pytest.raises(Exception):
                    c.call(to=1, body=b"no credential")
            finally:
                c.close()
        assert seen == []
        assert _wait_for(lambda: port_server_mod.nauth_refused.get_value()
                         == before + 4)
    finally:
        _stop(srv)
    # brpc_tpu's server answers both and runs the handlers: the gap the
    # port does not copy (ROADMAP section 3)
    ref_seen = []

    def ref_esp_handler(sock, msg):
        ref_seen.append("esp")
        return b"re-" + msg.body
    ref = RefServer(RefServerOptions(
        auth_token="secret", nshead_service=ref_npb.nova_adaptor(
            _echo_service("ref", ref_seen)), esp_service=ref_esp_handler))
    rep = ref.start("tcp://127.0.0.1:0")
    try:
        c = npb.NovaClient(f"127.0.0.1:{rep.port}")
        try:
            assert c.call_method(0, b"in") == b"re: in"
        finally:
            c.close()
        c = esp.EspClient(f"127.0.0.1:{rep.port}")
        try:
            assert c.call(to=1, body=b"in").body == b"re-in"
        finally:
            c.close()
        assert ref_seen == ["Echo", "esp"]
    finally:
        _stop(ref)


SIDES = (("port", "port"), ("port", "ref"), ("ref", "port"))

CASES = ([("nshead codec", case_nshead_codec, ()),
          ("mcpack codec and fuzz", case_mcpack_codec, ()),
          ("public_pbrpc envelope", case_envelope_codec, ()),
          ("probing", case_probing, ())]
         + [(f"{name} {c} client, {s} server", fn, (c, s))
            for name, fn in (("raw nshead", case_raw_nshead),
                             ("nova", case_nova),
                             ("public_pbrpc", case_public_pbrpc),
                             ("ubrpc", case_ubrpc),
                             ("nshead+mcpack", case_nshead_mcpack))
            for c, s in SIDES]
         + [("/connections", case_connections_page, ())]
         + [(f"Generate over {f}", case_generate, (f,)) for f in FLAVOURS]
         + [("an auth server refuses nshead and esp",
             case_auth_refuses_nshead_and_esp, ())])


def test_nshead():
    _run_cases(CASES, limit_s=90.0)
