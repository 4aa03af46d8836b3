"""BSON and the mongo server of the port (``protocol/bson.py``,
``protocol/mongo.py``) against brpc_tpu's, on the CPU.

- BSON: the documents of tests/test_legacy_protocols.py and 200 made
  from a seed give bytes equal to brpc_tpu's and read alike; the 500
  random and 400 bit-flipped documents of tests/test_decoder_fuzz.py's
  generators are decoded alike or refused alike; the depth bomb and the
  length bomb are refused by both.
- The server: the OP_MSG and OP_QUERY cases of
  tests/test_legacy_protocols.py (ping, insert, find, the hello and
  isMaster handshake, an unknown command's code 59, a handler error's
  code 8, no adaptor) against the port's server and brpc_tpu's, with
  equal reply documents; 200 commands written back to back on one
  connection, answered in order with their ``responseTo``; code 202 at
  max concurrency; a corrupt frame drops the connection on both, and
  tests/test_protocol_fuzz.py's 2 GB header waits on both, as any
  16-byte prefix does, until 28 bytes show it is no nshead head either,
  then drops it; the server goes on serving; an auth server answers
  mongo, as brpc_tpu's does.

One collected test over the cases (``_run_cases`` of
test_torch_cluster.py).
"""

import random
import socket as pysocket
import struct
import threading

import numpy as np
import pytest

from brpc_tpu.fiber import sleep as ref_sleep
from brpc_tpu.protocol import bson as ref_bson
from brpc_tpu.protocol import mongo as ref_mongo
from brpc_tpu.rpc import Server as RefServer
from brpc_tpu.rpc import ServerOptions as RefServerOptions

import brpc_tpu_torch.fiber as port_fiber
from brpc_tpu_torch.protocol import bson, mongo
from brpc_tpu_torch.rpc import Server, ServerOptions

from test_torch_cluster import _run_cases

SEED = 20261018


def _norm(v):
    """A decoded value with both packages' ObjectId and DateTimeMs as
    tagged tuples, so the two reads compare."""
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_norm(x) for x in v]
    if isinstance(v, (bson.ObjectId, ref_bson.ObjectId)):
        return ("oid", v.raw)
    if isinstance(v, (bson.DateTimeMs, ref_bson.DateTimeMs)):
        return ("date", int(v))
    return v


def _to_ref(v):
    if isinstance(v, dict):
        return {k: _to_ref(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_to_ref(x) for x in v]
    if isinstance(v, bson.ObjectId):
        return ref_bson.ObjectId(v.raw)
    if isinstance(v, bson.DateTimeMs):
        return ref_bson.DateTimeMs(int(v))
    return v


def _value(rng, depth):
    k = int(rng.integers(11 if depth < 4 else 9))
    if k == 0:
        return float(rng.standard_normal())
    if k == 1:
        return "".join(chr(int(c)) for c in
                       rng.integers(1, 0x3000, int(rng.integers(0, 8))))
    if k == 2:
        return rng.bytes(int(rng.integers(0, 12)))
    if k == 3:
        return bson.ObjectId(rng.bytes(12))
    if k == 4:
        return bool(rng.integers(2))
    if k == 5:
        return bson.DateTimeMs(int(rng.integers(-(1 << 50), 1 << 50)))
    if k == 6:
        return None
    if k == 7:
        return int(rng.integers(-(1 << 31), 1 << 31))
    if k == 8:
        return int(rng.integers(1 << 31, 1 << 62))
    if k == 9:
        return _doc(rng, depth + 1)
    return [_value(rng, depth + 1) for _ in range(int(rng.integers(0, 4)))]


def _doc(rng, depth=0):
    return {f"k{int(rng.integers(1000))}": _value(rng, depth)
            for _ in range(int(rng.integers(0, 5)))}


def _outcome(mod, data):
    try:
        doc, end = mod.decode_doc(data)
        return ("ok", repr(_norm(doc)), end)
    except Exception as e:
        assert not isinstance(e, (RecursionError, MemoryError)), e
        return ("refused",)


def _mutations(rng, base: bytes, count: int):
    for _ in range(count):
        data = bytearray(base)
        for _ in range(rng.randrange(1, 4)):
            data[rng.randrange(len(data))] ^= 1 << rng.randrange(8)
        yield bytes(data)


def case_bson():
    doc = {"str": "hello", "int32": 7, "int64": 1 << 40, "double": 2.5,
           "bool": True, "none": None, "bin": b"\x00\x01",
           "oid": bson.ObjectId(b"A" * 12), "sub": {"nested": "yes"},
           "arr": [1, "two", 3.0], "when": bson.DateTimeMs(1700000000000)}
    wire = bson.encode_doc(doc)
    assert wire == ref_bson.encode_doc(_to_ref(doc))
    out, end = bson.decode_doc(wire)
    assert end == len(wire) and out == doc
    assert _norm(ref_bson.decode_doc(wire)[0]) == _norm(out)
    for bad in (b"\x03\x00\x00\x00", struct.pack("<i", 100) + b"\x00" * 10,
                struct.pack("<i", 2**31 - 1) + b"\x00" * 16):
        with pytest.raises(bson.BsonError):
            bson.decode_doc(bad)
        with pytest.raises((ref_bson.BsonError, ValueError)):
            ref_bson.decode_doc(bad)
    deep = cur = {}
    for _ in range(100):
        cur["x"] = {}
        cur = cur["x"]
    with pytest.raises(bson.BsonError, match="deep"):
        bson.encode_doc(deep)
    with pytest.raises(ref_bson.BsonError, match="deep"):
        ref_bson.encode_doc(deep)
    # the depth bomb: 100 nested documents on the wire
    bomb = b"\x00"
    for _ in range(100):
        inner = b"\x03x\x00" + bomb if len(bomb) > 1 else b""
        bomb = struct.pack("<i", len(inner) + 5) + inner + b"\x00"
    assert _outcome(bson, bomb) == _outcome(ref_bson, bomb) == ("refused",)
    rng = np.random.default_rng(SEED)
    for _ in range(200):
        doc = _doc(rng)
        wire = bson.encode_doc(doc)
        assert wire == ref_bson.encode_doc(_to_ref(doc))
        assert _norm(bson.decode_doc(wire)[0]) == \
            _norm(ref_bson.decode_doc(wire)[0]) == _norm(doc)
    # tests/test_decoder_fuzz.py's generators, at 500 and 400 inputs
    r = random.Random(0xB50A)
    for _ in range(500):
        data = bytes(r.randrange(256) for _ in range(r.randrange(0, 100)))
        assert _outcome(bson, data) == _outcome(ref_bson, data), data.hex()
    r = random.Random(0xB50B)
    base = bson.encode_doc({"name": "fuzz", "n": 42, "flag": True,
                            "nested": {"deep": [1, 2.5, "three"]},
                            "blob": b"\x00\x01\x02" * 10,
                            "oid": bson.ObjectId(b"B" * 12)})
    decoded = 0
    for data in _mutations(r, base, 400):
        got = _outcome(bson, data)
        assert got == _outcome(ref_bson, data), data.hex()
        decoded += got[0] == "ok"
    assert 0 < decoded < 400


# ------------------------------------------------------------------ server

def _adaptor(mod, sleep):
    svc = mod.MongoServiceAdaptor()
    store = {}

    @svc.command("ping")
    def ping(sock, doc):
        return {"ok": 1.0}

    @svc.command("insert")
    def insert(sock, doc):
        docs = doc.get("documents", [])
        store.setdefault(doc["insert"], []).extend(docs)
        return {"n": len(docs)}

    @svc.command("find")
    def find(sock, doc):
        return {"cursor": {"id": 0, "ns": f"db.{doc['find']}",
                           "firstBatch": store.get(doc["find"], [])}}

    @svc.command("boom")
    def boom(sock, doc):
        raise RuntimeError("bad day")

    @svc.command("echo")
    def echo(sock, doc):
        return {"n": doc["echo"]}

    async def slow(sock, doc):
        await sleep(0.3)
        return {}
    svc.add_command_handler("Slow", slow)
    return svc


def _server(kind, **opts):
    if kind == "port":
        srv = Server(ServerOptions(
            mongo_service_adaptor=_adaptor(mongo, port_fiber.sleep), **opts))
    else:
        srv = RefServer(RefServerOptions(
            mongo_service_adaptor=_adaptor(ref_mongo, ref_sleep), **opts))
    return srv, srv.start("tcp://127.0.0.1:0")


def _recv_exact(s, n: int) -> bytes:
    out = b""
    while len(out) < n:
        chunk = s.recv(n - len(out))
        if not chunk:
            raise ConnectionError("closed")
        out += chunk
    return out


def _read_frame(s) -> bytes:
    head = _recv_exact(s, 16)
    return head + _recv_exact(s, struct.unpack("<i", head[:4])[0] - 16)


def _roundtrip(s, doc, request_id=1, query=False):
    s.sendall(mongo.pack_query(request_id, "admin.$cmd", doc) if query
              else mongo.pack_msg(request_id, 0, doc))
    _rid, response_to, op, reply = mongo.unpack_reply(_read_frame(s))
    assert response_to == request_id
    assert op == (mongo.OP_REPLY if query else mongo.OP_MSG)
    return reply


def _talk(port: int):
    """The commands of tests/test_legacy_protocols.py; their replies with
    the handshake's clock left out."""
    out = []
    s = pysocket.create_connection(("127.0.0.1", port), timeout=10)
    try:
        for i, (doc, query) in enumerate((
                ({"ping": 1}, False),
                ({"insert": "things", "documents": [{"x": 1}, {"x": 2}]},
                 False),
                ({"find": "things"}, False),
                ({"hello": 1}, False),
                ({"isMaster": 1}, True),
                ({"ping": 1}, True),
                ({"nosuchcmd": 1}, False),
                ({"boom": 1}, False),
                ({}, False))):
            reply = _roundtrip(s, doc, i + 1, query)
            if "localTime" in reply:
                assert isinstance(reply.pop("localTime"),
                                  (bson.DateTimeMs, ref_bson.DateTimeMs))
            out.append(_norm(reply))
    finally:
        s.close()
    return out


def case_commands():
    srv, ep = _server("port")
    ref, rep = _server("ref")
    try:
        got = _talk(ep.port)
        assert got == _talk(rep.port)
        assert got[0] == {"ok": 1.0}
        assert got[1] == {"n": 2, "ok": 1.0}
        assert [d["x"] for d in got[2]["cursor"]["firstBatch"]] == [1, 2]
        assert got[3]["isWritablePrimary"] is True
        assert got[4]["ismaster"] is True
        assert got[6]["ok"] == 0.0 and got[6]["code"] == 59
        assert got[7]["ok"] == 0.0 and got[7]["code"] == 8 and \
            "handler error" in got[7]["errmsg"]
        assert got[8]["code"] == 59
        assert srv.method_status["mongo.ping"].count() == 2
    finally:
        for x in (srv, ref):
            x.stop()
            x.join(5)
    # no adaptor installed
    for srv in (Server(ServerOptions()), RefServer(RefServerOptions())):
        ep = srv.start("tcp://127.0.0.1:0")
        s = pysocket.create_connection(("127.0.0.1", ep.port), timeout=10)
        try:
            r = _roundtrip(s, {"ping": 1})
            assert r["ok"] == 0.0 and "adaptor" in r["errmsg"]
        finally:
            s.close()
            srv.stop()
            srv.join(5)


def case_pipelined(kind):
    srv, ep = _server(kind)
    s = pysocket.create_connection(("127.0.0.1", ep.port), timeout=20)
    try:
        n = 200
        s.sendall(b"".join(mongo.pack_msg(i + 1, 0, {"echo": i})
                           for i in range(n)))
        for i in range(n):
            _rid, response_to, _op, reply = mongo.unpack_reply(
                _read_frame(s))
            assert (response_to, reply["n"]) == (i + 1, i)
    finally:
        s.close()
        srv.stop()
        srv.join(5)


def case_max_concurrency(kind):
    srv, ep = _server(kind, max_concurrency=1)
    box = []

    def first():
        with pysocket.create_connection(("127.0.0.1", ep.port), 10) as s:
            box.append(_roundtrip(s, {"Slow": 1}))
    t = threading.Thread(target=first)
    try:
        t.start()
        import time
        time.sleep(0.1)
        with pysocket.create_connection(("127.0.0.1", ep.port), 10) as s:
            r = _roundtrip(s, {"slow": 1})
        assert r["ok"] == 0.0 and r["code"] == 202, r
        t.join(10)
        assert box == [{"ok": 1.0}]
    finally:
        t.join(10)
        srv.stop()
        srv.join(5)


def _dropped(port: int, payload: bytes) -> bool:
    with pysocket.create_connection(("127.0.0.1", port), timeout=5) as s:
        s.sendall(payload)
        s.settimeout(0.5)
        try:
            return s.recv(100) == b""
        except ConnectionResetError:
            return True
        except TimeoutError:
            return False


def case_bad_frames(kind):
    srv, ep = _server(kind)
    try:
        bad_doc = struct.pack("<iiii", 16 + 5 + 5, 1, 0, mongo.OP_MSG) + \
            b"\x00" * 5 + struct.pack("<i", 99) + b"\x00"
        kind1 = struct.pack("<iiii", 16 + 5 + 5, 1, 0, mongo.OP_MSG) + \
            b"\x00" * 4 + b"\x01" + bson.encode_doc({})
        # the 2 GB header waits, as any 16 bytes do, until nshead's magic
        # could show (28 bytes): then every protocol has disclaimed it
        giant = struct.pack("<iiii", 0x7FFFFFFF, 1, 0, mongo.OP_MSG)
        assert not _dropped(ep.port, giant)
        giant += b"\x00" * 12
        for payload in (bad_doc, kind1, giant):
            assert _dropped(ep.port, payload), payload.hex()
        s = pysocket.create_connection(("127.0.0.1", ep.port), timeout=5)
        try:
            assert _roundtrip(s, {"ping": 1}) == {"ok": 1.0}
        finally:
            s.close()
    finally:
        srv.stop()
        srv.join(5)


def case_auth_server_answers_mongo():
    srv, ep = _server("port", auth_token="secret")
    s = pysocket.create_connection(("127.0.0.1", ep.port), timeout=10)
    try:
        assert _roundtrip(s, {"ping": 1}) == {"ok": 1.0}
    finally:
        s.close()
        srv.stop()
        srv.join(5)


CASES = ([("bson against brpc_tpu's", case_bson, ()),
          ("commands against brpc_tpu's", case_commands, ()),
          ("an auth server answers mongo", case_auth_server_answers_mongo,
           ())]
         + [(f"{name} ({kind})", fn, (kind,))
            for name, fn in (("pipelined", case_pipelined),
                             ("max_concurrency", case_max_concurrency),
                             ("bad frames", case_bad_frames))
            for kind in ("port", "ref")])


def test_mongo():
    _run_cases(CASES, limit_s=60.0)
