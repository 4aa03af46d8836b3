"""RTMP and its codecs in the port (``protocol/amf.py``, ``flv.py``,
``ts.py`` and ``rtmp.py``) against brpc_tpu's, on the CPU, byte for byte.

- AMF0 encode and decode over seeded values (every type, long strings,
  nesting to the limit and past it), AMF3 decode over seeded AMF3 bytes
  (with string, object and traits references), and seeded garbage: each
  package reads the other's bytes alike, and the same bytes get the same
  value or the same refusal.
- ``pack_chunks`` at chunk sizes 128, 4,096 and 60,000 over seeded
  messages (extended timestamps among them), and each package's chunk
  parser over the other's chunks, fed whole and cut at seeded points.
- The handshake's primitives (``_hs_make_digest``, ``_hs_find_digest``,
  ``_hs_ack_block``, ``_hs_build_block``) on the same blocks and the same
  random source.
- FLV tags and headers, ``mpeg_crc32`` (the MPEG-2 check value among
  them) and TS segments from the same frames; ``_split_aggregate``, its
  clamp and its short-payload error; garbage read alike by every reader.
- Over TCP both ways: a port relay with brpc_tpu's clients and a
  brpc_tpu relay with the port's, publish, play, a late player's cached
  metadata and sequence headers, both handshakes (raw sockets where
  brpc_tpu's client has no switch), the AMF3 envelope, the taken name,
  the hooks, a publisher's drop freeing its name, a client's reconnect,
  ``/connections`` naming the connection, and ``Server.stop`` dropping
  the relay's entries.
- brpc_tpu's client writes 4,096-byte chunks and never says so: a server
  reads 128 until told, so its messages over 128 bytes arrive wrong at
  either relay (ROADMAP section 3); the port's client announces its
  chunk size, and its 60 KiB frames arrive whole at both.
- The probe: 1,000 seeded C0C1 blocks of each handshake, fed to the
  port's messenger through recording wrappers of its protocols, are
  claimed by rtmp alone on a server with a relay, and by none on a
  server without one, where brpc_tpu's messenger agrees; tpu_std's turbo
  scan and C echo take none of their bytes.
- A server with ``auth_token`` answers RTMP, and its ``on_publish``
  refuses, as brpc_tpu's does (RTMP's own hooks gate it).

One collected test over the cases (``_run_cases`` of
test_torch_cluster.py, whose leak check also fails a case that leaves an
RTMP client's socket open or a relay entry whose socket has closed).
"""

import hashlib
import hmac
import random
import socket as pysocket
import struct
import threading
import time
from types import SimpleNamespace

from brpc_tpu.butil.iobuf import IOPortal as RefPortal
from brpc_tpu.protocol import amf as ref_amf
from brpc_tpu.protocol import flv as ref_flv
from brpc_tpu.protocol import registry as ref_registry
from brpc_tpu.protocol import rtmp as ref_rtmp
from brpc_tpu.protocol import ts as ref_ts
from brpc_tpu.rpc import Server as RefServer
from brpc_tpu.rpc import ServerOptions as RefServerOptions
from brpc_tpu.transport.input_messenger import \
    InputMessenger as RefMessenger

from brpc_tpu_torch.builtin.services import connections_page
from brpc_tpu_torch.butil.iobuf import IOPortal
from brpc_tpu_torch.protocol import amf, flv, registry, rtmp, ts
from brpc_tpu_torch.protocol import tpu_std
from brpc_tpu_torch.rpc import Server, ServerOptions
from brpc_tpu_torch.transport.input_messenger import InputMessenger

from test_torch_cluster import _run_cases, _wait_for

SEED = 20261018
_names = iter(range(100000))


def _name(tag):
    return f"{tag}-{next(_names)}"


# --------------------------------------------------------------------- AMF

def _norm(v):
    """A value of either package as a comparable tree: the marker types
    by name, floats by their bytes (NaN included)."""
    kind = type(v).__name__
    if kind == "Undefined":
        return ("undefined",)
    if kind == "AmfDate":
        return ("date", struct.pack(">d", float(v)))
    if kind == "AmfEcmaArray":
        return ("ecma", tuple((k, _norm(x)) for k, x in v.items()))
    if isinstance(v, dict):
        return ("object", tuple((k, _norm(x)) for k, x in v.items()))
    if isinstance(v, list):
        return ("list", tuple(_norm(x) for x in v))
    if isinstance(v, bool):
        return ("bool", v)
    if isinstance(v, float):
        return ("number", struct.pack(">d", v))
    if isinstance(v, (bytes, bytearray)):
        return ("bytes", bytes(v))
    return (kind, v)


def _seeded_value(r, mod, depth=0):
    """A random AMF0 value of ``mod``'s types."""
    kinds = ["num", "bool", "str", "null", "undef", "date"]
    if depth < 4:
        kinds += ["obj", "ecma", "list"]
    k = r.choice(kinds)
    if k == "num":
        return r.choice([r.uniform(-1e9, 1e9), float(r.randrange(-99, 99)),
                         r.randrange(-(1 << 40), 1 << 40)])
    if k == "bool":
        return r.random() < 0.5
    if k == "str":
        n = r.choice([0, 1, 5, 40, 300])
        return "".join(chr(r.choice([r.randrange(32, 127),
                                     r.randrange(0xa0, 0x3000)]))
                       for _ in range(n))
    if k == "null":
        return None
    if k == "undef":
        return mod.Undefined()
    if k == "date":
        return mod.AmfDate(r.uniform(0, 2e12))
    n = r.randrange(0, 5)
    if k == "list":
        return [_seeded_value(r, mod, depth + 1) for _ in range(n)]
    d = {f"k{r.randrange(1000)}": _seeded_value(r, mod, depth + 1)
         for _ in range(n)}
    return mod.AmfEcmaArray(d) if k == "ecma" else d


def _as_decoded(v):
    """``v`` as AMF0 reads it back: an int as a float."""
    if isinstance(v, bool) or v is None:
        return v
    if isinstance(v, int):
        return float(v)
    if isinstance(v, list):
        return [_as_decoded(x) for x in v]
    if isinstance(v, dict):
        out = type(v)() if type(v).__name__ == "AmfEcmaArray" else {}
        out.update((k, _as_decoded(x)) for k, x in v.items())
        return out
    return v


def _decoded(fn, data):
    try:
        return ("ok", [_norm(x) for x in fn(data)])
    except Exception as e:      # the verdict: which error, not its text
        return ("error", type(e).__name__)


def case_amf0():
    for mod_seed in range(300):
        r1, r2 = random.Random(SEED + mod_seed), random.Random(SEED + mod_seed)
        vals_p = [_seeded_value(r1, amf) for _ in range(r1.randrange(1, 6))]
        vals_r = [_seeded_value(r2, ref_amf) for _ in range(r2.randrange(1, 6))]
        wire = amf.encode_values(*vals_p)
        assert wire == ref_amf.encode_values(*vals_r)
        got = [_norm(x) for x in amf.decode_all(wire)]
        assert got == [_norm(x) for x in ref_amf.decode_all(wire)]
        assert got == [_norm(_as_decoded(x)) for x in vals_p]
    # a long string, the depth limit both ways
    s = "x" * 70000
    assert amf.encode_value(s) == ref_amf.encode_value(s)
    assert amf.decode_all(ref_amf.encode_value(s)) == [s]
    deep_p, deep_r = [], []
    for _ in range(40):
        deep_p, deep_r = [deep_p], [deep_r]
    for mod, deep in ((amf, deep_p), (ref_amf, deep_r)):
        try:
            mod.encode_value(deep)
            raise AssertionError("nesting past the limit encoded")
        except mod.AmfError:
            pass
    nested = b"\x0a\x00\x00\x00\x01" * 40 + b"\x05"
    assert _decoded(amf.decode_all, nested) == \
        _decoded(ref_amf.decode_all, nested) == ("error", "AmfError")
    for bad in (b"\xff", b"\x00\x01", b"\x02\x00\x05ab", b"\x0b\x00"):
        assert _decoded(amf.decode_all, bad) == \
            _decoded(ref_amf.decode_all, bad) == ("error", "AmfError")


class _Amf3Writer:
    """A test encoder of AMF3, with references where a value repeats."""

    def __init__(self, r):
        self.r = r
        self.strings = []
        self.out = bytearray()

    def u29(self, v):
        v &= 0x1FFFFFFF
        if v < 0x80:
            self.out += bytes([v])
        elif v < 0x4000:
            self.out += bytes([0x80 | (v >> 7), v & 0x7F])
        elif v < 0x200000:
            self.out += bytes([0x80 | (v >> 14), 0x80 | ((v >> 7) & 0x7F),
                               v & 0x7F])
        else:
            self.out += bytes([0x80 | (v >> 22), 0x80 | ((v >> 15) & 0x7F),
                               0x80 | ((v >> 8) & 0x7F), v & 0xFF])

    def string(self, s):
        if s and s in self.strings and self.r.random() < 0.7:
            self.u29(self.strings.index(s) << 1)
            return
        b = s.encode()
        self.u29((len(b) << 1) | 1)
        self.out += b
        if s:
            self.strings.append(s)

    def value(self, depth=0):
        r = self.r
        k = r.randrange(12 if depth < 3 else 8)
        if k == 0:
            self.out += b"\x00"
        elif k == 1:
            self.out += b"\x01"
        elif k == 2:
            self.out += bytes([r.choice([2, 3])])
        elif k == 3:
            self.out += b"\x04"
            self.u29(r.randrange(0, 1 << 29))
        elif k == 4:
            self.out += b"\x05" + struct.pack(">d", r.uniform(-1e6, 1e6))
        elif k == 5:
            self.out += b"\x06"
            self.string(r.choice(["", "a", "bc", "app", "live", "x" * 20]))
        elif k == 6:
            self.out += b"\x08\x01" + struct.pack(">d", r.uniform(0, 2e12))
        elif k == 7:
            n = r.randrange(0, 20)
            self.out += b"\x0c"
            self.u29((n << 1) | 1)
            self.out += bytes(r.randrange(256) for _ in range(n))
        elif k in (8, 9):
            dense = r.randrange(0, 4)
            self.out += b"\x09"
            self.u29((dense << 1) | 1)
            for _ in range(r.randrange(0, 3)):
                self.string(r.choice(["k1", "k2", "name"]))
                self.value(depth + 1)
            self.string("")
            for _ in range(dense):
                self.value(depth + 1)
        else:
            sealed = r.randrange(0, 3)
            dynamic = r.random() < 0.5
            self.out += b"\x0a"
            self.u29((sealed << 4) | (8 if dynamic else 0) | 3)
            self.string(r.choice(["", "Cls"]))
            names = [f"s{i}" for i in range(sealed)]
            for nm in names:
                self.string(nm)
            for _ in names:
                self.value(depth + 1)
            if dynamic:
                for _ in range(r.randrange(0, 3)):
                    self.string(r.choice(["d1", "d2"]))
                    self.value(depth + 1)
                self.string("")
        if depth == 0 and r.random() < 0.2 and len(self.out) > 2:
            # a reference to an earlier complex value or traits
            self.out += b"\x0a"
            self.u29(0)


def case_amf3():
    r = random.Random(SEED)
    kinds = set()
    for _ in range(400):
        w = _Amf3Writer(r)
        for _ in range(r.randrange(1, 5)):
            w.value()
        data = bytes(w.out)
        got = _decoded(amf.decode_all_amf3, data)
        assert got == _decoded(ref_amf.decode_all_amf3, data), data.hex()
        kinds.add(got[0])
        # behind the AMF0 switch marker, as a command carries it
        wrapped = b"\x11" + data
        assert _decoded(amf.decode_all, wrapped) == \
            _decoded(ref_amf.decode_all, wrapped)
    assert kinds == {"ok", "error"}, kinds


def case_garbage():
    r = random.Random(SEED + 1)
    verdicts = set()
    for i in range(1500):
        n = r.choice([1, 2, 3, 9, 17, 40, 200])
        data = bytes(r.randrange(256) for _ in range(n))
        if i % 3 == 0:
            # a valid encoding with flipped bytes
            data = bytearray(ref_amf.encode_values(
                "connect", 1.0, {"app": "live", "n": [1.0, None]}))
            for _ in range(r.randrange(1, 4)):
                data[r.randrange(len(data))] ^= 1 << r.randrange(8)
            data = bytes(data)
        for fp, fr in ((amf.decode_all, ref_amf.decode_all),
                       (amf.decode_all_amf3, ref_amf.decode_all_amf3)):
            got = _decoded(fp, data)
            assert got == _decoded(fr, data), data.hex()
            verdicts.add(got[0])
        for fp, fr in ((flv.iter_tags, ref_flv.iter_tags),
                       (ts.iter_packets, ref_ts.iter_packets)):
            try:
                a = ("ok", [tuple(x) for x in fp(data)])
            except Exception as e:
                a = ("error", type(e).__name__)
            try:
                b = ("ok", [tuple(x) for x in fr(data)])
            except Exception as e:
                b = ("error", type(e).__name__)
            assert a == b, data.hex()
        sp, sr = rtmp._ConnState(False), ref_rtmp._ConnState(False)
        sp.phase = sp.PHASE_READY
        sr.phase = sr.PHASE_READY
        assert _chunk_verdict(rtmp, sp, data) == \
            _chunk_verdict(ref_rtmp, sr, data), data.hex()
    assert verdicts == {"ok", "error"}


# ------------------------------------------------------------------ chunks

def _seeded_messages(r, mod, n=40):
    msgs = []
    for _ in range(n):
        size = r.choice([0, 1, 127, 128, 129, 4095, 4096, 4097, 60000,
                         60001, 130000, r.randrange(0, 20000)])
        stamp = r.choice([0, 33, 0xFFFFFE, 0xFFFFFF, 0x1000000,
                          r.randrange(0, 1 << 32)])
        msgs.append(mod.RtmpMessage(
            r.choice([8, 9, 18, 20, 22]), stamp, r.randrange(0, 5),
            bytes(r.randrange(256) for _ in range(min(size, 64)))
            * (size // 64) + bytes(size % 64)))
    return msgs


def _parse_all(mod, data, chunk, cuts=()):
    """Messages ``mod``'s chunk parser cuts from ``data`` with the
    incoming chunk size ``chunk``, the bytes arriving in pieces at
    ``cuts``."""
    st = mod._ConnState(is_client=False)
    st.phase = st.PHASE_READY
    st.in_chunk_size = chunk
    out, buf, pos = [], b"", 0
    edges = sorted(set(cuts)) + [len(data)]
    prev = 0
    for edge in edges:
        buf += data[prev:edge]
        prev = edge
        while True:
            got = mod._parse_one_chunk(st, buf, pos)
            if got is None:
                break
            msg, pos = got
            if msg is not None:
                out.append((msg.msg_type, msg.timestamp, msg.stream_id,
                            msg.payload))
    assert pos == len(data)
    return out


def _chunk_verdict(mod, st, data):
    out, pos = [], 0
    try:
        while True:
            got = mod._parse_one_chunk(st, data, pos)
            if got is None:
                return ("ok", out, pos)
            msg, pos = got
            if msg is not None:
                out.append((msg.msg_type, msg.timestamp, msg.stream_id,
                            msg.payload))
    except Exception as e:
        return ("error", type(e).__name__)


def case_chunks():
    for size in (128, 4096, 60000):
        mp = _seeded_messages(random.Random(SEED + size), rtmp)
        mr = _seeded_messages(random.Random(SEED + size), ref_rtmp)
        for csid in (2, 3, 6, 63):
            wire = b"".join(rtmp.pack_chunks(m, csid, size) for m in mp)
            assert wire == b"".join(ref_rtmp.pack_chunks(m, csid, size)
                                    for m in mr)
            want = [(m.msg_type, m.timestamp & 0xFFFFFFFF, m.stream_id,
                     m.payload) for m in mp]
            r = random.Random(SEED + csid)
            cuts = sorted(r.randrange(len(wire)) for _ in range(25))
            assert _parse_all(rtmp, wire, size) == want
            assert _parse_all(rtmp, wire, size, cuts) == want
            assert _parse_all(ref_rtmp, wire, size, cuts) == want
    # formats 1-3 and 2- and 3-byte basic headers from hand-made bytes
    payload = b"z" * 300
    data = (bytes([0x00, 200]) + (1000).to_bytes(3, "big")
            + len(payload).to_bytes(3, "big") + b"\x09" +
            struct.pack("<I", 1) + payload[:128]
            + bytes([0xC0, 200]) + payload[128:256]
            + bytes([0xC0, 200]) + payload[256:]
            + bytes([0x40, 200]) + (40).to_bytes(3, "big")
            + (10).to_bytes(3, "big") + b"\x08" + b"a" * 10
            + bytes([0x80, 200]) + (7).to_bytes(3, "big") + b"b" * 10
            + bytes([0xC0, 200]) + b"c" * 10
            + bytes([0x01, 5, 1]) + (9).to_bytes(3, "big")
            + (4).to_bytes(3, "big") + b"\x12" + struct.pack("<I", 2)
            + b"meta")
    for cut in range(1, len(data)):
        assert _parse_all(rtmp, data, 128, [cut]) == \
            _parse_all(ref_rtmp, data, 128, [cut])
    got = _parse_all(rtmp, data, 128)
    assert [(t, s) for t, s, _, _ in got] == \
        [(9, 1000), (8, 1040), (8, 1047), (8, 1054), (18, 9)]


def case_split_aggregate():
    r = random.Random(SEED + 2)

    def sub(t, stamp, body):
        return (bytes([t]) + len(body).to_bytes(3, "big")
                + (stamp & 0xFFFFFF).to_bytes(3, "big")
                + bytes([(stamp >> 24) & 0xFF]) + b"\x00\x00\x00" + body
                + (11 + len(body)).to_bytes(4, "big"))

    for _ in range(200):
        payload = b"".join(
            sub(r.choice([8, 9]), r.randrange(0, 1 << 31),
                bytes(r.randrange(256) for _ in range(r.randrange(0, 50))))
            for _ in range(r.randrange(0, 9)))
        stamp = r.randrange(0, 1 << 20)
        if r.random() < 0.3 and payload:
            payload = payload[:r.randrange(len(payload))]
        outs = []
        for mod in (rtmp, ref_rtmp):
            try:
                outs.append(("ok", [(m.msg_type, m.timestamp, m.stream_id,
                                     m.payload) for m in
                                    mod._split_aggregate(mod.RtmpMessage(
                                        22, stamp, 3, payload))]))
            except mod.RtmpError as e:
                outs.append(("error", str(e)))
        assert outs[0] == outs[1]
    # rebased timestamps, the clamp of an older sub-tag, the short error
    agg = sub(8, 1000, b"a") + sub(9, 1021, b"b") + sub(8, 10, b"c")
    got = rtmp._split_aggregate(rtmp.RtmpMessage(22, 5000, 1, agg))
    assert [(m.msg_type, m.timestamp) for m in got] == \
        [(8, 5000), (9, 5021), (8, 4010)]
    got = rtmp._split_aggregate(rtmp.RtmpMessage(22, 100, 1, agg))
    assert got[2].timestamp == 0
    short = sub(8, 0, b"abcdef")[:-6]
    for mod in (rtmp, ref_rtmp):
        try:
            mod._split_aggregate(mod.RtmpMessage(22, 0, 1, short))
            raise AssertionError("a short aggregate split")
        except mod.RtmpError as e:
            assert "overruns" in str(e)


# --------------------------------------------------------------- handshake

class _Urandom:
    """A seeded stand-in for ``os.urandom``."""

    def __init__(self, seed):
        self.r = random.Random(seed)

    def __call__(self, n):
        return bytes(self.r.randrange(256) for _ in range(n))


def _with_urandom(mod, seed, fn):
    saved = mod.os
    mod.os = SimpleNamespace(urandom=_Urandom(seed))
    try:
        return fn()
    finally:
        mod.os = saved


def case_handshake():
    r = random.Random(SEED + 3)
    for i in range(60):
        block = bytes(r.randrange(256) for _ in range(rtmp.HANDSHAKE_SIZE))
        for key in (rtmp._FP_KEY, rtmp._FMS_KEY):
            for scheme in (0, 1):
                pos = rtmp._hs_digest_pos(block, scheme)
                assert pos == ref_rtmp._hs_digest_pos(block, scheme)
                assert rtmp._hs_make_digest(block, pos, key) == \
                    ref_rtmp._hs_make_digest(block, pos, key)
            assert rtmp._hs_find_digest(block, key) == \
                ref_rtmp._hs_find_digest(block, key) is None
        for scheme in (0, 1):
            for key, version in ((rtmp._FP_KEY, bytes((127, 101, 0, 1))),
                                 (rtmp._FMS_KEY, bytes((3, 5, 1, 1)))):
                got = _with_urandom(rtmp, i, lambda: rtmp._hs_build_block(
                    key, scheme, version))
                assert got == _with_urandom(
                    ref_rtmp, i, lambda: ref_rtmp._hs_build_block(
                        key, scheme, version))
                found = rtmp._hs_find_digest(got[0], key)
                assert found == ref_rtmp._hs_find_digest(got[0], key) == \
                    (scheme, got[1])
                flipped = bytearray(got[0])
                flipped[r.randrange(8, len(flipped))] ^= 0x40
                assert rtmp._hs_find_digest(bytes(flipped), key) == \
                    ref_rtmp._hs_find_digest(bytes(flipped), key)
                full = (rtmp._FMS_KEY if key == rtmp._FP_KEY
                        else rtmp._FP_KEY) + rtmp._KEY_TAIL
                ack = _with_urandom(rtmp, i, lambda: rtmp._hs_ack_block(
                    got[1], full))
                assert ack == _with_urandom(
                    ref_rtmp, i, lambda: ref_rtmp._hs_ack_block(got[1], full))
                tmp = hmac.new(full, got[1], hashlib.sha256).digest()
                assert ack[-32:] == hmac.new(tmp, ack[:-32],
                                             hashlib.sha256).digest()
    # the plain block: time and version words zero
    plain = rtmp._hs_plain_block()
    assert len(plain) == rtmp.HANDSHAKE_SIZE and plain[:8] == bytes(8)


# --------------------------------------------------------------- FLV and TS

def case_flv_ts():
    r = random.Random(SEED + 4)
    assert flv.file_header() == ref_flv.file_header()
    for a, v in ((True, False), (False, True), (False, False)):
        assert flv.file_header(a, v) == ref_flv.file_header(a, v)
    frames = []
    for i in range(120):
        t = r.choice([8, 9, 18])
        body = bytes(r.randrange(256) for _ in range(r.randrange(0, 3000)))
        frames.append((t, r.choice([33 * i, 0x1234567, 0xFFFFFFFF]), body))
    tags_p = [flv.FlvTag(*f) for f in frames]
    tags_r = [ref_flv.FlvTag(*f) for f in frames]
    blob = flv.file_header() + b"".join(flv.pack_tag(t) for t in tags_p)
    assert blob == ref_flv.file_header() + b"".join(
        ref_flv.pack_tag(t) for t in tags_r)
    assert [tuple(t) for t in flv.iter_tags(blob)] == \
        [tuple(t) for t in ref_flv.iter_tags(blob)] == frames
    assert flv.parse_header(blob) == ref_flv.parse_header(blob) == 13
    for bad in (blob[:-1] + b"\x99", blob[:30], b"NOT\x01" + bytes(20)):
        for mod in (flv, ref_flv):
            try:
                list(mod.iter_tags(bad))
                raise AssertionError("a corrupt FLV read")
            except mod.FlvError:
                pass
    # CRC: the check value, and seeded bytes
    assert ts.mpeg_crc32(b"123456789") == 0x0376E6E7
    for n in (0, 1, 3, 17, 188, 1000):
        data = bytes(r.randrange(256) for _ in range(n))
        assert ts.mpeg_crc32(data) == ref_ts.mpeg_crc32(data)
    assert ts.pat_section() == ref_ts.pat_section()
    for v, a in ((True, True), (True, False), (False, True)):
        assert ts.pmt_section(v, a) == ref_ts.pmt_section(v, a)
    # segments from the same frames, and the FLV->TS bridge
    for has_v, has_a in ((True, True), (True, False), (False, True)):
        mp, mr = ts.TsMuxer(has_v, has_a), ref_ts.TsMuxer(has_v, has_a)
        mp.write_tables()
        mr.write_tables()
        for t, stamp, body in frames:
            pts = (stamp * 90) & ((1 << 34) - 1)
            if t == 9 and has_v or not has_a:
                mp.write_video(body, pts)
                mr.write_video(body, pts)
            else:
                mp.write_audio(body, pts)
                mr.write_audio(body, pts)
        seg = mp.flush()
        assert seg == mr.flush()
        for pid in (ts.VIDEO_PID, ts.AUDIO_PID):
            assert ts.extract_pes(seg, pid) == ref_ts.extract_pes(seg, pid)
        assert [tuple(p) for p in ts.iter_packets(seg)] == \
            [tuple(p) for p in ref_ts.iter_packets(seg)]
    assert ts.pes_packet(0xE0, b"d", 0x1FFFFFFFF) == \
        ref_ts.pes_packet(0xE0, b"d", 0x1FFFFFFFF)
    assert ts.pes_packet(0xC0, b"x" * 70000, None) == \
        ref_ts.pes_packet(0xC0, b"x" * 70000, None)


# ----------------------------------------------------------- across the wire

def _relay(kind, **svc_kw):
    """A server of ``kind`` with an RTMP relay (and ``opts`` on it)."""
    opts = svc_kw.pop("opts", {})
    if kind == "port":
        svc = rtmp.RtmpService(**svc_kw)
        srv = Server(ServerOptions(rtmp_service=svc, **opts))
    else:
        svc = ref_rtmp.RtmpService(**svc_kw)
        srv = RefServer(RefServerOptions(rtmp_service=svc, **opts))
    return srv, svc, srv.start("tcp://127.0.0.1:0")


def _stop(srv):
    srv.stop()
    srv.join(5)


class _Player:
    def __init__(self, client, name):
        self.client = client
        self.got = []
        client.connect()
        self.sid = client.create_stream()
        info = client.play(self.sid, name, on_media=self.got.append)
        assert info["code"] == "NetStream.Play.Start", info

    def seen(self):
        return [(m.msg_type, m.timestamp, m.payload) for m in self.got]


def _client(kind, ep, **kw):
    mod = rtmp if kind == "port" else ref_rtmp
    return mod.RtmpClient(f"tcp://{ep.host}:{ep.port}", timeout_s=10, **kw)


def _relay_round(server_kind, client_kind, big: bool):
    """Publish, two players before and two after (the late ones get the
    cache), the taken name, the hook: media of ``client_kind``'s
    clients through ``server_kind``'s relay; ``big`` frames only where
    the client announces its chunk size."""
    refused = []
    srv, svc, ep = _relay(server_kind, on_publish=lambda n, s: (
        refused.append(n) if n.startswith("no-") else None) is None
        and not n.startswith("no-"))
    name = _name("room")
    r = random.Random(SEED + 5)
    size = (lambda: r.randrange(129, 70000)) if big else \
        (lambda: r.randrange(3, 120))
    clients = []
    try:
        pub = _client(client_kind, ep)
        clients.append(pub)
        pub.connect()
        psid = pub.create_stream()
        early = []
        for _ in range(2):
            c = _client(client_kind, ep)
            clients.append(c)
            early.append(_Player(c, name))
        assert pub.publish(psid, name)["code"] == "NetStream.Publish.Start"
        pub.send_metadata(psid, {"width": 640.0, "height": 480.0})
        seq_v = b"\x17\x00" + bytes(r.randrange(256) for _ in range(30))
        seq_a = b"\xaf\x00\x12\x10"
        pub.send_video(psid, 0, seq_v)
        pub.send_audio(psid, 0, seq_a)
        sent = []

        def frames(n, t0):
            for i in range(n):
                v = b"\x27\x01" + bytes(r.randrange(256)
                                        for _ in range(size() - 2))
                a = b"\xaf\x01" + bytes(r.randrange(256) for _ in range(20))
                pub.send_video(psid, t0 + 33 * i, v)
                pub.send_audio(psid, t0 + 33 * i + 5, a)
                sent.extend([(9, t0 + 33 * i, v), (8, t0 + 33 * i + 5, a)])

        frames(5, 40)
        assert _wait_for(lambda: all(len(p.got) == 3 + len(sent)
                                     for p in early))
        meta = early[0].got[0]
        assert meta.msg_type == 18
        late = []
        for _ in range(2):
            c = _client(client_kind, ep)
            clients.append(c)
            late.append(_Player(c, name))
        n0 = len(sent)
        frames(5, 400)
        head = [(18, 0, meta.payload), (9, 0, seq_v), (8, 0, seq_a)]
        assert _wait_for(lambda: all(len(p.got) == 3 + len(sent)
                                     for p in early)
                         and all(len(p.got) == 3 + len(sent) - n0
                                 for p in late)), \
            [len(p.got) for p in early + late]
        for p in early:
            assert p.seen() == head + sent
            assert all(m.stream_id == p.sid for m in p.got)
        for p in late:
            assert p.seen() == head + sent[n0:]
        # the taken name and the hook answer the refusal's status
        for stream in (name, "no-" + name):
            c = _client(client_kind, ep)
            clients.append(c)
            c.connect()
            try:
                c.publish(c.create_stream(), stream)
                raise AssertionError(f"publish {stream} answered")
            except (rtmp.RtmpError, ref_rtmp.RtmpError) as e:
                assert "BadName" in str(e)
        assert refused == ["no-" + name]
        if server_kind == "port":
            page = connections_page(srv)
            assert sum(1 for c in page["connections"]
                       if c["protocol"] == "rtmp") == len(clients)
    finally:
        for c in clients:
            c.close()
        _stop(srv)
    if server_kind == "port":
        assert _wait_for(lambda: svc.players() == 0 and
                         svc.publishers() == 0)


def case_port_clients_brpc_tpu_relay():
    _relay_round("ref", "port", big=True)


def case_brpc_tpu_clients_port_relay():
    _relay_round("port", "ref", big=False)


def case_port_to_port():
    _relay_round("port", "port", big=True)


def case_chunk_size_announced():
    """A 60 KiB frame: the port's client announces its chunk size and the
    frame arrives whole at either relay; brpc_tpu's does not, and its
    frame arrives at neither."""
    payload = b"\x27\x01" + bytes(range(256)) * 240
    out = {}
    for server_kind in ("port", "ref"):
        for client_kind in ("port", "ref"):
            srv, svc, ep = _relay(server_kind)
            name = _name("big")
            try:
                pub = _client(client_kind, ep)
                sub = _client("port", ep)
                try:
                    pub.connect()
                    psid = pub.create_stream()
                    pub.publish(psid, name)
                    p = _Player(sub, name)
                    pub.send_video(psid, 7, payload)
                    pub.send_audio(psid, 9, b"\xaf\x01tail")
                    _wait_for(lambda: any(m.payload == b"\xaf\x01tail"
                                          for m in p.got), 2.0)
                    out[(server_kind, client_kind)] = [
                        m.payload == payload for m in p.got
                        if m.msg_type == 9]
                finally:
                    pub.close()
                    sub.close()
            finally:
                _stop(srv)
    assert out[("port", "port")] == out[("ref", "port")] == [True], out
    assert out[("port", "ref")] == out[("ref", "ref")] == [], out


def _recv_at_least(s, n, deadline_s=10):
    buf = b""
    end = time.monotonic() + deadline_s
    while len(buf) < n and time.monotonic() < end:
        chunk = s.recv(65536)
        if not chunk:
            break
        buf += chunk
    return buf


def _raw_connect(ep, c1, envelope):
    """A raw-socket client: C0C1 ``c1``, the plain C2, then connect in
    ``envelope`` (20 or 17); the server's S0S1S2 and its reply bytes."""
    s = pysocket.create_connection((ep.host, ep.port), timeout=10)
    try:
        s.sendall(bytes([3]) + c1)
        hs = _recv_at_least(s, 1 + 2 * rtmp.HANDSHAKE_SIZE)
        assert len(hs) >= 1 + 2 * rtmp.HANDSHAKE_SIZE
        s.sendall(hs[1:1 + rtmp.HANDSHAKE_SIZE])     # C2 echoes S1
        body = ref_amf.encode_values("connect", 1.0, {
            "app": "live", "objectEncoding": 3.0 if envelope == 17
            else 0.0})
        if envelope == 17:
            body = b"\x00" + body
        s.sendall(rtmp.pack_chunks(rtmp.RtmpMessage(envelope, 0, 0, body),
                                   3))
        got = b""
        end = time.monotonic() + 10
        while b"NetConnection.Connect.Success" not in got and \
                time.monotonic() < end:
            chunk = s.recv(65536)
            if not chunk:
                break
            got += chunk
        return hs[:1 + 2 * rtmp.HANDSHAKE_SIZE], got
    finally:
        s.close()


def case_handshakes_and_envelope():
    """Both handshakes and both command envelopes against both relays,
    from raw sockets (brpc_tpu's client sends only a digest C1 and AMF0),
    and the port's client's switches."""
    for kind in ("port", "ref"):
        srv, svc, ep = _relay(kind)
        try:
            for scheme in (0, 1):
                c1, dig = ref_rtmp._hs_build_block(
                    ref_rtmp._FP_KEY, scheme, bytes((127, 101, 0, 1)))
                hs, got = _raw_connect(ep, c1, 20 if scheme else 17)
                s1 = hs[1:1 + rtmp.HANDSHAKE_SIZE]
                s2 = hs[1 + rtmp.HANDSHAKE_SIZE:]
                assert rtmp._hs_find_digest(s1, rtmp._FMS_KEY)[0] == scheme
                tmp = hmac.new(rtmp._FMS_KEY + rtmp._KEY_TAIL, dig,
                               hashlib.sha256).digest()
                assert s2[-32:] == hmac.new(tmp, s2[:-32],
                                            hashlib.sha256).digest()
                assert b"NetConnection.Connect.Success" in got
            plain = bytes(8) + bytes(random.Random(SEED).randrange(256)
                                     for _ in range(rtmp.HANDSHAKE_SIZE - 8))
            for envelope in (20, 17):
                hs, got = _raw_connect(ep, plain, envelope)
                assert hs[1:9] == bytes(8)               # a plain S1
                assert hs[1 + rtmp.HANDSHAKE_SIZE:] == plain   # S2 = C1
                assert b"NetConnection.Connect.Success" in got
            # the port's client: plain, and AMF3 commands
            for kw in ({"handshake": "plain"}, {"object_encoding": 3},
                       {"handshake": "plain", "object_encoding": 3}):
                with _client("port", ep, **kw) as c:
                    assert c.connect()["code"] == \
                        "NetConnection.Connect.Success"
                    sid = c.create_stream()
                    assert c.publish(sid, _name("kw"))["code"] == \
                        "NetStream.Publish.Start"
        finally:
            _stop(srv)


def case_plain_echo_server():
    """The port's digest client against a server that speaks only the
    plain handshake: it echoes S1 as C2, then says its chunk size."""
    srv = pysocket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]
    state = {}

    def serve():
        c, _ = srv.accept()
        c.settimeout(10)
        try:
            buf = _recv_at_least(c, 1 + rtmp.HANDSHAKE_SIZE)
            c1 = buf[1:1 + rtmp.HANDSHAKE_SIZE]
            s1 = bytes(8) + bytes(rtmp.HANDSHAKE_SIZE - 8)
            c.sendall(bytes([3]) + s1 + c1)
            data = _recv_at_least(c, rtmp.HANDSHAKE_SIZE)
            state["c2"] = data[:rtmp.HANDSHAKE_SIZE]
            rest = data[rtmp.HANDSHAKE_SIZE:]
            st = ref_rtmp._ConnState(is_client=False)
            st.phase = st.PHASE_READY
            pos = 0
            end = time.monotonic() + 10
            while time.monotonic() < end and "tid" not in state:
                got = ref_rtmp._parse_one_chunk(st, rest, pos)
                if got is None:
                    rest += c.recv(65536)
                    continue
                msg, pos = got
                if msg is None:
                    continue
                if msg.msg_type == 1:
                    state["chunk"] = struct.unpack(">I", msg.payload)[0]
                    st.in_chunk_size = state["chunk"]
                elif msg.msg_type == 20:
                    vals = ref_amf.decode_all(msg.payload)
                    state["tid"] = vals[1]
                    c.sendall(ref_rtmp.pack_chunks(ref_rtmp.command_message(
                        "_result", vals[1], {"fmsVer": "PLAIN/1,0"},
                        {"level": "status",
                         "code": "NetConnection.Connect.Success"}), 3))
        finally:
            c.close()

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    try:
        with rtmp.RtmpClient(f"tcp://127.0.0.1:{port}", timeout_s=10) as c:
            assert c.connect()["code"] == "NetConnection.Connect.Success"
        th.join(10)
        assert state["c2"] == bytes(8) + bytes(rtmp.HANDSHAKE_SIZE - 8)
        assert state["chunk"] == rtmp.OUT_CHUNK_SIZE
    finally:
        srv.close()


def case_drop_reconnect_stop():
    """A publisher's drop frees its name; a client reconnects after its
    socket fails; ``Server.stop`` drops the relay's entries; a stray
    0x03 at a server without a relay gets no handshake."""
    srv, svc, ep = _relay("port")
    try:
        a = _client("port", ep)
        a.connect()
        a.publish(a.create_stream(), "transient")
        a.close()
        assert _wait_for(lambda: svc.publishers() == 0)
        with _client("port", ep) as b:
            b.connect()
            b.publish(b.create_stream(), "transient")
            b._socket.set_failed(ConnectionError("simulated drop"))
            assert _wait_for(lambda: svc.publishers() == 0)
            assert b.connect()["code"] == "NetConnection.Connect.Success"
            b.publish(b.create_stream(), "after-reconnect")
            with _client("port", ep) as p:
                _Player(p, "after-reconnect")
                assert svc.players() == 1 and svc.publishers() == 1
                srv.stop()
                assert svc.players() == 0 and svc.publishers() == 0
    finally:
        _stop(srv)
    for kind in ("port", "ref"):
        s = (Server(ServerOptions()) if kind == "port"
             else RefServer(RefServerOptions()))
        sep = s.start("tcp://127.0.0.1:0")
        c = pysocket.create_connection((sep.host, sep.port), timeout=2)
        try:
            c.sendall(b"\x03" + bytes(rtmp.HANDSHAKE_SIZE))
            c.settimeout(0.5)
            try:
                got = c.recv(10)
            except TimeoutError:
                got = b""
            assert got == b"", kind
        finally:
            c.close()
            _stop(s)


def case_auth_server():
    """A server with ``auth_token`` answers RTMP and its ``on_publish``
    refuses, as brpc_tpu's: RTMP carries no credential of the server's,
    and its hooks gate it (ROADMAP section 3)."""
    for kind in ("port", "ref"):
        srv, svc, ep = _relay(kind, opts={"auth_token": "secret"},
                              on_publish=lambda n, s: n != "refused")
        try:
            for client_kind in ("port", "ref"):
                c = _client(client_kind, ep)
                try:
                    assert c.connect()["code"] == \
                        "NetConnection.Connect.Success"
                    assert c.publish(c.create_stream(), _name("ok"))[
                        "code"] == "NetStream.Publish.Start"
                    try:
                        c.publish(c.create_stream(), "refused")
                        raise AssertionError("the hook did not refuse")
                    except (rtmp.RtmpError, ref_rtmp.RtmpError) as e:
                        assert "BadName" in str(e)
                finally:
                    c.close()
        finally:
            _stop(srv)


# ------------------------------------------------------------------ probing

class _ProbeSocket:
    def __init__(self, portal, server):
        self.input_portal = portal
        self.input_need = 0
        self.preferred_protocol = -1
        self.user_data = {"server": server}
        self.failed = False

    def set_failed(self, err=None):
        self.failed = True

    def write(self, data):
        return True


class _Probe:
    """A protocol that records what it did with the bytes."""

    def __init__(self, proto, seen, ok, not_enough):
        self.proto = proto
        self.name = proto.name
        self.min_probe_bytes = getattr(proto, "min_probe_bytes", 0)
        self._seen, self._ok, self._not_enough = seen, ok, not_enough

    def parse(self, portal, socket):
        status, msg = self.proto.parse(portal, socket)
        if status == self._ok:
            self._seen.append((self.name, "claimed"))
        elif status == self._not_enough:
            self._seen.append((self.name, "waits"))
        return status, msg

    def process_inline(self, msg, socket):
        return True

    def process(self, msg, socket):
        return None


def _probe(kind, data, with_relay):
    seen = []
    opts = SimpleNamespace(rtmp_service=object() if with_relay else None)
    server = SimpleNamespace(options=opts)
    if kind == "port":
        protos = [_Probe(p, seen, registry.PARSE_OK,
                         registry.PARSE_NOT_ENOUGH_DATA)
                  for p in registry.get_protocols()]
        portal = IOPortal()
        portal.append(data)
        sock = _ProbeSocket(portal, server)
        InputMessenger(protocols=protos).on_new_messages(sock)
    else:
        # brpc_tpu's, in the port's order: its order depends on which
        # protocol a process used first (case_registry_order)
        protos = [_Probe(ref_registry.find_protocol(p.name), seen,
                         ref_registry.PARSE_OK,
                         ref_registry.PARSE_NOT_ENOUGH_DATA)
                  for p in registry.get_protocols()]
        portal = RefPortal()
        portal.append(data)
        sock = _ProbeSocket(portal, server)
        RefMessenger(protocols=protos).on_new_messages_sync(sock)
    return ("failed" if sock.failed else "kept", seen)


def case_probe_c0c1():
    assert [p.name for p in registry.get_protocols()] == [
        "tpu_std", "hulu_pbrpc", "sofa_pbrpc", "http", "h2", "thrift",
        "nshead", "esp", "mongo", "rtmp", "redis", "memcache"]
    blocks = []
    for i in range(1000):
        urandom = _Urandom(SEED * 7 + i)
        blocks.append(("digest", bytes([3]) + _with_urandom(
            rtmp, SEED * 7 + i, lambda: rtmp._hs_build_block(
                rtmp._FP_KEY, i % 2, rtmp._CLIENT_VERSION))[0]))
        blocks.append(("plain", bytes([3]) + bytes(8) +
                       urandom(rtmp.HANDSHAKE_SIZE - 8)))

    class _Sock:
        user_data = {"server": None}
        failed = False
    proto = tpu_std.TpuStdProtocol()
    for kind, data in blocks:
        got = _probe("port", data, with_relay=True)
        assert got == ("kept", [("rtmp", "claimed")]), (kind, got)
        assert _probe("ref", data, with_relay=True) == got
        got = _probe("port", data, with_relay=False)
        assert got == _probe("ref", data, with_relay=False), (kind, got)
        assert got == ("failed", []), (kind, got)
        # the turbo lane, tried on a connection's first bytes
        portal = IOPortal()
        portal.append(data)
        assert not proto.turbo_scan(portal, _Sock())
        assert not proto.native_serve(portal, _Sock())
        assert portal.size == len(data)
    # cut anywhere in the first bytes, a digest C0C1 waits or is claimed
    # by rtmp alone
    data = blocks[0][1]
    for n in list(range(1, 64)) + [600, 1536, 1537]:
        got = _probe("port", data[:n], with_relay=True)
        assert got == _probe("ref", data[:n], with_relay=True)
        assert not got[0] == "failed" and \
            {p for p, _ in got[1]} <= {"rtmp", "thrift"}, (n, got)


def case_registry_order():
    """A process whose first use of a protocol is a client's (an
    RtmpClient, an EspClient) keeps the builtins' order in the port; in
    brpc_tpu the client's protocol goes first (ROADMAP section 3)."""
    import subprocess
    import sys
    from test_torch_cluster import ROOT
    code = (
        "import sys\n"
        "from brpc_tpu_torch.protocol import rtmp, esp, registry\n"
        "rtmp.RtmpClient('tcp://127.0.0.1:1'); esp.EspClient('127.0.0.1:1')\n"
        "print([p.name for p in registry.get_protocols()])\n"
        "from brpc_tpu.protocol import rtmp as r, registry as rr\n"
        "r.RtmpClient('tcp://127.0.0.1:1')\n"
        "print([p.name for p in rr.get_protocols()])\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    port, ref = proc.stdout.strip().splitlines()[-2:]
    assert port == str(list(registry.BUILTIN_ORDER)), port
    assert ref == str(["rtmp"] + [n for n in registry.BUILTIN_ORDER
                                  if n != "rtmp"]), ref


CASES = [
    ("AMF0 against brpc_tpu's", case_amf0, ()),
    ("AMF3 decode against brpc_tpu's", case_amf3, ()),
    ("garbage read alike", case_garbage, ()),
    ("chunks against brpc_tpu's", case_chunks, ()),
    ("aggregate split", case_split_aggregate, ()),
    ("handshake primitives", case_handshake, ()),
    ("FLV and TS", case_flv_ts, ()),
    ("port clients, brpc_tpu relay", case_port_clients_brpc_tpu_relay, ()),
    ("brpc_tpu clients, port relay", case_brpc_tpu_clients_port_relay, ()),
    ("port clients, port relay", case_port_to_port, ()),
    ("the chunk size announced", case_chunk_size_announced, ()),
    ("handshakes and the AMF3 envelope", case_handshakes_and_envelope, ()),
    ("a plain echo server", case_plain_echo_server, ()),
    ("drop, reconnect, stop", case_drop_reconnect_stop, ()),
    ("an auth server answers RTMP", case_auth_server, ()),
    ("the C0C1 probe", case_probe_c0c1, ()),
    ("the registry's order", case_registry_order, ()),
]


def test_rtmp():
    _run_cases(CASES)
