"""The port's native host core (``brpc_tpu_torch/native``, built from its
own copies of the C++ sources into ``brpc_tpu_torch/_build/``) and the
lanes on it, against brpc_tpu's, on the CPU.

- Bytes: the port's native and pure outputs, each equal to brpc_tpu's on
  seeded numpy inputs: ``pack_small_frame``, ``pack_frame_head``, the
  head probe of ``parse``; ``scan_frames`` records over bursts cut at
  every byte, with metas it must defer (tensors, ``timeout_ms``,
  priority, credits past int32, compression, a token, a trace, an
  admission threshold) and a foreign magic; ``http_parse_request``;
  crc32c, murmur3 and snappy.
- Lane parity over TCP: Generate's tokens through the turbo lane, the
  classic lane and brpc_tpu's ``TinyDecoder``, equal, both ways across
  the wire (brpc_tpu Channel -> port Server, port Channel -> brpc_tpu
  Server).
- The pluck lane: a sync call, a timeout and a backup request.
- ``serve_drain``: an echo, and a tpu_std client that never calls the
  echo method, whose connection loses the hook after its defer streak;
  on ``mem://`` the chunk lanes (``serve_scan`` on the writer's chunks,
  the client's chunk drain).
- The switch and the build: ``BRPC_TPU_TORCH_NO_NATIVE=1`` in a
  subprocess gives the same bytes and tokens; four processes building
  at once leave one good library; the call registry's pool loads the
  core with the registry's lock free.

One collected test over the cases (``_run_cases`` of
test_torch_cluster.py, which fails a case that leaves a socket, naming
thread, health check or the port's loop threads behind); the slice adds
no thread or timer. The cases that serve or pluck over TCP check that
the sockets' pinned fds (``Socket.pin_fd_acquire``) close with them.
"""

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

from brpc_tpu import native as ref_native
from brpc_tpu.butil import flags as ref_flags
from brpc_tpu.butil import hash as ref_hash
from brpc_tpu.butil import snappy_codec as ref_snappy
from brpc_tpu.butil.iobuf import IOPortal as RefPortal
from brpc_tpu.native import fastcore as ref_fastcore
from brpc_tpu.protocol import http as ref_http
from brpc_tpu.protocol import tpu_std as ref_std
from brpc_tpu.protocol.proto import tpu_rpc_meta_pb2 as pb
from brpc_tpu.rpc import Channel as RefChannel
from brpc_tpu.rpc import ChannelOptions as RefChannelOptions
from brpc_tpu.rpc import Server as RefServer
from brpc_tpu.serving import TinyDecoder as RefDecoder
from brpc_tpu.serving import TinyDecoderConfig as RefConfig
from brpc_tpu.serving import add_generate_service as ref_add_generate

from brpc_tpu_torch import native
from brpc_tpu_torch.butil import flags as port_flags
from brpc_tpu_torch.butil import hash as port_hash
from brpc_tpu_torch.butil import snappy_codec as port_snappy
from brpc_tpu_torch.butil.iobuf import IOPortal
from brpc_tpu_torch.native import build as native_build
from brpc_tpu_torch.native import fastcore
from brpc_tpu_torch.protocol import http as port_http
from brpc_tpu_torch.protocol import tpu_std
from brpc_tpu_torch.protocol.registry import PARSE_OK
from brpc_tpu_torch.rpc import (Channel, ChannelOptions, ClusterChannel,
                                Controller, Server, client_dispatch,
                                server_dispatch)
from brpc_tpu_torch.rpc import errno_codes as berr
from brpc_tpu_torch.rpc.service import Service
from brpc_tpu_torch.serving import add_generate_service
from brpc_tpu_torch.transport import socket as port_socket

from test_torch_cluster import _run_cases, _wait_for

ROOT = Path(__file__).resolve().parent.parent
MAX_TOKENS = 8
PROMPTS = ["native lane", "pluck me", "turbo", "classic path"]


def _fc():
    fc = fastcore.get()
    assert fc is not None, f"fastcore did not load: {fastcore.load_error}"
    return fc


# ------------------------------------------------------------------ bytes

def _prefixes(rng):
    out = [b""]
    for _ in range(6):
        m = pb.RpcMeta()
        m.request.service_name = "S" * int(rng.integers(0, 12))
        m.request.method_name = "m" * int(rng.integers(0, 9))
        if rng.integers(2):
            m.request.timeout_ms = int(rng.integers(1, 1 << 20))
        out.append(m.SerializeToString())
    return out


def case_pack_bytes():
    rng = np.random.default_rng(20260803)
    fc = _fc()
    for prefix in _prefixes(rng):
        for _ in range(20):
            cid = int(rng.integers(1, 1 << 62))
            payload = rng.integers(0, 256, int(rng.integers(0, 600)),
                                   dtype=np.uint8).tobytes()
            att = rng.integers(0, 256, int(rng.integers(0, 3)) * 37,
                               dtype=np.uint8).tobytes()
            want = ref_std._py_pack_small_frame(prefix, cid, payload, att)
            assert ref_std.pack_small_frame(prefix, cid, payload, att) \
                == want
            assert tpu_std._py_pack_small_frame(prefix, cid, payload, att) \
                == want
            assert fc.pack_frame(tpu_std.MAGIC, prefix, cid, payload,
                                 att) == want
            assert tpu_std.pack_small_frame(prefix, cid, payload, att) \
                == want
            tail = len(payload)
            head = ref_std._py_pack_frame_head(prefix, cid, len(att), tail)
            assert ref_std.pack_frame_head(prefix, cid, len(att), tail) \
                == head
            assert tpu_std._py_pack_frame_head(prefix, cid, len(att),
                                               tail) == head
            assert tpu_std.pack_frame_head(prefix, cid, len(att), tail) \
                == head
    # request_meta_prefix + pack_small_frame == the whole meta encoded
    req = tpu_std.RpcRequestMeta("Svc", "Do", 0, 250, "", 0)
    for ct in (0, 3):
        meta = tpu_std.RpcMeta(request=req, compress_type=ct,
                               correlation_id=77)
        assert tpu_std.pack_small_frame(
            tpu_std.request_meta_prefix(req, ct), 77, b"body") == \
            tpu_std.pack_frame(meta, b"body")[0]


def _portals(data: bytes, split: int):
    """The port's and brpc_tpu's portals holding ``data`` in blocks of
    ``split`` bytes."""
    mine, ref = IOPortal(), RefPortal()
    for i in range(0, len(data), split):
        mine.append_user_data(data[i:i + split])
        ref.append(data[i:i + split])
    return mine, ref


class _NoFail:
    input_need = 0

    def set_failed(self, e):
        raise AssertionError(f"parse failed the socket: {e}")

    def take_device_payload_with_recv(self):
        return None, None


def case_head_probe():
    rng = np.random.default_rng(7)
    proto, ref = tpu_std.TpuStdProtocol(), ref_std.TpuStdProtocol()
    frame = tpu_std.pack_small_frame(b"", 5, b"x" * 40)
    heads = [frame, b"TRP", b"TRPX" + frame[4:], b"GET / HTTP/1.1\r\n",
             frame[:11], b"TRPC\x00\x00\x00\x01\x00\x00\x00\x09"]
    heads += [rng.integers(0, 256, int(rng.integers(1, 30)),
                           dtype=np.uint8).tobytes() for _ in range(30)]
    for data in heads:
        for split in (1, 5, 12, len(data)):
            results = []
            for lane in ("native", "pure"):
                mine, refp = _portals(data, split)
                sock = _NoFail()
                if lane == "pure":
                    tpu_std._fc, saved = None, tpu_std._fc
                try:
                    status, msg = proto.parse(mine, sock)
                finally:
                    if lane == "pure":
                        tpu_std._fc = saved
                results.append((status, mine.size))
            rstatus, _ = ref.parse(refp, _NoFail())
            assert results[0] == results[1], (data, split, results)
            assert results[0][0] == rstatus, (data, split, results, rstatus)


def _meta_frame(meta: pb.RpcMeta, payload: bytes = b"",
                att: bytes = b"") -> bytes:
    if att:
        meta.attachment_size = len(att)
    raw = meta.SerializeToString()
    return b"".join((tpu_std._HDR.pack(tpu_std.MAGIC,
                                       len(raw) + len(payload) + len(att),
                                       len(raw)), raw, payload, att))


def _burst(rng):
    """Frames the scanner takes, and after each kind it defers one."""
    frames = []
    for i in range(24):
        kind = int(rng.integers(3))
        payload = rng.integers(0, 256, int(rng.integers(0, 200)),
                               dtype=np.uint8).tobytes()
        att = rng.integers(0, 256, int(rng.integers(0, 2)) * 9,
                           dtype=np.uint8).tobytes()
        m = pb.RpcMeta()
        if kind == 0:
            m.request.service_name = "Svc"
            m.request.method_name = f"M{i}"
            if rng.integers(2):
                m.request.log_id = int(rng.integers(1, 1 << 40))
            m.correlation_id = i + 1
        elif kind == 1:
            m.response.error_code = int(rng.integers(2)) * 1008
            if m.response.error_code:
                m.response.error_text = "busy"
            m.correlation_id = i + 1
        else:
            m.stream_settings.stream_id = int(rng.integers(1, 1 << 30))
            m.stream_settings.frame_seq = i
            m.stream_settings.credits = int(rng.integers(0, 4))
            att = b""
        frames.append(_meta_frame(m, payload, att))
    return frames


def _deferred():
    """One frame per rule the scanner defers on."""
    out = {}

    def req(**kw):
        m = pb.RpcMeta()
        m.request.service_name, m.request.method_name = "S", "M"
        m.correlation_id = 9
        for k, v in kw.items():
            setattr(m.request, k, v)
        return m
    out["timeout_ms"] = _meta_frame(req(timeout_ms=100))
    out["priority"] = _meta_frame(req(priority=2))
    out["auth_token"] = _meta_frame(req(auth_token="t"))
    m = req()
    m.compress_type = 3
    out["compression"] = _meta_frame(m)
    m = req()
    m.trace_id = 5
    out["trace"] = _meta_frame(m)
    m = req()
    dp = m.device_payloads.add()
    dp.dtype, dp.nbytes = "float32", 4
    dp.shape.extend([1])
    out["device_payload"] = _meta_frame(m)
    m = req()
    m.stream_settings.stream_id = 3
    out["stream_on_call"] = _meta_frame(m)
    m = pb.RpcMeta()
    m.stream_settings.stream_id = 3
    m.stream_settings.need_feedback = True
    out["need_feedback"] = _meta_frame(m)
    # credits past int32: hand-encoded (protobuf would take it negative)
    inner = b"\x08\x03\x20" + tpu_std._varint(1 << 33)
    raw = b"\x32" + tpu_std._varint(len(inner)) + inner
    out["oversized_credits"] = tpu_std._HDR.pack(
        tpu_std.MAGIC, len(raw), len(raw)) + raw
    m = pb.RpcMeta()
    m.response.error_code = 0
    m.correlation_id = 4
    raw = m.SerializeToString() + b""
    r = tpu_std.RpcMeta(response=tpu_std.RpcResponseMeta(0, "", 9),
                        correlation_id=4).encode()
    out["admission_threshold"] = tpu_std._HDR.pack(
        tpu_std.MAGIC, len(r), len(r)) + r
    big = _meta_frame(req(), b"z" * (tpu_std.SMALL_FRAME_MAX + 10))
    out["oversized_body"] = big
    out["foreign_magic"] = b"XRPC" + _meta_frame(req())[4:]
    return out


def _classic_fields(frame: bytes):
    """What the classic parse makes of one frame, in a record's shape."""
    meta, payload, att = tpu_std.unpack_body(frame[12:], int.from_bytes(
        frame[8:12], "big"))
    if meta.request is not None:
        r = meta.request
        return (0, meta.correlation_id, r.service_name, r.method_name,
                r.log_id, payload, att)
    if meta.response is not None or meta.stream_settings is None:
        resp = meta.response or tpu_std.RpcResponseMeta()
        return (1, meta.correlation_id, resp.error_code,
                resp.error_text or None, payload, att)
    ss = meta.stream_settings
    return (2, ss.stream_id, ss.frame_seq, ss.credits, int(ss.close),
            payload, att)


def case_scan_records():
    rng = np.random.default_rng(11)
    fc, rfc = _fc(), ref_fastcore.get()
    frames = _burst(rng)
    want = [_classic_fields(f) for f in frames]
    data = b"".join(frames)
    ends = np.cumsum([len(f) for f in frames])
    # cut at every byte: the records of the frames wholly inside
    for k in range(len(data) + 1):
        got = fc.scan_frames(data[:k], tpu_std.MAGIC,
                             tpu_std.SMALL_FRAME_MAX, 128, 0, 1)
        ref = rfc.scan_frames(data[:k], ref_std.MAGIC,
                              ref_std.SMALL_FRAME_MAX, 128, 0, 1)
        n = int(np.searchsorted(ends, k, side="right"))
        assert got == ref, k
        assert got[1] == want[:n] and got[0] == (ends[n - 1] if n else 0)
    # each deferred meta stops the scan at its frame, taking what is
    # before it and nothing after
    head = b"".join(frames[:3])
    for name, frame in _deferred().items():
        burst = head + frame + frames[3]
        got = fc.scan_frames(burst, tpu_std.MAGIC,
                             tpu_std.SMALL_FRAME_MAX, 128, 0, 1)
        ref = rfc.scan_frames(burst, ref_std.MAGIC,
                              ref_std.SMALL_FRAME_MAX, 128, 0, 1)
        assert got == ref, name
        assert got == (len(head), want[:3]), name


def _http_heads(rng):
    heads = [b"POST /GenerateService/Generate HTTP/1.1\r\n"
             b"Content-Length: 7\r\n\r\n{\"a\":1}",
             b"GET /status?x=1&y=%20z HTTP/1.1\r\nHost: h\r\n"
             b"Connection: close\r\n\r\n",
             b"GET / HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n",
             b"POST /a HTTP/1.1\r\nContent-Length: +5\r\n\r\nabcde",
             b"POST /a HTTP/1.1\r\nContent-Length: -1\r\n\r\n",
             b"PUT /x HTTP/1.0\r\nX-A:  b  \r\nx-a: c\r\n\r\n",
             b"GET /nohdr HTTP/1.1\r\n\r\n",
             b"GET broken\r\n\r\n",
             b"POST /b HTTP/1.1\r\nContent-Length: 99999999999\r\n\r\n",
             b"DELETE /\xe9t\xe9 HTTP/1.1\r\nK\xe9y: v\r\n\r\n",
             b"GET / HTTP/1.1\r\nHost: x"]
    for _ in range(40):
        hdrs = b"".join(b"H%d: %s\r\n" % (j, rng.integers(
            32, 127, int(rng.integers(0, 20)), dtype=np.uint8).tobytes())
            for j in range(int(rng.integers(0, 5))))
        heads.append(b"GET /p%d HTTP/1.1\r\n%s\r\n" % (
            int(rng.integers(1000)), hdrs))
    return heads


def _parse_lane(data: bytes, lane: str):
    portal = IOPortal()
    portal.append_user_data(data)
    proto = port_http.HttpProtocol()
    if lane == "pure":
        port_http._fc, saved = None, port_http._fc
    try:
        status, req = proto.parse(portal, _NoFail())
    finally:
        if lane == "pure":
            port_http._fc = saved
    if status != PARSE_OK:
        return status
    return (req.method, req.path, req.headers, req.content_length,
            req.keep_alive, req.body, req.query)


def case_http_parse():
    rng = np.random.default_rng(3)
    fc, rfc = _fc(), ref_http._fastcore()
    for data in _http_heads(rng):
        for k in sorted({len(data), len(data) // 2, 5}):
            raw = data[:k]
            got = fc.http_parse_request(raw, port_http.MAX_HEADER,
                                        port_http.MAX_BODY)
            assert got == rfc.http_parse_request(raw, port_http.MAX_HEADER,
                                                 port_http.MAX_BODY), raw
            assert _parse_lane(raw, "native") == _parse_lane(raw, "pure"), \
                raw


def case_hash_snappy():
    rng = np.random.default_rng(5)
    for _ in range(30):
        data = rng.integers(0, 256, int(rng.integers(0, 300)),
                            dtype=np.uint8).tobytes()
        seed = int(rng.integers(0, 1 << 32))
        crc = ref_hash.crc32c_py(data, seed)
        assert port_hash.crc32c(data, seed) == crc
        assert port_hash.crc32c_py(data, seed) == crc
        assert native.crc32c(data, seed) == ref_native.crc32c(data, seed)
        mm = ref_hash.murmur3_x64_128_py(data, seed)
        assert port_hash.murmur3_x64_128(data, seed) == mm
        assert port_hash.murmur3_x64_128_py(data, seed) == mm
    payloads = [b"", b"a", bytes(range(256)) * 40,
                rng.integers(0, 4, 70000, dtype=np.uint8).tobytes(),
                rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()]
    for p in payloads:
        c = ref_snappy.compress(p)
        assert port_snappy.compress(p) == c
        assert native.snappy_compress(p) == ref_native.snappy_compress(p)
        assert port_snappy.compress_auto(p) == ref_snappy.compress_auto(p)
        assert port_snappy.decompress_auto(c) == p
        assert port_snappy.decompress(port_snappy.compress_auto(p)) == p
    for bad in (b"\x05\x08ab", b"\x80", b"\xff\xff\xff\xff\x0f"):
        for dec in (port_snappy.decompress_auto, port_snappy.decompress):
            try:
                dec(bad)
            except ValueError:
                continue
            raise AssertionError(f"{bad!r} must not decode")


# --------------------------------------------------------- lanes on TCP

def _body(prompt: str) -> bytes:
    return json.dumps({"prompt": prompt, "max_tokens": MAX_TOKENS}).encode()


_oracle_cache = {}


def _oracle():
    if not _oracle_cache:
        ref = RefDecoder(RefConfig(cache_len=160))
        for p in PROMPTS:
            _oracle_cache[p] = ref.generate(list(p.encode()), MAX_TOKENS)
    return _oracle_cache


def _counts():
    from brpc_tpu_torch.rpc import stream
    return {"scan": tpu_std.nscan_records.get_value(),
            "turbo": server_dispatch.nturbo_requests.get_value(),
            "fast": client_dispatch.nfast_responses.get_value(),
            "plucked": port_socket.npluck_fast.get_value(),
            "frames": stream.nfast_frames.get_value()}


def _delta(before):
    now = _counts()
    return {k: now[k] - before[k] for k in now}


def case_lane_parity_port_server():
    """Turbo (no deadline in the meta) and classic (a deadline defers
    the request) lanes of a port server, from a port and a brpc_tpu
    client: the same tokens as brpc_tpu's decoder."""
    oracle = _oracle()
    server = Server()
    add_generate_service(server, device="cpu")
    ep = server.start("tcp://127.0.0.1:0")
    try:
        turbo = Channel(str(ep), ChannelOptions(timeout_ms=None))
        classic = Channel(str(ep), ChannelOptions(timeout_ms=30000))
        try:
            for p in PROMPTS:
                before = _counts()
                c = turbo.call_sync("GenerateService", "Generate", _body(p))
                assert not c.failed(), c.error_text
                assert json.loads(c.response)["tokens"] == oracle[p]
                d = _delta(before)
                assert d["turbo"] == 1 and d["plucked"] == 1, d
                before = _counts()
                c = classic.call_sync("GenerateService", "Generate",
                                      _body(p))
                assert not c.failed(), c.error_text
                assert json.loads(c.response)["tokens"] == oracle[p]
                assert _delta(before)["turbo"] == 0
        finally:
            turbo.close()
            classic.close()
        # a traced request defers too: brpc_tpu's rpcz flag, which an
        # earlier test of the worker may have left on, goes off here
        saved = ref_flags.flag("rpcz_enabled")
        ref_flags.set_flag("rpcz_enabled", False)
        try:
            _ref_client_lanes(ep, oracle)
        finally:
            ref_flags.set_flag("rpcz_enabled", saved)
    finally:
        server.stop()
        server.join(5)


def _ref_client_lanes(ep, oracle):
    """brpc_tpu's client to a port server: with no deadline every
    request takes the turbo lane, with one none does."""
    for opts in (RefChannelOptions(timeout_ms=None),
                 RefChannelOptions(timeout_ms=30000)):
        before = _counts()
        rch = RefChannel(f"tcp://127.0.0.1:{ep.port}", opts)
        try:
            for p in PROMPTS:
                c = rch.call_sync("GenerateService", "Generate",
                                  _body(p))
                assert not c.failed(), c.error_text
                tokens = json.loads(c.response_payload.to_bytes()
                                    )["tokens"]
                assert tokens == oracle[p]
        finally:
            rch.close()
        want = len(PROMPTS) if opts.timeout_ms is None else 0
        assert _delta(before)["turbo"] == want


def case_lane_parity_ref_server():
    """A port client's pluck and turbo lanes against a brpc_tpu server."""
    oracle = _oracle()
    server = RefServer()
    ref_add_generate(server)
    ep = server.start("tcp://127.0.0.1:0")
    try:
        ch = Channel(f"tcp://127.0.0.1:{ep.port}",
                     ChannelOptions(timeout_ms=None))
        try:
            before = _counts()
            for p in PROMPTS:
                c = ch.call_sync("GenerateService", "Generate", _body(p))
                assert not c.failed(), c.error_text
                assert json.loads(c.response)["tokens"] == oracle[p]
            assert _delta(before)["plucked"] == len(PROMPTS)
            # calls with a done callback and no joiner: the responses
            # come through the dispatcher's turbo scan
            before = _counts()
            done = [threading.Event() for _ in PROMPTS]
            cs = [ch.call("GenerateService", "Generate", _body(p),
                          done=lambda c, e=e: e.set())
                  for p, e in zip(PROMPTS, done)]
            for p, c, e in zip(PROMPTS, cs, done):
                assert e.wait(60) and not c.failed(), c.error_text
                assert json.loads(c.response)["tokens"] == oracle[p]
            d = _delta(before)
            assert d["fast"] == len(PROMPTS) and d["plucked"] == 0, d
        finally:
            ch.close()
    finally:
        server.stop()
        server.join(5)


def _slow_service():
    svc = Service("Slow")

    @svc.method()
    async def Sleep(cntl, req):
        from brpc_tpu_torch.fiber import sleep
        await sleep(float(req.decode()))
        return req
    return svc


def case_pluck_lane():
    server = Server()
    server.add_service(_slow_service())
    ep = server.start("tcp://127.0.0.1:0")
    try:
        ch = Channel(str(ep), ChannelOptions(timeout_ms=5000))
        armed = []
        ch._arm = lambda cntl, ms, fn: (armed.append(ms),
                                        Channel._arm(cntl, ms, fn))
        try:
            before = port_socket.npluck_fast.get_value()
            for _ in range(5):
                c = ch.call_sync("Slow", "Sleep", b"0.001")
                assert not c.failed() and c.response == b"0.001"
            assert port_socket.npluck_fast.get_value() - before == 5
            # the lazy deadline: calls answered in time armed no timer
            assert armed == [] and "_pending_deadline" not in c.__dict__
            sock = ch._socket
            # a release with nothing in flight leaves reads off (the
            # sticky pause), on a plain Channel's socket
            assert sock.sticky_ok and not sock._plucking
            assert sock._busy_paused and sock._pluck_sticky
            assert not sock.client_cids and sock.lazy_plucker is None
            # the next sync call consumes the pause: no read interest
            # paused or resumed, and the socket sticks again
            conn, flips = sock.conn, []
            pause, resume = conn.pause_read_events, conn.resume_read_events
            conn.pause_read_events = lambda: (flips.append("p"), pause())
            conn.resume_read_events = lambda: (flips.append("r"), resume())
            try:
                c = ch.call_sync("Slow", "Sleep", b"0.001")
                assert not c.failed() and c.response == b"0.001"
                assert flips == [] and sock._pluck_sticky, flips
            finally:
                del conn.pause_read_events, conn.resume_read_events
            # an async call completes on the dispatcher, with its timer
            c = ch.call("Slow", "Sleep", b"0.002")
            assert c.join(10) and c.response == b"0.002"
            assert armed == [5000]
            # a second attempt on a plucked socket arms the plucker's
            # timer: its deadline must not wait on the plucker's pass
            res = {}

            def slow_sync():
                t0 = time.monotonic()
                res["c"] = ch.call_sync("Slow", "Sleep", b"0.4",
                                        cntl=Controller(timeout_ms=150))
                res["took"] = time.monotonic() - t0
            t = threading.Thread(target=slow_sync)
            t.start()
            assert _wait_for(lambda: sock.lazy_plucker is not None)
            c = ch.call("Slow", "Sleep", b"0.01")
            assert c.join(10) and c.response == b"0.01"
            t.join(10)
            assert res["c"].error_code == berr.ERPCTIMEDOUT
            assert 0.14 < res["took"] < 0.4, res["took"]
            # the plucker's timer, then the async call's own
            assert len(armed) == 3 and 0 < armed[1] <= 150 \
                and armed[2] == 5000, armed
        finally:
            ch.close()
        # the pinned dup closes with the socket
        assert _wait_for(lambda: sock.failed and sock._pin_fd == -1)
        # a deadline while plucking: completes on time, late reply dropped
        ch = Channel(str(ep), ChannelOptions(timeout_ms=80, max_retry=0))
        try:
            t0 = time.monotonic()
            c = ch.call_sync("Slow", "Sleep", b"0.5")
            took = time.monotonic() - t0
            assert c.error_code == berr.ERPCTIMEDOUT, c.error_text
            assert 0.07 < took < 0.4, took
            c = ch.call_sync("Slow", "Sleep", b"0.001",
                             cntl=Controller(timeout_ms=5000))
            assert not c.failed() and c.response == b"0.001"
        finally:
            ch.close()
        # a backup request: the first attempt stalls on one replica, the
        # backup answers from the other (one connection a replica, so a
        # backup on the first's connection would wait behind it)
        calls = []
        servers = []
        for delay in (1.0, 0.0):
            svc = Service("Hedge")

            @svc.method()
            async def Call(cntl, req, delay=delay):
                from brpc_tpu_torch.fiber import sleep
                calls.append(delay)
                await sleep(delay)
                return b"slept %s" % str(delay).encode()
            srv = Server()
            srv.add_service(svc)
            servers.append((srv, srv.start("tcp://127.0.0.1:0")))
        url = "list://" + ",".join(f"tcp://127.0.0.1:{e.port}"
                                   for _, e in servers)
        ch = ClusterChannel(url, "rr", ChannelOptions(
            timeout_ms=5000, backup_request_ms=30))
        try:
            # rr: the first pick is the slow replica
            while True:
                c = ch.call_sync("Hedge", "Call", b"")
                if calls[-1] == 0.0 and len(calls) == 1:
                    continue        # rr started on the fast one: again
                break
            assert not c.failed(), c.error_text
            assert c.response == b"slept 0.0" and c.used_backup
            assert c.latency_us() < 800_000, c.latency_us()
            assert _wait_for(lambda: not client_dispatch.inflight_attempts())
        finally:
            ch.close()
            for srv, _ in servers:
                srv.stop()
                srv.join(5)
    finally:
        server.stop()
        server.join(5)


def _echo_server():
    svc = Service("Echo")

    @svc.method(native="echo")
    def Echo(cntl, req):
        return req

    @svc.method()
    def Other(cntl, req):
        return b"other:" + req
    server = Server()
    server.add_service(svc)
    return server, server.start("tcp://127.0.0.1:0")


def case_serve_drain():
    server, ep = _echo_server()
    try:
        rng = np.random.default_rng(9)
        ch = Channel(str(ep), ChannelOptions(timeout_ms=None))
        before = server_dispatch.nserve_drain.get_value()
        try:
            for n in (0, 4, 64, 1024, 4096):
                body = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                c = ch.call_sync("Echo", "Echo", body)
                assert not c.failed() and c.response == body
            # a deadline in the meta: the echo loop still serves it
            c = ch.call_sync("Echo", "Echo", b"dl",
                             cntl=Controller(timeout_ms=1000))
            assert c.response == b"dl"
            c = ch.call_sync("Echo", "Other", b"x")
            assert c.response == b"other:x"
        finally:
            ch.close()
        assert server_dispatch.nserve_drain.get_value() - before == 6
        assert server.method_status["Echo.Echo"].count() >= 6
        # a client that never calls the echo method loses the hook
        other = Channel(str(ep), ChannelOptions(timeout_ms=None))
        try:
            for _ in range(20):
                c = other.call_sync("Echo", "Other", b"y")
                assert c.response == b"other:y"
            conns = [s for s in server.connections()
                     if s.remote_endpoint.port
                     == other._socket.local_endpoint.port]
            assert len(conns) == 1 and conns[0].fast_drain is None
        finally:
            other.close()
    finally:
        conns = server.connections()
        server.stop()
        server.join(5)
    # serve_drain's pinned dups close with their sockets
    assert _wait_for(lambda: all(s.failed and s._pin_fd == -1
                                 for s in conns)), \
        [(s.failed, s._pin_fd, s._pin_refs) for s in conns]


def case_chunk_lanes():
    """On ``mem://`` (chunk conns): the server's hook serves the echo
    with ``serve_scan`` straight off the writer's chunks, and the
    client's chunk drain completes the other method's responses."""
    svc = Service("Echo")
    svc.register_method("Echo", lambda cntl, req: req, native="echo")
    svc.register_method("Other", lambda cntl, req: b"other:" + req)
    server = Server()
    server.add_service(svc)
    ep = server.start("mem://native-chunk-lanes")
    ch = Channel(str(ep), ChannelOptions(timeout_ms=None))
    try:
        d0 = server_dispatch.nserve_drain.get_value()
        c0 = client_dispatch.nchunk_drained.get_value()
        for i in range(10):
            c = ch.call_sync("Echo", "Echo", b"e%d" % i)
            assert c.response == b"e%d" % i, c.error_text
            c = ch.call_sync("Echo", "Other", b"o%d" % i)
            assert c.response == b"other:o%d" % i, c.error_text
        assert server_dispatch.nserve_drain.get_value() - d0 == 10
        # every response came through the client's chunk drain
        assert client_dispatch.nchunk_drained.get_value() - c0 == 20
        assert ch._socket.fast_drain is not None
    finally:
        ch.close()
        server.stop()
        server.join(5)


_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from brpc_tpu_torch import native
from brpc_tpu_torch.native import fastcore
from brpc_tpu_torch.butil import hash as h, snappy_codec as sc
from brpc_tpu_torch.protocol import tpu_std, http
from brpc_tpu_torch.rpc import Channel, ChannelOptions, Server
from brpc_tpu_torch.serving import add_generate_service
assert native.lib() is None and fastcore.get() is None
raw = b"POST /a?b=1 HTTP/1.1\r\nX: y\r\nContent-Length: 2\r\n\r\nhi"
assert http.native_parse_head(raw) == "defer"
req = http.parse_head(raw[:raw.find(b"\r\n\r\n")])
out = {"http": [req.method, req.path, req.headers, req.content_length,
                req.keep_alive, req.query],"frame": tpu_std.pack_small_frame(b"\x0a\x02\x0a\x00", 99,
                                         b"p", b"aa").hex(),
       "head": tpu_std.pack_frame_head(b"", 7, 3, 4).hex(),
       "crc": h.crc32c(b"abc" * 50), "mm": h.murmur3_x64_128(b"key", 3),
       "snappy": sc.compress_auto(bytes(range(256)) * 9).hex()}
srv = Server()
add_generate_service(srv, device="cpu")
ep = srv.start("tcp://127.0.0.1:0")
ch = Channel(str(ep), ChannelOptions(timeout_ms=None))
out["tokens"] = [json.loads(ch.call_sync(
    "GenerateService", "Generate",
    json.dumps({"prompt": p, "max_tokens": 8}).encode()).response)["tokens"]
    for p in json.loads(sys.argv[2])]
ch.close()
srv.stop()
srv.join(5)
print(json.dumps(out), flush=True)
# the fiber workers are daemon threads that may sit in torch code: leave
# without the interpreter's teardown under them
import os
os._exit(0)
"""


def case_switch_subprocess():
    env = dict(os.environ, BRPC_TPU_TORCH_NO_NATIVE="1")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(ROOT),
                           json.dumps(PROMPTS)], env=env,
                          capture_output=True, text=True, timeout=25)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["frame"] == tpu_std.pack_small_frame(
        b"\x0a\x02\x0a\x00", 99, b"p", b"aa").hex()
    assert got["head"] == tpu_std.pack_frame_head(b"", 7, 3, 4).hex()
    assert got["crc"] == port_hash.crc32c(b"abc" * 50)
    assert got["mm"] == port_hash.murmur3_x64_128(b"key", 3)
    assert got["snappy"] == port_snappy.compress_auto(
        bytes(range(256)) * 9).hex()
    raw = b"POST /a?b=1 HTTP/1.1\r\nX: y\r\nContent-Length: 2\r\n\r\nhi"
    head_len, req = port_http.native_parse_head(raw)
    assert head_len == raw.find(b"\r\n\r\n") + 4
    assert got["http"] == [req.method, req.path, req.headers,
                           req.content_length, req.keep_alive, req.query]
    oracle = _oracle()
    assert got["tokens"] == [oracle[p] for p in PROMPTS]


_BUILDER = r"""
import ctypes, sys
from pathlib import Path
sys.path.insert(0, sys.argv[1])
from brpc_tpu_torch.native import build
build.BUILD_DIR = Path(sys.argv[2])
p = build.build()
lib = ctypes.CDLL(str(p))
lib.bt_crc32c.restype = ctypes.c_uint32
lib.bt_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint32]
print(p, lib.bt_crc32c(b"abc", 3, 0), build.build_info["libbrpc_tpu_torch_native"]["cached"])
"""


def case_build_race():
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen([sys.executable, "-c", _BUILDER,
                                   str(ROOT), tmp], stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for _ in range(4)]
        outs = [p.communicate(timeout=25) for p in procs]
        assert all(p.returncode == 0 for p in procs), \
            [o[1][-1500:] for o in outs]
        lines = [o[0].split() for o in outs]
        assert len({ln[0] for ln in lines}) == 1
        assert {ln[1] for ln in lines} == {str(port_hash.crc32c(b"abc"))}
        # one compiled, the others waited for it and loaded it
        assert sorted(ln[2] for ln in lines) == ["False", "True", "True",
                                                 "True"]
        files = sorted(os.listdir(tmp))
        assert files == sorted([Path(lines[0][0]).name,
                                "libbrpc_tpu_torch_native.lock"]), files
    # a failed build raises with the compiler's stderr and leaves nothing
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "src"
        src.mkdir()
        (src / "bad.cc").write_text("int f( {\n")
        saved = native_build.SRC_DIR, native_build.BUILD_DIR
        native_build.SRC_DIR, native_build.BUILD_DIR = src, Path(tmp) / "b"
        try:
            native_build._build("bad", ["bad.cc"], [])
        except RuntimeError as e:
            assert "bad.cc" in str(e) and "error" in str(e)
        else:
            raise AssertionError("a broken source must raise")
        finally:
            native_build.SRC_DIR, native_build.BUILD_DIR = saved
        assert [f for f in os.listdir(Path(tmp) / "b")
                if not f.endswith(".lock")] == []


def case_core_loads_outside_call_registry_lock():
    """The call registry's id pool asks for the native core, which a
    first use builds (seconds of g++): that must run with the registry's
    lock free, or every call's registration on every thread waits out
    the build (and the build's imports nest under the lock)."""
    saved_pool, saved_get = client_dispatch._call_pool, fastcore.get
    seen = []

    def get():
        free = client_dispatch._lock.acquire(blocking=False)
        if free:
            client_dispatch._lock.release()
        seen.append(free)
        return saved_get()
    client_dispatch._call_pool = None
    fastcore.get = get
    try:
        pool = client_dispatch._pool()
        assert pool is not None and client_dispatch._pool() is pool
    finally:
        fastcore.get = saved_get
        client_dispatch._call_pool = saved_pool
    assert seen == [True], seen


CASES = [(name, fn, ()) for name, fn in [
    ("pack bytes", case_pack_bytes),
    ("head probe", case_head_probe),
    ("scan records", case_scan_records),
    ("http parse", case_http_parse),
    ("hash and snappy", case_hash_snappy),
    ("lane parity, port server", case_lane_parity_port_server),
    ("lane parity, brpc_tpu server", case_lane_parity_ref_server),
    ("pluck lane", case_pluck_lane),
    ("serve_drain", case_serve_drain),
    ("chunk lanes on mem://", case_chunk_lanes),
    ("switch in a subprocess", case_switch_subprocess),
    ("four builds at once", case_build_race),
    ("the core loads outside the call registry's lock",
     case_core_loads_outside_call_registry_lock),
]]


def test_native_core():
    # the lanes stand down under rpcz (by their rule): a flag another
    # test of this worker left on must not turn them off here
    saved = port_flags.flag("rpcz_enabled")
    port_flags.set_flag("rpcz_enabled", False)
    try:
        _run_cases(CASES, limit_s=60.0)
    finally:
        port_flags.set_flag("rpcz_enabled", saved)
