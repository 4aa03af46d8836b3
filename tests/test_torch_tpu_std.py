"""The port's hand-written tpu_std meta codec against brpc_tpu's protobuf
RpcMeta, both ways, and its frames against brpc_tpu's framing."""

import numpy as np
import pytest

from brpc_tpu.protocol import tpu_std as ref_std
from brpc_tpu.protocol.proto import tpu_rpc_meta_pb2 as pb
from brpc_tpu_torch.protocol import tpu_std as port_std


def _pb_request(**request):
    m = pb.RpcMeta()
    for k, v in request.items():
        setattr(m.request, k, v)
    return m


REQUEST_METAS = [
    dict(service_name="GenerateService", method_name="Generate"),
    dict(service_name="GenerateService", method_name="Generate",
         timeout_ms=1000),
    dict(service_name="S", method_name="m", log_id=12345678901,
         timeout_ms=250, priority=3),
    dict(service_name="Sérvice", method_name="M", log_id=-7,
         priority=-2),
    dict(service_name="S", method_name="m", timeout_ms=-1),
]


@pytest.mark.parametrize("fields", REQUEST_METAS)
@pytest.mark.parametrize("cid", [1, 300, (1 << 64) - 1])
def test_request_meta_encodes_like_protobuf(fields, cid):
    m = _pb_request(**fields)
    m.correlation_id = cid
    mine = port_std.RpcMeta(request=port_std.RpcRequestMeta(**fields),
                            correlation_id=cid)
    assert mine.encode() == m.SerializeToString()
    back = port_std.RpcMeta.decode(m.SerializeToString())
    assert back == mine


@pytest.mark.parametrize("code,text", [(0, ""), (1008, "deadline"),
                                       (-5, "negative"), (2001, "x" * 300),
                                       (-(1 << 31), "")])
def test_response_meta_both_ways(code, text):
    m = pb.RpcMeta()
    m.correlation_id = 77
    m.response.error_code = code
    m.response.error_text = text
    m.attachment_size = 9
    wire = m.SerializeToString()
    mine = port_std.RpcMeta(
        response=port_std.RpcResponseMeta(code, text),
        correlation_id=77, attachment_size=9)
    assert mine.encode() == wire
    assert port_std.RpcMeta.decode(wire) == mine
    # and protobuf reads the port's bytes back to the same fields
    m2 = pb.RpcMeta()
    m2.ParseFromString(mine.encode())
    assert m2 == m
    if code < 0:
        assert len(port_std._varint(code)) == 10


def test_unknown_fields_are_skipped():
    """A meta of every field brpc_tpu writes: the fields the port knows,
    compress_type (3), auth_token, stream settings (6), the trace ids
    (8-10) and the response's admission_threshold, are read beside
    the device payloads (7)."""
    m = _pb_request(service_name="S", method_name="M", timeout_ms=5,
                    auth_token="tok")
    m.correlation_id = 42
    m.compress_type = 1
    m.attachment_size = 3
    m.stream_settings.stream_id = 9
    m.stream_settings.credits = -4
    m.stream_settings.close = True
    dp = m.device_payloads.add()
    dp.dtype = "bfloat16"
    dp.shape.extend([2, 3])
    dp.nbytes = 12
    m.trace_id = (1 << 63) + 5
    m.span_id = 6
    m.parent_span_id = 7
    m.response.admission_threshold = 4
    got = port_std.RpcMeta.decode(m.SerializeToString())
    assert got.request == port_std.RpcRequestMeta("S", "M", 0, 5, "tok")
    assert got.compress_type == 1
    assert got.response == port_std.RpcResponseMeta(0, "", 4)
    assert got.correlation_id == 42 and got.attachment_size == 3
    assert (got.trace_id, got.span_id, got.parent_span_id) == (
        (1 << 63) + 5, 6, 7)


@pytest.mark.parametrize("raw", [
    bytes([0x09]) + bytes(8),             # field 1, fixed64
    bytes([0x0D]) + bytes(4),             # field 1, fixed32
    bytes([0x5B, 0x08, 0x01, 0x5C]),      # field 11, group holding a varint
    bytes([0x58]) + bytes([0xFF] * 9 + [0x01]),   # field 11, 10-byte varint
])
def test_every_wire_type_is_skipped(raw):
    wire = raw + pb.RpcMeta(correlation_id=5).SerializeToString()
    assert port_std.RpcMeta.decode(wire) == port_std.RpcMeta(
        correlation_id=5)


@pytest.mark.parametrize("bad", [b"\x20", b"\x0a\x05ab", b"\x00\x01",
                                 b"\x0e"])
def test_malformed_meta_raises(bad):
    with pytest.raises(port_std.DecodeError):
        port_std.RpcMeta.decode(bad)


@pytest.mark.parametrize("prefix_fields", [
    {}, dict(service_name="GenerateService", method_name="Generate",
             timeout_ms=1000)])
@pytest.mark.parametrize("cid,payload,att", [
    (1, b"", b""), (129, b"hello", b""), (1 << 40, b"p" * 1000, b"att"),
])
def test_small_frames_byte_equal(prefix_fields, cid, payload, att):
    prefix = _pb_request(**prefix_fields).SerializeToString() \
        if prefix_fields else b""
    want = ref_std._py_pack_small_frame(prefix, cid, payload, att)
    assert port_std.pack_small_frame(prefix, cid, payload, att) == want
    # a whole-meta encode gives the same frame
    meta = port_std.RpcMeta(
        request=(port_std.RpcRequestMeta(**prefix_fields)
                 if prefix_fields else None),
        correlation_id=cid)
    assert port_std.pack_frame(meta, payload, att) == (want, None)
    # and it parses back
    body_size, meta_size = port_std.parse_header(want[:12])
    got_meta, got_payload, got_att = port_std.unpack_body(want[12:],
                                                          meta_size)
    assert body_size == len(want) - 12
    assert (got_meta, got_payload, got_att) == (meta, payload, att)


def test_error_response_frame_matches_reference_pack_message():
    """The server's failure frame is what brpc_tpu's pack_message makes
    of the same meta."""
    m = pb.RpcMeta()
    m.correlation_id = 99
    m.response.error_code = 2004
    m.response.error_text = "serving queue full (shed)"
    want, _ = ref_std.pack_message(m, b"")
    mine = port_std.pack_frame(port_std.RpcMeta(
        response=port_std.RpcResponseMeta(2004, "serving queue full (shed)"),
        correlation_id=99))
    assert mine == (want.to_bytes(), None)


def test_header_rejects_foreign_magic_and_bad_sizes():
    with pytest.raises(port_std.DecodeError):
        port_std.parse_header(b"PRPC" + bytes(8))
    with pytest.raises(port_std.DecodeError):
        port_std.parse_header(b"TRPC" + (4).to_bytes(4, "big")
                              + (8).to_bytes(4, "big"))
    with pytest.raises(port_std.DecodeError):
        port_std.unpack_body(
            port_std.RpcMeta(attachment_size=50).encode(),
            len(port_std.RpcMeta(attachment_size=50).encode()))


def test_random_metas_roundtrip_against_protobuf():
    rng = np.random.RandomState(3)
    for _ in range(200):
        m = pb.RpcMeta()
        mine = port_std.RpcMeta()
        if rng.rand() < 0.7:
            svc = "s" * int(rng.randint(0, 40))
            tmo = int(rng.randint(-(1 << 40), 1 << 40))
            m.request.service_name = svc
            m.request.timeout_ms = tmo
            mine.request = port_std.RpcRequestMeta(service_name=svc,
                                                   timeout_ms=tmo)
        else:
            code = int(rng.randint(-(1 << 31), (1 << 31) - 1))
            m.response.error_code = code
            mine.response = port_std.RpcResponseMeta(error_code=code)
        cid = int(rng.randint(0, 1 << 62))
        m.correlation_id = cid
        mine.correlation_id = cid
        assert mine.encode() == m.SerializeToString()
        assert port_std.RpcMeta.decode(m.SerializeToString()) == mine


# ------------------------------------------------------------ attachments

def test_small_call_frame_with_attachment_equals_pack_frame():
    """The Channel's small-call path with an attachment gives the bytes
    of the whole-meta frame, which are brpc_tpu's; ``TpuStdProtocol.frame``
    frames as brpc_tpu's does."""
    rng = np.random.default_rng(20261018)
    mine, ref = port_std.TpuStdProtocol(), ref_std.TpuStdProtocol()
    for _ in range(200):
        req = port_std.RpcRequestMeta(
            service_name="S" * int(rng.integers(1, 9)), method_name="m",
            timeout_ms=int(rng.integers(0, 5000)),
            auth_token="t" if rng.random() < 0.3 else "",
            priority=int(rng.integers(0, 4)))
        ct = int(rng.choice([0, 1, 3]))
        cid = int(rng.integers(1, 1 << 50))
        payload = rng.bytes(int(rng.integers(0, 200)))
        att = rng.bytes(int(rng.integers(0, 200)))
        small = port_std.pack_small_frame(
            port_std.request_meta_prefix(req, ct), cid, payload, att)
        meta = port_std.RpcMeta(request=req, compress_type=ct,
                                correlation_id=cid)
        assert small == port_std.pack_frame(meta, payload, att)[0]
        assert small == mine.frame(meta, payload, att)[0]
        m = _pb_request(service_name=req.service_name,
                        method_name=req.method_name,
                        timeout_ms=req.timeout_ms,
                        auth_token=req.auth_token, priority=req.priority)
        m.correlation_id = cid
        m.compress_type = ct
        buf = ref_std.IOBuf()
        buf.append(att)
        assert small == ref.frame(m, payload, attachment=buf)[0].to_bytes()


def _attachment_servers(kind):
    """A server of ``kind`` whose ``Bench.Echo`` reflects the request's
    payload and attachment; (server, port)."""
    if kind == "port":
        from brpc_tpu_torch.rpc import Server, Service
        svc = Service("Bench")

        def Echo(cntl, req):
            cntl.response_attachment.append(
                cntl.request_attachment.to_bytes())
            return bytes(req)
        svc.register_method("Echo", Echo)
        srv = Server()
    else:
        from brpc_tpu.rpc import Server, Service
        svc = Service("Bench")

        def Echo(cntl, req):
            cntl.response_attachment.append_buf(cntl.request_attachment)
            return req.to_bytes() if hasattr(req, "to_bytes") else bytes(req)
        svc.register_method("Echo", Echo)
        srv = Server()
    srv.add_service(svc)
    return srv, srv.start("tcp://127.0.0.1:0").port


@pytest.mark.parametrize("wiring", ["port->port", "port->ref", "ref->port"])
def test_attachments_across_the_wire(wiring):
    client, server = wiring.split("->")
    srv, port = _attachment_servers(server)
    rng = np.random.default_rng(7)
    try:
        if client == "port":
            from brpc_tpu_torch.rpc import Channel, ChannelOptions, Controller
            ch = Channel(f"tcp://127.0.0.1:{port}", ChannelOptions(
                timeout_ms=30000, share_connections=False))
        else:
            from brpc_tpu.rpc import Channel, ChannelOptions
            from brpc_tpu.rpc.controller import Controller
            ch = Channel(f"tcp://127.0.0.1:{port}",
                         ChannelOptions(timeout_ms=30000))
        try:
            for n in (4, 64 << 10, 4 << 20):
                att = rng.bytes(n)
                c = Controller()
                c.request_attachment.append(att)
                c = ch.call_sync("Bench", "Echo", b"p", cntl=c)
                assert not c.failed(), c.error_text
                body = c.response if client == "port" \
                    else c.response_payload.to_bytes()
                assert body == b"p"
                assert c.response_attachment.to_bytes() == att, n
                # a reused controller starts with no response attachment
                if client == "port":
                    c.request_attachment = port_std_iobuf()
                    c = ch.call_sync("Bench", "Echo", b"q", cntl=c)
                    assert c.response == b"q" and not c.response_attachment
        finally:
            ch.close()
    finally:
        srv.stop()
        srv.join(5)


def port_std_iobuf():
    from brpc_tpu_torch.butil.iobuf import IOBuf
    return IOBuf()


def _lane_counts():
    from brpc_tpu_torch.rpc import client_dispatch, server_dispatch
    from brpc_tpu_torch.transport import socket as port_socket
    return {"turbo": server_dispatch.nturbo_requests.get_value(),
            "plucked": port_socket.npluck_fast.get_value(),
            "drain": server_dispatch.nserve_drain.get_value(),
            "scan": server_dispatch.nserve_scan.get_value(),
            "chunk": client_dispatch.nchunk_drained.get_value()}


@pytest.mark.parametrize("lane", ["turbo_and_pluck", "classic",
                                  "chunk_lanes"])
def test_an_attachment_on_each_native_lane(lane):
    """The turbo and pluck lanes, the C echo over an fd (``serve_drain``),
    the classic path a deadline defers a request to, and the chunk lanes
    of ``mem://`` (the server's hook on the writer's chunks and the
    client's chunk drain) carry an attachment both ways."""
    from brpc_tpu_torch.native import fastcore
    from brpc_tpu_torch.rpc import (Channel, ChannelOptions, Controller,
                                    Server, Service)
    if fastcore.get() is None:
        pytest.fail(f"the native core did not load: {fastcore.load_error}")
    svc = Service("Echo")

    def echo(cntl, req):
        cntl.response_attachment.append(cntl.request_attachment.to_bytes())
        return bytes(req)
    svc.register_method("Echo", echo, native="echo")
    svc.register_method("Other", lambda cntl, req: (
        cntl.response_attachment.append(
            cntl.request_attachment.to_bytes()[::-1]), b"o:" + req)[1])
    server = Server()
    server.add_service(svc)
    addr = "mem://tpu-std-att-lanes" if lane == "chunk_lanes" \
        else "tcp://127.0.0.1:0"
    ep = server.start(addr)
    ch = Channel(str(ep), ChannelOptions(timeout_ms=None,
                                         share_connections=False))
    try:
        before = _lane_counts()
        for method, want in (("Echo", lambda a: a), ("Other",
                                                     lambda a: a[::-1])):
            c = Controller(timeout_ms=5000 if lane == "classic" else None)
            c.request_attachment.append(b"attached-" + method.encode())
            if lane == "chunk_lanes":
                done = []
                c = ch.call("Echo", method, b"x", cntl=c, done=done.append)
                assert c.join(10)
            else:
                c = ch.call_sync("Echo", method, b"x", cntl=c)
            assert not c.failed(), c.error_text
            assert c.response_attachment.to_bytes() == \
                want(b"attached-" + method.encode())
        d = {k: v - before[k] for k, v in _lane_counts().items()}
        if lane == "turbo_and_pluck":
            # the echo served in C, the other method by the turbo lane;
            # both responses plucked
            assert d["drain"] == 1 and d["turbo"] == 1 and \
                d["plucked"] == 2, d
        elif lane == "classic":
            # the deadline defers the request from the turbo lane, not
            # from the echo loop
            assert d["drain"] == 1 and d["turbo"] == 0, d
        else:
            assert d["drain"] == 1 and d["chunk"] == 2, d
    finally:
        ch.close()
        server.stop()
        server.join(5)
