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
