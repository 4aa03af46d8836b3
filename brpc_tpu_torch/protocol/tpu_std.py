"""tpu_std: framing with a hand-written RpcMeta codec, and the protocol
object that cuts frames off a socket's input (``TpuStdProtocol``, the
port of brpc_tpu/protocol/tpu_std.py:246).

Wire layout (the same bytes brpc_tpu puts on the wire):

    "TRPC" | body_size:u32be | meta_size:u32be | meta | payload | attachment

``body_size = meta_size + len(payload) + len(attachment)``. ``meta`` is a
proto3 ``RpcMeta`` (brpc_tpu/protocol/proto/tpu_rpc_meta.proto). The port
does not depend on ``google.protobuf``: this module encodes and decodes
the fields of unary calls (with the payload's ``compress_type``, field
3, and the request's ``auth_token``, ``RpcRequestMeta`` field 5), of
streams (``stream_settings``, field 6) and of rpcz tracing
(``trace_id``, ``span_id``, ``parent_span_id``, fields 8-10), device
payloads (7) and the response's admission threshold (``RpcResponseMeta``
field 3), and reads past every other field, of any wire type.

Encoding follows protobuf's own rules, so frames are byte-identical to
``RpcMeta.SerializeToString()``: fields in number order, proto3 scalars
omitted at their default, a sub-message present once set, a
negative int32/int64 written as a 10-byte varint, and a repeated scalar
(``DevicePayloadMeta.shape``) packed; the decoder reads it packed or
not.

Device payloads (``RpcMeta.device_payloads``, field 7): a frame may
carry tensors. ``pack_frame(..., device_arrays=, device_lane=)`` describes
each one in the meta (dtype name, shape, nbytes) and either leaves it out
of the bytes, to ride the connection's device lane
(``Socket.write_device_payload``), or copies it to the host and puts its
bytes at the front of the attachment, ahead of the user attachment
(``inline_bytes``; ``unpack_inline_device_arrays`` cuts them back off).
``parse`` takes a frame's lane batch with
``socket.take_device_payload_with_recv()`` when any payload is not
inline; a lane delivers its batches in the order of their frames.

``TpuStdProtocol.parse`` cuts one frame off an ``IOPortal`` into an
``RpcMessage`` (meta, payload and attachment bytes, and the cut time,
which is the request's arrival for its deadline and its span);
``process`` sends requests to server dispatch and responses to client
dispatch; ``process_inline`` hands bare stream frames to their stream in
parse order.

The native lanes (brpc_tpu/protocol/tpu_std.py:74-130, :261-290,
:339-520), on fastcore (``brpc_tpu_torch/native``) when it loads:
``pack_small_frame`` and ``pack_frame_head`` assemble a frame in one C
allocation (their ``_py_`` twins give the same bytes); ``parse`` reads
the header with fastcore's ``parse_head``; ``turbo_scan`` cuts every
complete small frame off the portal's head and decodes the meta subset
dispatch needs in one call (``scan_frames``), and ``turbo_dispatch``
sends its records down the slim paths; ``native_serve`` serves a
server's ``native="echo"`` method in C (``serve_scan``). (brpc_tpu's
``batch_parse``, off by default there behind ``tpu_std_batch_parse`` and
measured at parity with the per-frame path, is not ported: the ctypes
``trpc_scan`` it runs is, in ``brpc_tpu_torch.native``.)

The scanner judges a frame or defers it to the classic lane: it takes
a request whose meta holds service, method and log id only, a response
with an error code and text only, a bare stream frame with stream id,
frame seq, credits (within int32) and close, each with a correlation id
and an attachment size in bounds. Anything else stops the scan at that
frame: device payloads (field 7), compression, trace ids, stream
settings on a call or outside that vocabulary, ``timeout_ms``,
``priority``, ``auth_token``, an admission threshold, unknown fields, a
lying attachment size, a body over ``SMALL_FRAME_MAX``.
"""

from __future__ import annotations

import struct
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from brpc_tpu_torch.bvar.reducer import Adder
from brpc_tpu_torch.protocol.registry import (PARSE_NOT_ENOUGH_DATA,
                                              PARSE_OK, PARSE_TRY_OTHERS,
                                              Protocol, register_protocol)

MAGIC = b"TRPC"
HEADER_SIZE = 12
_HDR = struct.Struct(">4sII")
MAX_BODY_SIZE = 64 << 20
# frames up to this size take the one-allocation pack and the scan lanes
SMALL_FRAME_MAX = 32768
# scan_frames admits complete stream DATA frames up to this size beyond
# SMALL_FRAME_MAX (0: off, as brpc_tpu measured no gain on big frames)
STREAM_SCAN_MAX = 0

# the extension resolves at first use, not at import (get() may build
# it); False: not resolved yet
_fc = False


def _resolve_fc():
    global _fc
    from brpc_tpu_torch.native import fastcore
    _fc = fastcore.get()
    return _fc

_TAG_CORRELATION_ID = 0x20   # field 4, wire type 0
_TAG_ATTACHMENT_SIZE = 0x28  # field 5, wire type 0

_WT_VARINT, _WT_FIXED64, _WT_LEN, _WT_SGROUP, _WT_EGROUP, _WT_FIXED32 = (
    0, 1, 2, 3, 4, 5)
_U64 = (1 << 64) - 1


class DecodeError(ValueError):
    """Malformed meta bytes."""


# ------------------------------------------------------------- varints

def _varint(n: int) -> bytes:
    """Unsigned LEB128; a negative value is taken as its 64-bit two's
    complement (protobuf's int32/int64 encoding)."""
    n &= _U64
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise DecodeError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result & _U64, pos
        shift += 7
        if shift >= 70:
            raise DecodeError("varint too long")


def _as_int64(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def _as_int32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def _key(field: int, wire_type: int) -> bytes:
    return _varint((field << 3) | wire_type)


def _len_field(field: int, data: bytes) -> bytes:
    return _key(field, _WT_LEN) + _varint(len(data)) + data


def _skip(buf: bytes, pos: int, field: int, wire_type: int) -> int:
    """Position just past an unknown field's value."""
    if wire_type == _WT_VARINT:
        return _read_varint(buf, pos)[1]
    if wire_type == _WT_FIXED64:
        end = pos + 8
    elif wire_type == _WT_FIXED32:
        end = pos + 4
    elif wire_type == _WT_LEN:
        n, pos = _read_varint(buf, pos)
        end = pos + n
    elif wire_type == _WT_SGROUP:
        while True:
            key, pos = _read_varint(buf, pos)
            f, wt = key >> 3, key & 7
            if wt == _WT_EGROUP:
                if f != field:
                    raise DecodeError("mismatched end-group")
                return pos
            pos = _skip(buf, pos, f, wt)
    else:
        raise DecodeError(f"bad wire type {wire_type}")
    if end > len(buf):
        raise DecodeError("truncated field")
    return end


def _fields(buf: bytes):
    """Yield (field, wire_type, value_start) for each field. A known
    field number with another wire type than its own is an unknown field,
    as protobuf treats it."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if field == 0:
            raise DecodeError("field number 0")
        end = _skip(buf, pos, field, wt)
        yield field, wt, pos
        pos = end


def _string(buf: bytes, start: int) -> str:
    n, start = _read_varint(buf, start)
    try:
        return buf[start:start + n].decode("utf-8")
    except UnicodeDecodeError as e:
        raise DecodeError(f"string field is not utf-8: {e}") from None


def _submessage(buf: bytes, start: int) -> bytes:
    n, start = _read_varint(buf, start)
    return buf[start:start + n]


def _scalar(buf: bytes, start: int) -> int:
    return _read_varint(buf, start)[0]


# ---------------------------------------------------------------- meta

@dataclass
class RpcRequestMeta:
    service_name: str = ""
    method_name: str = ""
    log_id: int = 0
    timeout_ms: int = 0
    # the client's credential (rpc/auth.py), on every request
    auth_token: str = ""
    priority: int = 0

    def encode(self) -> bytes:
        out = b""
        if self.service_name:
            out += _len_field(1, self.service_name.encode("utf-8"))
        if self.method_name:
            out += _len_field(2, self.method_name.encode("utf-8"))
        if self.log_id:
            out += _key(3, _WT_VARINT) + _varint(self.log_id)
        if self.timeout_ms:
            out += _key(4, _WT_VARINT) + _varint(self.timeout_ms)
        if self.auth_token:
            out += _len_field(5, self.auth_token.encode("utf-8"))
        if self.priority:
            out += _key(6, _WT_VARINT) + _varint(self.priority)
        return out

    @classmethod
    def decode(cls, buf: bytes) -> "RpcRequestMeta":
        m = cls()
        for f, wt, s in _fields(buf):
            if (f, wt) == (1, _WT_LEN):
                m.service_name = _string(buf, s)
            elif (f, wt) == (2, _WT_LEN):
                m.method_name = _string(buf, s)
            elif (f, wt) == (3, _WT_VARINT):
                m.log_id = _as_int64(_scalar(buf, s))
            elif (f, wt) == (4, _WT_VARINT):
                m.timeout_ms = _as_int64(_scalar(buf, s))
            elif (f, wt) == (5, _WT_LEN):
                m.auth_token = _string(buf, s)
            elif (f, wt) == (6, _WT_VARINT):
                m.priority = _as_int32(_scalar(buf, s))
        return m


@dataclass
class RpcResponseMeta:
    error_code: int = 0
    error_text: str = ""
    # an overloaded server's admission threshold (rpc/admission.py); 0
    # while calm, and then off the wire
    admission_threshold: int = 0

    def encode(self) -> bytes:
        out = b""
        if self.error_code:
            out += _key(1, _WT_VARINT) + _varint(self.error_code)
        if self.error_text:
            out += _len_field(2, self.error_text.encode("utf-8"))
        if self.admission_threshold:
            out += _key(3, _WT_VARINT) + _varint(self.admission_threshold)
        return out

    @classmethod
    def decode(cls, buf: bytes) -> "RpcResponseMeta":
        m = cls()
        for f, wt, s in _fields(buf):
            if (f, wt) == (1, _WT_VARINT):
                m.error_code = _as_int32(_scalar(buf, s))
            elif (f, wt) == (2, _WT_LEN):
                m.error_text = _string(buf, s)
            elif (f, wt) == (3, _WT_VARINT):
                m.admission_threshold = _as_int32(_scalar(buf, s))
        return m


@dataclass
class StreamSettings:
    """Stream setup on a request or response, and the header of a bare
    stream frame (tpu_rpc_meta.proto:51-57). ``frame_seq`` is nonzero on
    DATA frames only; ``credits`` grants send budget back to the peer."""
    stream_id: int = 0
    need_feedback: bool = False
    frame_seq: int = 0
    credits: int = 0
    close: bool = False

    def encode(self) -> bytes:
        out = b""
        if self.stream_id:
            out += b"\x08" + _varint(self.stream_id)
        if self.need_feedback:
            out += b"\x10\x01"
        if self.frame_seq:
            out += b"\x18" + _varint(self.frame_seq)
        if self.credits:
            out += b"\x20" + _varint(self.credits)
        if self.close:
            out += b"\x28\x01"
        return out

    @classmethod
    def decode(cls, buf: bytes) -> "StreamSettings":
        m = cls()
        for f, wt, s in _fields(buf):
            if wt != _WT_VARINT:
                continue
            if f == 1:
                m.stream_id = _scalar(buf, s)
            elif f == 2:
                m.need_feedback = _scalar(buf, s) != 0
            elif f == 3:
                m.frame_seq = _scalar(buf, s)
            elif f == 4:
                m.credits = _as_int32(_scalar(buf, s))
            elif f == 5:
                m.close = _scalar(buf, s) != 0
        return m


@dataclass
class DevicePayloadMeta:
    """One tensor of a frame (tpu_rpc_meta.proto:59-64): its dtype's wire
    name, its shape, whether its bytes are in the attachment, and their
    count."""
    dtype: str = ""
    shape: Tuple[int, ...] = ()
    inline_bytes: bool = False
    nbytes: int = 0

    def encode(self) -> bytes:
        out = b""
        if self.dtype:
            out += _len_field(1, self.dtype.encode("utf-8"))
        if self.shape:
            out += _len_field(2, b"".join(_varint(d) for d in self.shape))
        if self.inline_bytes:
            out += b"\x18\x01"
        if self.nbytes:
            out += _key(4, _WT_VARINT) + _varint(self.nbytes)
        return out

    @classmethod
    def decode(cls, buf: bytes) -> "DevicePayloadMeta":
        m = cls()
        shape: List[int] = []
        for f, wt, s in _fields(buf):
            if (f, wt) == (1, _WT_LEN):
                m.dtype = _string(buf, s)
            elif (f, wt) == (2, _WT_LEN):      # packed
                packed = _submessage(buf, s)
                pos = 0
                while pos < len(packed):
                    v, pos = _read_varint(packed, pos)
                    shape.append(_as_int64(v))
            elif (f, wt) == (2, _WT_VARINT):   # unpacked
                shape.append(_as_int64(_scalar(buf, s)))
            elif (f, wt) == (3, _WT_VARINT):
                m.inline_bytes = _scalar(buf, s) != 0
            elif (f, wt) == (4, _WT_VARINT):
                m.nbytes = _as_int64(_scalar(buf, s))
        m.shape = tuple(shape)
        return m

    @classmethod
    def of(cls, t, inline: bool) -> "DevicePayloadMeta":
        from brpc_tpu_torch.butil import tensor_bytes
        return cls(tensor_bytes.dtype_name(t), tuple(int(d) for d in t.shape),
                   inline, tensor_bytes.nbytes(t))


@dataclass
class RpcMeta:
    request: Optional[RpcRequestMeta] = None
    response: Optional[RpcResponseMeta] = None
    # the payload's codec (rpc/compress.py); 0: none
    compress_type: int = 0
    correlation_id: int = 0
    attachment_size: int = 0
    stream_settings: Optional[StreamSettings] = None
    trace_id: int = 0
    span_id: int = 0
    parent_span_id: int = 0
    device_payloads: List[DevicePayloadMeta] = field(default_factory=list)

    def encode(self) -> bytes:
        out = b""
        if self.request is not None:
            out += _len_field(1, self.request.encode())
        if self.response is not None:
            out += _len_field(2, self.response.encode())
        if self.compress_type:
            out += _key(3, _WT_VARINT) + _varint(self.compress_type)
        if self.correlation_id:
            out += _key(4, _WT_VARINT) + _varint(self.correlation_id)
        if self.attachment_size:
            out += _key(5, _WT_VARINT) + _varint(self.attachment_size)
        if self.stream_settings is not None:
            out += _len_field(6, self.stream_settings.encode())
        for dp in self.device_payloads:
            out += _len_field(7, dp.encode())
        if self.trace_id:
            out += _key(8, _WT_VARINT) + _varint(self.trace_id)
        if self.span_id:
            out += _key(9, _WT_VARINT) + _varint(self.span_id)
        if self.parent_span_id:
            out += _key(10, _WT_VARINT) + _varint(self.parent_span_id)
        return out

    def is_stream_frame(self) -> bool:
        """A bare stream frame: stream settings and nothing of a call."""
        return (self.stream_settings is not None and self.request is None
                and self.response is None and not self.correlation_id)

    @classmethod
    def decode(cls, buf: bytes) -> "RpcMeta":
        m = cls()
        for f, wt, s in _fields(buf):
            if (f, wt) == (1, _WT_LEN):
                m.request = RpcRequestMeta.decode(_submessage(buf, s))
            elif (f, wt) == (2, _WT_LEN):
                m.response = RpcResponseMeta.decode(_submessage(buf, s))
            elif (f, wt) == (3, _WT_VARINT):
                m.compress_type = _as_int32(_scalar(buf, s))
            elif (f, wt) == (4, _WT_VARINT):
                m.correlation_id = _scalar(buf, s)
            elif (f, wt) == (5, _WT_VARINT):
                m.attachment_size = _as_int32(_scalar(buf, s))
            elif (f, wt) == (6, _WT_LEN):
                m.stream_settings = StreamSettings.decode(
                    _submessage(buf, s))
            elif (f, wt) == (7, _WT_LEN):
                m.device_payloads.append(
                    DevicePayloadMeta.decode(_submessage(buf, s)))
            elif (f, wt) == (8, _WT_VARINT):
                m.trace_id = _scalar(buf, s)
            elif (f, wt) == (9, _WT_VARINT):
                m.span_id = _scalar(buf, s)
            elif (f, wt) == (10, _WT_VARINT):
                m.parent_span_id = _scalar(buf, s)
        return m


# --------------------------------------------------------------- frames

def pack_small_frame(meta_prefix: bytes, cid: int, payload: bytes,
                     attachment: bytes = b"",
                     magic: bytes = MAGIC) -> bytes:
    """A frame from an already-encoded constant meta prefix plus the
    per-call correlation_id and attachment_size (brpc_tpu's small-call
    fast path; the same bytes as encoding the whole meta): fastcore's
    ``pack_frame`` when it loads, ``_py_pack_small_frame`` else."""
    fc = _fc if _fc is not False else _resolve_fc()
    if fc is not None:
        return fc.pack_frame(magic, meta_prefix, cid, payload, attachment)
    return _py_pack_small_frame(meta_prefix, cid, payload, attachment,
                                magic)


def _py_pack_small_frame(meta_prefix: bytes, cid: int, payload: bytes,
                         attachment: bytes = b"",
                         magic: bytes = MAGIC) -> bytes:
    meta = meta_prefix + bytes((_TAG_CORRELATION_ID,)) + _varint(cid)
    if attachment:
        meta += bytes((_TAG_ATTACHMENT_SIZE,)) + _varint(len(attachment))
    body = len(meta) + len(payload) + len(attachment)
    return b"".join((_HDR.pack(magic, body, len(meta)), meta, payload,
                     attachment))


def pack_frame_head(meta_prefix: bytes, cid: int, att_size: int,
                    tail_len: int, magic: bytes = MAGIC) -> bytes:
    """Header and meta of a frame whose payload (``tail_len`` bytes) and
    attachment (``att_size``) follow as separate buffers: fastcore's
    ``pack_frame_head``, or ``_py_pack_frame_head``."""
    fc = _fc if _fc is not False else _resolve_fc()
    if fc is not None:
        return fc.pack_frame_head(magic, meta_prefix, cid, att_size,
                                  tail_len)
    return _py_pack_frame_head(meta_prefix, cid, att_size, tail_len, magic)


def _py_pack_frame_head(meta_prefix: bytes, cid: int, att_size: int,
                        tail_len: int, magic: bytes = MAGIC) -> bytes:
    meta = meta_prefix + bytes((_TAG_CORRELATION_ID,)) + _varint(cid)
    if att_size:
        meta += bytes((_TAG_ATTACHMENT_SIZE,)) + _varint(att_size)
    return _HDR.pack(magic, len(meta) + tail_len + att_size,
                     len(meta)) + meta


def request_meta_prefix(request: RpcRequestMeta,
                        compress_type: int = 0) -> bytes:
    """The meta's part before the correlation id for a call with no
    stream, tensors or trace: ``pack_small_frame`` appends the rest."""
    out = _len_field(1, request.encode())
    if compress_type:
        out += _key(3, _WT_VARINT) + _varint(compress_type)
    return out


def pack_stream_frame(peer_id: int, seq: int = 0, credits: int = 0,
                      close: bool = False, payload: bytes = b"") -> bytes:
    """A bare stream frame to the peer's stream ``peer_id``: its meta is
    ``stream_settings`` alone, encoded by hand (the same bytes as
    brpc_tpu's fast pack and as ``RpcMeta.SerializeToString()``)."""
    inner = StreamSettings(peer_id, False, seq, credits, close).encode()
    meta = b"\x32" + _varint(len(inner)) + inner
    return b"".join((_HDR.pack(MAGIC, len(meta) + len(payload), len(meta)),
                     meta, payload))


def pack_frame(meta: RpcMeta, payload: bytes = b"",
               attachment: bytes = b"", device_arrays=None,
               device_lane: bool = False,
               magic: bytes = MAGIC) -> Tuple[bytes, Optional[List]]:
    """``(wire, lane)``: the frame's bytes, and the tensors that must ride
    the device lane right before it (None when none do). Without
    ``device_lane`` every tensor is copied to the host and its bytes go
    at the front of the attachment, ahead of ``attachment``
    (brpc_tpu/protocol/tpu_std.py:179-225). ``magic``: the header's
    (hulu_pbrpc frames with its own)."""
    lane = None
    if device_arrays:
        # torch only for calls that carry tensors: a process that sends
        # none never imports it
        from brpc_tpu_torch.butil import tensor_bytes
        meta.device_payloads = [
            DevicePayloadMeta.of(tensor_bytes.check_tensor(t),
                                 not device_lane)
            for t in device_arrays]
        if device_lane:
            lane = list(device_arrays)
        else:
            attachment = b"".join(
                [tensor_bytes.host_bytes(t) for t in device_arrays]
                + [bytes(attachment)])
    meta.attachment_size = len(attachment)
    meta_bytes = meta.encode()
    body = len(meta_bytes) + len(payload) + len(attachment)
    return b"".join((_HDR.pack(magic, body, len(meta_bytes)), meta_bytes,
                     payload, attachment)), lane


def parse_header(head: bytes, want: bytes = MAGIC) -> Tuple[int, int]:
    """(body_size, meta_size) of a 12-byte header; raises on a magic
    other than ``want`` or an impossible size."""
    magic, body_size, meta_size = _HDR.unpack(head)
    if magic != want:
        raise DecodeError(f"bad magic {magic!r}")
    if meta_size > body_size or body_size > MAX_BODY_SIZE:
        raise DecodeError(f"bad sizes body={body_size} meta={meta_size}")
    return body_size, meta_size


def unpack_body(body: bytes, meta_size: int
                ) -> Tuple[RpcMeta, bytes, bytes]:
    """Split a frame body into (meta, payload, attachment)."""
    meta = RpcMeta.decode(body[:meta_size])
    att = meta.attachment_size
    if att < 0 or meta_size + att > len(body):
        raise DecodeError(f"attachment_size {att} exceeds body")
    return (meta, body[meta_size:len(body) - att],
            body[len(body) - att:] if att else b"")


# ------------------------------------------------------------ protocol

class RpcMessage:
    """One parsed tpu_std frame; ``arrival_ns`` is its cut time and
    ``device_arrays`` the batch its lane delivered (inline tensors stay
    in the attachment until ``unpack_inline_device_arrays``)."""

    __slots__ = ("meta", "payload", "attachment", "device_arrays",
                 "arrival_ns", "device_recv")

    def __init__(self, meta: RpcMeta, payload: bytes, attachment: bytes,
                 device_arrays: Optional[List] = None,
                 device_recv: Optional[dict] = None):
        self.meta = meta
        self.payload = payload
        self.attachment = attachment
        self.device_arrays = device_arrays or []
        self.arrival_ns = time.monotonic_ns()
        # the socket's record of the lane take (rpcz on): dispatch hangs
        # a device-recv child span off the call's span with it
        self.device_recv = device_recv

    @property
    def is_response(self) -> bool:
        """No user handler: pure completion work for the client."""
        return self.meta.request is None


def unpack_inline_device_arrays(msg: RpcMessage) -> List:
    """The inline tensors of ``msg`` on the host, cut off the front of
    its attachment (which keeps the user attachment); None in the place
    of each lane tensor (brpc_tpu/protocol/tpu_std.py:235-246)."""
    from brpc_tpu_torch.butil import tensor_bytes
    out: List = []
    att = msg.attachment
    pos = 0
    for dp in msg.meta.device_payloads:
        if not dp.inline_bytes:
            out.append(None)
            continue
        if dp.nbytes < 0 or pos + dp.nbytes > len(att):
            raise DecodeError(f"inline payload of {dp.nbytes} bytes "
                              "exceeds the attachment")
        out.append(tensor_bytes.from_host_bytes(
            att, dp.dtype, dp.shape, "cpu", offset=pos, count=dp.nbytes))
        pos += dp.nbytes
    msg.attachment = att[pos:]
    return out


def merge_device_arrays(msg: RpcMessage) -> List:
    """A frame's tensors in meta order: inline ones from the attachment,
    lane ones from the lane batch, in turn. A lane batch of another
    length than the meta describes raises: the pairing is lost."""
    inline = unpack_inline_device_arrays(msg)
    want = sum(not dp.inline_bytes for dp in msg.meta.device_payloads)
    if len(msg.device_arrays) != want:
        raise DecodeError(f"lane batch of {len(msg.device_arrays)} tensors "
                          f"for a frame that describes {want}")
    lane = iter(msg.device_arrays)
    return [t if dp.inline_bytes else next(lane)
            for dp, t in zip(msg.meta.device_payloads, inline)]


# records the turbo lane cut
nscan_records = Adder().expose("tpu_std_scan_records")


def _probe_head(portal, magic: bytes = MAGIC):
    """``(body_size, meta_size)`` from fastcore's ``parse_head`` on the
    portal's head window, -1 for a definite disclaim, None when the
    probe cannot say (no extension, a window shorter than a header)."""
    fc = _fc if _fc is not False else _resolve_fc()
    if fc is None:
        return None
    win = portal.first_host_view()
    if win is None:
        return None
    try:
        r = fc.parse_head(win, magic)
    finally:
        win.release()
    if r is None or r == -1:
        return r
    return r[0], r[1]


class TpuStdProtocol(Protocol):
    name = "tpu_std"
    # a variant of the family re-magics it (protocol/pbrpc_variants.py)
    MAGIC = MAGIC
    min_probe_bytes = len(MAGIC)
    _scan_fn = False        # scan_frames, resolved at the first turbo scan
    _serve_fn = False       # serve_scan, at the first native_serve

    def frame(self, meta: RpcMeta, payload: bytes = b"",
              attachment: bytes = b"", device_arrays=None,
              device_lane: bool = False):
        """This family's framing (brpc_tpu/protocol/tpu_std.py:248-258):
        the Channel frames its requests and the server its responses
        with the protocol that parsed the request, so that a reply
        matches the request's framing."""
        return pack_frame(meta, payload, attachment, device_arrays,
                          device_lane, magic=self.MAGIC)

    def parse(self, portal, socket):
        magic = self.MAGIC
        sizes = _probe_head(portal, magic)
        if sizes == -1:
            # a mismatch is final even on a short window
            return PARSE_TRY_OTHERS, None
        if sizes is None:
            if portal.size < HEADER_SIZE:
                head = portal.peek_bytes(len(magic))
                return (PARSE_NOT_ENOUGH_DATA if magic.startswith(head)
                        else PARSE_TRY_OTHERS), None
            try:
                sizes = parse_header(portal.peek_bytes(HEADER_SIZE), magic)
            except DecodeError:
                # another magic, or sizes no frame has
                return PARSE_TRY_OTHERS, None
        body_size, meta_size = sizes
        if body_size > MAX_BODY_SIZE:
            # a body past MAX_BODY_SIZE would buffer toward bytes that
            # never come
            return PARSE_TRY_OTHERS, None
        if portal.size < HEADER_SIZE + body_size:
            # the input loop skips re-probing until the frame is here
            socket.input_need = HEADER_SIZE + body_size
            return PARSE_NOT_ENOUGH_DATA, None
        portal.pop_front(HEADER_SIZE)
        body = portal.cut(body_size).to_bytes()
        try:
            meta, payload, attachment = unpack_body(body, meta_size)
        except DecodeError as e:
            # a lying attachment_size would eat the next frame's bytes
            socket.set_failed(ConnectionError(f"bad frame: {e}"))
            return PARSE_NOT_ENOUGH_DATA, None
        lane = recv = None
        if any(not dp.inline_bytes for dp in meta.device_payloads):
            # the lane batch went out right before this frame
            lane, recv = socket.take_device_payload_with_recv()
        return PARSE_OK, RpcMessage(meta, payload, attachment, lane, recv)

    # -------------------------------------------------------- turbo lane
    def turbo_scan(self, portal, socket):
        """The records of every complete small frame at the portal's
        head, cut and meta-decoded in one ``scan_frames`` call, their
        payloads copied out before the pop; None when nothing was taken
        (no extension, a short window, a frame it defers first). The cut
        time of the run is left in ``socket.turbo_cut_ns``: a request
        that falls back to the classic body takes it as its arrival. A
        subclass keeps the classic path (its parse or process may differ,
        which the records would skip, and the scanner knows only the
        ``TRPC`` magic: a variant's frames are left to the classic
        path, brpc_tpu/protocol/tpu_std.py:360-362, :430)."""
        if type(self) is not TpuStdProtocol:
            return None
        scan = self._scan_fn
        if scan is False:
            fc = _fc if _fc is not False else _resolve_fc()
            scan = self._scan_fn = getattr(fc, "scan_frames", None)
        if scan is None:
            return None
        win = portal.first_host_view()
        if win is None:
            return None
        try:
            if len(win) < HEADER_SIZE:
                return None
            consumed, recs = scan(win, MAGIC, SMALL_FRAME_MAX, 128,
                                  STREAM_SCAN_MAX, 1)
        finally:
            win.release()
        if not recs:
            return None
        socket.turbo_cut_ns = time.monotonic_ns()
        portal.pop_front(consumed)
        nscan_records.add(len(recs))
        return recs

    def native_serve(self, portal, socket) -> bool:
        """Serve the portal's front run of small requests to the server's
        ``native="echo"`` method in C (``serve_scan``: parse, dispatch
        and the response frames in one call, one write). True when a
        batch was served."""
        if type(self) is not TpuStdProtocol:
            return False
        server = socket.user_data.get("server")
        if server is None or server._native_echo is None:
            return False
        serve = self._serve_fn
        if serve is False:
            fc = _fc if _fc is not False else _resolve_fc()
            serve = self._serve_fn = getattr(fc, "serve_scan", None)
        if serve is None:
            return False
        from brpc_tpu_torch.rpc.server_dispatch import (native_echo_target,
                                                        nserve_scan)
        tgt = native_echo_target(server)
        if tgt is None:
            return False
        win = portal.first_host_view()
        if win is None:
            return False
        t0 = time.monotonic_ns()
        try:
            if len(win) < HEADER_SIZE:
                return False
            consumed, out, n = serve(win, MAGIC, tgt[0], tgt[1],
                                     SMALL_FRAME_MAX)
        finally:
            win.release()
        if not n:
            return False
        portal.pop_front(consumed)
        socket.write(out)
        nserve_scan.add(n)
        server.account_native_batch(tgt[2], n,
                                    (time.monotonic_ns() - t0) / 1e3)
        return True

    def turbo_dispatch(self, recs, socket):
        """Dispatch ``turbo_scan`` records in parse order; returns the
        pending processing of a request that fell back to the classic
        body, as ``process`` does, for the caller to step."""
        from brpc_tpu_torch.rpc.client_dispatch import process_response_fast
        from brpc_tpu_torch.rpc.server_dispatch import process_request_fast
        from brpc_tpu_torch.rpc.stream import process_stream_frame_fast
        server = socket.user_data.get("server")
        cut_ns = getattr(socket, "turbo_cut_ns", 0)
        pending = []
        last = len(recs) - 1
        for i, rec in enumerate(recs):
            kind = rec[0]
            if kind == 1:
                process_response_fast(rec[1], rec[2], rec[3], rec[4],
                                      rec[5], socket)
            elif kind == 2:
                # order-critical: here, in parse order
                process_stream_frame_fast(rec[1], rec[2], rec[3], rec[4],
                                          rec[5], rec[6])
            else:
                r = process_request_fast(self, socket, server, rec[1],
                                         rec[2], rec[3], rec[4], rec[5],
                                         rec[6], is_last=(i == last),
                                         arrival_ns=cut_ns)
                if r is not None:
                    pending.append(r)
        if not pending:
            return None
        if len(pending) > 1:
            # earlier fallbacks get fibers of their own, the last steps
            # in place (the classic loop's rule)
            socket._control.spawn_many(pending[:-1],
                                       name="process_tpu_std")
        return pending[-1]

    def process(self, msg: RpcMessage, socket):
        if msg.meta.request is not None:
            from brpc_tpu_torch.rpc.server_dispatch import process_request
            return process_request(self, msg, socket)
        from brpc_tpu_torch.rpc.client_dispatch import process_response
        return process_response(self, msg, socket)

    def process_inline(self, msg: RpcMessage, socket) -> bool:
        """Bare stream frames go to their stream here, in parse order."""
        if msg.meta.is_stream_frame():
            from brpc_tpu_torch.rpc.stream import process_stream_frame
            process_stream_frame(msg)
            return True
        return False


_instance: Optional[TpuStdProtocol] = None


def ensure_registered() -> TpuStdProtocol:
    global _instance
    if _instance is None:
        _instance = TpuStdProtocol()
        register_protocol(_instance)
    return _instance
