"""tpu_std framing for the unary path, with a hand-written RpcMeta codec.

Wire layout (the same bytes brpc_tpu puts on the wire):

    "TRPC" | body_size:u32be | meta_size:u32be | meta | payload | attachment

``body_size = meta_size + len(payload) + len(attachment)``. ``meta`` is a
proto3 ``RpcMeta`` (brpc_tpu/protocol/proto/tpu_rpc_meta.proto). The port
does not depend on ``google.protobuf``: this module encodes and decodes
the fields the unary path uses and reads past every other field, of any
wire type, so a brpc_tpu peer's trace ids (8-10), stream settings (6),
device payloads (7) or admission threshold are skipped, not rejected.

Encoding follows protobuf's own rules, so frames are byte-identical to
``RpcMeta.SerializeToString()``: fields in number order, proto3 scalars
omitted at their default, a sub-message present once set, and a
negative int32/int64 written as a 10-byte varint.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Optional, Tuple

MAGIC = b"TRPC"
HEADER_SIZE = 12
_HDR = struct.Struct(">4sII")
MAX_BODY_SIZE = 64 << 20

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
            elif (f, wt) == (6, _WT_VARINT):
                m.priority = _as_int32(_scalar(buf, s))
        return m


@dataclass
class RpcResponseMeta:
    error_code: int = 0
    error_text: str = ""

    def encode(self) -> bytes:
        out = b""
        if self.error_code:
            out += _key(1, _WT_VARINT) + _varint(self.error_code)
        if self.error_text:
            out += _len_field(2, self.error_text.encode("utf-8"))
        return out

    @classmethod
    def decode(cls, buf: bytes) -> "RpcResponseMeta":
        m = cls()
        for f, wt, s in _fields(buf):
            if (f, wt) == (1, _WT_VARINT):
                m.error_code = _as_int32(_scalar(buf, s))
            elif (f, wt) == (2, _WT_LEN):
                m.error_text = _string(buf, s)
        return m


@dataclass
class RpcMeta:
    request: Optional[RpcRequestMeta] = None
    response: Optional[RpcResponseMeta] = None
    correlation_id: int = 0
    attachment_size: int = 0

    def encode(self) -> bytes:
        out = b""
        if self.request is not None:
            out += _len_field(1, self.request.encode())
        if self.response is not None:
            out += _len_field(2, self.response.encode())
        if self.correlation_id:
            out += _key(4, _WT_VARINT) + _varint(self.correlation_id)
        if self.attachment_size:
            out += _key(5, _WT_VARINT) + _varint(self.attachment_size)
        return out

    @classmethod
    def decode(cls, buf: bytes) -> "RpcMeta":
        m = cls()
        for f, wt, s in _fields(buf):
            if (f, wt) == (1, _WT_LEN):
                m.request = RpcRequestMeta.decode(_submessage(buf, s))
            elif (f, wt) == (2, _WT_LEN):
                m.response = RpcResponseMeta.decode(_submessage(buf, s))
            elif (f, wt) == (4, _WT_VARINT):
                m.correlation_id = _scalar(buf, s)
            elif (f, wt) == (5, _WT_VARINT):
                m.attachment_size = _as_int32(_scalar(buf, s))
        return m


# --------------------------------------------------------------- frames

def pack_small_frame(meta_prefix: bytes, cid: int, payload: bytes,
                         attachment: bytes = b"",
                         magic: bytes = MAGIC) -> bytes:
    """A frame from an already-encoded constant meta prefix plus the
    per-call correlation_id and attachment_size (brpc_tpu's small-call
    fast path; the same bytes as encoding the whole meta)."""
    meta = meta_prefix + bytes((_TAG_CORRELATION_ID,)) + _varint(cid)
    if attachment:
        meta += bytes((_TAG_ATTACHMENT_SIZE,)) + _varint(len(attachment))
    body = len(meta) + len(payload) + len(attachment)
    return b"".join((_HDR.pack(magic, body, len(meta)), meta, payload,
                     attachment))


def pack_frame(meta: RpcMeta, payload: bytes = b"",
               attachment: bytes = b"") -> bytes:
    meta.attachment_size = len(attachment)
    meta_bytes = meta.encode()
    body = len(meta_bytes) + len(payload) + len(attachment)
    return b"".join((_HDR.pack(MAGIC, body, len(meta_bytes)), meta_bytes,
                     payload, attachment))


def parse_header(head: bytes) -> Tuple[int, int]:
    """(body_size, meta_size) of a 12-byte header; raises on a foreign
    magic or an impossible size."""
    magic, body_size, meta_size = _HDR.unpack(head)
    if magic != MAGIC:
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
