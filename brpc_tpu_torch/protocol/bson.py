"""A BSON codec for the mongo adaptor (the port of
brpc_tpu/protocol/bson.py): the subset of types mongo commands use.

Python mapping: float (double), str (string), dict (document), list
(array), bytes (binary, subtype 0), ``ObjectId`` (12 raw bytes), bool,
``DateTimeMs`` (UTC datetime, ms since the epoch), None (null), int
(int32 when it fits, else int64); a timestamp (0x11) reads as an int.
Nesting past 64 is refused both ways; any malformed document raises
``BsonError``.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

_MAX_DEPTH = 64
_I32 = struct.Struct("<i")
_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")


class ObjectId:
    __slots__ = ("raw",)

    def __init__(self, raw: bytes):
        if len(raw) != 12:
            raise ValueError("ObjectId must be 12 bytes")
        self.raw = bytes(raw)

    def __eq__(self, other):
        return isinstance(other, ObjectId) and self.raw == other.raw

    def __hash__(self):
        return hash(self.raw)

    def __repr__(self):
        return f"ObjectId({self.raw.hex()})"


class DateTimeMs(int):
    """UTC datetime as milliseconds since the epoch (wire type 0x09)."""


class BsonError(ValueError):
    pass


def _encode_value(key: bytes, v, depth: int) -> bytes:
    if depth > _MAX_DEPTH:
        raise BsonError("document nesting too deep")
    head = key + b"\x00"
    if isinstance(v, float):
        return b"\x01" + head + _F64.pack(v)
    if isinstance(v, str):
        s = v.encode()
        return b"\x02" + head + _I32.pack(len(s) + 1) + s + b"\x00"
    if isinstance(v, dict):
        return b"\x03" + head + encode_doc(v, depth + 1)
    if isinstance(v, (list, tuple)):
        return b"\x04" + head + encode_doc(
            {str(i): x for i, x in enumerate(v)}, depth + 1)
    if isinstance(v, (bytes, bytearray, memoryview)):
        b = bytes(v)
        return b"\x05" + head + _I32.pack(len(b)) + b"\x00" + b
    if isinstance(v, ObjectId):
        return b"\x07" + head + v.raw
    if isinstance(v, bool):
        return b"\x08" + head + (b"\x01" if v else b"\x00")
    if isinstance(v, DateTimeMs):
        return b"\x09" + head + _I64.pack(int(v))
    if v is None:
        return b"\x0a" + head
    if isinstance(v, int):
        if -(1 << 31) <= v < (1 << 31):
            return b"\x10" + head + _I32.pack(v)
        return b"\x12" + head + _I64.pack(v)
    raise BsonError(f"cannot encode {type(v)!r}")


def encode_doc(doc: Dict[str, Any], depth: int = 0) -> bytes:
    body = b"".join(_encode_value(k.encode(), v, depth)
                    for k, v in doc.items())
    return _I32.pack(len(body) + 5) + body + b"\x00"


def _read_cstring(data: bytes, pos: int) -> Tuple[str, int]:
    end = data.find(b"\x00", pos)
    if end < 0:
        raise BsonError("unterminated cstring")
    return data[pos:end].decode("utf-8", "replace"), end + 1


def _fixed(data: bytes, pos: int, codec: struct.Struct):
    if pos + codec.size > len(data):
        raise BsonError("truncated value")
    return codec.unpack_from(data, pos)[0], pos + codec.size


def _array_index(key: str) -> int:
    try:
        return int(key) if key.isdigit() else 0
    except ValueError:                  # a digit int() does not take
        raise BsonError(f"bad array index {key!r}") from None


def _decode_value(t: int, data: bytes, pos: int, depth: int):
    if t == 0x01:
        return _fixed(data, pos, _F64)
    if t == 0x02:
        n, _ = _fixed(data, pos, _I32)
        if n < 1 or pos + 4 + n > len(data):
            raise BsonError("bad string length")
        return (data[pos + 4:pos + 4 + n - 1].decode("utf-8", "replace"),
                pos + 4 + n)
    if t == 0x03:
        return decode_doc(data, pos, depth + 1)
    if t == 0x04:
        doc, end = decode_doc(data, pos, depth + 1)
        return [doc[k] for k in sorted(doc, key=_array_index)], end
    if t == 0x05:
        n, _ = _fixed(data, pos, _I32)
        if n < 0 or pos + 5 + n > len(data):
            raise BsonError("bad binary length")
        return bytes(data[pos + 5:pos + 5 + n]), pos + 5 + n
    if t == 0x07:
        if pos + 12 > len(data):
            raise BsonError("truncated ObjectId")
        return ObjectId(data[pos:pos + 12]), pos + 12
    if t == 0x08:
        return data[pos:pos + 1] == b"\x01", pos + 1
    if t == 0x09:
        v, end = _fixed(data, pos, _I64)
        return DateTimeMs(v), end
    if t == 0x0a:
        return None, pos
    if t == 0x10:
        return _fixed(data, pos, _I32)
    if t in (0x11, 0x12):               # a timestamp reads as its int64
        return _fixed(data, pos, _I64)
    raise BsonError(f"unsupported bson type 0x{t:02x}")


def decode_doc(data: bytes, pos: int = 0, depth: int = 0
               ) -> Tuple[Dict[str, Any], int]:
    """One document at ``pos``: (doc, the position past it)."""
    if depth > _MAX_DEPTH:
        raise BsonError("document nesting too deep")
    if pos + 4 > len(data):
        raise BsonError("truncated document")
    size = _I32.unpack_from(data, pos)[0]
    if size < 5 or pos + size > len(data):
        raise BsonError("bad document size")
    end = pos + size
    cur = pos + 4
    out: Dict[str, Any] = {}
    while cur < end - 1:
        t = data[cur]
        key, cur = _read_cstring(data, cur + 1)
        out[key], cur = _decode_value(t, data, cur, depth)
    if data[end - 1:end] != b"\x00":
        raise BsonError("document missing terminator")
    return out, end
