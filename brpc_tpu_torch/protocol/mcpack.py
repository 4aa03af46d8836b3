"""mcpack: a typed, named-item pack format, and the nshead+mcpack
adaptor (the port of brpc_tpu/protocol/mcpack.py; bRPC's src/mcpack2pb/
and policy/nshead_mcpack_protocol.cpp).

Wire layout, the reference's own (v2-inspired, not byte-compatible with
legacy Baidu mcpack):

  item   := type:u8 name_len:u8 [name bytes (no NUL)] content
  OBJECT (0x10) / ARRAY (0x20): content = count:u32 items*
  STRING (0x50): content = len:u32 utf8 bytes
  BINARY (0x60): content = len:u32 raw bytes
  INT64  (0x11): content = i64 LE     UINT64 (0x12): u64 LE
  DOUBLE (0x13): content = f64 LE     BOOL   (0x14): u8
  NULL   (0x15): no content

Array elements have name_len 0; the top level is an unnamed OBJECT.
Nesting past 64 and a count past 2**24 are refused, and so are bytes
after the top level's end.

The port has no protobuf bridge (the reference's ``pb_to_mcpack`` and
``mcpack_to_pb`` walk message descriptors): its methods take and return
bytes, so the adaptor hands a method the request's binary as bytes and a
map as a dict, as the reference does for a method without a request
class.
"""

from __future__ import annotations

import inspect
import struct
from typing import Any, Dict, List, Tuple

OBJECT = 0x10
ARRAY = 0x20
STRING = 0x50
BINARY = 0x60
INT64 = 0x11
UINT64 = 0x12
DOUBLE = 0x13
BOOL = 0x14
NULL = 0x15

_MAX_DEPTH = 64
_MAX_COUNT = 1 << 24
_U32 = struct.Struct("<I")
_I64 = struct.Struct("<q")
_Q64 = struct.Struct("<Q")
_F64 = struct.Struct("<d")


class McpackError(Exception):
    pass


# ----------------------------------------------------------------- encode

def _encode_item(name: bytes, v, depth: int) -> bytes:
    if depth > _MAX_DEPTH:
        raise McpackError("nesting too deep")
    if len(name) > 255:
        raise McpackError("name too long")
    tail = bytes([len(name)]) + name
    if isinstance(v, bool):
        return bytes([BOOL]) + tail + (b"\x01" if v else b"\x00")
    if isinstance(v, int):
        if -(1 << 63) <= v < (1 << 63):
            return bytes([INT64]) + tail + _I64.pack(v)
        if 0 <= v < (1 << 64):
            return bytes([UINT64]) + tail + _Q64.pack(v)
        raise McpackError("integer out of 64-bit range")
    if isinstance(v, float):
        return bytes([DOUBLE]) + tail + _F64.pack(v)
    if isinstance(v, str):
        b = v.encode()
        return bytes([STRING]) + tail + _U32.pack(len(b)) + b
    if isinstance(v, (bytes, bytearray, memoryview)):
        b = bytes(v)
        return bytes([BINARY]) + tail + _U32.pack(len(b)) + b
    if v is None:
        return bytes([NULL]) + tail
    if isinstance(v, dict):
        items = b"".join(_encode_item(str(k).encode(), val, depth + 1)
                         for k, val in v.items())
        return bytes([OBJECT]) + tail + _U32.pack(len(v)) + items
    if isinstance(v, (list, tuple)):
        items = b"".join(_encode_item(b"", val, depth + 1) for val in v)
        return bytes([ARRAY]) + tail + _U32.pack(len(v)) + items
    raise McpackError(f"cannot encode {type(v)!r}")


def encode(doc: Dict[str, Any]) -> bytes:
    """A dict as the unnamed top-level OBJECT."""
    return _encode_item(b"", doc, 0)


# ----------------------------------------------------------------- decode

def _need(data: bytes, pos: int, n: int, what: str) -> None:
    if pos + n > len(data):
        raise McpackError(f"truncated {what}")


def _decode_item(data: bytes, pos: int, depth: int) -> Tuple[bytes, Any, int]:
    if depth > _MAX_DEPTH:
        raise McpackError("nesting too deep")
    _need(data, pos, 2, "item head")
    t = data[pos]
    name_len = data[pos + 1]
    pos += 2
    _need(data, pos, name_len, "name")
    name = data[pos:pos + name_len]
    pos += name_len
    if t == BOOL:
        _need(data, pos, 1, "bool")
        return name, data[pos] != 0, pos + 1
    if t in (INT64, UINT64, DOUBLE):
        _need(data, pos, 8, {INT64: "int64", UINT64: "uint64",
                             DOUBLE: "double"}[t])
        codec = {INT64: _I64, UINT64: _Q64, DOUBLE: _F64}[t]
        return name, codec.unpack_from(data, pos)[0], pos + 8
    if t == NULL:
        return name, None, pos
    if t in (STRING, BINARY):
        _need(data, pos, 4, "length")
        n = _U32.unpack_from(data, pos)[0]
        pos += 4
        if n > len(data) - pos:
            raise McpackError("truncated content")
        raw = data[pos:pos + n]
        return name, (raw.decode("utf-8", "replace") if t == STRING
                      else bytes(raw)), pos + n
    if t in (OBJECT, ARRAY):
        _need(data, pos, 4, "count")
        count = _U32.unpack_from(data, pos)[0]
        pos += 4
        if count > _MAX_COUNT:
            raise McpackError("bad count")
        if t == OBJECT:
            obj: Dict[str, Any] = {}
            for _ in range(count):
                n2, v, pos = _decode_item(data, pos, depth + 1)
                obj[n2.decode("utf-8", "replace")] = v
            return name, obj, pos
        arr: List[Any] = []
        for _ in range(count):
            _n, v, pos = _decode_item(data, pos, depth + 1)
            arr.append(v)
        return name, arr, pos
    raise McpackError(f"unknown type 0x{t:02x}")


def decode(data: bytes) -> Dict[str, Any]:
    _name, v, pos = _decode_item(bytes(data), 0, 0)
    if not isinstance(v, dict):
        raise McpackError("top level is not an object")
    if pos != len(data):
        raise McpackError(f"{len(data) - pos} trailing bytes")
    return v


# ------------------------------------------------- nshead_mcpack adaptor

def nshead_mcpack_adaptor(service):
    """Serve ``service`` over nshead+mcpack: the request body is
    ``{"method": str, "request": binary or map}``, the answer
    ``{"error_code", "error_text"}`` on a failure (1002: no such method,
    1003: a bad body, 2001: a handler error, else the Controller's code)
    or ``{"error_code": 0, "response": bytes, map or {}}``. Install as
    ``ServerOptions(nshead_service=nshead_mcpack_adaptor(svc))``."""
    from brpc_tpu_torch.protocol.nshead import adaptor_controller

    async def handler(socket, msg):
        try:
            doc = decode(msg.body)
            method = service.methods.get(str(doc.get("method", "")))
            if method is None:
                return encode({"error_code": 1002,
                               "error_text": f"unknown method "
                                             f"{doc.get('method')!r}"})
            request = doc.get("request", {})
            if isinstance(request, bytearray):
                request = bytes(request)
            cntl = adaptor_controller(socket, service, method)
            r = method.handler(cntl, request)
            if inspect.isawaitable(r):
                r = await r
            if cntl.failed():
                return encode({"error_code": cntl.error_code,
                               "error_text": cntl.error_text})
            if isinstance(r, (bytes, bytearray, memoryview)):
                r = bytes(r)
            return encode({"error_code": 0,
                           "response": r if r is not None else {}})
        except McpackError as e:
            return encode({"error_code": 1003,
                           "error_text": f"bad mcpack request: {e}"})
        except Exception as e:          # boundary: report, keep serving
            return encode({"error_code": 2001,
                           "error_text": f"handler error: {e}"})

    return handler
