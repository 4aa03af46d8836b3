"""The AMF0 codec under RTMP's command and data messages, and AMF3's read
side (the port of brpc_tpu/protocol/amf.py; bRPC's amf.{h,cpp}).

Python mapping: float/int -> number, bool -> boolean, str -> string
(a long string past 64 KiB), dict -> object, ``AmfEcmaArray`` -> ECMA
array, list -> strict array, None -> null, ``Undefined`` -> undefined,
``AmfDate`` -> date (its timezone field written as 0). Nesting past 32
is refused both ways. The AMF0 switch marker (0x11) reads the next value
as AMF3 (``decode_amf3``: undefined, null, booleans, U29 integers,
doubles, strings, dates, arrays, objects with their traits and byte
arrays, with the string, object and traits reference tables). Any
malformed input raises ``AmfError``.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

_MAX_DEPTH = 32

# markers
_NUMBER = 0x00
_BOOLEAN = 0x01
_STRING = 0x02
_OBJECT = 0x03
_NULL = 0x05
_UNDEFINED = 0x06
_ECMA_ARRAY = 0x08
_OBJECT_END = 0x09
_STRICT_ARRAY = 0x0A
_DATE = 0x0B
_AVMPLUS = 0x11   # switch-to-AMF3 marker (objectEncoding 3)
_LONG_STRING = 0x0C


class Undefined:
    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return "amf.Undefined"


class AmfEcmaArray(dict):
    """dict subclass marking ECMA-array encoding."""


class AmfDate(float):
    """milliseconds since epoch (timezone field written as 0)."""


class AmfError(Exception):
    pass


# ----------------------------------------------------------------- encode

def _encode_utf8(s: str) -> bytes:
    b = s.encode("utf-8")
    if len(b) > 0xFFFF:
        raise AmfError("property name too long")
    return struct.pack(">H", len(b)) + b


def encode_value(v, depth: int = 0) -> bytes:
    if depth > _MAX_DEPTH:
        raise AmfError("AMF nesting too deep")
    if isinstance(v, Undefined):
        return bytes([_UNDEFINED])
    if v is None:
        return bytes([_NULL])
    if isinstance(v, bool):
        return bytes([_BOOLEAN, 1 if v else 0])
    if isinstance(v, AmfDate):
        return bytes([_DATE]) + struct.pack(">dH", float(v), 0)
    if isinstance(v, (int, float)):
        return bytes([_NUMBER]) + struct.pack(">d", float(v))
    if isinstance(v, str):
        b = v.encode("utf-8")
        if len(b) > 0xFFFF:
            return bytes([_LONG_STRING]) + struct.pack(">I", len(b)) + b
        return bytes([_STRING]) + struct.pack(">H", len(b)) + b
    if isinstance(v, AmfEcmaArray):
        out = [bytes([_ECMA_ARRAY]), struct.pack(">I", len(v))]
        for k, val in v.items():
            out.append(_encode_utf8(str(k)))
            out.append(encode_value(val, depth + 1))
        out.append(b"\x00\x00" + bytes([_OBJECT_END]))
        return b"".join(out)
    if isinstance(v, dict):
        out = [bytes([_OBJECT])]
        for k, val in v.items():
            out.append(_encode_utf8(str(k)))
            out.append(encode_value(val, depth + 1))
        out.append(b"\x00\x00" + bytes([_OBJECT_END]))
        return b"".join(out)
    if isinstance(v, (list, tuple)):
        out = [bytes([_STRICT_ARRAY]), struct.pack(">I", len(v))]
        for val in v:
            out.append(encode_value(val, depth + 1))
        return b"".join(out)
    raise AmfError(f"cannot encode {type(v)!r}")


def encode_values(*values) -> bytes:
    return b"".join(encode_value(v) for v in values)


# ----------------------------------------------------------------- decode

def _read_utf8(data: bytes, pos: int) -> Tuple[str, int]:
    if pos + 2 > len(data):
        raise AmfError("truncated name")
    n = struct.unpack_from(">H", data, pos)[0]
    if pos + 2 + n > len(data):
        raise AmfError("truncated name body")
    return data[pos + 2:pos + 2 + n].decode("utf-8", "replace"), pos + 2 + n


def decode_value(data: bytes, pos: int = 0, depth: int = 0) -> Tuple[Any, int]:
    if depth > _MAX_DEPTH:
        raise AmfError("AMF nesting too deep")
    if pos >= len(data):
        raise AmfError("truncated value")
    marker = data[pos]
    pos += 1
    if marker == _NUMBER:
        if pos + 8 > len(data):
            raise AmfError("truncated number")
        return struct.unpack_from(">d", data, pos)[0], pos + 8
    if marker == _BOOLEAN:
        if pos + 1 > len(data):
            raise AmfError("truncated boolean")
        return data[pos] != 0, pos + 1
    if marker == _STRING:
        return _read_utf8(data, pos)
    if marker == _LONG_STRING:
        if pos + 4 > len(data):
            raise AmfError("truncated long string")
        n = struct.unpack_from(">I", data, pos)[0]
        if pos + 4 + n > len(data):
            raise AmfError("truncated long string body")
        return data[pos + 4:pos + 4 + n].decode("utf-8", "replace"), \
            pos + 4 + n
    if marker in (_OBJECT, _ECMA_ARRAY):
        out: Dict[str, Any] = AmfEcmaArray() if marker == _ECMA_ARRAY else {}
        if marker == _ECMA_ARRAY:
            if pos + 4 > len(data):
                raise AmfError("truncated ecma array")
            pos += 4   # associative count is advisory
        while True:
            name, pos = _read_utf8(data, pos)
            if name == "" and pos < len(data) and data[pos] == _OBJECT_END:
                return out, pos + 1
            out[name], pos = decode_value(data, pos, depth + 1)
    if marker == _NULL:
        return None, pos
    if marker == _UNDEFINED:
        return Undefined(), pos
    if marker == _STRICT_ARRAY:
        if pos + 4 > len(data):
            raise AmfError("truncated strict array")
        n = struct.unpack_from(">I", data, pos)[0]
        if n > len(data):        # each element is >=1 byte
            raise AmfError("bad strict array length")
        pos += 4
        out_l: List[Any] = []
        for _ in range(n):
            v, pos = decode_value(data, pos, depth + 1)
            out_l.append(v)
        return out_l, pos
    if marker == _DATE:
        if pos + 10 > len(data):
            raise AmfError("truncated date")
        ms = struct.unpack_from(">d", data, pos)[0]
        return AmfDate(ms), pos + 10
    if marker == _AVMPLUS:
        # AMF0 -> AMF3 switch (objectEncoding 3 peers): the next value
        # is AMF3-encoded
        return decode_amf3(data, pos)
    raise AmfError(f"unsupported AMF0 marker 0x{marker:02x}")


def decode_all(data: bytes) -> List[Any]:
    out = []
    pos = 0
    while pos < len(data):
        v, pos = decode_value(data, pos)
        out.append(v)
    return out


# ------------------------------------------------------------------ AMF3
# Read-side AMF3 (bRPC's amf.cpp, its AMF3 half): enough of the
# format to decode what objectEncoding-3 encoders actually emit —
# undefined/null/bool/integer(U29)/double/string/date/array/object/
# bytearray, with the string/complex-object reference tables.

_A3_UNDEFINED = 0x00
_A3_NULL = 0x01
_A3_FALSE = 0x02
_A3_TRUE = 0x03
_A3_INTEGER = 0x04
_A3_DOUBLE = 0x05
_A3_STRING = 0x06
_A3_DATE = 0x08
_A3_ARRAY = 0x09
_A3_OBJECT = 0x0A
_A3_BYTEARRAY = 0x0C


class _Amf3Ctx:
    __slots__ = ("strings", "complexes", "traits")

    def __init__(self):
        self.strings: List[str] = []
        self.complexes: List[Any] = []
        self.traits: List[tuple] = []


def _read_u29(data: bytes, pos: int) -> Tuple[int, int]:
    v = 0
    for i in range(4):
        if pos >= len(data):
            raise AmfError("truncated U29")
        b = data[pos]
        pos += 1
        if i < 3:
            v = (v << 7) | (b & 0x7F)
            if not b & 0x80:
                return v, pos
        else:
            return (v << 8) | b, pos
    raise AmfError("unreachable U29")


def _read_a3_string(data: bytes, pos: int, ctx: _Amf3Ctx) -> Tuple[str, int]:
    ref, pos = _read_u29(data, pos)
    if not ref & 1:
        idx = ref >> 1
        if idx >= len(ctx.strings):
            raise AmfError("AMF3 string reference out of range")
        return ctx.strings[idx], pos
    n = ref >> 1
    if pos + n > len(data):
        raise AmfError("truncated AMF3 string")
    s = data[pos:pos + n].decode("utf-8", "replace")
    if s:                      # the empty string is never table-stored
        ctx.strings.append(s)
    return s, pos + n


def decode_amf3(data: bytes, pos: int = 0, ctx: Optional[_Amf3Ctx] = None,
                depth: int = 0) -> Tuple[Any, int]:
    if ctx is None:
        ctx = _Amf3Ctx()
    if depth > _MAX_DEPTH:
        raise AmfError("AMF3 nesting too deep")
    if pos >= len(data):
        raise AmfError("truncated AMF3 value")
    marker = data[pos]
    pos += 1
    if marker == _A3_UNDEFINED:
        return Undefined(), pos
    if marker == _A3_NULL:
        return None, pos
    if marker == _A3_FALSE:
        return False, pos
    if marker == _A3_TRUE:
        return True, pos
    if marker == _A3_INTEGER:
        v, pos = _read_u29(data, pos)
        if v & 0x10000000:      # 29-bit two's complement
            v -= 0x20000000
        return v, pos
    if marker == _A3_DOUBLE:
        if pos + 8 > len(data):
            raise AmfError("truncated AMF3 double")
        return struct.unpack_from(">d", data, pos)[0], pos + 8
    if marker == _A3_STRING:
        return _read_a3_string(data, pos, ctx)
    if marker == _A3_DATE:
        ref, pos = _read_u29(data, pos)
        if not ref & 1:
            idx = ref >> 1
            if idx >= len(ctx.complexes):
                raise AmfError("AMF3 date reference out of range")
            return ctx.complexes[idx], pos
        if pos + 8 > len(data):
            raise AmfError("truncated AMF3 date")
        d = AmfDate(struct.unpack_from(">d", data, pos)[0])
        ctx.complexes.append(d)
        return d, pos + 8
    if marker == _A3_ARRAY:
        ref, pos = _read_u29(data, pos)
        if not ref & 1:
            idx = ref >> 1
            if idx >= len(ctx.complexes):
                raise AmfError("AMF3 array reference out of range")
            return ctx.complexes[idx], pos
        dense_n = ref >> 1
        # associative part first (name/value pairs until empty name)
        assoc: Dict[str, Any] = {}
        while True:
            name, pos = _read_a3_string(data, pos, ctx)
            if name == "":
                break
            assoc[name], pos = decode_amf3(data, pos, ctx, depth + 1)
        dense: List[Any] = []
        result: Any = assoc if assoc else dense
        ctx.complexes.append(result)
        for _ in range(dense_n):
            v, pos = decode_amf3(data, pos, ctx, depth + 1)
            dense.append(v)
        if assoc and dense:
            # mixed array: dense part lands under numeric keys
            for i, v in enumerate(dense):
                assoc[str(i)] = v
        return result, pos
    if marker == _A3_OBJECT:
        ref, pos = _read_u29(data, pos)
        if not ref & 1:
            idx = ref >> 1
            if idx >= len(ctx.complexes):
                raise AmfError("AMF3 object reference out of range")
            return ctx.complexes[idx], pos
        if not ref & 2:         # traits reference
            t_idx = ref >> 2
            if t_idx >= len(ctx.traits):
                raise AmfError("AMF3 traits reference out of range")
            class_name, sealed, dynamic = ctx.traits[t_idx]
        elif ref & 4:
            raise AmfError("AMF3 externalizable objects unsupported")
        else:
            dynamic = bool(ref & 8)
            sealed_n = ref >> 4
            class_name, pos = _read_a3_string(data, pos, ctx)
            sealed = []
            for _ in range(sealed_n):
                nm, pos = _read_a3_string(data, pos, ctx)
                sealed.append(nm)
            ctx.traits.append((class_name, sealed, dynamic))
        obj: Dict[str, Any] = {}
        ctx.complexes.append(obj)
        for nm in sealed:
            obj[nm], pos = decode_amf3(data, pos, ctx, depth + 1)
        if dynamic:
            while True:
                nm, pos = _read_a3_string(data, pos, ctx)
                if nm == "":
                    break
                obj[nm], pos = decode_amf3(data, pos, ctx, depth + 1)
        return obj, pos
    if marker == _A3_BYTEARRAY:
        ref, pos = _read_u29(data, pos)
        if not ref & 1:
            idx = ref >> 1
            if idx >= len(ctx.complexes):
                raise AmfError("AMF3 bytearray reference out of range")
            return ctx.complexes[idx], pos
        n = ref >> 1
        if pos + n > len(data):
            raise AmfError("truncated AMF3 bytearray")
        b = data[pos:pos + n]
        ctx.complexes.append(b)
        return b, pos + n
    raise AmfError(f"unsupported AMF3 marker 0x{marker:02x}")


def decode_all_amf3(data: bytes) -> List[Any]:
    ctx = _Amf3Ctx()
    out = []
    pos = 0
    while pos < len(data):
        v, pos = decode_amf3(data, pos, ctx)
        out.append(v)
    return out
