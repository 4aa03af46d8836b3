"""public_pbrpc's envelope: a hand-written proto2 codec of the six
messages of brpc_tpu/protocol/proto/public_pbrpc_meta.proto (bRPC's
policy/public_pbrpc_meta.proto). The field layout is the wire format,
and the machine with the card has no protobuf, so the port codes it as
it codes tpu_std's ``RpcMeta``, on the same varint helpers.

The proto2 rules kept:

- a field has presence: one that was set is written, even at its
  default; fields are written in field-number order;
- ``ResponseHead.code`` is ``sint32`` (zigzag) and ``ResponseBody.error``
  ``int32``, so a negative error takes ten bytes;
- an unknown field, or a known one under another wire type, is skipped;
  a singular message field seen twice is merged; a string that is not
  UTF-8 reads as its bytes;
- a tag over five bytes or 32 bits, field number 0, a bad wire type and
  a truncated value are refused.

``encode()`` refuses a message that lacks a ``required`` field
(``RequestBody``'s ``service``, ``method_id`` and ``id``;
``ResponseHead.code``; ``ResponseBody.id``), as protobuf's
``SerializeToString`` does, and so does ``decode()``, as bRPC's
``ParsePbFromIOBuf`` does. ``decode(buf, partial=True)`` reads as
Python protobuf's ``ParseFromString``, which does not check them.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from brpc_tpu_torch.protocol.tpu_std import (_U64, _WT_LEN, _WT_VARINT,
                                             DecodeError, _as_int32, _key,
                                             _len_field, _read_varint,
                                             _skip, _varint)

OPTIONAL, REQUIRED, REPEATED = "optional", "required", "repeated"
_VARINT_KINDS = ("uint32", "uint64", "bool", "int32", "sint32")


class EncodeError(ValueError):
    """A message that lacks a required field."""


class Message:
    """A proto2 message over its ``FIELDS``: ``(number, name, kind,
    label)`` in number order, ``kind`` a scalar's name or a Message
    class. An unset field is None (a repeated one, an empty list)."""

    FIELDS: Tuple[Tuple[int, str, object, str], ...] = ()
    _BY_NUMBER: Dict[int, Tuple[int, str, object, str]] = {}

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        cls._BY_NUMBER = {f[0]: f for f in cls.FIELDS}

    def __init__(self, **values):
        for _, name, _, label in self.FIELDS:
            setattr(self, name, [] if label == REPEATED else None)
        for name, v in values.items():
            if not any(f[1] == name for f in self.FIELDS):
                raise TypeError(f"{type(self).__name__} has no field "
                                f"{name!r}")
            setattr(self, name, v)

    def __eq__(self, other):
        return type(other) is type(self) and all(
            getattr(self, f[1]) == getattr(other, f[1]) for f in self.FIELDS)

    def __repr__(self):
        set_ = ", ".join(f"{f[1]}={getattr(self, f[1])!r}"
                         for f in self.FIELDS
                         if getattr(self, f[1]) not in (None, []))
        return f"{type(self).__name__}({set_})"

    # ------------------------------------------------------- required
    def missing(self, prefix: str = "") -> List[str]:
        """The required fields not set, this message's and its
        submessages', by path."""
        out = []
        for _, name, kind, label in self.FIELDS:
            v = getattr(self, name)
            if label == REQUIRED and v is None:
                out.append(prefix + name)
            elif isinstance(kind, type) and v is not None:
                if label == REPEATED:
                    for i, m in enumerate(v):
                        out += m.missing(f"{prefix}{name}[{i}].")
                else:
                    out += v.missing(f"{prefix}{name}.")
        return out

    # --------------------------------------------------------- encode
    def encode(self, partial: bool = False) -> bytes:
        if not partial:
            missing = self.missing()
            if missing:
                raise EncodeError(f"{type(self).__name__} is missing "
                                  f"required fields: {', '.join(missing)}")
        out = []
        for number, name, kind, label in self.FIELDS:
            v = getattr(self, name)
            for item in (v if label == REPEATED else
                         () if v is None else (v,)):
                out.append(_encode_field(number, kind, item))
        return b"".join(out)

    # --------------------------------------------------------- decode
    @classmethod
    def decode(cls, buf: bytes, partial: bool = False) -> "Message":
        buf = bytes(buf)
        msg = cls()
        merged: Dict[str, List[bytes]] = {}
        pos = 0
        while pos < len(buf):
            start = pos
            key, pos = _read_varint(buf, pos)
            if pos - start > 5 or key > 0xFFFFFFFF:
                raise DecodeError("bad tag")
            number, wt = key >> 3, key & 7
            if number == 0:
                raise DecodeError("field number 0")
            end = _skip(buf, pos, number, wt)
            spec = cls._BY_NUMBER.get(number)
            if spec is not None and wt == _wire_type(spec[2]):
                _, name, kind, label = spec
                if isinstance(kind, type):
                    n, s = _read_varint(buf, pos)
                    raw = buf[s:s + n]
                    if label == REPEATED:
                        getattr(msg, name).append(kind.decode(raw, True))
                    else:
                        merged.setdefault(name, []).append(raw)
                else:
                    v = _decode_scalar(kind, buf, pos)
                    if label == REPEATED:
                        getattr(msg, name).append(v)
                    else:
                        setattr(msg, name, v)
            pos = end
        for name, chunks in merged.items():
            setattr(msg, name, cls._kind_of(name).decode(b"".join(chunks),
                                                         True))
        if not partial:
            missing = msg.missing()
            if missing:
                raise DecodeError(f"{cls.__name__} is missing required "
                                  f"fields: {', '.join(missing)}")
        return msg

    @classmethod
    def _kind_of(cls, name: str):
        return next(f[2] for f in cls.FIELDS if f[1] == name)


def _wire_type(kind) -> int:
    return _WT_VARINT if kind in _VARINT_KINDS else _WT_LEN


def _encode_field(number: int, kind, v) -> bytes:
    if isinstance(kind, type):
        return _len_field(number, v.encode(partial=True))
    if kind == "string":
        return _len_field(number, v.encode() if isinstance(v, str)
                          else bytes(v))
    if kind == "bytes":
        return _len_field(number, bytes(v))
    if kind == "uint32":
        n = v & 0xFFFFFFFF
    elif kind == "uint64":
        n = v & _U64
    elif kind == "bool":
        n = 1 if v else 0
    elif kind == "int32":
        n = _as_int32(v)            # negative: its 64-bit two's complement
    else:                           # sint32: zigzag
        v = _as_int32(v)
        n = ((v << 1) ^ (v >> 31)) & 0xFFFFFFFF
    return _key(number, _WT_VARINT) + _varint(n)


def _decode_scalar(kind, buf: bytes, pos: int):
    n, pos = _read_varint(buf, pos)
    if kind == "string" or kind == "bytes":
        raw = buf[pos:pos + n]
        if kind == "bytes":
            return raw
        try:
            return raw.decode("utf-8")
        except UnicodeDecodeError:
            return raw                  # protobuf's proto2 reading
    if kind == "uint32":
        return n & 0xFFFFFFFF
    if kind == "uint64":
        return n
    if kind == "bool":
        return n != 0
    if kind == "int32":
        return _as_int32(n)
    u = n & 0xFFFFFFFF                  # sint32
    return (u >> 1) ^ -(u & 1)


class RequestHead(Message):
    FIELDS = ((1, "from_host", "string", OPTIONAL),
              (2, "content_type", "uint32", OPTIONAL),
              (3, "connection", "bool", OPTIONAL),
              (4, "charset", "string", OPTIONAL),
              (5, "accept_charset", "string", OPTIONAL),
              (6, "create_time", "string", OPTIONAL),
              (7, "log_id", "uint64", OPTIONAL),
              (8, "compress_type", "uint32", OPTIONAL))


class RequestBody(Message):
    FIELDS = ((1, "version", "string", OPTIONAL),
              (2, "charset", "string", OPTIONAL),
              (3, "service", "string", REQUIRED),
              (4, "method_id", "uint32", REQUIRED),
              (5, "id", "uint64", REQUIRED),
              (6, "serialized_request", "bytes", OPTIONAL))


class PublicPbrpcRequest(Message):
    FIELDS = ((1, "requestHead", RequestHead, OPTIONAL),
              (2, "requestBody", RequestBody, REPEATED))


class ResponseHead(Message):
    FIELDS = ((1, "code", "sint32", REQUIRED),
              (2, "text", "string", OPTIONAL),
              (3, "from_host", "string", OPTIONAL),
              (4, "compress_type", "uint32", OPTIONAL))


class ResponseBody(Message):
    FIELDS = ((1, "serialized_response", "bytes", OPTIONAL),
              (2, "version", "string", OPTIONAL),
              (3, "error", "int32", OPTIONAL),
              (4, "id", "uint64", REQUIRED))


class PublicPbrpcResponse(Message):
    FIELDS = ((1, "responseHead", ResponseHead, OPTIONAL),
              (2, "responseBody", ResponseBody, REPEATED))
