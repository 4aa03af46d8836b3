"""Framed thrift: the TBinaryProtocol codec, the framed transport, the
server side and a client (the port of brpc_tpu/protocol/thrift.py;
bRPC's policy/thrift_protocol.cpp and thrift_service.h).

No code generation: a struct is ``{field_id: TVal(ttype, value)}``, a
list or set ``TList(elem_ttype, [values])``, a map ``TMap(key_ttype,
val_ttype, {k: v})``. Methods take and return such structs.

Framing: a u32 big-endian length, then a strict TBinary message:

    i32 (0x8001_0000 | msg_type) | string method | i32 seqid | args struct

The reader refuses nesting deeper than 32 and containers longer than
2**24, and a frame over 64 MiB fails the connection.

Server side (``ServerOptions.thrift_service``): a connection's calls are
answered in parse order (``process_in_parse_order``), each through the
server's limiters (``on_request_start`` and ``on_request_end``, its row
``thrift.<method>`` on ``/status``) and counted in flight for ``join``.
A server with an Authenticator refuses every thrift call, since thrift
carries no credential (``Server.refuse_uncredentialed``): an application
exception, no handler run. brpc_tpu answers such calls (ROADMAP section
3). The client (``ThriftClient``) rides ``transport/pipelined.py``:
``call``, ``call_async`` from a fiber and ``call_oneway``.
"""

from __future__ import annotations

import inspect
import struct
import threading
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

from brpc_tpu_torch.protocol.registry import (PARSE_NOT_ENOUGH_DATA,
                                              PARSE_OK, PARSE_TRY_OTHERS,
                                              Protocol, register_protocol)
from brpc_tpu_torch.transport.pipelined import PipelinedClient

VERSION_1 = 0x80010000
_VERSION_MASK = 0xFFFF0000

# message types
MSG_CALL = 1
MSG_REPLY = 2
MSG_EXCEPTION = 3
MSG_ONEWAY = 4

# TType wire ids
T_STOP = 0
T_VOID = 1
T_BOOL = 2
T_BYTE = 3
T_DOUBLE = 4
T_I16 = 6
T_I32 = 8
T_I64 = 10
T_STRING = 11
T_STRUCT = 12
T_MAP = 13
T_SET = 14
T_LIST = 15

# TApplicationException types
EXC_UNKNOWN = 0
EXC_UNKNOWN_METHOD = 1
EXC_BAD_SEQUENCE_ID = 4
EXC_MISSING_RESULT = 5
EXC_INTERNAL_ERROR = 6

_MAX_FRAME = 64 << 20
_MAX_DEPTH = 32
_MAX_CONTAINER = 1 << 24
_U32 = struct.Struct(">I")
_I32 = struct.Struct(">i")


class TVal(NamedTuple):
    ttype: int
    value: Any


class TList(NamedTuple):
    elem_ttype: int
    values: List[Any]


class TMap(NamedTuple):
    key_ttype: int
    val_ttype: int
    items: Dict[Any, Any]


class ThriftError(Exception):
    """A TApplicationException from the peer (message, type)."""

    def __init__(self, message: str, type_: int = EXC_INTERNAL_ERROR):
        super().__init__(message)
        self.type = type_


class BadWire(Exception):
    """Bytes that are no TBinary message."""


# ------------------------------------------------------------------ codec

class TBinaryWriter:
    def __init__(self):
        self._parts: List[bytes] = []

    def bytes(self) -> bytes:
        return b"".join(self._parts)

    def write_message_begin(self, method: str, msg_type: int, seqid: int):
        self._parts.append(_U32.pack(VERSION_1 | msg_type))
        self.write_string(method)
        self._parts.append(_I32.pack(seqid))

    def write_string(self, s) -> None:
        if isinstance(s, str):
            s = s.encode()
        self._parts.append(_I32.pack(len(s)))
        self._parts.append(bytes(s))

    def write_value(self, ttype: int, value) -> None:
        p = self._parts
        if ttype == T_BOOL:
            p.append(b"\x01" if value else b"\x00")
        elif ttype == T_BYTE:
            p.append(struct.pack(">b", value))
        elif ttype == T_I16:
            p.append(struct.pack(">h", value))
        elif ttype == T_I32:
            p.append(_I32.pack(value))
        elif ttype == T_I64:
            p.append(struct.pack(">q", value))
        elif ttype == T_DOUBLE:
            p.append(struct.pack(">d", value))
        elif ttype == T_STRING:
            self.write_string(value)
        elif ttype == T_STRUCT:
            self.write_struct(value)
        elif ttype in (T_LIST, T_SET):
            p.append(struct.pack(">bi", value.elem_ttype, len(value.values)))
            for v in value.values:
                self.write_value(value.elem_ttype, v)
        elif ttype == T_MAP:
            p.append(struct.pack(">bbi", value.key_ttype, value.val_ttype,
                                 len(value.items)))
            for k, v in value.items.items():
                self.write_value(value.key_ttype, k)
                self.write_value(value.val_ttype, v)
        else:
            raise TypeError(f"cannot write ttype {ttype}")

    def write_struct(self, fields: Dict[int, TVal]) -> None:
        for fid, tv in fields.items():
            self._parts.append(struct.pack(">bh", tv.ttype, fid))
            self.write_value(tv.ttype, tv.value)
        self._parts.append(b"\x00")     # T_STOP


class TBinaryReader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise BadWire("truncated thrift payload")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def read_message_begin(self) -> Tuple[str, int, int]:
        word = _U32.unpack(self._take(4))[0]
        if word & _VERSION_MASK != VERSION_1:
            raise BadWire(f"bad thrift version word 0x{word:08x}")
        method = self.read_string().decode("utf-8", "replace")
        seqid = _I32.unpack(self._take(4))[0]
        return method, word & 0xFF, seqid

    def read_string(self) -> bytes:
        n = _I32.unpack(self._take(4))[0]
        if n < 0 or n > _MAX_FRAME:
            raise BadWire("bad string length")
        return self._take(n)

    def read_value(self, ttype: int, depth: int = 0):
        if depth > _MAX_DEPTH:
            raise BadWire("thrift nesting too deep")
        if ttype == T_BOOL:
            return self._take(1) != b"\x00"
        if ttype == T_BYTE:
            return struct.unpack(">b", self._take(1))[0]
        if ttype == T_I16:
            return struct.unpack(">h", self._take(2))[0]
        if ttype == T_I32:
            return _I32.unpack(self._take(4))[0]
        if ttype == T_I64:
            return struct.unpack(">q", self._take(8))[0]
        if ttype == T_DOUBLE:
            return struct.unpack(">d", self._take(8))[0]
        if ttype == T_STRING:
            return self.read_string()
        if ttype == T_STRUCT:
            return self.read_struct(depth + 1)
        if ttype in (T_LIST, T_SET):
            elem, n = struct.unpack(">bi", self._take(5))
            if n < 0 or n > _MAX_CONTAINER:
                raise BadWire("bad container length")
            return TList(elem, [self.read_value(elem, depth + 1)
                                for _ in range(n)])
        if ttype == T_MAP:
            kt, vt, n = struct.unpack(">bbi", self._take(6))
            if n < 0 or n > _MAX_CONTAINER:
                raise BadWire("bad map length")
            items = {}
            for _ in range(n):
                k = self.read_value(kt, depth + 1)
                if isinstance(k, (TList, TMap, dict)):
                    k = repr(k)         # an unhashable key, as brpc_tpu
                items[k] = self.read_value(vt, depth + 1)
            return TMap(kt, vt, items)
        raise BadWire(f"unknown ttype {ttype}")

    def read_struct(self, depth: int = 0) -> Dict[int, TVal]:
        if depth > _MAX_DEPTH:
            raise BadWire("thrift nesting too deep")
        fields: Dict[int, TVal] = {}
        while True:
            ttype = struct.unpack(">b", self._take(1))[0]
            if ttype == T_STOP:
                return fields
            fid = struct.unpack(">h", self._take(2))[0]
            fields[fid] = TVal(ttype, self.read_value(ttype, depth + 1))


def pack_message(method: str, msg_type: int, seqid: int,
                 fields: Dict[int, TVal]) -> bytes:
    """One framed message."""
    w = TBinaryWriter()
    w.write_message_begin(method, msg_type, seqid)
    w.write_struct(fields)
    payload = w.bytes()
    return _U32.pack(len(payload)) + payload


class ThriftMessage(NamedTuple):
    method: str
    msg_type: int
    seqid: int
    fields: Dict[int, TVal]


def unpack_message(payload: bytes) -> ThriftMessage:
    """A frame's payload (its length cut off)."""
    r = TBinaryReader(payload)
    method, msg_type, seqid = r.read_message_begin()
    return ThriftMessage(method, msg_type, seqid, r.read_struct())


def app_exception_fields(message: str,
                         type_: int = EXC_INTERNAL_ERROR) -> Dict[int, TVal]:
    return {1: TVal(T_STRING, message), 2: TVal(T_I32, type_)}


# ----------------------------------------------------------------- server

class ThriftService:
    """The method table of ``ServerOptions.thrift_service``. A handler
    takes ``(socket, args_fields)`` and returns result fields
    (``{0: TVal(...)}``, 0 being the success field), a bare ``TVal``
    (field 0), or None (void); it may be a coroutine function, and may
    raise ``ThriftError`` to answer an application exception."""

    def __init__(self):
        self._methods: Dict[str, Callable] = {}

    def add_method(self, name: str, fn: Callable) -> None:
        self._methods[name] = fn

    def method(self, name: Optional[str] = None):
        def deco(fn):
            self.add_method(name or fn.__name__, fn)
            return fn
        return deco

    def find(self, name: str) -> Optional[Callable]:
        return self._methods.get(name)


class ThriftProtocol(Protocol):
    name = "thrift"

    def parse(self, portal, socket) -> Tuple[str, object]:
        head = portal.peek_bytes(min(8, portal.size))
        if len(head) < 8:
            # the length and the version word claim the bytes
            if len(head) >= 6 and head[4:6] != b"\x80\x01":
                return PARSE_TRY_OTHERS, None
            return PARSE_NOT_ENOUGH_DATA, None
        if head[4:6] != b"\x80\x01":
            return PARSE_TRY_OTHERS, None
        length = _U32.unpack_from(head)[0]
        if length > _MAX_FRAME:
            socket.set_failed(ConnectionError(
                f"thrift frame of {length} bytes exceeds max"))
            return PARSE_NOT_ENOUGH_DATA, None
        if portal.size < 4 + length:
            socket.input_need = 4 + length
            return PARSE_NOT_ENOUGH_DATA, None
        portal.pop_front(4)
        payload = portal.cut(length).to_bytes()
        try:
            msg = unpack_message(payload)
        except BadWire as e:
            socket.set_failed(ConnectionError(f"corrupt thrift frame: {e}"))
            return PARSE_NOT_ENOUGH_DATA, None
        return PARSE_OK, msg

    def process_inline(self, msg: ThriftMessage, socket) -> bool:
        client = socket.user_data.get("thrift_client")
        if client is not None:
            client._on_reply(socket, msg)
            return True
        from brpc_tpu_torch.transport.input_messenger import (
            process_in_parse_order)
        process_in_parse_order(socket, "thrift", msg, self._run_method)
        return True

    async def _run_method(self, msg: ThriftMessage, socket) -> None:
        server = socket.user_data.get("server")
        service: Optional[ThriftService] = (
            server.options.thrift_service if server is not None else None)
        oneway = msg.msg_type == MSG_ONEWAY

        def reply(msg_type: int, fields: Dict[int, TVal]) -> None:
            if not oneway:
                socket.write(pack_message(msg.method, msg_type, msg.seqid,
                                          fields))

        if service is None:
            reply(MSG_EXCEPTION, app_exception_fields(
                "this server has no thrift_service installed",
                EXC_MISSING_RESULT))
            return
        # thrift carries no credential: an auth server answers no call
        refused = server.refuse_uncredentialed("thrift")
        if refused is not None:
            reply(MSG_EXCEPTION, app_exception_fields(refused, EXC_UNKNOWN))
            return
        handler = service.find(msg.method)
        if handler is None:
            reply(MSG_EXCEPTION, app_exception_fields(
                f"unknown method {msg.method!r}", EXC_UNKNOWN_METHOD))
            return
        key = f"thrift.{msg.method}"
        cost = server.on_request_start(key)
        if not cost:
            reply(MSG_EXCEPTION, app_exception_fields(
                "max_concurrency reached", EXC_MISSING_RESULT))
            return
        server._request_begin()
        t0 = time.monotonic_ns()
        error = False
        try:
            r = handler(socket, msg.fields)
            if inspect.isawaitable(r):
                r = await r
            if r is None:
                fields: Dict[int, TVal] = {}
            elif isinstance(r, TVal):
                fields = {0: r}
            else:
                fields = r
            reply(MSG_REPLY, fields)
        except ThriftError as e:
            error = True
            reply(MSG_EXCEPTION, app_exception_fields(str(e), e.type))
        except Exception as e:          # boundary: report, keep serving
            error = True
            reply(MSG_EXCEPTION, app_exception_fields(
                f"handler error: {e}", EXC_INTERNAL_ERROR))
        finally:
            server.on_request_end(key, (time.monotonic_ns() - t0) / 1e3,
                                  error, cost)
            server._request_done()

    def process(self, msg, socket):
        raise AssertionError("thrift messages are processed inline")


# ----------------------------------------------------------------- client

class ThriftClient(PipelinedClient):
    """A framed TBinary client on one pipelined connection: ``call``
    returns the reply's result fields and raises ``ThriftError`` on an
    exception reply; ``call_async`` is its fiber twin; ``call_oneway``
    sends and forgets. A reply whose seqid or method is not the call's
    fails the connection."""

    user_data_key = "thrift_client"

    def __init__(self, address, timeout_s: float = 5.0, control=None):
        super().__init__(address, ensure_registered(), timeout_s=timeout_s,
                         control=control)
        self._seq_lock = threading.Lock()
        self._seq = 0

    def _next_seqid(self) -> int:
        with self._seq_lock:
            self._seq = (self._seq + 1) & 0x7FFFFFFF
            return self._seq

    def _finish_call(self, reply: ThriftMessage, method: str, seqid: int,
                     batch) -> Dict[int, TVal]:
        if reply.seqid != seqid or reply.method != method:
            if batch.socket is not None:
                batch.socket.set_failed(
                    ConnectionError("thrift reply desync"))
            raise ThriftError("reply desync (seqid/method mismatch)",
                              EXC_BAD_SEQUENCE_ID)
        if reply.msg_type == MSG_EXCEPTION:
            msg_f = reply.fields.get(1)
            type_f = reply.fields.get(2)
            raise ThriftError(
                msg_f.value.decode("utf-8", "replace") if msg_f
                else "application exception",
                type_f.value if type_f else EXC_INTERNAL_ERROR)
        return reply.fields

    def call(self, method: str, fields: Optional[Dict[int, TVal]] = None
             ) -> Dict[int, TVal]:
        seqid = self._next_seqid()
        batch = self._start(pack_message(method, MSG_CALL, seqid,
                                         fields or {}), 1)
        reply = self._wait(batch, f"thrift {method!r}")[0]
        return self._finish_call(reply, method, seqid, batch)

    async def call_async(self, method: str,
                         fields: Optional[Dict[int, TVal]] = None
                         ) -> Dict[int, TVal]:
        seqid = self._next_seqid()
        batch = self._start(pack_message(method, MSG_CALL, seqid,
                                         fields or {}), 1)
        reply = (await self._wait_async(batch, f"thrift {method!r}"))[0]
        return self._finish_call(reply, method, seqid, batch)

    def call_oneway(self, method: str,
                    fields: Optional[Dict[int, TVal]] = None) -> None:
        self._get_socket().write(pack_message(
            method, MSG_ONEWAY, self._next_seqid(), fields or {}))


_instance: Optional[ThriftProtocol] = None


def ensure_registered() -> ThriftProtocol:
    global _instance
    if _instance is None:
        _instance = ThriftProtocol()
        register_protocol(_instance)
    return _instance
