"""The mongo wire protocol's server side (the port of
brpc_tpu/protocol/mongo.py; bRPC's policy/mongo_protocol.cpp, mongo_head.h
and mongo_service_adaptor.h): enough OP_MSG and OP_QUERY for a mongo client
to send commands to a server whose ``ServerOptions.mongo_service_adaptor``
maps command documents to reply documents.

    header: messageLength:i32 requestID:i32 responseTo:i32 opCode:i32 (LE)
    OP_MSG (2013):   flagBits:u32, section kind 0, one BSON document
    OP_QUERY (2004): flags:i32, fullCollectionName cstring,
                     numberToSkip:i32, numberToReturn:i32, the query
                     document; answered with OP_REPLY (1)

The header is all binary: a prefix shorter than 16 bytes is disclaimed
tentatively (``min_probe_bytes``), and bytes are claimed only with a
known opcode and a length from 16 to 48 MiB. A frame that does not
decode fails the connection.

A connection's commands are answered in parse order, each through the
server's limiters (its row ``mongo.<command>`` on ``/status``; code 202
when they shed it) and counted in flight for ``join``. Without a handler
of its own, ``isMaster`` and ``hello`` answer a minimal handshake; any
other unknown command gets code 59 (CommandNotFound), and a handler's
exception code 8. Mongo authenticates with commands (``saslStart``),
which an adaptor implements: ``ServerOptions.auth`` does not gate it.
The port has no mongo client: a mongo client library, or frames made
with ``pack_msg`` and ``pack_query``, speak to it.
"""

from __future__ import annotations

import inspect
import struct
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from brpc_tpu_torch.protocol import bson
from brpc_tpu_torch.protocol.registry import (PARSE_NOT_ENOUGH_DATA,
                                              PARSE_OK, PARSE_TRY_OTHERS,
                                              Protocol, register_protocol)

_HDR = struct.Struct("<iiii")
HEADER_SIZE = 16
OP_REPLY = 1
OP_QUERY = 2004
OP_MSG = 2013
_MAX_MESSAGE = 48 << 20
_KNOWN_OPS = frozenset((OP_REPLY, OP_QUERY, OP_MSG, 2001, 2002, 2005, 2006,
                        2010, 2011, 2012))
CODE_COMMAND_NOT_FOUND = 59
CODE_INTERNAL_ERROR = 8
CODE_EXCEEDED_LIMIT = 202


class MongoMessage:
    __slots__ = ("request_id", "response_to", "op_code", "flags", "doc",
                 "collection")

    def __init__(self, request_id, response_to, op_code, flags, doc,
                 collection=""):
        self.request_id = request_id
        self.response_to = response_to
        self.op_code = op_code
        self.flags = flags
        self.doc = doc
        self.collection = collection


class MongoServiceAdaptor:
    """The command table: ``@adaptor.command("ping")`` over ``def
    ping(socket, doc) -> reply doc`` (a coroutine function too); names
    match case-insensitively."""

    def __init__(self):
        self._handlers: Dict[str, Callable] = {}

    def command(self, name: Optional[str] = None):
        def deco(fn):
            self.add_command_handler(name or fn.__name__, fn)
            return fn
        return deco

    def add_command_handler(self, name: str, fn: Callable) -> None:
        self._handlers[name.lower()] = fn

    def find(self, name: str) -> Optional[Callable]:
        return self._handlers.get(name.lower())


def pack_msg(request_id: int, response_to: int, doc: dict) -> bytes:
    """An OP_MSG frame of one kind-0 section."""
    body = b"\x00\x00\x00\x00\x00" + bson.encode_doc(doc)
    return _HDR.pack(16 + len(body), request_id, response_to, OP_MSG) + body


def pack_query(request_id: int, collection: str, doc: dict) -> bytes:
    """An OP_QUERY frame (skip 0, return 1)."""
    body = (struct.pack("<i", 0) + collection.encode("latin1") + b"\x00"
            + struct.pack("<ii", 0, 1) + bson.encode_doc(doc))
    return _HDR.pack(16 + len(body), request_id, 0, OP_QUERY) + body


def pack_reply(request_id: int, response_to: int, doc: dict) -> bytes:
    """An OP_REPLY frame: flags, cursorId, startingFrom, numberReturned,
    one document."""
    body = struct.pack("<iqii", 8, 0, 0, 1) + bson.encode_doc(doc)
    return _HDR.pack(16 + len(body), request_id, response_to,
                     OP_REPLY) + body


def unpack_reply(frame: bytes) -> Tuple[int, int, int, dict]:
    """(requestID, responseTo, opCode, document) of a whole OP_MSG or
    OP_REPLY frame."""
    _length, request_id, response_to, op = _HDR.unpack_from(frame)
    start = 16 + (5 if op == OP_MSG else 20)
    return request_id, response_to, op, bson.decode_doc(frame, start)[0]


class MongoProtocol(Protocol):
    name = "mongo"
    min_probe_bytes = HEADER_SIZE

    def __init__(self):
        self._id_lock = threading.Lock()
        self._next_id = 1

    def _reply_id(self) -> int:
        with self._id_lock:
            rid = self._next_id
            self._next_id += 1
            return rid

    def parse(self, portal, socket) -> Tuple[str, object]:
        head = portal.peek_bytes(min(HEADER_SIZE, portal.size))
        if len(head) < HEADER_SIZE:
            return PARSE_TRY_OTHERS, None
        length, request_id, response_to, op_code = _HDR.unpack(head)
        if op_code not in _KNOWN_OPS or not \
                HEADER_SIZE <= length <= _MAX_MESSAGE:
            return PARSE_TRY_OTHERS, None
        if portal.size < length:
            socket.input_need = length
            return PARSE_NOT_ENOUGH_DATA, None
        portal.pop_front(HEADER_SIZE)
        payload = portal.cut(length - HEADER_SIZE).to_bytes()
        try:
            if op_code == OP_MSG:
                if len(payload) < 5:
                    raise bson.BsonError("truncated OP_MSG")
                flags = struct.unpack_from("<I", payload, 0)[0]
                if payload[4:5] != b"\x00":
                    raise bson.BsonError("only OP_MSG section kind 0")
                doc, _ = bson.decode_doc(payload, 5)
                return PARSE_OK, MongoMessage(request_id, response_to,
                                              op_code, flags, doc)
            if op_code == OP_QUERY:
                if len(payload) < 4:
                    raise bson.BsonError("truncated OP_QUERY")
                flags = struct.unpack_from("<i", payload, 0)[0]
                end = payload.find(b"\x00", 4)
                if end < 0:
                    raise bson.BsonError("unterminated collection name")
                collection = payload[4:end].decode("latin1")
                # past numberToSkip and numberToReturn
                doc, _ = bson.decode_doc(payload, end + 9)
                return PARSE_OK, MongoMessage(request_id, response_to,
                                              op_code, flags, doc,
                                              collection)
            raise bson.BsonError(f"unsupported opcode {op_code}")
        except bson.BsonError as e:
            socket.set_failed(ConnectionError(f"corrupt mongo frame: {e}"))
            return PARSE_NOT_ENOUGH_DATA, None

    def process_inline(self, msg: MongoMessage, socket) -> bool:
        from brpc_tpu_torch.transport.input_messenger import (
            process_in_parse_order)
        process_in_parse_order(socket, "mongo", msg, self._run_command)
        return True

    async def _run_command(self, msg: MongoMessage, socket) -> None:
        server = socket.user_data.get("server")
        if server is None or socket.failed:
            return
        adaptor: Optional[MongoServiceAdaptor] = \
            server.options.mongo_service_adaptor
        packer = pack_reply if msg.op_code == OP_QUERY else pack_msg

        def send(doc: dict) -> None:
            socket.write(packer(self._reply_id(), msg.request_id, doc))

        if adaptor is None:
            send({"ok": 0.0, "errmsg": "no mongo_service_adaptor installed",
                  "code": CODE_COMMAND_NOT_FOUND})
            return
        if not msg.doc:
            send({"ok": 0.0, "errmsg": "empty command",
                  "code": CODE_COMMAND_NOT_FOUND})
            return
        cmd_name = next(iter(msg.doc))
        handler = adaptor.find(cmd_name)
        if handler is None:
            if cmd_name.lower() in ("ismaster", "hello"):
                # the minimal topology handshake a mongo client needs
                send({"ok": 1.0, "ismaster": True, "isWritablePrimary": True,
                      "maxWireVersion": 13, "minWireVersion": 0,
                      "maxBsonObjectSize": 16 << 20,
                      "localTime": bson.DateTimeMs(int(time.time() * 1000))})
                return
            send({"ok": 0.0, "errmsg": f"no such command: '{cmd_name}'",
                  "code": CODE_COMMAND_NOT_FOUND})
            return
        key = f"mongo.{cmd_name}"
        cost = server.on_request_start(key)
        if not cost:
            send({"ok": 0.0, "errmsg": "max_concurrency reached",
                  "code": CODE_EXCEEDED_LIMIT})
            return
        server._request_begin()
        t0 = time.monotonic_ns()
        error = False
        try:
            r = handler(socket, msg.doc)
            if inspect.isawaitable(r):
                r = await r
            reply = r if isinstance(r, dict) else {"ok": 1.0}
            reply.setdefault("ok", 1.0)
        except Exception as e:          # boundary: report, keep serving
            error = True
            reply = {"ok": 0.0, "errmsg": f"handler error: {e}",
                     "code": CODE_INTERNAL_ERROR}
        finally:
            server.on_request_end(key, (time.monotonic_ns() - t0) / 1e3,
                                  error, cost)
            server._request_done()
        send(reply)

    def process(self, msg, socket):
        raise AssertionError("mongo messages are processed inline")


_instance: Optional[MongoProtocol] = None


def ensure_registered() -> MongoProtocol:
    global _instance
    if _instance is None:
        _instance = MongoProtocol()
        register_protocol(_instance)
    return _instance
