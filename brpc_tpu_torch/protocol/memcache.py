"""The memcached binary protocol's client (the port of
brpc_tpu/protocol/memcache.py; bRPC's memcache.{h,cpp} and
policy/memcache_binary_protocol.cpp). Client side only, as in the
reference: on a server's connection the parser disclaims every byte.

A frame is a 24-byte header,

    magic:u8 opcode:u8 key_len:u16 extras_len:u8 data_type:u8
    vbucket_or_status:u16 total_body:u32 opaque:u32 cas:u64

then extras, key and value. A connection answers in request order, so
the client matches replies by FIFO (``transport/pipelined.py``); each
request's ``opaque`` is checked all the same, and a reply that is not
its request's fails the connection. ``username``/``password`` send a
SASL PLAIN auth first on every fresh connection.
"""

from __future__ import annotations

import itertools
import struct
import threading
from typing import List, NamedTuple, Optional, Tuple

from brpc_tpu_torch.protocol.registry import (PARSE_NOT_ENOUGH_DATA,
                                              PARSE_OK, PARSE_TRY_OTHERS,
                                              Protocol, register_protocol)
from brpc_tpu_torch.transport.pipelined import PipelinedClient

_HDR = struct.Struct(">BBHBBHIIQ")
HEADER_SIZE = 24
MAGIC_REQUEST = 0x80
MAGIC_RESPONSE = 0x81

# opcodes (protocol_binary.h of upstream memcached)
OP_GET = 0x00
OP_SET = 0x01
OP_ADD = 0x02
OP_REPLACE = 0x03
OP_DELETE = 0x04
OP_INCREMENT = 0x05
OP_DECREMENT = 0x06
OP_FLUSH = 0x08
OP_NOOP = 0x0A
OP_VERSION = 0x0B
OP_APPEND = 0x0E
OP_PREPEND = 0x0F
OP_TOUCH = 0x1C
OP_SASL_LIST_MECHS = 0x20
OP_SASL_AUTH = 0x21
OP_SASL_STEP = 0x22

# status codes
STATUS_OK = 0x0000
STATUS_KEY_NOT_FOUND = 0x0001
STATUS_KEY_EXISTS = 0x0002
STATUS_VALUE_TOO_LARGE = 0x0003
STATUS_INVALID_ARGUMENTS = 0x0004
STATUS_ITEM_NOT_STORED = 0x0005
STATUS_NON_NUMERIC = 0x0006
STATUS_AUTH_ERROR = 0x0020
STATUS_AUTH_CONTINUE = 0x0021

_MAX_BODY = 64 << 20


class MemcacheError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(f"[0x{status:04x}] {message}")
        self.status = status
        self.message = message


class Response(NamedTuple):
    opcode: int
    status: int
    opaque: int
    cas: int
    extras: bytes
    key: bytes
    value: bytes


class GetResult(NamedTuple):
    value: bytes
    flags: int
    cas: int


def pack_request(opcode: int, key: bytes = b"", value: bytes = b"",
                 extras: bytes = b"", opaque: int = 0, cas: int = 0) -> bytes:
    total = len(extras) + len(key) + len(value)
    return _HDR.pack(MAGIC_REQUEST, opcode, len(key), len(extras), 0, 0,
                     total, opaque, cas) + extras + key + value


def parse_response(data: bytes, pos: int) -> Optional[Tuple[Response, int]]:
    """One complete response frame at ``pos`` or None if incomplete.
    Raises ValueError on a frame that can never be a binary response."""
    if len(data) - pos < HEADER_SIZE:
        return None
    (magic, opcode, key_len, extras_len, _dtype, status, total, opaque,
     cas) = _HDR.unpack_from(data, pos)
    if magic != MAGIC_RESPONSE:
        raise ValueError(f"bad response magic 0x{magic:02x}")
    if total > _MAX_BODY or extras_len + key_len > total:
        raise ValueError("bad body lengths")
    if len(data) - pos < HEADER_SIZE + total:
        return None
    body = pos + HEADER_SIZE
    extras = data[body:body + extras_len]
    key = data[body + extras_len:body + extras_len + key_len]
    value = data[body + extras_len + key_len:body + total]
    return (Response(opcode, status, opaque, cas, extras, key, value),
            body + total)


class MemcacheProtocol(Protocol):
    """Client-side parser: binary responses on sockets owned by a
    MemcacheClient. Never claims server-side bytes."""

    name = "memcache"

    def parse(self, portal, socket) -> Tuple[str, object]:
        client = socket.user_data.get("memcache_client")
        if client is None:
            return PARSE_TRY_OTHERS, None
        # parse every complete frame off one flattened peek (a pipelined
        # multi-get burst would otherwise cost O(N^2) in re-peeks)
        data = portal.peek_bytes(portal.size)
        frames: List[Response] = []
        pos = 0
        while pos < len(data):
            try:
                got = parse_response(data, pos)
            except ValueError as e:
                socket.set_failed(
                    ConnectionError(f"corrupt memcache stream: {e}"))
                return PARSE_NOT_ENOUGH_DATA, None
            if got is None:
                break
            resp, pos = got
            frames.append(resp)
        if not frames:
            return PARSE_NOT_ENOUGH_DATA, None
        portal.pop_front(pos)
        return PARSE_OK, frames

    def process_inline(self, msgs: List[Response], socket) -> bool:
        client = socket.user_data.get("memcache_client")
        if client is not None:
            for msg in msgs:
                client._on_reply(socket, msg)
        return True

    def process(self, msg, socket):
        raise AssertionError("memcache responses are processed inline")


class MemcacheClient(PipelinedClient):
    """get/set/add/replace/append/prepend/delete/incr/decr/touch/version/
    flush_all over one pipelined connection (MemcacheRequest's batched
    api maps to ``pipeline_get``)."""

    user_data_key = "memcache_client"

    def __init__(self, address, timeout_s: float = 5.0, control=None,
                 username: Optional[str] = None,
                 password: Optional[str] = None):
        """username/password enable SASL PLAIN authentication on every
        fresh connection (the couchbase_authenticator.cpp role: the
        reference authenticates memcache/couchbase connections with a
        SASL PLAIN token before user commands)."""
        super().__init__(address, ensure_registered(), timeout_s=timeout_s,
                         control=control)
        if password is not None and username is None:
            # a silently-dropped password would leave the connection
            # unauthenticated with no hint why commands fail
            raise ValueError("memcache SASL: password given without "
                             "username")
        self._opaque = itertools.count(1)
        self._username = username
        self._password = password or ""
        # thread-local: _hello_commands and _check_hello_reply both run
        # on the connecting thread inside one _get_socket call, while a
        # concurrent connect on another thread generates its own opaque
        # — instance state here would let one connection's check compare
        # against the other's opaque
        self._sasl_expect = threading.local()

    # ----------------------------------------------------------- sasl auth
    def _hello_commands(self):
        if self._username is None:
            return []
        token = b"\x00" + self._username.encode() + \
            b"\x00" + self._password.encode()
        self._sasl_expect.opaque = next(self._opaque)
        return [pack_request(OP_SASL_AUTH, b"PLAIN", token,
                             opaque=self._sasl_expect.opaque)]

    def _check_hello_reply(self, reply) -> None:
        # strict: the hello reply must BE the SASL reply (same desync
        # tripwire as _call) — a stray frame here must not be mistaken
        # for a successful authentication
        expected = getattr(self._sasl_expect, "opaque", None)
        if reply.opcode != OP_SASL_AUTH or reply.opaque != expected:
            raise MemcacheError(-1, "sasl reply desync "
                                f"(opcode 0x{reply.opcode:02x})")
        if reply.status != STATUS_OK:
            raise MemcacheError(
                reply.status,
                reply.value.decode("latin1", "replace") or "auth failure")

    # ------------------------------------------------------------ helpers
    def _call(self, opcode: int, key: bytes = b"", value: bytes = b"",
              extras: bytes = b"", cas: int = 0) -> Response:
        opaque = next(self._opaque)
        wire = pack_request(opcode, key, value, extras, opaque, cas)
        batch = self._start(wire, 1)
        resp: Response = self._wait(batch, f"memcache op 0x{opcode:02x}")[0]
        return self._check_reply(resp, opaque, opcode, batch)

    async def _call_async(self, opcode: int, key: bytes = b"",
                          value: bytes = b"", extras: bytes = b"",
                          cas: int = 0) -> Response:
        """Fiber-friendly _call: awaits the reply instead of parking the
        worker thread (same contract as redis execute_async / thrift
        call_async)."""
        opaque = next(self._opaque)
        wire = pack_request(opcode, key, value, extras, opaque, cas)
        batch = self._start(wire, 1)
        resp: Response = (await self._wait_async(
            batch, f"memcache op 0x{opcode:02x}"))[0]
        return self._check_reply(resp, opaque, opcode, batch)

    def _check_reply(self, resp: Response, opaque: int, opcode: int,
                     batch) -> Response:
        if resp.opaque != opaque or resp.opcode != opcode:
            # FIFO desync: fail the connection, nothing after this can match
            if batch.socket is not None:
                batch.socket.set_failed(
                    ConnectionError("memcache reply desync"))
            raise MemcacheError(-1, "reply desync (opaque mismatch)")
        return resp

    @staticmethod
    def _key(key) -> bytes:
        return key.encode() if isinstance(key, str) else bytes(key)

    @staticmethod
    def _val(value) -> bytes:
        return value.encode() if isinstance(value, str) else bytes(value)

    @staticmethod
    def _raise(resp: Response):
        raise MemcacheError(resp.status,
                            resp.value.decode("latin1", "replace")
                            or f"status 0x{resp.status:04x}")

    # ---------------------------------------------------------------- api
    def get(self, key) -> Optional[GetResult]:
        return self._get_result(self._call(OP_GET, self._key(key)))

    async def get_async(self, key) -> Optional[GetResult]:
        return self._get_result(await self._call_async(OP_GET,
                                                       self._key(key)))

    def _get_result(self, resp: Response) -> Optional[GetResult]:
        if resp.status == STATUS_KEY_NOT_FOUND:
            return None
        if resp.status != STATUS_OK:
            self._raise(resp)
        flags = struct.unpack(">I", resp.extras)[0] if len(resp.extras) >= 4 else 0
        return GetResult(resp.value, flags, resp.cas)

    def _store(self, opcode: int, key, value, flags: int, exptime: int,
               cas: int) -> int:
        extras = struct.pack(">II", flags, exptime)
        resp = self._call(opcode, self._key(key), self._val(value), extras,
                          cas)
        if resp.status != STATUS_OK:
            self._raise(resp)
        return resp.cas

    async def _store_async(self, opcode: int, key, value, flags: int,
                           exptime: int, cas: int) -> int:
        extras = struct.pack(">II", flags, exptime)
        resp = await self._call_async(opcode, self._key(key),
                                      self._val(value), extras, cas)
        if resp.status != STATUS_OK:
            self._raise(resp)
        return resp.cas

    async def set_async(self, key, value, flags: int = 0, exptime: int = 0,
                        cas: int = 0) -> int:
        return await self._store_async(OP_SET, key, value, flags, exptime,
                                       cas)

    def set(self, key, value, flags: int = 0, exptime: int = 0,
            cas: int = 0) -> int:
        """Returns the new cas. With cas != 0 this is a check-and-set
        (raises MemcacheError(STATUS_KEY_EXISTS) on conflict)."""
        return self._store(OP_SET, key, value, flags, exptime, cas)

    def add(self, key, value, flags: int = 0, exptime: int = 0) -> int:
        return self._store(OP_ADD, key, value, flags, exptime, 0)

    def replace(self, key, value, flags: int = 0, exptime: int = 0) -> int:
        return self._store(OP_REPLACE, key, value, flags, exptime, 0)

    def _concat(self, opcode: int, key, value) -> int:
        resp = self._call(opcode, self._key(key), self._val(value))
        if resp.status != STATUS_OK:
            self._raise(resp)
        return resp.cas

    def append(self, key, value) -> int:
        return self._concat(OP_APPEND, key, value)

    def prepend(self, key, value) -> int:
        return self._concat(OP_PREPEND, key, value)

    def delete(self, key) -> bool:
        resp = self._call(OP_DELETE, self._key(key))
        if resp.status == STATUS_KEY_NOT_FOUND:
            return False
        if resp.status != STATUS_OK:
            self._raise(resp)
        return True

    def _arith(self, opcode: int, key, delta: int, initial: int,
               exptime: int) -> int:
        extras = struct.pack(">QQI", delta, initial, exptime)
        resp = self._call(opcode, self._key(key), extras=extras)
        if resp.status != STATUS_OK:
            self._raise(resp)
        return struct.unpack(">Q", resp.value)[0]

    def incr(self, key, delta: int = 1, initial: int = 0,
             exptime: int = 0) -> int:
        return self._arith(OP_INCREMENT, key, delta, initial, exptime)

    def decr(self, key, delta: int = 1, initial: int = 0,
             exptime: int = 0) -> int:
        return self._arith(OP_DECREMENT, key, delta, initial, exptime)

    def touch(self, key, exptime: int) -> bool:
        resp = self._call(OP_TOUCH, self._key(key),
                          extras=struct.pack(">I", exptime))
        if resp.status == STATUS_KEY_NOT_FOUND:
            return False
        if resp.status != STATUS_OK:
            self._raise(resp)
        return True

    def version(self) -> str:
        resp = self._call(OP_VERSION)
        if resp.status != STATUS_OK:
            self._raise(resp)
        return resp.value.decode("latin1")

    def flush_all(self, delay: int = 0) -> None:
        extras = struct.pack(">I", delay) if delay else b""
        resp = self._call(OP_FLUSH, extras=extras)
        if resp.status != STATUS_OK:
            self._raise(resp)

    def noop(self) -> None:
        resp = self._call(OP_NOOP)
        if resp.status != STATUS_OK:
            self._raise(resp)

    def pipeline_get(self, keys: List) -> List[Optional[GetResult]]:
        """Batched multi-get: N GET requests in one write, N replies."""
        if not keys:
            return []
        opaques = [next(self._opaque) for _ in keys]
        batch = self._start(b"".join(
            pack_request(OP_GET, self._key(key), opaque=opaque)
            for key, opaque in zip(keys, opaques)), len(keys))
        results = self._wait(batch, "memcache pipeline_get")
        out: List[Optional[GetResult]] = []
        for resp, opaque in zip(results, opaques):
            if resp.opaque != opaque:
                if batch.socket is not None:
                    batch.socket.set_failed(
                        ConnectionError("memcache reply desync"))
                raise MemcacheError(-1, "reply desync (opaque mismatch)")
            if resp.status == STATUS_KEY_NOT_FOUND:
                out.append(None)
            elif resp.status != STATUS_OK:
                self._raise(resp)
            else:
                flags = (struct.unpack(">I", resp.extras)[0]
                         if len(resp.extras) >= 4 else 0)
                out.append(GetResult(resp.value, flags, resp.cas))
        return out


_instance: Optional[MemcacheProtocol] = None


def ensure_registered() -> MemcacheProtocol:
    global _instance
    if _instance is None:
        _instance = MemcacheProtocol()
        register_protocol(_instance)
    return _instance
