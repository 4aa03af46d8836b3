"""nshead: the 36-byte little-endian head of Baidu's legacy family and a
raw body (the port of brpc_tpu/protocol/nshead.py; bRPC's
policy/nshead_protocol.cpp and nshead_service.h).

    id:u16 version:u16 log_id:u32 provider:16s magic:u32 reserved:u32
    body_len:u32 | body                       (magic 0xFB709394 at 24)

Server side: ``ServerOptions.nshead_service``, one handler a server,
``(socket, NsheadMessage) -> NsheadMessage | bytes | None`` (None: no
reply), or an adaptor of ``protocol/nshead_pbrpc.py`` or
``protocol/mcpack.py`` over a ``Service``. A connection's requests are
answered in parse order (``process_in_parse_order``), each through the
server's limiters (its row ``nshead.process`` on ``/status``) and
counted in flight for ``join``. A raw-bytes reply does not take on the
request's ``version``: its bits are an adaptor's flags (nova's snappy
bit). A server with no ``nshead_service`` answers the head with an empty
body. nshead carries no credential, so a server with ``auth`` or
``auth_token`` refuses every nshead request: it drops the connection,
runs no handler and counts the refusal (``Server.refuse_uncredentialed``;
brpc_tpu answers such requests, ROADMAP section 3).

The client (``NsheadClient``) rides ``transport/pipelined.py``: nshead
has no correlation field, so replies match requests in connection order.

A prefix shorter than 28 bytes cannot show the magic: the parse's
disclaim of it is tentative (``min_probe_bytes``), and a body over
64 MiB fails the connection.
"""

from __future__ import annotations

import inspect
import struct
import time
from typing import Optional, Tuple

from brpc_tpu_torch.protocol.registry import (PARSE_NOT_ENOUGH_DATA,
                                              PARSE_OK, PARSE_TRY_OTHERS,
                                              Protocol, register_protocol)
from brpc_tpu_torch.transport.pipelined import PipelinedClient

NSHEAD_MAGIC = 0xFB709394
_HDR = struct.Struct("<HHI16sIII")
HEADER_SIZE = 36
_MAGIC_END = 28
_MAX_BODY = 64 << 20


class NsheadMessage:
    __slots__ = ("id", "version", "log_id", "provider", "body", "reserved")

    def __init__(self, body: bytes = b"", id: int = 0, version: int = 0,
                 log_id: int = 0, provider: bytes = b"brpc-tpu",
                 reserved: int = 0):
        self.id = id
        self.version = version
        self.log_id = log_id
        self.provider = provider[:16]
        self.body = bytes(body)
        # nova_pbrpc carries its method index here
        self.reserved = reserved

    def pack(self) -> bytes:
        return _HDR.pack(self.id, self.version, self.log_id,
                         self.provider.ljust(16, b"\x00"), NSHEAD_MAGIC,
                         self.reserved, len(self.body)) + self.body


def unpack_head(head: bytes) -> Tuple[int, int, int, bytes, int, int, int]:
    return _HDR.unpack(head)


def adaptor_controller(socket, service, method):
    """The Controller an adaptor hands ``service``'s ``method``: marked
    ``unary``, since its answer is one body (a Generate call answers its
    tokens, not the HTTP path's stream, which nshead has no way to carry),
    with the peer and the connection's identity as the other paths set
    them."""
    from brpc_tpu_torch.rpc.controller import Controller
    cntl = Controller()
    cntl.unary = True
    cntl.remote_side = socket.remote_endpoint
    cntl.auth_context = socket.user_data.get("auth_context")
    cntl._service_name, cntl._method_name = service.name, method.name
    return cntl


class NsheadProtocol(Protocol):
    name = "nshead"
    min_probe_bytes = _MAGIC_END

    def parse(self, portal, socket) -> Tuple[str, object]:
        head = portal.peek_bytes(min(HEADER_SIZE, portal.size))
        if len(head) < _MAGIC_END:
            return PARSE_TRY_OTHERS, None
        if struct.unpack_from("<I", head, 24)[0] != NSHEAD_MAGIC:
            return PARSE_TRY_OTHERS, None
        if len(head) < HEADER_SIZE:
            return PARSE_NOT_ENOUGH_DATA, None
        id_, version, log_id, provider, _magic, reserved, body_len = \
            _HDR.unpack(head)
        if body_len > _MAX_BODY:
            socket.set_failed(ConnectionError(
                f"nshead body of {body_len} bytes exceeds max"))
            return PARSE_NOT_ENOUGH_DATA, None
        if portal.size < HEADER_SIZE + body_len:
            socket.input_need = HEADER_SIZE + body_len
            return PARSE_NOT_ENOUGH_DATA, None
        portal.pop_front(HEADER_SIZE)
        body = portal.cut(body_len).to_bytes()
        return PARSE_OK, NsheadMessage(body, id_, version, log_id,
                                       provider.rstrip(b"\x00"),
                                       reserved=reserved)

    def process_inline(self, msg: NsheadMessage, socket) -> bool:
        client = socket.user_data.get("nshead_client")
        if client is not None:
            client._on_reply(socket, msg)
            return True
        from brpc_tpu_torch.transport.input_messenger import (
            process_in_parse_order)
        process_in_parse_order(socket, "nshead", msg, self._run_handler)
        return True

    async def _run_handler(self, msg: NsheadMessage, socket) -> None:
        server = socket.user_data.get("server")
        if server is None or socket.failed:
            return
        # nshead carries no credential: an auth server answers none, and
        # nova could not even say so, so the connection goes
        refused = server.refuse_uncredentialed("nshead")
        if refused is not None:
            socket.set_failed(ConnectionError(refused))
            return
        handler = server.options.nshead_service
        if handler is None:
            # no adaptor: the head back with an empty body
            socket.write(NsheadMessage(b"", msg.id, msg.version,
                                       msg.log_id).pack())
            return
        cost = server.on_request_start("nshead.process")
        if not cost:
            return
        server._request_begin()
        t0 = time.monotonic_ns()
        error = False
        reply = None
        try:
            r = handler(socket, msg)
            if inspect.isawaitable(r):
                r = await r
            reply = r
        except Exception:               # boundary: no reply, keep serving
            error = True
        finally:
            server.on_request_end("nshead.process",
                                  (time.monotonic_ns() - t0) / 1e3, error,
                                  cost)
            server._request_done()
        if reply is None:
            return
        if isinstance(reply, (bytes, bytearray, memoryview)):
            # not the request's version: its bits are adaptor flags
            reply = NsheadMessage(bytes(reply), msg.id, 0, msg.log_id)
        socket.write(reply.pack())

    def process(self, msg, socket):
        raise AssertionError("nshead messages are processed inline")


class NsheadClient(PipelinedClient):
    """nshead calls on one pipelined connection: ``call`` and its fiber
    twin ``call_async`` take a message or bare body bytes and return the
    reply's ``NsheadMessage``."""

    user_data_key = "nshead_client"

    def __init__(self, address, timeout_s: float = 5.0, control=None):
        super().__init__(address, ensure_registered(), timeout_s=timeout_s,
                         control=control)

    @staticmethod
    def _wire(msg) -> bytes:
        if isinstance(msg, (bytes, bytearray, memoryview)):
            msg = NsheadMessage(bytes(msg))
        return msg.pack()

    def call(self, msg) -> NsheadMessage:
        return self._wait(self._start(self._wire(msg), 1), "nshead call")[0]

    async def call_async(self, msg) -> NsheadMessage:
        batch = self._start(self._wire(msg), 1)
        return (await self._wait_async(batch, "nshead call"))[0]


_instance: Optional[NsheadProtocol] = None


def ensure_registered() -> NsheadProtocol:
    global _instance
    if _instance is None:
        _instance = NsheadProtocol()
        register_protocol(_instance)
    return _instance
