"""esp, the legacy stargate messaging format (the port of
brpc_tpu/protocol/esp.py; bRPC's policy/esp_protocol.cpp and
esp_message.h), as the reference lays it out:

    "SG" | to:u32 from:u32 flags:u32 msg_id:u32 body_len:u32 (LE) | body

Server side: ``ServerOptions.esp_service``, a handler ``(socket,
EspMessage) -> EspMessage | bytes | None`` (bytes: a reply addressed
back, with the request's ``msg_id``). A connection's requests are
handled in parse order, each through the server's limiters (its row
``esp.process`` on ``/status``) and counted in flight for ``join``. esp
has no error channel: a request on a server without ``esp_service``, or
whose handler raised, gets no reply. It carries no credential either, so
a server with ``auth`` or ``auth_token`` refuses every esp request: it
drops the connection, runs no handler and counts the refusal
(``Server.refuse_uncredentialed``; brpc_tpu answers such requests,
ROADMAP section 3). A body over 64 MiB fails the connection.

The client (``EspClient``) matches replies by ``msg_id``, so a server
may answer out of order and callers may share it: ``call`` blocks its
thread, ``call_async`` is the fiber twin. It has an InputMessenger over
esp alone and one port ``Socket`` on the process's dispatcher, which
never sticks (``Socket.sticky_ok`` stays False); a socket's failure
fails only the calls written to it, and the loser of a dial race is
closed. ``live_sockets()`` counts the clients' sockets not yet failed
(the tests' leak check).
"""

from __future__ import annotations

import inspect
import struct
import threading
import time
from typing import Dict, Optional, Tuple

from brpc_tpu_torch.butil.endpoint import str2endpoint
from brpc_tpu_torch.fiber import global_control
from brpc_tpu_torch.fiber.sync import FiberEvent
from brpc_tpu_torch.protocol.registry import (PARSE_NOT_ENOUGH_DATA,
                                              PARSE_OK, PARSE_TRY_OTHERS,
                                              Protocol, register_protocol)
from brpc_tpu_torch.transport.input_messenger import (InputMessenger,
                                                      process_in_parse_order)
from brpc_tpu_torch.transport.socket import create_client_socket

MAGIC = b"SG"
_HDR = struct.Struct("<2sIIIII")
HEADER_SIZE = 22
_MAX_BODY = 64 << 20

_live_lock = threading.Lock()
_live: set = set()


def live_sockets() -> int:
    """Sockets of EspClients that have not failed."""
    with _live_lock:
        return sum(1 for s in _live if not s.failed)


class EspMessage:
    __slots__ = ("to", "from_", "flags", "msg_id", "body")

    def __init__(self, body: bytes = b"", to: int = 0, from_: int = 0,
                 flags: int = 0, msg_id: int = 0):
        self.to = to
        self.from_ = from_
        self.flags = flags
        self.msg_id = msg_id
        self.body = bytes(body)

    def pack(self) -> bytes:
        return _HDR.pack(MAGIC, self.to, self.from_, self.flags,
                         self.msg_id, len(self.body)) + self.body


class EspProtocol(Protocol):
    name = "esp"

    def parse(self, portal, socket) -> Tuple[str, object]:
        head = portal.peek_bytes(min(HEADER_SIZE, portal.size))
        if MAGIC[:len(head)] != head[:2]:
            return PARSE_TRY_OTHERS, None
        if len(head) < HEADER_SIZE:
            return PARSE_NOT_ENOUGH_DATA, None
        _magic, to, from_, flags, msg_id, body_len = _HDR.unpack(head)
        if body_len > _MAX_BODY:
            socket.set_failed(ConnectionError("esp body exceeds max"))
            return PARSE_NOT_ENOUGH_DATA, None
        if portal.size < HEADER_SIZE + body_len:
            socket.input_need = HEADER_SIZE + body_len
            return PARSE_NOT_ENOUGH_DATA, None
        portal.pop_front(HEADER_SIZE)
        body = portal.cut(body_len).to_bytes()
        return PARSE_OK, EspMessage(body, to, from_, flags, msg_id)

    def process_inline(self, msg: EspMessage, socket) -> bool:
        client = socket.user_data.get("esp_client")
        if client is not None:
            client._on_reply(msg)
            return True
        process_in_parse_order(socket, "esp", msg, self._run_handler)
        return True

    async def _run_handler(self, msg: EspMessage, socket) -> None:
        server = socket.user_data.get("server")
        if server is None or socket.failed:
            return
        refused = server.refuse_uncredentialed("esp")
        if refused is not None:
            socket.set_failed(ConnectionError(refused))
            return
        handler = server.options.esp_service
        if handler is None:
            return                      # no error channel: no reply
        cost = server.on_request_start("esp.process")
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
            server.on_request_end("esp.process",
                                  (time.monotonic_ns() - t0) / 1e3, error,
                                  cost)
            server._request_done()
        if reply is None:
            return
        if isinstance(reply, (bytes, bytearray, memoryview)):
            reply = EspMessage(bytes(reply), to=msg.from_, from_=msg.to,
                               msg_id=msg.msg_id)
        socket.write(reply.pack())

    def process(self, msg, socket):
        raise AssertionError("esp messages are processed inline")


class _Slot:
    __slots__ = ("event", "result", "socket")

    def __init__(self, socket):
        self.event = FiberEvent()
        self.result = None              # the reply, or the failure
        self.socket = socket


class EspClient:
    """An esp client whose callers may share it (see the module's doc)."""

    def __init__(self, address, stargate_id: int = 0,
                 timeout_s: float = 5.0, control=None):
        self._endpoint = (str2endpoint(address) if isinstance(address, str)
                          else address)
        self._stargate_id = stargate_id
        self._timeout_s = timeout_s
        self._control = control or global_control()
        self._messenger = InputMessenger(protocols=[ensure_registered()],
                                         control=self._control)
        self._lock = threading.Lock()
        self._socket = None
        self._next_id = 1
        self._pending: Dict[int, _Slot] = {}

    def _get_socket(self):
        with self._lock:
            s = self._socket
        if s is not None and not s.failed:
            return s
        new = create_client_socket(
            self._endpoint, on_input=self._messenger.on_new_messages,
            control=self._control)
        new.user_data["esp_client"] = self
        new.user_data["protocol"] = "esp"
        with _live_lock:
            _live.add(new)
        new.on_failed(self._on_socket_failed)
        with self._lock:
            if self._socket is not None and not self._socket.failed:
                loser, new = new, self._socket
            else:
                self._socket, loser = new, None
        if loser is not None:
            loser.set_failed(ConnectionError("duplicate connect discarded"))
        return new

    def _on_socket_failed(self, socket) -> None:
        """Fail the calls written to this socket only: the loser of a dial
        race dies with none."""
        with _live_lock:
            _live.discard(socket)
        with self._lock:
            if self._socket is socket:
                self._socket = None
            failed = [i for i, s in self._pending.items()
                      if s.socket is socket]
            slots = [self._pending.pop(i) for i in failed]
        err = socket.fail_reason or ConnectionError("esp connection failed")
        for slot in slots:
            slot.result = err
            slot.event.set()

    def _on_reply(self, msg: EspMessage) -> None:
        with self._lock:
            slot = self._pending.pop(msg.msg_id, None)
        if slot is not None:
            slot.result = msg
            slot.event.set()

    def _issue(self, to: int, body: bytes, flags: int) -> Tuple[int, _Slot]:
        socket = self._get_socket()
        with self._lock:
            msg_id = self._next_id
            self._next_id = (self._next_id + 1) & 0xFFFFFFFF or 1
            slot = _Slot(socket)
            self._pending[msg_id] = slot
        msg = EspMessage(body, to=to, from_=self._stargate_id, flags=flags,
                         msg_id=msg_id)
        if not socket.write(msg.pack()):
            self._on_socket_failed(socket)
        return msg_id, slot

    def _settle(self, msg_id: int, slot: _Slot,
                completed: bool) -> EspMessage:
        if not completed:
            with self._lock:
                self._pending.pop(msg_id, None)
            raise TimeoutError("esp call timed out")
        if isinstance(slot.result, BaseException):
            raise slot.result
        return slot.result

    def call(self, to: int, body: bytes, flags: int = 0) -> EspMessage:
        """Blocks the calling thread; fibers use ``call_async``."""
        msg_id, slot = self._issue(to, body, flags)
        return self._settle(msg_id, slot,
                            slot.event.wait_pthread(self._timeout_s))

    async def call_async(self, to: int, body: bytes,
                         flags: int = 0) -> EspMessage:
        msg_id, slot = self._issue(to, body, flags)
        return self._settle(msg_id, slot,
                            await slot.event.wait(self._timeout_s))

    def close(self) -> None:
        with self._lock:
            s, self._socket = self._socket, None
        if s is not None and not s.failed:
            s.set_failed(ConnectionError("esp client closed"))


_instance: Optional[EspProtocol] = None


def ensure_registered() -> EspProtocol:
    global _instance
    if _instance is None:
        _instance = EspProtocol()
        register_protocol(_instance)
    return _instance
