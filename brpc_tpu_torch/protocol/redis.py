"""Redis's RESP2: the codec, the server's command table and a pipelined
client (the port of brpc_tpu/protocol/redis.py; bRPC's redis.h:240 and
policy/redis_protocol.cpp:428).

RESP replies carry no correlation id: a connection answers in command
order, so the client (``RedisClient``, on ``transport/pipelined.py``)
matches replies to its batches in parse order, and the server answers a
connection's commands one at a time in parse order
(``process_in_parse_order``), each through the server's limiters (its
row ``redis.<NAME>`` on ``/status``).

The rules kept from the reference: an inline (telnet-style) command is
taken only on a connection that has already spoken RESP, since any text
protocol would match it otherwise; a line longer than 1 MiB without its
CRLF, or nesting deeper than 32, is no RESP; ``PING`` answers ``PONG``
when the service has no handler of its own; a corrupt stream on an
established connection fails that connection, never the process.
Credentials are the service's business: a ``RedisService`` implements
``AUTH`` as a command like any other (``ServerOptions.auth`` does not
gate RESP).
"""

from __future__ import annotations

import inspect
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from brpc_tpu_torch.protocol.registry import (PARSE_NOT_ENOUGH_DATA,
                                              PARSE_OK, PARSE_TRY_OTHERS,
                                              Protocol, register_protocol)
from brpc_tpu_torch.transport.pipelined import PipelinedClient

_MAX_LINE = 1 << 20            # an unterminated line past this is no RESP
_MAX_DEPTH = 32
_RESP_FIRST = (b"*", b"+", b"-", b":", b"$")


class RedisStatus(str):
    """A +simple-string reply ("OK", "PONG"), told apart from bulk data."""


class RedisError(Exception):
    """An -error reply: returned, not raised, inside a pipeline's
    results."""

    def __eq__(self, other):
        return isinstance(other, RedisError) and self.args == other.args

    def __hash__(self):
        return hash(("RedisError",) + self.args)


class _NeedMore(Exception):
    pass


class BadWire(Exception):
    """Bytes that can never be RESP."""


# ------------------------------------------------------------------ codec

def encode_command(args) -> bytes:
    """One command as a multi-bulk array: ["SET", "k", 1] ->
    ``*3\\r\\n$3\\r\\nSET\\r\\n$1\\r\\nk\\r\\n$1\\r\\n1\\r\\n``."""
    out = [b"*%d\r\n" % len(args)]
    for a in args:
        if isinstance(a, str):
            a = a.encode()
        elif isinstance(a, bool):
            # before int: repr would give b"True"
            a = b"1" if a else b"0"
        elif isinstance(a, (int, float)):
            a = repr(a).encode()
        elif not isinstance(a, (bytes, bytearray, memoryview)):
            raise TypeError(f"bad redis argument type {type(a)!r}")
        a = bytes(a)
        out.append(b"$%d\r\n%s\r\n" % (len(a), a))
    return b"".join(out)


def encode_reply(value) -> bytes:
    """A handler's return value as the server's reply."""
    if isinstance(value, RedisStatus):
        return b"+%s\r\n" % str(value).encode()
    if isinstance(value, RedisError):
        msg = value.args[0] if value.args else "ERR"
        return b"-%s\r\n" % str(msg).encode()
    if isinstance(value, bool):
        return b":%d\r\n" % int(value)
    if isinstance(value, int):
        return b":%d\r\n" % value
    if value is None:
        return b"$-1\r\n"
    if isinstance(value, str):
        value = value.encode()
    if isinstance(value, (bytes, bytearray, memoryview)):
        value = bytes(value)
        return b"$%d\r\n%s\r\n" % (len(value), value)
    if isinstance(value, (list, tuple)):
        return b"*%d\r\n" % len(value) + b"".join(encode_reply(v)
                                                   for v in value)
    raise TypeError(f"cannot encode redis reply of type {type(value)!r}")


def parse_value(data: bytes, pos: int, inline_ok: bool = False,
                depth: int = 0) -> Tuple[Any, int]:
    """One RESP value at ``pos`` and the position after it. Raises
    ``_NeedMore`` on a valid prefix, ``BadWire`` on bytes that can never
    be RESP."""
    if depth > _MAX_DEPTH:
        # the nesting is the peer's to choose: a cap, not the stack
        raise BadWire("RESP nesting too deep")
    if pos >= len(data):
        raise _NeedMore
    t = data[pos:pos + 1]
    eol = data.find(b"\r\n", pos)
    if eol < 0:
        if len(data) - pos > _MAX_LINE:
            raise BadWire("unterminated line")
        raise _NeedMore
    line = data[pos + 1:eol]
    nxt = eol + 2
    if t == b"+":
        return RedisStatus(line.decode("latin1")), nxt
    if t == b"-":
        return RedisError(line.decode("latin1")), nxt
    if t == b":":
        try:
            return int(line), nxt
        except ValueError:
            raise BadWire("bad integer") from None
    if t == b"$":
        try:
            n = int(line)
        except ValueError:
            raise BadWire("bad bulk length") from None
        if n == -1:
            return None, nxt
        if n < 0:
            raise BadWire("negative bulk length")
        if len(data) < nxt + n + 2:
            raise _NeedMore
        if data[nxt + n:nxt + n + 2] != b"\r\n":
            raise BadWire("bulk not CRLF-terminated")
        return data[nxt:nxt + n], nxt + n + 2
    if t == b"*":
        try:
            n = int(line)
        except ValueError:
            raise BadWire("bad array length") from None
        if n == -1:
            return None, nxt
        if n < 0:
            raise BadWire("negative array length")
        out = []
        for _ in range(n):
            v, nxt = parse_value(data, nxt, False, depth + 1)
            out.append(v)
        return out, nxt
    if inline_ok:
        # a telnet-style command: the line's whitespace-split words
        words = data[pos:eol].split()
        if not words:
            raise BadWire("empty inline command")
        return [bytes(w) for w in words], nxt
    raise BadWire(f"bad RESP type byte {t!r}")


# ----------------------------------------------------------------- server

class RedisService:
    """The command table of ``ServerOptions.redis_service``. A handler
    takes ``(socket, args)``, the whole command as a list of bytes
    (``args[0]`` its name), may be a coroutine function, and returns any
    value ``encode_reply`` takes."""

    def __init__(self):
        self._handlers: Dict[str, Callable] = {}

    def add_command_handler(self, name: str, fn: Callable) -> None:
        self._handlers[name.upper()] = fn

    def command(self, name: Optional[str] = None):
        def deco(fn):
            self.add_command_handler(name or fn.__name__, fn)
            return fn
        return deco

    def find(self, name: bytes) -> Optional[Callable]:
        return self._handlers.get(name.decode("latin1").upper())


class _Burst(list):
    """The values cut from one peek (a pipelined burst that came in one
    read): one parse result, so N values cost one pass over the bytes;
    ``process_inline`` hands them on in order."""


class RedisProtocol(Protocol):
    name = "redis"

    def parse(self, portal, socket) -> Tuple[str, object]:
        first = portal.peek_bytes(1)
        if not first:
            return PARSE_NOT_ENOUGH_DATA, None
        ud = socket.user_data
        seen = ud.get("redis_seen", False)
        is_client = "redis_client" in ud
        if first not in _RESP_FIRST and not (seen or is_client):
            # an inline command only on a connection that spoke RESP
            return PARSE_TRY_OTHERS, None
        data = portal.peek_bytes(portal.size)
        values: List = []
        consumed = 0
        while consumed < len(data):
            try:
                value, consumed = parse_value(data, consumed,
                                              inline_ok=not is_client)
                values.append(value)
            except _NeedMore:
                break
            except BadWire:
                if values or seen or is_client:
                    # corruption on an established connection fails it,
                    # rather than letting another protocol eat the bytes
                    socket.set_failed(ConnectionError("corrupt RESP stream"))
                    return PARSE_NOT_ENOUGH_DATA, None
                return PARSE_TRY_OTHERS, None
        if not values:
            return PARSE_NOT_ENOUGH_DATA, None
        ud["redis_seen"] = True
        portal.pop_front(consumed)
        if len(values) == 1:
            return PARSE_OK, values[0]
        return PARSE_OK, _Burst(values)

    def process_inline(self, msg, socket) -> bool:
        """Both sides in parse order: a client's replies fill its FIFO
        batches here; a server's commands go through one drain fiber a
        connection."""
        vals = msg if isinstance(msg, _Burst) else (msg,)
        client = socket.user_data.get("redis_client")
        if client is not None:
            for v in vals:
                client._on_reply(socket, v)
            return True
        from brpc_tpu_torch.transport.input_messenger import (
            process_in_parse_order)
        for v in vals:
            process_in_parse_order(socket, "redis", v, self._run_command)
        return True

    async def _run_command(self, cmd, socket) -> None:
        server = socket.user_data.get("server")
        service: Optional[RedisService] = (
            server.options.redis_service if server is not None else None)
        if service is None:
            socket.write(encode_reply(RedisError(
                "ERR this server has no redis_service installed")))
            return
        if not isinstance(cmd, list) or not cmd or \
                not all(isinstance(a, bytes) for a in cmd):
            socket.write(encode_reply(RedisError("ERR bad command frame")))
            return
        handler = service.find(cmd[0])
        name = cmd[0].decode("latin1").upper()
        if handler is None:
            if name == "PING":
                socket.write(encode_reply(RedisStatus("PONG")))
                return
            socket.write(encode_reply(RedisError(
                f"ERR unknown command '{name}'")))
            return
        key = f"redis.{name}"
        cost = server.on_request_start(key)
        if not cost:
            socket.write(encode_reply(RedisError(
                "ERR max_concurrency reached")))
            return
        server._request_begin()
        t0 = time.monotonic_ns()
        error = False
        try:
            r = handler(socket, cmd)
            if inspect.isawaitable(r):
                r = await r
            out = encode_reply(r)
        except Exception as e:          # boundary: report, keep serving
            error = True
            out = encode_reply(RedisError(f"ERR handler error: {e}"))
        finally:
            server.on_request_end(key, (time.monotonic_ns() - t0) / 1e3,
                                  error, cost)
            server._request_done()
        socket.write(out)

    def process(self, msg, socket):
        raise AssertionError("redis messages are processed inline")


# ---------------------------------------------------------------- client

class RedisClient(PipelinedClient):
    """A pipelined RESP client on one connection: ``execute`` sends one
    command and returns its reply (an error reply raises); ``pipeline``
    sends N commands in one write and returns N replies (error replies
    in their places). ``_async`` twins for fibers. ``password`` and
    ``db`` send AUTH and SELECT first on every fresh connection."""

    user_data_key = "redis_client"

    def __init__(self, address, password: Optional[str] = None,
                 db: Optional[int] = None, timeout_s: float = 5.0,
                 control=None):
        super().__init__(address, ensure_registered(), timeout_s=timeout_s,
                         control=control)
        self._password = password
        self._db = db

    def _hello_commands(self) -> List[bytes]:
        hello = []
        if self._password is not None:
            hello.append(encode_command(["AUTH", self._password]))
        if self._db is not None:
            hello.append(encode_command(["SELECT", self._db]))
        return hello

    def _check_hello_reply(self, reply) -> None:
        if isinstance(reply, RedisError):
            raise reply

    @staticmethod
    def _one(results: List):
        v = results[0]
        if isinstance(v, RedisError):
            raise v
        return v

    def execute(self, *args):
        batch = self._start(encode_command(list(args)), 1)
        return self._one(self._wait(batch, f"redis {args[0]!r}"))

    def pipeline(self, cmds: List[List]) -> List:
        if not cmds:
            return []
        batch = self._start(b"".join(encode_command(c) for c in cmds),
                            len(cmds))
        return self._wait(batch, "redis pipeline")

    async def execute_async(self, *args):
        batch = self._start(encode_command(list(args)), 1)
        return self._one(await self._wait_async(batch,
                                                f"redis {args[0]!r}"))

    async def pipeline_async(self, cmds: List[List]) -> List:
        if not cmds:
            return []
        batch = self._start(b"".join(encode_command(c) for c in cmds),
                            len(cmds))
        return await self._wait_async(batch, "redis pipeline")


_instance: Optional[RedisProtocol] = None


def ensure_registered() -> RedisProtocol:
    global _instance
    if _instance is None:
        _instance = RedisProtocol()
        register_protocol(_instance)
    return _instance
