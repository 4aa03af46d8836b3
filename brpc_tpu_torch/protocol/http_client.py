"""The HTTP/1.1 client: keep-alive connections over the port's sockets
and fibers, with buffered or progressive bodies (the port of
brpc_tpu/protocol/http_client.py; bRPC's policy/http_rpc_protocol.cpp
client side and progressive_reader.h).

``HttpClient.request(...)`` returns ``(status, headers, body)``; with
``on_chunk=`` the body's parts go to the callback as they arrive and the
returned body is empty. Bodies end by Content-Length, by chunked
transfer (each chunk delivered as it is parsed: that is what makes the
reading progressive), or at the connection's close (HTTP/1.0 style).
HEAD, 1xx, 204 and 304 answers have no body, whatever their headers say.
A buffered body in ``Content-Encoding`` gzip or deflate is decoded.
The caller's headers, ``Authorization`` among them, go out as given.

The head phase calls fastcore's ``http_parse_resp_head`` (httpparse.cc)
when the native core loads, and its pure twin, ``parse_resp_head``,
under ``BRPC_TPU_TORCH_NO_NATIVE=1`` or where the C parse defers: both
answer what the reference's classic loop answers.
``nnative_resp_heads`` counts the heads the C parse read.

Responses on one connection come in request order, so the calls in
flight form a FIFO, and a request is queued and written under one lock
(the wire's order is the queue's). A call belongs to the socket it went
out on: a stale socket failing late fails only its own calls.
``_resolve_eof`` judges a dead connection once every byte it delivered
was parsed: a close-delimited body that got its head is complete;
anything else on that socket failed.
"""

from __future__ import annotations

import gzip
import threading
import weakref
import zlib
from collections import deque
from typing import Callable, Dict, Optional, Tuple, Union

from brpc_tpu_torch.butil.endpoint import EndPoint, str2endpoint
from brpc_tpu_torch.bvar.reducer import Adder
from brpc_tpu_torch.fiber import TaskControl, global_control
from brpc_tpu_torch.fiber.sync import FiberEvent
from brpc_tpu_torch.protocol.registry import (PARSE_NOT_ENOUGH_DATA,
                                              PARSE_OK, PARSE_TRY_OTHERS,
                                              Protocol)

MAX_HEADER = 64 * 1024
MAX_CHUNK_LINE = 128
_PROBE = b"HTTP/1."

# response heads the native parse read
nnative_resp_heads = Adder().expose("http_client_native_heads")

_fc = False             # the extension, resolved at the first head


def _fastcore():
    """fastcore, or None (not built, ``BRPC_TPU_TORCH_NO_NATIVE=1``)."""
    global _fc
    if _fc is False:
        from brpc_tpu_torch.native import fastcore
        m = fastcore.get()
        _fc = m if m is not None and hasattr(m, "http_parse_resp_head") \
            else None
    return _fc


_clients: "weakref.WeakSet[HttpClient]" = weakref.WeakSet()


def live_clients() -> int:
    """Clients holding an open connection."""
    return sum(1 for c in list(_clients)
               if c._socket is not None and not c._socket.failed)


class HttpClientError(ConnectionError):
    pass


def parse_resp_head(raw: bytes):
    """The pure head parse of ``raw`` (the connection's first bytes):
    ``(head_len, status, headers)``, None for more bytes, or -1 for bytes
    that are no HTTP/1.x response (the native parse's answers)."""
    if not raw.startswith(_PROBE[:len(raw)]):
        return -1
    sep = raw.find(b"\r\n\r\n")
    if sep < 0:
        return -1 if len(raw) >= MAX_HEADER else None
    lines = raw[:sep].split(b"\r\n")
    try:
        _version, code, *_ = lines[0].decode("latin1").split(" ", 2)
        status = int(code)
    except ValueError:
        return -1
    headers = {}
    for line in lines[1:]:
        k, _, v = line.decode("latin1").partition(":")
        headers[k.strip().lower()] = v.strip()
    return sep + 4, status, headers


class _RespState:
    """A socket's parse state: one response at the head of the FIFO."""

    __slots__ = ("phase", "status", "headers", "mode", "remaining")

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        # head | body | chunk_size | chunk_data | trailers
        self.phase = "head"
        self.status = 0
        self.headers: Dict[str, str] = {}
        self.mode = ""                  # length | chunked | close
        self.remaining = 0


_END = ("end", None, None, None)


class HttpResponseProtocol(Protocol):
    """HTTP/1.1 responses as events: ``("head", status, headers, mode)``,
    ``("chunk", bytes, ..)``, ``("end", ..)``; the client-side twin of
    ``protocol/http.py``'s request parse."""

    name = "http_client"
    min_probe_bytes = len(_PROBE)

    def parse(self, portal, socket):
        st = socket.user_data.get("http_resp_state")
        if st is None:
            st = socket.user_data["http_resp_state"] = _RespState()
        phase = st.phase
        if phase == "head":
            return self._parse_head(portal, socket, st)
        if phase == "body":
            if not portal:
                return PARSE_NOT_ENOUGH_DATA, None
            if st.mode == "close":
                # its end is the connection's (``_resolve_eof``)
                return PARSE_OK, [("chunk", portal.cut(portal.size)
                                   .to_bytes(), None, None)]
            n = min(portal.size, st.remaining)
            data = portal.cut(n).to_bytes()
            st.remaining -= n
            if st.remaining == 0:
                st.reset()
                return PARSE_OK, [("chunk", data, None, None), _END]
            return PARSE_OK, [("chunk", data, None, None)]
        if phase == "chunk_size":
            raw = portal.peek_bytes(MAX_CHUNK_LINE)
            nl = raw.find(b"\r\n")
            if nl < 0:
                if portal.size >= MAX_CHUNK_LINE:
                    return PARSE_TRY_OTHERS, None     # malformed: drop
                return PARSE_NOT_ENOUGH_DATA, None
            try:
                size = int(raw[:nl].split(b";")[0].strip() or b"0", 16)
            except ValueError:
                return PARSE_TRY_OTHERS, None
            portal.pop_front(nl + 2)
            if size == 0:
                st.phase = "trailers"
            else:
                st.remaining = size
                st.phase = "chunk_data"
            return PARSE_OK, []
        if phase == "chunk_data":
            if portal.size < st.remaining + 2:
                # a part of the chunk, passed on as it comes
                n = min(portal.size, st.remaining)
                if n == 0:
                    return PARSE_NOT_ENOUGH_DATA, None
                st.remaining -= n
                return PARSE_OK, [("chunk", portal.cut(n).to_bytes(),
                                   None, None)]
            data = portal.cut(st.remaining).to_bytes() if st.remaining \
                else b""
            portal.pop_front(2)
            st.remaining = 0
            st.phase = "chunk_size"
            return PARSE_OK, ([("chunk", data, None, None)] if data else [])
        if phase == "trailers":
            raw = portal.peek_bytes(MAX_HEADER)
            if raw.startswith(b"\r\n"):
                portal.pop_front(2)
                st.reset()
                return PARSE_OK, [_END]
            sep = raw.find(b"\r\n\r\n")
            if sep < 0:
                if portal.size >= MAX_HEADER:
                    return PARSE_TRY_OTHERS, None
                return PARSE_NOT_ENOUGH_DATA, None
            portal.pop_front(sep + 4)   # trailer fields are dropped
            st.reset()
            return PARSE_OK, [_END]
        return PARSE_TRY_OTHERS, None

    @staticmethod
    def _parse_head(portal, socket, st: _RespState):
        raw = portal.peek_bytes(MAX_HEADER)
        fc = _fastcore()
        parsed = fc.http_parse_resp_head(raw, MAX_HEADER) \
            if fc is not None else -2
        if isinstance(parsed, tuple):
            nnative_resp_heads.add(1)
        elif parsed == -2:              # only the pure parse can judge
            parsed = parse_resp_head(raw)
        if parsed is None:
            return PARSE_NOT_ENOUGH_DATA, None
        if parsed == -1:
            return PARSE_TRY_OTHERS, None
        head_len, st.status, st.headers = parsed
        portal.pop_front(head_len)
        # bodiless by RFC 9110 section 6.4.1: an answer to HEAD, 1xx,
        # 204 and 304, whatever their entity headers say
        expect = socket.user_data.get("http_expect_head")
        was_head = bool(expect.popleft()) if expect else False
        status = st.status
        te = st.headers.get("transfer-encoding", "").lower()
        if was_head or status in (204, 304) or 100 <= status < 200:
            st.mode = "length"
        elif "chunked" in te:
            st.mode, st.phase = "chunked", "chunk_size"
        elif "content-length" in st.headers:
            st.mode = "length"
            try:
                st.remaining = int(st.headers["content-length"])
            except ValueError:
                return PARSE_TRY_OTHERS, None
            if st.remaining < 0:
                return PARSE_TRY_OTHERS, None
            if st.remaining:
                st.phase = "body"
        else:
            st.mode, st.phase = "close", "body"
        msg = ("head", status, dict(st.headers), st.mode)
        if st.phase == "head":          # no body, or an empty one
            st.reset()
            return PARSE_OK, [msg, _END]
        return PARSE_OK, [msg]

    def process_inline(self, events, socket) -> bool:
        client = socket.user_data.get("http_client")
        if client is not None:
            for ev in events:
                client._on_event(socket, ev)
            # a dead connection is judged after its buffered tail parsed:
            # set_failed ran before these bytes reached the parse
            if socket.failed and not socket.input_portal:
                client._resolve_eof(socket)
        return True

    def process(self, msg, socket):     # every event is handled inline
        return None


class _Pending:
    __slots__ = ("done", "status", "headers", "body", "on_chunk", "mode",
                 "error", "sock")

    def __init__(self, on_chunk, sock):
        self.done = FiberEvent()
        self.status = 0
        self.headers: Dict[str, str] = {}
        self.body = bytearray()
        self.on_chunk = on_chunk
        self.mode = ""
        self.error: Optional[BaseException] = None
        self.sock = sock                # only this socket's end fails it


Response = Tuple[int, Dict[str, str], bytes]


class HttpClient:
    """Keep-alive HTTP/1.1 over one connection at a time: requests on a
    client are answered in order. ``request`` blocks the calling thread;
    a fiber uses ``request_async``."""

    def __init__(self, address: Union[str, EndPoint],
                 timeout_s: float = 10.0,
                 control: Optional[TaskControl] = None):
        from brpc_tpu_torch.transport.input_messenger import InputMessenger
        self._endpoint = address if isinstance(address, EndPoint) else \
            str2endpoint(address, default_scheme="tcp")
        self._timeout_s = timeout_s
        self._control = control or global_control()
        self._messenger = InputMessenger(protocols=[HttpResponseProtocol()],
                                         control=self._control)
        self._lock = threading.Lock()
        self._socket = None
        self._pending: deque = deque()
        _clients.add(self)

    # ------------------------------------------------------------ plumbing
    def _get_socket(self):
        """The live connection, or a new one: dialled outside the lock,
        one winner kept, a loser closed."""
        with self._lock:
            s = self._socket
            if s is not None and not s.failed:
                return s
        from brpc_tpu_torch.transport.socket import create_client_socket
        new = create_client_socket(
            self._endpoint, on_input=self._messenger.on_new_messages,
            control=self._control)
        new.user_data["http_client"] = self
        new.on_failed(self._on_socket_failed)
        with self._lock:
            if self._socket is not None and not self._socket.failed:
                winner, loser = self._socket, new
            else:
                self._socket, winner, loser = new, new, None
        if loser is not None:
            loser.set_failed(ConnectionError("duplicate connect discarded"))
        return winner

    def _on_socket_failed(self, sock) -> None:
        # bytes read before the EOF still parse after this callback; the
        # judgement waits for them (process_inline), unless none wait
        if not sock.input_portal:
            self._resolve_eof(sock)

    def _resolve_eof(self, sock) -> None:
        """``sock`` is dead and every byte it delivered was parsed: a
        close-delimited body with its head is complete; every other call
        on that socket failed. Calls on a later socket are untouched."""
        state = sock.user_data.get("http_resp_state")
        with self._lock:
            mine = [p for p in self._pending if p.sock is sock]
            for p in mine:
                self._pending.remove(p)
        complete = (state is not None and state.mode == "close"
                    and state.phase == "body")
        for i, p in enumerate(mine):
            if i == 0 and complete and p.status:
                state.reset()
            elif p.error is None:
                p.error = sock.fail_reason or ConnectionError(
                    "connection failed")
            p.done.set()

    def _on_event(self, sock, ev) -> None:
        with self._lock:
            p = self._pending[0] if self._pending else None
        if p is None or p.sock is not sock:
            return                      # unsolicited: the conn will fail
        kind = ev[0]
        if kind == "head":
            p.status, p.headers, p.mode = ev[1], ev[2], ev[3]
        elif kind == "chunk":
            if p.on_chunk is None:
                p.body += ev[1]
            else:
                try:
                    p.on_chunk(ev[1])
                except Exception:       # boundary: the caller's callback
                    pass
        elif kind == "end":
            with self._lock:
                if self._pending and self._pending[0] is p:
                    self._pending.popleft()
            p.done.set()

    # ---------------------------------------------------------------- api
    def _issue(self, method: str, path: str,
               headers: Optional[Dict[str, str]], body: bytes,
               on_chunk) -> _Pending:
        try:
            sock = self._get_socket()
        except OSError as e:
            raise HttpClientError(f"connect failed: {e}") from e
        hdrs = {"host": f"{self._endpoint.host}:{self._endpoint.port}",
                "accept": "*/*"}
        if body:
            hdrs["content-length"] = str(len(body))
        if headers:
            hdrs.update({k.lower(): v for k, v in headers.items()})
        lines = [f"{method.upper()} {path} HTTP/1.1"]
        lines += [f"{k}: {v}" for k, v in hdrs.items()]
        wire = ("\r\n".join(lines) + "\r\n\r\n").encode("latin1") + body
        p = _Pending(on_chunk, sock)
        with self._lock:
            # queued and written under one lock: the FIFO's order is the
            # wire's, or responses would match the wrong calls
            self._pending.append(p)
            sock.user_data.setdefault("http_expect_head", deque()).append(
                method.upper() == "HEAD")
            sock.write(wire)
        return p

    def _on_wait_timeout(self, p: _Pending) -> None:
        with self._lock:
            try:
                self._pending.remove(p)
            except ValueError:
                pass
        # a late answer would match the next call: drop the connection
        p.sock.set_failed(TimeoutError("http response timed out"))

    @staticmethod
    def _finish(p: _Pending, on_chunk) -> Response:
        if p.error is not None:
            raise HttpClientError(str(p.error))
        body = bytes(p.body)
        if on_chunk is None:
            enc = p.headers.get("content-encoding", "").lower()
            try:
                if enc == "gzip":
                    body = gzip.decompress(body)
                elif enc == "deflate":
                    body = zlib.decompress(body)
            except Exception:           # undecodable: deliver it raw
                pass
        return p.status, p.headers, body

    def request(self, method: str, path: str,
                headers: Optional[Dict[str, str]] = None,
                body: bytes = b"",
                on_chunk: Optional[Callable[[bytes], None]] = None,
                timeout_s: Optional[float] = None) -> Response:
        """``(status, headers, body)``; with ``on_chunk`` the body's parts
        go to the callback and the body returned is empty. Raises
        HttpClientError on a transport failure or at the timeout. Blocks
        the calling thread: a fiber that called it would park its worker,
        so fibers use ``request_async``."""
        p = self._issue(method, path, headers, body, on_chunk)
        if not p.done.wait_pthread(timeout_s or self._timeout_s):
            self._on_wait_timeout(p)
            raise HttpClientError("http response timed out")
        return self._finish(p, on_chunk)

    async def request_async(self, method: str, path: str,
                            headers: Optional[Dict[str, str]] = None,
                            body: bytes = b"",
                            on_chunk: Optional[Callable[[bytes],
                                                        None]] = None,
                            timeout_s: Optional[float] = None) -> Response:
        """``request`` for a fiber: it parks, its worker goes on."""
        p = self._issue(method, path, headers, body, on_chunk)
        if not await p.done.wait(timeout_s or self._timeout_s):
            self._on_wait_timeout(p)
            raise HttpClientError("http response timed out")
        return self._finish(p, on_chunk)

    def get(self, path: str, **kw) -> Response:
        return self.request("GET", path, **kw)

    def post(self, path: str, body: bytes = b"",
             content_type: str = "application/octet-stream",
             **kw) -> Response:
        headers = dict(kw.pop("headers", None) or {})
        headers.setdefault("content-type", content_type)
        return self.request("POST", path, headers=headers, body=body, **kw)

    def close(self) -> None:
        with self._lock:
            s, self._socket = self._socket, None
        if s is not None:
            s.set_failed(ConnectionError("client closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
