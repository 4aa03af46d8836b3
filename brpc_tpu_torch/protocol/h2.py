"""HTTP/2 (RFC 7540) and gRPC (the port of brpc_tpu/protocol/h2.py;
bRPC's policy/http2_rpc_protocol.cpp, details/hpack.cpp, grpc.{h,cpp}).

One ``H2Session`` is one connection, either side: the preface, the
SETTINGS exchange, HPACK (``protocol/hpack.py``), streams, flow control
both ways (1 MiB stream windows and a 16 MiB connection window offered,
refilled at half), PING, GOAWAY, RST_STREAM, CONTINUATION and padding.
Frames are fed in wire order on the connection's input path, so the
receiving state needs no lock; every write takes the session's
``_lock``, because handler fibers answer while the input path sends
SETTINGS and WINDOW_UPDATE and PING acks, and the frames of two streams
must never interleave inside one write.

Server side, ``H2ServerProtocol`` is the registry's ``h2``: it sniffs the
client preface, cuts frames (one larger than the 16 KiB we advertise
fails the connection), and hands each completed stream to a handler
fiber:

- ``content-type: application/grpc*``: a unary call into the server's
  methods (``Server.find_method`` with the package-qualified fallback),
  through the same gate as the HTTP path (``Server._auth_refused``: the
  ``authorization: Bearer`` metadata, once a connection; a refusal
  answers UNAUTHENTICATED and runs no handler), the interceptor, the
  limiters (``on_request_start``/``on_request_end``, which put the call
  under its method on ``/status``), and ``grpc-timeout`` as the call's
  deadline, which the server answers DEADLINE_EXCEEDED at. The
  handler's Controller is marked ``unary``: a method that would stream
  answers in one message instead (Generate, ``serving/service.py``). A
  handler error answers INTERNAL with its text, a failed call the
  status of its errno (``errno_to_grpc_status``), never an empty OK.
- anything else: plain HTTP through ``Server._call_http`` (its auth
  gate, the builtin pages, ``/<Service>/<Method>``), answered in one
  DATA frame.

Client side, ``GrpcChannel`` (unary ``call`` and ``call_async`` with
deadlines) and ``Http2Client`` (plain requests) drive a session of their
own over a client socket. They dial outside their lock, publish one
winner and close the loser (the rule of ``transport/socket_map.py``),
and never let their socket stick (no probe before reuse guards it). A
failed connection, or a GOAWAY that leaves a stream out, fails the calls
on it with UNAVAILABLE at once. A method's request and response are raw
bytes, as every method of the port's is.

The differences from the reference are repairs: its gRPC path checks no
credential and hands Generate a Controller that makes it stream into a
body nobody reads, answering an empty OK (ROADMAP section 3).
"""

from __future__ import annotations

import gzip
import inspect
import logging
import struct
import threading
import time
import urllib.parse
import weakref
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from brpc_tpu_torch.butil.endpoint import EndPoint, str2endpoint
from brpc_tpu_torch.fiber import TaskControl, global_control
from brpc_tpu_torch.fiber.sync import FiberEvent
from brpc_tpu_torch.fiber.timer import global_timer
from brpc_tpu_torch.protocol.hpack import HpackDecoder, HpackEncoder, HpackError
from brpc_tpu_torch.protocol.registry import (PARSE_NOT_ENOUGH_DATA,
                                              PARSE_OK, PARSE_TRY_OTHERS,
                                              Protocol, register_protocol)

log = logging.getLogger("brpc_tpu_torch.rpc")

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

# frame types
DATA, HEADERS, PRIORITY, RST_STREAM, SETTINGS, PUSH_PROMISE, PING, GOAWAY, \
    WINDOW_UPDATE, CONTINUATION = range(10)

# flags
FLAG_END_STREAM = 0x1           # DATA, HEADERS
FLAG_ACK = 0x1                  # SETTINGS, PING
FLAG_END_HEADERS = 0x4
FLAG_PADDED = 0x8
FLAG_PRIORITY = 0x20

# settings
S_HEADER_TABLE_SIZE = 1
S_ENABLE_PUSH = 2
S_MAX_CONCURRENT_STREAMS = 3
S_INITIAL_WINDOW_SIZE = 4
S_MAX_FRAME_SIZE = 5
S_MAX_HEADER_LIST_SIZE = 6

# error codes (RFC 7540 section 7)
NO_ERROR, PROTOCOL_ERROR, INTERNAL_ERROR, FLOW_CONTROL_ERROR, \
    SETTINGS_TIMEOUT, STREAM_CLOSED, FRAME_SIZE_ERROR, REFUSED_STREAM, \
    CANCEL, COMPRESSION_ERROR, CONNECT_ERROR, ENHANCE_YOUR_CALM, \
    INADEQUATE_SECURITY, HTTP_1_1_REQUIRED = range(14)

DEFAULT_WINDOW = 65535
DEFAULT_FRAME_SIZE = 16384
OUR_INITIAL_WINDOW = 1 << 20    # each stream's receive window
OUR_CONN_WINDOW = 1 << 24       # the connection's, widened at the preface
OUR_MAX_FRAME_SIZE = 16384

# what a stream's send queue holds: DATA bytes the windows hold back,
# and the header blocks (trailers) queued behind them
_DATA_ITEM, _HEADERS_ITEM = "data", "headers"

_sessions: "weakref.WeakSet[H2Session]" = weakref.WeakSet()
_channels: "weakref.WeakSet[GrpcChannel]" = weakref.WeakSet()


def live_sessions() -> int:
    """Sessions, either side, whose connection is still open."""
    return sum(1 for s in list(_sessions) if not s.socket.failed)


def live_channels() -> int:
    """Client channels holding an open connection."""
    return sum(1 for c in list(_channels) if c._open_session() is not None)


def pack_frame(ftype: int, flags: int, stream_id: int,
               payload: bytes = b"") -> bytes:
    n = len(payload)
    return b"".join((bytes((n >> 16 & 0xFF, n >> 8 & 0xFF, n & 0xFF, ftype,
                            flags)),
                     struct.pack(">I", stream_id & 0x7FFFFFFF), payload))


class H2Error(Exception):
    def __init__(self, code: int, msg: str):
        super().__init__(msg)
        self.code = code


class H2Stream:
    __slots__ = ("id", "session", "headers", "trailers", "data",
                 "recv_window", "send_window", "closed_local",
                 "closed_remote", "reset", "blocked", "on_complete",
                 "answered")

    def __init__(self, sid: int, session: "H2Session"):
        self.id = sid
        self.session = session
        self.headers: List[Tuple[str, str]] = []
        self.trailers: List[Tuple[str, str]] = []
        self.data = bytearray()
        self.recv_window = session.our_initial_window
        self.send_window = session.peer_initial_window
        self.closed_local = False
        self.closed_remote = False
        self.reset = False              # a RST_STREAM went either way
        self.blocked: deque = deque()   # (kind, data, end): the send queue
        self.on_complete: Optional[Callable] = None    # client: answered
        self.answered = False           # server: one answer wins

    def header(self, name: str, default: str = "") -> str:
        for k, v in self.headers:
            if k == name:
                return v
        return default


class H2Session:
    """One h2 connection, either side: frames are fed in wire order on
    the input path; every write holds ``_lock``."""

    def __init__(self, socket, is_server: bool,
                 on_request: Optional[Callable] = None):
        self.socket = socket
        self.is_server = is_server
        self.on_request = on_request    # server: a stream fully received
        self._lock = threading.Lock()
        self.encoder = HpackEncoder()
        self.decoder = HpackDecoder()
        self.streams: Dict[int, H2Stream] = {}
        self.next_stream_id = 2 if is_server else 1
        self.our_initial_window = OUR_INITIAL_WINDOW
        self.peer_initial_window = DEFAULT_WINDOW
        self.peer_max_frame = DEFAULT_FRAME_SIZE
        self.conn_recv_window = DEFAULT_WINDOW
        self.conn_send_window = DEFAULT_WINDOW
        self.goaway_sent = False
        self.goaway_received = False
        self.last_peer_stream = 0
        self._hdr_accum: Optional[Tuple[int, int, bytearray]] = None
        self.window_updates_sent = 0
        self.window_updates_received = 0
        _sessions.add(self)

    # ------------------------------------------------------------- sending
    def _write(self, data: bytes) -> None:
        # under _lock: the frames of one call go out contiguous
        self.socket.write(data)

    def _window_update(self, sid: int, inc: int) -> bytes:
        self.window_updates_sent += 1
        return pack_frame(WINDOW_UPDATE, 0, sid, struct.pack(">I", inc))

    def send_preface_and_settings(self) -> None:
        out = [b"" if self.is_server else PREFACE, pack_frame(
            SETTINGS, 0, 0, struct.pack(
                ">HIHIHI", S_INITIAL_WINDOW_SIZE, self.our_initial_window,
                S_MAX_FRAME_SIZE, OUR_MAX_FRAME_SIZE,
                S_MAX_CONCURRENT_STREAMS, 1024))]
        with self._lock:
            # the connection window never shrinks below 64 KiB: widen it
            # at once
            out.append(self._window_update(0, OUR_CONN_WINDOW
                                           - DEFAULT_WINDOW))
            self.conn_recv_window = OUR_CONN_WINDOW
            self._write(b"".join(out))

    def new_stream(self) -> H2Stream:
        with self._lock:
            sid = self.next_stream_id
            self.next_stream_id += 2
            st = H2Stream(sid, self)
            self.streams[sid] = st
            return st

    def send_headers(self, stream: H2Stream, headers: List[Tuple[str, str]],
                     end_stream: bool = False) -> None:
        """A header block; behind the stream's DATA that the window holds
        back (trailers must not pass the body), and HPACK-encoded when it
        goes out, so the peer's decoder sees blocks in the encoder's
        order."""
        with self._lock:
            if stream.reset:
                return
            if stream.blocked:
                stream.blocked.append((_HEADERS_ITEM, headers, end_stream))
                return
            self._write_headers(stream, headers, end_stream)

    def _write_headers(self, stream: H2Stream,
                       headers: List[Tuple[str, str]],
                       end_stream: bool) -> None:
        # under _lock
        block = self.encoder.encode(headers)
        end = FLAG_END_STREAM if end_stream else 0
        room = self.peer_max_frame
        if len(block) <= room:
            self._write(pack_frame(HEADERS, FLAG_END_HEADERS | end,
                                   stream.id, block))
        else:
            # over the peer's frame size: HEADERS, then CONTINUATIONs, in
            # one write (no other frame may come between them)
            frames = [pack_frame(HEADERS, end, stream.id, block[:room])]
            for off in range(room, len(block), room):
                last = off + room >= len(block)
                frames.append(pack_frame(
                    CONTINUATION, FLAG_END_HEADERS if last else 0,
                    stream.id, block[off:off + room]))
            self._write(b"".join(frames))
        if end_stream:
            stream.closed_local = True
            self._maybe_gc(stream)

    def send_data(self, stream: H2Stream, data: bytes,
                  end_stream: bool = False) -> None:
        with self._lock:
            if stream.reset:
                return
            stream.blocked.append((_DATA_ITEM, bytes(data), end_stream))
            self._flush_stream(stream)

    def _flush_stream(self, stream: H2Stream) -> None:
        # under _lock: as much of the stream's queue as the windows allow
        while stream.blocked:
            kind, data, end = stream.blocked[0]
            if kind is _HEADERS_ITEM:
                stream.blocked.popleft()
                self._write_headers(stream, data, end)
                if end:
                    return
                continue
            if data:
                room = min(self.conn_send_window, stream.send_window,
                           self.peer_max_frame)
                if room <= 0:
                    return
                chunk, rest = data[:room], data[room:]
                self.conn_send_window -= len(chunk)
                stream.send_window -= len(chunk)
                if rest:
                    stream.blocked[0] = (kind, rest, end)
                    self._write(pack_frame(DATA, 0, stream.id, chunk))
                    continue
            else:
                chunk = b""
            stream.blocked.popleft()
            self._write(pack_frame(DATA, FLAG_END_STREAM if end else 0,
                                   stream.id, chunk))
            if end:
                stream.closed_local = True
                self._maybe_gc(stream)
                return

    def _flush_all(self) -> None:
        for st in list(self.streams.values()):
            if st.blocked:
                self._flush_stream(st)
                if self.conn_send_window <= 0:
                    return

    def send_trailers(self, stream: H2Stream,
                      trailers: List[Tuple[str, str]]) -> None:
        self.send_headers(stream, trailers, end_stream=True)

    def send_rst(self, stream_id: int, code: int) -> None:
        with self._lock:
            st = self.streams.pop(stream_id, None)
            if st is not None:
                st.reset = True
                st.blocked.clear()
            self._write(pack_frame(RST_STREAM, 0, stream_id,
                                   struct.pack(">I", code)))

    def send_goaway(self, code: int = NO_ERROR, debug: bytes = b"") -> None:
        with self._lock:
            if self.goaway_sent:
                return
            self.goaway_sent = True
            self._write(pack_frame(GOAWAY, 0, 0, struct.pack(
                ">II", self.last_peer_stream, code) + debug))

    def _maybe_gc(self, stream: H2Stream) -> None:
        if stream.closed_local and stream.closed_remote:
            self.streams.pop(stream.id, None)

    # ------------------------------------------------------------ receiving
    def feed_frame(self, ftype: int, flags: int, sid: int,
                   payload: bytes) -> None:
        """One frame, in wire order, on the connection's input path."""
        if self._hdr_accum is not None and ftype != CONTINUATION:
            raise H2Error(PROTOCOL_ERROR,
                          "expected CONTINUATION in header block")
        if ftype == DATA:
            self._on_data(flags, sid, payload)
        elif ftype == HEADERS:
            self._on_headers(flags, sid, payload)
        elif ftype == CONTINUATION:
            self._on_continuation(flags, sid, payload)
        elif ftype == SETTINGS:
            self._on_settings(flags, payload)
        elif ftype == WINDOW_UPDATE:
            self._on_window_update(sid, payload)
        elif ftype == RST_STREAM:
            self._on_rst(sid, payload)
        elif ftype == PING:
            if not flags & FLAG_ACK:
                with self._lock:
                    self._write(pack_frame(PING, FLAG_ACK, 0, payload[:8]))
        elif ftype == GOAWAY:
            self._on_goaway(payload)
        # PRIORITY is ignored, push is never enabled, and frames of an
        # unknown type are ignored (RFC 7540 section 4.1)

    def _on_rst(self, sid: int, payload: bytes) -> None:
        with self._lock:
            st = self.streams.pop(sid, None)
            if st is None:
                return
            st.reset = True
            st.blocked.clear()
        if st.on_complete is not None:
            code = struct.unpack(">I", payload[:4])[0] \
                if len(payload) >= 4 else 0
            st.trailers = [("grpc-status", str(GRPC_CANCELLED)),
                           ("grpc-message",
                            f"stream reset by peer (h2 error {code})")]
            st.on_complete(st)

    def _on_goaway(self, payload: bytes) -> None:
        """The peer takes no stream past ``last``: a client's streams
        above it will never be answered, so they end at once."""
        self.goaway_received = True
        if self.is_server or len(payload) < 8:
            return
        last = struct.unpack(">I", payload[:4])[0] & 0x7FFFFFFF
        with self._lock:
            gone = [st for sid, st in self.streams.items() if sid > last]
            for st in gone:
                del self.streams[st.id]
                st.reset = True
                st.blocked.clear()
        for st in gone:
            if st.on_complete is not None:
                st.trailers = [("grpc-status", str(GRPC_UNAVAILABLE)),
                               ("grpc-message", "stream refused by GOAWAY")]
                st.on_complete(st)

    @staticmethod
    def _strip_padding(flags: int, payload: bytes) -> bytes:
        if flags & FLAG_PADDED:
            if not payload:
                raise H2Error(PROTOCOL_ERROR, "empty padded frame")
            pad = payload[0]
            if pad >= len(payload):
                raise H2Error(PROTOCOL_ERROR, "padding exceeds frame")
            payload = payload[1:len(payload) - pad]
        return payload

    def _on_data(self, flags: int, sid: int, payload: bytes) -> None:
        consumed = len(payload)         # padding counts against windows
        payload = self._strip_padding(flags, payload)
        st = self.streams.get(sid)
        self.conn_recv_window -= consumed
        refill = []
        if self.conn_recv_window < OUR_CONN_WINDOW // 2:
            refill.append((0, OUR_CONN_WINDOW - self.conn_recv_window))
            self.conn_recv_window = OUR_CONN_WINDOW
        if st is not None and not flags & FLAG_END_STREAM:
            st.recv_window -= consumed
            if st.recv_window < self.our_initial_window // 2:
                refill.append((sid, self.our_initial_window
                               - st.recv_window))
                st.recv_window = self.our_initial_window
        if refill:
            with self._lock:
                self._write(b"".join(self._window_update(s, inc)
                                     for s, inc in refill))
        if st is None:
            return                      # a closed or reset stream
        st.data += payload
        if flags & FLAG_END_STREAM:
            self._remote_closed(st)

    def _on_headers(self, flags: int, sid: int, payload: bytes) -> None:
        payload = self._strip_padding(flags, payload)
        if flags & FLAG_PRIORITY:
            payload = payload[5:]
        if sid > self.last_peer_stream and (sid % 2 == 1) == self.is_server:
            self.last_peer_stream = sid
        if flags & FLAG_END_HEADERS:
            self._header_block_done(sid, flags, bytes(payload))
        else:
            self._hdr_accum = (sid, flags, bytearray(payload))

    def _on_continuation(self, flags: int, sid: int, payload: bytes) -> None:
        if self._hdr_accum is None or self._hdr_accum[0] != sid:
            raise H2Error(PROTOCOL_ERROR, "unexpected CONTINUATION")
        self._hdr_accum[2].extend(payload)
        if flags & FLAG_END_HEADERS:
            sid, first_flags, block = self._hdr_accum
            self._hdr_accum = None
            self._header_block_done(sid, first_flags, bytes(block))

    def _header_block_done(self, sid: int, flags: int, block: bytes) -> None:
        # decoded even for a stream that is gone: the HPACK table must
        # move in step with the peer's encoder
        try:
            headers = self.decoder.decode(block)
        except HpackError as e:
            raise H2Error(COMPRESSION_ERROR, str(e)) from None
        st = self.streams.get(sid)
        if st is None:
            if not self.is_server:
                return                  # a stream we already tore down
            st = H2Stream(sid, self)
            self.streams[sid] = st
        if st.headers and not st.closed_remote:
            st.trailers = headers       # a second block: the trailers
        else:
            st.headers = headers
        if flags & FLAG_END_STREAM or (st.headers and st.trailers):
            self._remote_closed(st)

    def _remote_closed(self, st: H2Stream) -> None:
        if st.closed_remote:
            return
        st.closed_remote = True
        if self.is_server and self.on_request is not None:
            self.on_request(st)
        elif st.on_complete is not None:
            st.on_complete(st)
        with self._lock:
            self._maybe_gc(st)

    def _on_settings(self, flags: int, payload: bytes) -> None:
        if flags & FLAG_ACK:
            return
        if len(payload) % 6:
            raise H2Error(FRAME_SIZE_ERROR, "bad SETTINGS size")
        with self._lock:
            for off in range(0, len(payload), 6):
                ident, value = struct.unpack_from(">HI", payload, off)
                if ident == S_HEADER_TABLE_SIZE:
                    self.encoder.set_max_table_size(value)
                elif ident == S_INITIAL_WINDOW_SIZE:
                    if value > 0x7FFFFFFF:
                        raise H2Error(FLOW_CONTROL_ERROR, "window too large")
                    delta = value - self.peer_initial_window
                    self.peer_initial_window = value
                    for st in self.streams.values():
                        st.send_window += delta
                    if delta > 0:
                        self._flush_all()
                elif ident == S_MAX_FRAME_SIZE:
                    if not 16384 <= value <= 16777215:
                        raise H2Error(PROTOCOL_ERROR, "bad MAX_FRAME_SIZE")
                    self.peer_max_frame = value
            self._write(pack_frame(SETTINGS, FLAG_ACK, 0))

    def _on_window_update(self, sid: int, payload: bytes) -> None:
        if len(payload) != 4:
            raise H2Error(FRAME_SIZE_ERROR, "bad WINDOW_UPDATE")
        inc = struct.unpack(">I", payload)[0] & 0x7FFFFFFF
        if inc == 0:
            raise H2Error(PROTOCOL_ERROR, "zero WINDOW_UPDATE")
        self.window_updates_received += 1
        with self._lock:
            if sid == 0:
                self.conn_send_window += inc
                self._flush_all()
            else:
                st = self.streams.get(sid)
                if st is not None:
                    st.send_window += inc
                    self._flush_stream(st)


def cut_frames(portal, session: H2Session) -> None:
    """Feed every whole frame of ``portal`` to ``session`` (a client's
    input path); a frame over the size we advertised, or a protocol
    error, sends GOAWAY and fails the connection."""
    socket = session.socket
    while portal.size >= 9:
        head = portal.peek_bytes(9)
        length = (head[0] << 16) | (head[1] << 8) | head[2]
        if length > OUR_MAX_FRAME_SIZE:
            socket.set_failed(ConnectionError(
                f"h2 frame of {length} bytes exceeds max_frame_size"))
            return
        if portal.size < 9 + length:
            return
        portal.pop_front(9)
        payload = portal.cut(length).to_bytes() if length else b""
        sid = struct.unpack(">I", head[5:9])[0] & 0x7FFFFFFF
        try:
            session.feed_frame(head[3], head[4], sid, payload)
        except H2Error as e:
            session.send_goaway(e.code, str(e).encode())
            socket.set_failed(ConnectionError(f"h2: {e}"))
            return


# --------------------------------------------------------------- gRPC bits

# status codes (grpc.h GrpcStatus)
GRPC_OK = 0
GRPC_CANCELLED = 1
GRPC_UNKNOWN = 2
GRPC_INVALID_ARGUMENT = 3
GRPC_DEADLINE_EXCEEDED = 4
GRPC_NOT_FOUND = 5
GRPC_INTERNAL = 13
GRPC_UNAVAILABLE = 14
GRPC_UNAUTHENTICATED = 16

_TIMEOUT_UNITS = {"H": 3600.0, "M": 60.0, "S": 1.0, "m": 1e-3, "u": 1e-6,
                  "n": 1e-9}


def parse_grpc_timeout(value: str) -> Optional[float]:
    """A ``grpc-timeout`` header in seconds (None: absent or malformed)."""
    if not value or value[-1] not in _TIMEOUT_UNITS:
        return None
    try:
        return int(value[:-1]) * _TIMEOUT_UNITS[value[-1]]
    except ValueError:
        return None


def format_grpc_timeout(seconds: float) -> str:
    us = max(1, int(seconds * 1e6))
    if us < 1e8:
        return f"{us}u"
    return f"{int(seconds * 1e3)}m"


def pack_grpc_message(data: bytes, compressed: bool = False) -> bytes:
    """The length-prefixed message; ``compressed`` flags bytes the caller
    already gzipped."""
    return struct.pack(">BI", 1 if compressed else 0, len(data)) + data


def unpack_grpc_messages(data: bytes) -> List[bytes]:
    """Every message of a body; a flagged one is gunzipped."""
    out = []
    pos = 0
    while pos + 5 <= len(data):
        compressed, n = struct.unpack_from(">BI", data, pos)
        pos += 5
        if pos + n > len(data):
            raise ValueError("truncated grpc message")
        body = data[pos:pos + n]
        pos += n
        out.append(gzip.decompress(body) if compressed else bytes(body))
    if pos != len(data):
        raise ValueError("trailing bytes after grpc message")
    return out


def percent_encode(msg: str) -> str:
    return urllib.parse.quote(msg, safe=" !#$&'()*+,-./:;<=>?@[]^_`{|}~")


def percent_decode(msg: str) -> str:
    return urllib.parse.unquote(msg)


_ERRNO_TO_GRPC: Optional[Dict[int, int]] = None


def errno_to_grpc_status(code: int) -> int:
    """A failed call's errno as a gRPC status (brpc_tpu/protocol/h2.py:
    486-499); anything unnamed is INTERNAL."""
    global _ERRNO_TO_GRPC
    if _ERRNO_TO_GRPC is None:
        from brpc_tpu_torch.rpc import errno_codes as berr
        _ERRNO_TO_GRPC = {
            berr.OK: GRPC_OK,
            berr.ENOMETHOD: GRPC_NOT_FOUND,
            berr.ENOSERVICE: GRPC_NOT_FOUND,
            berr.EREQUEST: GRPC_INVALID_ARGUMENT,
            berr.ERPCTIMEDOUT: GRPC_DEADLINE_EXCEEDED,
            berr.ELIMIT: GRPC_UNAVAILABLE,
            berr.ECANCELED: GRPC_CANCELLED,
        }
    return _ERRNO_TO_GRPC.get(code, GRPC_INTERNAL)


# ---------------------------------------------------------- server protocol

class _FrameMsg:
    __slots__ = ("ftype", "flags", "sid", "payload", "is_preface")

    def __init__(self, ftype, flags, sid, payload, is_preface=False):
        self.ftype = ftype
        self.flags = flags
        self.sid = sid
        self.payload = payload
        self.is_preface = is_preface


_GRPC_HEADERS = [(":status", "200"), ("content-type", "application/grpc")]


class H2ServerProtocol(Protocol):
    """Server-side h2: sniffs the client preface, then cuts frames and
    feeds the connection's session in parse order."""

    name = "h2"

    def parse(self, portal, socket):
        if not socket.user_data.get("h2_started"):
            head = portal.peek_bytes(len(PREFACE))
            if not PREFACE.startswith(head):
                return PARSE_TRY_OTHERS, None
            if len(head) < len(PREFACE):
                return PARSE_NOT_ENOUGH_DATA, None
            portal.pop_front(len(PREFACE))
            socket.user_data["h2_started"] = True
            return PARSE_OK, _FrameMsg(-1, 0, 0, b"", is_preface=True)
        if portal.size < 9:
            return PARSE_NOT_ENOUGH_DATA, None
        head = portal.peek_bytes(9)
        length = (head[0] << 16) | (head[1] << 8) | head[2]
        if length > OUR_MAX_FRAME_SIZE:
            # we advertised 16 KiB: a larger frame is a FRAME_SIZE_ERROR
            # (RFC 7540 section 4.2), never a 16 MiB buffer the peer picks
            socket.set_failed(ConnectionError(
                f"h2 frame of {length} bytes exceeds max_frame_size"))
            return PARSE_NOT_ENOUGH_DATA, None
        if portal.size < 9 + length:
            return PARSE_NOT_ENOUGH_DATA, None
        portal.pop_front(9)
        payload = portal.cut(length).to_bytes() if length else b""
        sid = struct.unpack(">I", head[5:9])[0] & 0x7FFFFFFF
        return PARSE_OK, _FrameMsg(head[3], head[4], sid, payload)

    def process_inline(self, msg: _FrameMsg, socket) -> bool:
        session: Optional[H2Session] = socket.user_data.get("h2_session")
        if msg.is_preface:
            session = H2Session(socket, is_server=True,
                                on_request=self._dispatch)
            socket.user_data["h2_session"] = session
            session.send_preface_and_settings()
            return True
        if session is None:
            socket.set_failed(ConnectionError("h2 frame before preface"))
            return True
        try:
            session.feed_frame(msg.ftype, msg.flags, msg.sid, msg.payload)
        except H2Error as e:
            session.send_goaway(e.code, str(e).encode())
            socket.set_failed(ConnectionError(f"h2: {e}"))
        return True

    def process(self, msg, socket):     # every frame is handled inline
        return None

    # ------------------------------------------------------------ dispatch
    def _dispatch(self, stream: H2Stream) -> None:
        """A stream fully received (on the input path): its handler gets
        a fiber, so the connection goes on parsing."""
        session = stream.session
        socket = session.socket
        server = socket.user_data.get("server")
        if server is None or not server.is_running:
            session.send_rst(stream.id, REFUSED_STREAM)
            return
        if stream.header("content-type").startswith("application/grpc"):
            socket._control.spawn(self._handle_grpc, server, stream,
                                  name="h2_grpc")
        else:
            socket._control.spawn(self._handle_http, server, stream,
                                  name="h2_http")

    @staticmethod
    def _answer(stream: H2Stream, status: int, message: str = "",
                payload: Optional[bytes] = None) -> None:
        """The one answer of a gRPC stream (the first wins: the deadline
        timer and the handler race for it)."""
        session = stream.session
        with session._lock:
            if stream.answered:
                return
            stream.answered = True
        session.send_headers(stream, _GRPC_HEADERS)
        if status == GRPC_OK:
            session.send_data(stream, pack_grpc_message(payload or b""))
        trailers = [("grpc-status", str(status))]
        if message:
            trailers.append(("grpc-message", percent_encode(message)))
        session.send_trailers(stream, trailers)

    async def _handle_grpc(self, server, stream: H2Stream) -> None:
        socket = stream.session.socket
        # the gate comes first: an unauthenticated peer must not learn
        # the methods from NOT_FOUND
        refused = server._auth_refused(socket, stream.header("authorization"))
        if refused is not None:
            self._answer(stream, GRPC_UNAUTHENTICATED,
                         refused.decode("utf-8", "replace"))
            return
        path = stream.header(":path")
        parts = [p for p in path.split("/") if p]
        if len(parts) != 2:
            self._answer(stream, GRPC_NOT_FOUND, f"bad path {path}")
            return
        service, method_name = parts
        method = server.find_method(service, method_name,
                                    package_qualified=True)
        if method is None:
            self._answer(stream, GRPC_NOT_FOUND,
                         f"no method {service}/{method_name}")
            return
        try:
            msgs = unpack_grpc_messages(bytes(stream.data))
        except Exception as e:          # a bad frame or a bad gzip body
            self._answer(stream, GRPC_INTERNAL, f"bad request: {e}")
            return
        request = msgs[0] if msgs else b""
        status, message, payload = await self._call(server, stream, method,
                                                    request)
        self._answer(stream, status, message, payload)

    async def _call(self, server, stream: H2Stream, method, request: bytes):
        """Run ``method`` as the tpu_std and HTTP paths do: the limiters,
        the interceptor, the deadline; (status, message, payload)."""
        from brpc_tpu_torch.rpc import server_dispatch
        from brpc_tpu_torch.rpc.controller import Controller
        socket = stream.session.socket
        full = method.full_name
        cost = server.on_request_start(full, len(request))
        if not cost:
            return GRPC_UNAVAILABLE, "max_concurrency reached", b""
        cntl = Controller()
        cntl.unary = True
        cntl.remote_side = socket.remote_endpoint
        cntl.auth_context = socket.user_data.get("auth_context")
        cntl._service_name, _, cntl._method_name = full.partition(".")
        if server_dispatch._intercepted(server, method, cntl, cost):
            return (errno_to_grpc_status(cntl.error_code), cntl.error_text,
                    b"")
        timer = None
        timeout = parse_grpc_timeout(stream.header("grpc-timeout"))
        if timeout is not None:
            cntl.set_deadline(timeout * 1e3)
            # the client's deadline is the call's: past it, the answer is
            # DEADLINE_EXCEEDED whatever the handler does later
            timer = global_timer().schedule_after(
                timeout, lambda: self._answer(stream, GRPC_DEADLINE_EXCEEDED,
                                              "deadline exceeded"))
        server._request_begin()
        t0 = time.monotonic_ns()
        status, message, payload = GRPC_OK, "", b""
        server_dispatch._serving_cntl.set(cntl)
        try:
            r = method.handler(cntl, request)
            if inspect.isawaitable(r):
                r = await r
            if r is not None:
                payload = r if isinstance(r, bytes) else bytes(r)
        except Exception as e:          # boundary: report, keep serving
            log.exception("handler %s failed", full)
            status, message = GRPC_INTERNAL, f"handler error: {e}"
        finally:
            server_dispatch._serving_cntl.set(None)
            if timer is not None:
                global_timer().unschedule(timer)
            server.on_request_end(full, (time.monotonic_ns() - t0) / 1e3,
                                  status != GRPC_OK or cntl.failed(), cost)
            server._request_done()
        if status != GRPC_OK:
            return status, message, b""
        if cntl.failed():
            return (errno_to_grpc_status(cntl.error_code), cntl.error_text,
                    b"")
        if cntl._progressive is not None:
            cntl._progressive._on_conn_failed(None)     # its feeder stops
            return (GRPC_INTERNAL, "a progressive body cannot be sent over "
                                   "gRPC", b"")
        return GRPC_OK, "", payload

    async def _handle_http(self, server, stream: H2Stream) -> None:
        """Plain HTTP over h2 through the server's HTTP path, in one
        response: the controller is marked unary, so no body streams."""
        from brpc_tpu_torch.protocol.http import HttpRequest
        from brpc_tpu_torch.rpc.progressive import ProgressiveAttachment
        session = stream.session
        split = urllib.parse.urlsplit(stream.header(":path", "/"))
        body = bytes(stream.data)
        req = HttpRequest(
            method=stream.header(":method", "GET").upper(), path=split.path,
            headers={k: v for k, v in stream.headers
                     if not k.startswith(":")},
            content_length=len(body), body=body,
            query=dict(urllib.parse.parse_qsl(split.query)))
        try:
            status, ctype, out = await server._call_http(
                session.socket, req, unary=True)
        except Exception as e:          # boundary: report, keep serving
            status, ctype, out = 500, "text/plain", f"error: {e}".encode()
        if isinstance(out, ProgressiveAttachment):
            out._on_conn_failed(None)
            status, ctype, out = (500, "text/plain",
                                  b"a progressive body cannot be sent over "
                                  b"h2")
        session.send_headers(stream, [
            (":status", str(status)), ("content-type", ctype),
            ("content-length", str(len(out)))])
        session.send_data(stream, out, end_stream=True)


_instance: Optional[H2ServerProtocol] = None


def ensure_registered() -> H2ServerProtocol:
    global _instance
    if _instance is None:
        _instance = H2ServerProtocol()
        register_protocol(_instance)
    return _instance


# ----------------------------------------------------------------- clients

class GrpcCall:
    """One unary call; its completion is a FiberEvent, so a thread waits
    (``wait``) and a fiber parks (``wait_async``). The first outcome
    wins: a response, the deadline, or the connection's failure."""

    def __init__(self):
        self._event = FiberEvent()
        self._lock = threading.Lock()
        self._socket = None
        self.status: int = GRPC_INTERNAL
        self.message: str = ""
        self.response: bytes = b""
        self.headers: List[Tuple[str, str]] = []

    def _settle(self, status: int, message: str, response: bytes = b"",
                headers=None) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self.status, self.message = status, message
            self.response = response
            self.headers = headers or []
            self._event.set()
        return True

    def _complete(self, stream: H2Stream) -> None:
        status = msg = None
        # trailers, else a trailers-only response's headers
        for block in (stream.trailers, stream.headers):
            for k, v in block:
                if k == "grpc-status" and status is None:
                    status = v
                elif k == "grpc-message" and msg is None:
                    msg = v
            if status is not None:
                break
        try:
            code = int(status) if status is not None else GRPC_INTERNAL
        except ValueError:
            code = GRPC_INTERNAL
        text = percent_decode(msg) if msg else ""
        response = b""
        try:
            msgs = unpack_grpc_messages(bytes(stream.data))
            response = msgs[0] if msgs else b""
        except ValueError as e:
            if code == GRPC_OK:
                code, text = GRPC_INTERNAL, str(e)
        if code == GRPC_OK and status is None:
            text = "no grpc-status in the response"
        self._settle(code, text, response, stream.headers)

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait_pthread(timeout)

    async def wait_async(self, timeout: Optional[float] = None) -> bool:
        return await self._event.wait(timeout)

    def ok(self) -> bool:
        return self.status == GRPC_OK


class GrpcChannel:
    """gRPC over h2, the client half of policy/http2_rpc_protocol.cpp;
    speaks to the port's servers, the reference's and stock gRPC."""

    def __init__(self, address, control: Optional[TaskControl] = None):
        self._endpoint = address if isinstance(address, EndPoint) else \
            str2endpoint(address, default_scheme="tcp")
        self._control = control or global_control()
        self._lock = threading.Lock()
        self._session: Optional[H2Session] = None
        self._closed = False
        # calls in flight, failed together when their socket dies (one
        # on_failed a socket, registered by the dial that published it)
        self._pending: set = set()
        _channels.add(self)

    @property
    def _scheme(self) -> str:
        return "https" if self._endpoint.scheme == "ssl" else "http"

    @property
    def _authority(self) -> str:
        return f"{self._endpoint.host}:{self._endpoint.port}"

    def _open_session(self) -> Optional[H2Session]:
        s = self._session
        if s is None or s.socket.failed or s.goaway_received:
            return None
        return s

    def _connect(self) -> H2Session:
        """The channel's session: dialled outside the lock, one winner
        published, a loser closed (``transport/socket_map.py``'s rule)."""
        with self._lock:
            s = self._open_session()
            if s is not None:
                return s
            if self._closed:
                raise ConnectionError("channel closed")
        from brpc_tpu_torch.transport.socket import create_client_socket
        sock = create_client_socket(self._endpoint, on_input=self._on_input,
                                    control=self._control)
        session = H2Session(sock, is_server=False)
        sock.user_data["h2_session"] = session
        with self._lock:
            won = not self._closed and self._open_session() is None
            if won:
                self._session = session
            winner = self._session
        if not won:
            sock.set_failed(ConnectionError("duplicate connect discarded"))
            if winner is None or self._closed:
                raise ConnectionError("channel closed")
            return winner
        # outside the lock: on_failed fires at once on a dead socket, and
        # _fail_pending takes the lock
        sock.on_failed(self._fail_pending)
        session.send_preface_and_settings()
        return session

    def _fail_pending(self, socket) -> None:
        with self._lock:
            mine = [c for c in self._pending if c._socket is socket]
            self._pending.difference_update(mine)
        reason = socket.fail_reason
        for call in mine:
            call._settle(GRPC_UNAVAILABLE, f"connection failed: {reason}")

    def _on_input(self, socket) -> None:
        session = socket.user_data.get("h2_session")
        if session is not None:
            cut_frames(socket.input_portal, session)

    def _begin(self, call: GrpcCall) -> Tuple[H2Session, H2Stream]:
        """A new stream for ``call``, in flight on the channel."""
        session = self._connect()
        stream = session.new_stream()
        call._socket = session.socket
        with self._lock:
            self._pending.add(call)

        def done(st):
            with self._lock:
                self._pending.discard(call)
            self._on_stream_done(call, st)
        stream.on_complete = done
        if session.socket.failed:
            # it failed before the call was counted in: nothing else
            # will end it
            self._fail_pending(session.socket)
        return session, stream

    def _on_stream_done(self, call: GrpcCall, stream: H2Stream) -> None:
        call._complete(stream)

    def call(self, method_path: str, request: bytes = b"",
             timeout: Optional[float] = 5.0,
             metadata: Optional[List[Tuple[str, str]]] = None) -> GrpcCall:
        """A unary call to ``/package.Service/Method``. Blocks the
        calling thread; a fiber uses ``call_async``."""
        call, session, stream, wait_s = self._start(method_path, request,
                                                    timeout, metadata)
        if session is not None and not call.wait(wait_s):
            self._expire(call, session, stream)
        return call

    async def call_async(self, method_path: str, request: bytes = b"",
                         timeout: Optional[float] = 5.0,
                         metadata: Optional[List[Tuple[str, str]]] = None
                         ) -> GrpcCall:
        """``call`` for a fiber: it parks instead of its worker (the
        first call of a channel still dials with a blocking connect,
        outside every lock)."""
        call, session, stream, wait_s = self._start(method_path, request,
                                                    timeout, metadata)
        if session is not None and not await call.wait_async(wait_s):
            self._expire(call, session, stream)
        return call

    def _start(self, method_path, request, timeout, metadata):
        call = GrpcCall()
        try:
            session, stream = self._begin(call)
        except OSError as e:            # a refused or failed dial
            call._settle(GRPC_UNAVAILABLE, f"connect failed: {e}")
            return call, None, None, None
        headers = [(":method", "POST"), (":scheme", self._scheme),
                   (":path", method_path), (":authority", self._authority),
                   ("content-type", "application/grpc"),
                   ("user-agent", "brpc-tpu-torch-grpc/1.0"),
                   ("te", "trailers")]
        if timeout is not None:
            headers.append(("grpc-timeout", format_grpc_timeout(timeout)))
        headers.extend(metadata or ())
        session.send_headers(stream, headers)
        session.send_data(stream, pack_grpc_message(bytes(request)),
                          end_stream=True)
        # a second past the deadline for the server's own
        # DEADLINE_EXCEEDED to arrive
        wait_s = timeout + 1.0 if timeout is not None else None
        return call, session, stream, wait_s

    def _expire(self, call: GrpcCall, session: H2Session,
                stream: H2Stream) -> None:
        with self._lock:
            self._pending.discard(call)
        if call._settle(GRPC_DEADLINE_EXCEEDED, "deadline exceeded"):
            session.send_rst(stream.id, CANCEL)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            session, self._session = self._session, None
        # set_failed runs _fail_pending, which takes the lock
        if session is not None:
            session.send_goaway()
            session.socket.set_failed(ConnectionError("channel closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class HttpResponse:
    """A plain HTTP response over h2."""

    __slots__ = ("status", "headers", "body")

    def __init__(self, status: int, headers: List[Tuple[str, str]],
                 body: bytes):
        self.status = status
        self.headers = headers
        self.body = body

    def header(self, name: str, default: str = "") -> str:
        name = name.lower()
        for k, v in self.headers:
            if k.lower() == name:
                return v
        return default


class Http2Client(GrpcChannel):
    """Plain HTTP over h2 on the session a GrpcChannel drives: GET and
    POST streams multiplexed on one connection (builtin pages, methods
    as ``/<Service>/<Method>``)."""

    def _on_stream_done(self, call: GrpcCall, stream: H2Stream) -> None:
        if stream.reset:
            # the reset path's synthetic trailers: a transport failure,
            # never a 200 with a cut body
            call._settle(GRPC_UNAVAILABLE, "stream reset")
        else:
            call._settle(GRPC_OK, "", bytes(stream.data), stream.headers)

    def request(self, method: str, path: str, body: bytes = b"",
                headers: Optional[List[Tuple[str, str]]] = None,
                timeout: Optional[float] = 10.0) -> HttpResponse:
        """One exchange; raises H2Error on a transport failure or at the
        timeout."""
        call = GrpcCall()
        try:
            session, stream = self._begin(call)
        except OSError as e:
            raise H2Error(CONNECT_ERROR, f"connect failed: {e}") from e
        hdrs = [(":method", method.upper()), (":scheme", self._scheme),
                (":path", path), (":authority", self._authority)]
        hdrs.extend(headers or ())
        session.send_headers(stream, hdrs, end_stream=not body)
        if body:
            session.send_data(stream, body, end_stream=True)
        if not call.wait(timeout):
            with self._lock:
                self._pending.discard(call)
            if call._settle(GRPC_DEADLINE_EXCEEDED, "timed out"):
                session.send_rst(stream.id, CANCEL)
                raise H2Error(CANCEL, f"h2 request timed out after "
                                      f"{timeout}s")
        if call.status != GRPC_OK:
            raise H2Error(INTERNAL_ERROR, call.message or "request failed")
        resp = HttpResponse(0, call.headers, call.response)
        try:
            resp.status = int(resp.header(":status", "0") or 0)
        except ValueError as e:
            raise H2Error(PROTOCOL_ERROR, f"malformed :status: {e}") from None
        return resp
