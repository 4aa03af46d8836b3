"""TCP transport for tpu_std frames and HTTP/1.1 requests.

Reading: one reader thread per connection cuts whole messages off the
socket and hands them to the owner: tpu_std frames to ``on_frame``,
HTTP requests (head and ``Content-Length`` body) to ``on_http``. A
server connection picks its protocol from its first bytes, as
brpc_tpu/protocol/http.py:146-152 does: ``TRPC`` is tpu_std, a request
line is HTTP, anything else closes the connection.

Writing: ``send`` queues one whole frame and returns; it never waits
for the peer. A sender finding the send side free tries the frame
inline with a non-blocking write; what the socket does not take, and
every frame sent while another write is under way, goes to a FIFO that a
writer thread drains with blocking writes. So a decode step that sends
tokens never parks on a peer that stopped reading (brpc_tpu's
``Socket.write`` likewise only queues), and frames from concurrent
callers never interleave.

Failure: ``on_failed(cb)`` subscribes ``cb(conn)`` to the connection's
end: EOF or an error seen by the reader or a writer, or ``close()``. It
fires once; a subscription made after the end fires at once.
"""

from __future__ import annotations

import logging
import socket
import threading
from collections import deque
from typing import Callable, List, Optional, Tuple

from brpc_tpu_torch.protocol import http, tpu_std

log = logging.getLogger("brpc_tpu_torch.transport")

FrameHandler = Callable[["Connection", tpu_std.RpcMeta, bytes, bytes], None]
HttpHandler = Callable[["Connection", http.HttpRequest], None]

_CLOSE = object()       # write-queue marker: close once what precedes it is out
_RECV_SIZE = 1 << 16


def parse_address(address: str) -> Tuple[str, int]:
    """``tcp://host:port`` or ``host:port`` -> (host, port)."""
    if "://" in address:
        scheme, address = address.split("://", 1)
        if scheme != "tcp":
            raise ValueError(f"unsupported scheme {scheme!r}: only tcp://")
    host, sep, port = address.rpartition(":")
    if not sep or not host:
        raise ValueError(f"address needs host:port, got {address!r}")
    return host, int(port)


class _Reader:
    """Buffered reads off a blocking socket; None at EOF."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._buf = bytearray()

    def _fill(self) -> bool:
        data = self._sock.recv(_RECV_SIZE)
        if not data:
            return False
        self._buf += data
        return True

    def peek(self, n: int) -> Optional[bytes]:
        while len(self._buf) < n:
            if not self._fill():
                return None
        return bytes(self._buf[:n])

    def read(self, n: int) -> Optional[bytes]:
        out = self.peek(n)
        if out is not None:
            del self._buf[:n]
        return out

    def read_until(self, sep: bytes, limit: int) -> Optional[bytes]:
        """The bytes before ``sep``, which is consumed too."""
        start = 0
        while True:
            i = self._buf.find(sep, start)
            if i >= 0:
                out = bytes(self._buf[:i])
                del self._buf[:i + len(sep)]
                return out
            if len(self._buf) >= limit:
                raise http.HttpError(f"head over {limit} bytes")
            start = max(0, len(self._buf) - len(sep) + 1)
            if not self._fill():
                return None


class Connection:
    """A full-duplex TCP connection: a reader thread, a write queue and
    failure subscriptions. ``on_http`` set: the first bytes choose
    between tpu_std and HTTP; unset: tpu_std only."""

    def __init__(self, sock: socket.socket, on_frame: FrameHandler,
                 on_close: Optional[Callable[["Connection"], None]] = None,
                 name: str = "conn",
                 on_http: Optional[HttpHandler] = None):
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.sock = sock
        self.peer = sock.getpeername()
        self.name = name
        self.user_data: dict = {}       # owners' per-connection state
        self._on_frame = on_frame
        self._on_http = on_http
        self._on_close = on_close
        # one lock for the closed flag, the failure callbacks and the
        # write queue: a send and a close never see each other half done
        self._lock = threading.Lock()
        self._wcond = threading.Condition(self._lock)
        self.closed = False
        self._failed_cbs: List[Callable[["Connection"], None]] = []
        self._wq: deque = deque()
        self._wq_bytes = 0
        self._writing = False           # a thread owns the send side
        self._writer: Optional[threading.Thread] = None
        self._reader = threading.Thread(target=self._read_loop,
                                        name=f"{name}-reader", daemon=True)

    def start(self) -> "Connection":
        self._reader.start()
        return self

    # ------------------------------------------------------------ writing
    def send(self, frame: bytes) -> None:
        """Queue one whole frame for the wire, in call order; never
        blocks on the peer. Raises ConnectionError once closed."""
        with self._lock:
            if self.closed:
                raise ConnectionError("connection closed")
            if self._writing or self._wq:
                self._enqueue_locked(frame)
                return
            self._writing = True
        try:
            n = self.sock.send(frame, socket.MSG_DONTWAIT)
        except BlockingIOError:
            n = 0
        except OSError as e:
            with self._lock:
                self._writing = False
            # the reader wakes and closes the connection on its own
            # thread: failure callbacks must not run inside a sender that
            # may hold its own locks
            self._shutdown()
            raise ConnectionError(f"send failed: {e}") from e
        with self._lock:
            self._writing = False
            if n < len(frame):
                # the rest goes out before anything queued meanwhile
                self._wq.appendleft(memoryview(frame)[n:])
                self._wq_bytes += len(frame) - n
            if self._wq:
                self._wake_writer_locked()

    def close_after_flush(self) -> None:
        """Close once every frame queued so far has been written."""
        with self._lock:
            if self.closed:
                return
            self._enqueue_locked(_CLOSE)

    def write_backlog(self) -> int:
        """Bytes queued and not yet taken by the socket."""
        return max(0, self._wq_bytes)

    def _enqueue_locked(self, item) -> None:
        self._wq.append(item)
        if item is not _CLOSE:
            self._wq_bytes += len(item)
        self._wake_writer_locked()

    def _wake_writer_locked(self) -> None:
        if self._writer is None:
            self._writer = threading.Thread(target=self._write_loop,
                                            name=f"{self.name}-writer",
                                            daemon=True)
            self._writer.start()
        else:
            self._wcond.notify()

    def _write_loop(self) -> None:
        while True:
            with self._lock:
                while not self.closed and (self._writing or not self._wq):
                    self._wcond.wait()
                if self.closed:
                    return
                batch = list(self._wq)
                self._wq.clear()
                self._writing = True
            close_after = False
            try:
                for item in batch:
                    if item is _CLOSE:
                        close_after = True
                        break
                    self.sock.sendall(item)
                    with self._lock:
                        self._wq_bytes -= len(item)
            except OSError as e:
                if not self.closed:
                    log.debug("write to %s failed: %s", self.peer, e)
                close_after = True
            with self._lock:
                self._writing = False
            if close_after:
                self.close()
                return

    # ------------------------------------------------------------ reading
    def _read_loop(self) -> None:
        try:
            r = _Reader(self.sock)
            if self._on_http is not None:
                head = r.peek(http.SNIFF_BYTES)
                if head is None:
                    return
                if head != tpu_std.MAGIC:
                    if not http.is_request_start(head):
                        log.debug("unknown protocol from %s: %r", self.peer,
                                  head)
                        return
                    self._read_http(r)
                    return
            self._read_tpu_std(r)
        except (OSError, tpu_std.DecodeError, http.HttpError) as e:
            if not self.closed:
                log.debug("connection to %s failed: %s", self.peer, e)
        finally:
            self.close()

    def _read_tpu_std(self, r: _Reader) -> None:
        while True:
            head = r.read(tpu_std.HEADER_SIZE)
            if head is None:
                return
            body_size, meta_size = tpu_std.parse_header(head)
            body = r.read(body_size)
            if body is None:
                return
            meta, payload, att = tpu_std.unpack_body(body, meta_size)
            self._on_frame(self, meta, payload, att)

    def _read_http(self, r: _Reader) -> None:
        """Requests in order; reading goes on after each, so that the
        peer's EOF is seen while a chunked response is still streaming."""
        while True:
            head = r.read_until(b"\r\n\r\n", http.MAX_HEADER)
            if head is None:
                return
            req = http.parse_head(head)
            body = r.read(req.content_length)
            if body is None:
                return
            req.body = body
            self._on_http(self, req)

    # ------------------------------------------------------------ failure
    def on_failed(self, cb: Callable[["Connection"], None]) -> None:
        with self._lock:
            if not self.closed:
                self._failed_cbs.append(cb)
                return
        cb(self)

    def off_failed(self, cb: Callable[["Connection"], None]) -> None:
        with self._lock:
            try:
                self._failed_cbs.remove(cb)
            except ValueError:
                pass

    def close(self) -> None:
        with self._lock:
            if self.closed:
                return
            self.closed = True
            cbs, self._failed_cbs = self._failed_cbs, []
            self._wq.clear()
            self._wq_bytes = 0
            self._wcond.notify_all()
        self._shutdown()
        self.sock.close()
        for cb in cbs:
            try:
                cb(self)
            except Exception:           # boundary: every subscriber runs
                log.exception("on_failed callback failed")
        if self._on_close is not None:
            self._on_close(self)

    def _shutdown(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass

    def join(self, timeout_s: float = 5.0) -> None:
        for t in (self._reader, self._writer):
            if t is not None and t.is_alive() and \
                    t is not threading.current_thread():
                t.join(timeout_s)


def connect(address: str, on_frame: FrameHandler,
            on_close: Optional[Callable[[Connection], None]] = None,
            timeout_s: float = 5.0) -> Connection:
    host, port = parse_address(address)
    sock = socket.create_connection((host, port), timeout=timeout_s)
    sock.settimeout(None)
    return Connection(sock, on_frame, on_close, name="client").start()


class Listener:
    """Accepts on ``host:port`` (port 0 picks a free one) and gives every
    accepted socket a Connection of its own."""

    def __init__(self, address: str, on_frame: FrameHandler,
                 on_http: Optional[HttpHandler] = None):
        host, port = parse_address(address)
        self._on_frame = on_frame
        self._on_http = on_http
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(128)
        # a short accept timeout lets stop() end the loop without relying
        # on close() waking a blocked accept()
        self._sock.settimeout(0.1)
        self.host, self.port = self._sock.getsockname()[:2]
        self._conns: set = set()
        self._lock = threading.Lock()
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop,
                                        name="tcp-accept", daemon=True)

    def start(self) -> "Listener":
        self._thread.start()
        return self

    def _forget(self, conn: Connection) -> None:
        with self._lock:
            self._conns.discard(conn)

    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                sock, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            sock.settimeout(None)
            conn = Connection(sock, self._on_frame, self._forget,
                              name="server", on_http=self._on_http)
            with self._lock:
                if self._stopped.is_set():
                    sock.close()
                    break
                self._conns.add(conn)
            conn.start()

    def stop(self) -> None:
        """Stop accepting; existing connections stay open."""
        self._stopped.set()
        if self._thread.is_alive() and \
                self._thread is not threading.current_thread():
            self._thread.join(2.0)
        self._sock.close()

    def connections(self) -> List[Connection]:
        with self._lock:
            return list(self._conns)

    def close_connections(self, timeout_s: float = 2.0) -> None:
        conns = self.connections()
        for c in conns:
            c.close()
        for c in conns:
            c.join(timeout_s)
