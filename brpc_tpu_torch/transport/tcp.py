"""Blocking TCP transport for tpu_std frames.

One reader thread per connection cuts whole frames off the socket and
hands them to the owner's ``on_frame``; writers send whole frames under
a per-connection lock, so frames from concurrent callers never
interleave. ``close`` shuts the socket down, which wakes the reader.
"""

from __future__ import annotations

import logging
import socket
import threading
from typing import Callable, Optional, Tuple

from brpc_tpu_torch.protocol import tpu_std

log = logging.getLogger("brpc_tpu_torch.transport")

FrameHandler = Callable[["Connection", tpu_std.RpcMeta, bytes, bytes], None]


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


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    chunks = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            return None
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


class Connection:
    """A framed, full-duplex TCP connection with its own reader thread."""

    def __init__(self, sock: socket.socket, on_frame: FrameHandler,
                 on_close: Optional[Callable[["Connection"], None]] = None,
                 name: str = "conn"):
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.sock = sock
        self.peer = sock.getpeername()
        self._on_frame = on_frame
        self._on_close = on_close
        self._write_lock = threading.Lock()
        self._close_lock = threading.Lock()
        self.closed = False
        self._reader = threading.Thread(target=self._read_loop,
                                        name=f"{name}-reader", daemon=True)

    def start(self) -> "Connection":
        self._reader.start()
        return self

    def send(self, frame: bytes) -> None:
        """Write one whole frame; raises ConnectionError once closed."""
        if self.closed:
            raise ConnectionError("connection closed")
        with self._write_lock:
            self.sock.sendall(frame)

    def _read_loop(self) -> None:
        try:
            while True:
                head = _recv_exact(self.sock, tpu_std.HEADER_SIZE)
                if head is None:
                    break
                body_size, meta_size = tpu_std.parse_header(head)
                body = _recv_exact(self.sock, body_size)
                if body is None:
                    break
                meta, payload, att = tpu_std.unpack_body(body, meta_size)
                self._on_frame(self, meta, payload, att)
        except (OSError, tpu_std.DecodeError) as e:
            if not self.closed:
                log.debug("connection to %s failed: %s", self.peer, e)
        finally:
            self.close()

    def close(self) -> None:
        with self._close_lock:
            if self.closed:
                return
            self.closed = True
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()
        if self._on_close is not None:
            self._on_close(self)

    def join(self, timeout_s: float = 5.0) -> None:
        if self._reader.is_alive() and \
                self._reader is not threading.current_thread():
            self._reader.join(timeout_s)


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

    def __init__(self, address: str, on_frame: FrameHandler):
        host, port = parse_address(address)
        self._on_frame = on_frame
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
                              name="server")
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

    def close_connections(self, timeout_s: float = 2.0) -> None:
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            c.close()
        for c in conns:
            c.join(timeout_s)
