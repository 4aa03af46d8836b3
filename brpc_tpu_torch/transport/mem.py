"""In-process loopback transport, ``mem://name`` (the port of
brpc_tpu/transport/mem.py).

The fake fabric: the whole stack runs without a network. A mem conn is a
pair of byte queues, one per direction, with a device lane beside them
that hands tensors to the peer by reference (zero-copy), which is what a
same-process hop degenerates to.

A mem conn has no fd. Its peer's readiness is posted to the process's
event dispatcher (``EventDispatcher.post``), so the peer's Socket reads
and parses on the dispatcher thread, as it would a TCP socket's input,
and a writer never runs the peer's handler in its own context (where a
handler that calls back through the same connection would find the
writer's ``lane_lock`` held). At most one readable notice is pending per
conn; one notice reads everything written before it ran.

A direction holds at most ``_MAX_BUFFER`` bytes: a write beyond raises
BlockingIOError, and the reader's drain below the mark fires the
writer's writable event.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Dict, Optional

from brpc_tpu_torch.butil.endpoint import EndPoint
from brpc_tpu_torch.transport.base import Conn, Listener, Transport
from brpc_tpu_torch.transport.event_dispatcher import global_dispatcher

_MAX_BUFFER = 4 * 1024 * 1024  # per direction


class _MemPipe:
    """One direction of a mem connection."""

    def __init__(self):
        self.lock = threading.Lock()
        self.chunks: deque = deque()
        self.size = 0
        self.closed = False
        self.device_payloads: deque = deque()


class MemConn(Conn):
    supports_device_lane = True

    def __init__(self, rx: _MemPipe, tx: _MemPipe, local: EndPoint,
                 remote: EndPoint):
        self._rx = rx
        self._tx = tx
        self._local = local
        self._remote = remote
        self.peer: Optional["MemConn"] = None
        self._on_readable: Optional[Callable[[], None]] = None
        self._on_writable: Optional[Callable[[], None]] = None
        self._notice_lock = threading.Lock()
        self._read_posted = False

    # ------------------------------------------------------------- stream
    def _push(self, data: bytes) -> int:
        with self._tx.lock:
            if self._tx.closed:
                raise BrokenPipeError("mem conn closed")
            if self._tx.size >= _MAX_BUFFER:
                raise BlockingIOError
            self._tx.chunks.append(data)
            self._tx.size += len(data)
        peer = self.peer
        if peer is not None:
            peer._notify_readable()
        return len(data)

    def write(self, mv) -> int:
        return self._push(bytes(mv))

    def writev(self, views) -> int:
        """A chain of buffers as one chunk, one notice."""
        return self._push(b"".join(views))

    def read_into(self, mv: memoryview) -> int:
        """Gather every pending chunk that fits; BlockingIOError when none
        is pending, 0 once the pipe closed and is empty."""
        with self._rx.lock:
            chunks = self._rx.chunks
            if not chunks:
                if self._rx.closed:
                    return 0
                raise BlockingIOError
            n = 0
            space = len(mv)
            while chunks and n < space:
                chunk = chunks[0]
                take = min(len(chunk), space - n)
                mv[n:n + take] = chunk[:take]
                if take == len(chunk):
                    chunks.popleft()
                else:
                    chunks[0] = chunk[take:]
                n += take
            self._rx.size -= n
            was_full = self._rx.size + n >= _MAX_BUFFER > self._rx.size
        peer = self.peer
        if was_full and peer is not None:
            peer._notify_writable()
        return n

    # -------------------------------------------------------- device lane
    def write_device_payload(self, arrays) -> bool:
        """Hand a batch to the peer by reference."""
        self._push_batch(list(arrays))
        return True

    def _push_batch(self, item) -> None:
        with self._tx.lock:
            if self._tx.closed:
                raise BrokenPipeError("mem conn closed")
            self._tx.device_payloads.append(item)

    def take_device_payload(self):
        with self._rx.lock:
            if self._rx.device_payloads:
                return self._rx.device_payloads.popleft()
        return None

    def close(self) -> None:
        for pipe in (self._rx, self._tx):
            with pipe.lock:
                pipe.closed = True
        peer = self.peer
        if peer is not None:
            peer._notify_readable()     # the peer reads EOF

    # ------------------------------------------------------------- events
    def start_events(self, on_readable, on_writable) -> None:
        self._on_readable = on_readable
        self._on_writable = on_writable
        with self._rx.lock:
            pending = bool(self._rx.chunks) or self._rx.closed
        if pending:
            self._notify_readable()

    def request_writable_event(self) -> None:
        with self._tx.lock:
            if self._tx.closed:
                raise ConnectionError("mem conn closed")
            fire = self._tx.size < _MAX_BUFFER
        if fire:
            self._notify_writable()

    def _notify_readable(self) -> None:
        with self._notice_lock:
            if self._read_posted:
                return                  # the pending notice reads it too
            self._read_posted = True
        global_dispatcher().post(self._fire_readable)

    def _fire_readable(self) -> None:
        # cleared before the read: a write after this point posts again
        with self._notice_lock:
            self._read_posted = False
        cb = self._on_readable
        if cb is not None:
            cb()

    def _notify_writable(self) -> None:
        cb = self._on_writable
        if cb is not None:
            cb()

    @property
    def local_endpoint(self) -> EndPoint:
        return self._local

    @property
    def remote_endpoint(self) -> EndPoint:
        return self._remote


class _MemListener(Listener):
    def __init__(self, registry: Dict[str, "_MemListener"], key: str,
                 ep: EndPoint, on_new_conn: Callable[[Conn], None]):
        self._registry = registry
        self._key = key
        self._ep = ep
        self.on_new_conn = on_new_conn

    def stop(self) -> None:
        if self._registry.get(self._key) is self:
            self._registry.pop(self._key, None)

    @property
    def endpoint(self) -> EndPoint:
        return self._ep


class MemTransport(Transport):
    """Listeners keyed by name; ``connect`` builds both ends at once and
    hands the server's to the listener in the caller's thread."""
    scheme = "mem"

    def __init__(self):
        self._listeners: Dict[str, _MemListener] = {}
        self._lock = threading.Lock()

    def _key(self, ep: EndPoint) -> str:
        return ep.host

    def listen(self, ep: EndPoint, on_new_conn) -> Listener:
        key = self._key(ep)
        with self._lock:
            if key in self._listeners:
                raise OSError(f"{self.scheme}://{key} already listening")
            lst = _MemListener(self._listeners, key, ep, on_new_conn)
            self._listeners[key] = lst
            return lst

    def _find(self, ep: EndPoint) -> _MemListener:
        with self._lock:
            lst = self._listeners.get(self._key(ep))
        if lst is None:
            raise ConnectionRefusedError(
                f"no listener at {self.scheme}://{self._key(ep)}")
        return lst

    def _make_pair(self, a2b: _MemPipe, b2a: _MemPipe, lst: _MemListener,
                   ep: EndPoint, client_ep: EndPoint):
        client = MemConn(rx=b2a, tx=a2b, local=client_ep, remote=ep)
        server = MemConn(rx=a2b, tx=b2a, local=lst.endpoint,
                         remote=client_ep)
        return client, server

    def connect(self, ep: EndPoint) -> Conn:
        lst = self._find(ep)
        a2b, b2a = _MemPipe(), _MemPipe()
        client_ep = EndPoint(self.scheme, f"client-{id(a2b):x}", 0)
        client, server = self._make_pair(a2b, b2a, lst, ep, client_ep)
        client.peer = server
        server.peer = client
        lst.on_new_conn(server)
        return client
