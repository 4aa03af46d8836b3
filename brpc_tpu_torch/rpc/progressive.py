"""ProgressiveAttachment: an HTTP response body sent in chunks after the
handler returns (the port of brpc_tpu/rpc/progressive.py; bRPC's
progressive_attachment.h).

    pa = cntl.create_progressive_attachment()
    ...                       # the handler returns; a feeder then calls
    pa.write(block)           # False once the peer is gone
    pa.close()                # the terminating 0-length chunk

The HTTP path writes ``Transfer-Encoding: chunked`` headers, then
``_bind``s the attachment to the connection. Chunks written before that
are held and flushed in order; every state change (held, bound, closed,
failed) happens under one lock, so a feeder racing ``_bind`` can neither
reorder chunks nor put the terminator before held data. ``Socket.write``
only queues, so holding the lock over it never waits on the peer.
``await wait_finished()`` is what the HTTP path parks on (a
FiberEvent: its worker goes on) before it answers the next request on
the connection.
"""

from __future__ import annotations

import threading
from typing import List

from brpc_tpu_torch.fiber import FiberEvent
from brpc_tpu_torch.protocol import http


class ProgressiveAttachment:
    def __init__(self, content_type: str = "application/octet-stream"):
        self.content_type = content_type
        self._lock = threading.Lock()
        self._conn = None
        self._pending: List[bytes] = []
        self._closed = False
        self._failed = False            # the bound connection ended
        self._finished = FiberEvent()   # terminator out, or conn dead

    # -------------------------------------------------------- handler side
    def write(self, data) -> bool:
        """Send (or hold) one chunk. False once closed or once the bound
        connection has ended: a feeder of an unbounded body must stop
        then, and release what produces the body."""
        data = bytes(data)
        with self._lock:
            if self._closed or self._failed:
                return False
            if not data:
                return True
            if self._conn is None:
                self._pending.append(data)
                return True
            return self._send(http.chunk(data))

    def close(self) -> None:
        """End the body with the 0-length chunk. Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self._conn is None:
                return                  # _bind sends it after the flush
            self._send(http.LAST_CHUNK)
        self._finished.set()

    @property
    def closed(self) -> bool:
        return self._closed

    # ----------------------------------------------------------- http side
    def _bind(self, conn) -> None:
        """After the response headers: flush what is held, and the
        terminator if already closed, before any later write."""
        with self._lock:
            self._conn = conn
            for data in self._pending:
                self._send(http.chunk(data))
            self._pending = []
            done = self._closed
            if done:
                self._send(http.LAST_CHUNK)
        conn.on_failed(self._on_conn_failed)
        if done:
            self._finished.set()

    def _on_conn_failed(self, _conn) -> None:
        with self._lock:
            self._failed = True
        self._finished.set()

    def _send(self, wire: bytes) -> bool:
        if not self._conn.write(wire):
            self._failed = True
            return False
        return True

    async def wait_finished(self) -> None:
        """Await, in a fiber, the body's end: the terminator sent or the
        connection ended."""
        await self._finished.wait()
