"""Channel: unary tpu_std calls over one TCP connection.

Calls from many threads share the connection; each call takes a fresh
correlation id and parks on an Event that the connection's reader
thread sets when the matching response arrives. A call that outlives
its timeout fails with ``ERPCTIMEDOUT`` and its late response, if any,
is dropped. The request meta carries ``timeout_ms`` so the server can
stop work the client no longer waits for.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from brpc_tpu_torch.protocol import tpu_std
from brpc_tpu_torch.transport import tcp

from . import errno_codes as berr
from .controller import Controller


@dataclass
class ChannelOptions:
    timeout_ms: Optional[float] = 1000.0


class Channel:
    def __init__(self, address: str,
                 options: Optional[ChannelOptions] = None):
        self.address = address
        self.options = options or ChannelOptions()
        self._cids = itertools.count(1)
        # cid -> (event, controller, the connection the request went on)
        self._pending: Dict[int, Tuple[threading.Event, Controller,
                                       tcp.Connection]] = {}
        self._lock = threading.Lock()
        self._conn: Optional[tcp.Connection] = None
        self._closed = False

    def _connection(self) -> tcp.Connection:
        with self._lock:
            if self._closed:
                raise ConnectionError("channel closed")
            if self._conn is None or self._conn.closed:
                self._conn = tcp.connect(self.address, self._on_frame,
                                         self._on_close)
            return self._conn

    def _on_frame(self, conn, meta: tpu_std.RpcMeta, payload: bytes,
                  attachment: bytes) -> None:
        with self._lock:
            waiter = self._pending.pop(meta.correlation_id, None)
        if waiter is None:
            return                      # timed out earlier: drop
        ev, cntl, _ = waiter
        resp = meta.response
        if resp is not None and resp.error_code:
            cntl.set_failed(resp.error_code, resp.error_text)
        else:
            cntl.response = payload
        ev.set()

    def _on_close(self, conn) -> None:
        """Fail the calls still waiting on ``conn``; calls sent on a newer
        connection are not its business."""
        with self._lock:
            dead = [cid for cid, w in self._pending.items() if w[2] is conn]
            waiters = [self._pending.pop(cid) for cid in dead]
        for ev, cntl, _ in waiters:
            cntl.set_failed(berr.EFAILEDSOCKET, "connection closed")
            ev.set()

    def call_sync(self, service: str, method: str, request: bytes = b"",
                  cntl: Optional[Controller] = None) -> Controller:
        """Send one request and wait for its response. Returns the
        controller: ``failed()`` / ``error_code`` / ``response``."""
        cntl = cntl or Controller()
        cntl.error_code, cntl.error_text = berr.OK, ""
        cntl.response = None
        timeout_ms = (cntl.timeout_ms if cntl.timeout_ms is not None
                      else self.options.timeout_ms)
        try:
            conn = self._connection()
        except OSError as e:
            cntl.set_failed(berr.EFAILEDSOCKET, f"connect failed: {e}")
            return cntl
        cid = next(self._cids)
        cntl.correlation_id = cid
        meta = tpu_std.RpcMeta(
            request=tpu_std.RpcRequestMeta(
                service_name=service, method_name=method,
                timeout_ms=int(timeout_ms) if timeout_ms else 0),
            correlation_id=cid)
        ev = threading.Event()
        with self._lock:
            self._pending[cid] = (ev, cntl, conn)
        try:
            conn.send(tpu_std.pack_frame(meta, bytes(request)))
        except OSError as e:
            with self._lock:
                self._pending.pop(cid, None)
            cntl.set_failed(berr.EFAILEDSOCKET, f"write failed: {e}")
            return cntl
        if not ev.wait(None if not timeout_ms else timeout_ms / 1e3):
            with self._lock:
                still = self._pending.pop(cid, None)
            if still is not None:
                cntl.set_failed(berr.ERPCTIMEDOUT,
                                f"deadline of {timeout_ms}ms exceeded")
                return cntl
            ev.wait()                   # the response raced the timeout
        return cntl

    def close(self) -> None:
        with self._lock:
            self._closed = True
            conn, self._conn = self._conn, None
        if conn is not None:
            conn.close()                # fails what still waits on it
            conn.join()
