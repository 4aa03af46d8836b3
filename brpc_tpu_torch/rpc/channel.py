"""Channel: tpu_std calls over one TCP connection, with streams.

Calls from many threads share the connection; each call takes a fresh
correlation id and parks on an Event that the connection's reader
thread sets when the matching response arrives. A call that outlives
its timeout fails with ``ERPCTIMEDOUT`` and its late response, if any,
is dropped. The request meta carries ``timeout_ms`` so the server can
stop work the client no longer waits for.

``call_sync(..., stream_options=...)`` sets a Stream up on the call
(brpc_tpu/rpc/channel.py:482-485, :811-819): the stream is registered
before the request is written, so its frames are delivered even when
they overtake the response (the server may send the first token before
the handler's answer). The response binds the stream to the peer's id
and to the connection, whose end then closes it; a failed call closes
it. Frames with correlation id 0 go to the stream registry.

Under the ``rpcz_enabled`` flag a call gets a client span
(brpc_tpu/rpc/channel.py:487, :876; client_dispatch.py:137-150): its
trace and span ids ride the request meta (fields 8-9), ``write_done_us``
is stamped when the send returns, ``first_byte_us`` and
``parse_done_us`` when the reader matches the response, and the span is
finished when the call ends.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from brpc_tpu_torch.butil.flags import flag
from brpc_tpu_torch.protocol import tpu_std
from brpc_tpu_torch.transport import tcp

from . import errno_codes as berr
from . import span as _span
from .controller import Controller
from .stream import Stream, StreamOptions, process_stream_frame


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
        if meta.is_stream_frame():
            process_stream_frame(meta, payload, attachment)
            return
        with self._lock:
            waiter = self._pending.pop(meta.correlation_id, None)
        if waiter is None:
            return                      # timed out earlier: drop
        ev, cntl, _ = waiter
        span = cntl._client_span
        if span is not None:
            span.first_byte_us = time.monotonic_ns() // 1000
        resp = meta.response
        if resp is not None and resp.error_code:
            cntl.set_failed(resp.error_code, resp.error_text)
        else:
            cntl.response = payload
            ss, stream = meta.stream_settings, cntl.stream
            if stream is not None and ss is not None and ss.stream_id:
                # here, on the reader thread: frames parsed after the
                # response find the stream bound
                stream.peer_id = ss.stream_id
                stream._bind(conn)
                stream._on_established()
        if span is not None:
            span.parse_done_us = time.monotonic_ns() // 1000
            span.response_size = len(payload)
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
                  cntl: Optional[Controller] = None,
                  stream_options: Optional[StreamOptions] = None
                  ) -> Controller:
        """Send one request and wait for its response. Returns the
        controller: ``failed()`` / ``error_code`` / ``response``, and
        ``stream`` when ``stream_options`` set a stream up."""
        cntl = cntl or Controller()
        cntl.error_code, cntl.error_text = berr.OK, ""
        cntl.response = None
        cntl.stream = None
        cntl._client_span = None
        if flag("rpcz_enabled"):
            cntl._client_span = _span.start_client_span(cntl, service,
                                                        method)
            cntl._client_span.request_size = len(request)
        try:
            return self._call(service, method, request, cntl,
                              stream_options)
        finally:
            if cntl.failed() and cntl.stream is not None:
                # a stream set up on a failed call must not stay
                # registered
                cntl.stream.close()
            if cntl._client_span is not None:
                _span.finish_span(cntl._client_span, cntl)

    def _call(self, service: str, method: str, request: bytes,
              cntl: Controller, stream_options: Optional[StreamOptions]
              ) -> Controller:
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
        if cntl.trace_id:
            meta.trace_id = cntl.trace_id
            meta.span_id = cntl.span_id
        if stream_options is not None:
            cntl.stream = Stream(stream_options)
            cntl.stream.conn = conn     # bound (watched) on the response
            meta.stream_settings = tpu_std.StreamSettings(
                stream_id=cntl.stream.id)
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
        span = cntl._client_span
        if span is not None:
            # the send queued the whole frame; most often the socket
            # took it at once (transport/tcp.py)
            span.write_done_us = time.monotonic_ns() // 1000
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
