"""Channel: tpu_std calls over one client Socket, with streams (the port
of brpc_tpu/rpc/channel.py).

The channel dials with ``create_client_socket``: the connection is a
consumer of the process's event dispatcher, and its input goes through an
``InputMessenger`` to ``client_dispatch.process_response``, in place on
the dispatcher thread. Calls from many threads share the socket; each
call registers under a fresh correlation id, writes its request and
parks on an Event that the response sets. A call that outlives its
timeout fails with ``ERPCTIMEDOUT`` and its late response, if any, is
dropped. The socket's failure fails every call still waiting on it with
``EFAILEDSOCKET``, and the next call dials again. The request meta
carries ``timeout_ms`` so the server can shed work the client no longer
waits for.

``call_sync(..., stream_options=...)`` sets a Stream up on the call
(brpc_tpu/rpc/channel.py:482-485, :811-819): the stream is registered
before the request is written, so its frames are delivered even when
they overtake the response (the server may send the first token before
the handler's answer). The response binds the stream to the peer's id
and to the socket, whose failure then closes it; a failed call closes
it.

``call_sync(..., request_device_arrays=[t, ...])`` sends tensors with
the request (brpc_tpu/rpc/channel.py:391-394, :820-850). On a connection
with a device lane (mem, cuda, cudad, ici) they ride the lane, and the batch
and the request frame are written as an adjacent pair under the socket's
``lane_lock``, since the receiver pairs batches with frames by order; on
tcp they are copied to the host and go inline in the frame. The
response's tensors come back in ``cntl.response_device_arrays``.
``device_lane_kind()`` names the lane of the channel's connection.

Under the ``rpcz_enabled`` flag a call gets a client span
(brpc_tpu/rpc/channel.py:487, :876; client_dispatch.py:137-150): its
trace and span ids ride the request meta (fields 8-9), ``write_done_us``
is stamped when the write returns, ``first_byte_us`` at the response's
cut and ``parse_done_us`` once it is processed, and the span is finished
when the call ends.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import List, Optional

from brpc_tpu_torch.butil.endpoint import str2endpoint
from brpc_tpu_torch.butil.flags import flag
from brpc_tpu_torch.protocol import tpu_std
from brpc_tpu_torch.transport.input_messenger import InputMessenger
from brpc_tpu_torch.transport.socket import Socket, create_client_socket

from . import client_dispatch
from . import errno_codes as berr
from . import span as _span
from .controller import Controller
from .stream import Stream, StreamOptions

_messenger: Optional[InputMessenger] = None
# the longest an ici:// dial waits for the peer's hello
_HELLO_TIMEOUT_S = 10.0


def _client_messenger() -> InputMessenger:
    global _messenger
    if _messenger is None:
        _messenger = InputMessenger()
    return _messenger


@dataclass
class ChannelOptions:
    timeout_ms: Optional[float] = 1000.0


class Channel:
    def __init__(self, address: str,
                 options: Optional[ChannelOptions] = None):
        self.address = address
        self.endpoint = str2endpoint(address)
        self.options = options or ChannelOptions()
        self._lock = threading.Lock()
        self._socket: Optional[Socket] = None
        self._closed = False

    def _get_socket(self) -> Socket:
        with self._lock:
            if self._closed:
                raise ConnectionError("channel closed")
            s = self._socket
            if s is None or s.failed:
                s = create_client_socket(
                    self.endpoint,
                    on_input=_client_messenger().on_new_messages)
                s.on_failed(self._on_socket_failed)
                # an ici:// dial completes with the peer's hello (the
                # QP bring-up): the first batch then goes, and is
                # counted, on the lane it really takes
                wait_hello = getattr(s.conn, "wait_hello", None)
                if wait_hello is not None and \
                        not wait_hello(_HELLO_TIMEOUT_S):
                    s.set_failed(ConnectionError("no hello from the peer"))
                    raise ConnectionError(
                        f"no hello from {self.address} within "
                        f"{_HELLO_TIMEOUT_S} s")
                self._socket = s
            return s

    @staticmethod
    def _on_socket_failed(socket: Socket) -> None:
        """Fail the calls still waiting on ``socket``; calls sent on a
        newer socket are not its business."""
        client_dispatch.fail_calls(socket, berr.EFAILEDSOCKET,
                                   "connection closed")

    def device_lane_kind(self) -> Optional[str]:
        """The device lane of this channel's connection (``loopback-d2d``,
        ``staged-dcn``; on ici:// ``local-d2d``, ``cuda-ipc`` or
        ``staged``, from the peer's hello), or None without one; dials
        if needed."""
        try:
            conn = self._get_socket().conn
        except OSError:
            return None
        if not conn.supports_device_lane:
            return None
        return conn.lane_kind

    def call_sync(self, service: str, method: str, request: bytes = b"",
                  cntl: Optional[Controller] = None,
                  stream_options: Optional[StreamOptions] = None,
                  request_device_arrays: Optional[List] = None
                  ) -> Controller:
        """Send one request and wait for its response. Returns the
        controller: ``failed()`` / ``error_code`` / ``response``, the
        response's tensors in ``response_device_arrays``, and ``stream``
        when ``stream_options`` set a stream up."""
        cntl = cntl or Controller()
        cntl.error_code, cntl.error_text = berr.OK, ""
        cntl.response = None
        cntl.stream = None
        cntl.request_device_arrays = list(request_device_arrays or ())
        cntl.response_device_arrays = []
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
            sock = self._get_socket()
        except OSError as e:
            cntl.set_failed(berr.EFAILEDSOCKET, f"connect failed: {e}")
            return cntl
        ev = client_dispatch.register_call(cntl, sock)
        cid = cntl.correlation_id
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
            meta.stream_settings = tpu_std.StreamSettings(
                stream_id=cntl.stream.id)
        arrays = cntl.request_device_arrays
        try:
            wire, lane = tpu_std.pack_frame(
                meta, bytes(request), device_arrays=arrays,
                device_lane=bool(arrays) and sock.conn.supports_device_lane)
            if lane is None:
                written = sock.write(wire)
            else:
                # the batch and its frame, adjacent: Socket.write only
                # queues, and the peer learns of the bytes through the
                # dispatcher, so nothing of it runs under the lock
                with sock.lane_lock:
                    # the batch's device span is a child of the call's
                    sock.write_device_payload(lane,
                                              span=cntl._client_span)
                    written = sock.write(wire)
        except OSError as e:
            written = False
            sock.set_failed(e)
        except BaseException:
            # a tensor that cannot be sent (a failed copy, an unknown
            # dtype) fails loudly: no fallback
            client_dispatch.take_call(cid)
            raise
        if not written or sock.failed:
            # the socket failed before or as the call was registered
            if client_dispatch.take_call(cid) is not None:
                cntl.set_failed(berr.EFAILEDSOCKET,
                                f"write failed: {sock.fail_reason}")
                return cntl
        span = cntl._client_span
        if span is not None:
            # the write queued the whole frame; most often the kernel
            # took it in the write itself
            span.write_done_us = time.monotonic_ns() // 1000
        if not ev.wait(None if not timeout_ms else timeout_ms / 1e3):
            if client_dispatch.take_call(cid) is not None:
                cntl.set_failed(berr.ERPCTIMEDOUT,
                                f"deadline of {timeout_ms}ms exceeded")
                return cntl
            ev.wait()                   # the response raced the timeout
        return cntl

    def close(self) -> None:
        with self._lock:
            self._closed = True
            s, self._socket = self._socket, None
        if s is not None:
            s.set_failed(ConnectionError("channel closed"))
