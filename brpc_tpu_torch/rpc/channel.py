"""Channel: tpu_std calls over one client Socket, with streams (the port
of brpc_tpu/rpc/channel.py).

The channel dials with ``create_client_socket``: the connection is a
consumer of the process's event dispatcher, and its input goes through an
``InputMessenger`` to ``client_dispatch.process_response``, in place on
the dispatcher thread. Calls from many threads share the socket.
``call`` registers the call under a fresh correlation id, writes its
request, arms its deadline timer on the fiber timer and returns the
controller; ``call_sync`` joins it on the calling thread, ``call_async``
parks the calling fiber, and ``done`` runs where the call completes.
Exactly one of the response, the deadline timer, the socket's failure
and ``Controller.start_cancel`` completes a call (``Controller._complete``);
a late response is dropped. A call that outlives its timeout fails with
``ERPCTIMEDOUT``; the socket's failure fails every call still waiting on
it with ``EFAILEDSOCKET``, and the next call dials again. The request
meta carries ``timeout_ms`` so the server can shed work the client no
longer waits for; inside a handler that is at most the parent request's
remaining budget (brpc_tpu/rpc/channel.py:411-448).

``call(..., stream_options=...)`` sets a Stream up on the call
(brpc_tpu/rpc/channel.py:482-485, :811-819): the stream is registered
before the request is written, so its frames are delivered even when
they overtake the response (the server may send the first token before
the handler's answer). The response binds the stream to the peer's id
and to the socket, whose failure then closes it; a failed call closes
it.

``call(..., request_device_arrays=[t, ...])`` sends tensors with
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
from typing import Callable, List, Optional

from brpc_tpu_torch.butil.endpoint import str2endpoint
from brpc_tpu_torch.butil.flags import flag
from brpc_tpu_torch.fiber.timer import global_timer
from brpc_tpu_torch.protocol import tpu_std
from brpc_tpu_torch.transport.input_messenger import InputMessenger
from brpc_tpu_torch.transport.socket import Socket, create_client_socket

from . import client_dispatch
from . import errno_codes as berr
from . import span as _span
from .controller import Controller
from .server_dispatch import current_serving_controller
from .stream import Stream, StreamOptions

_messenger: Optional[InputMessenger] = None
# the longest an ici:// dial waits for the peer's hello
_HELLO_TIMEOUT_S = 10.0


def _join_budget(cntl: Controller) -> Optional[float]:
    """How long a joiner waits: the deadline timer ends the call first,
    so the slack only bounds a joiner whose call nothing completes."""
    return None if not cntl.timeout_ms else cntl.timeout_ms / 1e3 + 5.0


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

    def call(self, service: str, method: str, request: bytes = b"",
             cntl: Optional[Controller] = None,
             done: Optional[Callable[[Controller], None]] = None,
             request_device_arrays: Optional[List] = None,
             stream_options: Optional[StreamOptions] = None) -> Controller:
        """Begin one call and return its controller at once
        (brpc_tpu/rpc/channel.py:391). Wait with ``cntl.join()`` on a
        thread or ``await cntl.join_async()`` in a fiber, or pass
        ``done``: ``done(cntl)`` runs where the call completes, most
        often in place on the event dispatcher as the response is
        processed, else on the timer thread, on the thread that saw the
        socket fail, or in this call when it completes before returning.
        ``done`` must not block.

        Inside a handler the call inherits the request being served
        (``current_serving_controller``): its timeout shrinks to the
        parent's remaining budget, it joins the parent's trace, and a
        parent whose budget is spent fails it with ERPCTIMEDOUT before
        any socket work."""
        cntl = cntl or Controller()
        if cntl.start_us:
            cntl._reset_for_call()      # a reused controller
        cntl.start_us = time.monotonic_ns() // 1000
        cntl._done_cb = done
        if cntl.timeout_ms is None:
            cntl.timeout_ms = self.options.timeout_ms
        parent = current_serving_controller()
        if parent is not None and parent is not cntl:
            if parent.trace_id and not cntl.trace_id:
                cntl.trace_id = parent.trace_id
                cntl.span_id = parent.span_id
            rem = parent.remaining_ms()
            if rem is not None:
                if rem <= 0.0:
                    cntl.set_failed(berr.ERPCTIMEDOUT,
                                    "parent request's deadline budget "
                                    "exhausted before nested call")
                    cntl._complete()
                    return cntl
                if not cntl.timeout_ms or cntl.timeout_ms > rem:
                    cntl.timeout_ms = rem
        if cntl.timeout_ms:
            cntl._deadline_ns = time.monotonic_ns() + int(
                cntl.timeout_ms * 1e6)
        cntl.request_device_arrays = list(request_device_arrays or ())
        if flag("rpcz_enabled"):
            span = _span.start_client_span(cntl, service, method)
            span.request_size = len(request)
            cntl._client_span = span
            cntl._add_complete_hook(
                lambda c, s=span: _span.finish_span(s, c))
        self._issue(service, method, request, cntl, stream_options)
        # the deadline timer (HandleTimeout, final). The call may have
        # completed during the issue: arming then would pin the
        # controller in the timer heap for the whole timeout, so check
        # before, and after, since a completion on another thread can
        # interleave with the arm
        if cntl.timeout_ms and not cntl._completed:
            tid = global_timer().schedule_after(
                cntl.timeout_ms / 1e3, lambda: self._on_timeout(cntl))
            cntl._timer_ids.append(tid)
            if cntl._completed:
                global_timer().unschedule(tid)
        return cntl

    def call_sync(self, service: str, method: str, request: bytes = b"",
                  cntl: Optional[Controller] = None, **kw) -> Controller:
        """Send one request and wait for its response (``call`` +
        ``join``). Returns the controller: ``failed()`` / ``error_code`` /
        ``response``, the response's tensors in
        ``response_device_arrays``, and ``stream`` when ``stream_options``
        set a stream up."""
        cntl = self.call(service, method, request, cntl=cntl, **kw)
        cntl.join(_join_budget(cntl))
        return cntl

    async def call_async(self, service: str, method: str,
                         request: bytes = b"",
                         cntl: Optional[Controller] = None,
                         **kw) -> Controller:
        """``call`` + ``join_async``, for a fiber (channel.py:568)."""
        cntl = self.call(service, method, request, cntl=cntl, **kw)
        await cntl.join_async(_join_budget(cntl))
        return cntl

    @staticmethod
    def _on_timeout(cntl: Controller) -> None:
        """The deadline timer (brpc_tpu/rpc/channel.py:1246): it ends the
        call unless another path took it first."""
        with cntl._arb_lock:
            taken = client_dispatch.take_call(cntl.correlation_id) is cntl
        if taken:
            cntl.set_failed(berr.ERPCTIMEDOUT,
                            f"deadline {cntl.timeout_ms}ms exceeded")
            cntl._complete()

    def _issue(self, service: str, method: str, request: bytes,
               cntl: Controller, stream_options: Optional[StreamOptions]
               ) -> None:
        """Register the call and write its request; a failure to connect
        or to write completes it here."""
        try:
            sock = self._get_socket()
        except OSError as e:
            cntl.set_failed(berr.EFAILEDSOCKET, f"connect failed: {e}")
            cntl._complete()
            return
        cid = client_dispatch.register_call(cntl, sock)
        meta = tpu_std.RpcMeta(
            request=tpu_std.RpcRequestMeta(
                service_name=service, method_name=method,
                timeout_ms=int(cntl.timeout_ms) if cntl.timeout_ms else 0),
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
            # dtype) fails loudly: no fallback. The call completes first,
            # so its stream and span do not stay behind; the exception,
            # not ``done``, tells the caller
            if client_dispatch.take_call(cid) is cntl:
                cntl._done_cb = None
                cntl.set_failed(berr.EREQUEST, "request not sent")
                cntl._complete()
            raise
        if not written or sock.failed:
            # the socket failed before or as the call was registered
            if client_dispatch.take_call(cid) is cntl:
                cntl.set_failed(berr.EFAILEDSOCKET,
                                f"write failed: {sock.fail_reason}")
                cntl._complete()
                return
        span = cntl._client_span
        if span is not None:
            # the write queued the whole frame; most often the kernel
            # took it in the write itself
            span.write_done_us = time.monotonic_ns() // 1000

    def close(self) -> None:
        with self._lock:
            self._closed = True
            s, self._socket = self._socket, None
        if s is not None:
            s.set_failed(ConnectionError("channel closed"))
