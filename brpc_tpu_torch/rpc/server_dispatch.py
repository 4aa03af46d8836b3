"""Server-side request processing (the port of
brpc_tpu/rpc/server_dispatch.py; bRPC's ProcessRpcRequest,
policy/baidu_rpc_protocol.cpp:314, and SendRpcResponse, :139).

``process_request`` is the coroutine the InputMessenger returns for a
request. The last request of a read is stepped in place on the thread
that read it, until it first suspends; earlier ones run as fibers. A
handler that is not a coroutine function may block, so a request on a
thread that is not a fiber worker (the dispatcher) hops to a worker
first (``_HopToWorker``); a coroutine handler stays in place until its
first real ``await``.

The deadline travels in the request meta's ``timeout_ms`` and counts
from the frame's cut time (``RpcMessage.arrival_ns``), so waiting for
dispatch and for a worker spends it; a request whose deadline passed
before its handler would start is shed with ``ERPCTIMEDOUT``
(``server_deadline_shed``).

Responses are framed as brpc_tpu frames them: a success carries only the
correlation id in its meta (the small-call fast path); a failure, the
answer to a call whose stream the handler accepted, or one with tensors,
carries the full meta.

Tensors: the request's, inline or from the lane, reach the handler in
``cntl.request_device_arrays`` (brpc_tpu/rpc/server_dispatch.py:340-345);
what the handler sets in ``cntl.response_device_arrays`` goes back on the
connection's device lane when it has one, the batch and the response
frame as an adjacent pair under ``socket.lane_lock`` (:964-1000), and
inline otherwise. Under ``rpcz_enabled`` the server span is stamped as the
reference's (server_dispatch.py:300-317, :473, :490): ``received_us`` at
the cut, ``dispatch_us`` at dispatch, ``parse_done_us``,
``handler_start_us``/``handler_end_us`` around the handler,
``serialized_us`` when the response is packed, and ``flushed_us`` by the
response write's ``on_done`` once the kernel took it. The request's lane
take becomes a ``device-recv`` child span (``RpcMessage.device_recv``),
and the response batch's stage tracker hangs its device span off the
server span. A cuda-ipc request batch (``ici://``) arrives with its copy
queued: the request's fiber parks until the copy has run
(``device_ready`` on the batch's ``ready``) before the handler runs,
never blocking the dispatcher.

``current_serving_controller()`` (brpc_tpu/rpc/server_dispatch.py:95-108)
is the controller of the request whose handler runs on this fiber: a
fiber-local set for the request's whole residence, in place on the
dispatcher and after the hop to a worker alike, and cleared in
``finally``. A nested ``Channel.call`` reads it to inherit the parent's
remaining budget and trace. The HTTP path sets it too (``Server``).

The reference's limiter and priority sheds, capture and fast drains are
still to port (ROADMAP section 1).
"""

from __future__ import annotations

import inspect
import logging
import time
from typing import Optional

from brpc_tpu_torch.butil.flags import flag
from brpc_tpu_torch.bvar.reducer import Adder
from brpc_tpu_torch.fiber.device_poller import device_ready
from brpc_tpu_torch.fiber.keys import FiberLocal
from brpc_tpu_torch.fiber.scheduler import SchedAwaitable, current_group
from brpc_tpu_torch.protocol import tpu_std

from . import errno_codes as berr
from . import span as _span
from .controller import Controller

log = logging.getLogger("brpc_tpu_torch.rpc")

# requests shed with ERPCTIMEDOUT: their client's budget was gone
# before the handler would start (exposed by Server.start)
nshed = Adder()

# the controller of the request this fiber serves; set around the
# request's residence only, since a fiber that served one request must
# not clamp an unrelated later call
_serving_cntl = FiberLocal()


def current_serving_controller() -> Optional[Controller]:
    """The server-side Controller whose handler runs on this fiber (or
    thread), or None outside a handler."""
    return _serving_cntl.get()


class _HopToWorker(SchedAwaitable):
    """Move the current fiber from an inline context (the dispatcher)
    onto a fiber worker before it runs code that may block."""

    def _register(self, fiber) -> None:
        fiber.control.schedule(fiber, None)


async def process_request(proto, msg: tpu_std.RpcMessage, socket) -> None:
    server = socket.user_data.get("server")
    cid = msg.meta.correlation_id
    if server is None:
        _send_error(proto, socket, cid, berr.EINTERNAL,
                    "no server bound to socket")
        return
    req = msg.meta.request
    method = server.find_method(req.service_name, req.method_name)
    if method is None:
        known = req.service_name in server.services()
        _send_error(proto, socket, cid,
                    berr.ENOMETHOD if known else berr.ENOSERVICE,
                    f"{req.service_name}.{req.method_name} not found")
        return
    if not server.is_running:
        _send_error(proto, socket, cid, berr.ELOGOFF, "server is stopping")
        return
    server._request_begin()
    try:
        await _process_request_body(proto, msg, socket, server, method)
    finally:
        server._request_done()


def _expired(cntl: Controller, method, server, budget_ms: int,
             where: str) -> bool:
    if budget_ms <= 0 or not cntl.deadline_expired():
        return False
    nshed.add(1)
    server._request_end(method.full_name, 0.0, True)
    cntl.set_failed(berr.ERPCTIMEDOUT,
                    f"deadline {budget_ms}ms expired before {where}")
    return True


async def _process_request_body(proto, msg: tpu_std.RpcMessage, socket,
                                server, method) -> None:
    t0 = time.monotonic_ns()
    meta = msg.meta
    req = meta.request
    cntl = Controller()
    cntl.correlation_id = meta.correlation_id
    cntl._server_socket = socket
    cntl.trace_id = meta.trace_id
    cntl.span_id = meta.span_id
    cntl.log_id = req.log_id
    cntl.remote_side = socket.remote_endpoint
    if meta.stream_settings is not None:
        cntl._peer_stream_id = meta.stream_settings.stream_id
    _serving_cntl.set(cntl)
    try:
        await _serve(proto, msg, socket, server, method, cntl, t0)
    finally:
        _serving_cntl.set(None)
        cntl._drop_cancel_subs()


async def _serve(proto, msg: tpu_std.RpcMessage, socket, server, method,
                 cntl: Controller, t0: int) -> None:
    meta = msg.meta
    req = meta.request
    # the client's whole budget, counted from the frame's cut
    cntl.set_deadline(req.timeout_ms, msg.arrival_ns)
    # a cuda-ipc batch's copy may still be running: the fiber parks
    # until it has run before the handler sees the tensors
    landed = getattr(msg.device_arrays, "ready", None)
    if meta.device_payloads:
        try:
            cntl.request_device_arrays = tpu_std.merge_device_arrays(msg)
        except ValueError as e:         # DecodeError, a dtype not known
            cntl.set_failed(berr.EREQUEST, f"bad request tensors: {e}")
            _send_response(proto, socket, cntl, b"")
            return
    span = None
    if flag("rpcz_enabled"):
        span = _span.start_server_span(cntl, req.service_name,
                                       req.method_name)
        span.request_size = len(msg.payload) + len(msg.attachment)
        # the timeline's base is the cut, so latency_us is the whole
        # server residence and received -> dispatch the dispatch wait
        span.received_us = span.start_us = msg.arrival_ns // 1000
        span.dispatch_us = t0 // 1000
        if msg.device_recv is not None:
            # the request's receive leg, a child of this server span
            # (brpc_tpu/rpc/server_dispatch.py:346-353)
            _span.submit_device_recv_span(span, msg.device_recv)
    if landed is not None and not landed.done():
        await device_ready(landed)
    try:
        if _expired(cntl, method, server, req.timeout_ms, "dispatch"):
            _send_response(proto, socket, cntl, b"", span)
            return
        if span is not None:
            # the payload is the request's bytes: nothing to parse
            span.parse_done_us = time.monotonic_ns() // 1000
        if current_group() is None and \
                not inspect.iscoroutinefunction(method.handler):
            await _HopToWorker()
            if _expired(cntl, method, server, req.timeout_ms,
                        "handler entry"):
                _send_response(proto, socket, cntl, b"", span)
                return
        h0 = time.monotonic_ns()
        if span is not None:
            span.handler_start_us = h0 // 1000
        try:
            response = method.handler(cntl, msg.payload)
            if inspect.isawaitable(response):
                response = await response
        except Exception as e:          # boundary: report, keep serving
            log.exception("handler %s failed", method.full_name)
            cntl.set_failed(berr.EINTERNAL, f"{type(e).__name__}: {e}")
            response = b""
        finally:
            if span is not None:
                span.handler_end_us = time.monotonic_ns() // 1000
            server._request_end(method.full_name,
                                (time.monotonic_ns() - h0) / 1e3,
                                cntl.failed())
        _send_response(proto, socket, cntl, response or b"", span)
    finally:
        if span is not None:
            # with the flush latch armed, the span is submitted once the
            # write's on_done has stamped flushed_us
            _span.finish_span(span, cntl)


def _send_response(proto, socket, cntl: Controller, response: bytes,
                   span=None) -> None:
    accepted = cntl._accepted_stream
    arrays = [] if cntl.failed() else list(cntl.response_device_arrays)
    lane = None
    if cntl.failed() or accepted is not None or arrays:
        meta = tpu_std.RpcMeta(
            response=tpu_std.RpcResponseMeta(cntl.error_code,
                                             cntl.error_text),
            correlation_id=cntl.correlation_id)
        if accepted is not None:
            meta.stream_settings = tpu_std.StreamSettings(
                stream_id=accepted.id)
        try:
            frame, lane = tpu_std.pack_frame(
                meta, b"" if cntl.failed() else bytes(response),
                device_arrays=arrays,
                device_lane=bool(arrays) and socket.conn.supports_device_lane)
        except (TypeError, ValueError, RuntimeError) as e:
            frame, lane = _failed_tensors_frame(cntl, meta, e), None
    else:
        frame = tpu_std.pack_small_frame(b"", cntl.correlation_id,
                                         bytes(response))
    on_done = None
    if span is not None:
        span.response_size = 0 if cntl.failed() else len(response)
        span.serialized_us = time.monotonic_ns() // 1000
        _span.expect_flush(span)
        on_done = lambda err, s=span: _span.mark_flushed(s, err)  # noqa: E731
    # a failed socket fires on_done with the reason: the client is gone
    if lane is None:
        socket.write(frame, on_done=on_done)
        return
    try:
        with socket.lane_lock:
            try:
                # on cudad:// the host copy of the tensors runs here; the
                # batch's device span is a child of this server span
                socket.write_device_payload(lane, span=span)
            except (TypeError, ValueError, RuntimeError) as e:
                # no batch went out: answer without one
                frame = _failed_tensors_frame(cntl, meta, e)
                if span is not None:
                    span.response_size = 0
            socket.write(frame, on_done=on_done)
    except OSError as e:
        socket.set_failed(e)
        if on_done is not None:
            on_done(e)


def _failed_tensors_frame(cntl: Controller, meta, e: Exception) -> bytes:
    """A tensor that cannot be sent fails the call, not the server: the
    EINTERNAL frame that answers in place of the response."""
    log.exception("response tensors of call %d", cntl.correlation_id)
    cntl.set_failed(berr.EINTERNAL, f"{type(e).__name__}: {e}")
    meta.device_payloads = []
    meta.response = tpu_std.RpcResponseMeta(cntl.error_code, cntl.error_text)
    return tpu_std.pack_frame(meta)[0]


def _send_error(proto, socket, cid: int, code: int, text: str) -> None:
    cntl = Controller()
    cntl.correlation_id = cid
    cntl.set_failed(code, text)
    _send_response(proto, socket, cntl, b"")
