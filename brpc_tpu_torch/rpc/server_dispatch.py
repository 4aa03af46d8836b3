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

Overload control, before any slot is taken and before the handler
(brpc_tpu/rpc/server_dispatch.py:208-240): while the server's admission
controller is engaged, a request whose level (its priority and its
user slot: its auth token's, else its connection's,
``_request_level``) sits under the threshold is
shed with EPRIORITYSHED (``server_priority_shed``); a request that
waited in dispatch past ``queue_delay_shed_ms`` (``_queue_delay_shed``)
and one the limiters refuse (``Server.on_request_start``) are shed with
ELIMIT (``server_limit_shed``). The handler's end releases the cost its
admission charged. While the server sheds by priority, every response
carries its threshold (``RpcResponseMeta.admission_threshold``), and a
success then takes the full meta.

Auth, compression and the user's hooks (brpc_tpu/rpc/server_dispatch.py:
173-198, :360-363, :405-494, :956-959): with ``ServerOptions.auth`` (or
``auth_token``) a connection's first request has its credential verified
before the method lookup, so an unauthenticated peer learns nothing of
the services; a rejected one is answered ERPCAUTH, and the verified
``AuthContext`` is cached on the connection. A payload sent compressed
(``RpcMeta.compress_type``) is decompressed before the handler, and the
response goes back compressed in the same kind. ``ServerOptions.
interceptor`` may reject a decoded request with its own error code; a
``session_local_data_factory`` lends the handler an object of its pool;
with ``usercode_in_pthread`` a handler that is not a coroutine function
runs on the usercode pool (``rpc/usercode.py``) while its fiber parks.
Capture (brpc_tpu/rpc/server_dispatch.py:364-397, :421-423, :499-503):
while the traffic recorder (``traffic/capture.py``) is on, a request is
sampled after its payload is decompressed, and its record completes
with the call's error code and latency, on every way out after that
(the interceptor's refusal, the deadline at handler entry, the
handler's end); a request shed before it is not recorded. The
reference's fast drains are still to port (ROADMAP section 1).
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
from brpc_tpu_torch.traffic import capture as _cap

from . import admission
from . import compress as _compress
from . import errno_codes as berr
from . import span as _span
from .auth import AuthError, InterceptorError
from .controller import Controller
from .usercode import run_usercode

log = logging.getLogger("brpc_tpu_torch.rpc")

# requests shed with ERPCTIMEDOUT: their client's budget was gone
# before the handler would start (exposed by Server.start)
nshed = Adder()
# requests shed with ELIMIT by the limiters and the queue-delay gate
nlimit_shed = Adder()
# requests shed with EPRIORITYSHED by the admission threshold
npriority_shed = Adder()

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
    # auth precedes the lookup: an unauthenticated peer must not learn
    # the services from the error codes. Verified once a connection
    auth = server._auth
    if auth is not None and socket.user_data.get("auth_context") is None:
        try:
            ctx = auth.verify_credential(req.auth_token,
                                         socket.remote_endpoint)
        except AuthError as e:
            _send_error(proto, socket, cid, berr.ERPCAUTH,
                        str(e) or "authentication failed")
            return
        except Exception:               # boundary: a broken authenticator
            _send_error(proto, socket, cid, berr.ERPCAUTH,
                        "authentication failed")
            return
        socket.user_data["auth_context"] = ctx
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
    # priority admission, before any slot: while the server is in
    # overload, a request under the threshold is shed, cheaply and with
    # an errno of its own
    level = 0
    counted = False
    adm = server._admission
    if adm is not None and adm.threshold_engaged():
        level = _request_level(req.priority, req.auth_token, socket)
        counted = True                  # admit_level counts it
        if not adm.admit_level(level):
            npriority_shed.add(1)
            _send_error(proto, socket, cid, berr.EPRIORITYSHED,
                        "priority below admission threshold "
                        "(server overloaded)")
            return
    if _queue_delay_shed(server, msg.arrival_ns, level, counted):
        _send_error(proto, socket, cid, berr.ELIMIT,
                    "queue delay over shed budget (server overloaded)")
        return
    cost = server.on_request_start(method.full_name,
                                   len(msg.payload) + len(msg.attachment),
                                   level, counted)
    if not cost:
        _send_error(proto, socket, cid, berr.ELIMIT,
                    "max_concurrency reached")
        return
    server._request_begin()
    try:
        await _process_request_body(proto, msg, socket, server, method,
                                    cost)
    finally:
        server._request_done()


def _queue_delay_shed(server, arrival_ns: int, level: int = 0,
                      level_counted: bool = False) -> bool:
    """True: the request waited from its cut to its dispatch longer than
    the server's queue-delay budget, and is shed now. A trip is overload
    evidence for the admission controller."""
    qns = server._queue_shed_ns
    if not qns or not arrival_ns:
        return False
    if time.monotonic_ns() - arrival_ns <= qns:
        return False
    nlimit_shed.add(1)
    if server._admission is not None:
        server._admission.signal_overload(level, level_counted)
    return True


def _request_level(priority: int, auth_token: str, socket) -> int:
    """The request's admission level: its wire priority, and a user
    slot, that of the request's auth token when it carries one, else
    that of its connection's client address (the socket's
    ``remote_endpoint`` is the client's ``local_endpoint``; both sides
    hash it the same, ``admission.cached_socket_slot``)."""
    slot = admission.user_slot(auth_token) if auth_token else \
        admission.cached_socket_slot(socket, socket.remote_endpoint)
    return admission.compose_level(priority, slot)


def _expired(cntl: Controller, method, server, budget_ms: int,
             where: str, cost: float) -> bool:
    if budget_ms <= 0 or not cntl.deadline_expired():
        return False
    nshed.add(1)
    server.on_request_end(method.full_name, 0.0, True, cost)
    cntl.set_failed(berr.ERPCTIMEDOUT,
                    f"deadline {budget_ms}ms expired before {where}")
    return True


async def _process_request_body(proto, msg: tpu_std.RpcMessage, socket,
                                server, method, cost: float) -> None:
    t0 = time.monotonic_ns()
    meta = msg.meta
    req = meta.request
    cntl = Controller()
    cntl.correlation_id = meta.correlation_id
    cntl._server_socket = socket
    cntl.trace_id = meta.trace_id
    cntl.span_id = meta.span_id
    cntl.log_id = req.log_id
    cntl.request_priority = req.priority
    cntl.auth_token = req.auth_token
    cntl.auth_context = socket.user_data.get("auth_context")
    cntl.remote_side = socket.remote_endpoint
    # the flight recorder labels samples by these
    cntl._service_name = req.service_name
    cntl._method_name = req.method_name
    socket.last_method = method.full_name
    if meta.stream_settings is not None:
        cntl._peer_stream_id = meta.stream_settings.stream_id
    _serving_cntl.set(cntl)
    try:
        await _serve(proto, msg, socket, server, method, cntl, t0, cost)
    finally:
        _serving_cntl.set(None)
        cntl._drop_cancel_subs()


async def _serve(proto, msg: tpu_std.RpcMessage, socket, server, method,
                 cntl: Controller, t0: int, cost: float) -> None:
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
            server.on_request_end(method.full_name, 0.0, True, cost)
            _send_response(proto, socket, cntl, b"")
            return
    span = None
    if flag("rpcz_enabled"):
        span = _span.start_server_span(cntl, req.service_name,
                                       req.method_name)
        # the flight recorder's stall watchdog annotates it through here
        cntl._span = span
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
        if _expired(cntl, method, server, req.timeout_ms, "dispatch",
                    cost):
            _send_response(proto, socket, cntl, b"", span)
            return
        request = msg.payload
        if meta.compress_type:
            try:
                request = _compress.decompress(request, meta.compress_type)
            except Exception as e:      # an unknown codec, corrupt bytes
                server.on_request_end(method.full_name, 0.0, True, cost)
                cntl.set_failed(berr.EREQUEST,
                                f"cannot parse request: {e}")
                _send_response(proto, socket, cntl, b"", span)
                return
            cntl.compress_type = meta.compress_type     # reply in kind
        # captured after decompression, so a replay sends plaintext; a
        # broken capture directory never fails the call
        cap_rec = None
        rec = _cap.global_recorder()
        try:
            if rec.capture_enabled():
                cap_rec = rec.sample_request(
                    method.full_name, "", "", request, msg.attachment,
                    msg.arrival_ns or t0, req.timeout_ms, req.log_id,
                    req.priority)
        except Exception:
            cap_rec = None
        if span is not None:
            span.parse_done_us = time.monotonic_ns() // 1000
        if _intercepted(server, method, cntl, cost):
            _capture_done(rec, cap_rec, cntl, t0)
            _send_response(proto, socket, cntl, b"", span)
            return
        in_pool = server.options.usercode_in_pthread and \
            not inspect.iscoroutinefunction(method.handler)
        if current_group() is None and not in_pool and \
                not inspect.iscoroutinefunction(method.handler):
            await _HopToWorker()
            if _expired(cntl, method, server, req.timeout_ms,
                        "handler entry", cost):
                _capture_done(rec, cap_rec, cntl, t0)
                _send_response(proto, socket, cntl, b"", span)
                return
        pool = server.session_local_pool
        if pool is not None:
            cntl._session_local = pool.borrow()
        h0 = time.monotonic_ns()
        if span is not None:
            span.handler_start_us = h0 // 1000
        try:
            if in_pool:
                # blocking user code on the usercode pool; this fiber,
                # not its worker, waits
                response = await run_usercode(method.handler, cntl, request)
            else:
                response = method.handler(cntl, request)
            if inspect.isawaitable(response):
                response = await response
        except Exception as e:          # boundary: report, keep serving
            log.exception("handler %s failed", method.full_name)
            cntl.set_failed(berr.EINTERNAL, f"{type(e).__name__}: {e}")
            response = b""
        finally:
            if span is not None:
                span.handler_end_us = time.monotonic_ns() // 1000
            if pool is not None:
                pool.give_back(cntl._session_local)
                cntl._session_local = None
            server.on_request_end(method.full_name,
                                  (time.monotonic_ns() - h0) / 1e3,
                                  cntl.failed(), cost)
        _capture_done(rec, cap_rec, cntl, t0)
        _send_response(proto, socket, cntl, response or b"", span)
    finally:
        if span is not None:
            # with the flush latch armed, the span is submitted once the
            # write's on_done has stamped flushed_us
            _span.finish_span(span, cntl)


def _capture_done(rec, cap_rec, cntl: Controller, t0: int) -> None:
    """Complete a sampled request's record with its verdict; the
    recorder's writer thread takes it to disk."""
    if cap_rec is not None:
        rec.record_complete(cap_rec, cntl.error_code,
                            (time.monotonic_ns() - t0) / 1e3)


def _intercepted(server, method, cntl: Controller, cost: float) -> bool:
    """True: ``ServerOptions.interceptor`` rejected the decoded request
    (interceptor.h Accept); ``cntl`` holds its error."""
    interceptor = server.options.interceptor
    if interceptor is None:
        return False
    try:
        verdict = interceptor(cntl)
    except InterceptorError as e:
        verdict = (e.error_code, e.reason)
    except Exception as e:              # boundary: a broken interceptor
        verdict = (berr.EINTERNAL, f"interceptor error: {e}")
    if verdict is None:
        return False
    server.on_request_end(method.full_name, 0.0, True, cost)
    cntl.set_failed(*verdict)
    return True


def _send_response(proto, socket, cntl: Controller, response: bytes,
                   span=None) -> None:
    accepted = cntl._accepted_stream
    arrays = [] if cntl.failed() else list(cntl.response_device_arrays)
    lane = None
    # while the server sheds by priority its threshold rides every
    # response (brpc_tpu/rpc/server_dispatch.py:905-948); calm, the wire
    # stays as it was
    server = socket.user_data.get("server")
    adm = getattr(server, "_admission", None)
    threshold = adm.wire_threshold() if adm is not None else 0
    if cntl.failed() or accepted is not None or arrays or threshold \
            or cntl.compress_type:
        meta = tpu_std.RpcMeta(
            response=tpu_std.RpcResponseMeta(cntl.error_code,
                                             cntl.error_text, threshold),
            correlation_id=cntl.correlation_id)
        if cntl.compress_type and response and not cntl.failed():
            # the response in the kind the request came
            response = _compress.compress(bytes(response),
                                          cntl.compress_type)
            meta.compress_type = cntl.compress_type
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
    meta.response = tpu_std.RpcResponseMeta(
        cntl.error_code, cntl.error_text, meta.response.admission_threshold)
    return tpu_std.pack_frame(meta)[0]


def _send_error(proto, socket, cid: int, code: int, text: str) -> None:
    cntl = Controller()
    cntl.correlation_id = cid
    cntl.set_failed(code, text)
    _send_response(proto, socket, cntl, b"")
