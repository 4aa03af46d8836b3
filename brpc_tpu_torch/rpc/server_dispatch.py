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

Responses are framed as brpc_tpu frames them, in the protocol that
parsed the request (``proto.frame``, brpc_tpu/rpc/server_dispatch.py:
905-980): a success of tpu_std's framing carries only the correlation id
and the attachment's size in its meta (the small-call fast path, in the
request's magic, so hulu_pbrpc's too); a failure, the answer to a call
whose stream the handler accepted, one with tensors, and every answer of
sofa_pbrpc carry the full meta. The request's attachment reaches the
handler in ``cntl.request_attachment``, and ``cntl.response_attachment``
rides the response behind its payload.

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
handler's end); a request shed before it is not recorded.

The native lanes (brpc_tpu/rpc/server_dispatch.py:550-893).
``process_request_fast`` takes a request record of the turbo lane
(``TpuStdProtocol.turbo_scan``): the scanner has already refused every
meta that needs more than service, method and log id, so the slim body
(``_drive_fast``) keeps the gates that still apply (``is_running``, the
admission level of priority 0 and the connection's slot, the queue-delay
shed before and after the hop to a worker, the limiters, capture) and
drops the rest. A server whose options need the classic body (auth, an
interceptor, a session pool, ``usercode_in_pthread``:
``_server_turbo_ok``), or a process under ``rpcz_enabled``, sends each
record through ``process_request`` instead, as a message rebuilt from
it. ``make_fast_drain`` builds the per-event hook of a server with a
``native="echo"`` method: fastcore's ``serve_drain`` reads the fd and
serves the echo frames in one C call; what it cannot serve goes back
into the portal, and a connection that keeps deferring (16 passes in a
row) or speaks another protocol loses the hook. Both echo loops stand
down while rpcz, capture or the admission threshold is on
(``native_echo_target``): they cannot record or judge levels.
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


def expose_shed_vars() -> None:
    """The three shed counters in /vars and the trend rings: from
    ``Server.start`` (with builtin services), and from an incident
    replay's server, whose watchdog watches them."""
    nshed.expose("server_deadline_shed")
    nlimit_shed.expose("server_limit_shed")
    npriority_shed.expose("server_priority_shed")

# turbo-lane requests served by the slim body, and those sent back to the
# classic body; echo calls the C loops served, by loop
nturbo_requests = Adder().expose("turbo_requests")
nturbo_fallbacks = Adder().expose("turbo_fallbacks")
nserve_drain = Adder().expose("native_echo_drain_calls")
nserve_scan = Adder().expose("native_echo_scan_calls")

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
    if msg.attachment:
        # what the inline tensors left: the user's attachment
        cntl.request_attachment.append(msg.attachment)
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
    att = cntl.__dict__.get("response_attachment")
    att = att.to_bytes() if att and not cntl.failed() else b""
    lane = None
    # while the server sheds by priority its threshold rides every
    # response (brpc_tpu/rpc/server_dispatch.py:905-948); calm, the wire
    # stays as it was
    server = socket.user_data.get("server")
    adm = getattr(server, "_admission", None)
    threshold = adm.wire_threshold() if adm is not None else 0
    if cntl.failed() or accepted is not None or arrays or threshold \
            or cntl.compress_type or \
            type(proto).frame is not tpu_std.TpuStdProtocol.frame:
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
            frame, lane = proto.frame(
                meta, b"" if cntl.failed() else bytes(response), att,
                arrays, bool(arrays) and socket.conn.supports_device_lane)
        except (TypeError, ValueError, RuntimeError) as e:
            frame, lane = _failed_tensors_frame(proto, cntl, meta, e), None
    else:
        frame = tpu_std.pack_small_frame(b"", cntl.correlation_id,
                                         bytes(response), att, proto.MAGIC)
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
                frame = _failed_tensors_frame(proto, cntl, meta, e)
                if span is not None:
                    span.response_size = 0
            # graftlint: disable=callback-under-lock -- lane_lock pairs a
            # tensor batch with its frame. Socket.write never parks; a
            # failed send runs the socket's on_failed subscribers here: the
            # server's takes its _sockets_lock, a bound stream's its
            # _close_lock, a progressive attachment's its own RLock. None
            # takes this socket's lane_lock.
            socket.write(frame, on_done=on_done)
    except OSError as e:
        socket.set_failed(e)
        if on_done is not None:
            on_done(e)


def _failed_tensors_frame(proto, cntl: Controller, meta,
                          e: Exception) -> bytes:
    """A tensor that cannot be sent fails the call, not the server: the
    EINTERNAL frame that answers in place of the response."""
    log.exception("response tensors of call %d", cntl.correlation_id)
    cntl.set_failed(berr.EINTERNAL, f"{type(e).__name__}: {e}")
    meta.device_payloads = []
    meta.response = tpu_std.RpcResponseMeta(
        cntl.error_code, cntl.error_text, meta.response.admission_threshold)
    return proto.frame(meta)[0]


def _send_error(proto, socket, cid: int, code: int, text: str) -> None:
    cntl = Controller()
    cntl.correlation_id = cid
    cntl.set_failed(code, text)
    _send_response(proto, socket, cntl, b"")


# ----------------------------------------------------------- native lanes

def _server_turbo_ok(server) -> bool:
    """Whether the slim body can serve this server's requests, resolved
    once: auth, an interceptor, a session pool and usercode_in_pthread
    need the classic body."""
    ok = server.__dict__.get("_turbo_ok")
    if ok is None:
        o = server.options
        ok = server._turbo_ok = (
            server._auth is None and o.interceptor is None
            and server.session_local_pool is None
            and not o.usercode_in_pthread)
    return ok


def native_echo_target(server):
    """``(service, method, key)`` bytes of the server's ``native="echo"``
    method while the C echo loops may serve it, else None: they cannot
    record spans or capture, judge admission levels or answer ELOGOFF."""
    tgt = server._native_echo
    if tgt is None or not server.is_running or \
            not _server_turbo_ok(server) or flag("rpcz_enabled") or \
            _cap.global_recorder().capture_enabled():
        return None
    adm = server._admission
    if adm is not None and adm.threshold_engaged():
        return None
    return tgt


def _synth_request_msg(cid: int, service: str, method_name: str,
                       log_id: int, payload: bytes, att: bytes,
                       arrival_ns: int) -> tpu_std.RpcMessage:
    """The classic body's message for a turbo record."""
    meta = tpu_std.RpcMeta(
        request=tpu_std.RpcRequestMeta(service, method_name, log_id),
        correlation_id=cid, attachment_size=len(att))
    msg = tpu_std.RpcMessage(meta, payload, att)
    if arrival_ns:
        msg.arrival_ns = arrival_ns
    return msg


def process_request_fast(proto, socket, server, cid: int, service: str,
                         method_name: str, log_id: int, payload: bytes,
                         att: bytes, is_last: bool = True,
                         arrival_ns: int = 0):
    """Dispatch one request record of the turbo lane. None when it was
    handled here (answered, run in place or spawned), or the classic
    ``process_request`` coroutine for the caller to run."""
    if server is None or not _server_turbo_ok(server) or \
            flag("rpcz_enabled"):
        nturbo_fallbacks.add(1)
        return process_request(
            proto, _synth_request_msg(cid, service, method_name, log_id,
                                      payload, att, arrival_ns), socket)
    method = server.find_method(service, method_name)
    if method is None:
        known = service in server.services()
        _send_error(proto, socket, cid,
                    berr.ENOMETHOD if known else berr.ENOSERVICE,
                    f"{service}.{method_name} not found")
        return None
    if not server.is_running:
        _send_error(proto, socket, cid, berr.ELOGOFF, "server is stopping")
        return None
    # the record carries no priority and no token by construction (the
    # scanner defers both): the level is class 0 and the connection's slot
    level = 0
    counted = False
    adm = server._admission
    if adm is not None and adm.threshold_engaged():
        level = _request_level(0, "", socket)
        counted = True
        if not adm.admit_level(level):
            npriority_shed.add(1)
            _send_error(proto, socket, cid, berr.EPRIORITYSHED,
                        "priority below admission threshold "
                        "(server overloaded)")
            return None
    if _queue_delay_shed(server, arrival_ns, level, counted):
        _send_error(proto, socket, cid, berr.ELIMIT,
                    "queue delay over shed budget (server overloaded)")
        return None
    cost = server.on_request_start(method.full_name,
                                   len(payload) + len(att), level, counted)
    if not cost:
        _send_error(proto, socket, cid, berr.ELIMIT,
                    "max_concurrency reached")
        return None
    nturbo_requests.add(1)
    server._request_begin()
    coro = _drive_fast(proto, socket, server, method, cid, log_id, payload,
                       att, arrival_ns, cost)
    if not method.is_coroutine and not is_last:
        # a blocking handler of a burst's earlier request gets a fiber of
        # its own, so it cannot hold the burst behind it
        socket._control.spawn(coro, name=method.full_name)
    else:
        socket._control.run_inline(coro, name=method.full_name)
    return None


async def _drive_fast(proto, socket, server, method, cid: int, log_id: int,
                      payload: bytes, att: bytes, arrival_ns: int,
                      cost: float) -> None:
    """The slim request body: the classic ``_serve`` without what the
    record cannot carry (a deadline, tensors, a span, a codec, a stream,
    auth)."""
    t0 = time.monotonic_ns()
    cntl = Controller()
    cntl.correlation_id = cid
    cntl._server_socket = socket
    cntl.log_id = log_id
    cntl.remote_side = socket.remote_endpoint
    cntl._service_name, _, cntl._method_name = \
        method.full_name.partition(".")
    if att:
        cntl.request_attachment.append(att)
    socket.last_method = method.full_name
    _serving_cntl.set(cntl)
    try:
        rec = _cap.global_recorder()
        cap_rec = None
        try:
            if rec.capture_enabled():
                cap_rec = rec.sample_request(method.full_name, "", "",
                                             payload, att, arrival_ns or t0,
                                             0, log_id, 0)
        except Exception:
            cap_rec = None
        if not method.is_coroutine and current_group() is None:
            await _HopToWorker()
            if _queue_delay_shed(server, arrival_ns):
                # aged behind busy workers past the budget
                server.on_request_end(method.full_name, 0.0, True, cost)
                cntl.set_failed(berr.ELIMIT,
                                "queue delay over shed budget before "
                                "handler entry (server overloaded)")
                _capture_done(rec, cap_rec, cntl, t0)
                _send_response(proto, socket, cntl, b"")
                return
        h0 = time.monotonic_ns()
        try:
            response = method.handler(cntl, payload)
            if inspect.isawaitable(response):
                response = await response
        except Exception as e:          # boundary: report, keep serving
            log.exception("handler %s failed", method.full_name)
            cntl.set_failed(berr.EINTERNAL, f"{type(e).__name__}: {e}")
            response = b""
        server.on_request_end(method.full_name,
                              (time.monotonic_ns() - h0) / 1e3,
                              cntl.failed(), cost)
        _capture_done(rec, cap_rec, cntl, t0)
        _send_response(proto, socket, cntl, response or b"")
    finally:
        _serving_cntl.set(None)
        cntl._drop_cancel_subs()
        server._request_done()


def make_fast_drain(server):
    """The per-event hook of a server with a ``native="echo"`` method
    (``Socket.fast_drain``): one ``serve_drain`` call reads the readable
    fd and echo-serves its front run of frames; the bytes it cannot
    serve go back into the portal for the classic pass. On a chunk conn
    (``mem://``) ``serve_scan`` reads the writer's chunks instead. None
    without the extension."""
    from brpc_tpu_torch.native import fastcore
    from brpc_tpu_torch.transport.socket import nreads, pull_chunks
    fc = fastcore.get()
    sd = getattr(fc, "serve_drain", None) if fc is not None else None
    ss = getattr(fc, "serve_scan", None) if fc is not None else None
    if sd is None or ss is None:
        return None
    magic, max_body = tpu_std.MAGIC, tpu_std.SMALL_FRAME_MAX

    def _defer_streak(sock, served: bool) -> None:
        """A connection that keeps deferring (a tpu_std client that
        never calls the echo method) loses the hook after 16 passes in a
        row; a served frame resets the streak."""
        ud = sock.user_data
        if served:
            ud["_fdrain_defer_streak"] = 0
            return
        streak = ud["_fdrain_defer_streak"] = \
            ud.get("_fdrain_defer_streak", 0) + 1
        if streak >= 16:
            sock.fast_drain = None

    def _served(sock, tgt, out, n, t0) -> None:
        sock.write(out)
        nserve_drain.add(n)
        server.account_native_batch(tgt[2], n,
                                    (time.monotonic_ns() - t0) / 1e3)

    def fast_drain(sock) -> bool:
        tgt = native_echo_target(server)
        if tgt is None or sock.input_portal or sock.input_need:
            return False
        if getattr(sock.conn, "pluck_fd", None) is not None:
            dfd = sock.pin_fd_acquire()
            if dfd < 0:
                return False
            t0 = time.monotonic_ns()
            try:
                r = sd(dfd, magic, tgt[0], tgt[1], max_body)
            finally:
                sock.pin_fd_release()
            if r[-1]:
                nreads.add(r[-1])
            if r[0] == 0:
                _, out, n, leftover, _nr = r
                _served(sock, tgt, out, n, t0)
                _defer_streak(sock, True)
                if leftover:
                    sock.input_portal.append_user_data(leftover)
                    return False
                return True
            if r[0] == 1:
                leftover = r[1]
                if not leftover:
                    return True         # a spurious wake
                if not magic.startswith(leftover[:4]):
                    # at a frame boundary: another protocol (HTTP)
                    sock.fast_drain = None
                else:
                    _defer_streak(sock, False)
                sock.input_portal.append_user_data(leftover)
                return False
            # 2: the end or an error; bytes before it go first, and the
            # classic drain sees the end again
            if r[2]:
                sock.input_portal.append_user_data(r[2])
                return False
            sock.set_failed(ConnectionResetError(r[1]))
            return True
        data, handled = pull_chunks(sock)
        if data is None:
            return handled
        t0 = time.monotonic_ns()
        consumed, out, n = ss(data, magic, tgt[0], tgt[1], max_body)
        if n:
            _served(sock, tgt, out, n, t0)
        if consumed < len(data):
            rest = data[consumed:] if consumed else data
            if not n and not magic.startswith(rest[:4]):
                sock.fast_drain = None
            else:
                _defer_streak(sock, bool(n))
            sock.input_portal.append_user_data(rest)
            return False
        _defer_streak(sock, bool(n))
        return True

    return fast_drain
