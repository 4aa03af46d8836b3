"""Server: tpu_std and HTTP/1.1 on one TCP port, handlers on fibers.

Every accepted connection picks its protocol from its first bytes
(``transport/tcp.py``).

Handlers run as fibers of the server's TaskControl (``Server(control=)``,
by default the process's ``global_control()``), as brpc_tpu's do without
``usercode_in_pthread``: a coroutine handler is awaited, so a unary
Generate parks its fiber until its sequence retires and the worker goes
on; a plain handler runs on the worker. The same workers run the serving
engine's decode steps (``serving/engine.py``), so a handler must await,
never block, what it waits for.

tpu_std: a connection's reader thread parses each frame and spawns a
request's handler as a fiber, so a handler never stalls the connection
(the reference's process-in-place reading is a later slice). A bare stream
frame goes to its stream on the reader thread itself, in parse order
(brpc_tpu/protocol/tpu_std.py:676-683); the stream hands DATA frames to
its own delivery queue. Responses are framed as brpc_tpu frames them: a
success carries only the correlation id in its meta (the reference's
small-call fast path); a failure, or the answer to a call whose stream
the handler accepted, carries the full meta (``response``, and
``stream_settings`` with the accepted stream's id).

HTTP: ``POST /<Service>/<Method>`` calls the registered method with the
request body (brpc_tpu/protocol/http.py:902-980). A failed call answers
400 for ``EREQUEST`` and 500 otherwise, with the body ``[code] text``;
an unknown method answers 404. A handler that created a progressive
attachment answers with a chunked body that its feeder writes after the
handler returned. Requests on one connection are answered in order, one
at a time, by the connection's own fiber ExecutionQueue: a chunked
response holds the queue's drainer (parked, not blocking a worker)
until its terminator is out.

``start`` and ``stop`` call ``server._serving.on_server_start/stop``
(brpc_tpu/rpc/server.py:430,518): that is how the serving lane builds
and drains its engine with the server's lifecycle.

Observability (``ServerOptions(enable_builtin_services=True)``, the
default): ``start`` registers the ``builtin`` service and exposes the
process, scheduler and serving bvars; the HTTP path answers the builtin
pages (``/status``, ``/vars``, ``/rpcz``, ... in ``protocol/http.py``)
before method dispatch. Every call lands in its method's
``LatencyRecorder`` (``method_status``). Under the ``rpcz_enabled``
flag a tpu_std call gets a server span, stamped where the reference's
dispatch stamps it (brpc_tpu/rpc/server_dispatch.py:300-317, :473,
:490): ``received_us`` at the frame's arrival, ``dispatch_us`` when the
handler fiber is entered, ``handler_start_us``/``handler_end_us``
around the handler, ``serialized_us`` when the response is packed and
``flushed_us`` once the connection has handed the frame to the socket.
An HTTP call gets no server span, as in the reference.
"""

from __future__ import annotations

import inspect
import logging
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

from brpc_tpu_torch.butil.flags import flag
from brpc_tpu_torch.bvar.latency_recorder import LatencyRecorder
from brpc_tpu_torch.bvar.reducer import PassiveStatus
from brpc_tpu_torch.fiber import (ExecutionQueue, TaskControl,
                                  global_control, sleep)
from brpc_tpu_torch.protocol import http, tpu_std
from brpc_tpu_torch.transport.tcp import Connection, Listener

from . import errno_codes as berr
from . import span as _span
from .controller import Controller
from .progressive import ProgressiveAttachment
from .service import Method, Service
from .stream import process_stream_frame

log = logging.getLogger("brpc_tpu_torch.rpc")


# a response frame the socket did not take at once is watched at this
# period until the connection's write queue drains
_FLUSH_POLL_S = 0.0002


@dataclass(frozen=True)
class EndPoint:
    host: str
    port: int

    def __str__(self) -> str:
        return f"tcp://{self.host}:{self.port}"


@dataclass
class ServerOptions:
    """The options of brpc_tpu/rpc/server.py:121 that the port has."""
    # the builtin service and pages (/status, /vars, /rpcz, ...)
    enable_builtin_services: bool = True


class Server:
    def __init__(self, options: Optional[ServerOptions] = None,
                 control: Optional[TaskControl] = None):
        self.options = options or ServerOptions()
        self.control = control or global_control()
        self._services: Dict[str, Service] = {}
        self._methods: Dict[tuple, Method] = {}
        self._listener = None
        self.endpoint: Optional[EndPoint] = None
        self._running = False           # started: takes calls
        self._serving = None            # GenerateService handle (serving/)
        self._idle = threading.Condition()
        self._inflight = 0              # calls not yet answered
        # "Service.Method" -> LatencyRecorder of its handler times
        self.method_status: Dict[str, LatencyRecorder] = {}
        self.nprocessed = 0
        self.nerror = 0

    def add_service(self, service: Service) -> None:
        if self._running:
            raise RuntimeError("add_service after start")
        self._services[service.name] = service
        for name, m in service.methods.items():
            m.full_name = f"{service.name}.{name}"
            self._methods[(service.name, name)] = m

    def services(self) -> Dict[str, Service]:
        return dict(self._services)

    @property
    def is_running(self) -> bool:
        return self._running

    @property
    def concurrency(self) -> int:
        """Calls not yet answered."""
        return self._inflight

    def start(self, address: str) -> EndPoint:
        """Listen on ``tcp://host:port`` (port 0 picks a free port)."""
        if self._running:
            raise RuntimeError("server already started")
        if self.options.enable_builtin_services:
            from brpc_tpu_torch.builtin.services import add_builtin_services
            from brpc_tpu_torch.bvar.default_variables import (
                expose_default_variables)
            add_builtin_services(self)
            expose_default_variables()
            self.control.expose_vars()
            self._expose_vars()
        self._running = True
        try:
            if self._serving is not None:
                self._serving.on_server_start(self)
            self._listener = Listener(address, self._on_frame,
                                      self._on_http).start()
        except BaseException:
            self._running = False
            if self._serving is not None:
                self._serving.on_server_stop(self)
            raise
        self.endpoint = EndPoint(self._listener.host, self._listener.port)
        return self.endpoint

    def _expose_vars(self) -> None:
        """``server_processed``, ``server_errors`` and the worst method
        p99 (brpc_tpu/rpc/server.py:390-413), bound weakly: the registry
        outlives a server and must not pin a stopped one."""
        wref = weakref.ref(self)

        def read(fn, default=0):
            s = wref()
            return fn(s) if s is not None else default

        def worst_p99(s):
            return round(max([lr.latency_percentile(0.99)
                              for lr in list(s.method_status.values())]
                             or [0.0]), 1)

        PassiveStatus(lambda: read(lambda s: s.nprocessed)).expose(
            "server_processed")
        PassiveStatus(lambda: read(lambda s: s.nerror)).expose(
            "server_errors")
        PassiveStatus(lambda: read(worst_p99, 0.0)).expose(
            "server_latency_p99_us")

    # ----------------------------------------------------------- accounting
    def _request_begin(self) -> None:
        with self._idle:
            self._inflight += 1

    def _request_end(self, method_key: str, latency_us: float,
                     failed: bool) -> None:
        """A handler's end (brpc_tpu/rpc/server.py:654): the counters and
        its method's LatencyRecorder."""
        with self._idle:
            self.nprocessed += 1
            if failed:
                self.nerror += 1
            lr = self.method_status.get(method_key)
            if lr is None:
                lr = self.method_status[method_key] = LatencyRecorder()
        lr.record(latency_us)

    def _request_done(self) -> None:
        """A call answered: ``join`` waits for the last one."""
        with self._idle:
            self._inflight -= 1
            if not self._inflight:
                self._idle.notify_all()

    # ------------------------------------------------------------ dispatch
    def _on_frame(self, conn: Connection, meta: tpu_std.RpcMeta,
                  payload: bytes, attachment: bytes) -> None:
        if meta.is_stream_frame():
            process_stream_frame(meta, payload, attachment)
            return
        req = meta.request
        if req is None:
            return                      # not a request: ignore
        arrival_ns = time.monotonic_ns()
        cntl = Controller()
        cntl.correlation_id = meta.correlation_id
        cntl._server_socket = conn
        cntl.trace_id = meta.trace_id
        cntl.span_id = meta.span_id
        cntl.log_id = req.log_id
        cntl.remote_side = EndPoint(*conn.peer[:2])
        if meta.stream_settings is not None:
            cntl._peer_stream_id = meta.stream_settings.stream_id
        cntl.set_deadline(req.timeout_ms, arrival_ns)
        method = self._methods.get((req.service_name, req.method_name))
        if method is None:
            known = any(s == req.service_name for s, _ in self._methods)
            cntl.set_failed(berr.ENOMETHOD if known else berr.ENOSERVICE,
                            f"{req.service_name}.{req.method_name} "
                            "not found")
            self._respond(conn, cntl, b"")
            return
        if not self._running:
            cntl.set_failed(berr.ELOGOFF, "server is stopping")
            self._respond(conn, cntl, b"")
            return
        span = None
        if flag("rpcz_enabled"):
            span = _span.start_server_span(cntl, req.service_name,
                                           req.method_name)
            span.request_size = len(payload) + len(attachment)
            # the timeline's base is the frame's arrival, so latency_us
            # is the whole server residence and received -> dispatch is
            # the wait for a fiber worker
            span.received_us = span.start_us = arrival_ns // 1000
        self._request_begin()
        self.control.spawn(self._run, conn, method, cntl, payload, span,
                           name=method.full_name)

    async def _run(self, conn: Connection, method: Method,
                   cntl: Controller, payload: bytes, span) -> None:
        t0 = time.monotonic_ns()
        if span is not None:
            # the payload is the request's bytes: nothing to parse
            span.dispatch_us = span.parse_done_us = t0 // 1000
        try:
            try:
                if span is not None:
                    span.handler_start_us = time.monotonic_ns() // 1000
                response = await _call(method, cntl, payload)
            except Exception as e:      # boundary: report, keep serving
                log.exception("handler %s failed", method.full_name)
                cntl.set_failed(berr.EINTERNAL, f"{type(e).__name__}: {e}")
                response = b""
            finally:
                if span is not None:
                    span.handler_end_us = time.monotonic_ns() // 1000
                self._request_end(method.full_name,
                                  (time.monotonic_ns() - t0) / 1e3,
                                  cntl.failed())
            self._respond(conn, cntl, response or b"", span)
        finally:
            self._request_done()
            if span is not None:
                # with the flush latch armed, the span is submitted once
                # the frame is on the socket (mark_flushed)
                _span.finish_span(span, cntl)

    def _respond(self, conn: Connection, cntl: Controller, response: bytes,
                 span=None) -> None:
        accepted = cntl._accepted_stream
        if cntl.failed() or accepted is not None:
            meta = tpu_std.RpcMeta(
                response=tpu_std.RpcResponseMeta(cntl.error_code,
                                                 cntl.error_text),
                correlation_id=cntl.correlation_id)
            if accepted is not None:
                meta.stream_settings = tpu_std.StreamSettings(
                    stream_id=accepted.id)
            frame = tpu_std.pack_frame(
                meta, b"" if cntl.failed() else bytes(response))
        else:
            frame = tpu_std.pack_small_frame(
                b"", cntl.correlation_id, bytes(response))
        if span is not None:
            span.response_size = 0 if cntl.failed() else len(response)
            span.serialized_us = time.monotonic_ns() // 1000
            _span.expect_flush(span)
        try:
            conn.send(frame)
        except OSError as e:            # client gone: nothing to tell it
            log.debug("response to %s dropped: %s", conn.peer, e)
            if span is not None:
                _span.mark_flushed(span, e)
            return
        if span is None:
            return
        if not conn.write_backlog():
            # the socket took the frame (and all before it) in the send
            _span.mark_flushed(span)
        else:
            self.control.spawn(_flushed_when_drained, conn, span,
                               name="rpcz-flush")

    # ----------------------------------------------------------------- HTTP
    def _on_http(self, conn: Connection, req: http.HttpRequest) -> None:
        """On the reader thread: queue the request behind the ones before
        it on this connection, so the reader goes on reading."""
        q = conn.user_data.get("http_queue")
        if q is None:
            async def serve(batch):
                for r in batch:
                    await self._serve_http(conn, r)
            q = ExecutionQueue(serve, control=self.control,
                               name="http-conn")
            conn.user_data["http_queue"] = q
        q.execute(req)

    async def _serve_http(self, conn: Connection,
                          req: http.HttpRequest) -> None:
        if conn.closed:
            return
        status, ctype, body = await self._call_http(conn, req)
        try:
            if isinstance(body, ProgressiveAttachment):
                conn.send(http.chunked_head(body.content_type,
                                            req.keep_alive))
            else:
                conn.send(http.response(status, body, ctype,
                                        req.keep_alive))
        except OSError:
            if isinstance(body, ProgressiveAttachment):
                body._on_conn_failed(conn)  # the feeder sees write() False
            return
        if isinstance(body, ProgressiveAttachment):
            body._bind(conn)
            # the next request on this connection waits for the whole
            # body: its response must not land inside the chunked stream
            await body.wait_finished()
        if not req.keep_alive:
            conn.close_after_flush()

    async def _call_http(self, conn: Connection, req: http.HttpRequest
                         ) -> Tuple[int, str,
                                    Union[bytes, ProgressiveAttachment]]:
        if self.options.enable_builtin_services:
            page = http.builtin_page(self, req)
            if page is not None:
                return page
        parts = [p for p in req.path.split("/") if p]
        if len(parts) != 2:
            return 404, "text/plain", f"no such page {req.path}".encode()
        method = self._methods.get((parts[0], parts[1]))
        if method is None:
            return 404, "text/plain", b"no such service/method"
        cntl = Controller()             # _server_socket None: HTTP
        cntl.remote_side = EndPoint(*conn.peer[:2])
        self._request_begin()
        t0 = time.monotonic_ns()
        failed = True
        try:
            response = await _call(method, cntl, req.body)
            failed = cntl.failed()
        except Exception as e:          # boundary: report, keep serving
            log.exception("handler %s failed", method.full_name)
            return 500, "text/plain", f"handler error: {e}".encode()
        finally:
            self._request_end(method.full_name,
                              (time.monotonic_ns() - t0) / 1e3, failed)
            self._request_done()
        if cntl.failed():
            status = 400 if cntl.error_code == berr.EREQUEST else 500
            return (status, "text/plain",
                    f"[{cntl.error_code}] {cntl.error_text}".encode())
        if cntl._progressive is not None:
            return 200, cntl._progressive.content_type, cntl._progressive
        if response is None:
            return 200, "application/json", b"{}"
        return 200, "application/octet-stream", bytes(response)

    # ----------------------------------------------------------- lifecycle
    def connections(self) -> List[Connection]:
        """The accepted connections still open."""
        return self._listener.connections() if self._listener else []

    def stop(self) -> None:
        """Stop accepting and retire in-flight generations; their calls
        fail with the serving lane's verdict."""
        if not self._running:
            return
        self._running = False
        self._listener.stop()
        if self._serving is not None:
            self._serving.on_server_stop(self)

    def join(self, timeout_s: float = 5.0) -> None:
        """Wait up to ``timeout_s`` for in-flight handler fibers, then
        close the connections."""
        with self._idle:
            self._idle.wait_for(lambda: not self._inflight, timeout_s)
        if self._listener is not None:
            self._listener.close_connections()


async def _flushed_when_drained(conn: Connection, span) -> None:
    """Stamp ``flushed_us`` once the connection's writer has handed
    every queued byte to the socket: the response frame is among them,
    so this is an upper bound on its flush time. ``Connection.send``
    offers no completion callback, so the queue is watched."""
    while conn.write_backlog() and not conn.closed:
        await sleep(_FLUSH_POLL_S)
    _span.mark_flushed(
        span, ConnectionError("connection closed") if conn.closed else None)


async def _call(method: Method, cntl: Controller, request):
    """Run a handler on the current fiber: a coroutine result is awaited,
    a plain one returned."""
    response = method.handler(cntl, request)
    if inspect.isawaitable(response):
        response = await response
    return response
