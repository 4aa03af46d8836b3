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
"""

from __future__ import annotations

import inspect
import logging
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

from brpc_tpu_torch.fiber import ExecutionQueue, TaskControl, global_control
from brpc_tpu_torch.protocol import http, tpu_std
from brpc_tpu_torch.transport.tcp import Connection, Listener

from . import errno_codes as berr
from .controller import Controller
from .progressive import ProgressiveAttachment
from .service import Method, Service
from .stream import process_stream_frame

log = logging.getLogger("brpc_tpu_torch.rpc")


@dataclass(frozen=True)
class EndPoint:
    host: str
    port: int

    def __str__(self) -> str:
        return f"tcp://{self.host}:{self.port}"


class Server:
    def __init__(self, control: Optional[TaskControl] = None):
        self.control = control or global_control()
        self._methods: Dict[tuple, Method] = {}
        self._listener = None
        self._running = False           # started: takes calls
        self._serving = None            # GenerateService handle (serving/)
        self._idle = threading.Condition()
        self._inflight = 0              # handler fibers not yet answered

    def add_service(self, service: Service) -> None:
        if self._running:
            raise RuntimeError("add_service after start")
        for name, m in service.methods.items():
            m.full_name = f"{service.name}.{name}"
            self._methods[(service.name, name)] = m

    def start(self, address: str) -> EndPoint:
        """Listen on ``tcp://host:port`` (port 0 picks a free port)."""
        if self._running:
            raise RuntimeError("server already started")
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
        return EndPoint(self._listener.host, self._listener.port)

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
        with self._idle:
            self._inflight += 1
        self.control.spawn(self._run, conn, method, cntl, payload,
                           name=method.full_name)

    async def _run(self, conn: Connection, method: Method,
                   cntl: Controller, payload: bytes) -> None:
        try:
            try:
                response = await _call(method, cntl, payload)
            except Exception as e:      # boundary: report, keep serving
                log.exception("handler %s failed", method.full_name)
                cntl.set_failed(berr.EINTERNAL, f"{type(e).__name__}: {e}")
                response = b""
            self._respond(conn, cntl, response or b"")
        finally:
            with self._idle:
                self._inflight -= 1
                if not self._inflight:
                    self._idle.notify_all()

    @staticmethod
    def _respond(conn: Connection, cntl: Controller, response: bytes) -> None:
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
        try:
            conn.send(frame)
        except OSError as e:            # client gone: nothing to tell it
            log.debug("response to %s dropped: %s", conn.peer, e)

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
        status, ctype, body = await self._call_http(req)
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

    async def _call_http(self, req: http.HttpRequest
                         ) -> Tuple[int, str,
                                    Union[bytes, ProgressiveAttachment]]:
        parts = [p for p in req.path.split("/") if p]
        if len(parts) != 2:
            return 404, "text/plain", f"no such page {req.path}".encode()
        method = self._methods.get((parts[0], parts[1]))
        if method is None:
            return 404, "text/plain", b"no such service/method"
        cntl = Controller()             # _server_socket None: HTTP
        try:
            response = await _call(method, cntl, req.body)
        except Exception as e:          # boundary: report, keep serving
            log.exception("handler %s failed", method.full_name)
            return 500, "text/plain", f"handler error: {e}".encode()
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


async def _call(method: Method, cntl: Controller, request):
    """Run a handler on the current fiber: a coroutine result is awaited,
    a plain one returned."""
    response = method.handler(cntl, request)
    if inspect.isawaitable(response):
        response = await response
    return response
