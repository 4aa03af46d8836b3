"""Server: tpu_std and HTTP/1.1 on one TCP port (the port of
brpc_tpu/rpc/server.py).

The listener is a consumer of the process's event dispatcher, and so is
every accepted connection: ``_on_new_conn`` wraps it in a ``Socket`` whose
input goes to an ``InputMessenger`` (brpc_tpu/rpc/server.py:475). No
thread is started per connection. The messenger tries the registered
protocols on each connection's bytes (tpu_std, then HTTP), and an
unparsable prefix drops the connection.

Handlers run as fibers of the server's TaskControl (``Server(control=)``,
by default the process's ``global_control()``), as brpc_tpu's do without
``usercode_in_pthread``. The last request of a read is processed in place
on the dispatcher thread until its handler first suspends, and a handler
that is not a coroutine function hops to a worker before it runs
(``server_dispatch.py``); earlier requests of a burst get fibers of their
own. The same workers run the serving engine's decode steps
(``serving/engine.py``), so a handler must await, never block, what it
waits for.

tpu_std: requests go to ``server_dispatch.process_request``; a bare
stream frame goes to its stream in parse order
(brpc_tpu/protocol/tpu_std.py:676-683), and the stream hands DATA frames
to its own delivery queue.

HTTP: ``POST /<Service>/<Method>`` calls the registered method with the
request body (brpc_tpu/protocol/http.py:902-980). A failed call answers
400 for ``EREQUEST`` and 500 otherwise, with the body ``[code] text``; an
unknown method answers 404. A handler that created a progressive
attachment answers with a chunked body that its feeder writes after the
handler returned. Requests on one connection are answered in order, one
at a time, by the connection's own drain fiber
(``input_messenger.process_in_parse_order``): a chunked response holds
the drain (parked, not blocking a worker) until its terminator is out.

``start`` and ``stop`` call ``server._serving.on_server_start/stop``
(brpc_tpu/rpc/server.py:430,518): that is how the serving lane builds
and drains its engine with the server's lifecycle.

Observability (``ServerOptions(enable_builtin_services=True)``, the
default): ``start`` registers the ``builtin`` service and exposes the
process, scheduler, dispatcher and serving bvars; the HTTP path answers
the builtin pages (``/status``, ``/vars``, ``/rpcz``, ... in
``protocol/http.py``) before method dispatch. Every call lands in its
method's ``LatencyRecorder`` (``method_status``). Under the
``rpcz_enabled`` flag a tpu_std call gets a server span, stamped in
``server_dispatch.py``; an HTTP call gets none, as in the reference.
"""

from __future__ import annotations

import inspect
import logging
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

from brpc_tpu_torch.butil.endpoint import EndPoint, str2endpoint
from brpc_tpu_torch.bvar.latency_recorder import LatencyRecorder
from brpc_tpu_torch.bvar.reducer import PassiveStatus
from brpc_tpu_torch.fiber import TaskControl, global_control
from brpc_tpu_torch.protocol import http
from brpc_tpu_torch.transport.base import Conn, get_transport
from brpc_tpu_torch.transport.event_dispatcher import expose_stall_vars
from brpc_tpu_torch.transport.input_messenger import InputMessenger
from brpc_tpu_torch.transport.socket import Socket

from . import errno_codes as berr
from . import server_dispatch
from .controller import Controller
from .progressive import ProgressiveAttachment
from .service import Method, Service

log = logging.getLogger("brpc_tpu_torch.rpc")


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
        self._messenger: Optional[InputMessenger] = None
        self.endpoint: Optional[EndPoint] = None
        self._running = False           # started: takes calls
        self._serving = None            # GenerateService handle (serving/)
        self._idle = threading.Condition()
        self._inflight = 0              # calls not yet answered
        self._sockets_lock = threading.Lock()
        self._sockets: set = set()      # accepted sockets not yet failed
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

    def find_method(self, service: str, method: str) -> Optional[Method]:
        return self._methods.get((service, method))

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
        ep = str2endpoint(address)
        transport = get_transport(ep.scheme)
        if self.options.enable_builtin_services:
            from brpc_tpu_torch.builtin.services import add_builtin_services
            from brpc_tpu_torch.bvar.default_variables import (
                expose_default_variables)
            add_builtin_services(self)
            expose_default_variables()
            expose_stall_vars()
            self.control.expose_vars()
            self._expose_vars()
            # the device lanes' cells and the ici_* counters: a restart
            # after a test's unexpose_all must not drop them from /vars
            from brpc_tpu_torch.transport.device_stats import (
                expose_device_vars)
            expose_device_vars()
            import sys
            ici = sys.modules.get("brpc_tpu_torch.transport.ici")
            if ici is not None:
                ici.expose_ici_vars()
        self._messenger = InputMessenger(control=self.control)
        self._running = True
        try:
            if self._serving is not None:
                self._serving.on_server_start(self)
            self._listener = transport.listen(ep, self._on_new_conn)
        except BaseException:
            self._running = False
            if self._serving is not None:
                self._serving.on_server_stop(self)
            raise
        self.endpoint = self._listener.endpoint
        return self.endpoint

    def _on_new_conn(self, conn: Conn) -> None:
        """On the dispatcher thread, which also raises the new socket's
        first input event: ``user_data`` is set before any byte is read."""
        s = Socket(conn, on_input=self._messenger.on_new_messages,
                   control=self.control)
        s.user_data["server"] = self
        with self._sockets_lock:
            self._sockets.add(s)
        s.on_failed(self._forget)

    def _forget(self, s: Socket) -> None:
        with self._sockets_lock:
            self._sockets.discard(s)

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
        server_dispatch.nshed.expose("server_deadline_shed")

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

    # ----------------------------------------------------------------- HTTP
    async def _serve_http(self, socket: Socket,
                          req: http.HttpRequest) -> None:
        """One request, on the connection's drain fiber, in order."""
        if socket.failed:
            return
        status, ctype, body = await self._call_http(socket, req)
        if isinstance(body, ProgressiveAttachment):
            if not socket.write(http.chunked_head(body.content_type,
                                                  req.keep_alive)):
                body._on_conn_failed(socket)  # the feeder sees False
                return
            body._bind(socket)
            # the next request on this connection waits for the whole
            # body: its response must not land inside the chunked stream
            await body.wait_finished()
        elif not socket.write(http.response(status, body, ctype,
                                            req.keep_alive)):
            return
        if not req.keep_alive:
            # close once every byte queued so far is out
            socket.write(b"", on_done=lambda err: socket.set_failed(
                ConnectionError("closed after the response")))

    async def _call_http(self, socket: Socket, req: http.HttpRequest
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
        cntl.remote_side = socket.remote_endpoint
        self._request_begin()
        t0 = time.monotonic_ns()
        failed = True
        # nested calls in the handler read the serving controller
        server_dispatch._serving_cntl.set(cntl)
        try:
            response = method.handler(cntl, req.body)
            if inspect.isawaitable(response):
                response = await response
            failed = cntl.failed()
        except Exception as e:          # boundary: report, keep serving
            log.exception("handler %s failed", method.full_name)
            return 500, "text/plain", f"handler error: {e}".encode()
        finally:
            server_dispatch._serving_cntl.set(None)
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
    def connections(self) -> List[Socket]:
        """The accepted connections still open."""
        with self._sockets_lock:
            return [s for s in self._sockets if not s.failed]

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
        """Wait up to ``timeout_s`` for in-flight calls, then close the
        connections."""
        with self._idle:
            self._idle.wait_for(lambda: not self._inflight, timeout_s)
        with self._sockets_lock:
            socks = list(self._sockets)
        for s in socks:
            s.set_failed(ConnectionError("server stopped"))
