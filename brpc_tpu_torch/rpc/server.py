"""Server: tpu_std, HTTP/1.1 and HTTP/2 with gRPC on one TCP port (the
port of brpc_tpu/rpc/server.py).

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

HTTP/2 and gRPC (``protocol/h2.py``): a connection that opens with the
h2 preface gets a session; its gRPC calls find their method with the
package-qualified fallback of ``find_method``, pass the same auth gate
as HTTP (``_auth_refused``), the limiters and ``on_request_end`` (their
method's row on ``/status``), and count as calls in flight for
``join``; its plain requests go through ``_call_http`` with ``unary``.

``start`` and ``stop`` call ``server._serving.on_server_start/stop``
(brpc_tpu/rpc/server.py:430,518): that is how the serving lane builds
and drains its engine with the server's lifecycle.

Observability (``ServerOptions(enable_builtin_services=True)``, the
default): ``start`` registers the ``builtin`` service and exposes the
process, scheduler, dispatcher and serving bvars; the HTTP path answers
the builtin pages (``/status``, ``/vars``, ``/rpcz``, ... in
``protocol/http.py``) before method dispatch. Every ``start`` also
holds the flight recorder's sampler (``builtin/flight_recorder.py``),
which the last running server's ``stop`` ends, hands itself to the
incident manager, and makes sure the trend rings tick
(``bvar/series.ensure_series``). Every call lands in its
method's ``LatencyRecorder`` (``method_status``). Under the
``rpcz_enabled`` flag a tpu_std call gets a server span, stamped in
``server_dispatch.py``; an HTTP call gets none, as in the reference.

Shard groups (brpc_tpu/rpc/server.py:293-316): ``start(address,
num_shards=N)`` with N > 1 on tcp makes this process the supervisor of N
forked shards behind one SO_REUSEPORT port (``rpc/shard_group.py``):
it serves no traffic itself, and ``stop``/``join`` drain the group.
Each shard re-arms its copy of this Server (``_postfork_child_reset``)
and starts it; ``shard_index`` is its index there, and the admin server
of the supervisor has the ``shard_aggregator`` the merged pages read.
``run_until_asked_to_quit`` blocks until SIGINT or SIGTERM with a
pidfile under ``.pids/`` and an orphan watchdog.

The native core (brpc_tpu/rpc/server.py:474-495): a server with a
``native="echo"`` method gives each new connection the per-event hook
of ``server_dispatch.make_fast_drain`` (fastcore's ``serve_drain``), and
``account_native_batch`` counts what the C echo loops served.
``start`` exposes the syscall counters (``transport/syscall_stats.py``).
A ring-attached connection (``transport/ring_lane.py``) gets no
``serve_drain`` hook: the ring's tick is its fd's only reader, and a
loop reading the fd would serve bytes that came after the chunks the
ring queued (brpc_tpu/rpc/server.py:483-494); the portal-based echo
loop still serves it.
"""

from __future__ import annotations

import inspect
import logging
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

from brpc_tpu_torch.butil.endpoint import EndPoint, str2endpoint
from brpc_tpu_torch.butil.flags import define_flag, flag
from brpc_tpu_torch.bvar.latency_recorder import LatencyRecorder
from brpc_tpu_torch.bvar.reducer import Adder, PassiveStatus
from brpc_tpu_torch.bvar.series import declare_series_kind
from brpc_tpu_torch.fiber import TaskControl, global_control
from brpc_tpu_torch.protocol import http
from brpc_tpu_torch.transport.base import Conn, get_transport
from brpc_tpu_torch.transport.event_dispatcher import expose_stall_vars
from brpc_tpu_torch.transport.input_messenger import InputMessenger
from brpc_tpu_torch.transport.socket import Socket

from . import errno_codes as berr
from . import server_dispatch
from .admission import AdmissionController, CostModel, admission_enabled
from .auth import AuthError, InterceptorError, resolve_server_auth
from .concurrency_limiter import new_limiter
from .controller import Controller
from .data_pool import SimpleDataPool
from .progressive import ProgressiveAttachment
from .service import Method, Service

log = logging.getLogger("brpc_tpu_torch.rpc")

# requests the auth gate of the HTTP, gRPC and thrift paths refused
nauth_refused = Adder()

define_flag("server_queue_shed_ms", 200.0,
            "queue-delay shed budget: a request whose arrival-to-"
            "dispatch time exceeds this is rejected with ELIMIT before "
            "the handler runs (default gate for adaptive-limiter "
            "servers; ServerOptions.queue_delay_shed_ms overrides "
            "per server)", validator=lambda v: v > 0)


@dataclass
class ServerOptions:
    """The options of brpc_tpu/rpc/server.py:112-190 that the port has.

    ``max_concurrency``: the server's limit of requests in flight, an
    int or a spec, ``constant:N``, ``auto[:initial[:min[:max]]]`` or
    ``timeout:MS`` (``rpc/concurrency_limiter.py``); a request over it is
    shed with ELIMIT before its handler. ``method_max_concurrency``:
    ``{"Service.Method": spec}``, checked after the server's.
    ``queue_delay_shed_ms``: a request that waited longer than this
    from its arrival to its dispatch is shed with ELIMIT (None: on at
    the ``server_queue_shed_ms`` flag's value when ``max_concurrency``
    is a spec string, else off). ``request_costs``: weighted slots
    (``admission.CostModel``). ``priority_admission``: shed by the
    DAGOR threshold with EPRIORITYSHED while overloaded, the threshold
    on every response (None: on whenever a limiter or the queue gate
    is). ``health_reporter``: ``callable(server)`` answering ``/health``
    with bytes, a str, or (status, content type, body).
    ``auth``: an ``Authenticator`` (``rpc/auth.py``) that verifies each
    connection's first request, tpu_std and HTTP alike (``/health``
    excepted); ``auth_token``: a shared token, short for a
    ``TokenAuthenticator``. ``interceptor``: ``callable(cntl)`` run on
    every decoded request before its handler, returning None to accept
    or ``(error_code, reason)`` to reject. ``session_local_data_factory``
    (and ``session_local_data_reset``): each request borrows an object of
    a ``SimpleDataPool`` (``cntl.session_local_data()``).
    ``usercode_in_pthread``: handlers that are not coroutine functions
    run on the usercode pool (``rpc/usercode.py``), not on the fiber
    workers. ``enable_builtin_services``: the builtin service and pages
    (/status, /vars, /rpcz, ...). ``thrift_service``: a
    ``protocol.thrift.ThriftService`` answering framed thrift on the
    server's port (refused on a server with ``auth`` or ``auth_token``:
    thrift carries no credential); ``redis_service``: a
    ``protocol.redis.RedisService`` answering RESP there.
    ``nshead_service``: the nshead handler, raw or an adaptor of
    ``protocol/nshead_pbrpc.py`` (nova_pbrpc, public_pbrpc, ubrpc) or
    ``protocol/mcpack.py`` (nshead+mcpack) over a Service;
    ``esp_service``: the esp handler; both are refused on a server with
    ``auth`` or ``auth_token``, since neither carries a credential.
    ``mongo_service_adaptor``: a ``protocol.mongo.MongoServiceAdaptor``,
    whose commands do their own authentication. ``rtmp_service``: a
    ``protocol.rtmp.RtmpService``, the live relay answering RTMP on the
    server's port (only a server with one claims a 0x03 first byte); its
    ``on_publish`` and ``on_play`` hooks gate it, not ``auth``, as in
    the reference. ``stop`` drops the relay's publishers and players of
    this server's connections."""
    max_concurrency: Any = None
    method_max_concurrency: Optional[Dict[str, Any]] = None
    queue_delay_shed_ms: Optional[float] = None
    request_costs: Optional[bool] = None
    priority_admission: Optional[bool] = None
    health_reporter: Optional[Callable] = None
    auth: Optional[Any] = None
    auth_token: Optional[str] = None
    interceptor: Optional[Callable] = None
    session_local_data_factory: Optional[Callable[[], Any]] = None
    session_local_data_reset: Optional[Callable[[Any], None]] = None
    usercode_in_pthread: bool = False
    enable_builtin_services: bool = True
    thrift_service: Optional[Any] = None
    redis_service: Optional[Any] = None
    nshead_service: Optional[Callable] = None
    esp_service: Optional[Callable] = None
    mongo_service_adaptor: Optional[Any] = None
    rtmp_service: Optional[Any] = None


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
        # (service, method, "Service.Method") bytes of the first
        # native="echo" method, and its per-event hook (False: none)
        self._native_echo: Optional[Tuple[bytes, bytes, str]] = None
        self._fast_drain_hook = None
        self._shard_group = None        # the supervisor's (num_shards > 1)
        self.shard_index: Optional[int] = None      # set in a shard
        self.shard_aggregator = None    # set on a supervisor's admin server
        self._build_limiters()
        # resolved once, as the reference does at Server::Start
        self._auth = resolve_server_auth(self.options)
        self.session_local_pool = None
        if self.options.session_local_data_factory is not None:
            self.session_local_pool = SimpleDataPool(
                self.options.session_local_data_factory,
                reset=self.options.session_local_data_reset)

    def _build_limiters(self) -> None:
        """The overload gates the options name
        (brpc_tpu/rpc/server.py:224)."""
        o = self.options
        self._limiter = new_limiter(o.max_concurrency)
        self._method_limiters = {
            k: new_limiter(v)
            for k, v in (o.method_max_concurrency or {}).items()}
        qd = o.queue_delay_shed_ms
        if qd is None and isinstance(o.max_concurrency, str):
            # an adaptive server gets the queue gate by default: a
            # saturated node must reject in microseconds, not let queued
            # work time out in seconds
            qd = flag("server_queue_shed_ms")
        self._queue_shed_ns = int(qd * 1e6) if qd else 0
        # admission is on where an overload gate exists to signal it;
        # inert until overload, and never sheds traffic of one priority
        want_adm = o.priority_admission
        if want_adm is None:
            want_adm = (self._limiter is not None
                        or bool(self._method_limiters)
                        or self._queue_shed_ns > 0)
        self._admission = AdmissionController() \
            if (want_adm and admission_enabled()) else None
        self._cost_model = CostModel(self) if o.request_costs else None

    def concurrency_limit(self) -> Optional[int]:
        """The server limiter's current limit (None: no limit)."""
        lim = self._limiter
        return lim.max_concurrency if lim is not None else None

    def add_service(self, service: Service) -> None:
        if self._running:
            raise RuntimeError("add_service after start")
        self._services[service.name] = service
        for name, m in service.methods.items():
            m.full_name = f"{service.name}.{name}"
            self._methods[(service.name, name)] = m
            if m.native_kind == "echo" and self._native_echo is None:
                self._native_echo = (service.name.encode(), name.encode(),
                                     m.full_name)

    def services(self) -> Dict[str, Service]:
        return dict(self._services)

    def find_method(self, service: str, method: str,
                    package_qualified: bool = False) -> Optional[Method]:
        """The method registered as ``service.method``; with
        ``package_qualified`` (gRPC's paths name ``package.Service``),
        ``service``'s last dotted part when the whole name is not
        registered (brpc_tpu/protocol/h2.py:602-605)."""
        m = self._methods.get((service, method))
        if m is None and package_qualified and "." in service:
            m = self._methods.get((service.rsplit(".", 1)[1], method))
        return m

    @property
    def is_running(self) -> bool:
        return self._running

    @property
    def concurrency(self) -> int:
        """Calls admitted and not yet answered."""
        return self._inflight

    def start(self, address: Union[str, EndPoint],
              num_shards: Optional[int] = None,
              shard_options=None) -> EndPoint:
        """Listen on ``tcp://host:port`` (port 0 picks a free port).
        ``num_shards=N``, N > 1 and tcp only, makes this process the
        supervisor of a shard group (``rpc/shard_group.py``): N forked
        shards serve the port, and this process serves none of it."""
        if self._running:
            raise RuntimeError("server already started")
        if num_shards is not None and num_shards > 1:
            return self.start_group(address, num_shards, shard_options)
        ep = address if isinstance(address, EndPoint) \
            else str2endpoint(address)
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
            # SIGUSR2 prints the fiber stacks (main thread only)
            from brpc_tpu_torch.fiber.stacks import enable_stack_dump_signal
            enable_stack_dump_signal()
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
        # the flight recorder runs while a server does; the incident
        # bvars outlive an unexpose_all, the manager's snapshots read
        # this server, and the trend rings' tick runs with the
        # watchdog's imports bound on this thread (brpc_tpu/rpc/
        # server.py:433-457)
        from brpc_tpu_torch.builtin.flight_recorder import hold_recorder
        from brpc_tpu_torch.bvar.series import ensure_series
        from brpc_tpu_torch.incident.manager import (attach_incident_server,
                                                     expose_incident_vars)
        hold_recorder(self)
        expose_incident_vars()
        attach_incident_server(self)
        ensure_series()
        return self.endpoint

    def _on_new_conn(self, conn: Conn) -> None:
        """On the dispatcher thread, which also raises the new socket's
        first input event: ``user_data`` is set before any byte is read."""
        s = Socket(conn, on_input=self._messenger.on_new_messages,
                   control=self.control)
        s.user_data["server"] = self
        if self._native_echo is not None:
            hook = self._fast_drain_hook
            if hook is None:            # resolved once; False: none
                hook = self._fast_drain_hook = \
                    server_dispatch.make_fast_drain(self) or False
            if hook is not False and not s._ring_attached:
                s.fast_drain = hook
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
        # the trend triple: a monotone passive graphs as a rate only
        # when its ring knows it is a counter
        declare_series_kind("server_processed", "delta")
        declare_series_kind("server_errors", "delta")
        declare_series_kind("server_latency_p99_us", "max")
        # the overload gates (brpc_tpu/rpc/server.py:54-75)
        PassiveStatus(lambda: read(
            lambda s: s.concurrency_limit() or 0)).expose(
            "server_concurrency_limit")
        PassiveStatus(lambda: read(lambda s: s.concurrency)).expose(
            "server_concurrency_inflight")
        PassiveStatus(lambda: read(
            lambda s: s._admission.wire_threshold()
            if s._admission is not None else 0)).expose(
            "server_admission_threshold")
        from brpc_tpu_torch.transport.ring_lane import expose_ring_vars
        from brpc_tpu_torch.transport.socket import expose_conn_census_vars
        from brpc_tpu_torch.transport.syscall_stats import (
            expose_syscall_vars)
        expose_syscall_vars()
        expose_ring_vars()
        expose_conn_census_vars()
        server_dispatch.expose_shed_vars()
        from .backend_stats import expose_backend_vars
        from .channel import expose_channel_vars
        from .cluster_channel import nnaming_empty
        expose_backend_vars()
        expose_channel_vars()
        nnaming_empty.expose("naming_empty")
        nauth_refused.expose("server_auth_refused")

    # ----------------------------------------------------------- accounting
    def _request_begin(self) -> None:
        with self._idle:
            self._inflight += 1

    def on_request_start(self, method_key: Optional[str] = None,
                         nbytes: int = 0, level: int = 0,
                         level_counted: bool = False) -> float:
        """The limiters' gate (brpc_tpu/rpc/server.py:601): the server's
        limiter, then the method's. The request's cost (1.0, or its
        weight with ``request_costs``), which ``on_request_end`` must
        release, or 0.0: shed it with ELIMIT. A reject is overload
        evidence for the admission controller (``level`` is the
        request's; ``level_counted``: ``admit_level`` counted it)."""
        cm = self._cost_model
        cost = cm.request_cost(method_key, nbytes) if cm is not None \
            else 1.0
        lim = self._limiter
        ml = self._method_limiters.get(method_key) \
            if self._method_limiters else None
        if lim is not None and not lim.on_requested(cost):
            shed = True
        elif ml is not None and not ml.on_requested(cost):
            if lim is not None:
                lim.on_responded(0.0, True, cost)   # the slot it took
            shed = True
        else:
            return cost
        server_dispatch.nlimit_shed.add(1)
        if self._admission is not None:
            self._admission.signal_overload(level, level_counted)
        return 0.0

    def on_request_end(self, method_key: str, latency_us: float,
                       failed: bool, cost: float = 1.0) -> None:
        """A handler's end (brpc_tpu/rpc/server.py:654): the counters,
        the limiters' release and its method's LatencyRecorder."""
        with self._idle:
            self.nprocessed += 1
            if failed:
                self.nerror += 1
            lr = self.method_status.get(method_key)
            if lr is None:
                lr = self.method_status[method_key] = LatencyRecorder()
        if self._limiter is not None:
            self._limiter.on_responded(latency_us, failed, cost)
        ml = self._method_limiters.get(method_key) \
            if self._method_limiters else None
        if ml is not None:
            ml.on_responded(latency_us, failed, cost)
        lr.record(latency_us)

    def account_native_batch(self, method_key: str, n: int,
                             total_us: float) -> None:
        """What a C echo loop served: the counts and the method's
        latencies. Such methods never block, so they pass no limiter."""
        from brpc_tpu_torch.transport.syscall_stats import note_rpc_messages
        note_rpc_messages(n)
        with self._idle:
            self.nprocessed += n
            lr = self.method_status.get(method_key)
            if lr is None:
                lr = self.method_status[method_key] = LatencyRecorder()
        lr.record_batch(total_us / n, n)

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

    def _http_auth_refused(self, socket: Socket,
                           req: http.HttpRequest) -> Optional[bytes]:
        """The auth gate of the HTTP path (brpc_tpu/protocol/http.py:
        259-280): every page and method but ``/health`` wants the
        credential, ``Authorization: Bearer ...`` or ``?token=``."""
        if (req.path.rstrip("/") or "/") == "/health":
            return None
        return self._auth_refused(socket, req.headers.get("authorization",
                                                          ""),
                                  req.query.get("token", ""))

    def _auth_refused(self, socket: Socket, authorization: str,
                      token: str = "") -> Optional[bytes]:
        """The gate of the HTTP and gRPC paths: the credential of an
        ``authorization: Bearer ...`` header (else ``token``), verified
        once a connection. The reason of a refusal, or None."""
        if self._auth is None or socket.user_data.get("auth_context") \
                is not None:
            return None
        cred = authorization[7:] if authorization.startswith("Bearer ") \
            else token
        try:
            ctx = self._auth.verify_credential(cred, socket.remote_endpoint)
        except AuthError as e:
            nauth_refused.add(1)
            return (str(e) or "authentication failed").encode()
        except Exception:               # boundary: a broken authenticator
            nauth_refused.add(1)
            return b"authentication failed"
        socket.user_data["auth_context"] = ctx
        return None

    def refuse_uncredentialed(self, protocol: str) -> Optional[str]:
        """The gate of a protocol that carries no credential (thrift,
        nshead, esp): a server with an Authenticator refuses every such
        call, as bRPC does (policy/thrift_protocol.cpp,
        VerifyThriftRequest; policy/nshead_protocol.cpp,
        VerifyNsheadRequest), and counts it where the HTTP gate counts
        its refusals. The reason, or None on a server without one."""
        if self._auth is None:
            return None
        nauth_refused.add(1)
        return (f"this server requires a credential, which {protocol} "
                f"cannot carry")

    async def _call_http(self, socket: Socket, req: http.HttpRequest,
                         unary: bool = False
                         ) -> Tuple[int, str,
                                    Union[bytes, ProgressiveAttachment]]:
        """``unary``: the answer must be one body (plain HTTP over h2),
        so the handler's Controller is marked ``unary``."""
        refused = self._http_auth_refused(socket, req)
        if refused is not None:
            return 403, "text/plain", refused
        if self.options.enable_builtin_services:
            page = http.builtin_page(self, req)
            if inspect.isawaitable(page):
                page = await page       # an on-demand /hotspots profile
            if page is not None:
                return page
        parts = [p for p in req.path.split("/") if p]
        if len(parts) != 2:
            return 404, "text/plain", f"no such page {req.path}".encode()
        method = self._methods.get((parts[0], parts[1]))
        if method is None:
            return 404, "text/plain", b"no such service/method"
        # the limiters' gate (brpc_tpu/protocol/http.py:924); HTTP
        # carries no priority, so no admission level
        cost = self.on_request_start(method.full_name, len(req.body))
        if not cost:
            return 500, "text/plain", b"max_concurrency reached"
        cntl = Controller()             # _server_socket None: HTTP
        cntl.unary = unary
        cntl.remote_side = socket.remote_endpoint
        cntl.auth_context = socket.user_data.get("auth_context")
        interceptor = self.options.interceptor
        if interceptor is not None:
            try:
                verdict = interceptor(cntl)
            except InterceptorError as e:
                verdict = (e.error_code, e.reason)
            except Exception as e:      # boundary: a broken interceptor
                verdict = (500, f"interceptor error: {e}")
            if verdict is not None:
                self.on_request_end(method.full_name, 0.0, True, cost)
                return 403, "text/plain", str(verdict[1]).encode()
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
            self.on_request_end(method.full_name,
                                (time.monotonic_ns() - t0) / 1e3, failed,
                                cost)
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
        if self._shard_group is not None:
            self._shard_group.stop()
            return
        self._listener.stop()
        if self.options.rtmp_service is not None:
            with self._sockets_lock:
                socks = list(self._sockets)
            for s in socks:
                self.options.rtmp_service.drop_socket(s)
        if self._serving is not None:
            self._serving.on_server_stop(self)
        # the last running server stops the flight recorder's sampler
        # (the reference leaves it running; ROADMAP section 3)
        from brpc_tpu_torch.builtin.flight_recorder import release_recorder
        release_recorder(self)

    def join(self, timeout_s: float = 5.0) -> None:
        """Wait up to ``timeout_s`` for in-flight calls, then close the
        connections (a supervisor: for its monitor to end)."""
        if self._shard_group is not None:
            self._shard_group.join(timeout_s)
            return
        with self._idle:
            self._idle.wait_for(lambda: not self._inflight, timeout_s)
        with self._sockets_lock:
            socks = list(self._sockets)
        for s in socks:
            s.set_failed(ConnectionError("server stopped"))

    def start_group(self, address: Union[str, EndPoint], num_shards: int,
                    shard_options=None) -> EndPoint:
        """Make this process the supervisor of ``num_shards`` forked
        shards on ``address`` (tcp), one shard included: ``start`` takes
        the plain path for one, this gives one shard the group's
        supervisor, dumps, merged pages and restarts."""
        import copy

        from .shard_group import ShardGroup, ShardGroupOptions
        if self._running:
            raise RuntimeError("server already started")
        # a copy: the caller may reuse the options for another group
        opts = copy.copy(shard_options) if shard_options is not None \
            else ShardGroupOptions()
        opts.num_shards = num_shards
        self._shard_group = ShardGroup(self, address, opts)
        self.endpoint = self._shard_group.start()
        self._running = True
        return self.endpoint

    def run_until_asked_to_quit(self) -> None:
        """Block until SIGINT or SIGTERM, then stop and join
        (brpc_tpu/rpc/server.py:541-569). Meanwhile a pidfile under
        ``.pids/`` names this process (``butil/pidfile.py``), and an
        orphaned server (its parent died without a signal) stops by
        itself unless ``BRPC_TPU_TORCH_NO_PARENT_WATCHDOG`` is set; so
        does a supervisor whose group failed (``ShardGroup.failed``)."""
        import os
        import signal

        from brpc_tpu_torch.butil.pidfile import (remove_pidfile,
                                                  write_pidfile)
        ev = threading.Event()
        for sig in (signal.SIGINT, signal.SIGTERM):
            signal.signal(sig, lambda *_: ev.set())
        watchdog = not os.environ.get("BRPC_TPU_TORCH_NO_PARENT_WATCHDOG")
        pidfile = write_pidfile(f"server-{self.endpoint}")
        parent = os.getppid()
        try:
            while not ev.is_set():
                ev.wait(1.0)
                if watchdog and os.getppid() != parent:
                    break
                grp = self._shard_group
                if grp is not None and grp.failed:
                    break
        finally:
            remove_pidfile(pidfile)
        self.stop()
        self.join()

    def _postfork_child_reset(self) -> None:
        """Re-arm this Server in a forked shard (brpc_tpu/rpc/server.py:
        571-600): its services and options cross the fork as plain data,
        but its TaskControl, listener, sockets, counters, recorders and
        limiters belong to the parent's machinery, and are made anew
        against the child's fresh singletons before ``start``."""
        self.control = global_control()
        self._messenger = None
        self._listener = None
        self.endpoint = None
        self._running = False
        self._idle = threading.Condition()
        self._inflight = 0
        self._sockets_lock = threading.Lock()
        self._sockets = set()
        self._fast_drain_hook = None
        self.method_status = {}
        self.nprocessed = 0
        self.nerror = 0
        self._build_limiters()
        self._shard_group = None
        if self.session_local_pool is not None:
            self.session_local_pool = SimpleDataPool(
                self.options.session_local_data_factory,
                reset=self.options.session_local_data_reset)
