"""Server: tpu_std over TCP, sync handlers on a small thread pool.

A connection's reader thread parses each request frame and hands it to
the handler pool, so a handler that blocks (a unary Generate waits for
its sequence to retire) never stalls the connection. Responses are
framed as brpc_tpu frames them: a success carries only the correlation
id in its meta (the reference's small-call fast path), a failure
carries ``response {error_code, error_text}``.

``start`` and ``stop`` call ``server._serving.on_server_start/stop``
(brpc_tpu/rpc/server.py:430,518): that is how the serving lane builds
and drains its engine with the server's lifecycle.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict

from brpc_tpu_torch.protocol import tpu_std
from brpc_tpu_torch.transport.tcp import Connection, Listener

from . import errno_codes as berr
from .controller import Controller
from .service import Method, Service

log = logging.getLogger("brpc_tpu_torch.rpc")


HANDLER_THREADS = 32     # a unary Generate holds its thread until it retires


@dataclass(frozen=True)
class EndPoint:
    host: str
    port: int

    def __str__(self) -> str:
        return f"tcp://{self.host}:{self.port}"


class Server:
    def __init__(self):
        self._methods: Dict[tuple, Method] = {}
        self._listener = None
        self._pool = None
        self._running = False
        self._serving = None            # GenerateService handle (serving/)

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
        self._pool = ThreadPoolExecutor(HANDLER_THREADS,
                                        thread_name_prefix="rpc-handler")
        try:
            if self._serving is not None:
                self._serving.on_server_start(self)
            self._listener = Listener(address, self._on_frame).start()
        except BaseException:
            self._pool.shutdown(wait=False)
            if self._serving is not None:
                self._serving.on_server_stop(self)
            raise
        self._running = True
        return EndPoint(self._listener.host, self._listener.port)

    # ------------------------------------------------------------ dispatch
    def _on_frame(self, conn: Connection, meta: tpu_std.RpcMeta,
                  payload: bytes, attachment: bytes) -> None:
        req = meta.request
        if req is None:
            return                      # not a request: ignore
        arrival_ns = time.monotonic_ns()
        cntl = Controller()
        cntl.correlation_id = meta.correlation_id
        cntl.set_deadline(req.timeout_ms, arrival_ns)
        method = self._methods.get((req.service_name, req.method_name))
        if method is None:
            known = any(s == req.service_name for s, _ in self._methods)
            cntl.set_failed(berr.ENOMETHOD if known else berr.ENOSERVICE,
                            f"{req.service_name}.{req.method_name} "
                            "not found")
            self._respond(conn, cntl, b"")
            return
        try:
            self._pool.submit(self._run, conn, method, cntl, payload)
        except RuntimeError:            # pool shut down: server stopping
            cntl.set_failed(berr.ELOGOFF, "server is stopping")
            self._respond(conn, cntl, b"")

    def _run(self, conn: Connection, method: Method, cntl: Controller,
             payload: bytes) -> None:
        try:
            response = method.handler(cntl, payload)
        except Exception as e:          # boundary: report, keep serving
            log.exception("handler %s failed", method.full_name)
            cntl.set_failed(berr.EINTERNAL, f"{type(e).__name__}: {e}")
            response = b""
        self._respond(conn, cntl, response or b"")

    @staticmethod
    def _respond(conn: Connection, cntl: Controller, response: bytes) -> None:
        if cntl.failed():
            meta = tpu_std.RpcMeta(
                response=tpu_std.RpcResponseMeta(cntl.error_code,
                                                 cntl.error_text),
                correlation_id=cntl.correlation_id)
            frame = tpu_std.pack_frame(meta)
        else:
            frame = tpu_std.pack_small_frame(
                b"", cntl.correlation_id, bytes(response))
        try:
            conn.send(frame)
        except OSError as e:            # client gone: nothing to tell it
            log.debug("response to %s dropped: %s", conn.peer, e)

    # ----------------------------------------------------------- lifecycle
    def stop(self) -> None:
        """Stop accepting and retire in-flight generations; their calls
        fail with the serving lane's verdict."""
        if not self._running:
            return
        self._running = False
        self._listener.stop()
        if self._serving is not None:
            self._serving.on_server_stop(self)
        self._pool.shutdown(wait=False)

    def join(self, timeout_s: float = 5.0) -> None:
        """Wait for in-flight handlers, then close the connections."""
        if self._pool is not None:
            done = threading.Event()
            threading.Thread(target=lambda: (self._pool.shutdown(wait=True),
                                             done.set()),
                             daemon=True).start()
            done.wait(timeout_s)
        if self._listener is not None:
            self._listener.close_connections()
