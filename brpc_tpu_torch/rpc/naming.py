"""Naming services: a url becomes a live server list (the port of
brpc_tpu/rpc/naming.py; brpc/naming_service.h:36).

A NamingService runs in a fiber of its own
(details/naming_service_thread.*) and pushes whole server lists through
``actions.reset_servers``. The schemes:

  list://ep1,ep2,...          a fixed list
  file://path                 one endpoint a line, read again every second
  dns://host:port             getaddrinfo, every 5 s
  mesh://base:port            one ``cuda://base:port#device=K`` for each
                              CUDA device of this process (brpc_tpu lists
                              its jax devices as ``tpu://...``)
  remotefile://host:port/path a list over HTTP, one server a line
  consul://, nacos://, discovery://host:port/name
                              the registries' HTTP APIs

A poller keeps its last good list when a fetch fails or a payload is
malformed. It waits between fetches on the thread's stop event, so
``NamingServiceThread.stop`` ends it at once; ``live_naming_threads()``
counts the services still running.
"""

from __future__ import annotations

import http.client
import inspect
import json
import logging
import socket as pysocket
import threading
import time
from typing import Callable, Dict, List, Optional
from urllib.parse import quote

from brpc_tpu_torch.butil.endpoint import EndPoint, str2endpoint
from brpc_tpu_torch.fiber import TaskControl, global_control
from brpc_tpu_torch.fiber.sync import FiberEvent

log = logging.getLogger("brpc_tpu_torch.rpc")

_live = 0
_live_lock = threading.Lock()


def live_naming_threads() -> int:
    """Naming services whose fiber is still running."""
    with _live_lock:
        return _live


class NamingServiceActions:
    """Receives server lists (NamingServiceActions::ResetServers)."""

    def reset_servers(self, servers: List[EndPoint]) -> None:
        raise NotImplementedError


class NamingService:
    def run(self, param: str, actions: NamingServiceActions,
            stop_event: FiberEvent) -> None:
        """A coroutine function or a plain one; loops until
        ``stop_event`` is set, waiting on it between fetches."""
        raise NotImplementedError


class StaticNamingService(NamingService):
    """list://: servers fixed at start."""

    async def run(self, param, actions, stop_event):
        actions.reset_servers([str2endpoint(p.strip())
                               for p in param.split(",") if p.strip()])


class FileNamingService(NamingService):
    interval_s = 1.0

    async def run(self, param, actions, stop_event):
        last = None
        while not stop_event.is_set():
            try:
                with open(param) as f:
                    lines = [ln.strip() for ln in f if ln.strip()
                             and not ln.startswith("#")]
            except OSError:
                lines = []
            if lines != last:
                last = lines
                actions.reset_servers([str2endpoint(ln) for ln in lines])
            await stop_event.wait(self.interval_s)


class DnsNamingService(NamingService):
    interval_s = 5.0

    async def run(self, param, actions, stop_event):
        ep = str2endpoint(param, default_scheme="tcp")
        last = None
        while not stop_event.is_set():
            try:
                infos = pysocket.getaddrinfo(ep.host, ep.port,
                                             pysocket.AF_INET,
                                             pysocket.SOCK_STREAM)
                ips = sorted({i[4][0] for i in infos})
            except OSError:
                ips = []
            if ips != last:
                last = ips
                actions.reset_servers(
                    [EndPoint("tcp", ip, ep.port) for ip in ips])
            await stop_event.wait(self.interval_s)


class MeshNamingService(NamingService):
    """mesh://base:port: every CUDA device of this process is a server,
    ``cuda://base:port#device=K``, the listeners the mesh's shards were
    started under."""

    async def run(self, param, actions, stop_event):
        import torch
        base = str2endpoint(param, default_scheme="cuda")
        actions.reset_servers(
            [EndPoint("cuda", base.host, base.port).with_extras(device=d)
             for d in range(torch.cuda.device_count())])


def _http_get(hostport: str, path: str, timeout: float = 3.0):
    """GET host:port/path: (status, body), or (0, b"") on any failure of
    the transport, a registry that restarts mid-response included; the
    polling fiber must outlive it."""
    host, _, port = hostport.partition(":")
    try:
        conn = http.client.HTTPConnection(host, int(port or 80),
                                          timeout=timeout)
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read()
        conn.close()
        return resp.status, body
    except (OSError, ValueError, http.client.HTTPException):
        return 0, b""


class RemoteFileNamingService(NamingService):
    """remotefile://host:port/path: a server list over HTTP, one a line
    (remote_file_naming_service)."""

    interval_s = 2.0

    async def run(self, param, actions, stop_event):
        hostport, _, path = param.partition("/")
        last = None
        while not stop_event.is_set():
            status, body = _http_get(hostport, "/" + path)
            lines = []
            if status == 200:
                lines = [ln.strip() for ln in body.decode().splitlines()
                         if ln.strip() and not ln.startswith("#")]
            if lines and lines != last:
                last = lines
                eps = []
                for ln in lines:
                    try:
                        eps.append(str2endpoint(ln))
                    except ValueError:
                        # one malformed line must not stop the poller
                        log.warning("remotefile naming: bad line %r", ln)
                actions.reset_servers(eps)
            await stop_event.wait(self.interval_s)


class _RegistryNamingService(NamingService):
    """The loop of the HTTP registries (consul, nacos, discovery;
    policy/*_naming_service.cpp): GET ``path(name)``, ``parse`` it to
    endpoints (None keeps the last list), push on change."""

    interval_s = 2.0

    def path(self, name: str) -> str:
        raise NotImplementedError

    def parse(self, body: bytes, name: str):
        raise NotImplementedError

    async def run(self, param, actions, stop_event):
        hostport, _, name = param.partition("/")
        last = None
        while not stop_event.is_set():
            status, body = _http_get(hostport, self.path(name))
            if status == 200:
                try:
                    eps = self.parse(body, name)
                except (ValueError, TypeError, KeyError):
                    eps = None          # malformed: keep the last list
                if eps is not None and eps != last:
                    last = eps
                    actions.reset_servers(eps)
            await stop_event.wait(self.interval_s)


class ConsulNamingService(_RegistryNamingService):
    """consul://agent:port/service: the passing instances of Consul's
    health API; an empty Service.Address falls back to the node's."""

    def path(self, name):
        return f"/v1/health/service/{quote(name)}?stale&passing"

    def parse(self, body, name):
        eps = []
        for entry in json.loads(body):
            svc = entry.get("Service", {})
            addr = svc.get("Address") or \
                entry.get("Node", {}).get("Address")
            port = svc.get("Port")
            if addr and port:
                eps.append(EndPoint("tcp", addr, int(port)))
        return eps


class NacosNamingService(_RegistryNamingService):
    """nacos://server:port/serviceName: healthy, enabled instances, the
    weight in the ``#w=`` extra (an int in [1, 10000]; a weight <= 0
    means drained and skips the host)."""

    def path(self, name):
        return f"/nacos/v1/ns/instance/list?serviceName={quote(name)}"

    def parse(self, body, name):
        eps = []
        for h in json.loads(body).get("hosts", []):
            if not (h.get("healthy", True) and h.get("enabled", True)):
                continue
            ep = EndPoint("tcp", h["ip"], int(h["port"]))
            w = h.get("weight")
            if w is not None:
                try:
                    wf = float(w)
                except (TypeError, ValueError):
                    wf = 1.0
                if wf != wf:
                    wf = 1.0
                if wf <= 0:
                    continue
                ep = ep.with_extras(
                    w=1 if wf == float("inf") else min(10000,
                                                       max(1, int(wf))))
            eps.append(ep)
        return eps


class DiscoveryNamingService(_RegistryNamingService):
    """discovery://server:port/appid: a bilibili-discovery registry, the
    UP instances (status 1), the first address of each."""

    def path(self, name):
        return f"/discovery/fetchs?appid={quote(name)}&status=1"

    def parse(self, body, name):
        doc = json.loads(body)
        if doc.get("code", 0) != 0:
            return None
        eps = []
        app = doc.get("data", {}).get(name, {})
        for inst in app.get("instances", []):
            if inst.get("status", 1) != 1:
                continue
            for addr in inst.get("addrs", []):
                _, _, hp = addr.partition("://")
                host, _, port = hp.partition(":")
                if host and port:
                    eps.append(EndPoint("tcp", host, int(port)))
                    break
        return eps


_registry: Dict[str, NamingService] = {
    "list": StaticNamingService(),
    "file": FileNamingService(),
    "dns": DnsNamingService(),
    "mesh": MeshNamingService(),
    "remotefile": RemoteFileNamingService(),
    "consul": ConsulNamingService(),
    "nacos": NacosNamingService(),
    "discovery": DiscoveryNamingService(),
}


def get_naming_service(scheme: str) -> NamingService:
    ns = _registry.get(scheme)
    if ns is None:
        raise ValueError(f"no naming service for scheme {scheme!r}")
    return ns


class NamingServiceThread:
    """One naming service in a fiber, its lists fanned out to watchers
    (details/naming_service_thread.{h,cpp})."""

    def __init__(self, url: str, control: Optional[TaskControl] = None):
        scheme, _, param = url.partition("://")
        self.url = url
        self._ns = get_naming_service(scheme)
        self._watchers: List[Callable[[List[EndPoint]], None]] = []
        self._servers: List[EndPoint] = []
        self._lock = threading.Lock()
        self._stop = FiberEvent()
        self._first_update = threading.Event()
        # how many lists were delivered and when the last one landed: a
        # stale feed explains a frozen backend set on /backends
        self._revision = 0
        self._last_update_mono: Optional[float] = None
        outer = self

        class _Actions(NamingServiceActions):
            def reset_servers(self, servers):
                with outer._lock:
                    outer._servers = list(servers)
                    watchers = list(outer._watchers)
                    outer._revision += 1
                    outer._last_update_mono = time.monotonic()
                # the watchers hear first: a ClusterChannel waiting on
                # the first update finds its balancer seeded. A watcher
                # that raises neither starves the others nor leaves the
                # event unset
                try:
                    for w in watchers:
                        try:
                            w(list(servers))
                        except Exception:
                            log.exception("naming watcher failed")
                finally:
                    outer._first_update.set()

        global _live
        with _live_lock:
            _live += 1
        (control or global_control()).spawn(
            self._run, param, _Actions(), name=f"naming_{scheme}")

    async def _run(self, param: str, actions: NamingServiceActions) -> None:
        global _live
        try:
            r = self._ns.run(param, actions, self._stop)
            if inspect.isawaitable(r):
                await r
        except Exception:               # boundary: the fiber must end
            log.exception("naming service %s failed", self.url)
        finally:
            with _live_lock:
                _live -= 1

    def watch(self, cb: Callable[[List[EndPoint]], None]) -> None:
        with self._lock:
            self._watchers.append(cb)
            servers = list(self._servers)
        if self._first_update.is_set():
            cb(servers)

    def revision(self) -> int:
        """Lists delivered so far (0: none yet)."""
        with self._lock:
            return self._revision

    def last_update_age_s(self) -> Optional[float]:
        """Seconds since the last list; None before the first."""
        with self._lock:
            if self._last_update_mono is None:
                return None
            return round(time.monotonic() - self._last_update_mono, 3)

    def wait_first_update(self, timeout_s: float = 5.0) -> bool:
        return self._first_update.wait(timeout_s)

    def stop(self) -> None:
        self._stop.set()
