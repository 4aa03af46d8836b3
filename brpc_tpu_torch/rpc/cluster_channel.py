"""ClusterChannel: a Channel over a naming service and a load balancer
(the port of brpc_tpu/rpc/cluster_channel.py; Channel::Init(ns_url,
lb_name), details/load_balancer_with_naming.*).

An attempt excludes the endpoints the call has tried (a retry goes
elsewhere), the breakers have isolated and the health checker holds
dead, then lets the balancer pick; with every endpoint excluded it
drops the call's own exclusions first and probes the dead last. The
channel keeps one socket an endpoint, shared by all its calls
(``_socket_for``). A failed attempt feeds the balancer and the breaker
(a shed only returns the balancer's slot); the call's completion feeds
the backend that answered and abandons every other selection, so each
pick is matched by one report. A refused connect and a failed socket
mark the endpoint dead; the health checker probes it and revives it.
Every decision lands in the channel's ring on ``/lb_trace``; its rows,
breakers and health on ``/backends``.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Union

from brpc_tpu_torch.butil.endpoint import EndPoint
from brpc_tpu_torch.butil.flags import flag
from brpc_tpu_torch.bvar.reducer import Adder

from . import backend_stats as _bs
from . import errno_codes as berr
from .channel import Channel, ChannelOptions
from .circuit_breaker import ClusterBreakers
from .client_dispatch import fail_calls
from .controller import Controller
from .health_check import HealthChecker
from .load_balancer import LoadBalancer, new_load_balancer
from .naming import NamingServiceThread

# calls failed at once because the naming service has given no server
nnaming_empty = Adder()


class NamingEmptyError(ConnectionError):
    """No server to pick because the list is empty (not because all are
    excluded): the call fails with ENAMINGEMPTY, drains no retry token,
    and a wrong naming url shows as itself."""

    berrno = berr.ENAMINGEMPTY


class ClusterChannel(Channel):
    def __init__(self, naming_url: str,
                 load_balancer: Union[str, LoadBalancer] = "rr",
                 options: Optional[ChannelOptions] = None):
        # the naming url names the dependency on /backends
        self._naming_url = naming_url
        super().__init__(None, options)
        self._lb = (load_balancer if isinstance(load_balancer, LoadBalancer)
                    else new_load_balancer(load_balancer))
        self._lb_has_info = type(self._lb).decision_info \
            is not LoadBalancer.decision_info
        self._breakers = ClusterBreakers()
        self._sockets: Dict[EndPoint, object] = {}
        self._sockets_lock = threading.Lock()
        self._servers: list = []
        self._health = HealthChecker(app_check=self.options.app_health_check,
                                     on_event=self._on_health_event)
        self._ns = NamingServiceThread(naming_url)
        self._ns.watch(self._on_servers)
        self._ns.wait_first_update(self.options.naming_wait_s)

    # ------------------------------------------------------------- naming
    def _on_servers(self, servers):
        self._servers = servers
        self._lb.reset_servers(servers)
        self._health.retain(servers)
        _bs.ring_event(self._stats_name, "naming", count=len(servers),
                       servers=_bs._ep_list(servers))

    def servers(self):
        return list(self._servers)

    def _on_health_event(self, event: str, ep) -> None:
        """A death explains why later picks skip the backend, a revival
        why it is back; a revival also restarts the balancer's estimate
        of it."""
        if event == "revived":
            try:
                self._lb.revive(ep)
            except Exception:
                pass
        _bs.ring_event(self._stats_name, "health", event=event,
                       endpoint=_bs.ep_key(ep))

    def _bs_ring(self):
        """The channel's ring, cached until ``lb_trace_ring`` changes."""
        r = self.__dict__.get("_bs_ring_cache")
        if r is None or r.maxlen != flag("lb_trace_ring"):
            r = _bs.global_stats().ring(self._stats_name)
            self._bs_ring_cache = r
        return r

    # ---------------------------------------------------- the page's state
    def _default_stats_name(self) -> str:
        return self._naming_url

    @property
    def lb_name(self) -> str:
        return getattr(self._lb, "name", type(self._lb).__name__)

    def naming_info(self) -> dict:
        return {"url": self._naming_url or None,
                "servers": len(self._servers),
                "revision": self._ns.revision(),
                "last_update_age_s": self._ns.last_update_age_s()}

    def backend_state(self, key: str) -> dict:
        """One /backends row's breaker, health and naming state (``key``
        is the row's backend key); a backend no longer named says
        in_naming False."""
        out = {"in_naming": any(_bs.ep_key(ep) == key
                                for ep in list(self._servers)),
               "health_dead": any(_bs.ep_key(ep) == key
                                  for ep in self._health.dead_set())}
        for ep, b in self._breakers.items():
            if _bs.ep_key(ep) == key:
                out["breaker"] = b.snapshot()
                break
        return out

    # ----------------------------------------------------------- selection
    def _pick_socket(self, cntl: Controller):
        if not self._servers:
            nnaming_empty.add(1)
            rev = self._ns.revision()
            why = ("never delivered a server list" if rev == 0
                   else f"delivered an empty list (revision {rev})")
            raise NamingEmptyError(f"naming {self._naming_url!r} {why}")
        tried = set(cntl.tried_servers)
        isolated = self._breakers.isolated_set(self._servers)
        dead = self._health.dead_set()
        exclude = tried | isolated | dead
        ep = self._lb.select_server(exclude or None)
        fallback = False
        if ep is None and exclude:
            # all excluded: drop the call's own exclusions (tried, the
            # breakers) first and still avoid the dead, whom probing is
            # the health checker's job; only a full outage probes anyone
            fallback = True
            if dead:
                ep = self._lb.select_server(dead)
            if ep is None:
                ep = self._lb.select_server(None)
        if _bs.enabled():
            self._select_event(ep, tried, isolated, dead, fallback)
        if ep is None:
            raise ConnectionError("no server available")
        # a backup or retry that comes after the completion's sweep
        # (which records, under this lock, how many picks it settled)
        # would leak its slot: return it and drop the attempt
        with cntl._lb_lock:
            if cntl._lb_swept_n is not None:
                self._lb.abandon(ep)
                _bs.ring_event(self._stats_name, "abandon",
                               endpoint=_bs.ep_key(ep),
                               why="late attempt after completion")
                raise ConnectionError("call already completed (late "
                                      "backup/retry attempt dropped)")
            cntl.tried_servers.append(ep)
        if self._on_call_complete not in cntl._complete_hooks:
            cntl._add_complete_hook(self._on_call_complete)
        return self._socket_for(ep)

    def _select_event(self, ep, tried, isolated, dead, fallback) -> None:
        """The decision ring's record of a pick: the winner, what was
        excluded and why, and a weighing balancer's factors."""
        ev = {"endpoint": self._bs_cell(ep)[0] if ep is not None else None,
              "lb": self.lb_name, "attempt": len(tried) + 1}
        excluded = {}
        if tried:
            excluded["tried"] = _bs._ep_list(tried)
        if isolated:
            excluded["breaker"] = _bs._ep_list(isolated)
        if dead:
            excluded["health"] = _bs._ep_list(dead)
        if excluded:
            ev["excluded"] = excluded
        if fallback:
            ev["fallback"] = True
        if ep is not None and self._lb_has_info:
            try:
                info = self._lb.decision_info(ep)
            except Exception:
                info = None
            if info:
                ev["info"] = info
        _bs.ring_event(self._stats_name, "select", ring=self._bs_ring(),
                       **ev)

    def _socket_for(self, ep: EndPoint):
        """The endpoint's one socket, dialed outside the lock; of two
        dials racing, one wins and the other is closed."""
        with self._sockets_lock:
            cur = self._sockets.get(ep)
        if cur is not None and not cur.failed:
            return cur
        try:
            s = self._dial(ep)
        except (ConnectionError, OSError):
            # a refused connect is how a stopped node shows before it has
            # a socket to fail
            self._health.mark_dead(ep)
            raise
        with self._sockets_lock:
            cur = self._sockets.get(ep)
            if cur is None or cur.failed:
                self._sockets[ep] = s
                cur = None
        if cur is not None:
            s.set_failed(ConnectionError("duplicate connect discarded"))
            return cur
        s.on_failed(lambda sock, ep=ep: self._on_socket_failed_ep(sock, ep))
        return s

    def _on_socket_failed_ep(self, sock, ep: EndPoint) -> None:
        # dead first: the retries of the attempts failed below skip it
        self._health.mark_dead(ep)
        fail_calls(sock, berr.EFAILEDSOCKET, "connection closed")

    # ------------------------------------------------------------ feedback
    def _on_attempt_failed(self, cntl: Controller, code: int, text: str,
                           failed_ep=None):
        """A failed attempt that the call survives: its server hears of
        it (else a server never isolates while retries save its calls),
        attributed to the endpoint the failure path knows, since with a
        backup in flight the last pick may be another, healthy one."""
        with cntl._lb_lock:
            tried = cntl.tried_servers
            if failed_ep is not None and failed_ep in tried:
                ep = failed_ep
            else:
                ep = tried[-1] if tried else None
            if ep is not None:
                # under the same hold: the sweep must see this report
                cntl._lb_fed.append(ep)
        super()._on_attempt_failed(cntl, code, text, ep)
        if ep is None:
            return
        reject = code in _bs.REJECT_CODES
        if reject:
            # a node shedding to protect itself is not broken: the slot
            # returns, no latency, the breaker untouched
            self._lb.feedback_reject(ep)
        else:
            self._lb.feedback(ep, cntl.latency_us(), True)
            self._breakers.on_call(ep, failed=True)
        if _bs.enabled():
            _bs.ring_event(self._stats_name, "feedback",
                           ring=self._bs_ring(),
                           endpoint=self._bs_cell(ep)[0],
                           failed="reject" if reject else True, code=code)

    def _on_call_complete(self, cntl: Controller):
        # the marker and the snapshot under the lock the picks append
        # under: a late backup lands before this, or sees the marker
        with cntl._lb_lock:
            cntl._lb_swept_n = len(cntl.tried_servers)
            tried = list(cntl.tried_servers)
            fed = list(cntl._lb_fed)
        if not tried:
            return
        ring = self._bs_ring() if _bs.enabled() else None

        def abandon(s, why):
            self._lb.abandon(s)
            if ring is not None:
                _bs.ring_event(self._stats_name, "abandon", ring=ring,
                               endpoint=_bs.ep_key(s), why=why)
        if cntl.error_code == berr.ECANCELED:
            # the client's own doing: no server failed, and the cut
            # latency means nothing
            for s in tried:
                if s in fed:
                    fed.remove(s)
                else:
                    abandon(s, "canceled")
            return
        # the final observation goes to the server whose response
        # completed the call; a timeout or failure, to the last pick
        ep = cntl.responded_server
        if ep is None or ep not in tried:
            ep = tried[-1]
        code = cntl.error_code
        if _bs.is_reject(code, cntl.responded_server):
            self._lb.feedback_reject(ep)
            ev = {"failed": "reject", "code": code}
        else:
            self._lb.feedback(ep, cntl.latency_us(), cntl.failed())
            self._breakers.on_call(
                ep, cntl.failed() and code != berr.ERPCTIMEDOUT)
            ev = {"failed": cntl.failed(), "code": code,
                  "latency_us": cntl.latency_us()}
        if ring is not None:
            _bs.ring_event(self._stats_name, "feedback", ring=ring,
                           endpoint=self._bs_cell(ep)[0], final=True, **ev)
        # every pick is matched by one report: the picks less the
        # reports delivered (the failed attempts' and this one) abandon
        fed.append(ep)
        for s in tried:
            if s in fed:
                fed.remove(s)
            else:
                abandon(s, "backup/retry lost the race")

    def close(self):
        self._ns.stop()
        self._health.stop()
        with self._sockets_lock:
            sockets, self._sockets = dict(self._sockets), {}
        for s in sockets.values():
            if not s.failed:
                s.set_failed(ConnectionError("channel closed"))
