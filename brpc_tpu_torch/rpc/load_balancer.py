"""Load balancers (the port of brpc_tpu/rpc/load_balancer.py;
brpc/load_balancer.h:35, the balancers of brpc/policy/).

A balancer keeps its servers in a ``DoublyBufferedData`` snapshot, a
tuple that ``reset_servers`` swaps whole, so a selection reads one
snapshot however a reset interleaves. ``select_server`` takes an
exclusion set (the servers a retry has tried, the breakers' and the
health checker's) and returns an EndPoint, or None when none is left.
After a selection exactly one of three reports returns its slot:
``feedback`` (a latency, or a failure), ``feedback_reject`` (the server
shed the attempt: no latency, no penalty) or ``abandon`` (no
observation: a backup that lost the race).

  rr            round robin
  random        uniform
  wrr / wr      weighted round robin / weighted random, the weight from
                the endpoint's ``#w=`` extra (default 1)
  c_hash        a ketama ring of 100 virtual nodes a server, md5
  c_murmurhash  the same ring keyed by murmur3 (``butil/hash.py``)
  la            locality-aware: weight 1 / (latency EWMA x (inflight +
                1)) in a partial-sum tree, O(log n) a pick

``register_load_balancer`` adds a name.
"""

from __future__ import annotations

import bisect
import hashlib
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from brpc_tpu_torch.butil.doubly_buffered import DoublyBufferedData
from brpc_tpu_torch.butil.endpoint import EndPoint
from brpc_tpu_torch.butil.fast_rand import fast_rand_less_than
from brpc_tpu_torch.butil.hash import murmur3_32of128


def _ep_weight(s: EndPoint) -> int:
    """The ``#w=`` extra as an int weight in [1, 10000]: a float string
    from a naming source rounds down, a malformed or infinite one is 1,
    and the cap bounds ``wrr``'s expanded list."""
    try:
        w = float(s.extra("w", "1") or "1")
    except (TypeError, ValueError):
        return 1
    if w != w or w in (float("inf"), float("-inf")):
        return 1
    return min(10000, max(1, int(w)))


class LoadBalancer:
    def reset_servers(self, servers: Sequence[EndPoint]) -> None:
        raise NotImplementedError

    def select_server(self, exclude: Optional[set] = None,
                      request_key: Optional[bytes] = None
                      ) -> Optional[EndPoint]:
        raise NotImplementedError

    def feedback(self, server: EndPoint, latency_us: float,
                 failed: bool) -> None:
        pass

    def abandon(self, server: EndPoint) -> None:
        """A selection that ends with no observation (a backup that lost
        the race, a late attempt): the slot returns, no latency."""

    def revive(self, server: EndPoint) -> None:
        """The health checker revived ``server``: adaptive balancers
        restart its estimate at a probe-friendly value."""

    def feedback_reject(self, server: EndPoint) -> None:
        """The server shed this attempt (ELIMIT, EOVERCROWDED,
        EPRIORITYSHED): the slot returns and the reject counts, but its
        microseconds must not enter a latency estimate (a shedding node
        would look fast) nor be penalised as breakage."""
        self.abandon(server)

    def decision_info(self, server: EndPoint) -> Optional[dict]:
        """Why ``server`` won, for the decision ring (``/lb_trace``);
        None for balancers that weigh nothing."""
        return None


class _SnapshotLB(LoadBalancer):
    def __init__(self):
        self._servers: DoublyBufferedData = DoublyBufferedData(())

    def reset_servers(self, servers):
        snapshot = tuple(servers)
        self._servers.modify(lambda _: snapshot)
        self._on_reset(snapshot)

    def _on_reset(self, snapshot):
        pass

    def _alive(self, exclude):
        servers = self._servers.read()
        if not exclude:
            return servers
        return tuple(s for s in servers if s not in exclude)


class RoundRobinLB(_SnapshotLB):
    name = "rr"

    def __init__(self):
        super().__init__()
        self._idx = 0
        self._lock = threading.Lock()

    def select_server(self, exclude=None, request_key=None):
        servers = self._alive(exclude)
        if not servers:
            return None
        with self._lock:
            self._idx = (self._idx + 1) % len(servers)
            return servers[self._idx]


class RandomLB(_SnapshotLB):
    name = "random"

    def select_server(self, exclude=None, request_key=None):
        servers = self._alive(exclude)
        if not servers:
            return None
        return servers[fast_rand_less_than(len(servers))]


class WeightedRoundRobinLB(_SnapshotLB):
    """wrr: each server ``w`` times in the cycle."""

    name = "wrr"

    def __init__(self):
        super().__init__()
        self._expanded: Tuple[EndPoint, ...] = ()
        self._idx = 0
        self._lock = threading.Lock()

    def _on_reset(self, snapshot):
        out: List[EndPoint] = []
        for s in snapshot:
            out.extend([s] * _ep_weight(s))
        self._expanded = tuple(out)

    def select_server(self, exclude=None, request_key=None):
        servers = self._expanded
        if exclude:
            servers = tuple(s for s in servers if s not in exclude)
        if not servers:
            return None
        with self._lock:
            self._idx = (self._idx + 1) % len(servers)
            return servers[self._idx]


class WeightedRandomLB(_SnapshotLB):
    """wr: a pick in proportion to weight
    (policy/weighted_randomized_load_balancer.cpp)."""

    name = "wr"

    def __init__(self):
        super().__init__()
        # (server, weight) pairs in one tuple: a reset can never pair a
        # weight with another server than its own
        self._weighted: Tuple[Tuple[EndPoint, int], ...] = ()

    def _on_reset(self, snapshot):
        self._weighted = tuple((s, _ep_weight(s)) for s in snapshot)

    def select_server(self, exclude=None, request_key=None):
        pool = [(s, w) for s, w in self._weighted
                if not exclude or s not in exclude]
        if not pool:
            return None
        pick = fast_rand_less_than(sum(w for _, w in pool))
        for s, w in pool:
            pick -= w
            if pick < 0:
                return s
        return pool[-1][0]


class ConsistentHashLB(_SnapshotLB):
    """c_hash: a ketama ring of VIRTUAL_NODES points a server
    (policy/hasher.cpp); the request key picks the point, and an
    excluded server's points pass to the next server on the ring."""

    name = "c_hash"
    VIRTUAL_NODES = 100

    def __init__(self):
        super().__init__()
        self._ring: List[Tuple[int, EndPoint]] = []

    @staticmethod
    def _hash(data: bytes) -> int:
        return int.from_bytes(hashlib.md5(data).digest()[:8], "big")

    def _on_reset(self, snapshot):
        ring = [(self._hash(f"{s}#{v}".encode()), s)
                for s in snapshot for v in range(self.VIRTUAL_NODES)]
        ring.sort(key=lambda t: t[0])
        self._ring = ring

    def select_server(self, exclude=None, request_key=None):
        ring = self._ring
        if not ring:
            return None
        idx = bisect.bisect_left(ring, (self._hash(request_key or b""),))
        n = len(ring)
        for i in range(n):
            s = ring[(idx + i) % n][1]
            if not exclude or s not in exclude:
                return s
        return None


class MurmurHashLB(ConsistentHashLB):
    """c_murmurhash: the same ring keyed by murmur3's low 32 bits
    (policy/hasher.cpp MurmurHash32)."""

    name = "c_murmurhash"

    @staticmethod
    def _hash(data: bytes) -> int:
        return murmur3_32of128(data)


class _Fenwick:
    """Partial sums over float weights: a point update and a descent by
    prefix sum in O(log n) (the divide tree of
    policy/locality_aware_load_balancer.cpp)."""

    def __init__(self, n: int):
        self.n = n
        self._t = [0.0] * (n + 1)
        self._w = [0.0] * n          # each weight, for point reads

    def set(self, i: int, w: float) -> None:
        delta = w - self._w[i]
        self._w[i] = w
        i += 1
        while i <= self.n:
            self._t[i] += delta
            i += i & (-i)

    def get(self, i: int) -> float:
        return self._w[i]

    @property
    def total(self) -> float:
        s = 0.0
        i = self.n
        while i > 0:
            s += self._t[i]
            i -= i & (-i)
        return s

    def find(self, target: float) -> int:
        """The index whose weight range holds ``target`` (0 <= target <
        total)."""
        idx = 0
        bit = 1
        while bit * 2 <= self.n:
            bit *= 2
        while bit:
            nxt = idx + bit
            if nxt <= self.n and self._t[nxt] <= target:
                target -= self._t[nxt]
                idx = nxt
            bit //= 2
        return min(idx, self.n - 1)


class LocalityAwareLB(_SnapshotLB):
    """la (policy/locality_aware_load_balancer.cpp): weight 1 /
    (latency EWMA x (inflight + 1)). A selection counts its request in
    flight at once, so a server that piles up unanswered requests loses
    weight before its EWMA moves; feedback returns the slot and folds
    the latency in (a failure as a sharp penalty). A new server starts
    at the cluster's best latency, so it is probed soon."""

    name = "la"
    ALPHA = 0.2
    DEFAULT_LAT_US = 1000.0
    ERROR_PENALTY_US = 1e6
    # the penalty's ceiling: ten times a failure compounds, and a node
    # that dies under traffic would reach float-inf, weight 0.0, and
    # stay unselectable after its revival
    MAX_PENALTY_US = 6e7

    def __init__(self):
        super().__init__()
        self._lock = threading.Lock()
        self._lat: Dict[EndPoint, float] = {}
        self._inflight: Dict[EndPoint, int] = {}
        self._rejects: Dict[EndPoint, int] = {}
        self._tree: Optional[_Fenwick] = None
        self._order: list = []          # index -> server
        self._index: Dict[EndPoint, int] = {}

    def _weight(self, s) -> float:
        lat = max(self._lat.get(s, self.DEFAULT_LAT_US), 1.0)
        return 1e9 / (lat * (self._inflight.get(s, 0) + 1))

    def _reweigh_locked(self, server) -> None:
        i = self._index.get(server)
        if i is not None and self._tree is not None:
            self._tree.set(i, self._weight(server))

    def _on_reset(self, snapshot):
        with self._lock:
            keep = set(snapshot)
            self._lat = {s: v for s, v in self._lat.items() if s in keep}
            self._inflight = {s: v for s, v in self._inflight.items()
                              if s in keep}
            self._rejects = {s: v for s, v in self._rejects.items()
                             if s in keep}
            self._order = list(snapshot)
            self._index = {s: i for i, s in enumerate(self._order)}
            self._tree = _Fenwick(len(self._order)) if self._order else None
            best = min(self._lat.values(), default=self.DEFAULT_LAT_US)
            for i, s in enumerate(self._order):
                self._lat.setdefault(s, best)   # optimistic probe weight
                self._tree.set(i, self._weight(s))

    def decision_info(self, server):
        with self._lock:
            lat = self._lat.get(server)
            if lat is None:
                return None
            info = {"weight": round(self._weight(server), 3),
                    "lat_ewma_us": round(lat, 1),
                    "inflight": self._inflight.get(server, 0)}
            nrej = self._rejects.get(server, 0)
            if nrej:
                info["rejects"] = nrej
            return info

    def revive(self, server):
        """Back from the dead: the estimate restarts at the cluster's
        best latency, as a new server's does; the penalty it died with
        would keep its weight near zero and starve it of the feedback
        that could clear it."""
        with self._lock:
            if server not in self._index:
                return
            best = min((v for s, v in self._lat.items() if s != server),
                       default=self.DEFAULT_LAT_US)
            self._lat[server] = min(best, self.MAX_PENALTY_US)
            self._reweigh_locked(server)

    def _return_slot_locked(self, server) -> None:
        inf = self._inflight.get(server, 0)
        if inf > 0:
            self._inflight[server] = inf - 1

    def feedback_reject(self, server):
        """A shed: the slot returns and the reject counts, the EWMA stays
        as it was. A shedding node loses picks because its in-flight
        count stays high against the calls it answers, not because it
        looks broken."""
        with self._lock:
            self._return_slot_locked(server)
            self._rejects[server] = self._rejects.get(server, 0) + 1
            self._reweigh_locked(server)

    def abandon(self, server):
        with self._lock:
            self._return_slot_locked(server)
            self._reweigh_locked(server)

    def feedback(self, server, latency_us, failed):
        with self._lock:
            self._return_slot_locked(server)
            cur = self._lat.get(server, self.DEFAULT_LAT_US)
            sample = (latency_us if not failed
                      else min(self.MAX_PENALTY_US,
                               max(cur * 10, self.ERROR_PENALTY_US)))
            self._lat[server] = (1 - self.ALPHA) * cur + self.ALPHA * sample
            self._reweigh_locked(server)

    def select_server(self, exclude=None, request_key=None):
        with self._lock:
            tree = self._tree
            if tree is None or not self._order:
                return None
            masked: list = []
            try:
                # excluded weights go to zero for this pick, then back
                for s in exclude or ():
                    i = self._index.get(s)
                    if i is not None and tree.get(i) > 0:
                        masked.append((i, tree.get(i)))
                        tree.set(i, 0.0)
                total = tree.total
                if total <= 0:
                    return None
                r = (fast_rand_less_than(1 << 30) / float(1 << 30)) * total
                chosen = self._order[tree.find(r)]
            finally:
                for i, w in masked:
                    tree.set(i, w)
            if exclude and chosen in exclude:
                return None
            # the request counts in flight from now: unanswered requests
            # push the weight down before any feedback arrives
            self._inflight[chosen] = self._inflight.get(chosen, 0) + 1
            tree.set(self._index[chosen], self._weight(chosen))
            return chosen


_factories = {
    "rr": RoundRobinLB,
    "random": RandomLB,
    "wrr": WeightedRoundRobinLB,
    "c_hash": ConsistentHashLB,
    "c_murmurhash": MurmurHashLB,
    "wr": WeightedRandomLB,
    "la": LocalityAwareLB,
}


def new_load_balancer(name: str) -> LoadBalancer:
    cls = _factories.get(name)
    if cls is None:
        raise ValueError(f"unknown load balancer {name!r}")
    return cls()


def register_load_balancer(name: str, factory) -> None:
    _factories[name] = factory
