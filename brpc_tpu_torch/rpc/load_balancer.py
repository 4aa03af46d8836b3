"""Load balancers (the part of brpc_tpu/rpc/load_balancer.py that
SelectiveChannel uses; brpc/load_balancer.h:35, policy/round_robin and
randomized_load_balancer).

A balancer holds a snapshot of its servers, a tuple that
``reset_servers`` swaps whole: a selection reads one snapshot, however a
reset interleaves (the reference keeps it in a DoublyBufferedData).
``select_server`` takes an exclusion set (the servers a retry has tried)
and returns an EndPoint, or None when none is left; ``feedback`` reports
a call's latency and failure to adaptive balancers. The weighted,
hashing and locality-aware balancers come with the cluster client
(ROADMAP section 1 item 8).
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

from brpc_tpu_torch.butil.endpoint import EndPoint
from brpc_tpu_torch.butil.fast_rand import fast_rand_less_than


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


class _SnapshotLB(LoadBalancer):
    def __init__(self):
        self._servers: tuple = ()

    def reset_servers(self, servers):
        self._servers = tuple(servers)

    def _alive(self, exclude):
        servers = self._servers
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


_factories = {"rr": RoundRobinLB, "random": RandomLB}


def new_load_balancer(name: str) -> LoadBalancer:
    cls = _factories.get(name)
    if cls is None:
        raise ValueError(f"unknown load balancer {name!r}")
    return cls()
