"""Combo channels (the port of brpc_tpu/rpc/combo_channels.py):

  ParallelChannel  -- one call fans out to N sub-channels and their
                      responses merge (parallel_channel.h: CallMapper
                      :94, ResponseMerger :127, fail_limit :168);
  SelectiveChannel -- one healthy sub-channel a call, picked by a load
                      balancer, a retry going to another one
                      (selective_channel.h:52);
  PartitionChannel -- a fan-out by partition index, each partition its
                      own sub-channel (partition_channel.h:46-136);
  DynamicPartitionChannel -- partitions taken from the naming service's
                      ``#partition=K/N`` tags, a ClusterChannel each,
                      rebuilt on every update (partition_channel.h:136).

Sub-calls go out through ``Channel.call(done=)``; the parent controller
completes in the callback of the sub-call that decides it, wherever that
one completes. Inside a handler every sub-call inherits the request's
remaining budget (``Channel.call``).

A ParallelChannel whose sub-channels are the shards of one device mesh
can lower a tensor call onto the mesh instead (``attach_collective``:
one ``parallel.CollectiveChannel`` call, no RPC).

Unlike the reference, a sub-call's response is merged before it is
counted, so the parent completes only after every merge of the calls
that decided it has run (the reference merges after counting, and a
last sub-call could complete the parent while an earlier one's merge
still ran).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

from brpc_tpu_torch.butil.endpoint import EndPoint
from brpc_tpu_torch.fiber.timer import global_timer

from . import errno_codes as berr
from .channel import Channel
from .controller import Controller
from .load_balancer import LoadBalancer, new_load_balancer


class SubCall:
    """What a CallMapper returns for one sub-channel."""

    __slots__ = ("service", "method", "request", "device_arrays", "skip")

    def __init__(self, service: str, method: str, request: Any,
                 device_arrays: Optional[List] = None, skip: bool = False):
        self.service = service
        self.method = method
        self.request = request
        self.device_arrays = device_arrays
        self.skip = skip

    @classmethod
    def skipped(cls) -> "SubCall":
        return cls("", "", b"", skip=True)


class CallMapper:
    """Maps the logical call onto sub-channel i (parallel_channel.h:94).
    The default sends every sub the whole request and its tensors."""

    def map(self, sub_index: int, nsub: int, service: str, method: str,
            request: Any, cntl: Controller) -> SubCall:
        return SubCall(service, method, request,
                       device_arrays=cntl.request_device_arrays or None)


class ResponseMerger:
    """Folds one finished sub-call into the parent controller
    (parallel_channel.h:127). The default keeps each sub's response bytes
    and response tensors by index. Merges of different sub-calls may run
    at once, on different threads."""

    def merge(self, final_cntl: Controller, sub_index: int,
              sub_cntl: Controller) -> None:
        final_cntl.sub_responses[sub_index] = sub_cntl.response
        if sub_cntl.response_device_arrays:
            final_cntl.sub_device_arrays[sub_index] = \
                sub_cntl.response_device_arrays


class ParallelChannel:
    def __init__(self, fail_limit: Optional[int] = None,
                 call_mapper: Optional[CallMapper] = None,
                 response_merger: Optional[ResponseMerger] = None):
        self._subs: List[Channel] = []
        self.fail_limit = fail_limit
        self.call_mapper = call_mapper or CallMapper()
        self.response_merger = response_merger or ResponseMerger()
        # collective lowering (parallel/collective.py)
        self._collective = None
        self._collective_fns: Dict[Any, Callable] = {}
        self._lane_verdict: Optional[bool] = None
        self.collective_fused = 0
        self.collective_fallbacks = 0

    def attach_collective(self, collective,
                          service_fns: Dict[Any, Callable]) -> None:
        """Arm collective lowering (combo_channels.py:88): ``collective``
        is a ``parallel.CollectiveChannel`` over the mesh whose devices
        back the sub-channels; ``service_fns`` maps ``(service, method)``
        to the per-shard function equivalent to what that method
        computes. A call with one request tensor to a mapped method then
        runs as one collective call (the tensor split over the shard
        axis, the function on each shard, the merge on the device)
        instead of N calls. A call that does not qualify (host payloads,
        an unmapped method, a custom mapper, a sub-channel without a
        device lane) fans out as before."""
        self._collective = collective
        self._collective_fns = dict(service_fns)
        self._lane_verdict = None

    def _all_device_lane(self) -> bool:
        """Every sub-channel must have a device lane for the collective to
        be the same program: probed once a set of sub-channels."""
        if self._lane_verdict is None:
            try:
                self._lane_verdict = bool(self._subs) and all(
                    sub.device_lane_kind() is not None
                    for sub in self._subs)
            except Exception:   # a sub that cannot be probed: fan out
                self._lane_verdict = False
        return self._lane_verdict

    def _maybe_collective(self, service: str, method: str,
                          cntl: Controller) -> bool:
        """Try the collective; True when the call completed there. A
        lowering that fails is counted (``collective_fallbacks``) and the
        call fans out: the lowering never changes what a call returns."""
        coll = self._collective
        if coll is None:
            return False
        fn = self._collective_fns.get((service, method))
        if fn is None:
            return False
        arrs = cntl.request_device_arrays
        if not arrs or len(arrs) != 1:
            return False
        if type(self.call_mapper) is not CallMapper:
            # a custom mapper rewrites each sub's request; the collective
            # expresses only the stock scatter
            return False
        if len(self._subs) != coll.n_shards or not self._all_device_lane():
            return False
        try:
            out = coll.call(fn, arrs[0])
        except Exception:
            self.collective_fallbacks += 1
            return False
        self.collective_fused += 1
        cntl.collective_lowered = True
        cntl.response_device_arrays = [out]
        cntl._complete()
        return True

    def add_sub_channel(self, ch: Channel) -> None:
        self._subs.append(ch)
        self._lane_verdict = None

    @property
    def sub_channel_count(self) -> int:
        return len(self._subs)

    def call(self, service: str, method: str, request: Any = b"",
             cntl: Optional[Controller] = None,
             done: Optional[Callable] = None, **kw) -> Controller:
        """Fan the call out and return the parent controller at once;
        ``done`` and the joiners as in ``Channel.call``. The request's
        tensors are ``cntl.request_device_arrays``; ``kw`` goes to every
        sub-call."""
        cntl = cntl or Controller()
        if cntl.start_us:
            cntl._reset_for_call()
        cntl.start_us = time.monotonic_ns() // 1000
        cntl._done_cb = done
        subs = self._subs               # one call sees one set of subs
        nsub = len(subs)
        cntl.sub_responses = [None] * nsub
        cntl.sub_device_arrays = [None] * nsub
        cntl.sub_errors = [None] * nsub
        if nsub == 0:
            cntl.set_failed(berr.EINTERNAL, "no sub channels")
            cntl._complete()
            return cntl
        if self._maybe_collective(service, method, cntl):
            return cntl
        fail_limit = self.fail_limit if self.fail_limit is not None \
            else nsub
        sub_calls = []
        for i, sub in enumerate(subs):
            sc = self.call_mapper.map(i, nsub, service, method, request,
                                      cntl)
            if sc is None or sc.skip:
                continue
            sub_calls.append((i, sub, sc))
        if not sub_calls:
            cntl.set_failed(berr.EREQUEST,
                            "call mapper skipped every sub call")
            cntl._complete()
            return cntl
        state = {"pending": len(sub_calls), "failed": 0, "done": False}
        lock = threading.Lock()

        def on_sub_done(i):
            def _cb(sub_cntl):
                if state["done"]:
                    return              # decided: nothing more to merge
                err = None
                if sub_cntl.failed():
                    err = (sub_cntl.error_code, sub_cntl.error_text)
                else:
                    try:
                        self.response_merger.merge(cntl, i, sub_cntl)
                    except Exception as e:
                        err = (berr.ERESPONSE, f"merger failed: {e}")
                with lock:
                    if state["done"]:
                        return
                    if err is not None:
                        state["failed"] += 1
                        cntl.sub_errors[i] = err
                    state["pending"] -= 1
                    if state["failed"] < fail_limit and state["pending"]:
                        return
                    state["done"] = True
                    nfailed = state["failed"]
                if nfailed >= fail_limit:
                    cntl.set_failed(
                        berr.ETOOMANYFAILS,
                        f"{nfailed}/{len(sub_calls)} sub calls failed")
                cntl._complete()
            return _cb

        for i, sub, sc in sub_calls:
            sub.call(sc.service, sc.method, sc.request,
                     done=on_sub_done(i),
                     request_device_arrays=sc.device_arrays, **kw)
        return cntl

    def call_sync(self, service, method, request=b"",
                  timeout_s: float = 30.0, **kw) -> Controller:
        cntl = self.call(service, method, request, **kw)
        cntl.join(timeout_s)
        return cntl

    async def call_async(self, service, method, request=b"",
                         timeout_s: float = 30.0, **kw) -> Controller:
        """``call`` + ``join_async``, for a fiber."""
        cntl = self.call(service, method, request, **kw)
        await cntl.join_async(timeout_s)
        return cntl


class SelectiveChannel:
    """One healthy sub-channel a call; a failed call is retried on
    another (selective_channel.h:52)."""

    def __init__(self, load_balancer: str | LoadBalancer = "rr",
                 max_retry: int = 2):
        self._subs: List[Channel] = []
        self._lb = (load_balancer if isinstance(load_balancer, LoadBalancer)
                    else new_load_balancer(load_balancer))
        self.max_retry = max_retry

    def add_sub_channel(self, ch: Channel) -> None:
        self._subs.append(ch)
        # the balancer keys sub-channels by endpoints named by index
        self._lb.reset_servers(
            tuple(EndPoint("sub", str(i), 0) for i in range(len(self._subs))))

    def call(self, service: str, method: str, request: Any = b"",
             cntl: Optional[Controller] = None,
             done: Optional[Callable] = None, **kw) -> Controller:
        cntl = cntl or Controller()
        if cntl.start_us:
            cntl._reset_for_call()
        cntl.start_us = time.monotonic_ns() // 1000
        cntl._done_cb = done
        tried: set = set()

        def attempt(tries_left: int):
            ep = self._lb.select_server(tried or None)
            if ep is None:
                cntl.set_failed(berr.ETOOMANYFAILS, "no sub channel left")
                cntl._complete()
                return
            tried.add(ep)
            sub = self._subs[int(ep.host)]

            def _cb(sub_cntl):
                self._lb.feedback(ep, sub_cntl.latency_us(),
                                  sub_cntl.failed())
                if sub_cntl.failed() and tries_left > 0:
                    attempt(tries_left - 1)
                    return
                cntl.error_code = sub_cntl.error_code
                cntl.error_text = sub_cntl.error_text
                cntl.response = sub_cntl.response
                cntl.response_device_arrays = sub_cntl.response_device_arrays
                cntl._complete()

            sub.call(service, method, request, done=_cb, **kw)

        attempt(self.max_retry)
        return cntl

    def call_sync(self, service, method, request=b"",
                  timeout_s: float = 30.0, **kw) -> Controller:
        cntl = self.call(service, method, request, **kw)
        cntl.join(timeout_s)
        return cntl


class PartitionParser:
    """Splits a logical request into per-partition requests
    (partition_channel.h:46)."""

    def parse(self, partition_index: int, num_partitions: int, service: str,
              method: str, request: Any, cntl: Controller) -> SubCall:
        return SubCall(service, method, request)


class PartitionChannel(ParallelChannel):
    """Fan one call out to every partition of a sharded service;
    partition i is sub-channel i (partition_channel.h:75)."""

    def __init__(self, partition_parser: Optional[PartitionParser] = None,
                 fail_limit: Optional[int] = 1,
                 response_merger: Optional[ResponseMerger] = None):
        parser = partition_parser or PartitionParser()

        class _Mapper(CallMapper):
            def map(self, i, nsub, service, method, request, cntl):
                return parser.parse(i, nsub, service, method, request, cntl)

        super().__init__(fail_limit=fail_limit, call_mapper=_Mapper(),
                         response_merger=response_merger)
        self.partition_parser = parser

    def add_partition(self, ch: Channel) -> None:
        self.add_sub_channel(ch)

    @property
    def partition_count(self) -> int:
        return self.sub_channel_count


class DynamicPartitionChannel(PartitionChannel):
    """A PartitionChannel whose partitions follow the naming service
    (partition_channel.h:136 and the _dynpart balancer). A server entry
    carries ``#partition=K/N``; on each update the sub-channels become N
    partitions, each a ``list://`` ClusterChannel of that partition's
    replicas, swapped in whole: a call in flight keeps the generation it
    started with, and the old one closes 10 s later. A partition with no
    replica gets an empty cluster, whose calls fail ENAMINGEMPTY."""

    RETIRE_S = 10.0

    def __init__(self, naming_url: str,
                 partition_parser: Optional[PartitionParser] = None,
                 fail_limit: Optional[int] = 1,
                 response_merger: Optional[ResponseMerger] = None,
                 options=None):
        from .naming import NamingServiceThread
        super().__init__(partition_parser, fail_limit, response_merger)
        self._options = options
        self._generation = 0
        self._ready = threading.Event()
        self._retired: List[list] = []
        self._retire_lock = threading.Lock()
        self._ns = NamingServiceThread(naming_url)
        self._ns.watch(self._rebuild)

    def wait_ready(self, timeout_s: float = 5.0) -> bool:
        return self._ready.wait(timeout_s)

    def _rebuild(self, servers) -> None:
        from .cluster_channel import ClusterChannel
        by_partition: Dict[int, list] = {}
        nparts = 0
        for ep in servers:
            spec = ep.extra("partition")
            if not spec or "/" not in spec:
                continue
            k_s, n_s = spec.split("/", 1)
            try:
                k, n = int(k_s), int(n_s)
            except ValueError:
                continue
            if n <= 0 or not 0 <= k < n:
                continue
            nparts = max(nparts, n)
            by_partition.setdefault(k, []).append(
                EndPoint(ep.scheme, ep.host, ep.port))
        new_subs = [
            ClusterChannel("list://" + ",".join(
                str(e) for e in by_partition.get(k, [])), "rr",
                self._options)
            for k in range(nparts)]
        old, self._subs = self._subs, new_subs       # one reference swap
        self._lane_verdict = None
        self._generation += 1
        self._ready.set()
        if old:
            # calls in flight still hold the old generation: close it
            # after a grace period, not under them
            with self._retire_lock:
                self._retired.append(old)
            global_timer().schedule_after(self.RETIRE_S,
                                          self._close_retired)

    def _close_retired(self) -> None:
        with self._retire_lock:
            gens, self._retired = self._retired[:1], self._retired[1:]
        for gen in gens:
            for ch in gen:
                ch.close()

    def close(self) -> None:
        self._ns.stop()
        with self._retire_lock:
            gens, self._retired = self._retired, []
        for gen in gens + [self._subs]:
            for ch in gen:
                ch.close()
