"""DeviceRecvPool: size-classed admission control over the device memory
that receives tensors (the port of brpc_tpu/butil/device_pool.py; the
RDMA registered-memory block pool, rdma/block_pool.cpp:52 size classes
8KB/64KB/2MB).

As in the reference, the pool governs the budget, not placement: the
caching allocator places the tensors. Every inbound device batch
reserves its size-class-rounded bytes before its copy is issued, and the
reservation comes back when the application drops the tensors (a
``weakref.finalize`` on each tensor it receives; a view keeps its base
alive through ``._base``, so slicing a received tensor keeps the
reservation until the last view is gone). Each connection advertises a
byte budget (window x largest class, capped by this pool) in its hello,
and the sender gates on bytes in flight; the aggregate pressure of many
senders lands on this pool's blocking ``reserve()``.

``DevicePinnedStager`` lands host bytes on the card through a page-locked
block (``butil/iobuf.py`` ``pinned_staging_block``): the bytes go into
the block, a ``non_blocking`` copy runs on a side stream with an event
recorded after it, the taker's stream waits on that event, and the block
goes back to its freelist when the event completes (the device poller's
``watch``), so nobody blocks on the copy. ``ici://``'s staged lane uses
it; on the host (``#device=cpu``) a landed tensor is the host tensor.
"""

from __future__ import annotations

import threading
import weakref
from typing import List, Optional

# size classes mirror the reference's 8KB / 64KB / 2MB buckets
BLOCK_CLASSES = (8 << 10, 64 << 10, 2 << 20)


def round_to_class(nbytes: int) -> int:
    """Round a payload size up to its block-class footprint: payloads
    above the largest class take whole 2MB blocks (region extend)."""
    if nbytes <= 0:
        return BLOCK_CLASSES[0]
    for c in BLOCK_CLASSES:
        if nbytes <= c:
            return c
    big = BLOCK_CLASSES[-1]
    return ((nbytes + big - 1) // big) * big


class DeviceRecvPool:
    """Byte-budget admission for inbound device payloads. ``reserve()``
    blocks (with a timeout) when the budget is spent: the out-of-credit
    state a too-small window would otherwise hide."""

    def __init__(self, capacity_bytes: int = 256 << 20):
        self.capacity = capacity_bytes
        self._used = 0
        # reentrant: a collection that runs while this thread holds the
        # lock (any allocation under it may start one) fires the
        # finalizers of tensors it frees, and each calls ``release``
        self._lock = threading.RLock()
        self._freed = threading.Condition(self._lock)
        # reservations by class index (the last: oversized)
        self.reserved_blocks: List[int] = [0] * (len(BLOCK_CLASSES) + 1)

    def _class_index(self, footprint: int) -> int:
        for i, c in enumerate(BLOCK_CLASSES):
            if footprint <= c:
                return i
        return len(BLOCK_CLASSES)

    @property
    def used(self) -> int:
        with self._lock:
            return self._used

    @property
    def available(self) -> int:
        with self._lock:
            return self.capacity - self._used

    def reserve(self, nbytes: int, timeout_s: Optional[float] = 10.0) -> int:
        """Reserve budget for one payload; returns the rounded footprint
        (pass it to ``release``). Raises MemoryError on timeout: the
        connection-level error, not a silent stall. Under pressure it
        runs ``gc.collect()`` outside the lock (finalizers re-enter
        ``release``): tensors caught in reference cycles would otherwise
        hold budget until some later collection."""
        return self._reserve_footprint(round_to_class(nbytes), timeout_s)

    def reserve_group(self, footprint: int,
                      timeout_s: Optional[float] = 10.0) -> int:
        """One admission for a coalesced group: ``footprint`` is the sum
        of the group's size classes (sender and receiver compute it
        alike). Released by ``release``, or by ``GroupReservation`` when
        the group's last tensor dies."""
        return self._reserve_footprint(footprint, timeout_s)

    def _reserve_footprint(self, footprint: int,
                           timeout_s: Optional[float]) -> int:
        import time as _time

        if footprint > self.capacity:
            raise MemoryError(
                f"device payload footprint of {footprint}B exceeds "
                f"pool capacity {self.capacity}B")
        deadline = (None if timeout_s is None
                    else _time.monotonic() + timeout_s)
        gc_at = 0.0
        while True:
            with self._freed:
                if self.capacity - self._used >= footprint:
                    self._used += footprint
                    self.reserved_blocks[self._class_index(footprint)] += 1
                    return footprint
                if deadline is not None and _time.monotonic() >= deadline:
                    raise MemoryError(
                        f"device recv pool exhausted ({self._used}/"
                        f"{self.capacity}B used, need {footprint}B)")
                collect = _time.monotonic() >= gc_at
                if not collect:
                    self._freed.wait(0.05)
            if collect:
                import gc
                gc.collect()
                gc_at = _time.monotonic() + 1.0

    def try_reserve(self, nbytes: int) -> Optional[int]:
        """Non-blocking reserve; None when out of budget."""
        footprint = round_to_class(nbytes)
        with self._lock:
            if self.capacity - self._used < footprint:
                return None
            self._used += footprint
            self.reserved_blocks[self._class_index(footprint)] += 1
        return footprint

    def release(self, footprint: int) -> None:
        with self._freed:
            self._used -= footprint
            if self._used < 0:           # double-release guard
                self._used = 0
            self.reserved_blocks[self._class_index(footprint)] -= 1
            self._freed.notify_all()

    def attach_finalizer(self, obj, footprint: int) -> None:
        """Release the reservation when ``obj`` is collected: the
        application dropping the tensor is the block coming back."""
        try:
            weakref.finalize(obj, self.release, footprint)
        except TypeError:
            # no weakref support: release now rather than leak budget
            self.release(footprint)

    def attach_group_finalizer(self, obj, group: "GroupReservation") -> None:
        """Coalesced variant: every tensor of the group carries a
        finalizer into one GroupReservation, whose footprint goes back
        when the last one dies."""
        try:
            weakref.finalize(obj, group.release_one)
        except TypeError:
            group.release_one()


class DevicePinnedStager:
    """Lands host tensors on a device through pinned staging blocks and a
    side stream (one a device), without blocking the caller."""

    def __init__(self):
        self._streams: dict = {}
        self._lock = threading.Lock()
        self.staged_count = 0
        self.fallback_count = 0

    def _side_stream(self, device):
        import torch
        with self._lock:
            s = self._streams.get(device)
            if s is None:
                s = self._streams[device] = torch.cuda.Stream(device)
        return s

    def land(self, host, device):
        """``host`` (a CPU tensor) on ``device``. On a CUDA device the
        copy is queued, not waited for: the caller's current stream
        waits on it, and the staging block is released when it has
        run."""
        import torch

        if device.type != "cuda":
            self.fallback_count += 1
            return host
        nbytes = host.numel() * host.element_size()
        if nbytes == 0:
            return torch.empty(host.shape, dtype=host.dtype, device=device)
        from brpc_tpu_torch.butil.iobuf import pinned_staging_block
        from brpc_tpu_torch.fiber.device_poller import global_poller
        staging = pinned_staging_block(nbytes)
        staging.tensor.copy_(host.contiguous().reshape(-1).view(torch.uint8))
        side = self._side_stream(device)
        cur = torch.cuda.current_stream(device)
        with torch.cuda.stream(side):
            dst = torch.empty(host.shape, dtype=host.dtype, device=device)
            dst.reshape(-1).view(torch.uint8).copy_(staging.tensor,
                                                    non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(side)
        cur.wait_event(ev)
        # the block may be reused only after the taker's work on it
        dst.record_stream(cur)
        self.staged_count += 1
        global_poller().watch(ev, staging.release)
        return dst


_stager: Optional[DevicePinnedStager] = None
_stager_lock = threading.Lock()


def global_pinned_stager() -> DevicePinnedStager:
    global _stager
    with _stager_lock:
        if _stager is None:
            _stager = DevicePinnedStager()
        return _stager


def _postfork_reset_stager() -> None:
    """Fork hygiene: a child must not use the parent's side streams (CUDA
    objects of a context the child does not have), nor free them: the
    parent's stager is kept out of service (``postfork.keep_inherited``)
    and the child makes its own, under a fresh lock (brpc_tpu/butil/
    device_pool.py:272-282)."""
    global _stager, _stager_lock
    _postfork.keep_inherited(_stager)
    _stager = None
    _stager_lock = threading.Lock()


from brpc_tpu_torch.butil import postfork as _postfork  # noqa: E402

_postfork.register("butil.device_pool.stager", _postfork_reset_stager)


class GroupReservation:
    """Release-once holder shared by every tensor of a coalesced group:
    its footprint was reserved once (``reserve_group``) and goes back
    when the last tensor is dropped."""

    __slots__ = ("_pool", "_footprint", "_count", "_lock")

    def __init__(self, pool: DeviceRecvPool, footprint: int, count: int):
        self._pool = pool
        self._footprint = footprint
        self._count = max(1, count)
        self._lock = threading.Lock()

    def release_one(self) -> None:
        with self._lock:
            self._count -= 1
            if self._count > 0:
                return
        self._pool.release(self._footprint)
