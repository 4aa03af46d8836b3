"""ResourcePool: a dense versioned-id <-> object map (the port of
brpc_tpu/butil/resource_pool.py; bRPC's butil/resource_pool.h).

``insert`` returns a 64-bit VersionedId = (version << 32) | slot;
``address`` returns the object only while the id is live; ``remove``
bumps the slot's version, so every id handed out for it goes stale at
once (the ABA defense behind Socket's versioned refs,
brpc/socket.cpp:776-800). Freed slots are reused.
"""

from __future__ import annotations

import threading
from typing import Generic, List, Optional, TypeVar

T = TypeVar("T")

VersionedId = int

_SLOT_BITS = 32
_SLOT_MASK = (1 << _SLOT_BITS) - 1


class ResourcePool(Generic[T]):
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._objs: List[Optional[T]] = []
        self._versions: List[int] = []
        self._free: List[int] = []

    def insert(self, obj: T) -> VersionedId:
        with self._lock:
            if self._free:
                slot = self._free.pop()
                self._objs[slot] = obj
            else:
                slot = len(self._objs)
                self._objs.append(obj)
                self._versions.append(0)
            return (self._versions[slot] << _SLOT_BITS) | slot

    def address(self, vid: VersionedId) -> Optional[T]:
        """Lock-free read: list reads are atomic under the interpreter
        lock and the lists only grow."""
        slot = vid & _SLOT_MASK
        objs = self._objs
        if slot >= len(objs):
            return None
        if self._versions[slot] != (vid >> _SLOT_BITS):
            return None
        return objs[slot]

    def remove(self, vid: VersionedId) -> Optional[T]:
        """Make the id stale (version bump) and free the slot; the object
        if the id was still live."""
        slot = vid & _SLOT_MASK
        with self._lock:
            if slot >= len(self._objs):
                return None
            if self._versions[slot] != (vid >> _SLOT_BITS):
                return None
            obj = self._objs[slot]
            self._objs[slot] = None
            self._versions[slot] += 1
            self._free.append(slot)
            return obj

    def live(self) -> int:
        """The number of live ids."""
        with self._lock:
            return len(self._objs) - len(self._free)
