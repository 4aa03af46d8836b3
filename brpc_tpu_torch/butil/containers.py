"""Containers of the reference's butil/containers/ that Python does not
have (the port of brpc_tpu/butil/containers.py): ``BoundedQueue``
(bounded_queue.h), ``MRUCache`` (mru_cache.h) and ``CaseIgnoredDict``
(case_ignored_flat_map.h). FlatMap itself is a dict."""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Iterator, Optional, Tuple


class BoundedQueue:
    """Fixed-capacity FIFO ring. push/pop return False/None when full/
    empty instead of blocking (the reference's bounded_queue is the
    non-blocking building block under RemoteTaskQueue etc.)."""

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self._cap = capacity
        self._items = [None] * capacity
        self._head = 0     # next pop
        self._size = 0
        self._lock = threading.Lock()

    @property
    def capacity(self) -> int:
        return self._cap

    def __len__(self) -> int:
        return self._size

    def full(self) -> bool:
        return self._size >= self._cap

    def empty(self) -> bool:
        return self._size == 0

    def push(self, item) -> bool:
        with self._lock:
            if self._size >= self._cap:
                return False
            self._items[(self._head + self._size) % self._cap] = item
            self._size += 1
            return True

    def push_force(self, item) -> Optional[Any]:
        """Push, evicting and returning the oldest item when full
        (elim_push in the reference)."""
        with self._lock:
            evicted = None
            if self._size >= self._cap:
                evicted = self._items[self._head]
                self._items[self._head] = None
                self._head = (self._head + 1) % self._cap
                self._size -= 1
            self._items[(self._head + self._size) % self._cap] = item
            self._size += 1
            return evicted

    def pop(self) -> Optional[Any]:
        with self._lock:
            if self._size == 0:
                return None
            item = self._items[self._head]
            self._items[self._head] = None
            self._head = (self._head + 1) % self._cap
            self._size -= 1
            return item

    def top(self) -> Optional[Any]:
        with self._lock:
            return self._items[self._head] if self._size else None


class MRUCache:
    """Most-recently-used cache with capacity eviction (mru_cache.h):
    get() refreshes recency; inserting past capacity evicts the least
    recently used entry, calling the optional deleter."""

    def __init__(self, capacity: int,
                 deleter: Optional[Callable[[Any, Any], None]] = None):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self._cap = capacity
        self._deleter = deleter
        self._od: "OrderedDict[Any, Any]" = OrderedDict()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._od)

    def __contains__(self, key) -> bool:
        return key in self._od

    def put(self, key, value) -> None:
        evicted = None
        with self._lock:
            if key in self._od:
                self._od.pop(key)
            self._od[key] = value
            if len(self._od) > self._cap:
                evicted = self._od.popitem(last=False)
        if evicted is not None and self._deleter is not None:
            self._deleter(*evicted)

    def get(self, key, default=None):
        with self._lock:
            if key not in self._od:
                return default
            self._od.move_to_end(key)
            return self._od[key]

    def peek(self, key, default=None):
        """No recency refresh."""
        return self._od.get(key, default)

    def erase(self, key) -> bool:
        with self._lock:
            v = self._od.pop(key, _MISSING)
        if v is _MISSING:
            return False
        if self._deleter is not None:
            self._deleter(key, v)
        return True

    def clear(self) -> None:
        with self._lock:
            items, self._od = list(self._od.items()), OrderedDict()
        if self._deleter is not None:
            for k, v in items:
                self._deleter(k, v)

    def items(self) -> Iterator[Tuple[Any, Any]]:
        """LRU -> MRU order snapshot."""
        with self._lock:
            return iter(list(self._od.items()))


_MISSING = object()


class CaseIgnoredDict(dict):
    """dict with case-insensitive string keys (case_ignored_flat_map.h —
    HTTP header maps)."""

    @staticmethod
    def _k(key):
        return key.lower() if isinstance(key, str) else key

    def __init__(self, *args, **kw):
        super().__init__()
        for k, v in dict(*args, **kw).items():
            self[k] = v

    def __setitem__(self, key, value):
        super().__setitem__(self._k(key), value)

    def __getitem__(self, key):
        return super().__getitem__(self._k(key))

    def __delitem__(self, key):
        super().__delitem__(self._k(key))

    def __contains__(self, key):
        return super().__contains__(self._k(key))

    def get(self, key, default=None):
        return super().get(self._k(key), default)

    def pop(self, key, *a):
        return super().pop(self._k(key), *a)

    def setdefault(self, key, default=None):
        return super().setdefault(self._k(key), default)

    def update(self, *args, **kw):
        for k, v in dict(*args, **kw).items():
            self[k] = v
