"""SimpleDataPool: session-local objects reused across requests (the
port of brpc_tpu/rpc/data_pool.py; brpc/simple_data_pool.{h,cpp} and
data_factory.h, behind ``ServerOptions.session_local_data_factory``).

The factory makes an object when none is free; a request borrows one
(``cntl.session_local_data()``) and gives it back when its handler ends,
reset first when the options name a reset. An object whose reset raises
is dropped, not reused.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional


class SimpleDataPool:
    def __init__(self, factory: Callable[[], Any],
                 reset: Optional[Callable[[Any], None]] = None,
                 max_free: int = 128):
        self._factory = factory
        self._reset = reset
        self._max_free = max_free
        self._free: List[Any] = []
        self._lock = threading.Lock()
        self.ncreated = 0

    def borrow(self) -> Any:
        with self._lock:
            if self._free:
                return self._free.pop()
            self.ncreated += 1
        return self._factory()

    def give_back(self, obj: Any) -> None:
        if obj is None:
            return
        if self._reset is not None:
            try:
                self._reset(obj)
            except Exception:
                return
        with self._lock:
            if len(self._free) < self._max_free:
                self._free.append(obj)

    @property
    def free_count(self) -> int:
        return len(self._free)
