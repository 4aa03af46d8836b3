"""Fiber-local storage (the port of brpc_tpu/fiber/keys.py; bthread keys,
bthread/key.cpp): values scoped to a fiber's lifetime, with optional
destructors run when the fiber exits."""

from __future__ import annotations

import itertools
import threading
from typing import Any, Callable, Optional

from .scheduler import current_fiber

_key_seq = itertools.count()


class FiberLocal:
    """One key; ``get``/``set`` act on the current fiber. Outside a fiber
    they use a thread-level slot (as pthread keys would)."""

    def __init__(self, destructor: Optional[Callable[[Any], None]] = None):
        self._id = ("fiber_local", next(_key_seq))
        self._destructor = destructor
        self._thread_fallback = threading.local()

    def get(self, default: Any = None) -> Any:
        f = current_fiber()
        if f is None:
            return getattr(self._thread_fallback, "value", default)
        return f.locals.get(self._id, default)

    def peek(self, fiber, default: Any = None) -> Any:
        """Read ANOTHER fiber's slot (no thread fallback); racy by
        contract, for samplers."""
        return fiber.locals.get(self._id, default)

    def set(self, value: Any) -> None:
        f = current_fiber()
        if f is None:
            self._thread_fallback.value = value
            return
        if self._destructor is not None and self._id not in f.locals:
            key_id = self._id
            dtor = self._destructor

            def _run_dtor(fiber):
                if key_id in fiber.locals:
                    dtor(fiber.locals[key_id])
            f._key_destructors.append(_run_dtor)
        f.locals[self._id] = value
