"""Service and method registration (brpc_tpu/rpc/service.py).

A handler is ``handler(cntl, request: bytes) -> bytes``, or an ``async
def`` of that shape. It runs as a fiber on the server's workers, which
also run the decode steps: a coroutine handler awaits what it waits for
(a ``FiberEvent``, a butex); a plain one must not block for long. A
failure is reported with ``cntl.set_failed(code, text)``.

``native="echo"`` (brpc_tpu/rpc/service.py:25-36) declares a method a
reflection echo: its response is its request. The server may then serve
its small frames in C (fastcore's ``serve_drain`` and ``serve_scan``:
parse, dispatch and the response never reach Python); the handler still
serves the rest, and must echo too.
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import Callable, Dict, Optional


@dataclass
class Method:
    name: str
    handler: Callable
    full_name: str = ""   # "Service.Method", set by Server.add_service
    # precomputed: the dispatch path asks it a request
    is_coroutine: bool = False
    # "echo": the server may serve it natively (see the module's doc)
    native_kind: Optional[str] = None


class Service:
    def __init__(self, name: str):
        self.name = name
        self.methods: Dict[str, Method] = {}

    def register_method(self, name: str, handler: Callable,
                        native: Optional[str] = None) -> None:
        if native is not None and native != "echo":
            raise ValueError(f"unknown native method kind {native!r}")
        self.methods[name] = Method(
            name, handler, is_coroutine=inspect.iscoroutinefunction(handler),
            native_kind=native)

    def method(self, name: Optional[str] = None,
               native: Optional[str] = None):
        """Decorator: ``@svc.method()`` over ``def Echo(cntl, req): ...``;
        ``native="echo"`` as in ``register_method``."""
        def deco(fn):
            self.register_method(name or fn.__name__, fn, native=native)
            return fn
        return deco
