"""Service and method registration (brpc_tpu/rpc/service.py).

A handler is ``handler(cntl, request: bytes) -> bytes``, or an ``async
def`` of that shape. It runs as a fiber on the server's workers, which
also run the decode steps: a coroutine handler awaits what it waits for
(a ``FiberEvent``, a butex); a plain one must not block for long. A
failure is reported with ``cntl.set_failed(code, text)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional


@dataclass
class Method:
    name: str
    handler: Callable
    full_name: str = ""   # "Service.Method", set by Server.add_service


class Service:
    def __init__(self, name: str):
        self.name = name
        self.methods: Dict[str, Method] = {}

    def register_method(self, name: str, handler: Callable) -> None:
        self.methods[name] = Method(name, handler)

    def method(self, name: Optional[str] = None):
        """Decorator: ``@svc.method()`` over ``def Echo(cntl, req): ...``"""
        def deco(fn):
            self.register_method(name or fn.__name__, fn)
            return fn
        return deco
