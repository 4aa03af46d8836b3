"""The transport plugin interface (the port of brpc_tpu/transport/base.py).

A ``Conn`` is one non-blocking byte stream: ``write`` and ``read_into``
raise BlockingIOError when they would block, and the owning Socket
waits for the dispatcher to report readiness (``start_events``,
``request_writable_event``). A ``Transport`` dials (``connect``) and
listens (``listen``) for one scheme. The port registers ``tcp`` only;
the reference's mem://, tpu://, ici:// and ssl transports are still to
port (ROADMAP section 1).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

from brpc_tpu_torch.butil.endpoint import EndPoint


class Conn:
    """One established, non-blocking byte-stream connection."""

    def write(self, mv: memoryview) -> int:
        """Write some bytes; BlockingIOError if none can be taken."""
        raise NotImplementedError

    def read_into(self, mv: memoryview) -> int:
        """Read some bytes; 0 when the peer closed; BlockingIOError."""
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError

    def start_events(self, on_readable: Callable[[], None],
                     on_writable: Callable[[], None]) -> None:
        """Begin readiness callbacks (they fire on the dispatcher)."""
        raise NotImplementedError

    def request_writable_event(self) -> None:
        """One ``on_writable`` callback once the conn can take bytes
        again (the epollout a blocked writer asks for)."""
        raise NotImplementedError

    @property
    def local_endpoint(self) -> Optional[EndPoint]:
        return None

    @property
    def remote_endpoint(self) -> Optional[EndPoint]:
        return None


class Listener:
    def stop(self) -> None:
        raise NotImplementedError

    @property
    def endpoint(self) -> EndPoint:
        raise NotImplementedError


class Transport:
    scheme: str = ""

    def connect(self, ep: EndPoint) -> Conn:
        raise NotImplementedError

    def listen(self, ep: EndPoint,
               on_new_conn: Callable[[Conn], None]) -> Listener:
        raise NotImplementedError


_transports: Dict[str, Transport] = {}
_lock = threading.Lock()


def register_transport(t: Transport) -> None:
    with _lock:
        _transports[t.scheme] = t


def get_transport(scheme: str) -> Transport:
    t = _transports.get(scheme)
    if t is None:
        _register_builtins()
        t = _transports.get(scheme)
    if t is None:
        raise ValueError(f"no transport registered for scheme {scheme!r}")
    return t


def _register_builtins() -> None:
    with _lock:
        if "tcp" not in _transports:
            from brpc_tpu_torch.transport.tcp import TcpTransport
            _transports["tcp"] = TcpTransport()
