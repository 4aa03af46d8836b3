"""The transport plugin interface (the port of brpc_tpu/transport/base.py).

A ``Conn`` is one non-blocking byte stream: ``write`` and ``read_into``
raise BlockingIOError when they would block, and the owning Socket
waits for the dispatcher to report readiness (``start_events``,
``request_writable_event``). A ``Transport`` dials (``connect``) and
listens (``listen``) for one scheme. The port registers ``tcp``,
``mem`` (in-process loopback), ``cuda`` (the in-process device lane,
brpc_tpu's ``tpu://``), ``cudad`` (the staged lane between processes,
brpc_tpu's ``tpud://``) and ``ici`` (the device lane between processes:
CUDA IPC, or staged; ``transport/ici.py``); the reference's ssl
transport is still to port (ROADMAP section 1).

Device lane: a conn with ``supports_device_lane`` carries tensors beside
its bytes. ``write_device_payload(arrays)`` sends one batch and
``take_device_payload()`` returns the oldest batch received (None when
none came), in the order they were written; the sender writes a batch
right before the frame that describes it, so the parser takes the batch
when it cuts that frame. ``lane_kind`` names the lane
(``loopback-d2d``, ``staged-dcn``, ``local-d2d``, ``cuda-ipc``,
``staged``). A conn with ``supports_device_tracker`` takes the stage
tracker of ``transport/device_stats.py`` (``write_device_payload(arrays,
tracker=)``) and stamps it itself. A conn without the lane (tcp) never
gets a batch: tensors go inline in the frame's bytes.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

from brpc_tpu_torch.butil.endpoint import EndPoint


class Conn:
    """One established, non-blocking byte-stream connection."""

    supports_device_lane = False
    lane_kind: Optional[str] = None

    def write_device_payload(self, arrays) -> bool:
        raise NotImplementedError(
            f"{type(self).__name__} has no device lane")

    def take_device_payload(self):
        return None

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


# the builtin schemes, each imported when first asked for: cuda and
# cudad import torch, which a process serving bytes alone never needs
_BUILTINS = {
    "tcp": ("brpc_tpu_torch.transport.tcp", "TcpTransport"),
    "mem": ("brpc_tpu_torch.transport.mem", "MemTransport"),
    "cuda": ("brpc_tpu_torch.transport.cuda", "CudaTransport"),
    "cudad": ("brpc_tpu_torch.transport.cudad", "CudadTransport"),
    "ici": ("brpc_tpu_torch.transport.ici", "IciTransport"),
}


def get_transport(scheme: str) -> Transport:
    t = _transports.get(scheme)
    if t is None and scheme in _BUILTINS:
        import importlib
        module, cls = _BUILTINS[scheme]
        made = getattr(importlib.import_module(module), cls)()
        with _lock:
            t = _transports.setdefault(scheme, made)
    if t is None:
        raise ValueError(f"no transport registered for scheme {scheme!r}")
    return t
