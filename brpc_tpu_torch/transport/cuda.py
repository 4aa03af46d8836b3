"""cuda:// — the in-process device lane (the port of
brpc_tpu/transport/tpu.py, its ``tpu://``).

Host bytes ride mem pipes (``transport/mem.py``); tensors ride the lane
beside them. A tensor already on the peer's device is handed over by
reference, zero-copy; any other is moved there with ``.to(target)``
(tpu.py:50-61). Both ends live in one process: there is no wire and no
flow control on the lane. On one card this is a same-device hand-off,
and a time measured over it measures no link.

Address: ``cuda://name:port#device=K`` (``K`` the server's device,
``cpu`` for the host); a client's ``#reply_device=K`` names the device
its responses land on, by default the request's. A CUDA device needs a
card: without one the connect or listen raises (``resolve_device``).

Streams (the port's form of the PjRt future that ``jax.device_put``
returns): a tensor handed over by reference may still be being written
on the sender's stream. The writer records a ``torch.cuda.Event`` on its
current stream after the batch; ``take_device_payload`` makes the
taker's current stream wait on it, and where the two streams differ
calls ``record_stream`` so the allocator keeps the memory until the
taker's work is done.
"""

from __future__ import annotations

import torch

from brpc_tpu_torch.butil import tensor_bytes
from brpc_tpu_torch.butil.device import resolve_device
from brpc_tpu_torch.butil.endpoint import EndPoint, device_spec
from brpc_tpu_torch.transport.mem import MemConn, MemTransport, _MemPipe


class CudaConn(MemConn):
    """Host stream = mem pipes; device lane = by reference, or ``.to``
    onto the peer's device."""

    lane_kind = "loopback-d2d"

    def __init__(self, rx, tx, local, remote, peer_device: torch.device):
        super().__init__(rx, tx, local, remote)
        self.peer_device = peer_device

    def write_device_payload(self, arrays) -> bool:
        target = self.peer_device
        moved = []
        for t in arrays:
            tensor_bytes.check_tensor(t)
            moved.append(t if t.device == target else t.to(target))
        marks = []
        for dev in {t.device for t in moved if t.is_cuda}:
            stream = torch.cuda.current_stream(dev)
            ev = torch.cuda.Event()
            ev.record(stream)
            marks.append((ev, stream))
        self._push_batch((moved, marks))
        return True

    def take_device_payload(self):
        item = super().take_device_payload()
        if item is None:
            return None
        arrays, marks = item
        for ev, src in marks:
            cur = torch.cuda.current_stream(src.device)
            cur.wait_event(ev)
            if cur != src:
                for t in arrays:
                    if t.device == src.device:
                        t.record_stream(cur)
        return arrays


class CudaTransport(MemTransport):
    """Listeners keyed by ``host:port``. Requests land on the device the
    client's address names (the listener's when it names none);
    responses on the client's ``reply_device``, by default the same."""
    scheme = "cuda"

    def _key(self, ep: EndPoint) -> str:
        return f"{ep.host}:{ep.port}"

    def listen(self, ep: EndPoint, on_new_conn):
        resolve_device(ep.device)      # no card: raise now, not per call
        return super().listen(ep, on_new_conn)

    def _make_pair(self, a2b: _MemPipe, b2a: _MemPipe, lst, ep: EndPoint,
                   client_ep: EndPoint):
        spec = ep.device or lst.endpoint.device
        request_dev = resolve_device(spec)
        reply_dev = resolve_device(
            device_spec(ep.extra("reply_device")) or spec)
        client = CudaConn(rx=b2a, tx=a2b, local=client_ep, remote=ep,
                          peer_device=request_dev)
        server = CudaConn(rx=a2b, tx=b2a, local=lst.endpoint,
                          remote=client_ep, peer_device=reply_dev)
        return client, server
