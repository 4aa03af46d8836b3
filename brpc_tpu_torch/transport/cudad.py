"""cudad:// — the staged device lane between processes (the port of
brpc_tpu/transport/tpud.py, its ``tpud://``, on the same wire).

One TCP stream carries enveloped frames:

    frame := type:u8 len:u32be payload
    type 0  app bytes        (delivered to the Socket's input)
    type 1  device batch     (count:u16be, then per tensor: dtype name
                              len:u8 + name, rank:u8, shape as i64be,
                              nbytes:u64be, the bytes in C order)
    type 2  hello            (JSON: the device ordinal and kind)

The dtype names are numpy's and JAX's (``butil/tensor_bytes.py``), so a
brpc_tpu ``tpud://`` peer and a port ``cudad://`` peer talk to each
other. The sender copies each tensor to the host (an explicit
``.cpu()``, synchronous for a CUDA tensor) and writes its batch right
before the frame that describes it; the single stream keeps them in
order, so the batch is decoded (into host tensors, during the read) by
the time the parser asks for it. ``take_device_payload`` lands the batch
on the conn's device (``#device=K``, ``cpu`` for the host), on the
thread that parses, as brpc_tpu does; a failed copy raises, there is no
host fallback. ``cudad://`` mirrors brpc_tpu's ``tpud://``, which lands
its batches without the pinned stager; ``ici://``'s staged lane is the
one that lands through it (``butil/device_pool.py``). Moving these
copies onto the stager is a redesign queued in ROADMAP section 2.
"""

from __future__ import annotations

import json
import struct
import threading
from collections import deque
from typing import Callable, Deque, List, Optional

import torch

from brpc_tpu_torch.butil import tensor_bytes
from brpc_tpu_torch.butil.device import resolve_device
from brpc_tpu_torch.butil.endpoint import EndPoint
from brpc_tpu_torch.transport.base import Conn, Listener, Transport
from brpc_tpu_torch.transport.tcp import TcpConn, TcpTransport

_F_BYTES = 0
_F_DEVICE = 1
_F_HELLO = 2
_HDR = struct.Struct(">BI")
_MAX_FRAME = 256 << 20
_MAX_OUT = 64 << 20          # backpressure cap on the staged out-buffer
_FLUSH_CHUNK = 256 << 10


def _hello_payload(device: torch.device) -> bytes:
    return json.dumps({"device": device.index or 0,
                       "device_type": device.type}).encode()


def _encode_device_batch(arrays) -> bytes:
    """The batch envelope's payload, byte for byte brpc_tpu's
    ``_encode_device_batch`` of the same values."""
    parts = [struct.pack(">H", len(arrays))]
    for t in arrays:
        tensor_bytes.check_tensor(t)
        dt = tensor_bytes.dtype_name(t).encode()
        shape = tuple(int(s) for s in t.shape)
        raw = tensor_bytes.host_bytes(t)
        parts.append(struct.pack(">B", len(dt)))
        parts.append(dt)
        parts.append(struct.pack(">B", len(shape)))
        parts.append(struct.pack(f">{len(shape)}q", *shape))
        parts.append(struct.pack(">Q", len(raw)))
        parts.append(raw)
    return b"".join(parts)


def _decode_device_batch(data: bytearray) -> List[torch.Tensor]:
    """Host tensors over ``data`` (no copy: each one views the buffer)."""
    (count,) = struct.unpack_from(">H", data, 0)
    pos = 2
    out = []
    cpu = torch.device("cpu")
    for _ in range(count):
        (dtlen,) = struct.unpack_from(">B", data, pos)
        pos += 1
        name = bytes(data[pos:pos + dtlen]).decode()
        pos += dtlen
        (rank,) = struct.unpack_from(">B", data, pos)
        pos += 1
        shape = struct.unpack_from(f">{rank}q", data, pos)
        pos += 8 * rank
        (nbytes,) = struct.unpack_from(">Q", data, pos)
        pos += 8
        if pos + nbytes > len(data):
            raise ValueError("device batch shorter than its tensors")
        out.append(tensor_bytes.from_host_bytes(data, name, shape, cpu,
                                                offset=pos, count=nbytes))
        pos += nbytes
    return out


class CudadConn(Conn):
    supports_device_lane = True
    lane_kind = "staged-dcn"
    # the TCP fd underneath is level-triggered: a short read drained it
    level_triggered = True

    def __init__(self, inner: TcpConn, local: EndPoint, remote: EndPoint,
                 device: torch.device):
        self._inner = inner
        self._local = local
        self._remote = remote
        self.device = device
        self._lock = threading.Lock()
        self._flush_lock = threading.Lock()   # one flusher at a time
        self._out = bytearray()            # staged enveloped output
        self._inbuf = bytearray()          # raw inbound, pre-envelope
        self._appbuf = bytearray()         # de-enveloped app bytes
        self._lane: Deque[List[torch.Tensor]] = deque()
        self._closed_read = False
        self.peer_info: Optional[dict] = None
        self._send_frame(_F_HELLO, _hello_payload(device))

    # ----------------------------------------------------------- outbound
    def _send_frame(self, ftype: int, payload: bytes) -> None:
        with self._lock:
            if len(self._out) > _MAX_OUT:
                raise BlockingIOError("cudad out-buffer full")
            self._out += _HDR.pack(ftype, len(payload))
            self._out += payload
        self._flush()

    def _flush(self) -> bool:
        """Push staged bytes into the TCP socket; True once all went.
        Single-flight: two flushers would send the same prefix twice."""
        with self._flush_lock:
            while True:
                with self._lock:
                    if not self._out:
                        return True
                    chunk = bytes(self._out[:_FLUSH_CHUNK])
                try:
                    n = self._inner.write(memoryview(chunk))
                except BlockingIOError:
                    self._inner.request_writable_event()
                    return False
                with self._lock:
                    del self._out[:n]

    def write(self, mv) -> int:
        # the whole chunk goes into one envelope: a short TCP write must
        # never split the framing
        data = bytes(mv)
        self._send_frame(_F_BYTES, data)
        return len(data)

    def writev(self, views) -> int:
        data = b"".join(views)
        self._send_frame(_F_BYTES, data)
        return len(data)

    def write_device_payload(self, arrays) -> bool:
        self._send_frame(_F_DEVICE, _encode_device_batch(list(arrays)))
        return True

    # ------------------------------------------------------------ inbound
    def _pump(self) -> None:
        """Drain the TCP socket and de-envelope every complete frame."""
        buf = bytearray(256 << 10)
        while True:
            try:
                n = self._inner.read_into(memoryview(buf))
            except BlockingIOError:
                break
            if n == 0:
                self._closed_read = True
                break
            self._inbuf += memoryview(buf)[:n]
        while len(self._inbuf) >= _HDR.size:
            ftype, length = _HDR.unpack_from(self._inbuf, 0)
            if length > _MAX_FRAME:
                raise ConnectionError(f"cudad frame of {length}B exceeds "
                                      "max")
            if len(self._inbuf) < _HDR.size + length:
                break
            payload = self._inbuf[_HDR.size:_HDR.size + length]
            del self._inbuf[:_HDR.size + length]
            if ftype == _F_BYTES:
                self._appbuf += payload
            elif ftype == _F_DEVICE:
                try:
                    self._lane.append(_decode_device_batch(payload))
                except (ValueError, struct.error) as e:
                    raise ConnectionError(f"cudad: bad device batch: {e}") \
                        from None
            elif ftype == _F_HELLO:
                try:
                    self.peer_info = json.loads(bytes(payload).decode())
                except ValueError:
                    raise ConnectionError("cudad: bad hello") from None
            else:
                raise ConnectionError(f"cudad: unknown frame type {ftype}")

    def read_into(self, mv: memoryview) -> int:
        self._pump()
        if self._appbuf:
            n = min(len(mv), len(self._appbuf))
            mv[:n] = self._appbuf[:n]
            del self._appbuf[:n]
            return n
        if self._closed_read:
            return 0
        raise BlockingIOError

    def take_device_payload(self):
        # no pump here: a batch precedes its frame's bytes on the stream,
        # so it was decoded by the read that brought the frame
        if not self._lane:
            return None
        return [t.to(self.device) for t in self._lane.popleft()]

    # ----------------------------------------------------------- plumbing
    def close(self) -> None:
        self._inner.close()

    def start_events(self, on_readable: Callable[[], None],
                     on_writable: Callable[[], None]) -> None:
        def writable():
            if self._flush():
                on_writable()
        self._inner.start_events(on_readable, writable)

    def request_writable_event(self) -> None:
        self._inner.request_writable_event()

    def pause_read_events(self) -> None:
        self._inner.pause_read_events()

    def resume_read_events(self) -> None:
        self._inner.resume_read_events()

    @property
    def local_endpoint(self) -> EndPoint:
        return self._local

    @property
    def remote_endpoint(self) -> EndPoint:
        return self._remote


class _CudadListener(Listener):
    def __init__(self, inner: Listener, ep: EndPoint):
        self._inner = inner
        self._ep = ep

    def stop(self) -> None:
        self._inner.stop()

    @property
    def endpoint(self) -> EndPoint:
        return self._ep


class CudadTransport(Transport):
    """``cudad://host:port#device=K``: the conn's device is where the
    batches it takes land (``cuda:0`` when the address names none)."""
    scheme = "cudad"

    def __init__(self):
        self._tcp = TcpTransport()

    def listen(self, ep: EndPoint, on_new_conn) -> Listener:
        device = resolve_device(ep.device)

        def wrap(conn: TcpConn):
            tcp_local = conn.local_endpoint
            local = EndPoint("cudad", tcp_local.host, tcp_local.port,
                             ep.extras)
            on_new_conn(CudadConn(conn, local, conn.remote_endpoint,
                                  device))

        inner = self._tcp.listen(
            EndPoint("tcp", ep.host or "127.0.0.1", ep.port, ep.extras),
            wrap)
        return _CudadListener(inner, EndPoint(
            "cudad", inner.endpoint.host, inner.endpoint.port, ep.extras))

    def connect(self, ep: EndPoint) -> Conn:
        device = resolve_device(ep.device)
        inner = self._tcp.connect(EndPoint("tcp", ep.host, ep.port,
                                           ep.extras))
        return CudadConn(inner, inner.local_endpoint, ep, device)
