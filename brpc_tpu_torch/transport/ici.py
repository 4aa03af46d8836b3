"""ici:// — the device lane between processes (the port of
brpc_tpu/transport/ici.py; the reference's RDMA slot, rdma_endpoint.h).

* **Bootstrap and control stream**: TCP, carrying 13-byte-framed
  control and application frames.
* **Hello** (the GID/QPN exchange, type 2, JSON): the process uuid
  (``proc``), the recv window, the byte ``budget``, ``max_batch`` and the
  device ordinal, with the reference's keys (``transfer_addr`` None,
  ``can_pull`` false: the port has no PjRt transfer server, and a
  brpc_tpu peer that saw ``can_pull`` would send a descriptor the port
  cannot pull). A port peer on a card adds ``"cuda_ipc": {"device":
  K}``; two port peers that both advertise it pull from each other over
  CUDA IPC. Between the port and brpc_tpu neither finds a common pull
  lane and both take the staged lane, as brpc_tpu does without a
  transfer server.
* **Device lane**, by peer:
  - same process (``local-d2d``): the batch waits in the in-process
    exchange (``_local_exchange``) and the taker gets the sender's
    tensors by reference (``.to`` its device when they are elsewhere),
    its stream waiting on the sender's event;
  - another process, both with ``cuda_ipc`` (``cuda-ipc``, in the place
    of ``pjrt-pull``): the sender records an interprocess event on the
    stream that produced the tensors, keeps them registered by uid
    until the peer's cumulative ACK covers the batch, and sends a type-6
    frame (only to a peer that advertised ``cuda_ipc``): per tensor its
    spec beside the allocation's IPC handle and the tensor's offset in
    it, and the event's handle (``transport/cuda_ipc.py``). The
    receiver reserves the batch's footprint in its ``DeviceRecvPool``,
    opens each handle, makes its stream wait on the sender's event,
    copies into tensors of its own and records an event; once that
    event has completed (the device poller's ``watch``) it closes the
    mappings and counts the batch consumed, so its ACK never lets the
    sender reuse memory a copy still reads. The request's fiber parks on
    that moment (the batch's ``ready``, ``device_ready``) before its
    handler runs;
  - otherwise (``staged``, type 4): the tensors' bytes in tpud's batch
    envelope (``cudad.py``), landed through the pinned stager
    (``butil/device_pool.py``).
* **Flow control**: at most ``window`` un-ACKed device batches a
  connection, and bytes in flight within the peer's advertised budget;
  every frame header piggybacks the cumulative consumed count, a bare
  ACK (type 3) goes once half the window is unacknowledged with no
  reverse traffic, and carries the receiver's adaptive grant (``u32``,
  from its pool's headroom); the idle-ACK timer (``ici_idle_ack_ms``)
  acknowledges a quiet connection's last batches. A window-stalled
  sender parks as a TCP-blocked one does.
* **Coalescing** (type 5): adjacent small batches (``ici_coalesce_bytes``,
  ``ici_coalesce_max``) of the exchange or the staged lane ride one
  frame, one exchange entry and one receiver reservation.
* **Leaks**: batches still registered when a connection closes go on a
  grace queue (``ici_reclaim_grace_s``: the peer may still take them)
  and are dropped after it; the un-ACKed pull registrations count per
  peer epoch and process-wide, and past a cap the pull lane gives way
  to the staged lane (``_note_leaked``, ``_pull_lane_allowed``).
  ``leak_snapshot`` is /device's pane of it. Unlike the PjRt lane, a
  registration here can be dropped, so the breaker counts the bytes
  still held, not every byte ever leaked.

Switches: ``BRPC_TPU_TORCH_ICI_FORCE_STAGED`` sends every cross-process
batch staged; ``BRPC_TPU_TORCH_ICI_REQUIRE_PULL`` turns a degradation to
the staged lane into a ConnectionError.

Frame format (all big-endian):
    type:u8  ack:u64  len:u32  payload[len]
    type 0 app bytes
    type 1 descriptor: uid:u64, count:u16, then per tensor
           {dtype_len:u8, dtype, rank:u8, dims:i64*rank, nbytes:u64}
    type 2 hello (JSON)
    type 3 bare ack (empty, or a u32 window grant)
    type 4 staged batch (tpud's batch envelope)
    type 5 coalesced group: mode:u8 (0 descriptor / 1 staged),
           count:u16, then mode 0: uid:u64 + per sub-batch
           {count:u16, specs as type 1}; mode 1: per sub-batch
           {len:u32, staged blob}
    type 6 cuda-ipc batch (port peers only): uid:u64, count:u16,
           event_len:u8, event handle, then per tensor
           {spec as type 1, handle_len:u8, handle, offset:u64}
Types 0-5 are byte for byte brpc_tpu's.
"""

from __future__ import annotations

import concurrent.futures
import itertools
import json
import logging
import os
import struct
import threading
import time
import uuid as uuidlib
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

import torch

from brpc_tpu_torch.butil import tensor_bytes
from brpc_tpu_torch.butil.device import resolve_device
from brpc_tpu_torch.butil.device_pool import (BLOCK_CLASSES, DeviceRecvPool,
                                              GroupReservation,
                                              global_pinned_stager,
                                              round_to_class)
from brpc_tpu_torch.butil.endpoint import EndPoint, device_spec
from brpc_tpu_torch.butil.flags import define_flag, flag as _flag
from brpc_tpu_torch.transport import cuda_ipc
from brpc_tpu_torch.transport import device_stats as _dev_stats
from brpc_tpu_torch.transport.base import Conn, Listener, Transport
from brpc_tpu_torch.transport.cudad import (_decode_device_batch,
                                            _encode_device_batch)
from brpc_tpu_torch.transport.tcp import TcpConn, TcpTransport

logger = logging.getLogger("brpc_tpu_torch.ici")

F_BYTES = 0
F_DESCRIPTOR = 1
F_HELLO = 2
F_ACK = 3
F_STAGED = 4
F_COALESCED = 5
F_IPC = 6
_HDR = struct.Struct(">BQI")
_MAX_FRAME = 256 << 20
_MAX_OUT = 64 << 20
DEFAULT_WINDOW = 32
# cap on framed-but-unwritten bytes a flush pass gathers before one write
_FLUSH_CHUNK = 1 << 20

_ENV_FORCE_STAGED = "BRPC_TPU_TORCH_ICI_FORCE_STAGED"
_ENV_REQUIRE_PULL = "BRPC_TPU_TORCH_ICI_REQUIRE_PULL"


def _force_staged() -> bool:
    return bool(os.environ.get(_ENV_FORCE_STAGED))


def _require_pull() -> bool:
    return bool(os.environ.get(_ENV_REQUIRE_PULL))


def _stager():
    return global_pinned_stager()


_PROC_UUID = uuidlib.uuid4().hex

# sender-side registry for same-process peers (uid -> (tensors, marks)),
# and for a closed connection's un-ACKed cuda-ipc batches on the grace
# queue
_local_exchange: Dict[int, tuple] = {}
_local_lock = threading.Lock()

_uuid_base = int.from_bytes(os.urandom(4), "big")
_uuid_counter = itertools.count(1)


def _next_uuid() -> int:
    return (_uuid_base << 32) | (next(_uuid_counter) & 0xFFFFFFFF)


# ------------------------------------------------------- the IPC lane
_lane_lock = threading.Lock()
_lane_probed = False
_lane_error: Optional[str] = None
_lane_status_var = None


def _publish_lane_status() -> None:
    """/vars ``ici_transfer_lane``: the lane's state, so a degradation
    shows rather than latching silently."""
    global _lane_status_var
    from brpc_tpu_torch.bvar.reducer import Status
    if _lane_status_var is None:
        _lane_status_var = Status("init").expose("ici_transfer_lane")
    _lane_status_var.set_value(transfer_lane_status())


def transfer_lane_status() -> str:
    """'up' | 'down: <reason>' | 'not started': the IPC lane of this
    process."""
    if not _lane_probed:
        return "not started"
    return "up" if _lane_error is None else f"down: {_lane_error}"


def _ipc_lane_up() -> bool:
    """Whether this process can export and import CUDA IPC handles,
    probed once (loudly: a warning and the bvar when it cannot)."""
    global _lane_probed, _lane_error
    if not _lane_probed:
        with _lane_lock:
            if not _lane_probed:
                _lane_error = cuda_ipc.probe()
                _lane_probed = True
                if _lane_error is not None:
                    logger.warning("ici: the CUDA IPC lane is down (%s): "
                                   "batches between processes take the "
                                   "staged lane", _lane_error)
        _publish_lane_status()
    return _lane_error is None


def _local_pull_reason(device: torch.device) -> Optional[str]:
    """Why this end cannot pull over CUDA IPC, or None."""
    if _force_staged():
        return f"{_ENV_FORCE_STAGED} is set"
    if device.type != "cuda":
        return "the connection's device is the host"
    if not _ipc_lane_up():
        return f"the CUDA IPC lane is down: {_lane_error}"
    return None


# shared default pool: one budget per process
_default_pool = DeviceRecvPool()


_lazy_adders: List["_LazyAdder"] = []


class _LazyAdder:
    """A counter whose bvar appears at first use; ``expose_ici_vars``
    (Server.start) re-exposes it after a test's ``unexpose_all``."""

    def __init__(self, name: str):
        self._name = name
        self._var = None
        _lazy_adders.append(self)

    def add(self, n: int) -> None:
        if self._var is None:
            from brpc_tpu_torch.bvar.reducer import Adder
            self._var = Adder().expose(self._name)
        self._var.add(n)

    def get_value(self) -> int:
        var = self._var
        return int(var.get_value()) if var is not None else 0

    def reexpose_counter(self) -> None:
        if self._var is not None:
            self._var.expose(self._name)


# un-ACKed cuda-ipc registrations at close: an upper bound (a batch the
# peer copied but had not acknowledged counts too)
_unpulled_registrations = _LazyAdder("ici_unpulled_registrations")
_unpulled_bytes = _LazyAdder("ici_unpulled_bytes")
# leaked = bytes a closing conn left registered (cuda-ipc batches and
# exchange entries, handed to the grace queue); reclaimed = bytes the
# grace sweep dropped or the peer took during the grace. leaked -
# reclaimed is the bytes still held.
_leaked_bytes_counter = _LazyAdder("ici_leaked_bytes")
_reclaimed_bytes_counter = _LazyAdder("ici_reclaimed_bytes")
_leaked_pull_bytes = [0]                    # held now, all epochs
_leaked_by_epoch: Dict[str, int] = {}       # peer proc uuid -> bytes
_LEAK_CAP_BYTES = int(os.environ.get(
    "BRPC_TPU_TORCH_ICI_PULL_LEAK_CAP", 256 << 20))     # a peer epoch
_LEAK_GLOBAL_CAP_BYTES = int(
    os.environ.get("BRPC_TPU_TORCH_ICI_PULL_LEAK_GLOBAL_CAP")
    or os.environ.get("BRPC_TPU_TORCH_ICI_PULL_LEAK_CAP")
    or (1 << 30))
_epoch_trips_logged: set = set()
_leak_breaker_logged = [False]


def _note_leaked(peer_epoch: Optional[str], nbytes: int) -> None:
    """Charge un-ACKed pull-registration bytes to the peer epoch that
    left them (under _local_lock)."""
    _leaked_pull_bytes[0] += nbytes
    if peer_epoch:
        _leaked_by_epoch[peer_epoch] = \
            _leaked_by_epoch.get(peer_epoch, 0) + nbytes
        if len(_leaked_by_epoch) > 4096:    # bound dead-epoch bookkeeping
            for k in sorted(_leaked_by_epoch,
                            key=_leaked_by_epoch.get)[:2048]:
                del _leaked_by_epoch[k]


def _unnote_leaked(peer_epoch: Optional[str], nbytes: int) -> None:
    """Credit back bytes the grace sweep dropped (under _local_lock)."""
    _leaked_pull_bytes[0] = max(0, _leaked_pull_bytes[0] - nbytes)
    if peer_epoch in _leaked_by_epoch:
        left = _leaked_by_epoch[peer_epoch] - nbytes
        if left > 0:
            _leaked_by_epoch[peer_epoch] = left
        else:
            del _leaked_by_epoch[peer_epoch]


def _pull_lane_allowed(peer_epoch: Optional[str] = None) -> bool:
    if _leaked_pull_bytes[0] >= _LEAK_GLOBAL_CAP_BYTES:
        if not _leak_breaker_logged[0]:
            _leak_breaker_logged[0] = True
            logger.warning(
                "ici: ~%d MB of un-ACKed cuda-ipc registrations held "
                "process-wide (global cap %d MB): every lane batch takes "
                "the staged lane until the grace sweep drops them",
                _leaked_pull_bytes[0] >> 20, _LEAK_GLOBAL_CAP_BYTES >> 20)
        return False
    _leak_breaker_logged[0] = False
    if peer_epoch and \
            _leaked_by_epoch.get(peer_epoch, 0) >= _LEAK_CAP_BYTES:
        if peer_epoch not in _epoch_trips_logged:
            _epoch_trips_logged.add(peer_epoch)
            logger.warning(
                "ici: peer epoch %s left ~%d MB of cuda-ipc "
                "registrations un-ACKed (cap %d MB): its batches take "
                "the staged lane until they are reclaimed or it "
                "reconnects under a fresh epoch",
                peer_epoch[:16], _leaked_by_epoch[peer_epoch] >> 20,
                _LEAK_CAP_BYTES >> 20)
        return False
    return True


define_flag("ici_reclaim_grace_s", 30.0,
            "seconds a closed connection's registered batches linger "
            "before they are dropped (the peer may still take them)")
define_flag("ici_idle_ack_ms", 2.0,
            "idle-ACK timer: a conn that consumed batches but has no "
            "reverse traffic sends a bare ACK after this many ms; <=0 "
            "disables")
define_flag("ici_coalesce_bytes", 16 << 10,
            "lane batches whose tensors total at most this many bytes "
            "may coalesce into one frame and one reservation; <=0 "
            "disables coalescing")
define_flag("ici_coalesce_max", 16,
            "max lane batches per coalesced frame")
define_flag("ici_adaptive_window", True,
            "receivers ride a window grant on bare ACKs sized from pool "
            "headroom: free pool -> 2x the hello window, pool under "
            "pressure -> window/4")


def _reclaim_grace_s() -> float:
    return float(_flag("ici_reclaim_grace_s"))


_reclaim_queue: Deque[Tuple[float, int]] = deque()
# uid -> (bytes charged to ici_leaked_bytes at close, epoch charged to
# the breaker or None): whichever way the entry leaves (swept, or taken
# by the peer during the grace) the bytes credit ici_reclaimed_bytes
# once (under _local_lock)
_grace_uid_bytes: Dict[int, Tuple[int, Optional[str]]] = {}


def _credit_grace(uid: int) -> int:
    """Under _local_lock: take ``uid`` off the grace ledger."""
    nb, epoch = _grace_uid_bytes.pop(uid, (0, None))
    if epoch is not None:
        _unnote_leaked(epoch, nb)
    return nb


def _sweep_reclaim(now: Optional[float] = None) -> None:
    """Drop expired grace entries (a timer close() sets, and close)."""
    now = time.monotonic() if now is None else now
    freed = 0
    with _local_lock:
        while _reclaim_queue and _reclaim_queue[0][0] <= now:
            _, uid = _reclaim_queue.popleft()
            _local_exchange.pop(uid, None)
            freed += _credit_grace(uid)
    if freed:
        _reclaimed_bytes_counter.add(freed)


def leak_snapshot() -> dict:
    """/device's leak pane: what the lane left registered, what came
    back, and where the breaker stands."""
    with _local_lock:
        by_epoch = len(_leaked_by_epoch)
        grace_queued = len(_reclaim_queue)
    leaked = _leaked_bytes_counter.get_value()
    reclaimed = _reclaimed_bytes_counter.get_value()
    return {
        "leaked_bytes": leaked,
        "reclaimed_bytes": reclaimed,
        "pinned_bytes_estimate": max(0, leaked - reclaimed),
        "leaked_pull_bytes": _leaked_pull_bytes[0],
        "unpulled_registrations": _unpulled_registrations.get_value(),
        "epochs_tracked": by_epoch,
        "grace_queue": grace_queued,
        "leak_cap_bytes": _LEAK_CAP_BYTES,
        "leak_global_cap_bytes": _LEAK_GLOBAL_CAP_BYTES,
        "pull_lane_tripped":
            _leaked_pull_bytes[0] >= _LEAK_GLOBAL_CAP_BYTES,
    }


def expose_ici_vars() -> None:
    """(Re-)expose the lane's bvars; Server.start calls it."""
    if _lane_status_var is not None:
        _lane_status_var.expose("ici_transfer_lane")
    else:
        _publish_lane_status()
    for adder in _lazy_adders:
        adder.reexpose_counter()


# --------------------------------------------------------------- codecs

def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _encode_spec(t) -> bytes:
    dt = tensor_bytes.dtype_name(t).encode()
    shape = tuple(int(s) for s in t.shape)
    parts = [struct.pack(">B", len(dt)), dt, struct.pack(">B", len(shape))]
    if shape:
        parts.append(struct.pack(f">{len(shape)}q", *shape))
    parts.append(struct.pack(">Q", _nbytes(t)))
    return b"".join(parts)


def _decode_spec(data, pos: int) -> Tuple[dict, int]:
    (dtlen,) = struct.unpack_from(">B", data, pos)
    pos += 1
    dtype = bytes(data[pos:pos + dtlen]).decode()
    pos += dtlen
    (rank,) = struct.unpack_from(">B", data, pos)
    pos += 1
    shape = struct.unpack_from(f">{rank}q", data, pos) if rank else ()
    pos += 8 * rank
    (nbytes,) = struct.unpack_from(">Q", data, pos)
    pos += 8
    return {"dtype": dtype, "shape": tuple(shape), "nbytes": nbytes}, pos


def _encode_descriptor(uid: int, arrays) -> bytes:
    parts = [struct.pack(">QH", uid, len(arrays))]
    for a in arrays:
        parts.append(_encode_spec(a))
    return b"".join(parts)


def _decode_descriptor(data) -> Tuple[int, List[dict]]:
    uid, count = struct.unpack_from(">QH", data, 0)
    pos = 10
    specs = []
    for _ in range(count):
        spec, pos = _decode_spec(data, pos)
        specs.append(spec)
    return uid, specs


def _encode_coalesced(uid: Optional[int], batches) -> bytes:
    """Type 5: N sub-batches in one frame. ``uid``: the group's one
    exchange entry (mode 0); None: staged (mode 1), each sub-batch's
    envelope inline."""
    if uid is None:
        parts = [struct.pack(">BH", 1, len(batches))]
        for arrays in batches:
            blob = _encode_device_batch(arrays)
            parts.append(struct.pack(">I", len(blob)))
            parts.append(blob)
    else:
        parts = [struct.pack(">BH", 0, len(batches)),
                 struct.pack(">Q", uid)]
        for arrays in batches:
            parts.append(struct.pack(">H", len(arrays)))
            for a in arrays:
                parts.append(_encode_spec(a))
    return b"".join(parts)


def _decode_coalesced(data):
    """-> ("staged", None, [blob, ...]) |
          ("pull", uid, [[spec, ...] per sub-batch])"""
    mode, count = struct.unpack_from(">BH", data, 0)
    pos = 3
    if mode == 1:
        blobs = []
        for _ in range(count):
            (ln,) = struct.unpack_from(">I", data, pos)
            pos += 4
            if pos + ln > len(data):
                raise ValueError("coalesced blob past the frame")
            blobs.append(data[pos:pos + ln])
            pos += ln
        return "staged", None, blobs
    if mode != 0:
        raise ValueError(f"coalesced mode {mode}")
    (uid,) = struct.unpack_from(">Q", data, pos)
    pos += 8
    groups = []
    for _ in range(count):
        (narr,) = struct.unpack_from(">H", data, pos)
        pos += 2
        specs = []
        for _ in range(narr):
            spec, pos = _decode_spec(data, pos)
            specs.append(spec)
        groups.append(specs)
    return "pull", uid, groups


def _encode_ipc(uid: int, event_handle: bytes, records) -> bytes:
    """Type 6: ``records`` are (tensor, handle, offset) per tensor; a
    zero-size tensor has an empty handle."""
    parts = [struct.pack(">QHB", uid, len(records), len(event_handle)),
             event_handle]
    for t, handle, offset in records:
        parts.append(_encode_spec(t))
        parts.append(struct.pack(">B", len(handle)))
        parts.append(handle)
        parts.append(struct.pack(">Q", offset))
    return b"".join(parts)


def _decode_ipc(data) -> Tuple[int, bytes, List[Tuple[dict, bytes, int]]]:
    """-> (uid, event handle, [(spec, handle, offset), ...]). The bytes
    come from a peer: each field is checked, nothing is unpickled."""
    uid, count, evlen = struct.unpack_from(">QHB", data, 0)
    pos = 11
    if evlen not in (0, cuda_ipc.HANDLE_BYTES):
        raise ValueError(f"an event handle of {evlen} bytes")
    event = bytes(data[pos:pos + evlen])
    pos += evlen
    recs = []
    for _ in range(count):
        spec, pos = _decode_spec(data, pos)
        (hlen,) = struct.unpack_from(">B", data, pos)
        pos += 1
        want = cuda_ipc.HANDLE_BYTES if spec["nbytes"] else 0
        if hlen != want:
            raise ValueError(f"a memory handle of {hlen} bytes for "
                             f"{spec['nbytes']} bytes")
        handle = bytes(data[pos:pos + hlen])
        pos += hlen
        (offset,) = struct.unpack_from(">Q", data, pos)
        pos += 8
        recs.append((spec, handle, offset))
    if pos != len(data):
        raise ValueError("trailing bytes in a cuda-ipc frame")
    return uid, event, recs


def _spec_tensor(spec: dict, device) -> torch.Tensor:
    """An empty tensor of ``spec`` on ``device``; its size must be the
    spec's ``nbytes``."""
    dtype = tensor_bytes.torch_dtype(spec["dtype"])
    t = torch.empty(spec["shape"], dtype=dtype, device=device)
    if _nbytes(t) != spec["nbytes"]:
        raise ValueError(f"{spec['nbytes']} bytes for {spec['dtype']}"
                         f"{list(spec['shape'])}")
    return t


def _record_marks(arrays) -> list:
    """An interprocess event on the current stream of each CUDA device of
    ``arrays`` (the writer's stream: what produced them); a peer in
    another process waits on it through its IPC handle."""
    marks = []
    for dev in {t.device for t in arrays if t.is_cuda}:
        stream = torch.cuda.current_stream(dev)
        ev = torch.cuda.Event(interprocess=True)
        ev.record(stream)
        marks.append((ev, stream))
    return marks


def _wait_marks(arrays, marks) -> None:
    """The taker's stream waits on the writer's events; tensors used on
    another stream than their writer's are recorded on it (cuda.py)."""
    for ev, src in marks:
        cur = torch.cuda.current_stream(src.device)
        cur.wait_event(ev)
        if cur != src:
            for t in arrays:
                if t.device == src.device:
                    t.record_stream(cur)


class LandedBatch(list):
    """The tensors of one cuda-ipc batch; ``ready`` is a Future set once
    their copy has run and the batch counts consumed, for a fiber to
    park on (``device_ready``): the response the handler sends then
    carries the batch's ACK."""

    __slots__ = ("ready",)


class _PendingTake:
    """A taken batch waiting to count consumed: ``event`` (None: at
    once) completes after its copy, ``maps`` are the handles of the
    peer's allocations to release then, ``ready`` the Future to set."""

    __slots__ = ("event", "maps", "device", "ready")

    def __init__(self, event, maps=(), device=0, ready=None):
        self.event = event
        self.maps = maps
        self.device = device
        self.ready = ready


class IciConn(Conn):
    """One ici:// connection: RdmaEndpoint's state machine re-expressed.

    Outbound items queue in FIFO (``_outq``), so a batch's frame can
    never overtake, or be overtaken by, the bytes of the RPC that
    references it; the window check happens at flush time on the queue
    head, so a stalled lane stalls everything behind it
    (rdma_endpoint.h:235-241)."""

    supports_device_lane = True
    # Socket.write_device_payload passes a stage tracker through to the
    # flush and ack legs (transport/device_stats.BatchTracker)
    supports_device_tracker = True
    # the TCP fd underneath is level-triggered: a short read drained it
    level_triggered = True

    def __init__(self, inner: TcpConn, local: EndPoint, remote: EndPoint,
                 device: torch.device, window: int = DEFAULT_WINDOW,
                 pool: Optional[DeviceRecvPool] = None):
        self._inner = inner
        self._local = local
        self._remote = remote
        self.device = device
        self._window = window                    # credits we grant the peer
        self._pool = pool or _default_pool
        self._lock = threading.Lock()
        self._flush_lock = threading.Lock()
        # the ingest state has one owner at a time: the read path and
        # the take path both reach it
        self._pump_lock = threading.Lock()
        # outbound FIFO: ("bytes", payload) | ("ctrl", ftype, payload) |
        # ("lane", tensors, tracker, marks)
        self._outq: Deque[Tuple] = deque()
        self._out_bytes = 0
        self._wirebuf = bytearray()              # framed, partly written
        # flush stamps (under _flush_lock): cumulative bytes written, and
        # (frame end, tracker) marks
        self._wire_written = 0
        self._wire_marks: Deque[Tuple[int, object]] = deque()
        self._inbuf = bytearray()
        self._appbuf = bytearray()
        self._lane: Deque[Tuple] = deque()       # inbound batches
        self._closed_read = False
        self._closed = False
        # an unsendable batch poisons the conn: no frame may follow it
        self._poisoned: Optional[str] = None
        # flow control, sender side (its own lock: the flush and the
        # pump paths both touch it)
        self._fc_lock = threading.Lock()
        self._sent = 0
        self._peer_acked = 0
        # un-ACKed batches in order: (footprint, tracker, the uid of a
        # cuda-ipc registration or 0)
        self._inflight_footprints: Deque[Tuple[int, object, int]] = \
            deque()
        self._inflight_bytes = 0
        self._issued_uids: List[int] = []
        # cuda-ipc batches registered until the peer's ACK covers them
        self._ipc_held: Dict[int, tuple] = {}
        # flow control, receiver side
        self._consumed = 0
        self._acked_sent = 0
        self._pending_takes: Deque[_PendingTake] = deque()
        self._peer_grant = 0
        self._idle_ack_armed = False
        self._idle_acks = 0
        self._coalesced_frames = 0
        self._coalesced_batches = 0
        self.peer_info: Optional[dict] = None
        self._hello_evt = threading.Event()
        self._want_writable = False
        self._on_writable_cb: Optional[Callable[[], None]] = None
        self._pull_reason = _local_pull_reason(device)
        if self._pull_reason is not None and _require_pull():
            raise ConnectionError(f"ici: {_ENV_REQUIRE_PULL} is set and "
                                  f"this end cannot pull: "
                                  f"{self._pull_reason}")
        hello = {
            "proc": _PROC_UUID,
            "transfer_addr": None,
            "window": self._window,
            # the per-connection recv byte budget (window x the largest
            # block class, capped by the pool): the sender's effective
            # window comes from it; max_batch is the largest batch the
            # receiver could ever admit
            "budget": min(self._pool.capacity,
                          self._window * BLOCK_CLASSES[-1]),
            "max_batch": self._pool.capacity,
            "device": device.index or 0,
            "can_pull": False,
        }
        if self._pull_reason is None:
            hello["cuda_ipc"] = {"device": device.index or 0}
        _dev_stats.global_device_stats().track_device_conn(self)
        self._enqueue(("ctrl", F_HELLO, json.dumps(hello).encode()))
        self._flush()

    # ----------------------------------------------------------- outbound
    def _enqueue(self, item: Tuple) -> None:
        with self._lock:
            if self._closed:
                # close() sets this under the same lock before it sweeps
                # the queued trackers: a late enqueue fails loudly
                raise ConnectionError("ici conn closed")
            if self._out_bytes > _MAX_OUT:
                raise BlockingIOError("ici out-buffer full")
            self._outq.append(item)
            if item[0] == "bytes":
                self._out_bytes += len(item[1])

    def _frame(self, ftype: int, payload: bytes) -> bytes:
        # every frame piggybacks the cumulative consumed count
        self._acked_sent = self._consumed
        return _HDR.pack(ftype, self._consumed, len(payload)) + payload

    @staticmethod
    def _batch_footprint(arrays) -> int:
        """The receiver's pool footprint for this batch."""
        return sum(round_to_class(_nbytes(a)) for a in arrays)

    def _apply_peer_ack(self, ack: int) -> None:
        """Advance the cumulative ACK and retire the matching FIFO
        entries: their cuda-ipc registrations are dropped, their
        trackers settle after _fc_lock is released."""
        acked_trackers = []
        with self._fc_lock:
            while self._peer_acked < ack and self._inflight_footprints:
                fp, tracker, held = self._inflight_footprints.popleft()
                self._inflight_bytes -= fp
                self._peer_acked += 1
                if held:
                    self._ipc_held.pop(held, None)
                if tracker is not None:
                    acked_trackers.append(tracker)
            self._peer_acked = max(self._peer_acked, ack)
        for tracker in acked_trackers:
            tracker.lane_acked()

    def _unsendable_reason(self, arrays) -> Optional[str]:
        """A batch larger than the peer's whole pool fails at the source
        instead of wedging the lane."""
        max_batch = int((self.peer_info or {}).get("max_batch") or 0)
        if max_batch:
            need = self._batch_footprint(arrays)
            if need > max_batch:
                return (f"ici: device batch footprint {need}B exceeds "
                        f"the peer's pool capacity {max_batch}B — "
                        f"unsendable (split the batch or raise the "
                        f"peer's DeviceRecvPool capacity)")
        return None

    def _staged_reason(self, info: dict) -> Optional[str]:
        """Why a batch to this cross-process peer would go staged, or
        None when it goes over CUDA IPC."""
        if self._pull_reason is not None:
            return self._pull_reason
        if not info.get("cuda_ipc"):
            return "the peer has no CUDA IPC lane"
        if not _pull_lane_allowed(info.get("proc")):
            return "the leak breaker tripped"
        return None

    def _effective_window(self, info: dict) -> int:
        """The hello window, or the grant the peer rode on a bare ACK
        (bounded to 4x the hello window)."""
        base = int(info.get("window", 1))
        grant = self._peer_grant
        if grant > 0:
            return max(1, min(grant, base * 4))
        return base

    def _lane_ready(self) -> bool:
        """May the queue-head batch go? Hello received, window, and the
        peer's byte budget (a batch over the budget goes alone once the
        lane drains)."""
        info = self.peer_info
        if info is None:
            return False
        budget = int(info.get("budget") or 0)
        need = self._batch_footprint(self._outq[0][1])
        window = self._effective_window(info)
        with self._fc_lock:
            if (self._sent - self._peer_acked) >= window:
                return False
            if (budget and self._inflight_bytes + need > budget
                    and self._inflight_bytes > 0):
                return False
        return True

    def _account(self, footprint: int, tracker, held: int = 0) -> None:
        with self._fc_lock:
            self._inflight_footprints.append((footprint, tracker, held))
            self._inflight_bytes += footprint
            self._sent += 1

    def _stage_lane_frame(self, item: Tuple) -> bytes:
        """A lane batch's frame: an exchange entry (same process), a
        cuda-ipc registration, or the staged envelope. The tracker
        stamps the end of the host stage here."""
        _, arrays, tracker, marks = item
        info = self.peer_info or {}
        staged = False
        held = 0                # a cuda-ipc batch's uid, held to its ACK
        if info.get("proc") == _PROC_UUID:
            uid = _next_uuid()
            with _local_lock:
                _local_exchange[uid] = (list(arrays), marks)
            self._issued_uids.append(uid)
            frame = self._frame(F_DESCRIPTOR,
                                _encode_descriptor(uid, arrays))
        else:
            reason = self._staged_reason(info)
            if reason is None:
                held = _next_uuid()
                frame = self._frame(F_IPC, self._ipc_payload(held, arrays,
                                                             marks))
                self._ipc_held[held] = (list(arrays), marks)
            elif _require_pull():
                raise ConnectionError(f"ici: {_ENV_REQUIRE_PULL} is set "
                                      f"and the batch would go staged: "
                                      f"{reason}")
            else:
                # the host copy runs here: after the writer's work
                _wait_marks(arrays, marks)
                frame = self._frame(F_STAGED, _encode_device_batch(arrays))
                staged = True
        if tracker is not None:
            tracker.lane_encoded(staged=staged)
        self._account(self._batch_footprint(arrays), tracker, held)
        return frame

    def _ipc_payload(self, uid: int, arrays, marks) -> bytes:
        """Type 6's payload: each tensor's allocation handle and offset,
        and the handle of the writer's interprocess event."""
        records = []
        for t in arrays:
            if _nbytes(t):
                handle, offset = cuda_ipc.export_tensor(t)
            else:
                handle, offset = b"", 0
            records.append((t, handle, offset))
        event = marks[0][0].ipc_handle() if marks else b""
        return _encode_ipc(uid, event, records)

    def _coalescible(self, it: Tuple, limit: int) -> bool:
        if sum(_nbytes(a) for a in it[1]) > limit:
            return False
        info = self.peer_info or {}
        # cuda-ipc batches go one a frame: each tensor has its own handle
        return info.get("proc") == _PROC_UUID or \
            self._staged_reason(info) is not None

    def _collect_coalesce(self, head: Tuple) -> Optional[List[Tuple]]:
        """Under _lock, with ``head`` (a lane item) just popped: take
        further small lane batches out of _outq to ride one coalesced
        frame. A later lane batch may move over byte frames (a batch
        only has to precede its own frame); an ineligible lane batch
        stops the scan, so lane batches keep their order."""
        limit = int(_flag("ici_coalesce_bytes"))
        nmax = int(_flag("ici_coalesce_max"))
        if limit <= 0 or nmax <= 1 or not self._outq:
            return None
        if not self._coalescible(head, limit):
            return None
        info = self.peer_info or {}
        budget = int(info.get("budget") or 0)
        window = self._effective_window(info)
        with self._fc_lock:
            slots = window - (self._sent - self._peer_acked) - 1
            room = (budget - self._inflight_bytes
                    - self._batch_footprint(head[1])) if budget else None
        if slots <= 0:
            return None
        extras: List[Tuple] = []
        keep: Deque[Tuple] = deque()
        while self._outq and len(extras) < nmax - 1 and slots > 0:
            it = self._outq.popleft()
            if it[0] != "lane":
                keep.append(it)
                continue
            fp = self._batch_footprint(it[1])
            if not self._coalescible(it, limit) \
                    or (room is not None and fp > room) \
                    or self._unsendable_reason(it[1]) is not None:
                keep.append(it)
                break
            extras.append(it)
            slots -= 1
            if room is not None:
                room -= fp
        while self._outq:
            keep.append(self._outq.popleft())
        self._outq = keep
        return extras or None

    def _stage_coalesced_frame(self, items: List[Tuple]) -> bytes:
        """One type-5 frame for N small batches: one exchange entry or
        staged frame, one receiver reservation; window, budget and
        trackers stay per sub-batch."""
        info = self.peer_info or {}
        batches = [it[1] for it in items]
        staged = False
        if info.get("proc") == _PROC_UUID:
            flat = [a for b in batches for a in b]
            marks = [m for it in items for m in it[3]]
            uid = _next_uuid()
            with _local_lock:
                _local_exchange[uid] = (flat, marks)
            self._issued_uids.append(uid)
            payload = _encode_coalesced(uid, batches)
        elif _require_pull():
            raise ConnectionError(f"ici: {_ENV_REQUIRE_PULL} is set and "
                                  f"the batches would go staged: "
                                  f"{self._staged_reason(info)}")
        else:
            staged = True
            for it in items:
                _wait_marks(it[1], it[3])
            payload = _encode_coalesced(None, batches)
        frame = self._frame(F_COALESCED, payload)
        for it in items:
            if it[2] is not None:
                it[2].lane_encoded(staged=staged)
        for it in items:
            self._account(self._batch_footprint(it[1]), it[2])
        with self._fc_lock:
            self._coalesced_frames += 1
            self._coalesced_batches += len(items)
        return frame

    def _flush(self) -> bool:
        """Drain wirebuf and the sendable queue items into TCP, one
        flusher at a time (two would interleave frames); True when all
        went. Every sendable item is framed before each write."""
        if self._poisoned is not None:
            raise ConnectionError(self._poisoned)
        with self._flush_lock:
            while True:
                if self._poisoned is not None:
                    raise ConnectionError(self._poisoned)
                stalled = self._frame_ready_items()
                if not self._wirebuf:
                    return not stalled
                while self._wirebuf:
                    mv = memoryview(self._wirebuf)
                    try:
                        n = self._inner.write(mv)
                    except BlockingIOError:
                        self._inner.request_writable_event()
                        return False
                    finally:
                        mv.release()
                    del self._wirebuf[:n]
                    self._wire_written += n
                    while self._wire_marks and \
                            self._wire_marks[0][0] <= self._wire_written:
                        # the frame's bytes all left for TCP
                        self._wire_marks.popleft()[1].lane_flushed()
                if stalled:
                    return False

    def _frame_ready_items(self) -> bool:
        """Frame every sendable _outq item into _wirebuf (under
        _flush_lock). True when the queue head is a batch waiting for
        credit (the caller parks for the ACK)."""
        while len(self._wirebuf) < _FLUSH_CHUNK:
            poison = None
            extras = None
            with self._lock:
                if not self._outq:
                    return False
                item = self._outq[0]
                if item[0] == "lane":
                    poison = self._unsendable_reason(item[1])
                    if poison is not None:
                        # the whole connection: a later frame must not
                        # pair with another RPC's batch on the receiver
                        self._outq.popleft()
                        self._poisoned = poison
                    elif not self._lane_ready():
                        self._want_writable = True
                        return True
                    else:
                        self._outq.popleft()
                        extras = self._collect_coalesce(item)
                else:
                    self._outq.popleft()
                    if item[0] == "bytes":
                        self._out_bytes -= len(item[1])
            if poison is not None:
                if item[2] is not None:
                    item[2].lane_failed(poison)
                raise ConnectionError(poison)
            if item[0] == "bytes":
                self._wirebuf += self._frame(F_BYTES, item[1])
            elif item[0] == "ctrl":
                self._wirebuf += self._frame(item[1], item[2])
            else:
                group = [item] + (extras or [])
                try:
                    if extras:
                        frame = self._stage_coalesced_frame(group)
                    else:
                        frame = self._stage_lane_frame(item)
                except (ConnectionError, cuda_ipc.CudaIpcError,
                        RuntimeError) as e:
                    # the batch cannot go as it must: poison, as for an
                    # unsendable batch
                    self._poisoned = f"ici: {e}"
                    for it in group:
                        if it[2] is not None:
                            it[2].lane_failed(self._poisoned)
                    raise ConnectionError(self._poisoned) from e
                self._wirebuf += frame
                end = self._wire_written + len(self._wirebuf)
                for it in group:
                    if it[2] is not None:
                        self._wire_marks.append((end, it[2]))
        return False

    def write(self, mv) -> int:
        if self._poisoned is not None:
            raise ConnectionError(self._poisoned)
        data = bytes(mv)
        self._enqueue(("bytes", data))
        self._flush()
        return len(data)

    def writev(self, views) -> int:
        return self.write(b"".join(views))

    def write_device_payload(self, arrays, tracker=None) -> bool:
        """Queue one batch. On a card, host tensors go to the conn's
        device first (as the reference device_puts them), every tensor
        is made contiguous, and an event is recorded on the writer's
        stream: the receiver's copy waits on it."""
        try:
            staged = []
            for t in arrays:
                tensor_bytes.check_tensor(t)
                if self.device.type == "cuda" and t.device != self.device:
                    t = t.to(self.device)
                staged.append(t.contiguous())
            marks = _record_marks(staged)
            if self._poisoned is not None:
                raise ConnectionError(self._poisoned)
            # fail at the call when the peer is already known (otherwise
            # the flush poisons the connection)
            reason = self._unsendable_reason(staged)
            if reason is None and _require_pull() and self.peer_info \
                    and self.peer_info.get("proc") != _PROC_UUID:
                why = self._staged_reason(self.peer_info)
                if why is not None:
                    reason = (f"ici: {_ENV_REQUIRE_PULL} is set and the "
                              f"batch would go staged: {why}")
            if reason is not None:
                raise ConnectionError(reason)
            self._enqueue(("lane", staged, tracker, marks))
        except (ConnectionError, BlockingIOError) as e:
            # the batch never entered a queue a sweep covers
            if tracker is not None:
                tracker.lane_failed(str(e))
            raise
        self._flush()
        return True

    # ------------------------------------------------------------ inbound
    def _pump(self) -> None:
        with self._pump_lock:
            fire = self._pump_locked()
        # the writable callback re-enters the write path: never under
        # _pump_lock
        if fire is not None:
            fire()

    def _pump_locked(self) -> Optional[Callable[[], None]]:
        """Drain and decode inbound frames; the writable callback to
        fire once _pump_lock is released, or None."""
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
        window_opened = False
        while len(self._inbuf) >= _HDR.size:
            ftype, ack, length = _HDR.unpack_from(self._inbuf, 0)
            if length > _MAX_FRAME:
                raise ConnectionError(f"ici frame of {length}B exceeds max")
            if len(self._inbuf) < _HDR.size + length:
                break
            payload = self._inbuf[_HDR.size:_HDR.size + length]
            del self._inbuf[:_HDR.size + length]
            if ack > self._peer_acked:
                self._apply_peer_ack(ack)
                window_opened = True
            try:
                window_opened |= self._ingest(ftype, payload)
            except (ValueError, struct.error) as e:
                raise ConnectionError(f"ici: bad frame of type {ftype}: "
                                      f"{e}") from None
        if window_opened:
            drained = self._flush()
            if drained and self._want_writable:
                self._want_writable = False
                return self._on_writable_cb
        return None

    def _ingest(self, ftype: int, payload: bytearray) -> bool:
        """One decoded frame; True when it may open the send window."""
        if ftype == F_BYTES:
            self._appbuf += payload
        elif ftype == F_DESCRIPTOR:
            uid, specs = _decode_descriptor(payload)
            self._lane.append(("pull", uid, specs))
        elif ftype == F_IPC:
            self._lane.append(("ipc", _decode_ipc(payload), None))
        elif ftype == F_STAGED:
            self._lane.append(("staged", payload, None))
        elif ftype == F_COALESCED:
            mode, uid, subs = _decode_coalesced(payload)
            # one group shared by its sub-entries: the first take
            # materializes it, later takes index into it
            group = {"mode": mode, "uid": uid, "subs": subs,
                     "out": None, "error": None}
            for i in range(len(subs)):
                self._lane.append(("coal", group, i))
        elif ftype == F_HELLO:
            try:
                self.peer_info = json.loads(bytes(payload).decode())
            except ValueError:
                raise ConnectionError("ici: bad hello") from None
            self._hello_evt.set()
            return True                  # the lane may wait for the hello
        elif ftype == F_ACK:
            # the header's ack is applied; the payload may carry a grant
            if len(payload) >= 4:
                (grant,) = struct.unpack_from(">I", payload, 0)
                self._peer_grant = grant
                return True
        else:
            raise ConnectionError(f"ici: unknown frame type {ftype}")
        return False

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

    def wait_hello(self, timeout_s: float) -> bool:
        """Wait for the peer's hello (``Channel.device_lane_kind``)."""
        return self._hello_evt.wait(timeout_s)

    def _ack_grant_payload(self) -> bytes:
        """The adaptive window grant on a bare ACK, from the pool's
        headroom: plenty -> 2x the hello window, under pressure -> down
        to window/4, so the blocking admission, not the wire, backs
        off."""
        if not _flag("ici_adaptive_window"):
            return b""
        cap = self._pool.capacity or 1
        frac = self._pool.available / cap
        if frac >= 0.5:
            grant = self._window * 2
        elif frac >= 0.25:
            grant = self._window
        else:
            grant = max(1, self._window // 4)
        return struct.pack(">I", grant)

    def _maybe_send_ack(self) -> None:
        """A bare ACK once half the window is unacknowledged and no
        frame has carried it (SendAck, rdma_endpoint.h:138)."""
        if self._consumed - self._acked_sent >= max(1, self._window // 2):
            try:
                self._enqueue(("ctrl", F_ACK, self._ack_grant_payload()))
                self._flush()
            except (BlockingIOError, ConnectionError):
                # a full out-buffer: the ack piggybacks later; a closed
                # or poisoned conn: a courtesy ack is worthless, and its
                # failure is the conn's, not the batch's
                return

    def _arm_idle_ack(self) -> None:
        """The idle-ACK timer: a quiet conn acknowledges its last
        batches without waiting for reverse traffic or close. Fires
        once; the next take re-arms it."""
        if self._closed or self._consumed <= self._acked_sent:
            return
        delay = float(_flag("ici_idle_ack_ms")) / 1000.0
        if delay <= 0:
            return
        with self._fc_lock:
            if self._idle_ack_armed:
                return
            self._idle_ack_armed = True
        from brpc_tpu_torch.fiber.timer import global_timer
        global_timer().schedule_after(delay, self._idle_ack_fire)

    def _idle_ack_fire(self) -> None:
        with self._fc_lock:
            self._idle_ack_armed = False
        if self._closed or self._consumed <= self._acked_sent:
            return          # a frame already carried the ack
        try:
            self._enqueue(("ctrl", F_ACK, self._ack_grant_payload()))
            self._idle_acks += 1
            self._flush()
        except (BlockingIOError, ConnectionError):
            pass            # full, poisoned or closed under the timer

    # ------------------------------------------------------ consumption
    def _note_consumed(self, pending: _PendingTake) -> None:
        """Count a taken batch consumed in arrival order, and only once
        its copy has run (``pending.event``; None: at once): the
        cumulative ACK tells the sender it may drop the batch."""
        with self._pump_lock:
            self._pending_takes.append(pending)
        if pending.event is None:
            self._drain_takes()
        else:
            from brpc_tpu_torch.fiber.device_poller import global_poller
            global_poller().watch(pending.event, self._drain_takes)

    def _drain_takes(self) -> None:
        done: List[_PendingTake] = []
        with self._pump_lock:
            q = self._pending_takes
            while q and (q[0].event is None or q[0].event.query()):
                done.append(q.popleft())
            self._consumed += len(done)
        for p in done:
            for handle in p.maps:
                try:
                    cuda_ipc.release(handle, p.device)
                except cuda_ipc.CudaIpcError:
                    logger.exception("ici: closing a peer's mapping")
            if p.ready is not None:
                p.ready.set_result(True)
        if done and not self._closed:
            self._maybe_send_ack()
            self._arm_idle_ack()

    # -------------------------------------------------------------- takes
    def _take_local(self, uid: int, target) -> list:
        """Same-process take: pop the exchange entry (a grace-queued one
        taken now was delivered, not leaked), then the tensors by
        reference, or ``.to`` the target."""
        with _local_lock:
            entry = _local_exchange.pop(uid, None)
            grace_credit = _credit_grace(uid) if entry is not None else 0
        if grace_credit:
            _reclaimed_bytes_counter.add(grace_credit)
        if entry is None:
            raise ConnectionError(
                "ici: same-process batch no longer available "
                "(sender closed and its registration was reclaimed)")
        arrays, marks = entry
        _wait_marks(arrays, marks)
        return [t if t.device == target else t.to(target) for t in arrays]

    def _pull_ipc(self, uid: int, event: bytes, recs, target
                  ) -> Tuple[LandedBatch, _PendingTake]:
        """Cross-process take over CUDA IPC: open each handle, make the
        current stream wait on the sender's event, copy into tensors of
        our own, record the event after the copies."""
        if target.type != "cuda":
            raise ConnectionError("ici: a cuda-ipc batch for a host "
                                  "connection")
        idx = target.index or 0
        out = LandedBatch()
        maps: List[int] = []
        cur = torch.cuda.current_stream(target)
        try:
            with torch.cuda.device(idx):
                if event:
                    cur.wait_event(torch.cuda.Event.from_ipc_handle(
                        target, event))
                for spec, handle, offset in recs:
                    dst = _spec_tensor(spec, target)
                    n = spec["nbytes"]
                    if n:
                        base, size = cuda_ipc.acquire(handle, idx)
                        maps.append(handle)
                        if offset + n > size:
                            raise ConnectionError(
                                f"ici: {n} bytes at offset {offset} of a "
                                f"{size}-byte allocation")
                        cuda_ipc.copy_async(dst.data_ptr(), base + offset,
                                            n, cur.cuda_stream, idx)
                    out.append(dst)
        except BaseException:
            # the mappings close once the copies queued so far have run
            done = torch.cuda.Event()
            done.record(cur)
            self._note_consumed(_PendingTake(done, maps, idx))
            raise
        done = torch.cuda.Event()
        done.record(cur)
        out.ready = concurrent.futures.Future()
        return out, _PendingTake(done, maps, idx, out.ready)

    def _materialize_coalesced(self, group: dict, target) -> List[list]:
        """First take of a coalesced group: one reservation for the
        group, one exchange pop or staged decode, split back into
        sub-batches; the reservation goes back when the group's last
        tensor dies."""
        info = self.peer_info or {}
        if group["mode"] == "staged":
            subs = [_decode_device_batch(blob) for blob in group["subs"]]
            footprint = sum(round_to_class(_nbytes(x))
                            for b in subs for x in b)
            res = self._pool.reserve_group(footprint)
            stager = _stager()
            try:
                outs = [[stager.land(x, target) for x in b] for b in subs]
            except BaseException:
                self._pool.release(res)
                raise
        else:
            if info.get("proc") != _PROC_UUID:
                raise ConnectionError("ici: an exchange group from a peer "
                                      "in another process")
            spec_groups = group["subs"]
            footprint = sum(round_to_class(s["nbytes"])
                            for g in spec_groups for s in g)
            res = self._pool.reserve_group(footprint)
            try:
                flat = self._take_local(group["uid"], target)
                outs = []
                pos = 0
                for g in spec_groups:
                    outs.append(list(flat[pos:pos + len(g)]))
                    pos += len(g)
            except BaseException:
                self._pool.release(res)
                raise
        holder = GroupReservation(self._pool, res,
                                  sum(len(o) for o in outs))
        for sub in outs:
            for t in sub:
                self._pool.attach_group_finalizer(t, holder)
        return outs

    def _take_coalesced(self, group: dict, idx: int, target) -> list:
        err = group.get("error")
        if err is not None:
            # one entry, one fate: every sub-batch fails as its group did
            raise ConnectionError(err)
        outs = group.get("out")
        if outs is None:
            try:
                outs = self._materialize_coalesced(group, target)
            except BaseException as e:
                group["error"] = \
                    f"ici: coalesced group materialization failed: {e}"
                raise
            group["out"] = outs
        return outs[idx]

    def take_device_payload(self):
        # no TCP pump here: a batch's frame precedes its message's bytes
        # on the wire, so the read that brought the bytes decoded it
        with self._pump_lock:
            if not self._lane:
                return None
            kind, a, b = self._lane.popleft()
        target = self.device
        if kind == "coal":
            out = self._take_coalesced(a, b, target)
            self._note_consumed(_PendingTake(None))
            return out
        footprints: List[int] = []
        pending = _PendingTake(None)
        try:
            # reserve inside the try: a partial reservation is released
            # when a later reserve or the copy raises. The staged lane
            # is held to the same admission as the pull lane.
            if kind == "staged":
                batch = _decode_device_batch(a)
                for x in batch:
                    footprints.append(self._pool.reserve(_nbytes(x)))
                stager = _stager()
                out = [stager.land(x, target) for x in batch]
            elif kind == "ipc":
                uid, event, recs = a
                for spec, _, _ in recs:
                    footprints.append(self._pool.reserve(spec["nbytes"]))
                out, pending = self._pull_ipc(uid, event, recs, target)
            else:
                uid, specs = a, b
                if (self.peer_info or {}).get("proc") != _PROC_UUID:
                    raise ConnectionError(
                        "ici: a pull descriptor from a peer in another "
                        "process (the port has no PjRt pull lane)")
                for s in specs:
                    footprints.append(self._pool.reserve(s["nbytes"]))
                out = self._take_local(uid, target)
        except BaseException:
            # the error escapes into the input path, which drops the
            # connection: the batch is lost with it and the sender learns
            # through the failure (RDMA's answer when rbufs cannot be
            # posted)
            for f in footprints:
                self._pool.release(f)
            raise
        for t, f in zip(out, footprints):
            self._pool.attach_finalizer(t, f)
        self._note_consumed(pending)
        return out

    # ----------------------------------------------------------- plumbing
    def close(self) -> None:
        if self._closed:
            return
        # acknowledge the batches whose copies have run, so the peer
        # drops them now rather than after its grace
        self._drain_takes()
        if self._consumed > self._acked_sent:
            try:
                self._enqueue(("ctrl", F_ACK, b""))
            except (BlockingIOError, ConnectionError):
                pass      # the flush below is as best-effort
        with self._lock:
            # _enqueue checks the flag under the same lock: no batch
            # slips into _outq after the sweep of queued trackers below
            if self._closed:
                return
            self._closed = True
        # best effort: frames the Socket counted written may still wait
        # here behind the window or TCP backpressure
        try:
            self._flush()
        except (ConnectionError, OSError):
            pass
        self._inner.close()
        peer_epoch = (self.peer_info or {}).get("proc")
        cross_proc = peer_epoch != _PROC_UUID
        with self._fc_lock:
            unacked = list(self._inflight_footprints)
        held_uids = {held for _, _, held in unacked if held}
        # registered batches go on the grace queue, not away at once: the
        # flush above may just have delivered their frames
        grace = _reclaim_grace_s()
        deadline = time.monotonic() + grace
        grace_bytes = 0
        leaked_pull = 0
        with _local_lock:
            for uid in self._issued_uids:
                entry = _local_exchange.get(uid)
                if entry is not None:
                    nb = sum(_nbytes(t) for t in entry[0])
                    _reclaim_queue.append((deadline, uid))
                    _grace_uid_bytes[uid] = (nb, None)
                    grace_bytes += nb
            for uid in held_uids:
                entry = self._ipc_held.pop(uid, None)
                if entry is not None and cross_proc:
                    nb = sum(_nbytes(t) for t in entry[0])
                    _local_exchange[uid] = entry
                    _reclaim_queue.append((deadline, uid))
                    _grace_uid_bytes[uid] = (nb, peer_epoch)
                    _note_leaked(peer_epoch, nb)
                    grace_bytes += nb
                    leaked_pull += nb
        self._issued_uids.clear()
        self._ipc_held.clear()
        if grace_bytes:
            _leaked_bytes_counter.add(grace_bytes)
            from brpc_tpu_torch.fiber.timer import global_timer
            # the sweep runs even if the lane is never used again
            global_timer().schedule_after(grace + 0.5, _sweep_reclaim)
        # batches still queued (window-gated, or behind a poisoned head)
        # never reached a frame: their trackers settle here
        with self._lock:
            queued_trackers = [item[2] for item in self._outq
                               if item[0] == "lane"
                               and item[2] is not None]
        for tracker in queued_trackers:
            tracker.lane_failed("connection closed before the batch "
                                "was flushed")
        # un-ACKed batches settle as failures; a cuda-ipc registration
        # the peer never acknowledged is a leak until the grace sweep
        outstanding = 0
        for fp, tracker, held in unacked:
            leak = bool(held) and cross_proc
            outstanding += leak
            if tracker is not None:
                tracker.lane_failed(
                    "connection closed with batch un-ACKed"
                    + (" (cuda-ipc registration held for the grace)"
                       if leak else ""), leaked=leak)
        if outstanding:
            _unpulled_registrations.add(outstanding)
            _unpulled_bytes.add(leaked_pull)
        _sweep_reclaim()
        # inbound batches never taken: their tensors are the peer's
        with self._pump_lock:
            self._lane.clear()

    def start_events(self, on_readable: Callable[[], None],
                     on_writable: Callable[[], None]) -> None:
        self._on_writable_cb = on_writable

        def writable():
            if self._flush():
                on_writable()

        self._inner.start_events(on_readable, writable)

    def request_writable_event(self) -> None:
        # the stall may be TCP backpressure or window credit: arm both
        self._want_writable = True
        self._inner.request_writable_event()

    def pause_read_events(self) -> None:
        self._inner.pause_read_events()

    def resume_read_events(self) -> None:
        self._inner.resume_read_events()

    def peek_closed(self) -> bool:
        return self._inner.peek_closed()

    @property
    def local_endpoint(self):
        return self._local

    @property
    def remote_endpoint(self):
        return self._remote

    @property
    def lane_kind(self) -> str:
        info = self.peer_info or {}
        if info.get("proc") == _PROC_UUID:
            return "local-d2d"
        if info and self._staged_reason(info) is None:
            return "cuda-ipc"
        return "staged"

    @property
    def outstanding_batches(self) -> int:
        with self._fc_lock:
            return self._sent - self._peer_acked

    def lane_introspection(self) -> dict:
        """One /device conn row: window occupancy, queue depths,
        buffered bytes."""
        info = self.peer_info or {}
        window = int(info.get("window") or self._window)
        with self._fc_lock:
            outstanding = self._sent - self._peer_acked
            inflight_bytes = self._inflight_bytes
            sent = self._sent
            coalesced_frames = self._coalesced_frames
            coalesced_batches = self._coalesced_batches
            held = len(self._ipc_held)
        with self._lock:
            outq_depth = len(self._outq)
            out_bytes = self._out_bytes
        effective = self._effective_window(info) if info else window
        buffered = len(self._wirebuf) + len(self._inbuf) \
            + len(self._appbuf) + out_bytes
        return {
            "remote": str(self._remote),
            "lane_kind": self.lane_kind,
            "device": str(self.device),
            "window": window,
            "effective_window": effective,
            "peer_grant": self._peer_grant,
            "outstanding_batches": outstanding,
            "window_occupancy": round(outstanding / effective, 3)
            if effective else 0.0,
            "inflight_bytes": inflight_bytes,
            "budget": int(info.get("budget") or 0),
            "batches_sent": sent,
            "ipc_registered": held,
            "pending_copies": len(self._pending_takes),
            "coalesced_frames": coalesced_frames,
            "coalesced_batches": coalesced_batches,
            "idle_acks": self._idle_acks,
            "enqueue_depth": outq_depth,
            "buffered_bytes": buffered,
            "want_writable": self._want_writable,
            "poisoned": self._poisoned,
            "closed": self._closed,
        }


class _IciListener(Listener):
    def __init__(self, inner: Listener, ep: EndPoint):
        self._inner = inner
        self._ep = ep

    def stop(self) -> None:
        self._inner.stop()

    @property
    def endpoint(self) -> EndPoint:
        return self._ep


class IciTransport(Transport):
    """``ici://host:port#device=K``: the conn's device is where the
    batches it takes land (``cuda:0`` when the address names none,
    ``cpu`` for the host); a client's ``#reply_device=K`` names its own,
    by default the address's."""
    scheme = "ici"

    def __init__(self, window: int = DEFAULT_WINDOW,
                 pool: Optional[DeviceRecvPool] = None):
        self._tcp = TcpTransport()
        self._window = window
        self._pool = pool

    def listen(self, ep: EndPoint, on_new_conn) -> Listener:
        device = resolve_device(ep.device)
        # probe the IPC lane here, in the caller's thread: accepted
        # conns are built on the dispatcher, which must not wait on it
        _local_pull_reason(device)

        def wrap(conn: TcpConn):
            tcp_local = conn.local_endpoint
            local = EndPoint("ici", tcp_local.host, tcp_local.port,
                             ep.extras)
            try:
                ici = IciConn(conn, local, conn.remote_endpoint, device,
                              window=self._window, pool=self._pool)
            except ConnectionError:
                # the require-pull switch refused it: drop the socket
                logger.exception("ici: refusing an accepted connection")
                conn.close()
                return
            on_new_conn(ici)

        inner = self._tcp.listen(
            EndPoint("tcp", ep.host or "127.0.0.1", ep.port, ep.extras),
            wrap)
        return _IciListener(inner, EndPoint(
            "ici", inner.endpoint.host, inner.endpoint.port, ep.extras))

    def connect(self, ep: EndPoint) -> Conn:
        device = resolve_device(device_spec(ep.extra("reply_device"))
                                or ep.device)
        inner = self._tcp.connect(EndPoint("tcp", ep.host, ep.port,
                                           ep.extras))
        try:
            return IciConn(inner, inner.local_endpoint, ep, device,
                           window=self._window, pool=self._pool)
        except BaseException:
            inner.close()
            raise
