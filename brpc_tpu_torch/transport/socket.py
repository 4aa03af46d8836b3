"""Socket: the connection object (the port of brpc_tpu/transport/socket.py,
its classic Python path; bRPC's socket.h, SURVEY.md §2.4).

- **Versioned ids**: every Socket lives in one ResourcePool; its
  ``SocketId`` goes stale at once on ``set_failed``
  (socket.cpp:776-800), so ``address_socket`` of an old id is None.
- **Writes**: ``write(data, on_done)`` pushes onto an MPSC queue and
  returns. The producer whose push finds no writer becomes the writer and
  drains the queue in its own context with non-blocking sends, merging
  the frames already queued into one ``sendmsg`` (socket.cpp:1924-2050).
  When the kernel takes no more, the rest of the batch parks with the
  writership (``_park_handoff``) on a one-shot writable event; the event
  starts a KeepWrite fiber that resumes it (socket.cpp:2066-2160). No
  thread ever blocks in a send. ``on_done(err)`` fires once per write,
  in order: with None once the kernel took the whole frame, or with the
  failure.
- **Input**: a readiness event bumps ``_nevent``; only its 0 -> 1 step
  starts a processing pass (StartInputEvent, socket.cpp:2527), which
  reads until EAGAIN into ``input_portal`` and hands the socket to
  ``on_input``. With ``socket_inline_process`` (the default) the pass
  runs on the dispatcher thread; ``on_input`` returns the last message's
  pending processing, if any, which goes on as a fiber stepped in place
  (``TaskControl.run_inline``) until it first suspends. Events that come
  while a pass is owed only count; the pass loops until the count is
  settled, and read interest pauses meanwhile.
- **Failure**: ``set_failed`` runs once: the id goes stale, the conn is
  unregistered and closed, a parked writer's batch and every queued write
  fail, and the ``on_failed`` callbacks fire; one subscribed after the
  end fires at once.

- **Device lane**: ``write_device_payload(arrays)`` hands a batch of
  tensors to the conn's lane and ``take_device_payload`` takes the oldest
  batch received (brpc_tpu/transport/socket.py:1007-1058, :1747-1791).
  Batches are paired with the frames that describe them by order alone,
  so a writer sends the batch and its frame as an adjacent pair under
  ``lane_lock``; ``Socket.write`` only queues, and on a conn without an
  fd (mem, cuda) the peer is told through the dispatcher
  (``EventDispatcher.post``), so nothing of the peer runs under the lock.
  Such a conn's readable event fires on the dispatcher as a TCP
  socket's does; it is not level-triggered and has no read interest to
  pause.

- **Device stats** (``transport/device_stats.py``): each batch written
  gets a stage tracker in the cell of its (peer, lane), and each batch
  taken is timed into the cell of its receive side.

Census: ``_socket_census`` (the ``sockets`` provider of ``/census``)
walks the live sockets of the id pool. The reference's native
fastcore, ring lane, sync pluck and per-row census (an activity stamp a
socket) are still to port (ROADMAP section 1).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Callable, Optional

from brpc_tpu_torch.butil.endpoint import EndPoint
from brpc_tpu_torch.butil.flags import define_flag, flag
from brpc_tpu_torch.butil.iobuf import (BIG_BLOCK_SIZE, DEFAULT_BLOCK_SIZE,
                                        IOBuf, IOPortal)
from brpc_tpu_torch.butil.resource_pool import ResourcePool, VersionedId
from brpc_tpu_torch.bvar.reducer import Adder
from brpc_tpu_torch.fiber import TaskControl, global_control
from brpc_tpu_torch.transport import device_stats as _device_stats
from brpc_tpu_torch.transport.base import Conn, get_transport

log = logging.getLogger("brpc_tpu_torch.transport")

define_flag("socket_inline_process", True,
            "process socket input in place on the event thread until the "
            "handler first suspends (input_messenger.cpp:183); off: every "
            "busy period gets a fiber")

# one gather write takes at most this many queued frames / bytes
_COALESCE_MAX_FRAMES = 32
_COALESCE_MAX_BYTES = 1 << 20

nwrites = Adder().expose("socket_writes")
nreads = Adder().expose("socket_read_bytes")
# bytes accepted by write() and not yet taken by the kernel, all sockets
nwqueue_bytes = Adder().expose("socket_wqueue_bytes")
# frames that left in a merged batch beyond its first: sends saved
ncoalesced = Adder().expose("socket_write_coalesced_frames")

SocketId = VersionedId

_pool: ResourcePool = ResourcePool()


def address_socket(sid: SocketId) -> Optional["Socket"]:
    """The live Socket of ``sid``; None once it failed."""
    return _pool.address(sid)


class _PyMpsc:
    """The write queue with writer-retire arbitration: ``push`` returns
    True when the caller became the writer; the writer drains in order
    and leaves through ``try_retire``, which refuses while items remain
    (socket.cpp StartWrite / IsWriteComplete)."""

    __slots__ = ("_q", "_lock", "_writing")

    def __init__(self):
        self._q = deque()
        self._lock = threading.Lock()
        self._writing = False

    def push(self, item) -> bool:
        with self._lock:
            self._q.append(item)
            if self._writing:
                return False
            self._writing = True
            return True

    def drain_one(self):
        with self._lock:
            return self._q.popleft() if self._q else None

    def try_retire(self) -> bool:
        with self._lock:
            if self._q:
                return False
            self._writing = False
            return True


def _fire(cb, err) -> None:
    if cb is not None:
        try:
            cb(err)
        except Exception:               # boundary: every callback runs
            log.exception("write on_done failed")


def _composite(cbs):
    """One on_done for a parked batch's unfired callbacks."""
    if not cbs:
        return None

    def comp(err):
        for c in cbs:
            _fire(c, err)
    return comp


class Socket:
    def __init__(self, conn: Conn, on_input: Optional[Callable] = None,
                 control: Optional[TaskControl] = None):
        """``on_input(socket)`` runs when bytes arrive; it returns None,
        or an awaitable that is the rest of its work
        (``InputMessenger.on_new_messages``)."""
        self.conn = conn
        self._control = control or global_control()
        self._on_input = on_input
        self.input_portal = IOPortal()
        self.failed = False
        self.fail_reason: Optional[BaseException] = None
        self._wq = _PyMpsc()
        # a parked writer's rest: (IOBuf, on_done). Non-None exactly while
        # the writership waits on a writable event; taking it (under the
        # lock) is taking the writership
        self._handoff = None
        self._handoff_lock = threading.Lock()
        self._nevent = 0
        self._nevent_lock = threading.Lock()
        self._busy_paused = False       # read interest paused (busy pass)
        self._read_hint = DEFAULT_BLOCK_SIZE
        self.preferred_protocol = -1    # the InputMessenger's memo
        # bytes the portal must hold before the next parse can succeed
        self.input_need = 0
        self.user_data: dict = {}       # owners' per-connection state
        self.wq_bytes = 0               # queued, not yet taken by the kernel
        self._on_failed_cbs: list = []
        self._failed_cb_lock = threading.Lock()
        # pairs a device-lane batch with its frame: batches are matched
        # to frames by order, so two writers must not interleave
        self.lane_lock = threading.Lock()
        self._inline_process = flag("socket_inline_process")
        self._level_triggered = getattr(conn, "level_triggered", False)
        self.id: SocketId = _pool.insert(self)
        try:
            conn.start_events(self._on_readable_event,
                              self._on_writable_event)
        except BaseException:
            # no fallback to a reader thread: the connection is refused
            _pool.remove(self.id)
            self.failed = True
            conn.close()
            raise

    # ----------------------------------------------------------- identity
    @property
    def remote_endpoint(self) -> Optional[EndPoint]:
        return self.conn.remote_endpoint

    @property
    def local_endpoint(self) -> Optional[EndPoint]:
        return self.conn.local_endpoint

    def write_backlog(self) -> int:
        """Bytes accepted by ``write`` and not yet taken by the kernel."""
        return max(0, self.wq_bytes)

    # -------------------------------------------------------------- write
    def write(self, data, on_done: Optional[Callable] = None) -> bool:
        """Queue ``data`` (bytes or IOBuf) behind every earlier write and
        return at once. False when the socket has failed: ``on_done``
        then fires at once with the reason, never a silent drop."""
        if self.failed:
            _fire(on_done, self.fail_reason)
            return False
        sz = data.size if isinstance(data, IOBuf) else len(data)
        nwrites.add(1)
        self.wq_bytes += sz
        nwqueue_bytes.add(sz)
        if not self._wq.push((data, on_done)):
            return True                 # the writer of the moment sends it
        self._drain_writes(None)
        return True

    def _pop(self):
        item = self._wq.drain_one()
        if item is not None:
            data = item[0]
            sz = data.size if isinstance(data, IOBuf) else len(data)
            self.wq_bytes -= sz
            nwqueue_bytes.add(-sz)
        return item

    def _cut_buf(self, buf: IOBuf) -> None:
        """Send what the kernel takes of ``buf``: one sendmsg for a chain,
        one send for a single ref; EAGAIN leaves the rest in ``buf``."""
        writev = getattr(self.conn, "writev", None)
        if writev is not None and buf.backing_block_count > 1:
            buf.cut_into_gather_writer(writev)
        else:
            buf.cut_into_writer(self.conn.write)

    def _drain_writes(self, first) -> None:
        """The writer's loop (the writership is this context's): send
        queued frames in order, a merged batch at a time, until the queue
        is empty (retire) or the kernel blocks (park the rest on the
        writable event). ``first`` is a parked batch taken back."""
        while True:
            if first is not None:
                batch, marks = first[0], [(first[0].size, first[1])]
                first = None
            else:
                item = self._pop()
                if item is None:
                    if self._wq.try_retire():
                        return
                    continue            # a racing push landed: go on
                batch, marks = IOBuf(), []
                total = 0
                while item is not None:
                    data, cb = item
                    if isinstance(data, IOBuf):
                        batch.append_buf(data)
                        total += data.size
                    elif data:
                        batch.append_user_data(data)
                        total += len(data)
                    marks.append((total, cb))
                    if total >= _COALESCE_MAX_BYTES or \
                            len(marks) >= _COALESCE_MAX_FRAMES:
                        break
                    item = self._pop()
                if len(marks) > 1:
                    ncoalesced.add(len(marks) - 1)
            if self.failed:
                for _, cb in marks:
                    _fire(cb, self.fail_reason)
                continue
            total = batch.size
            try:
                self._cut_buf(batch)
            except OSError as e:
                self.set_failed(e)
                for _, cb in marks:
                    _fire(cb, self.fail_reason)
                continue
            sent = total - batch.size
            unfired = []
            for end, cb in marks:
                if end <= sent:
                    _fire(cb, None)
                elif cb is not None:
                    unfired.append(cb)
            if not batch:
                continue
            if self._park_handoff(batch, _composite(unfired)):
                return
            # requesting the event failed: the socket is now failed; this
            # context still writes, so it fails the rest of the queue

    def _take_handoff(self):
        with self._handoff_lock:
            item, self._handoff = self._handoff, None
        if item is not None:
            sz = item[0].size
            self.wq_bytes -= sz
            nwqueue_bytes.add(-sz)
        return item

    def _park_handoff(self, rest: IOBuf, on_done) -> bool:
        """Park a blocked batch's rest, with the writership, on a one-shot
        writable event. False when the event could not be requested: the
        socket is failed then, ``on_done`` has fired, and the writership
        stays with the caller unless ``set_failed`` took it."""
        sz = rest.size
        with self._handoff_lock:
            self._handoff = (rest, on_done)
        self.wq_bytes += sz
        nwqueue_bytes.add(sz)
        try:
            self.conn.request_writable_event()
            return True
        except Exception as e:          # the conn closed under us
            took = self._take_handoff()
            self.set_failed(e)
            if took is None:
                return True             # set_failed drained it and the rest
            _fire(took[1], self.fail_reason)
            return False

    def _on_writable_event(self) -> None:
        """On the dispatcher: the kernel takes bytes again. A parked batch
        goes on in a KeepWrite fiber, off the event thread."""
        item = self._take_handoff()
        if item is not None:
            self._control.spawn(self._drain_writes, item, name="keep_write")

    # -------------------------------------------------------- device lane
    def _lane_cell(self, slot: str):
        """(lane, peer, cell) of this socket's device lane, cached in
        ``slot``; the lane kind can change once a hello lands, so the
        cache keys on it."""
        conn = self.conn
        lane = getattr(conn, "lane_kind", None) or \
            getattr(conn.remote_endpoint, "scheme", "device")
        cached = self.__dict__.get(slot)
        if cached is None or cached[0] != lane:
            peer = _device_stats.peer_key(conn.remote_endpoint)
            cached = (lane, peer, _device_stats.global_device_stats()
                      .device_cell(peer, lane))
            self.__dict__[slot] = cached
        return cached

    def write_device_payload(self, arrays, span=None) -> bool:
        """Send one batch of tensors on the conn's device lane; the caller
        holds ``lane_lock`` and writes the batch's frame next. With device
        stats on, the batch gets a stage tracker (and, under rpcz, a
        child span of ``span``, the owning RPC's): a conn with
        ``supports_device_tracker`` stamps it through its flush and ack
        legs; on any other the timeline settles around the call
        (brpc_tpu/transport/socket.py:1007-1058)."""
        if self.failed:
            raise ConnectionError(f"socket failed: {self.fail_reason}")
        tracker = None
        if _device_stats.enabled():
            lane, peer, cell = self._lane_cell("_dev_send")
            nbytes = sum(t.numel() * t.element_size() for t in arrays)
            tracker = _device_stats.open_transfer(peer, lane, nbytes,
                                                  parent_span=span,
                                                  cell=cell)
        if tracker is not None and \
                getattr(self.conn, "supports_device_tracker", False):
            try:
                return bool(self.conn.write_device_payload(
                    arrays, tracker=tracker))
            except BaseException as e:
                # the conn settles the failures it detects; one before
                # those checks must not strand an open record (a second
                # settle does nothing)
                tracker.lane_failed(f"{type(e).__name__}: {e}")
                raise
        try:
            r = self.conn.write_device_payload(arrays)
        except BaseException as e:
            if tracker is not None:
                tracker.lane_failed(f"{type(e).__name__}: {e}")
            raise
        if tracker is not None:
            # a loopback or staged conn delivers in the call: the whole
            # timeline settles here (stage = the call, ack = 0)
            tracker.lane_encoded()
            tracker.lane_flushed()
            tracker.lane_acked()
        return bool(r)

    def take_device_payload(self):
        """The oldest batch the lane delivered; None when none came. With
        device stats on, the take is timed into the lane's cell, and
        under rpcz the record ``last_device_take`` is left for the
        parser (brpc_tpu/transport/socket.py:1747-1781)."""
        if not _device_stats.enabled():
            return self.conn.take_device_payload()
        t0 = time.monotonic_ns()
        lane = self.conn.take_device_payload()
        if lane is None:
            return None
        dur_us = (time.monotonic_ns() - t0) / 1e3
        kind, peer, cell = self._lane_cell("_dev_recv")
        nbytes = sum(t.numel() * t.element_size() for t in lane)
        cell.note_recv(dur_us, nbytes)
        if flag("rpcz_enabled"):
            # parse per connection is sequential: the parser takes the
            # record before the next take can replace it
            self.last_device_take = {
                "peer": peer, "lane": kind, "recv_us": round(dur_us, 1),
                "nbytes": nbytes, "t_us": t0 // 1000}
        return lane

    def take_device_payload_with_recv(self):
        """(batch or None, recv record or None): the one parse-side way
        to take a batch, so the device-recv span's record cannot drift
        between protocols (brpc_tpu/transport/socket.py:1783)."""
        lane = self.take_device_payload()
        if lane is None:
            return None, None
        return lane, self.__dict__.pop("last_device_take", None)

    # -------------------------------------------------------------- input
    def _on_readable_event(self) -> None:
        """On the dispatcher thread; only the 0 -> 1 step starts a pass."""
        with self._nevent_lock:
            self._nevent += 1
            busy = self._nevent > 1
        if not busy:
            if self._inline_process:
                self._process_input_entry()
            else:
                self._control.spawn(self._process_input, name="socket_input")
            return
        # a pass is owed, maybe suspended in a handler: a dead peer must
        # still show now, and a level-triggered fd must not re-fire in a
        # hot loop until the pass settles (which resumes read interest)
        if getattr(self.conn, "peek_closed", lambda: False)():
            self._control.spawn(self.set_failed,
                                ConnectionResetError("peer closed"),
                                name="socket_failed")
        if self._level_triggered:
            with self._nevent_lock:
                if self._nevent > 0 and not self._busy_paused:
                    self._busy_paused = True
                    self.conn.pause_read_events()

    def _input_error(self, e: BaseException) -> None:
        # an escaping parse or process error must not wedge the socket
        # (_nevent would stay raised and no event would start a pass)
        log.exception("input processing failed; dropping the connection")
        self.set_failed(e if isinstance(e, Exception)
                        else ConnectionError(str(e)))

    def _process_input_entry(self) -> None:
        """The in-place pass: read and parse on this thread; the last
        message's pending processing continues as a fiber stepped here
        until it first suspends (``run_inline``), and the pass ends
        there, so the rest of its cycle is that fiber's."""
        while True:
            with self._nevent_lock:
                pending = self._nevent
            self._drain_readable()
            if self._on_input is not None and \
                    (self.input_portal or self.failed):
                r = None
                try:
                    r = self._on_input(self)
                except BaseException as e:
                    self._input_error(e)
                if r is not None:
                    self._control.run_inline(
                        self._input_async_tail(r, pending),
                        name="socket_input")
                    return
            if not self._finish_input_cycle(pending):
                return

    async def _input_async_tail(self, r, pending: int) -> None:
        try:
            await r
        except BaseException as e:
            self._input_error(e)
        if self._finish_input_cycle(pending):
            await self._process_input()

    async def _process_input(self) -> None:
        while True:
            with self._nevent_lock:
                pending = self._nevent
            self._drain_readable()
            if self._on_input is not None and \
                    (self.input_portal or self.failed):
                try:
                    r = self._on_input(self)
                    if r is not None:
                        await r
                except BaseException as e:
                    self._input_error(e)
            if not self._finish_input_cycle(pending):
                return

    def _finish_input_cycle(self, pending: int) -> bool:
        """Settle one pass; True when more events came (loop again)."""
        with self._nevent_lock:
            self._nevent -= pending
            if self._nevent > 0:
                return True
            if self._busy_paused:
                # under the same lock as the pause: the flag and the fd's
                # read interest never disagree
                self._busy_paused = False
                if not self.failed:
                    self.conn.resume_read_events()
        return False

    def _drain_readable(self) -> int:
        """Read until EAGAIN or EOF into the portal; the bytes read.
        Blocks grow to BIG_BLOCK_SIZE while reads fill them and shrink
        back on short reads (iobuf.h:469's effect without the iovec)."""
        total = 0
        while not self.failed:
            hint = self._read_hint
            try:
                n = self.input_portal.append_from_reader(self.conn.read_into,
                                                         hint=hint)
            except BlockingIOError:
                break
            except OSError as e:
                self.set_failed(e)
                break
            if n == 0:
                self.set_failed(ConnectionResetError("peer closed"))
                break
            if n >= hint:
                self._read_hint = BIG_BLOCK_SIZE
            elif n < 4096:
                self._read_hint = DEFAULT_BLOCK_SIZE
            total += n
            if self._level_triggered and n < 4096:
                # a short read drained the kernel buffer (every buffer
                # offered is at least 4 KiB); if not, the event fires again
                break
        if total:
            nreads.add(total)
        return total

    # ------------------------------------------------------------ failure
    def set_failed(self, reason: Optional[BaseException] = None) -> None:
        """Once: stale id, conn unregistered and closed, parked and queued
        writes failed, failure callbacks fired (SetFailed, socket.cpp)."""
        with self._failed_cb_lock:
            if self.failed:
                return
            self.failed = True
            self.fail_reason = reason or ConnectionError("socket failed")
            cbs, self._on_failed_cbs = self._on_failed_cbs, []
        _pool.remove(self.id)
        self.conn.close()
        # a parked writer is woken by no event now: take its writership
        # (the event continuation that loses the race does nothing) and
        # fail its batch and everything queued behind it
        item = self._take_handoff()
        if item is not None:
            self._drain_writes(item)
        for cb in cbs:
            try:
                cb(self)
            except Exception:           # boundary: every subscriber runs
                log.exception("on_failed callback failed")

    def on_failed(self, cb: Callable[["Socket"], None]) -> None:
        """``cb(socket)`` once the socket fails; at once if it has."""
        with self._failed_cb_lock:
            if not self.failed:
                self._on_failed_cbs.append(cb)
                return
        cb(self)

    def off_failed(self, cb: Callable[["Socket"], None]) -> None:
        with self._failed_cb_lock:
            try:
                self._on_failed_cbs.remove(cb)
            except ValueError:
                pass


def create_client_socket(ep: EndPoint, on_input: Optional[Callable] = None,
                         control: Optional[TaskControl] = None) -> Socket:
    conn = get_transport(ep.scheme).connect(ep)
    return Socket(conn, on_input=on_input, control=control)


def _socket_census() -> dict:
    """Census: every live socket of the process, client channels' too,
    with the server-side subset (the sockets /connections lists); a
    socket's bytes are its unparsed input and its queued output."""
    with _pool._lock:
        socks = [s for s in _pool._objs if s is not None and not s.failed]
    rows = [(s, s.input_portal.size + s.wq_bytes) for s in socks]
    srv = [b for s, b in rows if s.user_data.get("server") is not None]
    return {"bytes": sum(b for _, b in rows), "count": len(rows),
            "server_bytes": sum(srv), "server_count": len(srv)}


from brpc_tpu_torch.butil import resource_census as _census  # noqa: E402
#   (the census registration ships with the registry it measures)

_census.register("sockets", _socket_census)
