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

- **Native core** (``brpc_tpu_torch/native``, the port of
  brpc_tpu/transport/socket.py:98-185, :351-362, :531-570, :1301-1575):
  the write queue is fastcore's ``Mpsc`` (queues.cc) when the extension
  loads, ``_PyMpsc`` otherwise, with the same contract. The native fd
  loops read a refcounted dup of the conn's fd (``pin_fd_acquire`` /
  ``pin_fd_release``): a ``set_failed`` that closes the conn while a C
  loop sits in ``poll`` must not let the fd number go to a new
  connection whose bytes the loop would eat. ``fast_drain`` is a hook a
  server installs (``server_dispatch.make_fast_drain``) that serves a
  readable pass in C before the classic drain; ``pull_chunks`` is the
  chunk conns' (``mem://``) front half of such hooks.
- **Sync pluck lane** (``pluck_until``): a joining thread that is not a
  fiber worker takes this socket's input processing over until its call
  completes, so its response needs no dispatcher round trip and no
  cross-thread wake. The claim (``pluck_preclaim``, taken before the
  request is written) pauses read interest and makes dispatcher events
  count as owed; ``pluck_release`` settles them. With ``fast`` armed,
  fastcore's ``pluck_scan`` runs poll, recv and the frame scan in one C
  call a slice; a frame only the classic path can judge is put back
  into the portal and processed there (``_pluck_process``), and a pass
  whose handler suspends escalates to the normal machinery.
- **Sticky pause** (brpc_tpu/transport/socket.py:435-443, :964-1005,
  :1343-1410): a release that leaves nothing in flight (no attempt
  registered, no bound stream) leaves reads off (``_pluck_sticky``), so
  the next sync call's claim pays no ``epoll_ctl`` pair and, on the
  ring, no fence. The decision is made under the event lock and checks
  the socket's attempts again after it is set, while a registration
  adds its attempt before its write checks the mark (``write``
  unsticks): one of the two sides always sees the other. Every consumer
  that is not a pluck unsticks first (``unstick_reads``): a write, and
  a stream binding. With reads off nothing watches the fd, so a
  channel probes a socket that has been sticky for 5 ms or more before
  it reuses it (``probe_unobserved``, one ``MSG_PEEK``). Only a socket
  whose owner probes may stick (``sticky_ok``: a plain Channel's
  ``single`` and ``pooled`` sockets); a ClusterChannel's or a health
  check's never does, since they wait for a stopped replica's FIN with
  no call in flight.

- **Ring lane** (``transport/ring_lane.py``, brpc_tpu/transport/
  socket.py:455-466, :634, :872-930, :1139-1160, :1343-1380,
  :1463-1490): a ring-native conn's bytes come from the dispatcher's
  tick through ``ring_input``, which queues them on ``_ring_chunks``
  under the event lock and runs the input cycle as a readable event
  would; the pass that owns the input moves them into the portal
  (``_drain_readable``), so one context at a time touches the portal.
  A bytes frame written on the ring thread is deferred to the tick's
  flush (``try_defer_write``): ``ring_collect_writes`` hands the queued
  frames to one native gather write and ``ring_settle_write`` fires
  their callbacks, parks a short write's rest on the writable event or
  fails the socket. A sync claim (``pluck_preclaim``) on a ring-attached
  socket pauses its reads and then waits out the tick in flight
  (``ring_read_barrier``), and moves the chunks the ring took before the
  fence into the portal; a claim that finds reads already off (the
  sticky pause) pays none. On the uring backend sync joins take the
  event path.

Census: ``socket_census_rows`` is the one walk of every live socket of
the process (client channels' too): each row's resident bytes (unparsed
input and queued output) and idle seconds since the socket's activity
stamp (``last_active_ns``: a readable event, a ring delivery, a write),
memoized for 0.2 s. The ``sockets`` provider of ``/census``, its
``idle`` count (``census_idle_s``), the ``idle_conn_count`` and
``conn_resident_bytes_avg`` bvars and ``/connections``' rows all read
it (brpc_tpu/transport/socket.py:205-300).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from typing import Callable, Optional

from brpc_tpu_torch.butil.endpoint import EndPoint
from brpc_tpu_torch.butil.flags import define_flag, flag
from brpc_tpu_torch.butil.iobuf import (BIG_BLOCK_SIZE, DEFAULT_BLOCK_SIZE,
                                        IOBuf, IOPortal)
from brpc_tpu_torch.butil.resource_pool import ResourcePool, VersionedId
from brpc_tpu_torch.bvar.reducer import Adder, PassiveStatus
from brpc_tpu_torch.fiber import TaskControl, global_control
from brpc_tpu_torch.transport import device_stats as _device_stats
from brpc_tpu_torch.transport import syscall_stats as _syscall_stats
from brpc_tpu_torch.transport.base import Conn, get_transport
from brpc_tpu_torch.transport.ring_lane import (
    try_defer_write as _try_defer_write)

log = logging.getLogger("brpc_tpu_torch.transport")

define_flag("census_idle_s", 10.0,
            "a connection with no read or write for this long counts as "
            "idle on /census, /connections and the idle_conn_count bvar")
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
# the sync pluck lane: responses its native loop completed, frames it put
# back for the classic path, and pluck_scan calls (slices)
npluck_fast = Adder().expose("pluck_fast_responses")
npluck_defer = Adder().expose("pluck_defers")
npluck_scans = Adder().expose("pluck_scans")

SocketId = VersionedId

_pool: ResourcePool = ResourcePool()


def _postfork_reset() -> None:
    """Fork hygiene: the versioned-id pool addresses the parent's sockets
    (the child holds mere copies of their fds, registered with the
    parent's dispatcher), and the traffic counters count this process's
    sockets only (brpc_tpu/transport/socket.py:319-341); the census memo
    lists the parent's sockets."""
    global _pool, _rows_memo
    _pool = ResourcePool()
    _rows_memo = (0.0, [])
    for c in (nwrites, nreads, nwqueue_bytes, ncoalesced, npluck_fast,
              npluck_defer, npluck_scans):
        c.postfork_clear()


from brpc_tpu_torch.butil import postfork as _postfork  # noqa: E402

_postfork.register("transport.socket", _postfork_reset)


def address_socket(sid: SocketId) -> Optional["Socket"]:
    """The live Socket of ``sid``; None once it failed."""
    return _pool.address(sid)


class _PyMpsc:
    """The write queue with writer-retire arbitration, the fallback of
    fastcore's ``Mpsc`` with its contract: ``push`` returns True when the
    caller became the writer; the writer drains in order and leaves
    through ``try_retire``, which refuses while items remain (socket.cpp
    StartWrite / IsWriteComplete)."""

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

    def depth(self) -> int:
        return len(self._q)


# the extension resolves at the first socket, not at import: get() may
# compile it, and an import must stay cheap. False: not resolved yet
_fc_mod = False


def _fastcore():
    global _fc_mod
    if _fc_mod is False:
        from brpc_tpu_torch.native import fastcore
        _fc_mod = fastcore.get()
    return _fc_mod


def _new_mpsc():
    fc = _fastcore()
    return fc.Mpsc() if fc is not None else _PyMpsc()


def pull_chunks(sock):
    """The front half of the chunk lanes (``mem://``): the writer's own
    bytes objects off the conn, with the end-of-stream and accounting
    rules in one place. ``(data, handled)``: data None means nothing to
    scan, and then ``handled`` is what the hook returns (True: a
    spurious wake or the end, dealt with; False: not a chunk conn, and
    the hook disabled itself)."""
    rc = getattr(sock.conn, "read_chunks", None)
    if rc is None:
        sock.fast_drain = None
        return None, False
    chunks, eof = rc()
    if eof:
        sock.set_failed(ConnectionResetError("peer closed"))
        return None, True
    if not chunks:
        return None, True
    data = chunks[0] if len(chunks) == 1 else b"".join(chunks)
    nreads.add(len(data))
    return data, False


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
        self._wq = _new_mpsc()
        # a parked writer's rest: (IOBuf, on_done). Non-None exactly while
        # the writership waits on a writable event; taking it (under the
        # lock) is taking the writership
        self._handoff = None
        self._handoff_lock = threading.Lock()
        self._nevent = 0
        self._nevent_lock = threading.Lock()
        self._busy_paused = False       # read interest paused (busy pass)
        # a sync joiner owns input processing (the pluck lane)
        self._plucking = False
        # the sticky pause: reads left off by a settled pluck, and since
        # when (the probe's gate); only a socket whose owner probes
        # before reuse may stick
        self._pluck_sticky = False
        self._sticky_since = 0.0
        self.sticky_ok = False
        # the native fd loops' refcounted dup of the conn's fd
        self._pin_lock = threading.Lock()
        self._pin_fd = -1
        self._pin_refs = 0
        self._pin_closed = False
        # a server's native per-event hook (server_dispatch.make_fast_drain)
        # ``(socket) -> bool``, tried before the classic drain; True: the
        # pass was handled. It disables itself by setting this to None
        self.fast_drain: Optional[Callable] = None
        # the correlation ids of client attempts registered on this
        # socket and not yet ended, and the sync joiner plucking it with
        # its deadline unarmed (client_dispatch keeps both, under its
        # lock)
        self.client_cids: set = set()
        self.lazy_plucker = None
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
        # the last readable event, ring delivery or write (monotonic
        # ns): the idle class of /census and /connections
        self.last_active_ns = time.monotonic_ns()
        # the ring lane: bytes the tick read, queued under the event lock
        # for the pass that owns the input; _ring_fed marks a pass they
        # started (set before start_events: a completion can come before
        # _ring_attached is)
        self._ring_chunks: list = []
        self._ring_fed = False
        self._ring_attached = False
        self._ring_pluck_ok = True
        self.id: SocketId = _pool.insert(self)
        if getattr(conn, "supports_ring_sink", False):
            conn.ring_sink = self.ring_input
        try:
            conn.start_events(self._on_readable_event,
                              self._on_writable_event)
        except BaseException:
            # no fallback to a reader thread: the connection is refused
            _pool.remove(self.id)
            self.failed = True
            conn.close()
            raise
        self._ring_attached = getattr(conn, "ring_attached", False)
        self._ring_pluck_ok = getattr(conn, "ring_pluck_ok", True)

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

    # ---------------------------------------------------------- pinned fd
    def pin_fd_acquire(self) -> int:
        """The cached dup of the conn's fd for a native loop, or -1 (no
        fd, closed, the dup failed). The dup pins the kernel socket: a
        ``set_failed`` closes the conn's own fd while the loop may sit in
        ``poll`` without the interpreter lock. Balance with
        ``pin_fd_release``."""
        with self._pin_lock:
            if self._pin_closed:
                return -1
            if self._pin_fd < 0:
                pfd = getattr(self.conn, "pluck_fd", None)
                if pfd is None:
                    return -1
                try:
                    self._pin_fd = os.dup(pfd())
                except OSError:
                    return -1
            self._pin_refs += 1
            return self._pin_fd

    def pin_fd_release(self) -> None:
        with self._pin_lock:
            self._pin_refs -= 1
            self._close_pin_locked()

    def _close_pin_locked(self) -> None:
        if self._pin_refs == 0 and self._pin_closed and self._pin_fd >= 0:
            fd, self._pin_fd = self._pin_fd, -1
            try:
                os.close(fd)
            except OSError:
                pass

    def _pin_fd_shutdown(self) -> None:
        """``set_failed``'s half: the dup closes as soon as no loop holds
        it (a loop in flight sees the reset through it and releases; the
        last releaser closes)."""
        with self._pin_lock:
            self._pin_closed = True
            self._close_pin_locked()

    # -------------------------------------------------------------- write
    def write(self, data, on_done: Optional[Callable] = None) -> bool:
        """Queue ``data`` (bytes or IOBuf) behind every earlier write and
        return at once. False when the socket has failed: ``on_done``
        then fires at once with the reason, never a silent drop."""
        if self.failed:
            _fire(on_done, self.fail_reason)
            return False
        if self._pluck_sticky and not self._plucking:
            # a writer that is not a pluck: its answer, or the peer's
            # data, needs read events again
            self.unstick_reads()
        sz = data.size if isinstance(data, IOBuf) else len(data)
        nwrites.add(1)
        self.last_active_ns = time.monotonic_ns()
        # graftlint: disable=guarded-by -- wq_bytes is approximate
        # accounting beside the wait-free write queue: a lock here would sit
        # on every write of every thread, and drift only skews a gauge
        # (write_backlog, the census), never the queue itself.
        self.wq_bytes += sz
        nwqueue_bytes.add(sz)
        if not self._wq.push((data, on_done)):
            return True                 # the writer of the moment sends it
        if self._ring_attached and type(data) is bytes and \
                _try_defer_write(self):
            # on the ring thread in a tick: the writership goes to the
            # tick's flush, one gather write a connection
            return True
        self._drain_writes(None)
        return True

    def ring_collect_writes(self):
        """The ring flush's collect half (on the ring thread, with the
        writership the deferring push claimed): queued frames as a list
        of buffers and their end marks, for one native gather write,
        capped as a merged batch is. ``(views, marks, total)``."""
        views, marks, total = [], [], 0
        while total < _COALESCE_MAX_BYTES and \
                len(marks) < _COALESCE_MAX_FRAMES:
            item = self._pop()
            if item is None:
                break
            data, cb = item
            if isinstance(data, IOBuf):
                # a racing producer's IOBuf behind a deferred frame: fd
                # conns carry no device blocks, so it flattens
                data = data.to_bytes()
            if len(data):
                views.append(data)
                total += len(data)
            marks.append((total, cb))
        if len(marks) > 1:
            ncoalesced.add(len(marks) - 1)
        return views, marks, total

    def ring_settle_write(self, res: int, errcode: int, views, marks,
                          total: int) -> bool:
        """The settle half: callbacks of the frames sent fire, a short
        write's rest parks on the writable event with the writership, an
        error fails the socket (``_drain_writes``' contract, split so
        that the syscall runs in the tick's native batch). False when
        the socket failed."""
        if errcode:
            e = ConnectionError(f"ring writev: {os.strerror(errcode)}")
            self.set_failed(e)
            for _, cb in marks:
                _fire(cb, e)
            # the writership is still ours: fail what queued behind
            self._drain_writes(None)
            return False
        unfired = []
        for end, cb in marks:
            if end <= res:
                _fire(cb, None)
            elif cb is not None:
                unfired.append(cb)
        if res >= total:
            self._drain_writes(None)    # what queued meanwhile, retire
            return True
        rest, off = IOBuf(), 0
        for v in views:
            lv = len(v)
            if off + lv > res:
                start = res - off if res > off else 0
                rest.append_user_data(v[start:] if start else v)
            off += lv
        if self._park_handoff(rest, _composite(unfired)):
            return True
        self._drain_writes(None)        # failed, writership kept: fail on
        return False

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
        self.last_active_ns = time.monotonic_ns()
        with self._nevent_lock:
            self._nevent += 1
            # a plucking joiner owns the input: events defer to it as
            # they do to a busy pass
            busy = self._nevent > 1 or self._plucking
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

    def ring_input(self, data, eof: bool = False, err: int = 0) -> None:
        """The ring's sink (on the ring thread): the tick already read
        ``data``; queue it and run the input cycle as a readable event
        does, the fd drain left out. A busy pass gets the bytes at its
        next turn, and its reads pause for the rest of it."""
        self.last_active_ns = time.monotonic_ns()
        if data:
            nreads.add(len(data))
        with self._nevent_lock:
            if data:
                self._ring_chunks.append(data)
            self._nevent += 1
            busy = self._nevent > 1 or self._plucking
            if not busy:
                self._ring_fed = True
            elif data and self._level_triggered and \
                    not self._busy_paused:
                self._busy_paused = True
                try:
                    self.conn.pause_read_events()
                except Exception:       # closed under us
                    self._busy_paused = False
        if eof or err:
            e = (ConnectionResetError("peer closed") if eof
                 else ConnectionError(f"ring recv: {os.strerror(err)}"))
            if busy:
                # the owning pass may sit in a suspended handler: the
                # failure must not wait for it, nor run its callbacks
                # on the ring thread
                self._control.spawn(self.set_failed, e,
                                    name="socket_failed")
                return
            self.set_failed(e)
        if busy:
            return
        if self._inline_process:
            self._process_input_entry()
        else:
            self._control.spawn(self._process_input, name="socket_input")

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
            fde = self.fast_drain
            if fde is not None and not self.failed:
                handled = False
                try:
                    handled = fde(self)
                except BaseException as e:
                    self._input_error(e)
                if handled:
                    if not self._finish_input_cycle(pending):
                        return
                    continue
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
            if self._busy_paused and not self._plucking:
                # under the same lock as the pause: the flag and the fd's
                # read interest never disagree. A plucker keeps the pause
                # (its release restores read interest)
                self._busy_paused = False
                self._pluck_sticky = False
                if not self.failed:
                    self.conn.resume_read_events()
        return False

    def _drain_readable(self) -> int:
        """Read until EAGAIN or EOF into the portal; the bytes read.
        Blocks grow to BIG_BLOCK_SIZE while reads fill them and shrink
        back on short reads (iobuf.h:469's effect without the iovec)."""
        ring_total = 0
        if self._ring_fed or self._ring_attached or self._ring_chunks:
            # the tick is this fd's only reader: take what it queued, in
            # order
            self._ring_fed = False
            with self._nevent_lock:
                chunks, self._ring_chunks = self._ring_chunks, []
            for c in chunks:
                self.input_portal.append_user_data(c)
                ring_total += len(c)
            if not (self._plucking and self._busy_paused):
                return ring_total
            # a pluck claim paused the ring's reads and fenced its tick:
            # the plucker reads the fd now, behind the queued chunks
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
        return total + ring_total

    # ---------------------------------------------------- sync pluck lane
    def pluck_preclaim(self) -> bool:
        """Claim the pluck lane, before the request is written: with
        reads paused first, the dispatcher cannot win the race to the
        response. True when claimed; the caller hands the claim to
        ``pluck_until(preclaimed=True)`` or gives it back with
        ``pluck_release``."""
        if getattr(self.conn, "pluck_fd", None) is None \
                or self._on_input is None or self.failed:
            return False
        if self._ring_attached and not self._ring_pluck_ok:
            # uring: a recv in the kernel cannot be fenced
            return False
        with self._nevent_lock:
            if self._nevent > 0 or self._plucking:
                return False
            self._plucking = True
            # a sticky pause is consumed here: reads are off already, so
            # the claim pays no epoll_ctl and no fence
            self._pluck_sticky = False
            reads_were_live = not self._busy_paused
            if self._level_triggered and not self._busy_paused:
                self._busy_paused = True
                try:
                    self.conn.pause_read_events()
                except Exception:       # the conn closed under us
                    self._busy_paused = False
        if self._ring_attached and reads_were_live:
            # fence the tick in flight (outside the event lock: it may be
            # delivering to this socket now), then take over what it read
            self.conn.ring_read_barrier()
            if self._ring_chunks:
                with self._nevent_lock:
                    chunks, self._ring_chunks = self._ring_chunks, []
                for c in chunks:
                    self.input_portal.append_user_data(c)
        return True

    def pluck_release(self) -> None:
        """Settle a claim: events owed meanwhile get one normal pass, and
        read interest comes back, unless nothing is in flight on a socket
        that may stick (the sticky pause)."""
        stuck = False
        with self._nevent_lock:
            if not self._plucking:
                return
            self._plucking = False
            leftover = self._nevent > 0
            if self._busy_paused and not leftover:
                if self.sticky_ok and not self.failed and \
                        not self.client_cids and \
                        not self.user_data.get("bound_streams"):
                    self._pluck_sticky = stuck = True
                    self._sticky_since = time.monotonic()
                else:
                    self._resume_reads_locked()
        if stuck and (self.client_cids or
                      self.user_data.get("bound_streams")):
            # an attempt registered between the check and the mark: its
            # write may have missed the mark, so unstick for it
            self.unstick_reads()
        if leftover and not self.failed:
            self._process_input_entry()

    def _resume_reads_locked(self) -> None:
        """Read interest back on (under the event lock)."""
        self._busy_paused = False
        if not self.failed:
            try:
                self.conn.resume_read_events()
            except Exception:           # closed under us
                pass

    def unstick_reads(self) -> None:
        """Read interest back on after a sticky pause; idempotent, and a
        pause that a live plucker owns stays."""
        with self._nevent_lock:
            if not self._pluck_sticky:
                return
            self._pluck_sticky = False
            if self._busy_paused and not self._plucking:
                self._resume_reads_locked()

    def probe_unobserved(self) -> bool:
        """True when this socket is (now) failed. A sticky pause leaves
        nothing watching the fd, so a peer's FIN would go unseen: an
        owner about to reuse the socket probes it here, with one
        ``MSG_PEEK``, when it has been sticky for 5 ms or more (a close
        within back-to-back sync calls shows in the pluck's own read)."""
        if self.failed:
            return True
        if not self._pluck_sticky or \
                time.monotonic() - self._sticky_since < 0.005:
            return False
        peek = getattr(self.conn, "peek_closed", None)
        if peek is not None and peek():
            self.set_failed(ConnectionResetError("peer closed"))
            return True
        return False

    def _pluck_process(self) -> bool:
        """One drain and parse pass on the plucking thread. True when it
        escalated: a message's processing suspended, and the pass (with
        its owed events) went to the normal machinery; the plucker
        stops."""
        with self._nevent_lock:
            pending = self._nevent
        self._drain_readable()
        if self.input_portal or self.failed:
            r = None
            try:
                r = self._on_input(self)
            except BaseException as e:
                self._input_error(e)
            if r is not None:
                # one more owed event keeps the pass busy through the
                # hand-off: a dispatcher event in between must not start
                # a second pass over the same portal
                with self._nevent_lock:
                    self._nevent += 1
                    self._plucking = False
                self._control.run_inline(
                    self._input_async_tail(r, pending + 1),
                    name="socket_input")
                return True
        if pending:
            self._finish_input_cycle(pending)
        return False

    # graftlint: disable=judge-defer -- the defer exit here is re-injection,
    # not a return: frames the native scan cannot judge go back into
    # input_portal and through _pluck_process, the classic machinery, before
    # pluck_until returns pred().
    def pluck_until(self, pred, deadline_s: float, fast=None,
                    preclaimed: bool = False) -> bool:
        """The sync pluck lane: the calling thread (not a fiber worker)
        processes this socket's input until ``pred()`` or the monotonic
        ``deadline_s``; returns ``pred()``. Claims only when no pass is
        in flight (unless ``preclaimed``).

        ``fast=(magic, cid, max_body, on_resp)`` arms fastcore's
        ``pluck_scan``: poll, recv and the frame scan in one C call a
        slice, and the response for ``cid`` completes through
        ``on_resp(cid, ec, et, payload, att, socket)``. What only the
        classic path can judge (another call's frame, a meta the scanner
        defers, bytes behind the response) goes back into the portal and
        through ``_pluck_process``, so the lanes cannot differ."""
        if not preclaimed and not self.pluck_preclaim():
            return pred()
        pfd = getattr(self.conn, "pluck_fd", None)
        try:
            fd = pfd() if pfd is not None else -1
        except OSError:
            fd = -1
        if fd < 0:
            self.pluck_release()
            return pred()
        scan = None
        dup_fd = -1
        if fast is not None and not self.input_portal \
                and not self.input_need and not self._ring_chunks:
            fc = _fastcore()
            scan = getattr(fc, "pluck_scan", None) if fc is not None \
                else None
            if scan is not None:
                dup_fd = self.pin_fd_acquire()
                if dup_fd < 0:
                    scan = None
        poller = None
        escalated = False
        carry = b""
        # bytes already in the portal (a claim takes over what the fenced
        # tick read) may hold the whole response, and then the fd stays
        # quiet: judge them before waiting on it
        judge = bool(self.input_portal)
        try:
            while not pred() and not self.failed:
                remaining = deadline_s - time.monotonic()
                if remaining <= 0:
                    break
                if judge or (self._ring_chunks and not carry):
                    # a ring delivery slipped past the fence: those bytes
                    # come before anything in the kernel, so the classic
                    # pass judges them and the scan stands down
                    judge = False
                    scan = None
                    escalated = self._pluck_process()
                    if escalated:
                        break
                    continue
                # short slices: pred() can turn without traffic (the
                # deadline timer, another thread completing the call)
                slice_s = min(remaining, 0.2)
                if scan is not None:
                    magic, cid, max_body, on_resp = fast
                    npluck_scans.add(1)
                    r = scan(dup_fd, magic, cid, int(slice_s * 1000) + 1,
                             max_body, carry)
                    tag, nr = r[0], r[-1]
                    if nr:
                        nreads.add(nr)
                    if tag == 2:            # slice over: keep the carry
                        carry = r[1]
                        continue
                    carry = b""
                    if tag == 0:            # the response for cid
                        npluck_fast.add(1)
                        _syscall_stats.note_rpc_messages(1)
                        _, ec, et, payload, att, leftover, _nr = r
                        if leftover:
                            self.input_portal.append_user_data(leftover)
                        on_resp(cid, ec, et, payload, att, self)
                        if not self.input_portal:
                            continue
                        scan = None         # bytes behind it: classic
                    elif tag == 1:          # defer: the classic path
                        npluck_defer.add(1)
                        if r[1]:
                            self.input_portal.append_user_data(r[1])
                        scan = None
                    else:                   # 3: the end or an error
                        scan = None
                        if r[2]:
                            # frames that came before it still count,
                            # as the classic drain would take them
                            self.input_portal.append_user_data(r[2])
                        else:
                            if not pred():
                                self.set_failed(ConnectionError(r[1]))
                            continue
                    escalated = self._pluck_process()
                    if escalated:
                        break
                    continue
                if poller is None:
                    import select
                    poller = select.poll()
                    poller.register(fd, select.POLLIN | select.POLLHUP
                                    | select.POLLERR)
                if not poller.poll(slice_s * 1000):
                    continue
                escalated = self._pluck_process()
                if escalated:
                    break
        finally:
            if dup_fd >= 0:
                self.pin_fd_release()
            if carry:
                # a partial frame the C loop read: back into the portal;
                # its rest arrives with a readable event
                self.input_portal.append_user_data(carry)
            if not escalated:
                self.pluck_release()
        return pred()

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
        # the dup must not outlive the close (it would hold the FIN back)
        self._pin_fd_shutdown()
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


_rows_memo = (0.0, [])      # (expires, rows); swapped whole


def socket_census_rows(max_age_s: float = 0.2):
    """``[(socket, resident bytes, idle seconds)]`` of every live socket,
    client channels' too: the one accounting that ``/census``,
    ``/connections`` and the census bvars share, so that they cannot
    disagree. Resident bytes are the unparsed input and the queued
    output. Memoized for ``max_age_s`` (0: fresh): a ``/vars`` read
    evaluates both census bvars."""
    global _rows_memo
    now_mono = time.monotonic()
    expires, rows = _rows_memo
    if max_age_s > 0 and now_mono < expires:
        return rows
    with _pool._lock:
        socks = [s for s in _pool._objs if s is not None and not s.failed]
    now = time.monotonic_ns()
    rows = [(s, s.input_portal.size + s.wq_bytes,
             (now - s.last_active_ns) / 1e9) for s in socks]
    _rows_memo = (now_mono + 0.2, rows)
    return rows


def _socket_census() -> dict:
    """Census: every live socket of the process, with the idle ones and
    the server-side subset (the sockets /connections lists)."""
    rows = socket_census_rows()
    idle_after = flag("census_idle_s")
    srv = [b for s, b, _ in rows if s.user_data.get("server") is not None]
    return {"bytes": sum(b for _, b, _ in rows), "count": len(rows),
            "idle": sum(1 for _, _, i in rows if i >= idle_after),
            "server_bytes": sum(srv), "server_count": len(srv)}


def idle_conn_count() -> int:
    idle_after = flag("census_idle_s")
    return sum(1 for _, _, i in socket_census_rows() if i >= idle_after)


def conn_resident_bytes_avg() -> float:
    rows = socket_census_rows()
    if not rows:
        return 0.0
    return round(sum(b for _, b, _ in rows) / len(rows), 1)


_idle_var = PassiveStatus(idle_conn_count)
_avg_var = PassiveStatus(conn_resident_bytes_avg)


def expose_conn_census_vars() -> None:
    """(Re-)expose the census bvars: at import and from
    ``Server.start``, so that they outlive an ``unexpose_all``."""
    _idle_var.expose("idle_conn_count")
    _avg_var.expose("conn_resident_bytes_avg")


expose_conn_census_vars()


from brpc_tpu_torch.butil import resource_census as _census  # noqa: E402
#   (the census registration ships with the registry it measures)

_census.register("sockets", _socket_census)
