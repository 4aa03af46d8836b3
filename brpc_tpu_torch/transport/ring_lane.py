"""The ring lane: an event dispatcher whose tick is one native call (the
port of brpc_tpu/transport/ring_lane.py; the fork's io_uring
networking, src/bthread/ring_listener.*).

The selector dispatcher fires one Python callback per ready fd, and
each callback pays its own recv and send. A ``RingDispatcher`` tick is
one call into fastcore's ``Ring`` (``native/src/ring.cc``) with the
interpreter lock released: it polls the interest set and runs the whole
ready set's I/O, recv bursts, accept loops and one-shot writability.
Python drains the returned completions in bulk. A response written on
the ring thread while it drains (``Socket.write`` asks
``try_defer_write``) is put on the tick's flush list, which leaves as a
second native call: a pipelined burst's responses go out as one gather
write a connection instead of one send a frame.

``global_dispatcher()`` builds a ``RingDispatcher`` when the
``event_ring_lane`` flag is on (``BRPC_TPU_FLAG_EVENT_RING_LANE=1``)
and the extension has a ``Ring``; else the selector ``EventDispatcher``,
the default. ``Ring()`` picks its backend: ``uring`` where
``io_uring_setup`` is allowed, ``batch`` (poll plus recv/accept/writev
in one pass) otherwise; ``Ring(1)`` forces batch, ``Ring(2)`` uring or
an OSError. A conn that cannot give its fd to the ring (ssl buffers
decrypted bytes above the fd; the device lanes' inner TCP conns) is
registered poll-only: the ring reports readiness and its callbacks run
as on the selector.

Everything this module runs on the ring thread must be cheap: schedule
fibers, feed portals, never block. Completions enter the same Socket
machinery as the selector lane's events (``Socket.ring_input``).

A sync plucker fences the ring (``read_barrier``): it pauses the fd's
reads and waits until the tick in flight has ended, so the native pass
cannot consume the response it is about to read itself. A claim that
finds reads already off (the socket's sticky pause, left by the last
sync call) pays no barrier; every other claim on a ring-attached socket
does, and ``ring_barrier_waits`` and ``ring_barrier_wait_us`` count it. On the uring backend a recv in the
kernel cannot be fenced, so sync joins take the event path there.

Mem and cuda conns post their readiness (``post``); the ring runs posted
callbacks on its thread after each tick's completions.
"""

from __future__ import annotations

import errno
import logging
import os
import socket as pysocket
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional

from brpc_tpu_torch.butil.flags import define_flag, flag
from brpc_tpu_torch.bvar.reducer import Adder
from brpc_tpu_torch.transport import event_dispatcher as _evd

log = logging.getLogger("brpc_tpu_torch.transport")

define_flag("event_ring_lane", False,
            "make the process's event dispatcher the ring lane (one "
            "native call a tick: poll and the ready set's I/O, native "
            "ring.cc); off: the selector lane. Read when the dispatcher "
            "is built")

# completion ops (native/src/ring.cc)
OP_RECV = 0
OP_ACCEPT = 1
OP_WRITEV = 2
OP_WRITABLE = 3
OP_READABLE = 4

_KIND_DATA = 0
_KIND_ACCEPT = 1
_KIND_POLL = 2

# a handler: [on_readable, on_writable (one-shot), read armed, sink];
# the sink is ring_recv(data, eof, err) or ring_accept(fd | -errno)
_H_READ = 0
_H_WRITE = 1
_H_ARMED = 2
_H_SINK = 3

# ticks, completions, and how much the write half batches:
# ring_flushed_frames / ring_flush_batches is frames a gather write
nticks = Adder()
ncompletions = Adder()
nflush_batches = Adder()
nflush_frames = Adder()
# the pluck fence: barriers asked for, those that found a tick in flight
# and waited for it, and the time they waited
nbarriers = Adder()
nbarrier_waits = Adder()
nbarrier_wait_us = Adder()

_VARS = (("ring_ticks", nticks), ("ring_completions", ncompletions),
         ("ring_flush_batches", nflush_batches),
         ("ring_flushed_frames", nflush_frames),
         ("ring_read_barriers", nbarriers),
         ("ring_barrier_waits", nbarrier_waits),
         ("ring_barrier_wait_us", nbarrier_wait_us))


def expose_ring_vars() -> None:
    """(Re-)expose the ring's bvars: at import and from ``Server.start``,
    so that they outlive an ``unexpose_all``."""
    for name, var in _VARS:
        var.expose(name)


expose_ring_vars()


def counters() -> dict:
    """The ring's bvars by name (zeros in a process on the selector)."""
    return {name: var.get_value() for name, var in _VARS}


# the dispatcher whose tick runs on this thread: only the ring thread
# sees one, and Socket.write defers its frames to that tick's flush
_tick_local = threading.local()


def try_defer_write(sock) -> bool:
    """True when ``sock``'s queued frames went to the current tick's write
    flush (the caller's push just claimed the writership, which the
    flush now owns); False off the ring thread: write inline."""
    d = getattr(_tick_local, "disp", None)
    if d is None:
        return False
    d._flush.append(sock)
    return True


def ring_available() -> bool:
    from brpc_tpu_torch.native import fastcore
    fc = fastcore.get()
    return fc is not None and hasattr(fc, "Ring")


class RingDispatcher:
    """The selector dispatcher's surface (``add_consumer``,
    ``pause_read``, ``resume_read``, ``request_writable``,
    ``remove_consumer``, ``post``, ``stop``) over a native ``Ring``; a
    data conn also passes ``ring_recv=`` (its bytes come from the tick)
    and a listener ``ring_accept=`` (accepted fds come made)."""

    ring_native = True

    def __init__(self, name: str = "ring_dispatcher", backend: int = 0):
        from brpc_tpu_torch.native import fastcore
        fc = fastcore.get()
        if fc is None or not hasattr(fc, "Ring"):
            raise RuntimeError("the ring lane needs the fastcore extension")
        self._ring = fc.Ring(backend)
        self.backend = self._ring.backend_name()
        self._lock = threading.Lock()
        self._barrier_cv = threading.Condition(self._lock)
        self._handlers: Dict[int, list] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._name = name
        self._posted: deque = deque()
        # _tick_busy spans wait + drain + flush; read_barrier waits for
        # the generation in flight to end
        self._tick_busy = False
        self._tick_gen = 0
        # fds removed during the tick: its later completions may name
        # them, or a new consumer on a reused fd number
        self._tick_dead: set = set()
        # sockets whose writes this tick deferred
        self._flush: list = []
        # uring gathers waiting for their OP_WRITEV completion:
        # fd -> (socket, views, marks, total)
        self._pending_writes: Dict[int, tuple] = {}
        # the stall surface the flight recorder reads (as the selector's)
        self._tick_start_ns = 0
        self._tick_seq = 0
        self._stall_counted_seq = -1
        self._stall_lock = threading.Lock()
        self._wakeup_r, self._wakeup_w = pysocket.socketpair()
        self._wakeup_r.setblocking(False)
        self._wakeup_w.setblocking(False)
        wfd = self._wakeup_r.fileno()
        self._handlers[wfd] = [self._drain_wakeup, None, True, None]
        self._ring.register_fd(wfd, _KIND_POLL)

    @property
    def thread(self) -> Optional[threading.Thread]:
        return self._thread

    # ------------------------------------------------------ registration
    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._stop = False
            self._thread = threading.Thread(target=self._run,
                                            name=self._name, daemon=True)
            self._thread.start()

    def _wakeup(self) -> None:
        if threading.current_thread() is self._thread:
            return
        try:
            self._wakeup_w.send(b"x")
        except OSError:                 # full: a wake is pending
            pass

    def _drain_wakeup(self) -> None:
        try:
            while self._wakeup_r.recv(4096):
                pass
        except OSError:
            pass

    def add_consumer(self, fd: int, on_readable: Callable[[], None],
                     ring_recv=None, ring_accept=None) -> None:
        """Read interest in ``fd``. ``ring_recv`` makes it ring-native
        (the tick recvs it and hands the bytes over), ``ring_accept``
        marks a listener; neither: poll-only, readiness fires
        ``on_readable`` as on the selector (level-triggered)."""
        if ring_recv is not None:
            kind, sink = _KIND_DATA, ring_recv
        elif ring_accept is not None:
            kind, sink = _KIND_ACCEPT, ring_accept
        else:
            kind, sink = _KIND_POLL, None
        with self._lock:
            self._handlers[fd] = [on_readable, None, True, sink]
            self._ring.register_fd(fd, kind)
            self._ensure_thread()
        self._wakeup()

    def pause_read(self, fd: int) -> None:
        """Drop read interest. The tick in flight may still see the fd
        once: a consumer that needs a hard cut follows with
        ``read_barrier``."""
        with self._lock:
            h = self._handlers.get(fd)
            if h is None or not h[_H_ARMED]:
                return
            h[_H_ARMED] = False
            self._ring.set_read(fd, False)

    def resume_read(self, fd: int) -> None:
        with self._lock:
            h = self._handlers.get(fd)
            if h is None or h[_H_ARMED]:
                return
            h[_H_ARMED] = True
            self._ring.set_read(fd, True)
        # the native pass took its interest set at entry: kick it, so
        # that pending bytes are seen now and not at the next timeout
        self._wakeup()

    def request_writable(self, fd: int,
                         on_writable: Callable[[], None]) -> None:
        """One ``on_writable`` call once ``fd`` can take bytes."""
        with self._lock:
            h = self._handlers.get(fd)
            if h is None:
                raise ConnectionError(f"fd {fd} is not a consumer")
            h[_H_WRITE] = on_writable
            self._ring.request_writable(fd)
            self._ensure_thread()
        self._wakeup()

    def remove_consumer(self, fd: int) -> None:
        with self._lock:
            self._handlers.pop(fd, None)
            self._ring.unregister_fd(fd)
            self._tick_dead.add(fd)
            # graftlint: disable=guarded-by -- _pending_writes is
            # ring-thread owned (defer and settle on the tick); this one
            # teardown pop from another thread holds _lock while the native
            # generation guard stales any in-flight completion for fd.
            pend = self._pending_writes.pop(fd, None)
        if pend is not None:
            # a uring gather was still in flight: its completion is now
            # stale (the native generation check drops it), so its frames
            # settle here and their callbacks see the failure
            sock, views, marks, total = pend
            sock.ring_settle_write(0, errno.EPIPE, views, marks, total)
        self._wakeup()
        # the caller closes the fd next: a native pass still holding it
        # would race a reused fd number, so wait the tick out
        self.read_barrier(count=False)

    def post(self, cb: Callable[[], None]) -> None:
        """Run ``cb`` on the ring thread, after the tick in flight."""
        # graftlint: disable=guarded-by -- the deque IS the hand-off, as
        # EventDispatcher.post's: appended from any thread, popped by the
        # ring thread only, each operation atomic; the wakeup after the
        # append makes the tick look again.
        self._posted.append(cb)
        if self._thread is None or not self._thread.is_alive():
            with self._lock:
                self._ensure_thread()
        self._wakeup()

    def nconsumers(self) -> int:
        with self._lock:
            return len(self._handlers)

    def read_barrier(self, count: bool = True) -> None:
        """Block until the tick in flight (native pass, completions,
        write flush) has ended. The pluck lane calls it after pausing
        reads and before sending its request: past the barrier, the ring
        can no longer consume the response. A no-op on the ring thread,
        where running Python proves no native pass is in flight."""
        if threading.current_thread() is self._thread:
            return
        if count:
            nbarriers.add(1)
        # the generation in flight is read before the kick: read after
        # it, it could name the next tick, which then sits out its whole
        # timeout (brpc_tpu reads it after and pays that)
        with self._lock:
            gen = self._tick_gen
            if not self._tick_busy:
                return
        t0 = time.monotonic_ns()
        self._wakeup()
        with self._lock:
            while self._tick_busy and self._tick_gen == gen:
                self._barrier_cv.wait(0.05)
        if count:
            nbarrier_waits.add(1)
            nbarrier_wait_us.add((time.monotonic_ns() - t0) // 1000)

    # ------------------------------------------------------- write flush
    def _flush_writes(self) -> None:
        socks, self._flush = self._flush, []
        batch, metas = [], []
        for sock in socks:
            try:
                if sock.failed:
                    # the writer's failed branch fires every callback
                    sock._drain_writes(None)
                    continue
                views, marks, total = sock.ring_collect_writes()
                if not marks:
                    sock._drain_writes(None)    # raced empty: retire
                    continue
                try:
                    fd = sock.conn.pluck_fd()
                except OSError:
                    fd = -1
                if fd < 0:
                    # no fd any more (failed in the tick): the frames
                    # park through the classic hand-off, which the
                    # failure settles
                    sock.ring_settle_write(0, 0, views, marks, total)
                    continue
                batch.append((fd, views))
                metas.append((sock, views, marks, total))
            except Exception:
                # one socket must not strand the round: it fails, the
                # others' claimed writerships still flush
                log.exception("ring flush collect failed; failing the conn")
                self._fail_conn(sock, "ring flush collect failed")
        if not batch:
            return
        nflush_batches.add(len(batch))
        nflush_frames.add(sum(len(m[2]) for m in metas))
        try:
            results = self._ring.flush_writes(batch)
        except Exception:
            log.exception("ring write flush failed; parking the batches")
            for sock, views, marks, total in metas:
                sock.ring_settle_write(0, 0, views, marks, total)
            return
        for (sock, views, marks, total), (fd, res, err) in zip(metas,
                                                               results):
            try:
                if res < 0 and err == 0:
                    # uring: pending, its OP_WRITEV completion settles
                    self._pending_writes[fd] = (sock, views, marks, total)
                    continue
                sock.ring_settle_write(res, err, views, marks, total)
            except Exception:
                log.exception("ring write settle failed; failing the conn")
                self._fail_conn(sock, "ring write settle failed")

    @staticmethod
    def _fail_conn(sock, why: str) -> None:
        try:
            sock.set_failed(ConnectionError(why))
            sock._drain_writes(None)
        except Exception:
            pass

    # ---------------------------------------------------------- the loop
    def _run(self) -> None:
        _tick_local.disp = self
        while not self._stop:
            with self._lock:
                self._tick_busy = True
                self._tick_dead.clear()
            try:
                try:
                    comps = self._ring.wait(0 if self._posted else 500)
                except OSError:
                    continue
                except ValueError:      # the ring closed under us
                    return
                posted = [self._posted.popleft()
                          for _ in range(len(self._posted))]
                if not comps and not posted:
                    continue
                if comps:
                    nticks.add(1)
                    ncompletions.add(len(comps))
                self._tick_seq += 1
                self._tick_start_ns = t0 = time.monotonic_ns()
                try:
                    for comp in comps:
                        try:
                            self._dispatch_completion(comp)
                        except Exception:
                            log.exception("ring completion failed for fd "
                                          "%d", comp[0])
                    for cb in posted:
                        try:
                            cb()
                        except Exception:
                            log.exception("posted callback failed")
                finally:
                    self._flush_rounds()
                    dur_ms = (time.monotonic_ns() - t0) / 1e6
                    self._tick_start_ns = 0
                    if dur_ms > 1.0:
                        _evd._tick_ms_max.update(dur_ms)
                        if dur_ms >= flag("dispatcher_stall_ms"):
                            self.count_stall(self._tick_seq)
            finally:
                with self._lock:
                    self._tick_busy = False
                    self._tick_gen += 1
                    self._barrier_cv.notify_all()

    def _flush_rounds(self) -> None:
        """Flush until nothing is deferred: a settle's callbacks may defer
        more writes (a completed response issues a call). A chain past 8
        rounds writes inline."""
        rounds = 0
        while self._flush and rounds < 8:
            rounds += 1
            try:
                self._flush_writes()
            except Exception:
                log.exception("ring flush round failed")
                break
        for sock in self._flush:
            try:
                sock._drain_writes(None)
            except Exception:
                log.exception("ring flush fallback failed")
        self._flush = []

    def _dispatch_completion(self, comp) -> None:
        fd, op, res, payload = comp
        if op == OP_WRITEV:
            # settle first, the consumer removed or not: the parked
            # frames' callbacks must fire as the classic writer's would
            pend = self._pending_writes.pop(fd, None)
            if pend is not None:
                sock, views, marks, total = pend
                if res >= 0:
                    sock.ring_settle_write(res, 0, views, marks, total)
                else:
                    sock.ring_settle_write(0, -res, views, marks, total)
            return
        cb = None
        with self._lock:
            if fd in self._tick_dead:
                # removed during this tick (perhaps re-registered on a
                # reused number): the completion is the old consumer's
                if op == OP_ACCEPT and res >= 0:
                    os.close(res)       # never leak an accepted fd
                return
            h = self._handlers.get(fd)
            if h is not None and op == OP_WRITABLE:
                cb, h[_H_WRITE] = h[_H_WRITE], None
        if h is None:
            if op == OP_ACCEPT and res >= 0:
                os.close(res)
            return
        # callbacks run outside the lock: they re-enter the dispatcher
        if op == OP_RECV:
            sink = h[_H_SINK]
            if sink is not None:
                sink(payload if res > 0 else None, res == 0,
                     -res if res < 0 else 0)
            elif h[_H_READ] is not None:
                h[_H_READ]()
        elif op == OP_ACCEPT:
            sink = h[_H_SINK]
            if sink is not None:
                sink(res)
            elif res >= 0:
                os.close(res)
        elif op == OP_WRITABLE:
            if cb is not None:
                cb()
        elif op == OP_READABLE:
            if h[_H_READ] is not None:
                h[_H_READ]()

    def count_stall(self, seq: int) -> bool:
        """Count tick ``seq``'s stall once (the selector's rule)."""
        with self._stall_lock:
            if self._stall_counted_seq == seq:
                return False
            self._stall_counted_seq = seq
        _evd.nstalls.add(1)
        return True

    def stop(self, timeout_s: float = 2.0) -> None:
        """End the thread; a later consumer starts it again."""
        self._stop = True
        self._wakeup()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout_s)

    def close(self) -> None:
        """Stop, then free the native ring and the wakeup pair (a private
        dispatcher's end; the global one lives as long as the process)."""
        self.stop()
        self._release()

    def _release(self) -> None:
        for s in (self._wakeup_r, self._wakeup_w):
            try:
                s.close()
            except Exception:
                pass
        try:
            self._ring.close()
        except Exception:
            pass

    def _postfork_abandon(self) -> None:
        """The child's side of a fork (event_dispatcher's postfork reset):
        the ring thread lives only in the parent. Close the child's
        copies of the wakeup pair and the ring (batch: freed; uring: the
        child unmaps its copy of the queues and closes its ring fd, which
        leaves the parent's kernel object alone)."""
        self._stop = True
        self._release()


def _postfork_reset() -> None:
    """The child counts its own ring's ticks, flushes and barriers (the
    parent's ring is abandoned by the dispatcher's reset)."""
    for _, var in _VARS:
        var.postfork_clear()


from brpc_tpu_torch.butil import postfork as _postfork  # noqa: E402

_postfork.register("transport.ring_lane", _postfork_reset)
