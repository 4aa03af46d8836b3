"""EventDispatcher: the readiness poller of fd transports (the port of
brpc_tpu/transport/event_dispatcher.py; bRPC's event_dispatcher.h:32,
epoll there, ``selectors`` here).

One daemon thread per process runs the selector (``global_dispatcher()``)
and fires the callbacks of ready fds on itself. A read callback is the
Socket's input event, which may process the last message of a read in
place until its handler first suspends (``Socket``); anything that could
block hops to a fiber worker first, so one connection cannot stall the
others. A write-readiness request is one-shot: the epollout a blocked
writer asks for.

Conns without an fd (``mem://``, ``cuda://``) ``post`` their readiness
callbacks: the dispatcher runs them on its thread as it runs an fd's, so
a peer's input is processed where a TCP socket's would be, never in the
writer's own context (where a handler run in place could re-enter the
writer's locks).

The lane is chosen when the process's dispatcher is built
(``_new_dispatcher``): the ring lane (``transport/ring_lane.py``, one
native call a tick) when the ``event_ring_lane`` flag is on and the
native core has a ``Ring``, else this selector dispatcher; a ring that
fails to come up also leaves the selector, with the error logged
(brpc_tpu/transport/event_dispatcher.py:293-301).

A consumer is keyed by its fd number only here, inside the selector: the
owners hold ``socket.socket`` objects, unregister (``remove_consumer``)
before they close, and close once.

Stall instrumentation: ``dispatcher_stall_ms_max_10s`` is the longest
time one wakeup's callback batch held the thread over 10 s, and
``dispatcher_stalls`` counts the batches longer than the
``dispatcher_stall_ms`` flag. ``_tick_start_ns`` is nonzero exactly
while a batch runs, so the flight recorder's watchdog
(``builtin/flight_recorder.py``) sees a stall still in progress: it
feeds the gauge (``note_stall``), counts the stall once a tick
(``_tick_seq``), and annotates the rpcz span of the request holding the
thread. A stall the watchdog did not see is counted when its batch ends.
"""

from __future__ import annotations

import logging
import selectors
import socket as pysocket
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional

from brpc_tpu_torch.butil.flags import define_flag, flag
from brpc_tpu_torch.bvar.reducer import Adder, Maxer, PassiveStatus

log = logging.getLogger("brpc_tpu_torch.transport")

define_flag("dispatcher_stall_ms", 50.0,
            "an event-dispatcher callback batch holding the event thread "
            "longer than this is a stall: counted, and annotated into the "
            "rpcz span it is serving")

_tick_ms_max = Maxer()
nstalls = Adder()
_stall_win = None
_stall_win_lock = threading.Lock()


def _stall_window():
    """The 10 s window over the tick Maxer, made on first read (a Window
    registers with the sampler thread)."""
    global _stall_win
    if _stall_win is None:
        with _stall_win_lock:
            if _stall_win is None:
                from brpc_tpu_torch.bvar.window import Window
                _stall_win = Window(_tick_ms_max, 10)
    return _stall_win


def stall_ms_max_10s() -> float:
    """The longest tick over the window, the not yet sampled one too."""
    win = _stall_window().get_value() or 0.0
    live = _tick_ms_max.get_value() or 0.0
    return round(max(win, live), 3)


def note_stall(ms: float) -> None:
    """A tick overrun the flight recorder saw while it was running."""
    _tick_ms_max.update(ms)


_stall_var = PassiveStatus(stall_ms_max_10s)


def expose_stall_vars() -> None:
    """(Re-)expose the stall bvars: at import, and from Server.start, so
    that they outlive an ``unexpose_all``."""
    nstalls.expose("dispatcher_stalls")
    _stall_var.expose("dispatcher_stall_ms_max_10s")


expose_stall_vars()


class EventDispatcher:
    def __init__(self, name: str = "event_dispatcher"):
        self._selector = selectors.DefaultSelector()
        self._lock = threading.Lock()
        # fd -> [on_readable, on_writable (one-shot), armed read mask]
        self._handlers: Dict[int, list] = {}
        self._wakeup_r, self._wakeup_w = pysocket.socketpair()
        self._wakeup_r.setblocking(False)
        self._wakeup_w.setblocking(False)
        self._selector.register(self._wakeup_r, selectors.EVENT_READ, None)
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._name = name
        # callbacks posted by fd-less conns, run in order on the thread
        self._posted: deque = deque()
        # nonzero exactly while a callback batch runs; _tick_seq tells
        # the ticks apart, so a stall is counted once (by the flight
        # recorder's watchdog while it runs, or at the batch's end)
        self._tick_start_ns = 0
        self._tick_seq = 0
        self._stall_counted_seq = -1
        self._stall_lock = threading.Lock()
        # epoll applies interest changes while another thread waits in
        # it; select/poll snapshot the set per call and need a kick
        self._rearm_needs_wakeup = not isinstance(
            self._selector, getattr(selectors, "EpollSelector", ()))

    @property
    def thread(self) -> Optional[threading.Thread]:
        return self._thread

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._stop = False
            self._thread = threading.Thread(target=self._run,
                                            name=self._name, daemon=True)
            self._thread.start()

    def _wakeup(self) -> None:
        # a change made on the dispatcher thread needs no kick: the loop
        # re-enters select() right after the callback returns
        if threading.current_thread() is self._thread:
            return
        try:
            self._wakeup_w.send(b"x")
        except OSError:                 # full pipe: a wake is pending
            pass

    def add_consumer(self, fd: int, on_readable: Callable[[], None]) -> None:
        """Level-triggered read callbacks for ``fd``; the consumer pauses
        read interest for its busy periods (``pause_read``)."""
        with self._lock:
            self._handlers[fd] = [on_readable, None, selectors.EVENT_READ]
            try:
                self._selector.register(fd, selectors.EVENT_READ, fd)
            except KeyError:
                self._selector.modify(fd, selectors.EVENT_READ, fd)
            self._ensure_thread()
        self._wakeup()

    def _apply_locked(self, fd: int, h: list) -> None:
        """Make the selector's interest in ``fd`` match its handler."""
        mask = h[2] | (selectors.EVENT_WRITE if h[1] else 0)
        try:
            if mask:
                try:
                    self._selector.modify(fd, mask, fd)
                except KeyError:
                    self._selector.register(fd, mask, fd)
            else:
                self._selector.unregister(fd)
        except (KeyError, ValueError, OSError):
            pass

    def pause_read(self, fd: int) -> None:
        """Drop read interest until ``resume_read``."""
        with self._lock:
            h = self._handlers.get(fd)
            if h is None or not h[2]:
                return
            h[2] = 0
            self._apply_locked(fd, h)
        if self._rearm_needs_wakeup:
            self._wakeup()

    def resume_read(self, fd: int) -> None:
        """Re-arm read interest; a no-op when armed or removed."""
        with self._lock:
            h = self._handlers.get(fd)
            if h is None or h[2]:
                return
            h[2] = selectors.EVENT_READ
            self._apply_locked(fd, h)
        if self._rearm_needs_wakeup:
            self._wakeup()

    def request_writable(self, fd: int,
                         on_writable: Callable[[], None]) -> None:
        """One ``on_writable`` call once ``fd`` can take bytes."""
        with self._lock:
            h = self._handlers.get(fd)
            if h is None:
                raise ConnectionError(f"fd {fd} is not a consumer")
            h[1] = on_writable
            self._apply_locked(fd, h)
            self._ensure_thread()
        self._wakeup()

    def remove_consumer(self, fd: int) -> None:
        with self._lock:
            self._handlers.pop(fd, None)
            try:
                self._selector.unregister(fd)
            except (KeyError, ValueError, OSError):
                pass
        self._wakeup()

    def post(self, cb: Callable[[], None]) -> None:
        """Run ``cb`` on the dispatcher thread, after what it is running."""
        # graftlint: disable=guarded-by -- the deque IS the hand-off: post()
        # appends from any thread and only the dispatcher thread pops, and
        # deque append and popleft are atomic; the wakeup after the append
        # makes the loop look again.
        self._posted.append(cb)
        if self._thread is None or not self._thread.is_alive():
            with self._lock:
                self._ensure_thread()
        self._wakeup()

    def nconsumers(self) -> int:
        with self._lock:
            return len(self._handlers)

    def _run(self) -> None:
        while not self._stop:
            try:
                events = self._selector.select(
                    timeout=0 if self._posted else 0.5)
            except OSError:
                continue
            fired = []
            with self._lock:
                for key, mask in events:
                    if key.data is None:            # the wakeup pipe
                        try:
                            while self._wakeup_r.recv(4096):
                                pass
                        except OSError:
                            pass
                        continue
                    fd = key.data
                    h = self._handlers.get(fd)
                    if h is None:
                        continue
                    if mask & selectors.EVENT_READ and h[2]:
                        fired.append((fd, h[0]))
                    if mask & selectors.EVENT_WRITE and h[1] is not None:
                        fired.append((fd, h[1]))
                        h[1] = None                 # one-shot
                        self._apply_locked(fd, h)
            # what was posted up to now; later posts wait for the next
            # turn, so a callback that posts cannot hold the loop
            for _ in range(len(self._posted)):
                fired.append((None, self._posted.popleft()))
            if not fired:
                continue
            self._tick_seq += 1
            self._tick_start_ns = t0 = time.monotonic_ns()
            try:
                for fd, cb in fired:
                    try:
                        cb()
                    except Exception:   # boundary: the loop must go on
                        log.exception("event callback failed for fd %s",
                                      fd)
            finally:
                dur_ms = (time.monotonic_ns() - t0) / 1e6
                self._tick_start_ns = 0
                if dur_ms > 1.0:
                    # sub-ms ticks are the norm, not worth a Maxer lock
                    _tick_ms_max.update(dur_ms)
                    if dur_ms >= flag("dispatcher_stall_ms"):
                        self.count_stall(self._tick_seq)

    def count_stall(self, seq: int) -> bool:
        """Count tick ``seq``'s stall once, whoever sees it first (the
        watchdog mid-tick, the loop at its end)."""
        with self._stall_lock:
            if self._stall_counted_seq == seq:
                return False
            self._stall_counted_seq = seq
        nstalls.add(1)
        return True

    def stop(self, timeout_s: float = 2.0) -> None:
        """End the thread (for tests); a later consumer starts it again."""
        self._stop = True
        self._wakeup()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout_s)


_global: Optional[EventDispatcher] = None
_glock = threading.Lock()


def peek_dispatcher() -> Optional[EventDispatcher]:
    """The global dispatcher if there is one: watchdogs observe, never
    make one."""
    return _global


def _new_dispatcher():
    """The ring lane when the ``event_ring_lane`` flag is on and the
    native core has a ``Ring``; the selector lane otherwise, and on any
    failure to bring the ring up, so that a missing compiler never takes
    eventing down with it."""
    try:
        from brpc_tpu_torch.transport import ring_lane
        if flag("event_ring_lane") and ring_lane.ring_available():
            return ring_lane.RingDispatcher()
    except Exception:
        log.exception("ring lane unavailable; the selector lane serves")
    return EventDispatcher()


def global_dispatcher() -> EventDispatcher:
    global _global
    if _global is None:
        with _glock:
            if _global is None:
                _global = _new_dispatcher()
    return _global


def _postfork_reset() -> None:
    """Fork hygiene: the dispatcher's thread exists only in the parent,
    and the inherited epoll fd is the parent's kernel object: an
    ``epoll_ctl`` from the child would change the parent's interest set.
    The instance is abandoned (only the child's copies of its fds are
    closed; ``close`` never changes the shared interest list), so the
    first consumer after the fork builds a dispatcher of its own
    (brpc_tpu/transport/event_dispatcher.py:324-356). A ring dispatcher
    closes its own copies (``_postfork_abandon``: a uring's queues are
    shared mappings, and only the child's are unmapped). The stall window
    rode the parent's sampler series, and the stall counters count this
    process's ticks only."""
    global _global, _glock, _stall_win, _stall_win_lock
    d, _global = _global, None
    _glock = threading.Lock()
    _stall_win = None
    _stall_win_lock = threading.Lock()
    _tick_ms_max.postfork_clear()
    nstalls.postfork_clear()
    if d is not None:
        d._stop = True
        abandon = getattr(d, "_postfork_abandon", None)
        if abandon is not None:
            abandon()
            return
        try:
            d._selector.close()
        except Exception:
            pass
        for s in (d._wakeup_r, d._wakeup_w):
            try:
                s.close()
            except Exception:
                pass


from brpc_tpu_torch.butil import postfork as _postfork  # noqa: E402

_postfork.register("transport.event_dispatcher", _postfork_reset)
