"""M:N fiber scheduler: work-stealing worker threads stepping coroutines
(the port of brpc_tpu/fiber/scheduler.py, bRPC's bthread runtime).

  TaskControl (task_control.h:42)  -> TaskControl: owns N workers + parking
  TaskGroup   (task_group.h:70)    -> TaskGroup: per-worker run queues
  WorkStealingQueue                -> collections.deque (owner pops right,
                                      thieves pop left; GIL-atomic)
  ParkingLot  (parking_lot.h:31)   -> condition variable + signal counter
  fcontext switch                  -> coroutine send/StopIteration stepping
  bound run queue (task_group.h)   -> Fiber.bound_group pinning

A *fiber* wraps a Python coroutine. Workers pop a fiber and step it: one
``coro.send`` advances it until it finishes (StopIteration) or awaits a
scheduler token (a ``SchedAwaitable``), which hands the fiber to whatever
will wake it (a butex, the timer). Plain callables are wrapped in a
trivial coroutine and may block their worker thread.

Each worker's loop polls the registered WorkerModules before its run
queues (``worker_module.py``): that is how the serving engine's decode
slices share the worker threads with the RPC fibers.

The scheduler's counters are bvars, as the reference's are: the fiber
counts are Adders, the ``fiber_wake`` LatencyRecorder times 1 wake in
16, and ``TaskControl.expose_vars()`` puts them on ``/vars`` with the
run-queue and busy windows. ``TaskControl.saturation_snapshot()`` reads
the same counters for callers that compare two moments.
"""

from __future__ import annotations

import inspect
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, List, Optional

from brpc_tpu_torch.butil.fast_rand import fast_rand_less_than
from brpc_tpu_torch.bvar.latency_recorder import LatencyRecorder
from brpc_tpu_torch.bvar.reducer import Adder, Maxer, PassiveStatus

from . import worker_module

log = logging.getLogger("brpc_tpu_torch.fiber")

FIBER_STATE_READY = 0
FIBER_STATE_RUNNING = 1
FIBER_STATE_SUSPENDED = 2
FIBER_STATE_DONE = 3

_wake_rec: Optional[LatencyRecorder] = None
_wake_rec_lock = threading.Lock()


def _wake_recorder() -> LatencyRecorder:
    """The wake-to-run LatencyRecorder, exposed as ``fiber_wake`` when
    first used (brpc_tpu/fiber/scheduler.py:44-56). It is one per
    process, so it exposes itself again after ``unexpose_all``."""
    global _wake_rec
    if _wake_rec is None:
        with _wake_rec_lock:
            if _wake_rec is None:
                _wake_rec = LatencyRecorder().expose("fiber_wake")
    if _wake_rec.name != "fiber_wake":
        _wake_rec.expose("fiber_wake")
    return _wake_rec


class SchedAwaitable:
    """Base of everything a fiber may ``await``. ``_register(fiber)`` must
    arrange a future ``TaskControl.schedule(fiber, value)`` exactly once."""

    def _register(self, fiber: "Fiber") -> None:
        raise NotImplementedError

    def __await__(self):
        result = yield self
        return result


class _YieldNow(SchedAwaitable):
    def _register(self, fiber: "Fiber") -> None:
        fiber.control.schedule(fiber, None, to_tail=True)


def yield_now() -> SchedAwaitable:
    """Cooperatively reschedule (bthread_yield)."""
    return _YieldNow()


class Fiber:
    """One unit of M:N execution (bthread's TaskMeta)."""

    __slots__ = (
        "coro", "control", "state", "result", "exception", "bound_group",
        "locals", "_done_event", "_joiner_butex", "_resume_value", "name",
        "_key_destructors", "_ready_ns",
    )

    def __init__(self, coro, control: "TaskControl", name: str = ""):
        self.coro = coro
        self.control = control
        self.state = FIBER_STATE_READY
        self.result: Any = None
        self.exception: Optional[BaseException] = None
        self.bound_group: Optional[int] = None
        self.locals: dict = {}
        self.name = name
        self._done_event = None    # created on the first thread join()
        self._joiner_butex = None  # created on the first join_async()
        self._resume_value: Any = None
        self._key_destructors: List[Callable] = []
        self._ready_ns = 0

    def done(self) -> bool:
        return self.state == FIBER_STATE_DONE

    def join(self, timeout: Optional[float] = None) -> bool:
        """Block the calling *thread* until the fiber finishes. Safe from
        plain threads; inside a fiber use ``await fiber.join_async()``."""
        if self.state == FIBER_STATE_DONE:
            return True
        # the Event is created under the lock and DONE re-checked, so a
        # _finish racing this join either sees the Event or already
        # published DONE
        with _joiner_init_lock:
            if self.state == FIBER_STATE_DONE:
                return True
            ev = self._done_event
            if ev is None:
                ev = self._done_event = threading.Event()
        return ev.wait(timeout)

    def join_async(self) -> SchedAwaitable:
        """Awaitable join for use inside another fiber."""
        from .butex import Butex
        if self._joiner_butex is None:
            with _joiner_init_lock:
                if self._joiner_butex is None:
                    self._joiner_butex = Butex(0)
        butex = self._joiner_butex

        class _Join(SchedAwaitable):
            def _register(_self, fiber):
                if self.done():
                    fiber.control.schedule(fiber, None)
                else:
                    butex.add_waiter(fiber, expected=0)
        return _Join()

    def value(self) -> Any:
        if self.exception is not None:
            raise self.exception
        return self.result

    def _finish(self, result, exc) -> None:
        self.result = result
        self.exception = exc
        for d in self._key_destructors:
            try:
                d(self)
            except Exception:           # boundary: every destructor runs
                log.exception("fiber-local destructor failed")
        self.state = FIBER_STATE_DONE
        if self._joiner_butex is not None:
            self._joiner_butex.set_and_wake_all(1)
        # pairs with join()'s lazy creation: once DONE is published, an
        # Event a joiner managed to install must still be set
        ev = self._done_event
        if ev is None:
            with _joiner_init_lock:
                ev = self._done_event
        if ev is not None:
            ev.set()
        self.control.nfibers.add(-1)
        if exc is not None and not isinstance(exc, SystemExit):
            self.control.on_fiber_error(self, exc)


_joiner_init_lock = threading.Lock()


class _CurrentCell:
    """A thread's current fiber, in a plain object registered by thread
    id (not in thread-local storage), so the flight recorder's sampler
    can read another thread's fiber and attribute its sample to the RPC
    that fiber serves. Reads are racy by design: a torn read costs one
    misattributed sample."""

    __slots__ = ("current",)

    def __init__(self):
        self.current: Optional[Fiber] = None


class _WorkerTLS(threading.local):
    def __init__(self):
        self.group: Optional["TaskGroup"] = None
        self.inline_depth: int = 0
        # runs once a thread, on its first touch, on that thread
        self.cell = _CurrentCell()
        _cell_by_thread[threading.get_ident()] = self.cell


# thread id -> its _CurrentCell; the sampler prunes dead threads'
_cell_by_thread: dict = {}

_tls = _WorkerTLS()


def current_fiber() -> Optional[Fiber]:
    return _tls.cell.current


def thread_current_fiber(tid: int) -> Optional[Fiber]:
    """The fiber being stepped on thread ``tid`` (a racy snapshot for
    samplers), or None for a thread that is not stepping one."""
    cell = _cell_by_thread.get(tid)
    return cell.current if cell is not None else None


_prune_suspects: set = set()


def prune_thread_registry(live_tids) -> None:
    """Drop the cells of dead threads, on two strikes: a cell goes only
    when its thread was missing from two consecutive snapshots, since a
    new thread may register between the sampler's snapshot and this
    prune (and its cell, once pruned, would never come back)."""
    global _prune_suspects
    # a copy: another thread's first touch inserts while we iterate
    gone = {tid for tid in list(_cell_by_thread) if tid not in live_tids}
    for tid in gone & _prune_suspects:
        _cell_by_thread.pop(tid, None)
    _prune_suspects = gone


def current_group() -> Optional["TaskGroup"]:
    return _tls.group


class ParkingLot:
    """Futex-style idle-worker parking (bthread/parking_lot.h:31)."""

    def __init__(self):
        self._cond = threading.Condition()
        self._signals = 0

    def signal_count(self) -> int:
        return self._signals

    def signal(self, n: int = 1) -> None:
        with self._cond:
            self._signals += 1
            self._cond.notify(n)

    def wait(self, expected: int, timeout: float = 1.0) -> None:
        with self._cond:
            if self._signals == expected:
                self._cond.wait(timeout)


class TaskGroup:
    """Per-worker scheduler state (bthread/task_group.h:70). The counters
    are written by the owning worker alone."""

    def __init__(self, control: "TaskControl", index: int):
        self.control = control
        self.index = index
        self.rq: Deque[Fiber] = deque()         # local queue: owner pops right
        self.remote_rq: Deque[Fiber] = deque()  # pushed by non-workers
        self.bound_rq: Deque[Fiber] = deque()   # fibers pinned to this group
        self.nsteals = 0
        self.nswitches = 0
        self.nwakes = 0
        self.busy_ns = 0                        # time spent stepping fibers
        self.wake_samples = 0                   # 1 in 16 wakes, timed
        self.wake_us_sum = 0.0
        self.wake_us_max = 0.0

    # owner-side pop order: bound first (pinned work cannot run
    # elsewhere), then local LIFO for locality, then remote FIFO
    def pop_local(self) -> Optional[Fiber]:
        try:
            return self.bound_rq.popleft()
        except IndexError:
            pass
        try:
            return self.rq.pop()
        except IndexError:
            pass
        try:
            return self.remote_rq.popleft()
        except IndexError:
            return None

    def steal_from(self) -> Optional[Fiber]:
        """Thieves take the oldest local or remote task; bound tasks are
        never stolen."""
        try:
            return self.rq.popleft()
        except IndexError:
            pass
        try:
            return self.remote_rq.popleft()
        except IndexError:
            return None

    def depth(self) -> int:
        return len(self.rq) + len(self.remote_rq) + len(self.bound_rq)


class TaskControl:
    """Owns the worker threads (bthread/task_control.h:42)."""

    def __init__(self, concurrency: Optional[int] = None, name: str = "fiber"):
        if concurrency is None:
            # bthread's default floor of spare workers: fibers may run
            # blocking user code, so spare workers matter more than
            # matching the core count under the interpreter lock
            concurrency = max(8, os.cpu_count() or 0)
        self.name = name
        self.concurrency = concurrency
        self.groups: List[TaskGroup] = [TaskGroup(self, i)
                                        for i in range(concurrency)]
        self.parking_lot = ParkingLot()
        self._threads: List[threading.Thread] = []
        self._stop = False
        self.nfibers = Adder(0)
        self.nfibers_created = Adder(0)
        # deepest run queue seen at schedule() since the last snapshot;
        # a racy max (a lost update loses one peak reading, no more)
        self.runq_peak = 0
        # the same peak for the 10 s window of /vars (a Maxer that the
        # sampler resets each tick, so it must not share the field
        # saturation_snapshot resets)
        self.runq_peak_var = Maxer()
        self._busy_window = None        # built by expose_vars
        self._runq_peak_window = None
        self._snap_ns = time.perf_counter_ns()
        self._snap_busy_ns = 0
        self._error_handlers: List[Callable] = []
        self._started = False
        self._start_lock = threading.Lock()

    # -------------------------------------------------------------- start
    def start(self) -> None:
        with self._start_lock:
            if self._started:
                return
            self._started = True
            for g in self.groups:
                t = threading.Thread(target=self._worker, args=(g,),
                                     name=f"{self.name}_w{g.index}",
                                     daemon=True)
                self._threads.append(t)
                t.start()

    def stop_and_join(self, timeout: float = 5.0) -> None:
        self._stop = True
        with self._start_lock:
            # _started stays True through the join, so a racing start()
            # keeps no-opping instead of spawning a doomed pool
            threads = list(self._threads)
            self._threads.clear()
        for _ in threads:
            self.parking_lot.signal(len(threads))
        for t in threads:
            t.join(timeout)
        with self._start_lock:
            self._started = False
            self._stop = False

    # -------------------------------------------------------------- spawn
    @staticmethod
    def _coro_of(fn, args=(), kwargs=None):
        kwargs = kwargs or {}
        if inspect.iscoroutine(fn):
            return fn
        if inspect.iscoroutinefunction(fn):
            return fn(*args, **kwargs)

        async def _runner():
            r = fn(*args, **kwargs)
            if inspect.isawaitable(r):
                r = await r
            return r
        return _runner()

    def spawn(self, fn: Callable | Any, *args, name: str = "",
              urgent: bool = False, bound_group: Optional[int] = None,
              **kwargs) -> Fiber:
        """Start a fiber from a coroutine function, a coroutine object or
        a plain callable (bthread_start_background / start_urgent)."""
        fiber = Fiber(self._coro_of(fn, args, kwargs), self, name=name)
        if bound_group is not None:
            fiber.bound_group = bound_group % self.concurrency
        self.nfibers.add(1)
        self.nfibers_created.add(1)
        if not self._started:
            self.start()
        # the local queue is LIFO for its owner, so a plain push already
        # runs next: a Python frame cannot be preempted, and ``urgent``
        # is accepted for the API's sake only
        self.schedule(fiber, None)
        return fiber

    def spawn_many(self, works, name: str = "") -> List[Fiber]:
        """Spawn a batch with ONE parking-lot signal; the same semantics
        as ``spawn`` called for each item in order."""
        fibers: List[Fiber] = []
        if not works:
            return fibers
        if not self._started:
            self.start()
        g = _tls.group
        local = g is not None and g.control is self
        tgt = g if local else self.groups[
            fast_rand_less_than(self.concurrency)]
        for fn in works:
            fiber = Fiber(self._coro_of(fn), self, name=name)
            self.nfibers.add(1)
            self.nfibers_created.add(1)
            fiber._ready_ns = time.perf_counter_ns()
            if local:
                tgt.rq.append(fiber)        # owner-LIFO, as schedule()
            else:
                tgt.remote_rq.append(fiber)
            fibers.append(fiber)
        self._note_depth(tgt)
        self.parking_lot.signal(len(fibers))
        return fibers

    def run_inline(self, fn: Callable | Any, *args, name: str = "",
                   max_depth: int = 8, **kwargs) -> Fiber:
        """Step a new fiber on the CALLING thread until it completes or
        first suspends (the reference's process-in-place: a handler that
        never blocks pays no wake and no handoff). On its first real
        suspension the rest parks like a spawned fiber. Past
        ``max_depth`` nested inline runs on one thread, and for plain
        callables, this spawns instead."""
        depth = _tls.inline_depth
        if depth >= max_depth:
            return self.spawn(fn, *args, name=name, **kwargs)
        if not (inspect.iscoroutine(fn) or inspect.iscoroutinefunction(fn)):
            return self.spawn(fn, *args, name=name, **kwargs)
        fiber = Fiber(self._coro_of(fn, args, kwargs), self, name=name)
        self.nfibers.add(1)
        self.nfibers_created.add(1)
        if not self._started:
            self.start()                # a suspension needs the workers
        group = _tls.group or self.groups[0]
        _tls.inline_depth = depth + 1
        try:
            self._step(group, fiber)
        finally:
            _tls.inline_depth = depth
        return fiber

    def _note_depth(self, g: TaskGroup) -> None:
        d = g.depth()
        if d > self.runq_peak:
            # graftlint: disable=guarded-by -- a racy max by design: every
            # schedule() of every thread may raise it, and a lost update
            # loses one peak reading of an observability gauge
            # (saturation_snapshot), never a fiber; a lock here would sit on
            # the scheduling hot path.
            self.runq_peak = d
        self.runq_peak_var.update(d)

    def schedule(self, fiber: Fiber, resume_value: Any,
                 to_tail: bool = False) -> None:
        """Make a ready fiber runnable (ready_to_run / ready_to_run_remote)."""
        fiber._resume_value = resume_value
        fiber._ready_ns = time.perf_counter_ns()
        fiber.state = FIBER_STATE_READY
        if fiber.bound_group is not None:
            g = self.groups[fiber.bound_group]
            g.bound_rq.append(fiber)
            self._note_depth(g)
            self.parking_lot.signal(1)
            return
        g = _tls.group
        if g is not None and g.control is self:
            if to_tail:
                g.rq.appendleft(fiber)  # the back of the owner's LIFO
            else:
                g.rq.append(fiber)      # the owner runs it next
        else:
            # remote push: a random target group
            g = self.groups[fast_rand_less_than(self.concurrency)]
            g.remote_rq.append(fiber)
        self._note_depth(g)
        self.parking_lot.signal(1)

    # ------------------------------------------------------------- worker
    def _worker(self, group: TaskGroup) -> None:
        _tls.group = group
        worker_module.notify_start(group.index)
        while not self._stop:
            # co-scheduled engine work first (TaskGroup::ProcessModulesTask
            # runs before wait_task pops)
            ran_module = worker_module.process_modules(group.index) \
                if worker_module.has_modules() else False
            fiber = group.pop_local()
            if fiber is None:
                fiber = self._steal(group)
            if fiber is not None:
                self._step(group, fiber)
                continue
            if ran_module:
                continue                # the engine made progress: no park
            expected = self.parking_lot.signal_count()
            # re-check after reading the signal count: no lost wake-up
            fiber = group.pop_local() or self._steal(group)
            if fiber is not None:
                self._step(group, fiber)
                continue
            self.parking_lot.wait(expected, timeout=0.5)
        worker_module.notify_stop(group.index)
        _tls.group = None

    def _steal(self, group: TaskGroup) -> Optional[Fiber]:
        n = self.concurrency
        offset = fast_rand_less_than(n)
        for i in range(n):
            g = self.groups[(offset + i) % n]
            if g is group:
                continue
            f = g.steal_from()
            if f is not None:
                group.nsteals += 1
                return f
        return None

    def _step(self, group: TaskGroup, fiber: Fiber) -> None:
        """Advance the fiber one leg: run until it finishes or awaits."""
        cell = _tls.cell
        prev = cell.current
        cell.current = fiber
        fiber.state = FIBER_STATE_RUNNING
        ready_ns = fiber._ready_ns
        group.nswitches += 1
        t0 = time.perf_counter_ns()
        if ready_ns:
            # wake-to-run latency (the reference's fiber_wake recorder),
            # timed on 1 wake in 16, the first one included
            group.nwakes += 1
            if (group.nwakes & 0xF) == 1:
                us = (t0 - ready_ns) / 1e3
                group.wake_samples += 1
                group.wake_us_sum += us
                if us > group.wake_us_max:
                    group.wake_us_max = us
                _wake_recorder().record(us)
        fiber._ready_ns = 0
        try:
            token = fiber.coro.send(fiber._resume_value)
        except StopIteration as e:
            group.busy_ns += time.perf_counter_ns() - t0
            cell.current = prev
            fiber._finish(e.value, None)
            return
        except BaseException as e:      # the fiber's own failure: recorded
            group.busy_ns += time.perf_counter_ns() - t0
            cell.current = prev
            fiber._finish(None, e)
            return
        group.busy_ns += time.perf_counter_ns() - t0
        cell.current = prev
        fiber.state = FIBER_STATE_SUSPENDED
        fiber._resume_value = None
        if token is None:
            # a bare ``yield`` in a legacy generator: as yield_now
            self.schedule(fiber, None, to_tail=True)
        else:
            token._register(fiber)

    # -------------------------------------------------------------- misc
    def on_fiber_error(self, fiber: Fiber, exc: BaseException) -> None:
        for h in self._error_handlers:
            try:
                h(fiber, exc)
            except Exception:           # boundary: every handler runs
                log.exception("fiber error handler failed")
        if not self._error_handlers:
            log.error("fiber %r crashed", fiber.name, exc_info=exc)

    def add_error_handler(self, h: Callable) -> None:
        self._error_handlers.append(h)

    def runqueue_depth(self) -> int:
        """Ready fibers waiting for a worker, over all groups."""
        return sum(g.depth() for g in self.groups)

    def saturation_snapshot(self) -> dict:
        """The scheduler's counters. ``worker_busy_fraction`` and
        ``runqueue_peak`` cover the time since the previous snapshot (the
        reference reads them over a 10 s bvar window); the rest are
        totals since the control was made."""
        now = time.perf_counter_ns()
        busy = sum(g.busy_ns for g in self.groups)
        span = now - self._snap_ns
        frac = ((busy - self._snap_busy_ns) / (span * self.concurrency)
                if span > 0 and self.concurrency > 0 else 0.0)
        peak, self.runq_peak = self.runq_peak, 0
        self._snap_ns, self._snap_busy_ns = now, busy
        samples = sum(g.wake_samples for g in self.groups)
        return {
            "workers": self.concurrency,
            "runqueue_depth": self.runqueue_depth(),
            "runqueue_peak": peak,
            "worker_busy_fraction": min(1.0, frac),
            "fibers": self.nfibers.get_value(),
            "fibers_created": self.nfibers_created.get_value(),
            "switches": sum(g.nswitches for g in self.groups),
            "steals": sum(g.nsteals for g in self.groups),
            "wake_samples": samples,
            "wake_us_mean": (sum(g.wake_us_sum for g in self.groups)
                             / samples if samples else None),
            "wake_us_max": max((g.wake_us_max for g in self.groups),
                               default=0.0),
        }

    # ------------------------------------------------------- bvar views
    def _busy_ns_total(self) -> int:
        return sum(g.busy_ns for g in self.groups)

    def _saturation_windows(self):
        """10 s windows over the busy time and the run-queue peak, made
        on first use (a Window registers with the sampler thread: not
        for controls nobody looks at)."""
        if self._busy_window is None:
            from brpc_tpu_torch.bvar.window import PerSecond, Window
            self._busy_window = PerSecond(
                PassiveStatus(self._busy_ns_total), 10)
            self._runq_peak_window = Window(self.runq_peak_var, 10)
        return self._busy_window, self._runq_peak_window

    def worker_busy_fraction(self) -> float:
        """Share of worker capacity spent stepping fibers over the
        sampler's 10 s window."""
        busy, _ = self._saturation_windows()
        per_s = busy.get_value() or 0.0
        if self.concurrency <= 0:
            return 0.0
        return min(1.0, per_s / 1e9 / self.concurrency)

    def saturation_pane(self) -> dict:
        """The scheduler's half of the /status saturation pane, over the
        sampler's 10 s windows (what the reference's
        ``saturation_snapshot`` returns)."""
        _, peak = self._saturation_windows()
        return {
            "workers": self.concurrency,
            "runqueue_depth": self.runqueue_depth(),
            "runqueue_peak_10s": peak.get_value() or 0,
            "worker_busy_fraction": round(self.worker_busy_fraction(), 4),
        }

    def expose_vars(self, prefix: str = "fiber") -> None:
        """The scheduler's counters on /vars and the Prometheus dump
        (brpc_tpu/fiber/scheduler.py:651), with ``fiber_wake``."""
        self.nfibers.expose(f"{prefix}_count")
        self.nfibers_created.expose(f"{prefix}_created")
        PassiveStatus(lambda: self.concurrency).expose(
            f"{prefix}_worker_count")
        PassiveStatus(lambda: sum(g.nswitches for g in self.groups)).expose(
            f"{prefix}_switch_count")
        PassiveStatus(lambda: sum(g.nsteals for g in self.groups)).expose(
            f"{prefix}_steal_count")
        PassiveStatus(self.runqueue_depth).expose(
            f"{prefix}_runqueue_depth")
        _, peak = self._saturation_windows()
        PassiveStatus(lambda: peak.get_value() or 0).expose(
            f"{prefix}_runqueue_peak_10s")
        PassiveStatus(self.worker_busy_fraction).expose(
            f"{prefix}_worker_busy_fraction")
        _wake_recorder()


# ----------------------------------------------------------------- globals
_global_control: Optional[TaskControl] = None
_global_lock = threading.Lock()


def global_control() -> TaskControl:
    global _global_control
    if _global_control is None:
        with _global_lock:
            if _global_control is None:
                _global_control = TaskControl()
    return _global_control


def set_concurrency(n: int) -> None:
    """bthread_setconcurrency: must run before the first spawn."""
    global _global_control
    with _global_lock:
        if _global_control is not None and _global_control._started:
            raise RuntimeError("fiber workers already started")
        _global_control = TaskControl(concurrency=n)


def spawn(fn, *args, **kwargs) -> Fiber:
    return global_control().spawn(fn, *args, **kwargs)


def spawn_urgent(fn, *args, **kwargs) -> Fiber:
    return global_control().spawn(fn, *args, urgent=True, **kwargs)


def _postfork_reset() -> None:
    """Fork hygiene: the worker threads exist only in the parent, so the
    inherited control would queue every spawn forever; drop it so the
    first spawn in the child builds a control with live workers."""
    global _global_control, _global_lock
    _global_control = None
    _global_lock = threading.Lock()
    # the cells name the parent's threads; only the forking one lives on
    _cell_by_thread.clear()
    _cell_by_thread[threading.get_ident()] = _tls.cell


from brpc_tpu_torch.butil import postfork as _postfork  # noqa: E402

_postfork.register("fiber.scheduler", _postfork_reset)


def _fiber_census() -> dict:
    """Census: live fibers from the cheap Adder; peeks, so a census read
    never builds a TaskControl."""
    c = _global_control
    if c is None:
        return {"count": 0, "workers": 0}
    return {"count": max(0, int(c.nfibers.get_value() or 0)),
            "workers": c.concurrency,
            "runqueue_depth": c.runqueue_depth()}


from brpc_tpu_torch.butil import resource_census as _census  # noqa: E402
#   (the census registration ships with the singleton it measures)

_census.register("fibers", _fiber_census)
