"""The port's fiber runtime against brpc_tpu.fiber, on the CPU.

Each case is one script written against a runtime's public names; it
runs once through ``brpc_tpu.fiber`` and once through
``brpc_tpu_torch.fiber``, and both must give the same, expected result.
The cases are those of tests/test_fiber.py that need no device (spawn
and join, butex, sync, timer, execution queue, work stealing), and the
WorkerModule hook the serving engine rides on (tests/test_cluster_ext.py
drives the reference's). Every case makes its own TaskControl; a
WorkerModule answers only its own control's workers, since the module
registry is one per process and every control's workers poll it.
"""

import importlib
import logging
import threading
import time
from types import SimpleNamespace

import pytest

RUNTIMES = {"reference": "brpc_tpu.fiber", "port": "brpc_tpu_torch.fiber"}


def _runtime(pkg: str) -> SimpleNamespace:
    rt = importlib.import_module(pkg)
    return SimpleNamespace(
        fiber=rt, wm=importlib.import_module(pkg + ".worker_module"),
        log=logging.getLogger(pkg.split(".")[0] + ".fiber"))


class _Ctrl:
    """A 4-worker TaskControl, stopped on exit."""

    def __init__(self, rt, n=4):
        self.c = rt.fiber.TaskControl(concurrency=n, name="tf")

    def __enter__(self):
        return self.c

    def __exit__(self, *exc):
        self.c.stop_and_join()


# ------------------------------------------------------- spawn and join

def spawn_callable(rt):
    with _Ctrl(rt) as c:
        f = c.spawn(lambda: 42)
        return f.join(2), f.value()


def spawn_coroutine(rt):
    async def work(x):
        await rt.fiber.yield_now()
        return x * 2

    with _Ctrl(rt) as c:
        f = c.spawn(work, 21)
        return f.join(2), f.value()


def exception_propagates(rt):
    seen = []
    with _Ctrl(rt) as c:
        c.add_error_handler(lambda f, e: seen.append(type(e).__name__))

        def boom():
            raise ValueError("boom")

        f = c.spawn(boom)
        assert f.join(2)
        try:
            f.value()
        except ValueError as e:
            return str(e), seen
    return None


def join_async(rt):
    with _Ctrl(rt) as c:
        async def child():
            await rt.fiber.sleep(0.01)
            return "child-done"

        async def parent():
            ch = c.spawn(child)
            await ch.join_async()
            return ch.value()

        f = c.spawn(parent)
        return f.join(3), f.value()


def many_fibers(rt):
    total = rt.fiber.CountdownEvent(1000)
    with _Ctrl(rt) as c:
        for _ in range(1000):
            c.spawn(lambda: total.signal())
        return total.wait_pthread(10), total.count


def spawn_many_in_order(rt):
    with _Ctrl(rt) as c:
        fs = c.spawn_many([lambda i=i: i * i for i in range(50)])
        return all(f.join(2) for f in fs), [f.value() for f in fs]


def bound_group_pinning(rt):
    ran_on = []
    with _Ctrl(rt) as c:
        def probe():
            ran_on.append(rt.fiber.current_group().index)

        fs = [c.spawn(probe, bound_group=2) for _ in range(20)]
        return all(f.join(2) for f in fs), sorted(set(ran_on))


def run_inline_first_leg_on_caller(rt):
    """``run_inline`` steps the fiber on the calling thread up to its
    first suspension; a worker runs the rest."""
    legs = []
    with _Ctrl(rt) as c:
        async def handler():
            legs.append(threading.current_thread() is caller)
            await rt.fiber.sleep(0.01)
            legs.append(threading.current_thread() is caller)
            return "done"

        caller = threading.current_thread()
        f = c.run_inline(handler)
        return f.join(2), f.value(), legs


# ----------------------------------------------------------------- butex

def butex_wait_wake(rt):
    b = rt.fiber.Butex(0)
    with _Ctrl(rt) as c:
        async def waiter():
            return await b.wait(expected=0)

        f = c.spawn(waiter)
        deadline = time.monotonic() + 2
        woke = 0
        while not woke and time.monotonic() < deadline:
            time.sleep(0.01)            # until the fiber has parked
            woke = b.wake(1)
        return woke, f.join(2), f.value()


def butex_value_changed(rt):
    b = rt.fiber.Butex(5)
    with _Ctrl(rt) as c:
        async def waiter():
            return await b.wait(expected=0)

        f = c.spawn(waiter)
        return f.join(2), f.value() == rt.fiber.WAIT_VALUE_CHANGED


def butex_timeout(rt):
    b = rt.fiber.Butex(0)
    with _Ctrl(rt) as c:
        async def waiter():
            t0 = time.monotonic()
            r = await b.wait(expected=0, timeout_s=0.05)
            return r, time.monotonic() - t0 >= 0.045

        f = c.spawn(waiter)
        assert f.join(2)
        r, waited = f.value()
        return r == rt.fiber.WAIT_TIMEOUT, waited


def butex_pthread_waiter(rt):
    b = rt.fiber.Butex(0)
    woke = []
    t = threading.Thread(
        target=lambda: woke.append(b.wait_pthread(expected=0, timeout_s=5)))
    t.start()
    time.sleep(0.05)
    b.wake_all()
    t.join(2)
    return not t.is_alive(), woke == [rt.fiber.WAIT_OK]


def butex_ping_pong(rt):
    """Two fibers alternate on two butexes (bthread_ping_pong)."""
    a, b = rt.fiber.Butex(0), rt.fiber.Butex(0)
    log = []
    with _Ctrl(rt) as c:
        async def ping():
            for i in range(50):
                log.append(("ping", i))
                b.fetch_add(1)
                b.wake(1)
                while a.value < i + 1:
                    await a.wait(expected=a.value, timeout_s=1)

        async def pong():
            for i in range(50):
                while b.value < i + 1:
                    await b.wait(expected=b.value, timeout_s=1)
                log.append(("pong", i))
                a.fetch_add(1)
                a.wake(1)

        f1, f2 = c.spawn(ping), c.spawn(pong)
        return f1.join(10) and f2.join(10), len(log)


# ------------------------------------------------------------------ sync

def mutex_exclusion(rt):
    m = rt.fiber.FiberMutex()
    counter = {"v": 0}
    with _Ctrl(rt) as c:
        async def worker():
            for _ in range(200):
                async with m:
                    v = counter["v"]
                    await rt.fiber.yield_now()  # interleave inside the lock
                    counter["v"] = v + 1

        fs = [c.spawn(worker) for _ in range(4)]
        return all(f.join(30) for f in fs), counter["v"]


def countdown_event(rt):
    ev = rt.fiber.CountdownEvent(3)
    with _Ctrl(rt) as c:
        async def waiter():
            return await ev.wait(timeout_s=5)

        f = c.spawn(waiter)
        for _ in range(3):
            ev.signal()
        return f.join(2), f.value()


def fiber_event(rt):
    ev = rt.fiber.FiberEvent()
    with _Ctrl(rt) as c:
        async def waiter():
            return await ev.wait(timeout_s=5)

        fs = [c.spawn(waiter) for _ in range(5)]
        ev.set()
        return all(f.join(2) for f in fs), [f.value() for f in fs]


def fiber_event_timeout_and_pthread(rt):
    ev = rt.fiber.FiberEvent()
    with _Ctrl(rt) as c:
        async def waiter():
            return await ev.wait(timeout_s=0.05)

        f = c.spawn(waiter)
        assert f.join(2)
        timed_out = f.value()
        ev.set()
        return timed_out, ev.wait_pthread(1), ev.is_set()


def fiber_condition(rt):
    m = rt.fiber.FiberMutex()
    cond = rt.fiber.FiberCondition(m)
    state = {"ready": False}
    with _Ctrl(rt) as c:
        async def waiter():
            await m.lock()
            try:
                while not state["ready"]:
                    await cond.wait(timeout_s=5)
                return "saw ready"
            finally:
                m.unlock()

        f = c.spawn(waiter)
        time.sleep(0.05)
        assert m.lock_pthread(2)
        state["ready"] = True
        cond.notify_all()
        m.unlock()
        return f.join(5), f.value()


def fiber_local(rt):
    freed = []
    key = rt.fiber.FiberLocal(destructor=freed.append)
    with _Ctrl(rt) as c:
        async def user(tag):
            key.set(tag)
            await rt.fiber.yield_now()
            return key.get()

        fs = [c.spawn(user, t) for t in ("a", "b", "c")]
        ok = all(f.join(2) for f in fs)
        key.set("thread")               # outside a fiber: a thread slot
        return ok, [f.value() for f in fs], sorted(freed), key.get()


# ----------------------------------------------------------------- timer

def timer_sleep(rt):
    with _Ctrl(rt) as c:
        async def napper():
            t0 = time.monotonic()
            await rt.fiber.sleep(0.05)
            await rt.fiber.sleep_us(1000)
            return time.monotonic() - t0 >= 0.05

        f = c.spawn(napper)
        return f.join(2), f.value()


def periodic_task(rt):
    timer = rt.fiber.TimerThread("t")
    hits = []
    p = rt.fiber.PeriodicTask(0.02, lambda: hits.append(1), timer=timer)
    time.sleep(0.2)
    p.stop()
    n = len(hits)
    time.sleep(0.06)
    stopped = len(hits) <= n + 1        # a stopped task stops re-arming
    once = []
    rt.fiber.PeriodicTask(0.01, lambda: once.append(1) or False,
                          timer=timer)
    time.sleep(0.08)
    timer.stop()
    return n >= 3, stopped, once        # returning False ends the task


# ------------------------------------------------------- execution queue

def execq_serialized_batches(rt):
    seen = []
    running = {"n": 0, "max": 0}

    def execute(tasks):
        running["n"] += 1
        running["max"] = max(running["max"], running["n"])
        seen.extend(tasks)
        running["n"] -= 1

    with _Ctrl(rt) as c:
        q = rt.fiber.ExecutionQueue(execute, control=c)
        pushed = all(q.execute(i) for i in range(500))
        return pushed, q.join(5), seen == list(range(500)), running["max"]


def execq_per_producer_order(rt):
    seen = []
    with _Ctrl(rt) as c:
        q = rt.fiber.ExecutionQueue(lambda ts: seen.extend(ts), control=c)

        def producer(tag):
            for i in range(200):
                q.execute((tag, i))

        ts = [threading.Thread(target=producer, args=(t,)) for t in range(4)]
        [t.start() for t in ts]
        [t.join(10) for t in ts]
        assert q.join(5)
        return len(seen), [[i for t, i in seen if t == tag]
                           == list(range(200)) for tag in range(4)]


def execq_async_consumer_and_stop(rt):
    seen = []
    with _Ctrl(rt) as c:
        async def execute(tasks):
            for t in tasks:
                await rt.fiber.yield_now()
                seen.append(t)

        q = rt.fiber.ExecutionQueue(execute, control=c)
        for i in range(100):
            q.execute(i)
        drained = q.join(5)
        q.stop()
        return drained, seen == list(range(100)), q.execute("late")


# --------------------------------------------------------- work stealing

def fibers_spread_over_workers(rt):
    seen = set()
    ev = rt.fiber.CountdownEvent(200)
    with _Ctrl(rt) as c:
        def probe():
            seen.add(rt.fiber.current_group().index)
            time.sleep(0.001)           # keep this worker busy: others steal
            ev.signal()

        for _ in range(200):
            c.spawn(probe)
        return ev.wait_pthread(10), len(seen) >= 2


# ---------------------------------------------------------- WorkerModule

def _module(rt, ctrl_box, result):
    """A module that answers only the workers of ``ctrl_box[0]``."""

    class Engine(rt.wm.WorkerModule):
        def __init__(self):
            self.calls = 0
            self.started, self.stopped = set(), set()

        def _mine(self):
            g = rt.fiber.current_group()
            return g is not None and g.control is ctrl_box[0]

        def has_task(self):
            return self._mine()

        def process(self, group_index):
            if not self._mine():
                return False
            self.calls += 1
            return result(self)

        def on_worker_start(self, group_index):
            self.started.add(group_index)

        def on_worker_stop(self, group_index):
            self.stopped.add(group_index)
    return Engine()


def _run_module(rt, result, seconds=0.3):
    box = [None]
    m = _module(rt, box, result)
    rt.wm.register_module(m)
    try:
        c = box[0] = rt.fiber.TaskControl(concurrency=2, name="twm")
        c.start()
        time.sleep(seconds)
        calls = m.calls
        c.stop_and_join()
    finally:
        rt.wm.unregister_module(m)
    return m, calls


def module_no_progress_lets_workers_park(rt):
    """``process`` returning False reports no progress: the workers park
    (one call per wake-up), where a module reporting progress keeps them
    polling it."""
    _, parked = _run_module(rt, lambda m: False)
    _, busy = _run_module(rt, lambda m: None)
    return parked < 50, busy > 500


def module_error_is_logged_and_loop_goes_on(rt):
    records = []

    class Grab(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    h = Grab()
    rt.log.addHandler(h)
    try:
        def result(m):
            if m.calls == 1:
                raise RuntimeError("engine fault")
            return None
        m, calls = _run_module(rt, result, seconds=0.2)
    finally:
        rt.log.removeHandler(h)
    return "worker module failed" in records, calls > 10


def module_worker_start_stop_hooks(rt):
    m, _ = _run_module(rt, lambda m: False, seconds=0.05)
    return sorted(m.started), sorted(m.stopped), m in \
        rt.wm.registered_modules()


def module_process_runs_beside_fibers(rt):
    """A module that always reports progress does not starve fibers: the
    loop steps a fiber after every module pass."""
    box = [None]
    m = _module(rt, box, lambda m: None)
    rt.wm.register_module(m)
    try:
        c = box[0] = rt.fiber.TaskControl(concurrency=2, name="twm")
        fs = [c.spawn(lambda i=i: i) for i in range(100)]
        ok = all(f.join(5) for f in fs)
        c.stop_and_join()
    finally:
        rt.wm.unregister_module(m)
    return ok, sum(f.value() for f in fs), m.calls > 0


CASES = {
    "spawn_callable": (spawn_callable, (True, 42)),
    "spawn_coroutine": (spawn_coroutine, (True, 42)),
    "exception_propagates": (exception_propagates,
                             ("boom", ["ValueError"])),
    "join_async": (join_async, (True, "child-done")),
    "many_fibers": (many_fibers, (True, 0)),
    "spawn_many_in_order": (spawn_many_in_order,
                            (True, [i * i for i in range(50)])),
    "bound_group_pinning": (bound_group_pinning, (True, [2])),
    "run_inline": (run_inline_first_leg_on_caller,
                   (True, "done", [True, False])),
    "butex_wait_wake": (butex_wait_wake, (1, True, "ok")),
    "butex_value_changed": (butex_value_changed, (True, True)),
    "butex_timeout": (butex_timeout, (True, True)),
    "butex_pthread_waiter": (butex_pthread_waiter, (True, True)),
    "butex_ping_pong": (butex_ping_pong, (True, 100)),
    "mutex_exclusion": (mutex_exclusion, (True, 800)),
    "countdown_event": (countdown_event, (True, True)),
    "fiber_event": (fiber_event, (True, [True] * 5)),
    "fiber_event_timeout_and_pthread": (fiber_event_timeout_and_pthread,
                                        (False, True, True)),
    "fiber_condition": (fiber_condition, (True, "saw ready")),
    "fiber_local": (fiber_local,
                    (True, ["a", "b", "c"], ["a", "b", "c"], "thread")),
    "timer_sleep": (timer_sleep, (True, True)),
    "periodic_task": (periodic_task, (True, True, [1])),
    "execq_serialized_batches": (execq_serialized_batches,
                                 (True, True, True, 1)),
    "execq_per_producer_order": (execq_per_producer_order,
                                 (800, [True] * 4)),
    "execq_async_consumer_and_stop": (execq_async_consumer_and_stop,
                                      (True, True, False)),
    "fibers_spread_over_workers": (fibers_spread_over_workers,
                                   (True, True)),
    "module_no_progress_parks": (module_no_progress_lets_workers_park,
                                 (True, True)),
    "module_error_logged": (module_error_is_logged_and_loop_goes_on,
                            (True, True)),
    "module_worker_hooks": (module_worker_start_stop_hooks,
                            ([0, 1], [0, 1], False)),
    "module_beside_fibers": (module_process_runs_beside_fibers,
                             (True, sum(range(100)), True)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_port_runtime_equals_reference(name):
    case, want = CASES[name]
    got = {label: case(_runtime(pkg)) for label, pkg in RUNTIMES.items()}
    assert got["port"] == got["reference"] == want, got


def test_saturation_snapshot_counts_the_workers_time():
    """The port's plain counters in place of the reference's bvars:
    fibers made and finished, busy time over the interval since the last
    snapshot, the run-queue peak, wake samples."""
    from brpc_tpu_torch.fiber import TaskControl
    c = TaskControl(concurrency=2, name="tsat")
    try:
        c.saturation_snapshot()
        fs = [c.spawn(time.sleep, 0.002) for _ in range(40)]
        assert all(f.join(5) for f in fs)
        snap = c.saturation_snapshot()
        assert snap["workers"] == 2 and snap["fibers"] == 0
        assert snap["fibers_created"] == 40 and snap["switches"] >= 40
        assert snap["runqueue_depth"] == 0 and snap["runqueue_peak"] >= 1
        assert 0.0 < snap["worker_busy_fraction"] <= 1.0
        assert snap["wake_samples"] >= 1 and snap["wake_us_max"] > 0
        again = c.saturation_snapshot()
        assert again["runqueue_peak"] == 0      # reset by the last read
    finally:
        c.stop_and_join()


def test_default_concurrency_is_the_references():
    import os

    from brpc_tpu_torch.fiber import TaskControl
    assert TaskControl().concurrency == max(8, os.cpu_count() or 0)
