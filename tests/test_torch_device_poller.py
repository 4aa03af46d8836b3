"""The port's DeviceEventPoller and ``device_ready`` against
brpc_tpu.fiber's, on the CPU (brpc_tpu tests/test_fiber.py:265-460).

Each case runs through ``brpc_tpu.fiber`` and ``brpc_tpu_torch.fiber``
on the same inputs and wants equal results: a fiber parked on a
``concurrent.futures.Future`` (resolved later, or already), on a fake
device array with ``is_ready``/``block_until_ready`` (a waiter thread
blocks in its wait), on an object with only ``is_ready`` (the poll
pump), and past the waiter cap, where the rest go to the pump. The port
alone: a fake ``torch.cuda.Event`` (``query``/``synchronize``) parks on
a waiter thread, and no fiber worker is blocked while fibers wait
(one worker runs other fibers meanwhile).

Inputs come from a numpy seed. The cases run inside one collected test
(``_run_cases``), so every other test file keeps its place in
pytest-xdist's ``--dist loadfile`` queue (see test_torch_iobuf.py).
"""

import threading
import time
import traceback
from concurrent.futures import Future

import numpy as np

import brpc_tpu.fiber as ref_fiber
import brpc_tpu.fiber.device_poller as ref_poller
import brpc_tpu_torch.fiber as port_fiber
import brpc_tpu_torch.fiber.device_poller as port_poller

RUNTIMES = [("brpc_tpu", ref_fiber, ref_poller),
            ("port", port_fiber, port_poller)]


def _run_cases(cases):
    failed = []
    for name, fn, args in cases:
        try:
            fn(*args)
        except Exception:
            failed.append(f"--- {name}\n{traceback.format_exc()}")
    assert not failed, "\n".join(failed)


class _FakeArray:
    """A device array: ready once ``release`` is called; its blocking
    wait parks the calling thread until then."""

    def __init__(self, value):
        self.value = value
        self._ev = threading.Event()
        self.waited_on = []

    def release(self):
        self._ev.set()

    def is_ready(self):
        return self._ev.is_set()

    def block_until_ready(self):
        self.waited_on.append(threading.current_thread().name)
        self._ev.wait(10)
        return self


class _PollOnly:
    def __init__(self, value):
        self.value = value
        self._ev = threading.Event()

    def release(self):
        self._ev.set()

    def is_ready(self):
        return self._ev.is_set()


class _FakeCudaEvent:
    """torch.cuda.Event's interface: ``query`` and ``synchronize``."""

    def __init__(self):
        self._ev = threading.Event()
        self.waited_on = []

    def record(self):
        pass

    def release(self):
        self._ev.set()

    def query(self):
        return self._ev.is_set()

    def synchronize(self):
        self.waited_on.append(threading.current_thread().name)
        self._ev.wait(10)


def _park(fiber_mod, poller_mod, objs):
    """One fiber per object awaiting ``device_ready``; returns the
    fibers (still parked until their objects become ready)."""
    async def wait(obj):
        r = await poller_mod.device_ready(obj)
        return getattr(r, "value", r)
    return [fiber_mod.spawn(wait, o) for o in objs]


def _values(fibers, timeout_s=10.0):
    out = []
    for f in fibers:
        assert f.join(timeout_s), "a parked fiber never resumed"
        out.append(f.value())
    return out


def case_futures(seed):
    rng = np.random.RandomState(seed)
    vals = [int(v) for v in rng.randint(0, 1 << 30, size=6)]
    results = {}
    for name, fmod, pmod in RUNTIMES:
        late = [Future() for _ in vals[:3]]
        early = [Future() for _ in vals[3:]]
        for f, v in zip(early, vals[3:]):
            f.set_result(v)
        fibers = _park(fmod, pmod, late + early)
        time.sleep(0.02)
        assert not any(f.done() for f in fibers[:3]), name
        for f, v in zip(late, vals[:3]):
            f.set_result(v)
        results[name] = _values(fibers)
    assert results["brpc_tpu"] == results["port"] == vals, results


def case_blocking_waits(seed):
    """Fake device arrays: each parked wait gets a waiter thread blocked
    in ``block_until_ready``; the fibers resume in any order of
    release."""
    rng = np.random.RandomState(seed)
    vals = [float(v) for v in rng.randn(5)]
    order = list(rng.permutation(len(vals)))
    results = {}
    for name, fmod, pmod in RUNTIMES:
        arrs = [_FakeArray(v) for v in vals]
        fibers = _park(fmod, pmod, arrs)
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and \
                not all(a.waited_on for a in arrs):
            time.sleep(0.002)
        assert all(a.waited_on == ["device_poller_wait"] for a in arrs), \
            (name, [a.waited_on for a in arrs])
        for i in order:
            arrs[i].release()
        results[name] = _values(fibers)
    assert results["brpc_tpu"] == results["port"] == vals, results


def case_poll_pump(seed):
    rng = np.random.RandomState(seed)
    vals = [int(v) for v in rng.randint(0, 1000, size=4)]
    results = {}
    for name, fmod, pmod in RUNTIMES:
        objs = [_PollOnly(v) for v in vals]
        fibers = _park(fmod, pmod, objs)
        time.sleep(0.01)
        assert not any(f.done() for f in fibers), name
        for o in objs:
            o.release()
        results[name] = _values(fibers)
    assert results["brpc_tpu"] == results["port"] == vals, results


def case_over_the_cap(seed):
    """Past ``_MAX_WAITERS`` parked waiter threads, waits go to the pump;
    every fiber resumes all the same."""
    rng = np.random.RandomState(seed)
    vals = [int(v) for v in rng.randint(0, 1000, size=7)]
    results = {}
    for name, fmod, pmod in RUNTIMES:
        saved = pmod._MAX_WAITERS
        pmod._MAX_WAITERS = 3
        try:
            arrs = [_FakeArray(v) for v in vals]
            fibers = _park(fmod, pmod, arrs)
            time.sleep(0.05)
            blocked = sum(bool(a.waited_on) for a in arrs)
            assert blocked <= 3, (name, blocked)
            for a in arrs:
                a.release()
            results[name] = _values(fibers)
        finally:
            pmod._MAX_WAITERS = saved
    assert results["brpc_tpu"] == results["port"] == vals, results


def case_cuda_event_interface():
    """The port alone: an object with ``query``/``synchronize`` (a
    torch.cuda.Event) parks on a waiter thread, and the fiber resumes
    with the event once its wait returns; an event already complete
    resumes at once, with no thread."""
    poller = port_poller.global_poller()
    ev = _FakeCudaEvent()
    before = dict(poller.nwaits)
    (f,) = _park(port_fiber, port_poller, [ev])
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and not ev.waited_on:
        time.sleep(0.002)
    assert ev.waited_on == ["device_poller_wait"]
    assert not f.done()
    ev.release()
    assert _values([f]) == [ev]
    done = _FakeCudaEvent()
    done.release()
    assert _values(_park(port_fiber, port_poller, [done])) == [done]
    assert poller.nwaits["waiter"] == before["waiter"] + 1
    assert poller.nwaits["ready"] == before["ready"] + 1
    assert poller.active_waiters == 0


def case_no_worker_blocked():
    """One worker: fibers parked on device events leave it free, so a
    fiber spawned after them runs to its end first."""
    control = port_fiber.TaskControl(concurrency=1, name="poller_test")
    try:
        events = [_FakeCudaEvent() for _ in range(4)]
        order = []

        async def parked(i, ev):
            await port_poller.device_ready(ev)
            order.append(("resumed", i,
                          threading.current_thread().name))

        async def other():
            order.append(("other", -1, threading.current_thread().name))

        fibers = [control.spawn(parked, i, ev)
                  for i, ev in enumerate(events)]
        time.sleep(0.02)
        f = control.spawn(other)
        assert f.join(5), "the one worker was blocked"
        for ev in events:
            ev.release()
        for fb in fibers:
            assert fb.join(5)
        assert order[0][0] == "other"
        assert sorted(i for k, i, _ in order if k == "resumed") == \
            [0, 1, 2, 3]
        assert {t for _, _, t in order} == {"poller_test_w0"}, order
    finally:
        control.stop_and_join()


def case_singleton_and_reset():
    p = port_poller.global_poller()
    assert port_fiber.global_poller() is p
    assert port_fiber.device_ready is port_poller.device_ready
    assert isinstance(p, port_fiber.DeviceEventPoller)
    saved = port_poller._global_poller
    try:
        port_poller._postfork_reset()
        fresh = port_poller.global_poller()
        assert fresh is not p
    finally:
        port_poller._global_poller = saved


CASES = [
    ("futures", case_futures, (1,)),
    ("blocking waits", case_blocking_waits, (2,)),
    ("poll pump", case_poll_pump, (3,)),
    ("over the cap", case_over_the_cap, (4,)),
    ("cuda event interface", case_cuda_event_interface, ()),
    ("no worker blocked", case_no_worker_blocked, ()),
    ("singleton and reset", case_singleton_and_reset, ()),
]


def test_device_poller():
    _run_cases(CASES)
