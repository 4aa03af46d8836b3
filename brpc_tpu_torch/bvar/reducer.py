"""Reducer family: Adder/Maxer/Miner/IntRecorder (the port of
brpc_tpu/bvar/reducer.py; bvar/reducer.h).

The reference's write path touches only a per-thread agent (AgentGroup,
bvar/detail/agent_group.h:50); reads combine all agents. We keep exactly
that shape: each thread lazily registers an agent object holding a plain
Python number — mutating it is GIL-atomic-enough because only the owning
thread writes it; readers sum/combine a snapshot of agents plus the values
"folded" from dead threads.
"""

from __future__ import annotations

import threading
from typing import Callable

from brpc_tpu_torch.bvar.variable import Variable


class _Agent:
    __slots__ = ("value", "count", "__weakref__")

    def __init__(self, identity):
        self.value = identity
        self.count = 0


class _ReducerBase(Variable):
    def __init__(self, identity, op: Callable):
        super().__init__()
        self._identity = identity
        self._op = op
        self._lock = threading.Lock()
        # strong refs keyed by thread id: a dead thread's final contribution
        # stays readable (an Adder must not forget a dead thread's counts);
        # if an id is reused, the stale agent folds into _folded first
        self._agents: dict = {}
        self._folded = identity
        self._tls = threading.local()

    def _agent(self) -> _Agent:
        ag = getattr(self._tls, "agent", None)
        if ag is None:
            ag = _Agent(self._identity)
            self._tls.agent = ag
            tid = threading.get_ident()
            with self._lock:
                stale = self._agents.get(tid)
                if stale is not None:
                    self._folded = self._op(self._folded, stale.value)
                self._agents[tid] = ag
        return ag

    def get_value(self):
        with self._lock:
            agents = list(self._agents.values())
            val = self._folded
        for ag in agents:
            val = self._op(val, ag.value)
        return val

    def postfork_clear(self) -> None:
        """In a forked child: forget every count (the parent's, and its
        threads', which do not exist here) and take a fresh lock, which a
        dead parent thread may have held. The owning module's postfork
        reset calls it for the counters that must count this process's
        own work only."""
        self._lock = threading.Lock()
        self._agents = {}
        self._folded = self._identity
        self._tls = threading.local()
        if hasattr(self, "_reset_offset"):
            self._reset_offset = self._identity

    # which sampling mode Window uses for this reducer (window.py):
    # "cumulative" = snapshot get_value and subtract; "delta" = reset per tick
    SERIES_MODE = "delta"

    def reset(self):
        """Combine-and-clear. NOTE: clearing ag.value races with the owning
        thread's unlocked read-modify-write; subclasses with subtractable
        values (Adder/IntRecorder) override this with an exact offset-based
        version — this base version is only for Maxer/Miner, where a racing
        update merely lands in the next interval."""
        with self._lock:
            agents = list(self._agents.values())
            val = self._folded
            self._folded = self._identity
            for ag in agents:
                val = self._op(val, ag.value)
                ag.value = self._identity
        return val


class Adder(_ReducerBase):
    """bvar::Adder — contention-free counter (reducer.h:224)."""

    SERIES_MODE = "cumulative"

    def __init__(self, value=0):
        super().__init__(value, lambda a, b: a + b)
        self._reset_offset = value

    def add(self, n=1):
        self._agent().value += n

    def __lshift__(self, n):
        self.add(n)
        return self

    def _raw_total(self):
        with self._lock:
            agents = list(self._agents.values())
            val = self._folded
        for ag in agents:
            val = self._op(val, ag.value)
        return val

    def get_value(self):
        return self._raw_total() - self._reset_offset

    def reset(self):
        """Exact combine-since-last-reset: subtract a remembered offset
        instead of clearing agent values (which would race with the owning
        threads' unlocked `value += n`)."""
        with self._lock:
            agents = list(self._agents.values())
            val = self._folded
            for ag in agents:
                val = self._op(val, ag.value)
            delta = val - self._reset_offset
            self._reset_offset = val
        return delta


class Maxer(_ReducerBase):
    def __init__(self):
        super().__init__(None, lambda a, b: b if a is None else (a if b is None else max(a, b)))

    def update(self, v):
        ag = self._agent()
        if ag.value is None or v > ag.value:
            ag.value = v

    __lshift__ = lambda self, v: (self.update(v), self)[1]


class Miner(_ReducerBase):
    def __init__(self):
        super().__init__(None, lambda a, b: b if a is None else (a if b is None else min(a, b)))

    def update(self, v):
        ag = self._agent()
        if ag.value is None or v < ag.value:
            ag.value = v

    __lshift__ = lambda self, v: (self.update(v), self)[1]


class IntRecorder(Variable):
    """Average of recorded ints; sum+count per thread agent (recorder.h:84)."""

    def __init__(self):
        super().__init__()
        self._sum = Adder(0)
        self._count = Adder(0)

    def record(self, v: int, times: int = 1):
        self._sum.add(v * times)
        self._count.add(times)

    __lshift__ = lambda self, v: (self.record(v), self)[1]

    @property
    def sum(self) -> int:
        return self._sum.get_value()

    @property
    def count(self) -> int:
        return self._count.get_value()

    def average(self) -> float:
        c = self.count
        return (self.sum / c) if c else 0.0

    def get_value(self):
        return self.average()

    def reset(self):
        s = self._sum.reset()
        c = self._count.reset()
        return (s, c)


class PassiveStatus(Variable):
    """Callback-valued variable (bvar/passive_status.h:42)."""

    def __init__(self, fn: Callable[[], object]):
        super().__init__()
        self._fn = fn

    def get_value(self):
        return self._fn()


class Status(Variable):
    """Set-valued variable (bvar/status.h:44)."""

    def __init__(self, value=None):
        super().__init__()
        self._value = value

    def set_value(self, v):
        self._value = v

    def get_value(self):
        return self._value
