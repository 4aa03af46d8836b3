"""racelane: the lock model's dynamic complement — seeded schedule
perturbation, a runtime lock-order assert and a deterministic field-race
replay (the port of brpc_tpu/analysis/racelane.py).

Static rules prove the acquisition GRAPH is clean; this module attacks
the schedules. ``install(seed=N)`` replaces ``threading.Lock`` /
``threading.RLock`` with instrumented twins that

  * inject a DETERMINISTIC yield point at lock acquisitions — whether
    acquisition #k at site S yields is a pure function of
    ``(seed, S, k)``;
  * name themselves from their creation site (``module:attr`` parsed
    from the assignment source line — the naming the static lock model
    uses) and, under ``BRPC_TPU_TORCH_LOCK_DEBUG=1``, assert the
    DECLARED acquisition order from ``LOCK_ORDER`` at every acquire: a
    ranked lock taken while holding a higher-ranked one is recorded
    (and raised in strict mode) with both holders named.

The declared order below is the sanctioned registry published in
``analysis/INVARIANTS.md`` — one line per lock, outermost first. Locks
not listed are unranked: they perturb but never trip the order assert.
A runtime name ``module:attr`` takes a row's rank when it is that row
(a module-level lock), when the row's owner module and attribute are
the name's (a class's lock, created in its own module), or else when
the attribute names exactly one row (a lock named at the site that
first touched it). Rows whose attribute is the generic ``_lock`` are
ambiguous at runtime and covered by the static lock-cycle rule only.

Wiring: ``brpc_tpu_torch/__init__`` calls ``maybe_install_from_env()``
so ``BRPC_TPU_TORCH_LOCK_DEBUG=1`` (or ``strict``; with optional
``BRPC_TPU_TORCH_LOCK_SEED``) instruments every lock created after
package import — tests spawn their victim in a subprocess with the env
set. ``python -m brpc_tpu_torch.analysis.racelane --smoke`` replays the
lint's suspicious pairs as concrete interleavings on two threads.

The field-race replay does not depend on load. Only the racer that
holds the TURN runs traced code; at each traced line the seed picks the
racer that runs next (another one, once in ``SWITCH_EVERY`` lines on
average), and a racer that hands the turn over waits on a condition
variable until it comes back. A racer passes the turn on when it leaves the traced
code, when it would block on a lock another racer holds, and when it
ends; every wait is bounded, so a real deadlock still shows as "racers
hung". Seed N thus runs the same interleaving of traced lines whatever
else the machine is doing.
"""

from __future__ import annotations

import _thread
import linecache
import os
import re
import sys
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

# ------------------------------------------------------ declared order
#
# The sanctioned lock acquisition order, OUTERMOST FIRST: a thread may
# only take a lock with a HIGHER rank index than everything it already
# holds. brpc_tpu's rows that name a lock this package has keep their
# relative order; each lock of the package's lock model that takes part
# in an acquisition edge goes where the edges nest it (the generic
# bvar leaf _ReducerBase._lock and the model's receiver-inferred twin
# nodes stay out, as in brpc_tpu). analysis/INVARIANTS.md publishes
# this table verbatim; tests/test_torch_graftlint.py holds every row to
# a lock the model found and every model edge to the declared order.
LOCK_ORDER: List[Tuple[str, str]] = [
    # (qualified lock name, owner module)
    # the server's connection set (brpc_tpu's Server._conns_lock)
    ("Server._sockets_lock",        "rpc/server.py"),
    ("ShardGroup._lock",            "rpc/shard_group.py"),
    ("ClusterChannel._sockets_lock", "rpc/cluster_channel.py"),
    # the channel's socket, pool and lease (brpc_tpu's _socket_lock and
    # _pool_lock); wraps the transport registry's lookup
    ("Channel._lock",               "rpc/channel.py"),
    ("Controller._arb_lock",        "rpc/controller.py"),
    ("Controller._lb_lock",         "rpc/controller.py"),
    ("CircuitBreaker._lock",        "rpc/circuit_breaker.py"),
    ("HealthChecker._lock",         "rpc/health_check.py"),
    ("backend_stats:_registry_lock", "rpc/backend_stats.py"),
    ("BackendStats._ring_lock",     "rpc/backend_stats.py"),
    ("BackendCell._lock",           "rpc/backend_stats.py"),
    ("ServingEngine._decode_lock",  "serving/engine.py"),
    # leaf: the decode kernel's split workspace, taken in the decode
    # step under the engine's decode lock (ops/flash_attention.py)
    ("flash_attention:_workspace_lock", "ops/flash_attention.py"),
    ("ContinuousBatcher._lock",     "serving/batcher.py"),
    ("_StreamSender._lock",         "serving/service.py"),
    # a stream's send order: taken under the serving sender's lock, and
    # wraps the socket's lane_lock when a frame carries tensors
    ("Stream._send_lock",           "rpc/stream.py"),
    # a gRPC call's state; its waits park on a Butex
    ("GrpcCall._lock",              "protocol/h2.py"),
    ("Butex._lock",                 "fiber/butex.py"),
    ("FlightRecorder._lock",        "builtin/flight_recorder.py"),
    ("Stream._grant_lock",          "rpc/stream.py"),
    ("ProgressiveAttachment._lock", "rpc/progressive.py"),
    # the relay writes a whole message under a player's lane_lock
    ("RtmpService._lock",           "protocol/rtmp.py"),
    ("Socket.lane_lock",            "transport/socket.py"),
    ("Socket._handoff_lock",        "transport/socket.py"),
    ("Socket._failed_cb_lock",      "transport/socket.py"),
    # TLS: a read or write under the SSL object's lock (re)arms the
    # dispatcher's interest
    ("SslConn._ssl_lock",           "transport/ssl.py"),
    ("EventDispatcher._lock",       "transport/event_dispatcher.py"),
    # ring-lane twin of the dispatcher lock: only native ring calls run
    # under it, so it never wraps another Python acquisition
    ("RingDispatcher._lock",        "transport/ring_lane.py"),
    ("event_dispatcher:_glock",     "transport/event_dispatcher.py"),
    ("DoublyBufferedData._write_lock", "butil/doubly_buffered.py"),
    ("socket_map:_glock",           "transport/socket_map.py"),
    ("base:_lock",                  "transport/base.py"),
    ("CudadConn._flush_lock",       "transport/cudad.py"),
    ("CudadConn._lock",             "transport/cudad.py"),
    ("IciConn._pump_lock",          "transport/ici.py"),
    ("IciConn._flush_lock",         "transport/ici.py"),
    ("IciConn._lock",               "transport/ici.py"),
    ("IciConn._fc_lock",            "transport/ici.py"),
    ("ici:_local_lock",             "transport/ici.py"),
    # leaf: device transfer cell — stamped by BatchTracker settle paths
    # that run under IciConn flush/pump holds (transport/device_stats.py)
    ("DeviceCell._lock",            "transport/device_stats.py"),
    ("cuda_ipc:_map_lock",          "transport/cuda_ipc.py"),
    ("cuda_ipc:_lock",              "transport/cuda_ipc.py"),
    ("variable:_registry_lock",     "bvar/variable.py"),
    ("postfork:_lock",              "butil/postfork.py"),
    ("resource_census:_lock",       "butil/resource_census.py"),
    # leaf: drained inside the controller's _arb_lock hold
    ("RetryBudget._lock",           "rpc/retry_policy.py"),
    # the call registry, under _arb_lock; its ids come from the pool
    ("client_dispatch:_lock",       "rpc/client_dispatch.py"),
    ("ResourcePool._lock",          "butil/resource_pool.py"),
    ("PeriodicTask._lock",          "rpc/periodic_task.py"),
    ("timer:_lock",                 "fiber/timer.py"),
    ("inject:_install_lock",        "chaos/inject.py"),
    ("registry:_init_lock",         "protocol/registry.py"),
    ("registry:_lock",              "protocol/registry.py"),
    # leaf: the traffic recorder's queue lock — taken bare on the
    # dispatch completion path and by the writer's O(1) queue swap
    ("Recorder._lock",              "traffic/capture.py"),
    # leaves settled on the bvar sampler's tick thread
    ("SeriesCollector._lock",       "bvar/series.py"),
    ("AnomalyWatchdog._lock",       "bvar/anomaly.py"),
    # leaf: the admission controller's window histogram
    ("AdmissionController._lock",   "rpc/admission.py"),
    # leaf: the channel-group budget registry
    ("retry_policy:_group_lock",    "rpc/retry_policy.py"),
    # leaf: the incident manager's window state
    ("IncidentManager._lock",       "incident/manager.py"),
    # leaf: one per-method serving stat cell
    ("ServingCell._cell_lock",      "serving/serving_stats.py"),
    # leaf: the flight deck's bounded step ring
    ("ServingStats._ring_lock",     "serving/serving_stats.py"),
]

_RANK: Dict[str, int] = {name: i for i, (name, _) in enumerate(LOCK_ORDER)}


def _row_attr(name: str) -> str:
    return name.split(":")[-1].split(".")[-1]


def _row_module(owner: str) -> str:
    return os.path.basename(owner)[:-3]


# (owner module, attr) -> rank, for attrs that are not the generic _lock
_BY_MODULE_ATTR: Dict[Tuple[str, str], List[int]] = {}
# attr -> ranks, for the site-named fallback
_BY_ATTR: Dict[str, List[int]] = {}
for _i, (_n, _owner) in enumerate(LOCK_ORDER):
    _BY_MODULE_ATTR.setdefault((_row_module(_owner), _row_attr(_n)),
                               []).append(_i)
    _BY_ATTR.setdefault(_row_attr(_n), []).append(_i)

_ASSIGN_RE = re.compile(
    r"(?:self\.)?([A-Za-z_][A-Za-z0-9_]*)\s*=\s*"
    r"(?:threading\.)?(?:Lock|RLock)\s*\(")

# fallback for factory-indirected creation: the creating line is
# `v = factory()`, but a frame ABOVE it is the attribute access
# (`with obj._x_lock:`) — a lock-ish attribute token there names the lock
_ATTR_RE = re.compile(
    r"[.\s(\[]([A-Za-z_][A-Za-z0-9_]*(?:lock|mutex)[A-Za-z0-9_]*)",
    re.IGNORECASE)


class LockOrderViolation(AssertionError):
    """A ranked lock was acquired while a higher-ranked one was held."""


class _State:
    """Module state for one install() session."""

    def __init__(self):
        self.installed = False
        self.seed = 0
        self.strict = False
        self.perturb = True
        self.yield_period = 7          # acquire #k yields when
        #                                hash(site, k, seed) % period == 0
        self.real_lock = None          # saved threading.Lock
        self.real_rlock = None         # saved threading.RLock
        self.acquires = 0              # global acquisition counter
        self.ranked_acquires = 0       # of those, of a ranked lock
        self.yields = 0
        self.violations: List[dict] = []
        self.lock_names: List[str] = []   # names seen at creation
        # the field-race replay in progress, if any (its racers' lock
        # waits pass the turn on)
        self.replay: Optional["_Replay"] = None
        # per-THREAD ownership: .held = [(name, rank)] in acquisition
        # order, .counts = {id(lock): recursion depth}, keyed by
        # INSTANCE: holding another object's same-named lock is nesting
        # to order-check, not recursion to wave through
        self.tl = threading.local()

    def held(self) -> list:
        h = getattr(self.tl, "held", None)
        if h is None:
            h = self.tl.held = []
        return h

    def counts(self) -> dict:
        c = getattr(self.tl, "counts", None)
        if c is None:
            c = self.tl.counts = {}
        return c


_state = _State()


def _creation_site_name(depth: int = 2) -> Tuple[str, bool]:
    """Name a lock from its creation source line — 'module:attr' like
    the static model — and say whether the name came from the creating
    assignment itself (True) or from an attribute access a few frames up
    that triggered a factory's creation (False)."""
    try:
        for d in range(depth, depth + 4):
            try:
                f = sys._getframe(d)
            except ValueError:
                break
            fn, ln = f.f_code.co_filename, f.f_lineno
            line = linecache.getline(fn, ln)
            m = _ASSIGN_RE.search(line)
            direct = m is not None
            if m is None:
                m = _ATTR_RE.search(line)
            if m:
                mod = os.path.basename(fn)
                if mod.endswith(".py"):
                    mod = mod[:-3]
                return f"{mod}:{m.group(1)}", direct and d == depth
        return "<anon>:<anon>", False
    except Exception:
        return "<anon>:<anon>", False


def _rank_of(name: str, direct: bool = True) -> Optional[int]:
    if name in _RANK:
        return _RANK[name]
    mod, _, attr = name.partition(":")
    if attr == "_lock":
        return None
    if direct:
        hits = _BY_MODULE_ATTR.get((mod, attr), [])
        if len(hits) == 1:
            return hits[0]
    # unique attr ('_arb_lock' names exactly one registry row)
    hits = _BY_ATTR.get(attr, [])
    if len(hits) == 1:
        return hits[0]
    return None


def _registry_name(name: str, rank: Optional[int]) -> str:
    return LOCK_ORDER[rank][0] if rank is not None else name


def _perturb_point(site: str) -> None:
    """The deterministic yield: whether acquisition #k at this site
    yields is a pure function of (seed, site, k)."""
    st = _state
    st.acquires += 1
    if not st.perturb:
        return
    k = st.acquires
    # crc32, NOT builtin hash(): str hashing is salted per process
    h = zlib.crc32(f"{st.seed}|{site}|{k}".encode())
    if h % st.yield_period == 0:
        st.yields += 1
        time.sleep(0)


def _order_check(name: str, rank: Optional[int]) -> None:
    st = _state
    if rank is None:
        return
    st.ranked_acquires += 1
    held = st.held()
    for hname, hrank in held:
        if hrank is not None and hrank > rank:
            v = {"acquiring": _registry_name(name, rank),
                 "acquiring_rank": rank,
                 "holding": _registry_name(hname, hrank),
                 "holding_rank": hrank,
                 "thread": threading.current_thread().name}
            st.violations.append(v)
            if st.strict:
                raise LockOrderViolation(
                    f"lock order inversion: acquiring "
                    f"{v['acquiring']} (rank {rank}) while holding "
                    f"{v['holding']} (rank {hrank}) — the declared "
                    "order in analysis/racelane.py:LOCK_ORDER says "
                    "the opposite nesting")
            break


class _DebugLockBase:
    """Shared instrumentation over a real lock primitive."""

    _factory = None        # set by install()

    def __init__(self):
        self._inner = self._factory()
        self.name, direct = _creation_site_name(2)
        self.rank = _rank_of(self.name, direct)
        self._owner: Optional[int] = None
        _state.lock_names.append(self.name)

    # -- the threading.Lock protocol ---------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1):
        counts = _state.counts()
        mine = counts.get(id(self), 0)
        if blocking:
            _perturb_point(self.name)
            if mine == 0:
                # order is asserted on acquisition INTENT, before the
                # inner acquire: the deadlocked half of an AB/BA pair
                # never returns from acquire. In strict mode this raises
                # BEFORE anything is held — nothing leaks.
                _order_check(self.name, self.rank)
        rp = _state.replay
        if blocking and mine == 0 and rp is not None \
                and rp.is_racer() and timeout < 0:
            got = rp.acquire(self)
        else:
            got = self._inner.acquire(blocking, timeout)
        if got:
            counts[id(self)] = mine + 1
            if mine == 0:
                self._owner = _thread.get_ident()
                _state.held().append((self.name, self.rank))
        return got

    def release(self):
        counts = _state.counts()
        mine = counts.get(id(self), 0)
        if mine <= 1:
            self._owner = None
        self._inner.release()
        if mine:       # a cross-thread Lock release skips bookkeeping
            if mine == 1:
                counts.pop(id(self))     # no stale id-keyed entries
                held = _state.held()
                for i in range(len(held) - 1, -1, -1):
                    if held[i][0] == self.name:
                        del held[i]
                        break
            else:
                counts[id(self)] = mine - 1
        rp = _state.replay
        if rp is not None and self._owner is None:
            rp.released(self)

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def _at_fork_reinit(self):
        self._inner = self._factory()
        self._owner = None


class DebugLock(_DebugLockBase):
    pass


class DebugRLock(_DebugLockBase):
    """RLock twin; also speaks the Condition protocol (_is_owned /
    _release_save / _acquire_restore) — the stdlib fallback probes
    ownership with a NON-reentrant acquire(False), which an RLock
    answers wrongly, so delegation here is load-bearing."""

    def _is_owned(self):
        return self._inner._is_owned()

    def _recursion_count(self):
        # multiprocessing's resource tracker asks its RLock this
        return self._inner._recursion_count()

    def _release_save(self):
        self._owner = None
        state = self._inner._release_save()
        counts = _state.counts()
        depth = counts.pop(id(self), 0)
        held = _state.held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == self.name:
                del held[i]
                break
        rp = _state.replay
        if rp is not None:
            rp.released(self)
        return (state, depth)

    def _acquire_restore(self, saved):
        state, depth = saved
        self._inner._acquire_restore(state)
        self._owner = _thread.get_ident()
        _state.counts()[id(self)] = depth
        _state.held().append((self.name, self.rank))


def install(seed: Optional[int] = None, strict: bool = False,
            perturb: bool = True, yield_period: int = 7) -> None:
    """Instrument every lock created from now on. Idempotent."""
    st = _state
    if not st.installed:
        st.real_lock = threading.Lock
        st.real_rlock = threading.RLock
        DebugLock._factory = staticmethod(st.real_lock)
        DebugRLock._factory = staticmethod(st.real_rlock)
        threading.Lock = DebugLock
        threading.RLock = DebugRLock
        st.installed = True
    st.seed = 0 if seed is None else int(seed)
    st.strict = bool(strict)
    st.perturb = bool(perturb)
    st.yield_period = max(2, int(yield_period))


def uninstall() -> None:
    st = _state
    if st.installed:
        threading.Lock = st.real_lock
        threading.RLock = st.real_rlock
        st.installed = False


def installed() -> bool:
    return _state.installed


def violations() -> List[dict]:
    return list(_state.violations)


def clear_violations() -> None:
    _state.violations.clear()


def stats() -> dict:
    return {"installed": _state.installed, "seed": _state.seed,
            "acquires": _state.acquires,
            "ranked_acquires": _state.ranked_acquires,
            "yields": _state.yields,
            "locks_created": len(_state.lock_names),
            "violations": len(_state.violations)}


def maybe_install_from_env() -> bool:
    """The brpc_tpu_torch/__init__ hook: BRPC_TPU_TORCH_LOCK_DEBUG=1
    instruments (order-asserting, perturbing with
    BRPC_TPU_TORCH_LOCK_SEED, strict with
    BRPC_TPU_TORCH_LOCK_DEBUG=strict)."""
    mode = os.environ.get("BRPC_TPU_TORCH_LOCK_DEBUG", "")
    if mode not in ("1", "strict"):
        return False
    seed = 0
    try:
        seed = int(os.environ.get("BRPC_TPU_TORCH_LOCK_SEED", "0"))
    except ValueError:
        pass
    install(seed=seed, strict=(mode == "strict"))
    return True


# ----------------------------------------------------------- replays

def replay_pair(setup, thread_a, thread_b, seed: int,
                timeout_s: float = 5.0) -> dict:
    """Replay a suspicious lock pair as a concrete interleaving: run
    ``thread_a``/``thread_b`` (callables taking the object built by
    ``setup()``) on two threads under seeded perturbation and report
    violations + completion (a hang within the timeout = potential
    deadlock, reported, threads abandoned as daemons)."""
    clear_violations()
    # the REQUESTED seed, and the acquisition counter the yield schedule
    # is keyed on reset: the same replay sees the same k sequence
    _state.seed = int(seed)
    _state.acquires = 0
    obj = setup()
    done = [False, False]

    def run(fn, i):
        try:
            fn(obj)
        finally:
            done[i] = True

    ta = threading.Thread(target=run, args=(thread_a, 0), daemon=True)
    tb = threading.Thread(target=run, args=(thread_b, 1), daemon=True)
    ta.start()
    tb.start()
    ta.join(timeout_s)
    tb.join(timeout_s)
    return {"seed": seed, "completed": all(done),
            "violations": violations(),
            "stats": stats()}


# ------------------------------------------------- field-race replay
#
# The guarded-by rule's dynamic complement: a flagged site is a source
# LINE that mutates a field with the inferred guard not held. Replaying
# it runs the two implicated code paths on two threads that take TURNS
# at every traced line, the seed choosing who runs next — so the window
# between a site's check and its act opens at the same lines, run after
# run, whatever the load. A finding whose replay breaks the caller's
# invariant ships as CONFIRMED with this reproducer (seed + sites).

#: At each traced line the seed hands the turn to another racer once in
#: this many lines on average: runs of several lines on one racer are
#: what open a check-then-act window that spans more than one line.
SWITCH_EVERY = 16


def _parse_site(site) -> Tuple[str, int]:
    """'pkg/mod.py:123' or ('mod.py', 123) -> ('mod.py', 123)."""
    if isinstance(site, str):
        path, _, ln = site.rpartition(":")
        return os.path.basename(path), int(ln)
    path, ln = site
    return os.path.basename(str(path)), int(ln)


class _Replay:
    """The turn of one field-race replay. Its condition variable is
    built on a raw lock, outside the instrumentation it steers."""

    def __init__(self, seed: int, nracers: int, wait_s: float):
        self.cv = threading.Condition(_thread.allocate_lock())
        self.seed = seed
        self.n = nracers
        self.turn = 0
        self.alive = [True] * nracers
        # the lock a racer waits for (held by another racer), or None
        self.blocked: List[Optional[object]] = [None] * nracers
        self.k = 0
        # turn changes in the sequence of traced lines run: a function
        # of that sequence alone, so the same for the same seed
        self.switches = 0
        self._last: Optional[int] = None
        self.wait_s = wait_s
        self.switch_every = SWITCH_EVERY
        self.broken: Optional[str] = None
        self.idents: Dict[int, int] = {}

    # -- bookkeeping (self.cv held) ----------------------------------
    def _candidates(self, exclude: int = -1) -> List[int]:
        return [j for j in range(self.n) if j != exclude
                and self.alive[j] and self.blocked[j] is None]

    def _mine(self, i: int) -> bool:
        if self.blocked[i] is not None:
            return False
        if self.turn == i:
            return True
        # the holder ended or is stuck on a lock: the lowest-numbered
        # free racer takes the turn over
        if self.alive[self.turn] and self.blocked[self.turn] is None:
            return False
        free = self._candidates()
        return bool(free) and free[0] == i

    def _wait_turn(self, i: int) -> None:
        deadline = time.monotonic() + self.wait_s
        while self.broken is None and not self._mine(i):
            left = deadline - time.monotonic()
            if left <= 0:
                self.broken = (f"racer_{'ab'[i]} waited {self.wait_s}s "
                               "for its turn (potential deadlock)")
                self.cv.notify_all()
                return
            self.cv.wait(left)
        if self.broken is None:
            self.turn = i

    def _pick(self, cands: List[int]) -> int:
        self.k += 1
        return cands[zlib.crc32(f"{self.seed}|{self.k}".encode())
                     % len(cands)]

    def _pass_on(self, i: int) -> None:
        """Hand the turn to another racer, if one can take it."""
        cands = self._candidates(exclude=i)
        if cands:
            self.turn = self._pick(cands)
            self.cv.notify_all()

    # -- the racers' side --------------------------------------------
    def is_racer(self) -> bool:
        return self.broken is None and _thread.get_ident() in self.idents

    def enter(self, i: int) -> None:
        with self.cv:
            if self.broken is None:
                self._wait_turn(i)

    def leave(self, i: int) -> None:
        with self.cv:
            if self.broken is None and self.turn == i:
                self._pass_on(i)

    def end(self, i: int) -> None:
        with self.cv:
            self.alive[i] = False
            if self.turn == i:
                self._pass_on(i)
            self.cv.notify_all()

    def decide(self, i: int) -> None:
        """A traced line: the seed picks who runs it."""
        with self.cv:
            if self.broken is not None:
                return
            if self._last is not None and self._last != i:
                self.switches += 1
            self._last = i
            others = self._candidates(exclude=i)
            self.k += 1
            h = zlib.crc32(f"{self.seed}|{self.k}".encode())
            if others and h % self.switch_every == 0:
                self.turn = others[(h // self.switch_every) % len(others)]
                self.cv.notify_all()
                self._wait_turn(i)

    def acquire(self, lock: "_DebugLockBase") -> bool:
        """A racer's blocking acquire: a lock another racer holds passes
        the turn on until that racer releases it; a lock another thread
        holds is waited for with the turn kept (that thread runs free)."""
        i = self.idents[_thread.get_ident()]
        while not lock._inner.acquire(False):
            owner = lock._owner
            with self.cv:
                if self.broken is not None or owner not in self.idents:
                    other = True
                else:
                    other = False
                    self.blocked[i] = lock
                    if self.turn == i:
                        self._pass_on(i)
                    self._wait_turn(i)
            if other:
                return lock._inner.acquire()
        return True

    def released(self, lock: "_DebugLockBase") -> None:
        with self.cv:
            hit = False
            for j in range(self.n):
                if self.blocked[j] is lock:
                    self.blocked[j] = None
                    hit = True
            if hit:
                self.cv.notify_all()


def _make_tracer(rp: _Replay, i: int, files, lines, quals):
    """The trace function of racer ``i``: frames of the watched files
    and functions are the traced code; their lines in ``lines`` (or any
    line of a watched function) are the replay's decision points."""
    depth = [0]
    leaves = {q.split(".")[-1] for q in quals}

    def match_qual(code) -> bool:
        # suffix match on a dot boundary: functions built inside a
        # factory carry '<locals>.' prefixes in co_qualname
        qual = getattr(code, "co_qualname", None)
        if qual is None:
            return code.co_name in leaves
        return any(qual == q or qual.endswith("." + q) for q in quals)

    def local(frame, event, arg):
        if event == "line":
            code = frame.f_code
            if (os.path.basename(code.co_filename), frame.f_lineno) \
                    in lines or match_qual(code):
                rp.decide(i)
        elif event == "return":
            depth[0] -= 1
            if depth[0] == 0:
                rp.leave(i)
        return local

    def call_hook(frame, event, arg):
        code = frame.f_code
        if os.path.basename(code.co_filename) in files or \
                match_qual(code):
            depth[0] += 1
            if depth[0] == 1:
                rp.enter(i)
            return local
        return None

    return call_hook


def replay_field_race(setup, racer_a, racer_b, sites, seed: int = 0,
                      check=None, timeout_s: float = 10.0) -> dict:
    """Replay a guarded-by finding as a deterministic interleaving.

    ``setup()`` builds the victim object; ``racer_a``/``racer_b`` are
    the two implicated code paths (callables taking the object);
    ``sites`` mixes flagged source lines (``'path.py:123'`` strings or
    ``(file, line)`` pairs) with function qualnames (every line of the
    function is a decision point — drift-proof against edits). The
    locks ``setup()`` makes must be instrumented, so the lane is
    installed for the replay if it is not. After both racers finish,
    ``check(obj)`` validates the field's invariant; its message is the
    reproducer's evidence. Returns ``{seed, completed, site_yields, ok,
    evidence}``: ``site_yields`` counts the turn changes in the sequence
    of traced lines run, the same number for the same seed on every
    run."""
    lines = set()
    quals = set()
    for s in sites:
        if isinstance(s, str) and ":" not in s:
            quals.add(s)
        else:
            lines.add(_parse_site(s))
    files = {f for f, _ in lines}
    was_installed = _state.installed
    if not was_installed:
        install(seed=seed, perturb=False)
    try:
        obj = setup()
    finally:
        if not was_installed:
            uninstall()
    rp = _Replay(seed, 2, timeout_s)
    done = [False, False]
    errs: List[str] = []
    # both racers register before either runs traced code
    barrier = threading.Barrier(3)

    def run(fn, i):
        rp.idents[_thread.get_ident()] = i
        barrier.wait(timeout_s)
        sys.settrace(_make_tracer(rp, i, files, lines, quals))
        try:
            fn(obj)
        except Exception as e:   # noqa: BLE001 - the report carries it
            errs.append(f"racer_{'ab'[i]}: {e!r}")
        finally:
            sys.settrace(None)
            rp.end(i)
            done[i] = True

    ta = threading.Thread(target=run, args=(racer_a, 0), daemon=True)
    tb = threading.Thread(target=run, args=(racer_b, 1), daemon=True)
    ta.start()
    tb.start()
    _state.replay = rp
    try:
        barrier.wait(timeout_s)
        ta.join(timeout_s)
        tb.join(timeout_s)
    finally:
        _state.replay = None
    completed = all(done)
    evidence = sorted(errs)
    ok = completed and not errs and rp.broken is None
    if rp.broken is not None:
        evidence.append(rp.broken)
    if ok and check is not None:
        try:
            verdict = check(obj)
            if verdict not in (None, True):
                ok = False
                evidence.append(str(verdict))
        except AssertionError as e:
            ok = False
            evidence.append(str(e) or "invariant check failed")
    if not completed:
        evidence.append(f"racers hung past {timeout_s}s "
                        "(potential deadlock; daemons abandoned)")
    return {"seed": seed, "completed": completed,
            "site_yields": rp.switches,
            "ok": ok, "evidence": evidence}


# The suspicious-pair list the smoke replays: each entry is a named
# builder returning (setup, racer_a, racer_b, sites, check,
# expect_race). `expect_race=True` rows are positive controls — the
# replay MUST break their invariant; `False` rows are fixed findings —
# the replay must leave the invariant intact.

def _pair_unguarded_counter():
    """Positive control: the textbook lost update. The read-modify-
    write is split across two lines so a turn can change hands inside
    the window; 2x200 increments with no lock must lose some."""
    class _Cell:
        def __init__(self):
            self.x = 0

        def bump(self):
            t = self.x
            self.x = t + 1

    def racer(o):
        for _ in range(200):
            o.bump()

    def check(o):
        assert o.x == 400, f"lost update: {o.x}/400 after 2x200 bumps"

    return _Cell, racer, racer, ["_Cell.bump"], check, True


def _pair_guarded_counter():
    """The same counter with its guard held: zero lost updates under
    the identical turn schedule — the twin that proves detection is the
    race, not the harness."""
    class _Cell:
        def __init__(self):
            self._lock = threading.Lock()
            self.x = 0

        def bump(self):
            with self._lock:
                t = self.x
                self.x = t + 1

    def racer(o):
        for _ in range(200):
            o.bump()

    def check(o):
        assert o.x == 400, f"guarded counter lost updates: {o.x}"

    return _Cell, racer, racer, ["_Cell.bump"], check, False


def _pair_taskcontrol_stop_vs_start():
    """The fixed teardown race of the fiber pool: TaskControl.
    stop_and_join claims and clears the worker list under _start_lock
    and keeps _started set through the join, so a start() landing in
    the teardown window no-ops instead of leaving a pool that CLAIMS
    started with every worker dead. The invariant is 'started implies
    a live worker'."""
    from brpc_tpu_torch.fiber.scheduler import TaskControl

    def setup():
        return TaskControl(concurrency=2, name="racelane_tc")

    def starter(tc):
        for _ in range(6):
            tc.start()
            time.sleep(0)

    def stopper(tc):
        for _ in range(6):
            tc.stop_and_join(timeout=2.0)

    def check(tc):
        try:
            with tc._start_lock:
                started = tc._started
                alive = [t for t in tc._threads if t.is_alive()]
            assert not started or alive, (
                "pool claims started with no live worker: start() "
                "landed inside stop_and_join's teardown window")
        finally:
            tc.stop_and_join(timeout=2.0)

    return (setup, starter, stopper,
            ["TaskControl.start", "TaskControl.stop_and_join"],
            check, False)


SUSPICIOUS_PAIRS = [
    ("unguarded-counter", _pair_unguarded_counter),
    ("guarded-counter", _pair_guarded_counter),
    ("taskcontrol-stop-vs-start", _pair_taskcontrol_stop_vs_start),
]


def replay_suspicious_pairs(seed: int = 0) -> dict:
    """Run every registered pair; ok = every positive control raced
    and every fixed finding held its invariant."""
    out: dict = {"pairs": {}, "ok": True}
    for name, build in SUSPICIOUS_PAIRS:
        setup, ra, rb, sites, check, expect_race = build()
        r = replay_field_race(setup, ra, rb, sites, seed=seed,
                              check=check)
        raced = not r["ok"]
        good = r["completed"] and (raced == expect_race)
        out["pairs"][name] = {"expect_race": expect_race,
                              "raced": raced, **r}
        out["ok"] = out["ok"] and good
    return out


# ------------------------------------------------------------- smoke

def _smoke() -> dict:
    """The smoke lane: (1) a seeded synthetic AB/BA inversion must be
    DETECTED deterministically (same seed, same verdict, run twice);
    (2) the real serving batcher under perturbation + order assert runs
    a submit/step storm with zero violations; (3) the suspicious pairs
    replay as expected."""
    report: dict = {"ok": False}
    try:
        seed = int(os.environ.get("BRPC_TPU_TORCH_LOCK_SEED", "0") or "0")
    except ValueError:
        seed = 0
    if not _state.installed:
        install(seed=seed)
    else:
        # the package import hook installed with the seed the env had
        # THEN — a --seed passed to the CLI must still win
        _state.seed = seed

    # -- (1) synthetic inversion: two registry-ranked locks taken in
    # the wrong order on thread B while thread A uses the sanctioned
    # order. The order assert must flag B's inversion both runs.
    def build_pair():
        class _Arb:                       # mimic the registry rows
            pass
        o = _Arb()
        o._arb_lock = threading.RLock()   # rank: Controller._arb_lock
        o._lb_lock = threading.Lock()     # rank: Controller._lb_lock
        return o

    def good_path(o):
        for _ in range(20):
            with o._arb_lock:
                with o._lb_lock:          # sanctioned: arb then lb
                    pass

    def bad_path(o):
        for _ in range(20):
            with o._lb_lock:
                with o._arb_lock:         # inversion: lb then arb
                    pass

    strict, _state.strict = _state.strict, False
    runs = []
    try:
        for _ in range(2):
            r = replay_pair(build_pair, good_path, bad_path, _state.seed,
                            timeout_s=2.0)
            runs.append({"completed": r["completed"],
                         "deadlocked": not r["completed"],
                         "violations": len(r["violations"]),
                         "first": (r["violations"][0]
                                   if r["violations"] else None)})
    finally:
        _state.strict = strict
    report["seeded_inversion"] = runs
    detected = all(r["violations"] > 0 for r in runs)
    deterministic = (runs[0]["first"] is not None
                     and runs[1]["first"] is not None
                     and runs[0]["first"]["acquiring"]
                     == runs[1]["first"]["acquiring"]
                     and runs[0]["first"]["holding"]
                     == runs[1]["first"]["holding"])
    report["inversion_detected"] = detected
    report["inversion_deterministic"] = deterministic

    # -- (2) real code under perturbation: batcher submit/step storm on
    # a small model on the CPU
    clear_violations()
    from brpc_tpu_torch.serving.batcher import ContinuousBatcher, GenRequest
    from brpc_tpu_torch.serving.model import TinyDecoder, TinyDecoderConfig
    b = ContinuousBatcher(TinyDecoder(TinyDecoderConfig(), device="cpu"),
                          max_batch=2, max_waiting=8)
    errs: List[str] = []

    def submitter():
        for _ in range(24):
            try:
                b.submit(GenRequest([1, 2, 3], 4))
            except Exception as e:   # noqa: BLE001 - report, don't die
                errs.append(f"submit: {e!r}")

    def stepper():
        for _ in range(60):
            try:
                b.step()
            except Exception as e:   # noqa: BLE001
                errs.append(f"step: {e!r}")

    ts = [threading.Thread(target=submitter, daemon=True),
          threading.Thread(target=stepper, daemon=True)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60.0)
    b.stop()
    real_viol = violations()
    report["real_code"] = {"errors": errs[:5],
                           "violations": real_viol[:5],
                           "stats": stats()}
    report["real_code_clean"] = not errs and not real_viol

    # -- (3) the guarded-by suspicious-pair list: positive controls
    # must race, fixed findings must hold their invariant
    report["field_races"] = replay_suspicious_pairs(_state.seed)
    report["ok"] = bool(detected and deterministic
                        and report["real_code_clean"]
                        and report["field_races"]["ok"])
    return report


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import json
    p = argparse.ArgumentParser(
        prog="racelane",
        description="seeded lock-schedule perturbation + order assert")
    p.add_argument("--smoke", action="store_true",
                   help="run the seeded-interleaving smoke (JSON out)")
    p.add_argument("--seed", type=int, default=None)
    args = p.parse_args(argv)
    if args.seed is not None:
        os.environ["BRPC_TPU_TORCH_LOCK_SEED"] = str(args.seed)
    if not args.smoke:
        p.print_help()
        return 2
    report = _smoke()
    print(json.dumps(report, indent=2, default=str))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    # delegate to the canonical module object: under -m the package
    # __init__ may already have imported (and installed from) the
    # brpc_tpu_torch.analysis.racelane copy — running the smoke on a
    # second __main__ copy would split _state across two modules
    from brpc_tpu_torch.analysis import racelane as _canonical

    sys.exit(_canonical.main())
