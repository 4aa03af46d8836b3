"""Thread-role model: which thread executes each function.

Seeds come from the lock model's resolved ``threading.Thread`` roots —
the dispatcher tick, ring-lane tick, timer thread, device poller and
its per-block waiters, fiber worker pool, shard supervisor, bvar
sampler, flight-recorder sampler, capture writer, incident bundler —
plus every module's ``_postfork_reset``
handler (the fork child is single-threaded when they run). Each seed
is classified into a ROLE and the role propagates forward over the
resolved call graph: a function reachable from the dispatcher tick
runs (at least sometimes) on the dispatcher thread.

Two refinements keep the model honest rather than optimistic:

* a function reachable from several seeds carries several roles — the
  guarded-by rule treats fields written from multiple roles as shared
  state, ranked highest when unguarded;
* "external" is itself a role: any function reachable from an in-tree
  entry point that no seeded thread reaches (public API, helpers only
  tests call) may execute on an arbitrary caller thread. A function on
  both a seed path and an external path carries both roles, so
  `Socket.write()` called by user code *and* the dispatcher is never
  mistaken for thread-confined.

Single-thread roles (dispatcher, timer, poller, the samplers, the
supervisor, postfork) back the thread-confinement exemption: a field
written only from one single-thread role has a single writer by
construction and needs no lock. The fiber worker pool is N threads and
"external" is any number of caller threads — neither is single-thread.
"""

from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from brpc_tpu_torch.analysis.core import Context
from brpc_tpu_torch.analysis.lockmodel import LockModel, get_lock_model

#: Known thread entry points: (module suffix, qualname, role).
_SEED_ROLES: Tuple[Tuple[str, str, str], ...] = (
    ("transport.event_dispatcher", "EventDispatcher._run", "dispatcher"),
    ("transport.ring_lane", "RingDispatcher._run", "ring-dispatcher"),
    ("fiber.timer", "TimerThread._run", "timer"),
    ("fiber.device_poller", "DeviceEventPoller._run", "device-poller"),
    ("fiber.scheduler", "TaskControl._worker", "fiber"),
    ("rpc.shard_group", "ShardGroup._monitor_loop", "supervisor"),
    ("bvar.window", "Sampler._run", "bvar-sampler"),
    ("builtin.flight_recorder", "FlightRecorder._loop", "flight-sampler"),
    ("traffic.capture", "Recorder._record_writer_loop", "capture-writer"),
    # one thread per waited device block (up to the poller's waiter cap)
    ("fiber.device_poller", "DeviceEventPoller._wait_and_fire",
     "device-waiter"),
    # one thread per sealed incident; a bundle may outlast the next seal
    ("incident.manager", "IncidentManager._bundle_worker",
     "incident-bundler"),
)

#: Roles backed by exactly one OS thread at a time. "fiber" (a pool),
#: "device-waiter" and "incident-bundler" (a thread per event) and
#: "external" (arbitrary caller threads) are deliberately absent, as are
#: ad-hoc "thread:<leaf>" roles for unrecognized future roots. A thread
#: whose target is a nested function (rpc/lane_ab.py's client threads)
#: is no root at all: nested defs are not summarized, so what they call
#: carries the external role of any caller thread.
SINGLE_THREAD_ROLES: FrozenSet[str] = frozenset((
    "dispatcher", "ring-dispatcher", "timer", "device-poller",
    "supervisor", "bvar-sampler", "flight-sampler", "capture-writer",
    "postfork",
))

#: The synthetic role for code reachable only from unseeded entry
#: points — public API and helpers whose executing thread is whatever
#: the caller happens to be.
EXTERNAL = "external"

#: Functions that execute in a freshly forked CHILD process: a role
#: propagation boundary — the caller's thread does not exist on the
#: other side of os.fork(). They seed the (single-thread) postfork
#: role instead of inheriting the forking thread's.
_FORK_BOUNDARY = frozenset(("_child_main", "_postfork_reset",
                            "_postfork_child_reset"))


class ThreadModel:
    """Role assignment over the lock model's resolved call graph."""

    def __init__(self, model: LockModel):
        self.lock_model = model
        #: seed target fkey -> role name
        self.seeds: Dict[str, str] = {}
        #: fkey -> seeded roles that reach it (forward closure)
        self.roles: Dict[str, Set[str]] = {}
        #: fkeys reachable from role-less entry points (callable on
        #: arbitrary external threads)
        self.external: Set[str] = set()
        #: (fkey, role) -> call chain from the role's seed to fkey —
        #: the witness a finding prints so the reader can see WHICH
        #: thread reaches the access site and how
        self.chains: Dict[Tuple[str, str], Tuple[str, ...]] = {}
        self._build()

    # ------------------------------------------------------------ build
    def _classify_seed(self, fkey: str) -> str:
        mod, _, qual = fkey.partition("::")
        for suffix, leaf, role in _SEED_ROLES:
            if mod.endswith(suffix) and qual == leaf:
                return role
        # unrecognized future thread root: its own ad-hoc role, never
        # single-thread (no exemption granted on a guess)
        return "thread:" + qual.split(".")[-1].lstrip("_")

    @staticmethod
    def _forks(fkey: str) -> bool:
        return fkey.split("::")[-1].split(".")[-1] in _FORK_BOUNDARY

    def _reach(self, roots: List[str]) -> Set[str]:
        m = self.lock_model
        seen: Set[str] = set()
        pending = list(roots)
        while pending:
            cur = pending.pop()
            if cur in seen:
                continue
            seen.add(cur)
            info = m.funcs.get(cur)
            if info is None:
                continue
            for callee, _held, _line in info.resolved_calls:
                if callee not in seen and not self._forks(callee):
                    pending.append(callee)
        return seen

    def _reach_with_parents(self, root: str) -> Dict[str, Optional[str]]:
        """BFS forward closure keeping first-discovery parents, so a
        chain from the seed to any reached function can be rebuilt.
        Never crosses a fork boundary except out of the root itself."""
        m = self.lock_model
        parent: Dict[str, Optional[str]] = {root: None}
        queue = [root]
        while queue:
            cur = queue.pop(0)
            info = m.funcs.get(cur)
            if info is None:
                continue
            for callee, _held, _line in info.resolved_calls:
                if callee not in parent and not self._forks(callee):
                    parent[callee] = cur
                    queue.append(callee)
        return parent

    def _build(self) -> None:
        m = self.lock_model
        for _creator, fkey, _tname, _line in m.thread_roots:
            self.seeds[fkey] = self._classify_seed(fkey)
        for fkey in m.funcs:
            if self._forks(fkey):
                self.seeds.setdefault(fkey, "postfork")
        for root, role in sorted(self.seeds.items()):
            parent = self._reach_with_parents(root)
            for fkey in parent:
                self.roles.setdefault(fkey, set()).add(role)
                if (fkey, role) not in self.chains:
                    chain: List[str] = []
                    cur: Optional[str] = fkey
                    while cur is not None and len(chain) < 8:
                        chain.append(cur)
                        cur = parent.get(cur)
                    self.chains[(fkey, role)] = tuple(reversed(chain))
        # external closure: everything reachable from a non-seed entry
        # point with no in-tree caller may run on any caller thread
        callers: Set[str] = set()
        for info in m.funcs.values():
            for callee, _held, _line in info.resolved_calls:
                callers.add(callee)
        entries = [fkey for fkey in m.funcs
                   if fkey not in self.seeds and fkey not in callers]
        self.external = self._reach(entries)

    # ------------------------------------------------------------ query
    def roles_of(self, fkey: str) -> Set[str]:
        """Every role that may execute `fkey`, EXTERNAL included.
        Unknown functions get {EXTERNAL}: no claim means no exemption."""
        out = set(self.roles.get(fkey, ()))
        if fkey in self.external or not out:
            out.add(EXTERNAL)
        return out

    def seeded_roles_of(self, fkey: str) -> Set[str]:
        """Only the seeded thread roles reaching `fkey` (no EXTERNAL)."""
        return set(self.roles.get(fkey, ()))

    @staticmethod
    def is_single_thread(role: str) -> bool:
        return role in SINGLE_THREAD_ROLES

    def confined_to(self, fkeys: List[str]) -> Optional[str]:
        """The single single-thread role every function in `fkeys` is
        confined to, or None when they span threads."""
        combined: Set[str] = set()
        for fkey in fkeys:
            combined |= self.roles_of(fkey)
            if len(combined) > 1:
                return None
        if len(combined) == 1:
            role = next(iter(combined))
            if role in SINGLE_THREAD_ROLES:
                return role
        return None

    def chain_for(self, fkey: str, role: str) -> str:
        """Human-readable seed→site call chain for a (fkey, role)."""
        chain = self.chains.get((fkey, role))
        if not chain:
            return ""
        return " -> ".join(c.split("::")[-1] for c in chain)

    def role_table(self) -> List[Tuple[str, str]]:
        """(role, seed fkey) rows, stable order — docs + CLI surface."""
        return sorted(((role, fkey) for fkey, role in self.seeds.items()),
                      key=lambda r: (r[0], r[1]))


def get_thread_model(ctx: Context) -> ThreadModel:
    """The per-context singleton, riding the lock-model singleton."""
    tm = getattr(ctx, "_thread_model", None)
    if tm is None:
        tm = ThreadModel(get_lock_model(ctx))
        ctx._thread_model = tm
    return tm
