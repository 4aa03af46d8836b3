"""The three whole-program lock rules riding the lock model
(``analysis/lockmodel.py``): lock-cycle, callback-under-lock and
blocking-under-lock.

These are graftlint v2's replacement for the v1 intramodule
``lock-order`` rule: the same AB/BA-deadlock check, but over the
INTERPROCEDURAL acquisition graph (a ``with A:`` around a call whose
callee — possibly in another module — takes B is an A->B edge), plus
the two held-context rules whose violations were fixed by hand before
the rules existed (attempt records under ``_arb_lock``/``_lb_lock``;
batcher callbacks fired under the batcher lock).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from brpc_tpu_torch.analysis.core import Context, Finding, Rule, SourceFile
from brpc_tpu_torch.analysis.lockmodel import get_lock_model

# modules that ARE the blocking layer: the fiber runtime's pthread side
# legitimately parks carrier threads under its own coordination locks
# (parking lots, stack pools); everything above it must not
_BLOCKING_ALLOWLIST = (
    "brpc_tpu_torch/fiber/scheduler.py",
    "brpc_tpu_torch/fiber/butex.py",
    "brpc_tpu_torch/fiber/timer.py",
    "brpc_tpu_torch/fiber/stacks.py",
    "brpc_tpu_torch/fiber/execution_queue.py",
    "brpc_tpu_torch/fiber/worker_module.py",
)


class LockCycleRule(Rule):
    name = "lock-cycle"
    description = ("the whole-program lock acquisition graph (with-"
                   "nesting plus interprocedural call edges) must be "
                   "acyclic; reports the witness path")

    def finalize(self, ctx: Context) -> Iterable[Finding]:
        model = get_lock_model(ctx)
        findings: List[Finding] = []
        for cycle in model.cycles():
            members = set(cycle)
            # witness: one concrete edge location per hop of the cycle
            hops: List[str] = []
            first: Optional[Tuple[str, int]] = None
            for (a, b), (path, line, chain) in sorted(
                    model.edges.items()):
                if a in members and b in members:
                    via = (f" via {'->'.join(c.split('::')[-1] for c in chain)}"
                           if len(chain) > 1 else "")
                    hops.append(f"{a}->{b} at {path}:{line}{via}")
                    if first is None:
                        first = (path, line)
            if first is None:
                continue
            order = " -> ".join(cycle + (cycle[0],))
            findings.append(Finding(
                self.name, first[0], first[1],
                f"lock acquisition cycle: {order} — two paths can take "
                f"these locks in opposite orders and deadlock; "
                f"witness: {'; '.join(hops[:4])}"))
        return findings


class CallbackUnderLockRule(Rule):
    name = "callback-under-lock"
    description = ("no stored callback / user hook / socket write may "
                   "run while a framework lock is held (the callback "
                   "can re-enter the locked subsystem or block it)")

    def finalize(self, ctx: Context) -> Iterable[Finding]:
        model = get_lock_model(ctx)
        findings: List[Finding] = []
        for info in model.funcs.values():
            inherited = model.under_locks.get(info.key, set())
            for line, desc, held in info.callbacks:
                locks = set(held) | inherited
                if not locks:
                    continue
                if held:
                    how = f"while holding {', '.join(sorted(held))}"
                else:
                    chain = model.witness_chain(info.key)
                    how = (f"reached under {', '.join(sorted(locks))} "
                           f"(via {' -> '.join(c.split('::')[-1] for c in chain)})")
                findings.append(Finding(
                    self.name, info.relpath, line,
                    f"{desc} invoked {how} in '{info.qual}' — "
                    "callbacks re-enter the framework (socket failure "
                    "paths call cancel(), hooks take their own locks); "
                    "collect under the lock, fire after releasing it"))
        return findings


class BlockingUnderLockRule(Rule):
    name = "blocking-under-lock"
    description = ("no blocking operation (time.sleep, Event.wait, "
                   "blocking socket ops, subprocess) may run while a "
                   "framework lock is held")

    def finalize(self, ctx: Context) -> Iterable[Finding]:
        model = get_lock_model(ctx)
        findings: List[Finding] = []
        for info in model.funcs.values():
            if info.relpath.endswith(_BLOCKING_ALLOWLIST):
                continue
            inherited = model.under_locks.get(info.key, set())
            for line, why, held in info.blocking:
                locks = set(held) | inherited
                if not locks:
                    continue
                if held:
                    how = f"while holding {', '.join(sorted(held))}"
                else:
                    chain = model.witness_chain(info.key)
                    how = (f"reached under {', '.join(sorted(locks))} "
                           f"(via {' -> '.join(c.split('::')[-1] for c in chain)})")
                findings.append(Finding(
                    self.name, info.relpath, line,
                    f"{why} {how} in '{info.qual}' — every other "
                    "thread/fiber contending that lock stalls for the "
                    "whole wait; move the wait outside the critical "
                    "section"))
        return findings
