"""event-wait-not-sleep: a long-lived thread loop paces itself with
``Event.wait(timeout)``, never ``time.sleep``.

Two reasons: (1) ``stop()`` cannot interrupt a sleep —
shutdown waits out the tail of whatever nap the loop is in (the
spawn_util watchdog and the shard monitor both shipped this); (2) the
flight recorder's idle classification keys on the leaf frame —
``Event.wait`` parks in ``threading.py`` and classifies idle, while
``time.sleep`` shows up as an opaque busy-ish leaf that pollutes the
flamegraph. The fix is mechanical: give the loop a ``threading.Event``
and ``wait(period)`` on it; ``stop()`` sets it.

A root is any function handed to ``threading.Thread(target=...)``; the
rule walks its same-module call closure and flags ``time.sleep`` calls
sitting inside a ``while`` loop.
"""

from __future__ import annotations

from typing import Iterable, List, Set

from brpc_tpu_torch.analysis.core import Context, Finding, Rule, SourceFile
from brpc_tpu_torch.analysis.lockmodel import get_lock_model


class EventWaitNotSleepRule(Rule):
    name = "event-wait-not-sleep"
    description = ("time.sleep in a long-lived thread loop must be "
                   "Event.wait(timeout): stop() can interrupt it and "
                   "the profiler classifies the thread idle")

    def finalize(self, ctx: Context) -> Iterable[Finding]:
        model = get_lock_model(ctx)
        roots: Set[str] = {fkey for _, fkey, _, _ in model.thread_roots}
        findings: List[Finding] = []
        reported: Set[tuple] = set()
        for root in sorted(roots):
            for info, chain in model.same_module_closure(root):
                for line in info.sleeps_in_loop:
                    if (info.relpath, line) in reported:
                        continue
                    reported.add((info.relpath, line))
                    via = ("" if len(chain) == 1 else
                           " (reached via " + " -> ".join(
                               c.split("::")[-1] for c in chain) + ")")
                    findings.append(Finding(
                        self.name, info.relpath, line,
                        f"time.sleep() paces the thread loop "
                        f"'{info.qual}'{via} — use threading.Event."
                        "wait(timeout) so stop() can interrupt the nap "
                        "and the flight recorder classifies the thread "
                        "idle"))
        return findings
