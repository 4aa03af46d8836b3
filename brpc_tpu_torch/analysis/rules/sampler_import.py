"""sampler-no-lazy-import: no import statement reachable from a
profiler/sampler thread loop.

The fault it prevents: the flight recorder's attribution path lazily
imported ``worker_module`` — the FIRST execution opens the module file
ON THE SAMPLER THREAD at sample time, a transient fd that appears and
disappears mid-sample. In fd-exhaustion scenarios that open/close
handed the EMFILE accept-backoff test a free descriptor and flaked it
~50%. Sampler-thread code must bind every import before the thread
starts (module load, or an explicit bind step in ``ensure_running``).

A sampler root is a ``threading.Thread(target=...)`` whose class name,
thread name or target name mentions sampling (``sampl``/``record``/
``flight``/``profil``); the rule walks the target's call closure
through the lock model's resolved edges and flags any ``import``
statement executed inside it.

The walk crosses module boundaries by MARKER NAME: a resolved call
leaving the root's module becomes a new root when the callee's own
name matches the markers (the bvar sampler's tick calling
``series_sample_tick`` in bvar/series.py, which calls
``watchdog_sample_pass`` in bvar/anomaly.py — the trend-ring engine
and the anomaly watchdog are sampler-thread code even though the
thread object lives in bvar/window.py). Naming the entrypoint with a
marker is the opt-in; an unmarked cross-module callee stays out of
scope, so helper calls into unrelated modules cannot flood the rule.
"""

from __future__ import annotations

from typing import Iterable, List, Set

from brpc_tpu_torch.analysis.core import Context, Finding, Rule, SourceFile
from brpc_tpu_torch.analysis.lockmodel import get_lock_model

_MARKERS = ("sampl", "record", "flight", "profil")


class SamplerNoLazyImportRule(Rule):
    name = "sampler-no-lazy-import"
    description = ("no import statement reachable from a sampler-"
                   "thread loop (first execution opens module files on "
                   "the sampler thread — fd churn mid-sample)")

    def finalize(self, ctx: Context) -> Iterable[Finding]:
        model = get_lock_model(ctx)
        roots: Set[str] = set()
        for creator, target_fkey, tname, _line in model.thread_roots:
            blob = " ".join((creator.cls or "", tname,
                             target_fkey.split("::")[-1])).lower()
            if any(m in blob for m in _MARKERS):
                roots.add(target_fkey)
        findings: List[Finding] = []
        reported: Set[tuple] = set()
        seen_roots: Set[str] = set()
        pending = sorted(roots)
        while pending:
            root = pending.pop(0)
            if root in seen_roots:
                continue
            seen_roots.add(root)
            for info, chain in model.same_module_closure(root):
                # marker-named callees in OTHER modules are sampler
                # code too (the tick crossing a module boundary):
                # recurse into their own same-module closures
                for callee, _, _ in info.resolved_calls:
                    target = model.funcs.get(callee)
                    if target is None or \
                            target.relpath == info.relpath or \
                            callee in seen_roots:
                        continue
                    leaf = callee.split("::")[-1].split(".")[-1].lower()
                    if any(m in leaf for m in _MARKERS):
                        pending.append(callee)
                for line, names in info.imports:
                    if (info.relpath, line) in reported:
                        continue
                    reported.add((info.relpath, line))
                    via = ("" if len(chain) == 1 else
                           " (reached via " + " -> ".join(
                               c.split("::")[-1] for c in chain) + ")")
                    findings.append(Finding(
                        self.name, info.relpath, line,
                        f"lazy import of '{names}' inside sampler-loop "
                        f"code '{info.qual}'{via} — the first execution "
                        "opens module files ON THE SAMPLER THREAD at "
                        "sample time; bind it at module load or in the "
                        "pre-thread-start bind step"))
        return findings
