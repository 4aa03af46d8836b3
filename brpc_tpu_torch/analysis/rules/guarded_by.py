"""guarded-by: whole-program lockset guard inference (Eraser-style).

For every class/module field the lock model recorded access sites for,
infer the guard as the lock held at >= 90% of non-constructor write
sites (two or more writes required — one site is not a convention).
Then:

* a write site executed without the inferred guard is a [CONFIRMED]
  finding — the field's own discipline says this site races;
* a read site without the guard is flagged [PLAUSIBLE] only when its
  thread roles are disjoint from every writer role — same-thread
  reads and the repo's deliberate lock-free peek idioms stay quiet;
* a field with NO inferred guard is flagged (once, at its first write
  site) only when its writes span multiple thread roles — the
  cross-role unguarded write, ranked highest because two different
  threads mutate it with no common lock;
* a field written only from one single-thread role (dispatcher tick,
  timer, a sampler, postfork child...) is thread-confined: exempt, and
  published as such in the registry.

Effective locks at a site are the locks held lexically PLUS every lock
possibly held by callers (`under_locks`) — a generous may-analysis, so
a finding here means NO caller path supplies the guard. Lock and
Event attributes themselves are skipped (they synchronize, they are
not synchronized). Waive deliberate lock-free idioms with
``# graftlint: disable=guarded-by -- reason``.

The inferred field->guard registry is published in analysis/INVARIANTS.md
("Field guards") and snapshot-pinned by test; `python -m
brpc_tpu_torch.analysis --field-guards` regenerates it.
"""

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from brpc_tpu_torch.analysis.core import Context, Finding, Rule
from brpc_tpu_torch.analysis.lockmodel import LockModel, get_lock_model
from brpc_tpu_torch.analysis.threadmodel import (
    EXTERNAL, SINGLE_THREAD_ROLES, ThreadModel, get_thread_model,
)

#: Functions whose writes are construction, not publication.
_INIT_FUNCS = frozenset(("__init__", "__new__", "__post_init__",
                         "__init_subclass__"))
_GUARD_PCT = 0.90
_MIN_WRITES = 2


class _Site:
    """One field access: where, which lock set, which thread roles."""

    __slots__ = ("kind", "fkey", "relpath", "line", "held", "roles")

    def __init__(self, kind: str, fkey: str, relpath: str, line: int,
                 held: frozenset, roles: Set[str]):
        self.kind = kind
        self.fkey = fkey
        self.relpath = relpath
        self.line = line
        self.held = held
        self.roles = roles


def _tls_classes(ctx: Context) -> Set[str]:
    """Classes deriving threading.local: every instance is per-thread,
    so their fields are thread-confined by construction."""
    out: Set[str] = set()
    for sf in ctx.files:
        if not sf.is_python or sf.tree is None:
            continue
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            for base in node.bases:
                if (isinstance(base, ast.Attribute)
                        and base.attr == "local") or \
                        (isinstance(base, ast.Name)
                         and base.id == "local"):
                    out.add(node.name)
    return out


def _collect(ctx: Context) -> Tuple[
        LockModel, ThreadModel,
        Dict[str, Tuple[List[_Site], List[_Site]]]]:
    """field -> (write sites, read sites), constructor bodies dropped."""
    model = get_lock_model(ctx)
    tm = get_thread_model(ctx)
    fields: Dict[str, Tuple[List[_Site], List[_Site]]] = {}
    for fkey, info in model.funcs.items():
        if not info.attr_uses:
            continue
        if info.qual.split(".")[-1] in _INIT_FUNCS:
            continue
        under = frozenset(model.under_locks.get(fkey, ()))
        roles = tm.roles_of(fkey)
        if roles == {"postfork"}:
            # fork-child-only code (postfork reset handlers): the
            # child is single-threaded — nothing to race with, and
            # its re-init writes must not poison guard inference
            continue
        for kind, field, line, held in info.attr_uses:
            site = _Site(kind, fkey, info.relpath, line,
                         frozenset(held) | under, roles)
            pair = fields.setdefault(field, ([], []))
            (pair[0] if kind == "w" else pair[1]).append(site)
    return model, tm, fields


def _infer_guard(field: str, writes: List[_Site]) -> Tuple[
        Optional[str], int]:
    """(guard, sites-holding-it) when one lock covers every write site
    (any count) or >= 90% of them (>= _MIN_WRITES sites — a single
    partially-covered site is not a convention); (None, best count)
    otherwise."""
    n = len(writes)
    counts: Dict[str, int] = {}
    for s in writes:
        for lock in s.held:
            counts[lock] = counts.get(lock, 0) + 1
    if not counts:
        return None, 0
    owner = field.rpartition(".")[0]
    # prefer: most write sites covered, then the field's own class
    # lock over a caller's, then stable name order
    best = sorted(counts, key=lambda k: (
        -counts[k], 0 if k.startswith(owner + ".") else 1, k))[0]
    if counts[best] == n or \
            (n >= _MIN_WRITES and counts[best] / n >= _GUARD_PCT):
        return best, counts[best]
    return None, counts[best]


def _race_roles(sites: Iterable[_Site]) -> Set[str]:
    """Roles that can actually interleave: the postfork child runs
    alone in a fresh process, so it races with nothing."""
    roles: Set[str] = set()
    for s in sites:
        roles |= s.roles
    roles.discard("postfork")
    return roles


def _witness(tm: ThreadModel, site: _Site) -> str:
    """' [role: seed -> ... -> site fn]' for the site's best seeded
    role, or a terse external marker."""
    seeded = sorted(r for r in site.roles if r != EXTERNAL)
    for role in seeded:
        chain = tm.chain_for(site.fkey, role)
        if chain:
            return f" [{role}: {chain}]"
    return " [external callers]"


def _confined_role(wroles: Set[str]) -> Optional[str]:
    """The one single-thread role writing the field, if that's all."""
    if len(wroles) == 1:
        role = next(iter(wroles))
        if role in SINGLE_THREAD_ROLES:
            return role
    return None


class GuardedByRule(Rule):
    name = "guarded-by"
    description = ("fields written under an inferred guard (>=90% of "
                   "write sites hold one lock) must hold it at every "
                   "write and at cross-role reads; unguarded fields "
                   "written from multiple thread roles are races")

    def finalize(self, ctx: Context) -> Iterable[Finding]:
        model, tm, fields = _collect(ctx)
        tls = _tls_classes(ctx)
        findings: List[Finding] = []
        for field in sorted(fields):
            writes, reads = fields[field]
            if not writes or field in model.locks:
                continue
            cls, _, attr = field.rpartition(".")
            if cls and (cls in tls or (cls, attr) in model._event_attrs):
                continue
            guard, held_n = _infer_guard(field, writes)
            wroles = _race_roles(writes)
            if guard is not None:
                for s in writes:
                    if guard in s.held:
                        continue
                    findings.append(Finding(
                        self.name, s.relpath, s.line,
                        f"[CONFIRMED] write to {field} without {guard} "
                        f"(guard held at {held_n}/{len(writes)} write "
                        f"sites){_witness(tm, s)}"))
                for s in reads:
                    if guard in s.held:
                        continue
                    rroles = set(s.roles)
                    rroles.discard("postfork")
                    if rroles and wroles and rroles.isdisjoint(wroles):
                        findings.append(Finding(
                            self.name, s.relpath, s.line,
                            f"[PLAUSIBLE] read of {field} without "
                            f"{guard} on {'/'.join(sorted(rroles))} "
                            f"(written under the guard on "
                            f"{'/'.join(sorted(wroles))})"
                            f"{_witness(tm, s)}"))
            elif len(wroles) > 1:
                first = min(writes, key=lambda s: (s.relpath, s.line))
                findings.append(Finding(
                    self.name, first.relpath, first.line,
                    f"[CONFIRMED] cross-role unguarded writes to "
                    f"{field} from {'/'.join(sorted(wroles))} "
                    f"({len(writes)} write sites, no common lock)"
                    f"{_witness(tm, first)}"))
        return findings


# --------------------------------------------------------------- registry
def field_guard_table(ctx: Context) -> List[dict]:
    """The published registry rows: every field with an inferred guard
    plus every thread-confined field, stable order."""
    model, tm, fields = _collect(ctx)
    tls = _tls_classes(ctx)
    rows: List[dict] = []
    for field in sorted(fields):
        writes, _reads = fields[field]
        if not writes or field in model.locks:
            continue
        cls, _, attr = field.rpartition(".")
        if cls and (cls in tls or (cls, attr) in model._event_attrs):
            continue
        guard, held_n = _infer_guard(field, writes)
        if guard is not None:
            rows.append({"field": field, "guard": guard,
                         "writes": len(writes), "held": held_n})
            continue
        role = _confined_role(_race_roles(writes))
        if role is not None:
            rows.append({"field": field, "guard": f"confined:{role}",
                         "writes": len(writes), "held": len(writes)})
    return rows


def render_field_guards(ctx: Context) -> str:
    """Markdown table the docs snapshot pins (and --field-guards
    prints): field | guard | write sites covered."""
    rows = field_guard_table(ctx)
    out = ["| field | guard | writes |",
           "|---|---|---|"]
    for r in rows:
        out.append(f"| `{r['field']}` | `{r['guard']}` "
                   f"| {r['held']}/{r['writes']} |")
    return "\n".join(out)
