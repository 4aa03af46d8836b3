"""postfork-reset: process-global singleton caches must survive fork.

Shard-group serving forks worker processes (rpc/shard_group.py); a
module that caches a process-global singleton — dispatcher, scheduler,
timer, socket map, pooled buffers — hands every forked child dead
threads, shared epoll fds and possibly-held locks unless it registers
a reset with ``butil.postfork``. The failure is the worst kind:
nothing crashes at fork time, the child just serves nothing (spawns
queue onto worker threads that only exist in the parent) or corrupts
the PARENT (EPOLL_CTL on the inherited epoll fd edits the parent's
interest list).

The rule recognizes the two singleton idioms this codebase uses and
requires the defining module to call ``postfork.register(...)`` (or a
function named ``register_postfork_reset``):

  1. the lazy-global accessor::

         _global = None
         def global_thing():
             global _global
             if _global is None:
                 _global = Thing()
             return _global

     i.e. a module-level function with a ``global NAME`` statement, an
     ``is None``/truthiness guard on NAME, and an assignment whose
     value constructs an object (a Call whose callee is CapitalizedName
     or x.CapitalizedAttr) — or calls a SAME-MODULE factory helper
     whose body constructs one (``_global = _new_dispatcher()`` where
     ``def _new_dispatcher(): return RingDispatcher() or
     EventDispatcher()``); the lane-selection indirection must not
     launder the singleton past the rule. Accessors that hand the
     instance to ``register_protocol`` are exempt: the protocol table
     is a fork-safe codec registry (pure data, no threads/fds), owned
     by protocol/registry.py.

  2. module-level instantiation of a resource-bearing class::

         pool = BlockPool(...)
         global_sampler = Sampler()

     flagged only when the constructed class's body (resolved across
     the analyzed file set) shows process-resource markers — it starts
     threads, opens files/sockets/selectors, or keeps reuse freelists.
     Plain data singletons (Adder(), Maxer(), compiled regexes) stay
     out of scope.

  3. the object-registry registrar::

         _modules = []
         def register_module(module):
             _modules.append(module)

     a module-level ``register*`` function appending its own parameter
     into a module-level list carries LIVE caller-owned objects across
     fork — a forked shard's fresh loops would drive the PARENT's
     registered engines/callbacks (fiber/worker_module.py is the
     canonical case: the child's workers would double-run the parent's
     serving engine against controllers the child does not own).
     ``register_protocol`` is exempt like the accessor case: the
     protocol table is fork-safe codec data. Registrars that copy or
     wrap the argument (``append((name, fn))``) stay out of scope —
     name-keyed provider tables are replace-on-reregister by
     convention here and fork-safe when their entries are.

A singleton that is genuinely fork-safe can waive with a reason::

    # graftlint: disable=postfork-reset -- <why the fork inherits this safely>
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, List, Optional, Set

from brpc_tpu_torch.analysis.core import Context, Finding, Rule, SourceFile

# process-resource markers inside a class body: threads, fds, reuse
# caches — the things a forked child must not inherit silently
_RESOURCE_RE = re.compile(
    r"Thread\(|ThreadPoolExecutor|selectors\.|socketpair|os\.pipe|"
    r"\bopen\(|Popen\(|freelist|_freelists|\brecycle\b")


def _constructor_calls(value: ast.AST) -> List[str]:
    """Names of constructor-looking calls anywhere in ``value``:
    ``Thing()`` or ``mod.Thing()`` (leading-uppercase callee)."""
    out: List[str] = []
    for node in ast.walk(value):
        if not isinstance(node, ast.Call):
            continue
        name: Optional[str] = None
        if isinstance(node.func, ast.Name):
            name = node.func.id
        elif isinstance(node.func, ast.Attribute):
            name = node.func.attr
        if name and name[:1].isupper():
            out.append(name)
    return out


class PostforkResetRule(Rule):
    name = "postfork-reset"
    description = ("modules caching process-global singletons must "
                   "register a butil.postfork reset (forked shard "
                   "workers inherit dead threads / shared fds / held "
                   "locks otherwise)")

    # ----------------------------------------------------------- helpers
    def _has_registration(self, sf: SourceFile) -> bool:
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr == "register":
                base = f.value
                if isinstance(base, ast.Name) and "postfork" in base.id:
                    return True
                if isinstance(base, ast.Attribute) and \
                        "postfork" in base.attr:
                    return True
            if isinstance(f, ast.Name) and f.id == "register_postfork_reset":
                return True
        return False

    def _factory_constructs(self, sf: SourceFile, value: ast.AST) -> bool:
        """True when ``value`` calls a same-module factory helper whose
        body contains a constructor-looking call — the
        ``_global = _new_dispatcher()`` lane-selection idiom."""
        factories = {node.name: node for node in sf.tree.body
                     if isinstance(node, ast.FunctionDef)}
        for node in ast.walk(value):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Name):
                fac = factories.get(node.func.id)
                if fac is not None and _constructor_calls(fac):
                    return True
        return False

    def _lazy_singletons(self, sf: SourceFile) -> Iterable[ast.FunctionDef]:
        """Module-level functions matching the lazy-global accessor
        idiom (see module doc), excluding protocol registrars."""
        for node in sf.tree.body:
            if not isinstance(node, ast.FunctionDef):
                continue
            globals_: Set[str] = set()
            for sub in ast.walk(node):
                if isinstance(sub, ast.Global):
                    globals_.update(sub.names)
            if not globals_:
                continue
            guarded = False
            constructs = False
            registers_protocol = False
            for sub in ast.walk(node):
                if isinstance(sub, ast.Compare) and \
                        isinstance(sub.left, ast.Name) and \
                        sub.left.id in globals_ and \
                        any(isinstance(c, ast.Constant) and c.value is None
                            for c in sub.comparators):
                    guarded = True
                if isinstance(sub, ast.Assign):
                    tgt_hit = any(isinstance(t, ast.Name)
                                  and t.id in globals_
                                  for t in sub.targets)
                    if tgt_hit and (_constructor_calls(sub.value) or
                                    self._factory_constructs(sf, sub.value)):
                        constructs = True
                if isinstance(sub, ast.Call) and \
                        isinstance(sub.func, ast.Name) and \
                        sub.func.id == "register_protocol":
                    registers_protocol = True
            if guarded and constructs and not registers_protocol:
                yield node

    def _stateful_module_singletons(self, sf: SourceFile,
                                    ctx: Context) -> Iterable[ast.Assign]:
        """Top-level ``NAME = ResourceClass(...)`` assignments whose
        class body carries process-resource markers."""
        for node in sf.tree.body:
            if not isinstance(node, ast.Assign):
                continue
            for cls_name in _constructor_calls(node.value):
                hit = ctx.resolve_class(f"{sf.relpath}:{cls_name}") \
                    or ctx.resolve_class(cls_name)
                if hit is None:
                    continue
                cls_sf, cls_def = hit
                end = getattr(cls_def, "end_lineno", cls_def.lineno)
                body = "\n".join(
                    cls_sf.lines[cls_def.lineno - 1:end])
                if _RESOURCE_RE.search(body):
                    yield node
                    break

    def _registry_registrars(self, sf: SourceFile) \
            -> Iterable[ast.FunctionDef]:
        """Module-level ``register*`` functions appending their own
        parameter into a module-level list (idiom 3 in the module
        doc)."""
        module_lists: Set[str] = set()
        for node in sf.tree.body:
            targets: List[ast.expr] = []
            if isinstance(node, ast.Assign):
                targets = list(node.targets)
                value = node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets = [node.target]
                value = node.value
            else:
                continue
            if isinstance(value, ast.List):
                module_lists.update(t.id for t in targets
                                    if isinstance(t, ast.Name))
        if not module_lists:
            return
        for node in sf.tree.body:
            if not isinstance(node, ast.FunctionDef) or \
                    not node.name.startswith("register"):
                continue
            if node.name == "register_protocol":
                continue    # fork-safe codec table (module doc)
            params = {a.arg for a in node.args.args}
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call) and \
                        isinstance(sub.func, ast.Attribute) and \
                        sub.func.attr == "append" and \
                        isinstance(sub.func.value, ast.Name) and \
                        sub.func.value.id in module_lists and \
                        sub.args and \
                        isinstance(sub.args[0], ast.Name) and \
                        sub.args[0].id in params:
                    yield node
                    break

    # -------------------------------------------------------------- check
    def check(self, sf: SourceFile, ctx: Context) -> Iterable[Finding]:
        if not sf.is_python or "/analysis/" in sf.relpath \
                or sf.relpath.endswith("butil/postfork.py"):
            return ()
        findings: List[Finding] = []
        registered = self._has_registration(sf)
        for fn in self._lazy_singletons(sf):
            if not registered:
                findings.append(Finding(
                    self.name, sf.relpath, fn.lineno,
                    f"'{fn.name}' caches a process-global singleton but "
                    "the module never registers a postfork reset "
                    "(butil.postfork.register) — forked shard workers "
                    "would inherit dead threads/shared fds"))
        for node in self._stateful_module_singletons(sf, ctx):
            if not registered:
                tgt = node.targets[0]
                nm = tgt.id if isinstance(tgt, ast.Name) else "?"
                findings.append(Finding(
                    self.name, sf.relpath, node.lineno,
                    f"module-level singleton '{nm}' holds process "
                    "resources (threads/fds/freelists) but the module "
                    "never registers a postfork reset "
                    "(butil.postfork.register)"))
        for fn in self._registry_registrars(sf):
            if not registered:
                findings.append(Finding(
                    self.name, sf.relpath, fn.lineno,
                    f"'{fn.name}' appends caller-owned objects into a "
                    "module-level registry but the module never "
                    "registers a postfork reset (butil.postfork."
                    "register) — a forked shard worker would run the "
                    "PARENT's registered objects"))
        return findings
