"""memoryview-release: a view of a resizable buffer is released on
every path before the buffer is resized.

The BufferError it prevents, distilled: ``mv = memoryview(self._wirebuf)``
followed by ``del self._wirebuf[:n]`` is only correct if ``mv`` is
RELEASED first — a refcount-implicit release is not enough, because a
frame-walking sampler (the flight recorder holding another thread's
frame during a sample) briefly pins the frame's locals and keeps the
view alive, turning the resize into ``BufferError: Existing exports of
data``. The discipline: ``try: ... finally: mv.release()`` (or
``with memoryview(buf) as mv:``) before any resize of the source.

Scope: within one function, a ``memoryview(X)`` of a Name or
``self.attr`` source followed (in execution order) by a resize of the
same source — ``del X[...]``, ``X += ...``, ``X.clear()/.extend()/
.append()/.pop()/.popleft()/.resize()/.truncate()`` — must have an
unconditional ``mv.release()`` between the two. A release inside a
conditional branch does not cover (the other path leaks the export); a
release in a ``finally`` covers everything after its try; the
``with memoryview(...)`` form releases at block exit.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Tuple

from brpc_tpu_torch.analysis.core import Context, Finding, Rule, SourceFile

_RESIZE_METHODS = frozenset(("clear", "extend", "append", "pop",
                             "popleft", "resize", "truncate"))


def _src_key(node: ast.AST) -> Optional[str]:
    """Canonical name of a view-source expression: Name or self.attr."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return f"self.{node.attr}"
    return None


class _Linearizer:
    """Flatten a function body into execution-ordered events, with a
    branch-context tuple per event so conditional releases don't cover
    unconditional mutations. try bodies count as unconditional (the
    happy path runs them in order); If/else/except bodies are branches;
    a ``finally`` suite is emitted after its try (it runs before
    anything that follows)."""

    def __init__(self):
        self.events: List[tuple] = []   # (kind, *data, branch_ctx)
        self._pos = 0
        self._branch: Tuple[int, ...] = ()

    def pos(self) -> int:
        self._pos += 1
        return self._pos

    def emit(self, kind: str, *data) -> None:
        self.events.append((kind, self.pos(), self._branch) + data)

    def walk_body(self, body: List[ast.stmt]) -> None:
        for stmt in body:
            self.walk_stmt(stmt)

    def walk_stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            return
        if isinstance(stmt, ast.Try):
            self.walk_body(stmt.body)
            old = self._branch
            for i, h in enumerate(stmt.handlers):
                self._branch = old + (id(h) % 9973,)
                self.walk_body(h.body)
            self._branch = old
            self.walk_body(stmt.orelse)
            self.walk_body(stmt.finalbody)
            return
        if isinstance(stmt, ast.If):
            old = self._branch
            self._branch = old + (stmt.lineno,)
            self.walk_body(stmt.body)
            self._branch = old + (-stmt.lineno,)
            self.walk_body(stmt.orelse)
            self._branch = old
            return
        if isinstance(stmt, (ast.While, ast.For)):
            self.walk_body(stmt.body)
            self.walk_body(stmt.orelse)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            withviews = []
            for item in stmt.items:
                ce = item.context_expr
                if isinstance(ce, ast.Call) and \
                        isinstance(ce.func, ast.Name) and \
                        ce.func.id == "memoryview" and ce.args:
                    src = _src_key(ce.args[0])
                    var = None
                    if isinstance(item.optional_vars, ast.Name):
                        var = item.optional_vars.id
                    if src and var:
                        self.emit("view", var, src, ce.lineno)
                        withviews.append(var)
            self.walk_body(stmt.body)
            for var in withviews:     # __exit__ releases the export
                self.emit("release", var)
            return
        self.scan_expr_stmt(stmt)

    def scan_expr_stmt(self, stmt: ast.stmt) -> None:
        # view creation: mv = memoryview(src)
        if isinstance(stmt, ast.Assign) and \
                isinstance(stmt.value, ast.Call) and \
                isinstance(stmt.value.func, ast.Name) and \
                stmt.value.func.id == "memoryview" and stmt.value.args:
            src = _src_key(stmt.value.args[0])
            if src:
                for tgt in stmt.targets:
                    if isinstance(tgt, ast.Name):
                        self.emit("view", tgt.id, src, stmt.lineno)
            return
        # del src[...] — the resize
        if isinstance(stmt, ast.Delete):
            for t in stmt.targets:
                if isinstance(t, ast.Subscript):
                    src = _src_key(t.value)
                    if src:
                        self.emit("mutate", src, stmt.lineno,
                                  "del %s[...]" % src)
            return
        # src += ...
        if isinstance(stmt, ast.AugAssign):
            src = _src_key(stmt.target)
            if src:
                self.emit("mutate", src, stmt.lineno, f"{src} += ...")
            return
        # re-binding the view var or the source kills the old export
        if isinstance(stmt, ast.Assign):
            for tgt in stmt.targets:
                if isinstance(tgt, ast.Name):
                    self.emit("rebind", tgt.id)
                src = _src_key(tgt)
                if src:
                    self.emit("rebind_src", src)
        # mv.release() / src.clear() etc. anywhere in the statement
        for node in ast.walk(stmt):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if not isinstance(fn, ast.Attribute):
                continue
            if fn.attr == "release" and isinstance(fn.value, ast.Name):
                self.emit("release", fn.value.id)
            elif fn.attr in _RESIZE_METHODS:
                src = _src_key(fn.value)
                if src:
                    self.emit("mutate", src, node.lineno,
                              f"{src}.{fn.attr}()")


class MemoryviewReleaseRule(Rule):
    name = "memoryview-release"
    description = ("a memoryview of a resizable buffer must be "
                   "released (finally: mv.release() / with-form) "
                   "before the buffer is resized — a frame-pinning "
                   "sampler otherwise turns the resize into "
                   "BufferError")

    def check(self, sf: SourceFile, ctx: Context) -> Iterable[Finding]:
        if not sf.is_python or "/analysis/" in sf.relpath:
            return ()
        findings: List[Finding] = []
        for node in ast.walk(sf.tree):
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            lin = _Linearizer()
            lin.walk_body(node.body)
            findings.extend(self._scan(sf, lin.events))
        return findings

    def _scan(self, sf: SourceFile, events: List[tuple]) -> List[Finding]:
        out: List[Finding] = []
        # live views: var -> (src, viewline, view_pos, view_branch)
        live = {}
        for ev in events:
            kind = ev[0]
            if kind == "view":
                _, pos, branch, var, src, line = ev
                live[var] = (src, line, pos, branch)
            elif kind in ("release", "rebind"):
                _, pos, branch, var = ev
                t = live.get(var)
                # a release buried in a conditional branch only covers
                # paths through that branch: it clears the view only
                # when it is at the view's own (or an outer) branch
                # level — prefix-equal contexts
                if t is not None and t[3][:len(branch)] == branch[
                        :len(t[3])] and len(branch) <= len(t[3]):
                    live.pop(var, None)
            elif kind == "rebind_src":
                _, pos, branch, src = ev
                for var in [v for v, t in live.items() if t[0] == src]:
                    t = live[var]
                    if t[3][:len(branch)] == branch[:len(t[3])] and \
                            len(branch) <= len(t[3]):
                        live.pop(var, None)
            elif kind == "mutate":
                _, pos, branch, src, line, desc = ev
                for var, (vsrc, vline, vpos, vbranch) in list(
                        live.items()):
                    if vsrc != src:
                        continue
                    # skip only DIVERGENT branches (then vs else): a
                    # mutation in an outer/unconditional context after
                    # a branch-local view IS on the view's path (the
                    # branch was taken, the view leaked out of it), and
                    # a mutation deeper inside the view's branch is too
                    n = min(len(vbranch), len(branch))
                    if vbranch[:n] != branch[:n]:
                        continue
                    out.append(Finding(
                        self.name, sf.relpath, line,
                        f"{desc} while memoryview '{var}' (taken at "
                        f"line {vline}) may still export the buffer — "
                        "a frame-pinning sampler keeps the view alive "
                        "and the resize raises BufferError; release "
                        "the view first (try/finally or the with-"
                        "statement form)"))
                    live.pop(var, None)   # one report per view
        return out
