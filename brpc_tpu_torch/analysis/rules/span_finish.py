"""span-finish: every started rpcz span must reach finish_span.

A Span created by ``start_server_span``/``start_client_span`` is only
visible once ``finish_span`` submits it — a path that returns (or
raises) without finishing silently drops exactly the spans operators
grep /rpcz for (sheds, parse errors, dead peers). The rule walks every
function that starts a span with a small path-sensitive interpreter:
along each path to an exit (``return``/``raise``/fall-through), either
a direct ``finish_span(...)`` call must have executed, or a *deferred*
finish must have been registered — a lambda/def whose body calls
``finish_span``, the completion-hook idiom Channel.call uses (the hook
runs on every completion path, so registering it satisfies all later
exits).

A ``try`` whose ``finally`` finishes covers every exit inside it; a
span started inside one branch of an ``if`` taints the merged path
(the other branch typically binds a null-span stand-in and calls the
same ``finish_span`` alias, which the rule sees textually).
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from brpc_tpu_torch.analysis.core import Context, Finding, Rule, SourceFile

_START_NAMES = ("start_server_span", "start_client_span")
_FINISH = "finish_span"


def _call_name(node: ast.Call) -> str:
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return ""


def _iter_shallow(stmt: ast.AST):
    """AST nodes of one statement, NOT descending into nested function
    or lambda bodies (their control flow is not this function's)."""
    stack = [stmt]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            stack.append(child)


def _stmt_starts(stmt: ast.AST) -> bool:
    return any(isinstance(n, ast.Call) and _call_name(n) in _START_NAMES
               for n in _iter_shallow(stmt))


def _stmt_finishes(stmt: ast.AST) -> bool:
    return any(isinstance(n, ast.Call) and _call_name(n) == _FINISH
               for n in _iter_shallow(stmt))


def _stmt_defers_finish(stmt: ast.AST) -> bool:
    """A lambda/def registered in this statement whose body calls
    finish_span: the completion-hook pattern — once registered, the
    hook finishes the span on every completion path."""
    for node in ast.walk(stmt):
        if isinstance(node, (ast.Lambda, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body if isinstance(node.body, list) else [node.body]
            for sub in body:
                for n in ast.walk(sub):
                    if isinstance(n, ast.Call) and _call_name(n) == _FINISH:
                        return True
    return False


class _State:
    __slots__ = ("started", "finished")

    def __init__(self, started: bool = False, finished: bool = False):
        self.started = started
        self.finished = finished

    def copy(self) -> "_State":
        return _State(self.started, self.finished)

    @property
    def leaky(self) -> bool:
        return self.started and not self.finished


class SpanFinishRule(Rule):
    name = "span-finish"
    description = ("every start_server_span/start_client_span call site "
                   "must reach finish_span (direct or via a registered "
                   "completion hook) on all paths")

    def check(self, sf: SourceFile, ctx: Context) -> Iterable[Finding]:
        if not sf.is_python or sf.tree is None \
                or "/analysis/" in sf.relpath \
                or sf.relpath.endswith("rpc/span.py"):
            return ()
        findings: List[Finding] = []
        for node in ast.walk(sf.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if any(_stmt_starts(s) for s in node.body):
                    self._analyze(sf, node, findings)
        return findings

    # ---------------------------------------------------------- analysis
    def _analyze(self, sf: SourceFile, fn, findings: List[Finding]) -> None:
        st = _State()
        terminated = self._walk(sf, fn.body, st, findings)
        if not terminated and st.leaky:
            findings.append(self._finding(
                sf, fn.body[-1].lineno,
                f"function '{fn.name}' can fall off its end"))

    def _finding(self, sf: SourceFile, line: int, how: str) -> Finding:
        return Finding(
            self.name, sf.relpath, line,
            f"{how} with a started span never passed to finish_span — "
            "the span (and its error/stage record) is silently dropped")

    def _walk(self, sf: SourceFile, stmts, st: _State,
              findings: List[Finding]) -> bool:
        """Interpret a statement list; returns True when every path
        through it terminated (return/raise/continue/break)."""
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if _stmt_defers_finish(stmt):
                    st.finished = True
                continue
            if not isinstance(stmt, (ast.If, ast.For, ast.AsyncFor,
                                     ast.While, ast.Try, ast.With,
                                     ast.AsyncWith)):
                # simple statement: start/finish effects apply directly;
                # compound statements get them branch-by-branch below
                if _stmt_finishes(stmt) or _stmt_defers_finish(stmt):
                    st.finished = True
                if _stmt_starts(stmt):
                    st.started = True
                    if not _stmt_finishes(stmt):
                        st.finished = False   # a fresh span, a fresh finish
            if isinstance(stmt, ast.Return):
                if st.leaky:
                    findings.append(self._finding(
                        sf, stmt.lineno, "path returns"))
                return True
            if isinstance(stmt, ast.Raise):
                if st.leaky:
                    findings.append(self._finding(
                        sf, stmt.lineno, "path raises"))
                return True
            if isinstance(stmt, (ast.Break, ast.Continue)):
                return True        # stays inside the function: not a leak
            if isinstance(stmt, ast.If):
                s_body, s_else = st.copy(), st.copy()
                t_body = self._walk(sf, stmt.body, s_body, findings)
                t_else = self._walk(sf, stmt.orelse, s_else, findings)
                live = [s for s, t in ((s_body, t_body), (s_else, t_else))
                        if not t]
                if not live:
                    return True
                st.started = any(s.started for s in live)
                st.finished = all(s.finished or not s.started for s in live)
            elif isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                s_body = st.copy()
                self._walk(sf, stmt.body, s_body, findings)
                if stmt.orelse:
                    self._walk(sf, stmt.orelse, st.copy(), findings)
                # zero-iteration conservatism: the loop can only add
                # starts, never satisfy an outer finish — and a span
                # the body starts without finishing taints the merged
                # path (it leaks on every iteration)
                st.started = st.started or s_body.started
                if s_body.leaky:
                    st.finished = False
            elif isinstance(stmt, ast.Try):
                if self._walk_try(sf, stmt, st, findings):
                    return True
                if self._finally_finishes(stmt):
                    st.finished = True
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                if self._walk(sf, stmt.body, st, findings):
                    return True
        return False

    def _finally_finishes(self, stmt: ast.Try) -> bool:
        return any(_stmt_finishes(s) or _stmt_defers_finish(s)
                   for s in stmt.finalbody)

    def _walk_try(self, sf: SourceFile, stmt: ast.Try, st: _State,
                  findings: List[Finding]) -> bool:
        """Returns True when every path through the try terminated."""
        fin = self._finally_finishes(stmt)
        s_body = st.copy()
        s_body.finished = s_body.finished or fin   # every exit runs finally
        t_body = self._walk(sf, stmt.body, s_body, findings)
        if not t_body and stmt.orelse:
            t_body = self._walk(sf, stmt.orelse, s_body, findings)
        live = [] if t_body else [s_body]
        for handler in stmt.handlers:
            s_h = st.copy()
            # the handler may observe any prefix of the body: a span
            # started in the body counts as started here
            s_h.started = s_h.started or s_body.started
            s_h.finished = s_h.finished or fin
            if not self._walk(sf, handler.body, s_h, findings):
                live.append(s_h)
        self._walk(sf, stmt.finalbody, st.copy(), findings)
        if not live:
            # all paths inside terminated; the finally itself was checked
            st.started = st.started or s_body.started
            return True
        st.started = any(s.started for s in live)
        st.finished = all(s.finished or not s.started for s in live)
        return False
