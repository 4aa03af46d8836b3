"""block-recycle: a view into pooled blocks must not outlive the
buffer's recycle point.

``first_host_view()`` / ``BlockRef.memoryview()`` hand out windows into
POOLED block storage (butil/iobuf.py BlockPool): the bytes stay valid
only while the source buffer still references the block. The consuming
ops — ``pop_front`` / ``cut`` / ``cut_all`` / ``cut_into`` / ``clear``
— drop refs, and once the last ref is gone the block's buffer returns
to the freelist, where the next acquire (or the debug poisoner) rewrites
it under the still-held view. Reading such a view is silent corruption
in production and 0xDD garbage under ``BRPC_TPU_IOBUF_DEBUG=1``; the
scan lanes' discipline is slice-then-pop (turbo_scan copies every
payload out of the window BEFORE ``portal.pop_front``).

Detection is a per-function may-analysis mirroring iobuf-aliasing's
skeleton: a name bound from a view-producing method (or a subscript of
a tracked view — slicing a memoryview is still a view) is tied to its
source expression; a consuming call on that source marks the view
STALE; any later load of a stale name is a finding until the name is
rebound. Disjoint if/else branches don't poison each other (a consume
on either poisons the join), and loop bodies are scanned twice so a
late-iteration consume reaches the next pass's head. The buffer
implementation itself (butil/iobuf.py) owns its internals and is
excluded, like /analysis/ everywhere.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Set, Tuple

from brpc_tpu_torch.analysis.core import Context, Finding, Rule, SourceFile

# methods whose result is a live window into pooled block storage
VIEW_METHODS = ("first_host_view", "memoryview")
# ops that drop block refs from the source buffer (the recycle point)
CONSUMERS = ("pop_front", "cut", "cut_all", "cut_into", "clear")


def _expr_key(node: ast.AST) -> str:
    """Stable key for a source-buffer expression (Name / dotted attr)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return f"{_expr_key(node.value)}.{node.attr}"
    return ast.dump(node)


class BlockRecycleRule(Rule):
    name = "block-recycle"
    description = ("no use of a memoryview/BlockRef window into pooled "
                   "blocks after the source buffer's recycle point "
                   "(pop_front/cut/clear)")

    def check(self, sf: SourceFile, ctx: Context) -> Iterable[Finding]:
        if not sf.is_python or "/analysis/" in sf.relpath \
                or sf.relpath.endswith("butil/iobuf.py"):
            return ()
        findings: List[Finding] = []
        for node in ast.walk(sf.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                findings.extend(self._scan_function(sf, node))
        return findings

    def _scan_function(self, sf: SourceFile, func: ast.AST) -> List[Finding]:
        findings: List[Finding] = []
        seen: Set[Tuple[int, str]] = set()

        def emit(lineno: int, name: str, src: str, via: str) -> None:
            key = (lineno, name)
            if key in seen:            # loop bodies are scanned twice
                return
            seen.add(key)
            findings.append(Finding(
                self.name, sf.relpath, lineno,
                f"'{name}' is a view into '{src}''s pooled blocks and "
                f"is used after '{src}.{via}()' — the blocks may "
                "already be recycled (poisoned under "
                "BRPC_TPU_IOBUF_DEBUG); copy the bytes out before the "
                "cut/pop"))

        # views: name -> source key; stale: name -> consuming method
        def apply_expr(node: ast.AST, views: Dict[str, str],
                       stale: Dict[str, str]) -> None:
            events = []   # (lineno, col, kind, payload)
            for sub in ast.walk(node):
                if isinstance(sub, ast.Assign):
                    for tgt in sub.targets:
                        if not isinstance(tgt, ast.Name):
                            continue
                        v = sub.value
                        if isinstance(v, ast.Call) and isinstance(
                                v.func, ast.Attribute) and \
                                v.func.attr in VIEW_METHODS:
                            events.append((sub.lineno, sub.col_offset,
                                           "bind",
                                           (tgt.id,
                                            _expr_key(v.func.value))))
                        elif isinstance(v, ast.Subscript) and isinstance(
                                v.value, ast.Name):
                            # a slice of a tracked view is still a view
                            events.append((sub.lineno, sub.col_offset,
                                           "derive",
                                           (tgt.id, v.value.id)))
                        else:
                            events.append((sub.lineno, sub.col_offset,
                                           "rebind", (tgt.id, "")))
                elif isinstance(sub, ast.Delete):
                    for tgt in sub.targets:
                        if isinstance(tgt, ast.Name):
                            events.append((sub.lineno, sub.col_offset,
                                           "rebind", (tgt.id, "")))
                elif isinstance(sub, ast.Call) and isinstance(
                        sub.func, ast.Attribute) and \
                        sub.func.attr in CONSUMERS:
                    events.append((sub.lineno, sub.col_offset, "consume",
                                   (_expr_key(sub.func.value),
                                    sub.func.attr)))
                elif isinstance(sub, ast.Name) and isinstance(
                        sub.ctx, ast.Load):
                    events.append((sub.lineno, sub.col_offset, "load",
                                   (sub.id, "")))
            events.sort(key=lambda e: (e[0], e[1]))
            for lineno, _col, kind, payload in events:
                if kind == "bind":
                    name, src = payload
                    views[name] = src
                    stale.pop(name, None)
                elif kind == "derive":
                    name, parent = payload
                    if parent in views:
                        views[name] = views[parent]
                        if parent in stale:
                            stale[name] = stale[parent]
                        else:
                            stale.pop(name, None)
                    else:
                        views.pop(name, None)
                        stale.pop(name, None)
                elif kind == "rebind":
                    views.pop(payload[0], None)
                    stale.pop(payload[0], None)
                elif kind == "consume":
                    src, via = payload
                    for name, vsrc in views.items():
                        if vsrc == src:
                            stale[name] = via
                elif kind == "load":
                    name = payload[0]
                    if name in stale:
                        emit(lineno, name, views.get(name, "?"),
                             stale[name])

        def scan_stmts(stmts, views: Dict[str, str],
                       stale: Dict[str, str]) -> None:
            for st in stmts:
                if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef)):
                    continue   # nested defs scan as their own functions
                if isinstance(st, ast.If):
                    apply_expr(st.test, views, stale)
                    vb, sb = dict(views), dict(stale)
                    ve, se = dict(views), dict(stale)
                    scan_stmts(st.body, vb, sb)
                    scan_stmts(st.orelse, ve, se)
                    views.clear(); views.update(ve); views.update(vb)
                    stale.clear(); stale.update(se); stale.update(sb)
                elif isinstance(st, (ast.For, ast.AsyncFor, ast.While)):
                    apply_expr(st.iter if isinstance(
                        st, (ast.For, ast.AsyncFor)) else st.test,
                        views, stale)
                    v, s = dict(views), dict(stale)
                    scan_stmts(st.body, v, s)      # two-pass unroll: a
                    scan_stmts(st.body, v, s)      # late consume reaches
                    scan_stmts(st.orelse, v, s)    # the next pass's head
                    views.update(v)
                    stale.update(s)
                elif isinstance(st, (ast.With, ast.AsyncWith)):
                    for item in st.items:
                        apply_expr(item.context_expr, views, stale)
                    scan_stmts(st.body, views, stale)
                elif isinstance(st, ast.Try):
                    scan_stmts(st.body, views, stale)
                    for handler in st.handlers:
                        v, s = dict(views), dict(stale)
                        scan_stmts(handler.body, v, s)
                        views.update(v)
                        stale.update(s)
                    scan_stmts(st.orelse, views, stale)
                    scan_stmts(st.finalbody, views, stale)
                else:
                    apply_expr(st, views, stale)

        scan_stmts(func.body, {}, {})
        return findings
