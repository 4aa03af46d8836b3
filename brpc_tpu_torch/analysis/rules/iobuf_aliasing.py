"""iobuf-aliasing: an IOBuf handed to the write path must not be
mutated afterwards.

``socket.write(buf)`` enqueues buf's blocks by reference onto the
socket's MPSC write queue; ``append_user_data`` / ``append_buf``
splice the CALLER's object in zero-copy. From that point the writer
fiber and the caller alias the same blocks — a subsequent ``append``/
``clear``/``pop_front``/``cut`` on the caller's name races the wire
bytes (the reference's IOBuf ownership discipline: what you hand to
Socket::Write you no longer own, socket.cpp StartWrite).

Detection is a per-function may-analysis over the statement tree:
after a name is passed to a handoff call (write / write_small /
write_device_payload, or as the argument of append_user_data /
append_buf), any mutating method call on that same name is a finding
until the name is rebound. Disjoint ``if``/``else`` branches do not
poison each other (no false positive on mutually exclusive paths, but
a handoff on EITHER branch poisons the join); loop bodies are scanned
twice with loop-carried state, so a handoff late in iteration N is
seen by the mutation at the top of iteration N+1 — the canonical
``for chunk: buf.append(chunk); sock.write(buf)`` race.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Set, Tuple

from brpc_tpu_torch.analysis.core import Context, Finding, Rule, SourceFile

HANDOFF_METHODS = ("write", "write_small", "write_device_payload")
ALIASING_APPENDS = ("append_user_data", "append_buf")
MUTATORS = ("append", "append_user_data", "append_buf", "clear",
            "pop_front", "cut", "cut_all", "cut_into")


class IOBufAliasingRule(Rule):
    name = "iobuf-aliasing"
    description = ("no mutation of a buffer after it was handed to the "
                   "socket write path or spliced zero-copy into "
                   "another buffer")

    def check(self, sf: SourceFile, ctx: Context) -> Iterable[Finding]:
        if not sf.is_python or "/analysis/" in sf.relpath:
            return ()
        findings: List[Finding] = []
        for node in ast.walk(sf.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                findings.extend(self._scan_function(sf, node))
        return findings

    def _scan_function(self, sf: SourceFile,
                       func: ast.AST) -> List[Finding]:
        findings: List[Finding] = []
        seen: Set[Tuple[int, str, str]] = set()

        def emit(lineno: int, name: str, detail: str, via: str) -> None:
            # loop bodies are scanned twice: dedup by location
            key = (lineno, name, detail)
            if key in seen:
                return
            seen.add(key)
            findings.append(Finding(
                self.name, sf.relpath, lineno,
                f"'{name}.{detail}()' mutates a buffer already "
                f"handed off via '{via}' — the write path "
                "aliases its blocks zero-copy; build a fresh buffer "
                "instead"))

        def apply_expr(node: ast.AST, handed: Dict[str, str]) -> None:
            """Events of one simple statement/expression, in source
            order (handoffs poison a name, rebinding heals it)."""
            events = []   # (lineno, col, kind, name, detail)
            for sub in ast.walk(node):
                if isinstance(sub, ast.Assign):
                    for tgt in sub.targets:
                        if isinstance(tgt, ast.Name):
                            events.append((sub.lineno, sub.col_offset,
                                           "rebind", tgt.id, ""))
                elif isinstance(sub, ast.Call) and isinstance(
                        sub.func, ast.Attribute):
                    attr = sub.func.attr
                    if attr in HANDOFF_METHODS or attr in ALIASING_APPENDS:
                        for arg in sub.args:
                            if isinstance(arg, ast.Name):
                                events.append(
                                    (sub.lineno, sub.col_offset,
                                     "handoff", arg.id, attr))
                    if attr in MUTATORS and isinstance(sub.func.value,
                                                       ast.Name):
                        events.append((sub.lineno, sub.col_offset,
                                       "mutate", sub.func.value.id, attr))
            events.sort(key=lambda e: (e[0], e[1]))
            for lineno, _col, kind, name, detail in events:
                if kind == "rebind":
                    handed.pop(name, None)
                elif kind == "handoff":
                    handed[name] = detail
                elif kind == "mutate" and name in handed:
                    emit(lineno, name, detail, handed[name])

        def scan_stmts(stmts, handed: Dict[str, str]) -> None:
            for st in stmts:
                if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef)):
                    continue   # nested defs are scanned as their own funcs
                if isinstance(st, ast.If):
                    apply_expr(st.test, handed)
                    # disjoint branches: neither poisons the other, but
                    # a handoff on EITHER poisons the join (may-analysis)
                    h_body, h_else = dict(handed), dict(handed)
                    scan_stmts(st.body, h_body)
                    scan_stmts(st.orelse, h_else)
                    handed.clear()
                    handed.update(h_else)
                    handed.update(h_body)
                elif isinstance(st, (ast.For, ast.AsyncFor, ast.While)):
                    apply_expr(st.iter if isinstance(
                        st, (ast.For, ast.AsyncFor)) else st.test, handed)
                    # two-iteration unroll: a handoff late in the body
                    # aliases the mutation at the top of the NEXT pass
                    h = dict(handed)
                    scan_stmts(st.body, h)
                    scan_stmts(st.body, h)
                    scan_stmts(st.orelse, h)
                    handed.update(h)   # join with the zero-iteration path
                elif isinstance(st, (ast.With, ast.AsyncWith)):
                    for item in st.items:
                        apply_expr(item.context_expr, handed)
                    scan_stmts(st.body, handed)
                elif isinstance(st, ast.Try):
                    scan_stmts(st.body, handed)
                    for handler in st.handlers:
                        h = dict(handed)
                        scan_stmts(handler.body, h)
                        handed.update(h)
                    scan_stmts(st.orelse, handed)
                    scan_stmts(st.finalbody, handed)
                else:
                    apply_expr(st, handed)

        scan_stmts(func.body, {})
        return findings
