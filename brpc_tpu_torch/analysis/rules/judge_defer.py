"""judge-defer: every native fast lane must judge-or-defer to the
classic lane, and the C++ meta scanners must bound every narrow proto
field they admit.

The framework's fast lanes (scan_frames / serve_scan / pluck_scan /
serve_drain consumers, the turbo dispatch paths, cut-through) follow
one contract: a lane either fully JUDGES a frame with semantics
identical to the classic protobuf path, or DEFERS the verdict to it.
Two faults once breached exactly this contract (credits admitted
unbounded; need_feedback read and dropped), so the rule encodes it
twice:

Python side — any function that consumes a native scanner (calls or
resolves scan_frames/serve_scan/pluck_scan/serve_drain/trpc_scan, or
matches the fast-lane naming conventions) must contain an explicit
defer exit: a ``return None`` / ``return False`` / bare ``return``
statement the classic lane proceeds from.

C++ side — in the native meta walkers (fastcore.cc ``walk_*``
functions, mapped to the meta messages they decode), every varint
field case must be faithful:

  * an int32 field read into a 64-bit slot needs an explicit range
    guard (INT32_MAX / 0x7FFFFFFF) or a ``static_cast<int32_t>``
    matching protobuf's truncation — otherwise out-of-range varints
    ride the fast lane with different semantics than the classic
    parser (the first fault);
  * a scratch-read field (read into a local, not carried in MetaScan)
    must still be USED after the read — to defer or to gate —
    otherwise the fast lane silently drops wire semantics the classic
    lane preserves (the second fault);
  * a DEADLINE field (RpcRequestMeta.timeout_ms) must be enforced or
    deferred, never read-and-ignored: since deadline propagation the
    classic lane stamps arrival and sheds expired
    requests, so a native lane that admits a timeout-bearing request
    without a defer exit after the read serves traffic the classic
    lane would shed — its case block needs a conditional
    ``return false`` (the defer gate) downstream of the read.

The field table (number -> type, name per message) comes from the
package's hand-written meta codec, ``protocol/tpu_std.py``: the
``decode`` classmethods' ``(f, wt) == (N, _WT_*)`` (or ``f == N``)
tests, typed by the conversion each branch applies (``_as_int32`` is
int32, ``_as_int64`` int64, ``_scalar(...) != 0`` bool, a bare
``_scalar`` uint64, ``_string`` string, ``X.decode(...)`` message X).
A tree that carries a ``protocol/proto/tpu_rpc_meta.proto`` instead is
read from it. A .cc with meta walkers and neither beside it is itself
a finding: its walkers would otherwise go unchecked in silence. The
rule counts the walker cases it examined (``examined_cases``).
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Optional, Tuple

from brpc_tpu_torch.analysis.core import Context, Finding, Rule, SourceFile

SCANNER_NAMES = ("scan_frames", "serve_scan", "pluck_scan",
                 "serve_drain", "trpc_scan")
FAST_LANE_NAME_RE = re.compile(
    r"^(turbo_\w+|native_serve|fast_drain|try_cut_through"
    r"|process_\w+_fast|\w*_fast_lane\w*)$")

# native walker -> meta message it decodes
WALKER_MESSAGES = {
    "walk_request_meta": "RpcRequestMeta",
    "walk_response_meta": "RpcResponseMeta",
    "walk_stream_meta": "StreamSettings",
    "walk_meta": "RpcMeta",
}

_NARROW_TYPES = ("int32", "sint32", "sfixed32")
# deadline-class fields: reading one obliges the lane to enforce or
# defer (a conditional `return false` after the read) — see module doc
_DEADLINE_FIELDS = {("RpcRequestMeta", "timeout_ms")}
_DEFER_EXIT_RE = re.compile(r"return\s+false")
_BOUND_RE = re.compile(r"INT32_MAX|0x7FFFFFFF|static_cast<int32_t>")
_CASE_RE = re.compile(r"case\s*\((\d+)u?\s*<<\s*3\)\s*\|\s*0\s*:")
# any switch label bounds a case block — including wiretype-2 cases and
# default:, or the last varint case's "block" swallows the function tail
# and an unrelated bound there satisfies its check
_LABEL_RE = re.compile(r"\bcase\b|\bdefault\s*:")
_READ_RE = re.compile(r"read_varint\(\s*p\s*,\s*end\s*,\s*&([\w>\-\.]+)\s*\)")
_COMMENT_RE = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)


def _strip_comments(text: str) -> str:
    """Blank C++ comments in-place (newlines kept so offsets and line
    math survive): a bound or use mentioned only in a comment — e.g. an
    explanatory ``// must be <= INT32_MAX`` next to a case that lost
    its guard — must not satisfy the checks below."""
    return _COMMENT_RE.sub(lambda m: re.sub(r"[^\n]", " ", m.group(0)),
                           text)


def _parse_proto(text: str) -> Dict[str, Dict[int, Tuple[str, str]]]:
    """message -> {field_number: (type, name)} for scalar fields."""
    out: Dict[str, Dict[int, Tuple[str, str]]] = {}
    cur: Optional[str] = None
    for line in text.splitlines():
        m = re.match(r"\s*message\s+(\w+)\s*{", line)
        if m:
            cur = m.group(1)
            out[cur] = {}
            continue
        if cur and re.match(r"\s*}", line):
            cur = None
            continue
        if cur:
            f = re.match(r"\s*(?:repeated\s+)?(\w+)\s+(\w+)\s*=\s*(\d+)\s*;",
                         line)
            if f:
                out[cur][int(f.group(3))] = (f.group(1), f.group(2))
    return out


_CODEC_TYPES = {"_as_int32": "int32", "_as_int64": "int64",
                "_string": "string", "_scalar": "uint64"}


def _codec_field_number(test: ast.AST) -> Optional[int]:
    """N of a codec branch test ``(f, wt) == (N, _WT_*)`` or
    ``f == N``."""
    if not (isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.ops[0], ast.Eq)):
        return None
    left, right = test.left, test.comparators[0]
    if isinstance(left, ast.Tuple) and isinstance(right, ast.Tuple) \
            and left.elts and right.elts \
            and isinstance(left.elts[0], ast.Name) \
            and left.elts[0].id == "f":
        right = right.elts[0]
    elif not (isinstance(left, ast.Name) and left.id == "f"):
        return None
    if isinstance(right, ast.Constant) and isinstance(right.value, int):
        return right.value
    return None


def _codec_value_type(value: ast.AST) -> Optional[str]:
    """The wire type a decode branch gives the value it stores."""
    if isinstance(value, ast.Compare) and isinstance(value.left,
                                                     ast.Call):
        fn = value.left.func
        if isinstance(fn, ast.Name) and fn.id == "_scalar":
            return "bool"
    if not isinstance(value, ast.Call):
        return None
    fn = value.func
    if isinstance(fn, ast.Name):
        return _CODEC_TYPES.get(fn.id)
    if isinstance(fn, ast.Attribute) and fn.attr == "decode" \
            and isinstance(fn.value, ast.Name):
        return fn.value.id
    return None


def _codec_store(branch: List[ast.stmt]) -> Optional[Tuple[str, str]]:
    """(type, field name) of the first store in a decode branch:
    ``m.name = <value>``, ``m.name.append(<value>)`` or a local list's
    ``name.append(<value>)`` (a repeated field gathered first)."""
    for stmt in branch:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Attribute):
                ftype = _codec_value_type(node.value)
                if ftype:
                    return ftype, node.targets[0].attr
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "append" and node.args:
                recv = node.func.value
                name = (recv.attr if isinstance(recv, ast.Attribute)
                        else recv.id if isinstance(recv, ast.Name)
                        else None)
                ftype = _codec_value_type(node.args[0])
                if name and ftype:
                    return ftype, name
    return None


def _parse_codec(text: str) -> Dict[str, Dict[int, Tuple[str, str]]]:
    """message -> {field_number: (type, name)} from the ``decode``
    classmethods of a hand-written meta codec (protocol/tpu_std.py)."""
    try:
        tree = ast.parse(text)
    except SyntaxError:
        return {}
    out: Dict[str, Dict[int, Tuple[str, str]]] = {}
    for cls in tree.body:
        if not isinstance(cls, ast.ClassDef):
            continue
        for fn in cls.body:
            if not (isinstance(fn, ast.FunctionDef)
                    and fn.name == "decode"):
                continue
            fields: Dict[int, Tuple[str, str]] = {}
            for node in ast.walk(fn):
                if not isinstance(node, ast.If):
                    continue
                num = _codec_field_number(node.test)
                if num is None or num in fields:
                    continue
                hit = _codec_store(node.body)
                if hit:
                    fields[num] = hit
            if fields:
                out[cls.name] = fields
    return out


class JudgeDeferRule(Rule):
    name = "judge-defer"
    description = ("native fast lanes must defer to the classic lane; "
                   "C++ meta walkers must bound int32 fields and never "
                   "read-and-drop wire semantics")

    def __init__(self):
        # relpath -> walker cases checked against the field table
        self.examined: Dict[str, int] = {}

    def examined_cases(self) -> int:
        """Walker cases the last run checked against a field table."""
        return sum(self.examined.values())

    # ------------------------------------------------------ python side
    def check(self, sf: SourceFile, ctx: Context) -> Iterable[Finding]:
        if sf.is_python:
            return self._check_python(sf)
        if sf.relpath.endswith(".cc") and "walk_meta" in sf.text:
            return self._check_walkers(sf, ctx)
        return ()

    def _check_python(self, sf: SourceFile) -> Iterable[Finding]:
        if "/analysis/" in sf.relpath:
            return ()
        findings: List[Finding] = []
        for node in ast.walk(sf.tree):
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            if not self._is_fast_lane(node):
                continue
            if not self._has_defer_exit(node):
                findings.append(Finding(
                    self.name, sf.relpath, node.lineno,
                    f"fast-lane function '{node.name}' has no defer "
                    "exit (return None/False) — a frame the native "
                    "scanner cannot faithfully judge must fall back to "
                    "the classic lane"))
        return findings

    def _is_fast_lane(self, func: ast.AST) -> bool:
        if FAST_LANE_NAME_RE.match(func.name):
            return True
        for node in ast.walk(func):
            if isinstance(node, ast.Call):
                fn = node.func
                name = fn.attr if isinstance(fn, ast.Attribute) else (
                    fn.id if isinstance(fn, ast.Name) else None)
                if name in SCANNER_NAMES:
                    return True
            elif isinstance(node, ast.Constant) \
                    and node.value in SCANNER_NAMES:
                # getattr(fc, "scan_frames", ...)-style resolution
                return True
        return False

    def _has_defer_exit(self, func: ast.AST) -> bool:
        # a defer exit inside a NESTED def (callback/helper) does not
        # return from the fast-lane function itself
        nested = set()
        for node in ast.walk(func):
            if node is not func and isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for sub in ast.walk(node):
                    nested.add(id(sub))
        for node in ast.walk(func):
            if id(node) in nested:
                continue
            if isinstance(node, ast.Return):
                v = node.value
                if v is None:
                    return True
                if isinstance(v, ast.Constant) and (v.value is None or
                                                    v.value is False):
                    return True
                # parse()-shaped defer: return PARSE_TRY_OTHERS, None
                if isinstance(v, ast.Tuple) and v.elts and isinstance(
                        v.elts[0], ast.Name) and v.elts[0].id in (
                            "PARSE_TRY_OTHERS", "PARSE_NOT_ENOUGH_DATA"):
                    return True
        return False

    # --------------------------------------------------------- C++ side
    def _check_walkers(self, sf: SourceFile,
                       ctx: Context) -> Iterable[Finding]:
        table = self._load_table(sf)
        self.examined[sf.relpath] = 0
        if not table:
            return [Finding(
                self.name, sf.relpath, 1,
                "meta walkers with no field table: neither "
                "protocol/tpu_std.py nor protocol/proto/"
                "tpu_rpc_meta.proto sits beside the package, so the "
                "walkers' cases cannot be checked")]
        text = _strip_comments(sf.text)
        findings: List[Finding] = []
        for walker, message in WALKER_MESSAGES.items():
            fields = table.get(message)
            body, start_line = self._function_body(text, walker)
            if body is None or fields is None:
                continue
            findings.extend(self._check_cases(sf, walker, message,
                                              fields, body, start_line))
        return findings

    def _load_table(self, sf: SourceFile) -> Dict:
        # the meta codec (or a .proto) sits next to the package the .cc
        # belongs to
        root = sf.path
        for _ in range(6):
            root = os.path.dirname(root)
            codec = os.path.join(root, "protocol", "tpu_std.py")
            if os.path.exists(codec):
                with open(codec, encoding="utf-8") as f:
                    return _parse_codec(f.read())
            cand = os.path.join(root, "protocol", "proto",
                                "tpu_rpc_meta.proto")
            if os.path.exists(cand):
                with open(cand, encoding="utf-8") as f:
                    return _parse_proto(f.read())
        return {}

    def _function_body(self, text: str,
                       name: str) -> Tuple[Optional[str], int]:
        """Brace-matched body of ``name(...) {...}`` plus its first
        line number. ``text`` is the comment-stripped source."""
        m = re.search(r"\b" + name + r"\s*\([^)]*\)\s*{", text)
        if not m:
            return None, 0
        depth = 0
        for i in range(m.end() - 1, len(text)):
            c = text[i]
            if c == "{":
                depth += 1
            elif c == "}":
                depth -= 1
                if depth == 0:
                    start_line = text.count("\n", 0, m.start()) + 1
                    return text[m.start():i + 1], start_line
        return None, 0

    def _check_cases(self, sf: SourceFile, walker: str, message: str,
                     fields: Dict[int, Tuple[str, str]], body: str,
                     start_line: int) -> Iterable[Finding]:
        findings: List[Finding] = []
        cases = list(_CASE_RE.finditer(body))
        for cm in cases:
            field_no = int(cm.group(1))
            nxt = _LABEL_RE.search(body, cm.end())
            end = nxt.start() if nxt else len(body)
            block = body[cm.start():end]
            # the case block ends at its break/return run; the slice to
            # the next label is close enough for the checks below
            ftype, fname = fields.get(field_no, ("", ""))
            if not ftype:
                continue
            read = _READ_RE.search(block)
            if not read:
                continue
            self.examined[sf.relpath] += 1
            target = read.group(1)
            line = start_line + body.count("\n", 0, cm.start())
            after = block[read.end():]
            # the truncation guard `if (!read_varint(...)) return false;`
            # trails every read — its `return false` is not a defer
            # decision about the VALUE, so it must not satisfy the
            # deadline check below
            after_guard = re.sub(r"^\s*\)\s*return\s+false\s*;", "",
                                 after)
            if (message, fname) in _DEADLINE_FIELDS \
                    and not _DEFER_EXIT_RE.search(after_guard):
                findings.append(Finding(
                    self.name, sf.relpath, line,
                    f"{walker}: {message}.{fname} is read without "
                    "either enforcing or deferring — the classic lane "
                    "stamps arrival and sheds expired requests "
                    "(deadline propagation), so this lane needs a "
                    "conditional `return false` after the read (defer "
                    "the frame, or gate it on an enforce-by-"
                    "construction posture like MetaScan.defer_timeout)"))
                continue
            if target.startswith("m->"):
                if ftype in _NARROW_TYPES and not _BOUND_RE.search(block):
                    findings.append(Finding(
                        self.name, sf.relpath, line,
                        f"{walker}: {message}.{fname} is {ftype} but is "
                        "admitted into a 64-bit slot without an "
                        "INT32_MAX bound or static_cast<int32_t> — "
                        "out-of-range varints would ride the fast lane "
                        "with different semantics than the classic "
                        "parser (defer them: return false)"))
            else:
                # scratch read: the value must be used (defer/gate/carry)
                if not re.search(r"\b" + re.escape(target) + r"\b", after):
                    findings.append(Finding(
                        self.name, sf.relpath, line,
                        f"{walker}: {message}.{fname} is read into "
                        f"'{target}' and dropped — wire semantics the "
                        "classic lane preserves are silently discarded "
                        "on the fast lane (defer when set, or carry it "
                        "through the scan record)"))
        return findings
