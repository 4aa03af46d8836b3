"""graftlint core: source model, waivers, rule base, analyzer.

The analyzer parses every Python module once into an AST and exposes a
light line-oriented view of the native C++ sources; rules see the whole
file set at once (cross-module checks like lock-order cycles and
registry completeness need it). Findings carry a stable (path, line,
rule) identity so waivers and diffs are deterministic.

Waiver syntax (Python ``#`` and C++ ``//`` comments, same grammar):

    # graftlint: disable=<rule>[,<rule>...] -- <reason>

placed on the offending line or the line directly above. A whole file
opts out of a rule with ``disable-file=``. A waiver MUST carry a
reason after ``--``; a bare waiver is itself reported (rule
``waiver-reason``) so suppressions stay auditable. A reason started on
a comment-only waiver line may wrap across the comment block below it;
the whole run is recorded as the reason.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

_WAIVER_RE = re.compile(
    r"(?:#|//)\s*graftlint:\s*(disable(?:-file)?)="
    r"([A-Za-z0-9_,-]+)\s*(?:--\s*(\S.*))?")


class Finding:
    """One rule violation at a source location."""

    __slots__ = ("rule", "path", "line", "message", "waived", "reason")

    def __init__(self, rule: str, path: str, line: int, message: str):
        self.rule = rule
        self.path = path
        self.line = line
        self.message = message
        self.waived = False
        self.reason: Optional[str] = None   # waiver reason when waived

    def key(self) -> Tuple[str, int, str]:
        return (self.path, self.line, self.rule)

    def format(self) -> str:
        tag = " (waived)" if self.waived else ""
        return f"{self.path}:{self.line}: [{self.rule}]{tag} {self.message}"

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message, "waived": self.waived,
                "reason": self.reason}


class SourceFile:
    """One analyzed file: text + lines + (for .py) a parsed AST, plus
    the waiver table extracted from its comments."""

    def __init__(self, path: str, relpath: str, text: str):
        self.path = path
        self.relpath = relpath
        self.text = text
        self.lines = text.splitlines()
        self.is_python = relpath.endswith(".py")
        self.tree: Optional[ast.AST] = None
        self.parse_error: Optional[str] = None
        if self.is_python:
            try:
                self.tree = ast.parse(text, filename=relpath)
            except SyntaxError as e:
                self.parse_error = f"syntax error: {e}"
        # line -> set of disabled rules; 0 -> file-wide
        self.waivers: Dict[int, set] = {}
        # (line, rule) -> the waiver's full reason text
        self.reasons: Dict[Tuple[int, str], str] = {}
        self.bare_waivers: List[int] = []   # waiver lines missing a reason
        self._scan_waivers()

    def _scan_waivers(self) -> None:
        for i, line in enumerate(self.lines, start=1):
            m = _WAIVER_RE.search(line)
            if not m:
                continue
            kind, rules, reason = m.group(1), m.group(2), m.group(3)
            names = {r.strip() for r in rules.split(",") if r.strip()}
            slots = [0] if kind == "disable-file" else self._slots_for(i)
            if reason:
                reason = self._extend_reason(i, reason)
            for slot in slots:
                self.waivers.setdefault(slot, set()).update(names)
                for name in names:
                    self.reasons[(slot, name)] = reason or ""
            if not reason:
                self.bare_waivers.append(i)

    def _extend_reason(self, i: int, reason: str) -> str:
        """A reason started on a pure-comment waiver line continues
        through the comment run below it (up to the next code line or
        the next waiver) — the audit ledger must record the whole
        sentence, not the first line's fragment."""
        if not self.lines[i - 1].lstrip().startswith(("#", "//")):
            return reason          # inline waiver: reason ends with it
        parts = [reason]
        for j in range(i + 1, min(i + 8, len(self.lines)) + 1):
            nxt = self.lines[j - 1].lstrip()
            if not nxt.startswith(("#", "//")) or "graftlint:" in nxt:
                break
            parts.append(nxt.lstrip("#/").strip())
        return " ".join(p for p in parts if p)

    def _slots_for(self, i: int) -> list:
        """A waiver on line i covers i itself and — when i is a pure
        comment line — the first code line of the run below it (a
        multi-line comment block above the offending statement)."""
        slots = [i]
        stripped = self.lines[i - 1].lstrip()
        if stripped.startswith(("#", "//")):
            j = i + 1
            while j <= len(self.lines) and \
                    self.lines[j - 1].lstrip().startswith(("#", "//")):
                j += 1
            if j <= len(self.lines) and j - i <= 8:
                slots.append(j)
        return slots

    def waiver_reason(self, line: int, rule: str) -> Optional[str]:
        """The waiver reason if (line, rule) is waived, else None.
        Checks the line itself and file-wide — comment-above waivers
        were already mapped onto their first code line by _slots_for,
        so probing line-1 here would only let a waiver leak onto an
        unrelated same-rule finding on the following line."""
        for slot in (line, 0):
            disabled = self.waivers.get(slot)
            if disabled and (rule in disabled or "all" in disabled):
                name = rule if rule in disabled else "all"
                return self.reasons.get((slot, name), "")
        return None


class Rule:
    """Base class for graftlint rules.

    ``check(sf, ctx)`` runs per file; ``finalize(ctx)`` runs once after
    every file was seen (cross-module rules accumulate state in check
    and report in finalize). Both return Finding iterables.
    """

    name = "?"
    description = ""

    def check(self, sf: SourceFile, ctx: "Context") -> Iterable[Finding]:
        return ()

    def finalize(self, ctx: "Context") -> Iterable[Finding]:
        return ()


class Context:
    """Shared analysis context: the full file set plus lazily built
    cross-module tables (class hierarchy, import map)."""

    def __init__(self, files: List[SourceFile]):
        self.files = files
        self.by_relpath = {f.relpath: f for f in files}
        self._classes: Optional[Dict[str, Tuple[SourceFile,
                                                ast.ClassDef]]] = None

    # ---------------------------------------------------- class table
    @property
    def classes(self) -> Dict[str, Tuple[SourceFile, ast.ClassDef]]:
        """qualified 'relpath-sans-.py:ClassName' -> (file, node), plus
        a bare-name alias when unambiguous."""
        if self._classes is None:
            table: Dict[str, Tuple[SourceFile, ast.ClassDef]] = {}
            bare: Dict[str, list] = {}
            for sf in self.files:
                if sf.tree is None:
                    continue
                for node in ast.walk(sf.tree):
                    if isinstance(node, ast.ClassDef):
                        table[f"{sf.relpath}:{node.name}"] = (sf, node)
                        bare.setdefault(node.name, []).append((sf, node))
            for name, hits in bare.items():
                if len(hits) == 1 and name not in table:
                    table[name] = hits[0]
            self._classes = table
        return self._classes

    def resolve_class(self, name: str) -> Optional[Tuple[SourceFile,
                                                         ast.ClassDef]]:
        return self.classes.get(name)

    def mro_class_defs(self, sf: SourceFile,
                       node: ast.ClassDef) -> List[Tuple[SourceFile,
                                                         ast.ClassDef]]:
        """(file, ClassDef) for node and every resolvable base,
        breadth-first across the analyzed file set."""
        out, seen, queue = [], set(), [(sf, node)]
        while queue:
            cur_sf, cur = queue.pop(0)
            key = (cur_sf.relpath, cur.name)
            if key in seen:
                continue
            seen.add(key)
            out.append((cur_sf, cur))
            for base in cur.bases:
                base_name = base.id if isinstance(base, ast.Name) else (
                    base.attr if isinstance(base, ast.Attribute) else None)
                if base_name:
                    hit = self.resolve_class(base_name)
                    if hit:
                        queue.append(hit)
        return out


def iter_source_files(paths: Sequence[str]) -> List[SourceFile]:
    """Collect .py and .cc files under the given paths (files or
    directories), relpaths anchored at the repo root (the directory
    containing the brpc_tpu_torch package) when detectable. The CUDA
    sources (``ops/csrc/*.cu``, ``*.cuh``) are not read: no rule
    checks them."""
    roots: List[str] = []
    for p in paths:
        roots.append(os.path.abspath(p))
    # anchor: nearest ancestor containing brpc_tpu_torch/ (for stable
    # relpaths)
    anchor = os.getcwd()
    for r in roots:
        d = r if os.path.isdir(r) else os.path.dirname(r)
        while d and d != os.path.dirname(d):
            if os.path.isdir(os.path.join(d, "brpc_tpu_torch")):
                anchor = d
                break
            d = os.path.dirname(d)
    out: List[SourceFile] = []
    seen = set()

    def add(fp: str) -> None:
        if fp in seen or not fp.endswith((".py", ".cc")):
            return
        seen.add(fp)
        try:
            with open(fp, encoding="utf-8", errors="replace") as f:
                text = f.read()
        except OSError:
            return
        rel = os.path.relpath(fp, anchor)
        out.append(SourceFile(fp, rel.replace(os.sep, "/"), text))

    for r in roots:
        if os.path.isfile(r):
            add(r)
            continue
        for dirpath, dirnames, filenames in os.walk(r):
            dirnames[:] = [d for d in dirnames
                           if d not in ("__pycache__", ".git")]
            for fn in sorted(filenames):
                add(os.path.join(dirpath, fn))
    out.sort(key=lambda s: s.relpath)
    return out


class Analyzer:
    def __init__(self, rules: Optional[Sequence[Rule]] = None):
        if rules is None:
            from brpc_tpu_torch.analysis.rules import default_rules
            rules = default_rules()
        self.rules = list(rules)
        self.file_count = 0         # files the last run read

    def run(self, paths: Sequence[str]) -> Tuple[List[Finding],
                                                 List[Finding]]:
        """Returns (active, waived) findings, each sorted by location.
        Waivers lacking a reason surface as ``waiver-reason`` findings
        (never waivable by themselves)."""
        return self.run_context(Context(iter_source_files(paths)))

    def run_context(self, ctx: Context) -> Tuple[List[Finding],
                                                 List[Finding]]:
        """``run`` over a context already built: the models the rules
        ride (lock, thread) are cached on it, so a caller that also
        reads them builds each once."""
        files = ctx.files
        self.file_count = len(files)
        findings: List[Finding] = []
        for sf in files:
            if sf.parse_error:
                findings.append(Finding("parse", sf.relpath, 1,
                                        sf.parse_error))
                continue
            for rule in self.rules:
                findings.extend(rule.check(sf, ctx))
        for rule in self.rules:
            findings.extend(rule.finalize(ctx))
        for sf in files:
            for line in sf.bare_waivers:
                findings.append(Finding(
                    "waiver-reason", sf.relpath, line,
                    "waiver without a reason: append ' -- <why>'"))
        active: List[Finding] = []
        waived: List[Finding] = []
        seen = set()
        for f in sorted(findings, key=Finding.key):
            if f.key() in seen:
                continue
            seen.add(f.key())
            sf = ctx.by_relpath.get(f.path)
            reason = (sf.waiver_reason(f.line, f.rule)
                      if sf is not None and f.rule != "waiver-reason"
                      else None)
            if reason is not None:
                f.waived = True
                f.reason = reason
                waived.append(f)
            else:
                active.append(f)
        return active, waived
