"""registry-complete: every registered protocol is a complete citizen.

A Protocol registered into the global table is probed against ALL
inbound bytes (the InputMessenger tries each in turn), so a registered
class missing its contract surfaces as a runtime NotImplementedError
on the first foreign frame — the worst possible place. The rule
resolves every ``register_protocol(X)`` call site and checks, over the
class's MRO across the analyzed file set:

  * a concrete ``parse`` (not the raising base stub);
  * a concrete ``process`` or ``process_inline`` override (either
    dispatch surface satisfies the input path);
  * a client-side encoding surface — ``serialize_request`` /
    ``pack_request`` on the class, or a module-level pack/serialize
    function in any MRO module (most protocols here pack at module
    scope);
  * an error vocabulary: the MRO modules (or the brpc_tpu_torch modules
    they import) must reference an errno mapping — ``errno_codes``,
    ``error_code``, a ``STATUS_*`` table, or an ``*Error`` exception
    class — so failures map to SOMETHING a peer can interpret.

The same discipline covers the concurrency-limiter spec parser
(``new_limiter``): a spec string names a limiter class the Server
drives on its admission hot path, so every class the parser can
construct must implement the full ConcurrencyLimiter contract —
concrete ``on_requested``, ``on_responded`` and ``max_concurrency``
(a raising stub would turn ``max_concurrency="auto"`` into a
first-request crash).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from brpc_tpu_torch.analysis.core import Context, Finding, Rule, SourceFile

_PACKAGE = "brpc_tpu_torch"

_ERRNO_RE = re.compile(
    r"errno_codes|error_code|STATUS_[A-Z]|[A-Z]\w*Error\b")
_PACKISH_RE = re.compile(
    r"def\s+\w*(pack|serialize|encode|reply|response)\w*\s*\(")


def _is_raise_stub(node: ast.AST) -> bool:
    """A def whose body (docstring aside) is just ``raise
    NotImplementedError`` — an abstract stub, not an implementation."""
    body = list(getattr(node, "body", ()))
    if body and isinstance(body[0], ast.Expr) \
            and isinstance(body[0].value, ast.Constant) \
            and isinstance(body[0].value.value, str):
        body = body[1:]
    if len(body) != 1 or not isinstance(body[0], ast.Raise):
        return False
    exc = body[0].exc
    if isinstance(exc, ast.Call):
        exc = exc.func
    return isinstance(exc, ast.Name) and exc.id == "NotImplementedError"


class RegistryCompleteRule(Rule):
    name = "registry-complete"
    description = ("every register_protocol()ed class must expose "
                   "parse + process(+_inline) + a pack/serialize "
                   "surface + an errno mapping")

    # the ConcurrencyLimiter contract the Server's admission gate
    # calls on every request (rpc/concurrency_limiter.py)
    LIMITER_CONTRACT = ("on_requested", "on_responded", "max_concurrency")

    def check(self, sf: SourceFile, ctx: Context) -> Iterable[Finding]:
        if not sf.is_python or "/analysis/" in sf.relpath:
            return ()
        findings: List[Finding] = []
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.FunctionDef) \
                    and node.name == "new_limiter":
                findings.extend(self._check_limiter_parser(sf, node, ctx))
                continue
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "register_protocol"
                    and node.args):
                continue
            cls = self._resolve_class(sf, node.args[0])
            if cls is None:
                continue
            hit = ctx.resolve_class(f"{sf.relpath}:{cls}") \
                or ctx.resolve_class(cls)
            if hit is None:
                continue
            findings.extend(self._check_class(sf, node.lineno, hit, ctx))
        return findings

    # ------------------------------------------- limiter spec parser
    def _check_limiter_parser(self, sf: SourceFile, fn: ast.FunctionDef,
                              ctx: Context) -> Iterable[Finding]:
        """Every class the spec parser can construct must be a complete
        ConcurrencyLimiter: its contract methods run on the server's
        per-request admission path, so an inherited raising stub is a
        crash wired to a config string."""
        findings: List[Finding] = []
        seen: Set[str] = set()
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)):
                continue
            name = node.func.id
            if name in seen:
                continue
            seen.add(name)
            hit = ctx.resolve_class(f"{sf.relpath}:{name}") \
                or ctx.resolve_class(name)
            if hit is None:
                continue   # int()/float()/errors — not a class here
            hit_sf, hit_cls = hit
            methods: Dict[str, Tuple[str, ast.AST]] = {}
            for m_sf, m_cls in ctx.mro_class_defs(hit_sf, hit_cls):
                for item in m_cls.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)) \
                            and item.name not in methods:
                        methods[item.name] = (m_cls.name, item)
            for want in self.LIMITER_CONTRACT:
                owner = methods.get(want)
                if owner is not None and not _is_raise_stub(owner[1]):
                    continue
                findings.append(Finding(
                    self.name, sf.relpath, node.lineno,
                    f"limiter spec parser constructs '{name}' with no "
                    f"concrete {want}() — the Server's admission gate "
                    "calls the full ConcurrencyLimiter contract on "
                    "every request"))
        return findings

    def _resolve_class(self, sf: SourceFile,
                       arg: ast.AST) -> Optional[str]:
        """The class behind register_protocol's argument: a direct
        Class() call, or a name assigned from one anywhere in the
        module (the `_instance = Proto()` idiom)."""
        if isinstance(arg, ast.Call) and isinstance(arg.func, ast.Name):
            return arg.func.id
        if not isinstance(arg, ast.Name):
            return None
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call) \
                    and isinstance(node.value.func, ast.Name):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name) and tgt.id == arg.id:
                        return node.value.func.id
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                continue
        return None

    def _check_class(self, sf: SourceFile, line: int,
                     hit: Tuple[SourceFile, ast.ClassDef],
                     ctx: Context) -> Iterable[Finding]:
        cls_sf, cls = hit
        mro = ctx.mro_class_defs(cls_sf, cls)
        findings: List[Finding] = []
        methods: Dict[str, Tuple[str, ast.AST]] = {}
        for m_sf, m_cls in mro:
            for item in m_cls.body:
                if isinstance(item, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)) \
                        and item.name not in methods:
                    methods[item.name] = (m_cls.name, item)

        def concrete(name: str) -> bool:
            owner = methods.get(name)
            if owner is None:
                return False
            owner_cls, node = owner
            if owner_cls == "Protocol":
                # the base's parse/process raise NotImplementedError;
                # its process_inline returning False is NOT a dispatch
                # surface on its own
                return name not in ("parse", "process", "process_inline")
            return True

        if not concrete("parse"):
            findings.append(Finding(
                self.name, sf.relpath, line,
                f"registered protocol '{cls.name}' has no concrete "
                "parse() — the InputMessenger probes every registered "
                "protocol against inbound bytes"))
        if not (concrete("process") or concrete("process_inline")):
            findings.append(Finding(
                self.name, sf.relpath, line,
                f"registered protocol '{cls.name}' has no concrete "
                "process()/process_inline() — parsed messages would "
                "raise on dispatch"))
        mro_files = {m_sf for m_sf, _ in mro}
        if not (concrete("serialize_request") or concrete("pack_request")
                or any(_PACKISH_RE.search(f.text) for f in mro_files)):
            findings.append(Finding(
                self.name, sf.relpath, line,
                f"registered protocol '{cls.name}' exposes no pack/"
                "serialize surface (class hook or module-level "
                "pack/serialize/encode function)"))
        if not self._has_errno_vocabulary(mro_files, ctx):
            findings.append(Finding(
                self.name, sf.relpath, line,
                f"registered protocol '{cls.name}' maps errors to "
                "nothing: no errno_codes/error_code/STATUS_*/*Error "
                "reference in its modules or their imports"))
        return findings

    def _has_errno_vocabulary(self, mro_files: Set[SourceFile],
                              ctx: Context) -> bool:
        seen: Set[str] = set()
        queue = list(mro_files)
        hops = {f.relpath: 0 for f in queue}
        while queue:
            f = queue.pop(0)
            if f.relpath in seen:
                continue
            seen.add(f.relpath)
            if _ERRNO_RE.search(f.text):
                return True
            if hops.get(f.relpath, 0) >= 2:
                continue
            for node in ast.walk(f.tree):
                mod = None
                if isinstance(node, ast.ImportFrom) and node.module:
                    mod = node.module
                elif isinstance(node, ast.Import):
                    for a in node.names:
                        if _in_package(a.name):
                            mod = a.name
                if not mod or not _in_package(mod):
                    continue
                rel = mod.replace(".", "/") + ".py"
                nxt = ctx.by_relpath.get(rel)
                if nxt is not None and nxt.relpath not in seen:
                    hops[nxt.relpath] = hops.get(f.relpath, 0) + 1
                    queue.append(nxt)
        return False


def _in_package(mod: str) -> bool:
    """The package's own modules, by its exact name: over a tree that
    also holds brpc_tpu, a bare prefix test would follow brpc_tpu's
    imports as well."""
    return mod == _PACKAGE or mod.startswith(_PACKAGE + ".")
