"""fiber-blocking: no carrier-pthread-blocking call reachable from a
fiber context.

Fibers here are coroutines multiplexed onto carrier pthreads
(brpc_tpu_torch/fiber/scheduler.py); a synchronous blocking call inside one
stalls every other fiber sharing the carrier — the exact failure mode
bthread forbids with its "never call a blocking syscall from a
bthread" discipline. Fiber contexts are:

  * every ``async def`` in the package (fibers run coroutines);
  * ``parse`` / ``process`` / ``process_inline`` methods of Protocol
    subclasses (they run on the input path's fibers);
  * everything in transport/event_dispatcher.py and
    transport/ring_lane.py (the event loop / ring tick thread must
    never block on anything but its own poll);
  * the ring-lane completion entrypoints on Socket
    (``RING_COMPLETION_METHODS``): the batched tick drains its
    completion ring straight into them, so they are event-thread code
    wherever they live — the drain only queues bytes, retires writes
    and schedules fibers.

Context propagates through same-module synchronous calls (a helper
called from a fiber context is itself a fiber context). Awaited calls
are fine — ``await butex.wait()`` parks the FIBER, not the pthread;
that is the sanctioned equivalent. The worker-module boundary
(fiber/worker_module.py, where fibers intentionally hand work to
dedicated pthreads) and the fiber runtime's own pthread-side
internals (scheduler, butex pthread waiters, timer thread, device
poller, stack pool) are allowlisted: they ARE the blocking layer the
rest of the package must delegate to.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from brpc_tpu_torch.analysis.core import Context, Finding, Rule, SourceFile

# modules that legitimately block: the fiber runtime's pthread side and
# the sanctioned worker boundary
ALLOWLIST = (
    "brpc_tpu_torch/fiber/worker_module.py",
    "brpc_tpu_torch/fiber/scheduler.py",
    "brpc_tpu_torch/fiber/butex.py",
    "brpc_tpu_torch/fiber/timer.py",
    "brpc_tpu_torch/fiber/device_poller.py",
    "brpc_tpu_torch/fiber/stacks.py",
    "brpc_tpu_torch/fiber/execution_queue.py",
)

# event-loop modules where EVERY function is a fiber-adjacent context
CONTEXT_MODULES = ("brpc_tpu_torch/transport/event_dispatcher.py",
                   "brpc_tpu_torch/transport/ring_lane.py")

PROTOCOL_CONTEXT_METHODS = ("parse", "process", "process_inline")

# ring-lane completion entrypoints: the batched tick drains
# its completion ring straight into these Socket methods, so they run
# on the dispatcher thread even though they live outside the
# CONTEXT_MODULES — the drain must only queue bytes / retire writes /
# schedule fibers, mirroring the scan lane's deferred-timeout
# discipline (a blocking call here stalls EVERY fd in the batch)
RING_COMPLETION_METHODS = ("ring_input", "ring_settle_write",
                           "ring_collect_writes")

_SUBPROCESS_BLOCKING = ("run", "call", "check_call", "check_output",
                        "Popen", "getoutput", "getstatusoutput")


def _func_name(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


class _ModuleIndex:
    """Per-module: function defs, their blocking calls, their
    same-module callees, and which defs are fiber-context roots."""

    def __init__(self, sf: SourceFile, ctx: Context):
        self.sf = sf
        # key: "ClassName.func" or "func"
        self.defs: Dict[str, ast.AST] = {}
        self.roots: Set[str] = set()
        self.blocking: Dict[str, List[Tuple[int, str]]] = {}
        self.calls: Dict[str, Set[str]] = {}
        self._import_aliases(sf)
        self._collect(sf, ctx)

    def _import_aliases(self, sf: SourceFile) -> None:
        self.time_aliases: Set[str] = set()
        self.subprocess_aliases: Set[str] = set()
        self.socket_aliases: Set[str] = set()
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    alias = a.asname or a.name.split(".")[0]
                    if a.name == "time":
                        self.time_aliases.add(alias)
                    elif a.name == "subprocess":
                        self.subprocess_aliases.add(alias)
                    elif a.name == "socket":
                        self.socket_aliases.add(alias)
            elif isinstance(node, ast.ImportFrom):
                if node.module == "time":
                    for a in node.names:
                        if a.name == "sleep":
                            self.time_aliases.add(
                                f"\x00direct:{a.asname or a.name}")
                elif node.module == "subprocess":
                    for a in node.names:
                        if a.name in _SUBPROCESS_BLOCKING:
                            self.subprocess_aliases.add(
                                f"\x00direct:{a.asname or a.name}")

    # ------------------------------------------------------- collection
    def _collect(self, sf: SourceFile, ctx: Context) -> None:
        protocol_classes = _protocol_class_names(ctx)
        module_is_context = sf.relpath.endswith(CONTEXT_MODULES)

        class V(ast.NodeVisitor):
            def __init__(v):
                v.stack: List[str] = []
                v.class_stack: List[ast.ClassDef] = []

            def _enter(v, node, is_async: bool):
                cls = v.class_stack[-1].name if v.class_stack else None
                key = f"{cls}.{node.name}" if cls else node.name
                self.defs[key] = node
                if is_async or module_is_context:
                    self.roots.add(key)
                elif (cls is not None
                      and node.name in PROTOCOL_CONTEXT_METHODS
                      and cls in protocol_classes):
                    self.roots.add(key)
                elif node.name in RING_COMPLETION_METHODS:
                    self.roots.add(key)
                v.stack.append(key)
                for child in node.body:
                    v.visit(child)
                v.stack.pop()

            def visit_FunctionDef(v, node):
                v._enter(node, False)

            def visit_AsyncFunctionDef(v, node):
                v._enter(node, True)

            def visit_ClassDef(v, node):
                v.class_stack.append(node)
                for child in node.body:
                    v.visit(child)
                v.class_stack.pop()

        V().visit(sf.tree)
        # second pass, against the COMPLETE def table: helpers are
        # routinely defined below their callers, and resolving calls
        # during collection would silently drop every forward edge
        for key, node in self.defs.items():
            _FuncScan(self, key).scan(node)


class _FuncScan:
    """One function body: record blocking calls (not under Await, not
    inside a nested def) and same-module callee names."""

    def __init__(self, idx: _ModuleIndex, key: str):
        self.idx = idx
        self.key = key
        self.local_sockets: Set[str] = set()
        self.local_events: Set[str] = set()

    def scan(self, func: ast.AST) -> None:
        idx = self.idx
        idx.blocking.setdefault(self.key, [])
        idx.calls.setdefault(self.key, set())
        awaited: Set[int] = set()
        for node in ast.walk(func):
            if isinstance(node, ast.Await) and isinstance(node.value,
                                                          ast.Call):
                awaited.add(id(node.value))
        skip: Set[int] = set()
        for node in ast.walk(func):
            if node is not func and isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for sub in ast.walk(node):
                    skip.add(id(sub))
        for node in ast.walk(func):
            if id(node) in skip:
                continue
            if isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.Call):
                self._track_assign(node)
            if not isinstance(node, ast.Call) or id(node) in awaited:
                continue
            hit = self._blocking_reason(node)
            if hit:
                idx.blocking[self.key].append((node.lineno, hit))
                continue
            callee = self._same_module_callee(node)
            if callee:
                idx.calls[self.key].add(callee)

    def _track_assign(self, node: ast.Assign) -> None:
        call = node.value
        fn = call.func
        mod = fn.value.id if (isinstance(fn, ast.Attribute) and
                              isinstance(fn.value, ast.Name)) else None
        for tgt in node.targets:
            if not isinstance(tgt, ast.Name):
                continue
            if (mod in self.idx.socket_aliases
                    and isinstance(fn, ast.Attribute)
                    and fn.attr == "socket"):
                self.local_sockets.add(tgt.id)
            if (isinstance(fn, ast.Attribute) and mod == "threading"
                    and fn.attr in ("Event", "Condition")):
                self.local_events.add(tgt.id)

    def _blocking_reason(self, call: ast.Call) -> Optional[str]:
        idx = self.idx
        fn = call.func
        if isinstance(fn, ast.Name):
            if f"\x00direct:{fn.id}" in idx.time_aliases:
                return "time.sleep() blocks the carrier pthread"
            if f"\x00direct:{fn.id}" in idx.subprocess_aliases:
                return f"subprocess.{fn.id}() blocks the carrier pthread"
            return None
        if not isinstance(fn, ast.Attribute):
            return None
        base = fn.value
        base_name = base.id if isinstance(base, ast.Name) else None
        if base_name in idx.time_aliases and fn.attr == "sleep":
            return "time.sleep() blocks the carrier pthread"
        if (base_name in idx.subprocess_aliases
                and fn.attr in _SUBPROCESS_BLOCKING):
            return f"subprocess.{fn.attr}() blocks the carrier pthread"
        if (base_name in idx.socket_aliases
                and fn.attr == "create_connection"):
            return "socket.create_connection() blocks the carrier pthread"
        if (base_name in self.local_sockets
                and fn.attr in ("connect", "accept", "recv", "recvfrom",
                                "sendall", "makefile")):
            return (f"blocking socket.{fn.attr}() on a socket created "
                    "in this fiber context")
        if fn.attr == "acquire" and _lockish(fn.value):
            if not _nonblocking_acquire(call):
                return ("Lock.acquire() parks the carrier pthread — use "
                        "fiber.sync/butex primitives (or "
                        "acquire(blocking=False))")
        if fn.attr == "wait" and base_name in self.local_events:
            return ("threading.Event/Condition.wait() blocks the carrier "
                    "pthread — use fiber.sync.FiberEvent")
        return None

    def _same_module_callee(self, call: ast.Call) -> Optional[str]:
        fn = call.func
        if isinstance(fn, ast.Name) and fn.id in self.idx.defs:
            return fn.id
        if (isinstance(fn, ast.Attribute)
                and isinstance(fn.value, ast.Name)
                and fn.value.id == "self"):
            cls = self.key.split(".")[0] if "." in self.key else None
            if cls and f"{cls}.{fn.attr}" in self.idx.defs:
                return f"{cls}.{fn.attr}"
        return None


def _lockish(node: ast.AST) -> bool:
    name = None
    if isinstance(node, ast.Attribute):
        name = node.attr
    elif isinstance(node, ast.Name):
        name = node.id
    return name is not None and "lock" in name.lower()


def _nonblocking_acquire(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg == "blocking" and isinstance(kw.value, ast.Constant) \
                and kw.value.value is False:
            return True
    if call.args and isinstance(call.args[0], ast.Constant) \
            and call.args[0].value is False:
        return True
    return False


def _protocol_class_names(ctx: Context) -> Set[str]:
    """Names of classes anywhere in the file set whose MRO reaches the
    registry's Protocol base."""
    cached = getattr(ctx, "_fiber_protocol_classes", None)
    if cached is not None:
        return cached
    out: Set[str] = set()
    for key, (sf, node) in ctx.classes.items():
        if ":" not in key:
            continue
        for _, c in ctx.mro_class_defs(sf, node):
            if c.name == "Protocol":
                out.add(node.name)
                break
    ctx._fiber_protocol_classes = out
    return out


class FiberBlockingRule(Rule):
    name = "fiber-blocking"
    description = ("no pthread-blocking call (time.sleep, subprocess, "
                   "blocking socket ops, Lock.acquire, Event.wait) "
                   "reachable from a fiber/event-dispatcher/protocol-"
                   "handler context")

    def check(self, sf: SourceFile, ctx: Context) -> Iterable[Finding]:
        if not sf.is_python:
            return ()
        if sf.relpath.endswith(ALLOWLIST) or "/analysis/" in sf.relpath:
            return ()
        idx = _ModuleIndex(sf, ctx)
        findings: List[Finding] = []
        reported: Set[Tuple[int, str]] = set()
        for root in sorted(idx.roots):
            # reach the same-module closure of each fiber context
            stack, seen = [(root, (root,))], set()
            while stack:
                key, chain = stack.pop()
                if key in seen:
                    continue
                seen.add(key)
                for line, why in idx.blocking.get(key, ()):
                    if (line, why) in reported:
                        continue
                    reported.add((line, why))
                    via = ("" if len(chain) == 1 else
                           " (reached via " + " -> ".join(chain) + ")")
                    findings.append(Finding(
                        self.name, sf.relpath, line,
                        f"{why} in fiber context '{key}'{via}"))
                for callee in idx.calls.get(key, ()):
                    stack.append((callee, chain + (callee,)))
        return findings
