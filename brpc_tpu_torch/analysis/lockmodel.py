"""Whole-program lock model: every lock in the file set, and the
interprocedural acquisition graph over them.

The reference bRPC's concurrency invariants are *graph* properties —
"never take the LB lock while holding the arbitration lock", "never
fire a user callback while any framework lock is held" — and the
faults fixed by hand before this model (the batcher's callbacks, the
``_arb_lock``/``_lb_lock`` attempt records) re-learned them one at a
time. This module makes the graph a first-class
artifact the rules in ``rules/lock_cycle.py``, ``rules/
callback_under_lock.py`` and ``rules/blocking_under_lock.py`` check,
the snapshot test pins, and ``analysis/INVARIANTS.md`` publishes.

Model construction:

1. **Lock discovery.** Every ``threading.Lock()`` / ``RLock()`` /
   ``FiberMutex()`` creation is a lock node — ``self._x = ...`` in a
   class gives ``Class._x``, module-level gives ``module:_x``, and the
   lazy-member dict idiom (``Controller._LAZY = {"_arb_lock":
   threading.RLock, ...}``) gives ``Class._key``. Acquisitions of an
   attribute that is unique across all discovered locks resolve to its
   owning class even through a foreign receiver (``with cntl._arb_lock:``
   in another module lands on ``Controller._arb_lock``).
2. **Function summaries.** Every function body is walked once with a
   held-lock stack: ``with`` acquisitions (including multi-item forms),
   manual ``.acquire()`` of a discovered lock, calls made while holding,
   blocking operations, and callback invocations are recorded with the
   held set at that point.
3. **Two-pass call-edge resolution** (the fiber-blocking rule's def-
   table discipline, widened to the whole program): defs are collected
   first so forward and cross-module edges resolve against the COMPLETE
   table — same-module names, ``from x import f`` / ``import x as y``
   imports, ``self.``/MRO methods, light receiver-type inference
   (``self.x = ClassName(...)`` in ``__init__``; locals assigned from a
   constructor), and unique-method fallback for method names defined by
   exactly one class in the set (common verbs blocklisted).
4. **Fixpoints.** ``acquires_closure`` (locks a call may take,
   transitively) feeds held->acquired edges; ``under_locks`` (locks
   possibly held when a function runs) feeds the callback/blocking
   rules, each finding carrying the witness call chain.

The model is built once per analysis context (``get_lock_model``) and
shared by every rule riding it.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from brpc_tpu_torch.analysis.core import Context, SourceFile

# lock-constructor shapes: threading.Lock() / threading.RLock() /
# FiberMutex() (butex-backed; contended fibers suspend, but the HELD
# region still orders against every other lock)
_LOCK_CTORS = {"Lock": "Lock", "RLock": "RLock", "FiberMutex": "FiberMutex"}

# method names too generic for the unique-method fallback: an edge
# guessed through one of these would be noise, not analysis — the set
# covers framework verbs AND the builtin str/bytes/dict/list/set/array
# methods (a `s.replace(...)` must never resolve to some class's
# replace())
_COMMON_METHODS = frozenset((
    "run", "start", "stop", "close", "get", "put", "add", "remove",
    "write", "read", "send", "recv", "wait", "set", "clear", "update",
    "append", "pop", "join", "open", "flush", "reset", "name", "value",
    "copy", "items", "keys", "values", "submit", "cancel", "acquire",
    "release", "register", "main", "call", "connect", "handle", "next",
    "snapshot", "format", "count", "index", "insert", "extend", "expose",
    # builtin-type methods
    "replace", "strip", "lstrip", "rstrip", "split", "rsplit",
    "splitlines", "startswith", "endswith", "encode", "decode",
    "lower", "upper", "title", "ljust", "rjust", "zfill", "find",
    "rfind", "search", "match", "group", "groups", "sub", "fullmatch",
    "sort", "reverse", "setdefault", "discard", "popleft", "popitem",
    "appendleft", "to_bytes", "from_bytes", "hex", "tobytes", "cast",
    "item", "tolist", "astype", "reshape", "fill", "sum", "mean",
    "max", "min", "any", "all", "seek", "tell", "getvalue", "readline",
    "readlines", "fileno", "most_common", "elements", "total",
    "isoformat", "timestamp", "serialize", "parse",
    # threading.Condition verbs: a unique same-named fiber method must
    # not claim a stdlib condvar's notify (ring_lane's _barrier_cv)
    "notify", "notify_all",
))

_SUBPROCESS_BLOCKING = ("run", "call", "check_call", "check_output",
                        "getoutput", "getstatusoutput")

_SOCKETISH = ("sock", "stream", "conn")

# container-method calls that MUTATE their receiver: `self._q.append(x)`
# is a write to `_q` for guard purposes, same as `self._q = ...`
_MUTATORS = frozenset((
    "append", "appendleft", "add", "pop", "popleft", "popitem",
    "update", "extend", "extendleft", "remove", "discard", "clear",
    "insert", "setdefault", "rotate", "sort", "reverse",
))


class LockDef:
    """One discovered lock object."""

    __slots__ = ("name", "relpath", "line", "kind")

    def __init__(self, name: str, relpath: str, line: int, kind: str):
        self.name = name
        self.relpath = relpath
        self.line = line
        self.kind = kind


class CallSite:
    """One call made by a function: the resolution descriptor, the
    locks held at the call, and the location."""

    __slots__ = ("desc", "held", "line")

    def __init__(self, desc: tuple, held: Tuple[str, ...], line: int):
        self.desc = desc
        self.held = held
        self.line = line


class FuncInfo:
    """Summary of one function body."""

    __slots__ = ("key", "relpath", "qual", "cls", "line",
                 "acquires", "with_edges", "calls", "blocking",
                 "callbacks", "resolved_calls", "imports",
                 "thread_targets", "sleeps_in_loop", "attr_uses")

    def __init__(self, key: str, relpath: str, qual: str,
                 cls: Optional[str], line: int):
        self.key = key
        self.relpath = relpath
        self.qual = qual
        self.cls = cls
        self.line = line
        self.acquires: List[Tuple[str, int]] = []
        self.with_edges: List[Tuple[str, str, int]] = []
        self.calls: List[CallSite] = []
        # (line, why, held) blocking ops with the held set at that point
        self.blocking: List[Tuple[int, str, Tuple[str, ...]]] = []
        # (line, desc, held) callback/user-hook invocations
        self.callbacks: List[Tuple[int, str, Tuple[str, ...]]] = []
        self.resolved_calls: List[Tuple[str, Tuple[str, ...], int]] = []
        # import statements executed in this body (lazy imports)
        self.imports: List[Tuple[int, str]] = []
        # threading.Thread(target=...) creations: (desc, name kwarg, line)
        self.thread_targets: List[Tuple[tuple, str, int]] = []
        # time.sleep call lines sitting inside a while-loop body
        self.sleeps_in_loop: List[int] = []
        # attribute/global access sites with the held-lock set at each:
        # (kind 'w'|'r', field key 'Class.attr'|'module:name', line,
        # held) — the guarded-by rule's raw material. Only resolvable
        # receivers are recorded (self.X, typed receivers, declared
        # globals); an access the model cannot attribute to a class is
        # skipped, never guessed
        self.attr_uses: List[Tuple[str, str, int, Tuple[str, ...]]] = []


class _ModuleMaps:
    """Per-module import/alias tables used by call + lock resolution."""

    def __init__(self, sf: SourceFile):
        self.relpath = sf.relpath
        self.modname = sf.relpath[:-3].replace("/", ".")
        self.short = sf.relpath.rsplit("/", 1)[-1][:-3]
        self.mod_aliases: Dict[str, str] = {}     # alias -> dotted module
        self.from_imports: Dict[str, Tuple[str, str]] = {}  # local -> (mod, orig)
        self.time_aliases: Set[str] = set()
        self.subprocess_aliases: Set[str] = set()
        self.socket_aliases: Set[str] = set()
        self.direct_sleep: Set[str] = set()
        self.direct_subprocess: Set[str] = set()
        # names assigned at module top level (mutable module state the
        # guarded-by rule tracks writes/reads of)
        self.module_globals: Set[str] = set()
        for node in sf.tree.body:
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        self.module_globals.add(tgt.id)
            elif isinstance(node, ast.AnnAssign) and \
                    isinstance(node.target, ast.Name):
                self.module_globals.add(node.target.id)
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    alias = a.asname or a.name.split(".")[0]
                    self.mod_aliases[alias] = a.name
                    if a.name == "time":
                        self.time_aliases.add(alias)
                    elif a.name == "subprocess":
                        self.subprocess_aliases.add(alias)
                    elif a.name == "socket":
                        self.socket_aliases.add(alias)
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    local = a.asname or a.name
                    self.from_imports[local] = (node.module, a.name)
                    if node.module == "time" and a.name == "sleep":
                        self.direct_sleep.add(local)
                    if node.module == "subprocess" and \
                            a.name in _SUBPROCESS_BLOCKING:
                        self.direct_subprocess.add(local)


def _ctor_kind(call: ast.AST) -> Optional[str]:
    """'Lock'/'RLock'/'FiberMutex' when the node is a lock constructor
    call; None otherwise."""
    if not isinstance(call, ast.Call):
        return None
    fn = call.func
    if isinstance(fn, ast.Attribute) and fn.attr in _LOCK_CTORS and \
            isinstance(fn.value, ast.Name) and fn.value.id == "threading":
        return _LOCK_CTORS[fn.attr]
    if isinstance(fn, ast.Name) and fn.id in _LOCK_CTORS:
        # bare Lock()/RLock() only counts when imported from threading;
        # FiberMutex() counts bare (it IS the package's own primitive)
        return _LOCK_CTORS[fn.id] if fn.id == "FiberMutex" else None
    return None


def _ctor_ref_kind(node: ast.AST) -> Optional[str]:
    """The lazy-dict form: a REFERENCE to threading.Lock/RLock (not a
    call), as in Controller._LAZY values."""
    if isinstance(node, ast.Attribute) and node.attr in ("Lock", "RLock") \
            and isinstance(node.value, ast.Name) \
            and node.value.id == "threading":
        return node.attr
    if isinstance(node, ast.Name) and node.id == "FiberMutex":
        return "FiberMutex"
    return None


class LockModel:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.locks: Dict[str, LockDef] = {}
        # lock attr name -> [lock qualified names] (for unique-attr
        # resolution of foreign receivers)
        self._by_attr: Dict[str, List[str]] = {}
        self.funcs: Dict[str, FuncInfo] = {}
        # (modname, qual) -> fkey;  bare function name -> [fkey]
        self._def_index: Dict[Tuple[str, str], str] = {}
        self._methods: Dict[str, List[str]] = {}   # meth name -> [fkey]
        self._class_methods: Dict[str, Dict[str, str]] = {}
        self._maps: Dict[str, _ModuleMaps] = {}
        # fkey -> ClassName from the def's return annotation: resolves
        # factory-call receivers (global_dispatcher().pause_read(...))
        # that the unique-method fallback loses once two lane classes
        # define the method
        self._ret_types: Dict[str, str] = {}
        # (class, attr) -> ClassName   |   (modname, var) -> ClassName
        self._attr_types: Dict[Tuple[str, str], str] = {}
        self._var_types: Dict[Tuple[str, str], str] = {}
        self._event_attrs: Set[Tuple[str, str]] = set()  # (cls, attr)
        # threading.Condition attributes/globals: a Condition IS a
        # mutex for guarded-by purposes, but it never joins the lock
        # graph (its with-regions are tracked on a separate stack so
        # the pinned edge set and the blocking/callback rules are
        # unaffected)
        self._cond_attrs: Set[Tuple[str, str]] = set()   # (cls, attr)
        self._cond_vars: Set[Tuple[str, str]] = set()    # (mod, name)
        # edges: (a, b) -> (relpath, line, chain) first witness
        self.edges: Dict[Tuple[str, str],
                         Tuple[str, int, Tuple[str, ...]]] = {}
        # locks each function may acquire, transitively
        self.acquires_closure: Dict[str, Set[str]] = {}
        # locks possibly held when the function runs (callers' holds)
        self.under_locks: Dict[str, Set[str]] = {}
        # under_locks witness: fkey -> (caller fkey, lock, line)
        self._under_witness: Dict[str, Tuple[str, str, int]] = {}
        self._build()

    # ------------------------------------------------------------ build
    def _py_files(self) -> List[SourceFile]:
        return [sf for sf in self.ctx.files
                if sf.is_python and sf.tree is not None
                and "/analysis/" not in sf.relpath]

    def _build(self) -> None:
        files = self._py_files()
        for sf in files:
            self._maps[sf.relpath] = _ModuleMaps(sf)
        for sf in files:
            self._discover_locks(sf)
            self._collect_defs(sf)
        for name in self.locks:
            attr = name.split(".")[-1] if "." in name else \
                name.split(":")[-1]
            self._by_attr.setdefault(attr, []).append(name)
        # pass 2: summaries against the COMPLETE def/lock tables —
        # helpers below their callers and cross-module callees resolve
        for sf in files:
            self._summarize(sf)
        self._resolve_calls()
        self._fixpoint()
        # resolved thread targets: (creator, target fkey, name, line)
        self.thread_roots: List[Tuple[FuncInfo, str, str, int]] = []
        for info in self.funcs.values():
            maps = self._maps[info.relpath]
            for desc, tname, line in info.thread_targets:
                fkey = self.resolve_call(desc, maps, info.cls)
                if fkey:
                    self.thread_roots.append((info, fkey, tname, line))

    # ------------------------------------------------- lock discovery
    def _discover_locks(self, sf: SourceFile) -> None:
        maps = self._maps[sf.relpath]
        short = maps.short

        def add(name: str, line: int, kind: str) -> None:
            if name not in self.locks:
                self.locks[name] = LockDef(name, sf.relpath, line, kind)

        class V(ast.NodeVisitor):
            def __init__(v):
                v.cls: List[str] = []

            def visit_ClassDef(v, node: ast.ClassDef):
                v.cls.append(node.name)
                for child in node.body:
                    v.visit(child)
                v.cls.pop()

            def visit_Assign(v, node: ast.Assign):
                kind = _ctor_kind(node.value)
                if kind:
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Attribute) and \
                                isinstance(tgt.value, ast.Name) and \
                                tgt.value.id == "self" and v.cls:
                            add(f"{v.cls[-1]}.{tgt.attr}",
                                node.lineno, kind)
                        elif isinstance(tgt, ast.Name):
                            if v.cls:
                                add(f"{v.cls[-1]}.{tgt.id}",
                                    node.lineno, kind)
                            else:
                                add(f"{short}:{tgt.id}", node.lineno, kind)
                elif isinstance(node.value, ast.Dict) and v.cls:
                    # the lazy-member dict idiom (Controller._LAZY)
                    for k, val in zip(node.value.keys, node.value.values):
                        rkind = _ctor_ref_kind(val)
                        if rkind and isinstance(k, ast.Constant) and \
                                isinstance(k.value, str):
                            add(f"{v.cls[-1]}.{k.value}",
                                val.lineno, rkind)
                # receiver-type + event inference piggybacks this walk
                self_note(node, v.cls)
                v.generic_visit(node)

        def self_note(node: ast.Assign, cls: List[str]) -> None:
            val = node.value
            if not isinstance(val, ast.Call):
                return
            # fluent chains (`Adder().expose("name")` returns the
            # Adder): unwrap to the constructor call so the bound
            # name still gets its receiver type
            while isinstance(val.func, ast.Attribute) and \
                    isinstance(val.func.value, ast.Call):
                val = val.func.value
            fn = val.func
            cls_name = None
            if isinstance(fn, ast.Name):
                cls_name = fn.id
            elif isinstance(fn, ast.Attribute):
                cls_name = fn.attr
            if cls_name is None:
                return
            is_threading = (isinstance(fn, ast.Attribute)
                            and isinstance(fn.value, ast.Name)
                            and fn.value.id == "threading")
            is_event = cls_name == "Event" and is_threading
            is_cond = cls_name == "Condition" and is_threading
            for tgt in node.targets:
                if isinstance(tgt, ast.Attribute) and \
                        isinstance(tgt.value, ast.Name) and \
                        tgt.value.id == "self" and cls:
                    if is_event:
                        self._event_attrs.add((cls[-1], tgt.attr))
                    elif is_cond:
                        self._cond_attrs.add((cls[-1], tgt.attr))
                    elif cls_name in self.ctx.classes:
                        self._attr_types[(cls[-1], tgt.attr)] = cls_name
                elif isinstance(tgt, ast.Name) and not cls:
                    if is_cond:
                        self._cond_vars.add((maps.modname, tgt.id))
                    elif cls_name in self.ctx.classes and not is_event:
                        self._var_types[(maps.modname, tgt.id)] = cls_name

        V().visit(sf.tree)

    # ---------------------------------------------------- def indexing
    def _collect_defs(self, sf: SourceFile) -> None:
        maps = self._maps[sf.relpath]

        def enter(node, cls: Optional[str]) -> None:
            qual = f"{cls}.{node.name}" if cls else node.name
            fkey = f"{maps.modname}::{qual}"
            self.funcs[fkey] = FuncInfo(fkey, sf.relpath, qual, cls,
                                        node.lineno)
            self._def_index[(maps.modname, qual)] = fkey
            ann = getattr(node, "returns", None)
            if isinstance(ann, ast.Subscript):
                # Optional[X]: the class inside
                v = ann.value
                vn = v.id if isinstance(v, ast.Name) else (
                    v.attr if isinstance(v, ast.Attribute) else None)
                if vn == "Optional":
                    ann = ann.slice
            if isinstance(ann, ast.BinOp):
                # PEP-604 "X | None" / "None | X": the non-None side
                if isinstance(ann.right, ast.Constant) and \
                        ann.right.value is None:
                    ann = ann.left
                elif isinstance(ann.left, ast.Constant) and \
                        ann.left.value is None:
                    ann = ann.right
            nm = None
            if isinstance(ann, ast.Name):
                nm = ann.id
            elif isinstance(ann, ast.Attribute):
                nm = ann.attr
            elif isinstance(ann, ast.Constant) and \
                    isinstance(ann.value, str):
                # string annotation, possibly "mod.X | None": first
                # Capitalized non-None union member
                for part in ann.value.split("|"):
                    part = part.split(".")[-1].strip().strip("'\"")
                    if part and part != "None" and part[0].isupper():
                        nm = part
                        break
            if nm and nm[:1].isupper() and nm != "None":
                self._ret_types[fkey] = nm
            if cls:
                self._methods.setdefault(node.name, []).append(fkey)
                self._class_methods.setdefault(cls, {})[node.name] = fkey
            else:
                self._methods.setdefault(node.name, []).append(fkey)

        for node in sf.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                enter(node, None)
            elif isinstance(node, ast.ClassDef):
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        enter(item, node.name)

    # -------------------------------------------------- lock resolution
    def lock_at(self, node: ast.AST, maps: _ModuleMaps,
                cls: Optional[str]) -> Optional[str]:
        """Resolve an acquisition expression to a lock node name, or
        None when the expression is not a known/lock-like object."""
        if isinstance(node, ast.Attribute):
            attr = node.attr
            base = node.value
            if isinstance(base, ast.Name) and base.id == "self" and cls:
                name = f"{cls}.{attr}"
                if name in self.locks:
                    return name
                # inherited lock: find the defining base class
                for cand in self._mro_lock(cls, attr):
                    return cand
                if "lock" in attr.lower() or "mutex" in attr.lower():
                    return name          # unknown but lock-like
                return None
            # foreign receiver: typed receiver, then unique attr
            rtype = self._receiver_type(base, maps, cls)
            if rtype:
                name = f"{rtype}.{attr}"
                if name in self.locks:
                    return name
                for cand in self._mro_lock(rtype, attr):
                    return cand
            owners = self._by_attr.get(attr, ())
            if len(owners) == 1:
                return owners[0]
            if "lock" in attr.lower() or "mutex" in attr.lower():
                recv = base.id if isinstance(base, ast.Name) else "?"
                return f"{maps.short}:{recv}.{attr}"
            return None
        if isinstance(node, ast.Name):
            name = f"{maps.short}:{node.id}"
            if name in self.locks:
                return name
            if node.id in self.from_imported_locks(maps):
                return self.from_imported_locks(maps)[node.id]
            if "lock" in node.id.lower() or "mutex" in node.id.lower():
                return name
        return None

    def _mro_lock(self, cls: str, attr: str) -> Iterable[str]:
        hit = self.ctx.resolve_class(cls)
        if hit is None:
            return
        for _, c in self.ctx.mro_class_defs(*hit):
            name = f"{c.name}.{attr}"
            if name in self.locks:
                yield name
                return

    def from_imported_locks(self, maps: _ModuleMaps) -> Dict[str, str]:
        out = {}
        for local, (mod, orig) in maps.from_imports.items():
            short = mod.rsplit(".", 1)[-1]
            name = f"{short}:{orig}"
            if name in self.locks:
                out[local] = name
        return out

    def _receiver_type(self, base: ast.AST, maps: _ModuleMaps,
                       cls: Optional[str]) -> Optional[str]:
        if isinstance(base, ast.Name):
            t = self._var_types.get((maps.modname, base.id))
            if t:
                return t
        if isinstance(base, ast.Attribute) and \
                isinstance(base.value, ast.Name) and \
                base.value.id == "self" and cls:
            return self._attr_types.get((cls, base.attr))
        return None

    # ------------------------------------------------------- summaries
    def _summarize(self, sf: SourceFile) -> None:
        maps = self._maps[sf.relpath]
        model = self

        def walk_func(fkey: str, cls: Optional[str], node) -> None:
            info = self.funcs[fkey]
            _FuncWalk(model, maps, info, cls).walk(node)

        for node in sf.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                walk_func(f"{maps.modname}::{node.name}", None, node)
            elif isinstance(node, ast.ClassDef):
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        walk_func(f"{maps.modname}::{node.name}."
                                  f"{item.name}", node.name, item)

    # -------------------------------------------------- call resolution
    def resolve_call(self, desc: tuple, maps: _ModuleMaps,
                     cls: Optional[str]) -> Optional[str]:
        """Resolve a call descriptor recorded by _FuncWalk to a fkey."""
        kind = desc[0]
        if kind == "bare":
            name = desc[1]
            fkey = self._def_index.get((maps.modname, name))
            if fkey:
                return fkey
            fi = maps.from_imports.get(name)
            if fi:
                mod, orig = fi
                fkey = self._def_index.get((mod, orig))
                if fkey:
                    return fkey
            return None
        if kind == "self":
            meth = desc[1]
            if cls:
                fkey = self._class_lookup(cls, meth)
                if fkey:
                    return fkey
            return None
        if kind == "super":
            # the overridden method: first definer in the MRO past cls
            meth = desc[1]
            if not cls:
                return None
            hit = self.ctx.resolve_class(cls)
            if hit is None:
                return None
            for _, c in self.ctx.mro_class_defs(*hit):
                if c.name == cls:
                    continue
                fkey = self._class_methods.get(c.name, {}).get(meth)
                if fkey:
                    return fkey
            return None
        if kind == "attr":
            recv_desc, meth = desc[1], desc[2]
            # module alias: mod.func()
            if recv_desc[0] == "name":
                rn = recv_desc[1]
                mod = maps.mod_aliases.get(rn)
                if mod:
                    return self._def_index.get((mod, meth))
                # from-imported class: ClassName.meth()
                fi = maps.from_imports.get(rn)
                if fi and fi[1] in self._class_methods:
                    return self._class_lookup(fi[1], meth)
                if rn in self._class_methods:
                    return self._class_lookup(rn, meth)
                t = self._var_types.get((maps.modname, rn))
                if t:
                    return self._class_lookup(t, meth)
            elif recv_desc[0] == "selfattr" and cls:
                t = self._attr_types.get((cls, recv_desc[1]))
                if t:
                    fkey = self._class_lookup(t, meth)
                    if fkey:
                        return fkey
            elif recv_desc[0] == "callret":
                # the receiver is a factory call: type it from the
                # factory's return annotation (global_dispatcher() ->
                # EventDispatcher), so lane-duck-typed methods resolve
                # even when several classes define them
                fname = recv_desc[1]
                ffkey = self._def_index.get((maps.modname, fname))
                if not ffkey:
                    fi = maps.from_imports.get(fname)
                    if fi:
                        ffkey = self._def_index.get((fi[0], fi[1]))
                if ffkey:
                    rt = self._ret_types.get(ffkey)
                    if rt:
                        fkey = self._class_lookup(rt, meth)
                        if fkey:
                            return fkey
            # unique-method fallback
            if meth not in _COMMON_METHODS and not meth.startswith("__"):
                hits = self._methods.get(meth, ())
                cm = [h for h in hits if self.funcs[h].cls]
                if len(cm) == 1:
                    return cm[0]
        return None

    def _class_lookup(self, cls: str, meth: str) -> Optional[str]:
        direct = self._class_methods.get(cls, {}).get(meth)
        if direct:
            return direct
        hit = self.ctx.resolve_class(cls)
        if hit is None:
            return None
        for _, c in self.ctx.mro_class_defs(*hit):
            fkey = self._class_methods.get(c.name, {}).get(meth)
            if fkey:
                return fkey
        return None

    def _resolve_calls(self) -> None:
        for info in self.funcs.values():
            maps = self._maps[info.relpath]
            for site in info.calls:
                fkey = self.resolve_call(site.desc, maps, info.cls)
                if fkey and fkey != info.key:
                    info.resolved_calls.append((fkey, site.held,
                                                site.line))

    # --------------------------------------------------------- fixpoint
    def _fixpoint(self) -> None:
        # 1. transitive acquires
        reach = {k: {a for a, _ in f.acquires}
                 for k, f in self.funcs.items()}
        changed = True
        while changed:
            changed = False
            for k, f in self.funcs.items():
                for callee, _, _ in f.resolved_calls:
                    extra = reach.get(callee, set()) - reach[k]
                    if extra:
                        reach[k].update(extra)
                        changed = True
        self.acquires_closure = reach
        # 2. edges: direct with-nesting + held-at-call -> callee closure
        for f in self.funcs.values():
            for a, b, line in f.with_edges:
                self.edges.setdefault((a, b), (f.relpath, line, (f.key,)))
            for callee, held, line in f.resolved_calls:
                if not held:
                    continue
                for b in reach.get(callee, ()):
                    for a in held:
                        if a != b:
                            self.edges.setdefault(
                                (a, b),
                                (f.relpath, line, (f.key, callee)))
        # 3. under_locks: locks possibly held when a function runs
        under: Dict[str, Set[str]] = {k: set() for k in self.funcs}
        changed = True
        while changed:
            changed = False
            for k, f in self.funcs.items():
                for callee, held, line in f.resolved_calls:
                    if callee not in under:
                        continue
                    inbound = set(held) | under[k]
                    extra = inbound - under[callee]
                    if extra:
                        under[callee].update(extra)
                        self._under_witness.setdefault(
                            callee, (k, next(iter(extra)), line))
                        changed = True
        self.under_locks = under

    # -------------------------------------------------------- reporting
    def same_module_closure(self, root: str):
        """BFS over resolved call edges restricted to the root's own
        module, yielding ``(FuncInfo, chain)`` once per function — the
        traversal the thread-loop rules (sampler imports, sleep
        pacing) share."""
        stack = [(root, (root,))]
        seen: Set[str] = set()
        while stack:
            key, chain = stack.pop()
            if key in seen:
                continue
            seen.add(key)
            info = self.funcs.get(key)
            if info is None:
                continue
            yield info, chain
            for callee, _, _ in info.resolved_calls:
                if callee in self.funcs and \
                        self.funcs[callee].relpath == info.relpath:
                    stack.append((callee, chain + (callee,)))

    def witness_chain(self, fkey: str, limit: int = 6) -> List[str]:
        """Caller chain showing how fkey comes to run under a lock."""
        chain = [fkey]
        seen = {fkey}
        cur = fkey
        while cur in self._under_witness and len(chain) < limit:
            caller, _, _ = self._under_witness[cur]
            if caller in seen:
                break
            chain.append(caller)
            seen.add(caller)
            cur = caller
        return list(reversed(chain))

    def acquire_site(self, fkey: str,
                     lock: str) -> Optional[Tuple[str, int]]:
        """Where (relpath, line) the function or its callees first
        acquire the given lock — BFS so the witness is shortest."""
        queue = [fkey]
        seen = set()
        while queue:
            cur = queue.pop(0)
            if cur in seen:
                continue
            seen.add(cur)
            f = self.funcs.get(cur)
            if f is None:
                continue
            for a, line in f.acquires:
                if a == lock:
                    return (f.relpath, line)
            for callee, _, _ in f.resolved_calls:
                queue.append(callee)
        return None

    def graph(self) -> Dict[str, Set[str]]:
        g: Dict[str, Set[str]] = {}
        for (a, b) in self.edges:
            g.setdefault(a, set()).add(b)
            g.setdefault(b, set())
        return g

    def cycles(self) -> List[Tuple[str, ...]]:
        """Elementary cycles via Tarjan SCCs (every SCC with an internal
        edge reports one canonical cycle)."""
        graph = self.graph()
        index: Dict[str, int] = {}
        low: Dict[str, int] = {}
        on_stack: Set[str] = set()
        stack: List[str] = []
        counter = [0]
        sccs: List[List[str]] = []

        def strongconnect(v: str) -> None:
            index[v] = low[v] = counter[0]
            counter[0] += 1
            stack.append(v)
            on_stack.add(v)
            for w in sorted(graph.get(v, ())):
                if w not in index:
                    strongconnect(w)
                    low[v] = min(low[v], low[w])
                elif w in on_stack:
                    low[v] = min(low[v], index[w])
            if low[v] == index[v]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == v:
                        break
                sccs.append(scc)

        for v in sorted(graph):
            if v not in index:
                strongconnect(v)
        out: List[Tuple[str, ...]] = []
        for scc in sccs:
            if len(scc) > 1:
                out.append(tuple(sorted(scc)))
            elif scc and scc[0] in graph.get(scc[0], ()):
                out.append((scc[0],))
        return out


class _FuncWalk(ast.NodeVisitor):
    """One function body: held-lock stack + event recording."""

    def __init__(self, model: LockModel, maps: _ModuleMaps,
                 info: FuncInfo, cls: Optional[str]):
        self.model = model
        self.maps = maps
        self.info = info
        self.cls = cls
        self.held: List[str] = []
        # Condition-guarded regions: a parallel stack feeding ONLY the
        # attr_uses held tuples (conditions are mutexes for guard
        # inference but stay out of the lock graph / blocking rules)
        self.cond_held: List[str] = []
        self.loops = 0                    # while-loop nesting depth
        self.awaited: Set[int] = set()
        self.local_events: Set[str] = set()
        self.local_sockets: Set[str] = set()
        self.with_ctxs: Set[str] = set()   # receivers used as `with X:`
        self.globals_decl: Set[str] = set()   # `global x` names
        self.local_stores: Set[str] = set()   # names assigned locally
        # Attribute/Name nodes that are WRITES despite Load ctx (the
        # receiver of a subscript store / del / mutating method call)
        self._sub_writes: Set[int] = set()
        # Attribute nodes that are a call's method slot, not field reads
        self._method_attrs: Set[int] = set()

    def walk(self, func) -> None:
        for node in ast.walk(func):
            if isinstance(node, ast.Await) and \
                    isinstance(node.value, ast.Call):
                self.awaited.add(id(node.value))
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    r = _recv_name(item.context_expr)
                    if r:
                        self.with_ctxs.add(r)
            if isinstance(node, ast.Global):
                self.globals_decl.update(node.names)
            if isinstance(node, ast.Name) and \
                    isinstance(node.ctx, ast.Store):
                self.local_stores.add(node.id)
        self.local_stores -= self.globals_decl
        for child in func.body:
            self.visit(child)

    # nested defs are separate contexts (and lambdas defer execution)
    def visit_FunctionDef(self, node):
        pass

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        pass

    def visit_Import(self, node: ast.Import) -> None:
        names = ", ".join(a.name for a in node.names)
        self.info.imports.append((node.lineno, names))

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        names = ", ".join(a.name for a in node.names)
        self.info.imports.append(
            (node.lineno, f"{node.module or '.'}: {names}"))

    def visit_While(self, node: ast.While) -> None:
        self.loops += 1
        self.generic_visit(node)
        self.loops -= 1

    def _cond_name(self, expr: ast.AST) -> Optional[str]:
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and \
                expr.value.id == "self" and self.cls and \
                (self.cls, expr.attr) in self.model._cond_attrs:
            return f"{self.cls}.{expr.attr}"
        if isinstance(expr, ast.Name) and \
                (self.maps.modname, expr.id) in self.model._cond_vars:
            return f"{self.maps.short}:{expr.id}"
        return None

    def visit_With(self, node: ast.With) -> None:
        entered = 0
        cond_entered = 0
        for item in node.items:
            name = self.model.lock_at(item.context_expr, self.maps,
                                      self.cls)
            if name:
                for h in self.held:
                    self.info.with_edges.append((h, name, node.lineno))
                self.info.acquires.append((name, node.lineno))
                self.held.append(name)
                entered += 1
            else:
                cname = self._cond_name(item.context_expr)
                if cname:
                    self.cond_held.append(cname)
                    cond_entered += 1
        for child in node.body:
            self.visit(child)
        for _ in range(entered):
            self.held.pop()
        for _ in range(cond_entered):
            self.cond_held.pop()

    visit_AsyncWith = visit_With

    # -------------------------------------------- attribute use sites
    def _field_key(self, node: ast.Attribute) -> Optional[str]:
        """'Class.attr' / 'module:name' for a resolvable receiver, else
        None (never guessed)."""
        attr = node.attr
        if attr.startswith("__"):
            return None
        base = node.value
        if isinstance(base, ast.Name):
            if base.id == "self":
                return f"{self.cls}.{attr}" if self.cls else None
            # ClassName.attr class-var access (known class)
            if base.id in self.model._class_methods:
                return f"{base.id}.{attr}"
        rtype = self.model._receiver_type(base, self.maps, self.cls)
        if rtype:
            return f"{rtype}.{attr}"
        return None

    def _mark_sub_write(self, tgt: ast.AST) -> None:
        """`x[k] = v` / `del x[k]` / `x[k] += v` mutate the container
        `x` even though the receiver node carries Load ctx."""
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._mark_sub_write(el)
        elif isinstance(tgt, ast.Starred):
            self._mark_sub_write(tgt.value)
        elif isinstance(tgt, ast.Subscript):
            v = tgt.value
            if isinstance(v, (ast.Attribute, ast.Name)):
                self._sub_writes.add(id(v))

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if id(node) not in self._method_attrs:
            key = self._field_key(node)
            if key is not None:
                if isinstance(node.ctx, (ast.Store, ast.Del)) or \
                        id(node) in self._sub_writes:
                    kind = "w"
                else:
                    kind = "r"
                self.info.attr_uses.append(
                    (kind, key, node.lineno,
                     tuple(self.held) + tuple(self.cond_held)))
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name) -> None:
        name = node.id
        if isinstance(node.ctx, (ast.Store, ast.Del)):
            if name in self.globals_decl:
                self.info.attr_uses.append(
                    ("w", f"{self.maps.short}:{name}", node.lineno,
                     tuple(self.held) + tuple(self.cond_held)))
        elif name in self.maps.module_globals and \
                name not in self.local_stores:
            kind = "w" if id(node) in self._sub_writes else "r"
            self.info.attr_uses.append(
                (kind, f"{self.maps.short}:{name}", node.lineno,
                 tuple(self.held) + tuple(self.cond_held)))

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._mark_sub_write(node.target)
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            self._mark_sub_write(t)
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._mark_sub_write(t)
        val = node.value
        if isinstance(val, ast.Call):
            fn = val.func
            if isinstance(fn, ast.Attribute) and \
                    isinstance(fn.value, ast.Name):
                if fn.value.id == "threading" and fn.attr == "Event":
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            self.local_events.add(t.id)
                if fn.value.id in self.maps.socket_aliases and \
                        fn.attr == "socket":
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            self.local_sockets.add(t.id)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        held = tuple(self.held)
        fn = node.func
        if isinstance(fn, ast.Attribute):
            # the method slot itself is not a field read; a mutating
            # container method IS a write to its receiver
            self._method_attrs.add(id(fn))
            if fn.attr in _MUTATORS and \
                    isinstance(fn.value, (ast.Attribute, ast.Name)) and \
                    self.model._receiver_type(
                        fn.value, self.maps, self.cls) is None:
                # typed receivers (Adder.add, Maxer.update...) are
                # domain calls, not raw container mutations — the
                # callee class's own fields get their own analysis
                self._sub_writes.add(id(fn.value))
        self._note_thread_target(node)
        handled = False
        # manual acquire of a discovered lock = acquisition event
        if isinstance(fn, ast.Attribute) and fn.attr == "acquire":
            name = self.model.lock_at(fn.value, self.maps, self.cls)
            if name:
                for h in self.held:
                    if h != name:
                        self.info.with_edges.append((h, name,
                                                     node.lineno))
                self.info.acquires.append((name, node.lineno))
                handled = True
        if not handled and id(node) not in self.awaited:
            why = self._blocking_reason(node)
            if why:
                self.info.blocking.append((node.lineno, why, held))
                if why == "time.sleep()" and self.loops > 0:
                    self.info.sleeps_in_loop.append(node.lineno)
                handled = True
            else:
                cb = self._callback_desc(node)
                if cb:
                    self.info.callbacks.append((node.lineno, cb, held))
        if not handled:
            desc = self._call_desc(node)
            if desc:
                self.info.calls.append(CallSite(desc, held, node.lineno))
        self.generic_visit(node)

    def _note_thread_target(self, node: ast.Call) -> None:
        fn = node.func
        is_thread = (isinstance(fn, ast.Attribute) and fn.attr == "Thread"
                     and isinstance(fn.value, ast.Name)
                     and fn.value.id == "threading")
        if not is_thread and isinstance(fn, ast.Name) and \
                fn.id == "Thread" and \
                self.maps.from_imports.get("Thread", ("",))[0] == \
                "threading":
            is_thread = True
        if not is_thread:
            return
        target = None
        tname = ""
        for kw in node.keywords:
            if kw.arg == "target":
                v = kw.value
                if isinstance(v, ast.Name):
                    target = ("bare", v.id)
                elif isinstance(v, ast.Attribute) and \
                        isinstance(v.value, ast.Name) and \
                        v.value.id == "self":
                    target = ("self", v.attr)
            elif kw.arg == "name" and isinstance(kw.value, ast.Constant) \
                    and isinstance(kw.value.value, str):
                tname = kw.value.value
        if target is not None:
            self.info.thread_targets.append((target, tname, node.lineno))

    # ------------------------------------------------------ classifiers
    def _blocking_reason(self, node: ast.Call) -> Optional[str]:
        fn = node.func
        maps = self.maps
        if isinstance(fn, ast.Name):
            if fn.id in maps.direct_sleep:
                return "time.sleep()"
            if fn.id in maps.direct_subprocess:
                return f"subprocess.{fn.id}()"
            return None
        if not isinstance(fn, ast.Attribute):
            return None
        base = fn.value
        bname = base.id if isinstance(base, ast.Name) else None
        battr = base.attr if isinstance(base, ast.Attribute) else None
        if bname in maps.time_aliases and fn.attr == "sleep":
            return "time.sleep()"
        if bname in maps.subprocess_aliases and \
                fn.attr in _SUBPROCESS_BLOCKING:
            return f"subprocess.{fn.attr}()"
        if bname in maps.socket_aliases and \
                fn.attr == "create_connection":
            return "socket.create_connection()"
        if fn.attr in ("connect", "accept", "recv", "recvfrom",
                       "sendall", "makefile"):
            if bname in self.local_sockets:
                return f"blocking socket.{fn.attr}()"
        if fn.attr == "wait":
            recv = _recv_name(base)
            # a receiver also used as `with X:` in this function is a
            # Condition (wait releases the lock) — not a blocking hazard
            if recv and recv in self.with_ctxs:
                return None
            if bname in self.local_events:
                return "threading.Event.wait()"
            is_event_attr = (battr is not None and isinstance(
                base, ast.Attribute) and isinstance(base.value, ast.Name)
                and base.value.id == "self" and self.cls
                and (self.cls, battr) in self.model._event_attrs)
            if is_event_attr:
                return "threading.Event.wait()"
            if recv and ("_ev" in recv or "event" in recv.lower()
                         or recv.endswith("_done")):
                return f"{recv}.wait()"
        return None

    def _callback_desc(self, node: ast.Call) -> Optional[str]:
        fn = node.func
        name = None
        if isinstance(fn, ast.Attribute):
            name = fn.attr
        elif isinstance(fn, ast.Name):
            name = fn.id
        elif isinstance(fn, ast.Subscript):
            v = fn.value
            vn = v.attr if isinstance(v, ast.Attribute) else (
                v.id if isinstance(v, ast.Name) else None)
            if vn and any(h in vn.lower()
                          for h in ("hook", "callback", "cbs", "_cb")):
                return f"stored callback {vn}[...]"
            return None
        if name is None:
            return None
        low = name.lower()
        if (low.startswith("on_") or "callback" in low
                or low.endswith("_cb") or low == "cb"
                or "hook" in low) and not low.startswith("on_event_"):
            kind = "stored callback" if isinstance(fn, ast.Attribute) \
                else "callback parameter"
            return f"{kind} {name}()"
        if isinstance(fn, ast.Attribute) and \
                name in ("write", "write_nowait", "sendall", "send"):
            # the socket-write clause applies ABOVE the wire machinery:
            # transport/ and protocol/ ARE the write path and serialize
            # fd writes under their own locks by design
            rel = self.maps.relpath
            if "/transport/" in rel or "/protocol/" in rel:
                return None
            recv = _recv_name(fn.value)
            if recv and any(s in recv.lower() for s in _SOCKETISH):
                return f"socket write {recv}.{name}()"
        return None

    def _call_desc(self, node: ast.Call) -> Optional[tuple]:
        fn = node.func
        if isinstance(fn, ast.Name):
            return ("bare", fn.id)
        if isinstance(fn, ast.Attribute):
            base = fn.value
            if isinstance(base, ast.Name):
                if base.id == "self":
                    return ("self", fn.attr)
                return ("attr", ("name", base.id), fn.attr)
            if isinstance(base, ast.Attribute) and \
                    isinstance(base.value, ast.Name) and \
                    base.value.id == "self":
                return ("attr", ("selfattr", base.attr), fn.attr)
            if isinstance(base, ast.Call) and \
                    isinstance(base.func, ast.Name):
                if base.func.id == "super":
                    return ("super", fn.attr)
                # factory-call receiver: global_dispatcher().pause_read()
                return ("attr", ("callret", base.func.id), fn.attr)
            return ("attr", ("expr",), fn.attr)
        return None


def _recv_name(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def get_lock_model(ctx: Context) -> LockModel:
    """The per-context singleton every lock rule shares."""
    model = getattr(ctx, "_lock_model", None)
    if model is None:
        model = LockModel(ctx)
        ctx._lock_model = model
    return model
