"""ProjectContext: the whole-program half of bjx-lint.

Per-file rules see one module at a time; the cross-thread bug class
that reviews kept catching by hand — a ``state_dict`` snapshot racing
the draw loop, a ``stop()``-vs-last-worker teardown race, a service
thread wedged by an unbounded send — is invisible at that granularity. This module builds ONE
context over every module in the run (re-using the per-file pass's
parsed ``ModuleContext`` objects — the shared AST cache) and computes
the three things the concurrency rules (BJX117/118/119, in
``blendjax_torch/analysis/rules/concurrency.py``) need:

- a **thread-spawn graph**: every ``threading.Thread(target=...)``
  / ``Timer`` / executor ``submit`` site is resolved to the function
  it runs, and every function is assigned the set of *thread contexts*
  that can execute it — ``main`` (reachable from the public API),
  one ``thread:<target>`` context per spawn entry (propagated through
  the resolvable call graph, across modules), and a synthetic
  ``shared:<Class>`` context for classes that declare themselves
  callable from any thread with a ``# bjx: thread-shared`` marker
  (the reservoir contract: "every buffer-touching operation runs
  under one lock");
- **locksets**: for every attribute access and call site, the set of
  locks held — directly-enclosing ``with self._lock:`` scopes plus
  the function's *entry lockset*, the intersection of locks held at
  every resolvable call site (so a ``_tick_locked`` helper called
  only under the lock is known to hold it), iterated to fixpoint;
- **per-class attribute-access maps**: every ``self.X`` read/write
  with its thread contexts and lockset — the input to the Eraser-style
  lockset-intersection race check — plus per-class/module lock and
  value-type tables (``threading.Event``/``queue.Queue``/``deque``
  values are thread-safe for method calls and drop out of the race
  analysis; rebinding the attribute itself still counts).

Everything here is static and conservative: type inference only
follows constructor assignments it can resolve through the import
table (``self.r = TrajectoryReservoir(...)``, module-level singletons
like ``metrics = Metrics()``), and unresolvable calls simply add no
edges. stdlib-only, like the rest of the analyzer.
"""

from __future__ import annotations

import ast
import dataclasses
from collections import defaultdict
from typing import Iterator

from blendjax_torch.analysis.core import (
    FunctionNode,
    ModuleContext,
    dotted_name,
)

SHARED_MARKER = "bjx: thread-shared"

MAIN_CONTEXT = "main"

#: Constructors whose instances guard other state (a ``with`` on one of
#: these attrs is a lock acquisition, and the attr itself is exempt
#: from the race analysis).
LOCK_TYPES = {
    "threading.Lock",
    "threading.RLock",
    "threading.Condition",
    "threading.Semaphore",
    "threading.BoundedSemaphore",
}

#: Constructors whose instances are safe to CALL from any thread
#: (their methods synchronize internally); rebinding an attribute that
#: holds one is still a write.
SAFE_TYPES = LOCK_TYPES | {
    "threading.Event",
    "threading.Thread",
    "threading.Timer",
    "queue.Queue",
    "queue.SimpleQueue",
    "queue.LifoQueue",
    "queue.PriorityQueue",
    "collections.deque",
}

#: Plain-container constructors: method calls from this set mutate the
#: container (``self.remote.pop(...)``) and count as writes.
CONTAINER_TYPES = {
    "dict",
    "list",
    "set",
    "collections.OrderedDict",
    "collections.defaultdict",
    "collections.Counter",
}

CONTAINER_MUTATORS = {
    "append",
    "appendleft",
    "extend",
    "extendleft",
    "insert",
    "add",
    "discard",
    "remove",
    "pop",
    "popitem",
    "popleft",
    "clear",
    "update",
    "setdefault",
    "sort",
    "reverse",
}

NodeId = tuple[str, str]  # (module relpath, function qualname)


@dataclasses.dataclass(frozen=True)
class Access:
    """One ``self.X`` access inside a method body."""

    attr: str
    write: bool
    node: ast.AST
    held: frozenset[str]  # with-held lock ids at the site (direct only)
    init: bool  # inside __init__/__post_init__ (pre-publication state)


@dataclasses.dataclass(frozen=True)
class WithSite:
    """A ``with <lock>:`` acquisition."""

    lock: str
    node: ast.AST
    held_before: frozenset[str]


@dataclasses.dataclass(frozen=True)
class CallSite:
    """A call with the locks held at the site and (when resolvable)
    the project-internal callee and receiver type."""

    node: ast.Call
    held: frozenset[str]
    target: NodeId | None
    recv_type: str | None  # resolved ctor/class dotted name of receiver
    recv_text: str  # dotted receiver text ("self._cmds"), for heuristics


@dataclasses.dataclass
class FuncInfo:
    node_id: NodeId
    fn: FunctionNode
    cls_qual: str | None  # owning class ("pkg.mod.Class") or None
    accesses: list[Access] = dataclasses.field(default_factory=list)
    with_sites: list[WithSite] = dataclasses.field(default_factory=list)
    calls: list[CallSite] = dataclasses.field(default_factory=list)
    spawn_targets: list[tuple[NodeId, ast.Call]] = dataclasses.field(
        default_factory=list
    )
    # local var -> resolved ctor dotted name, computed once in _extract
    # and reused by _resolve_calls (no second per-function walk)
    local_types: dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ClassInfo:
    qual: str  # "pkg.mod.Class"
    module: ModuleContext
    node: ast.ClassDef
    methods: dict[str, NodeId] = dataclasses.field(default_factory=dict)
    attr_types: dict[str, str] = dataclasses.field(default_factory=dict)
    lock_attrs: set[str] = dataclasses.field(default_factory=set)
    shared: bool = False  # carries the thread-shared marker


def _is_dunder(name: str) -> bool:
    return name.startswith("__") and name.endswith("__")


def _is_lock_name(name: str) -> bool:
    """Word-boundary lock-name test: an underscore-separated segment
    must BE ``lock``/``rlock``/``mutex`` — a bare substring match
    misread ``host_blocks`` as a lock and silently dropped it from the
    race analysis."""
    return any(
        seg in ("lock", "rlock", "mutex")
        for seg in name.lower().split("_")
    )


def _last(name: str) -> str:
    return name.rsplit(".", 1)[-1]


class ProjectContext:
    """All modules of one run, parsed once, with the spawn graph,
    context assignment, and lockset tables the project rules consume."""

    def __init__(self, modules: list[ModuleContext]) -> None:
        self.modules = list(modules)
        self.by_path: dict[str, ModuleContext] = {
            m.relpath: m for m in self.modules
        }
        # class + module-level tables -------------------------------------
        self.classes: dict[str, ClassInfo] = {}
        self._class_of_node: dict[ast.ClassDef, str] = {}
        self._class_name_index: dict[str, list[str]] = defaultdict(list)
        self.global_var_types: dict[str, str] = {}  # "pkg.mod.var" -> ctor
        self.module_locks: dict[str, str] = {}  # "pkg.mod.var" -> lock id
        self.functions: dict[NodeId, FuncInfo] = {}
        self._module_funcs: dict[str, NodeId] = {}  # "pkg.mod.f" -> node
        for module in self.modules:
            self._collect_classes(module)
        for module in self.modules:
            self._collect_globals(module)
        for module in self.modules:
            self._collect_class_tables(module)
        for module in self.modules:
            self._collect_functions(module)
        self._resolve_calls()
        # derived graphs ---------------------------------------------------
        self.callers: dict[NodeId, list[tuple[NodeId, frozenset[str]]]] = (
            defaultdict(list)
        )
        self.callees: dict[NodeId, set[NodeId]] = defaultdict(set)
        for nid, info in self.functions.items():
            for call in info.calls:
                if call.target is not None and call.target in self.functions:
                    self.callers[call.target].append((nid, call.held))
                    self.callees[nid].add(call.target)
        self._add_nested_edges()
        self.spawns: list[tuple[NodeId, NodeId, ast.Call]] = []  # (site, entry)
        for nid, info in self.functions.items():
            for entry, node in info.spawn_targets:
                if entry in self.functions:
                    self.spawns.append((nid, entry, node))
        self.contexts: dict[NodeId, set[str]] = defaultdict(set)
        self._assign_contexts()
        self.entry_locks: dict[NodeId, frozenset[str]] = {}
        self._compute_entry_locks()
        self.acquires: dict[NodeId, frozenset[str]] = {}
        self._compute_acquires()

    # -- collection ---------------------------------------------------------

    def _collect_classes(self, module: ModuleContext) -> None:
        def walk(node: ast.AST, prefix: str) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    qual = f"{module.modname}.{prefix}{child.name}"
                    info = ClassInfo(qual=qual, module=module, node=child)
                    info.shared = self._has_shared_marker(module, child)
                    self.classes[qual] = info
                    self._class_of_node[child] = qual
                    self._class_name_index[child.name].append(qual)
                    walk(child, f"{prefix}{child.name}.")
                elif not isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    walk(child, prefix)

        walk(module.tree, "")

    @staticmethod
    def _has_shared_marker(module: ModuleContext, cls: ast.ClassDef) -> bool:
        """``# bjx: thread-shared`` on the class-def line, or anywhere
        in the contiguous comment/decorator block directly above it."""
        if SHARED_MARKER in module.line_text(cls.lineno):
            return True
        first = cls.decorator_list[0].lineno if cls.decorator_list else cls.lineno
        line = first - 1
        while line >= 1:
            text = module.line_text(line)
            if not text.startswith("#"):
                break
            if SHARED_MARKER in text:
                return True
            line -= 1
        return False

    def _ctor_name(self, module: ModuleContext, value: ast.AST) -> str | None:
        """Resolved dotted constructor/value name for a type table:
        ``Ctor(...)`` calls, literals (containers), and bare names
        (singleton propagation through the global-var table)."""
        if isinstance(value, (ast.Dict, ast.DictComp)):
            return "dict"
        if isinstance(value, (ast.List, ast.ListComp)):
            return "list"
        if isinstance(value, (ast.Set, ast.SetComp)):
            return "set"
        if isinstance(value, ast.Call):
            return module.resolve(value.func)
        resolved = module.resolve(value)
        if resolved is not None and resolved in self.global_var_types:
            return self.global_var_types[resolved]
        return None

    def _collect_globals(self, module: ModuleContext) -> None:
        for stmt in module.tree.body:
            target: ast.expr | None = None
            value: ast.expr | None = None
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                target, value = stmt.targets[0], stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                target, value = stmt.target, stmt.value
            if not isinstance(target, ast.Name) or value is None:
                continue
            ctor = self._ctor_name(module, value)
            if ctor is None:
                continue
            var = f"{module.modname}.{target.id}"
            self.global_var_types[var] = ctor
            if ctor in LOCK_TYPES or _is_lock_name(target.id):
                self.module_locks[var] = var

    def _collect_class_tables(self, module: ModuleContext) -> None:
        for qual, fn, cls in module.iter_functions():
            if cls is None or cls not in self._class_of_node:
                continue
            info = self.classes[self._class_of_node[cls]]
            # direct methods only: the parent of the def is the class
            if module.parents.get(fn) is cls:
                info.methods[fn.name] = (module.relpath, qual)
            for node in ast.walk(fn):
                target2: ast.expr | None = None
                value2: ast.expr | None = None
                if isinstance(node, ast.Assign) and len(node.targets) == 1:
                    target2, value2 = node.targets[0], node.value
                elif isinstance(node, ast.AnnAssign) and node.value is not None:
                    target2, value2 = node.target, node.value
                if (
                    not isinstance(target2, ast.Attribute)
                    or not isinstance(target2.value, ast.Name)
                    or target2.value.id != "self"
                    or value2 is None
                ):
                    continue
                ctor = self._ctor_name(module, value2)
                attr = target2.attr
                if ctor is not None and attr not in info.attr_types:
                    info.attr_types[attr] = ctor
                if (ctor in LOCK_TYPES) or (
                    _is_lock_name(attr) and ctor is None
                ):
                    info.lock_attrs.add(attr)

    def class_for(self, dotted: str | None) -> str | None:
        """Class qual for a resolved constructor name: exact match on
        ``pkg.mod.Class``, else a UNIQUE bare-name suffix match."""
        if dotted is None:
            return None
        if dotted in self.classes:
            return dotted
        quals = self._class_name_index.get(_last(dotted), [])
        return quals[0] if len(quals) == 1 else None

    # -- per-function extraction --------------------------------------------

    def _collect_functions(self, module: ModuleContext) -> None:
        for qual, fn, cls in module.iter_functions():
            nid = (module.relpath, qual)
            cls_qual = (
                self._class_of_node.get(cls) if cls is not None else None
            )
            info = FuncInfo(node_id=nid, fn=fn, cls_qual=cls_qual)
            self.functions[nid] = info
            if cls_qual is None and "." not in qual:
                self._module_funcs[f"{module.modname}.{qual}"] = nid
            self._extract(module, info)

    def _local_types(
        self, module: ModuleContext, fn: FunctionNode
    ) -> dict[str, str]:
        out: dict[str, str] = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                t = node.targets[0]
                if isinstance(t, ast.Name):
                    ctor = self._ctor_name(module, node.value)
                    if ctor is not None and t.id not in out:
                        out[t.id] = ctor
        return out

    def _infer_type(
        self,
        expr: ast.AST,
        module: ModuleContext,
        cls: ClassInfo | None,
        local_types: dict[str, str],
    ) -> str | None:
        """Resolved ctor/class dotted name of an expression's value."""
        if isinstance(expr, ast.Name):
            if expr.id == "self" and cls is not None:
                return cls.qual
            if expr.id in local_types:
                return local_types[expr.id]
            resolved = module.resolve(expr)
            if resolved is not None:
                if resolved in self.global_var_types:
                    return self.global_var_types[resolved]
                if self.class_for(resolved) is not None:
                    return resolved
            return None
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and cls is not None
        ):
            return cls.attr_types.get(expr.attr)
        if isinstance(expr, ast.Attribute):
            resolved = module.resolve(expr)
            if resolved is not None and resolved in self.global_var_types:
                return self.global_var_types[resolved]
            return None
        return None

    def _lock_id(
        self,
        expr: ast.AST,
        module: ModuleContext,
        cls: ClassInfo | None,
        local_types: dict[str, str],
    ) -> str | None:
        """Stable lock identity for a ``with`` item, or None when the
        item is not a recognizable lock."""
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and cls is not None
        ):
            if expr.attr in cls.lock_attrs:
                return f"{cls.qual}.{expr.attr}"
            return None
        if isinstance(expr, ast.Attribute) and _is_lock_name(expr.attr):
            owner = self._infer_type(expr.value, module, cls, local_types)
            owner_cls = self.class_for(owner)
            if owner_cls is not None:
                return f"{owner_cls}.{expr.attr}"
            # Unresolvable owner (e.g. ``self.reservoir`` assigned from
            # a constructor parameter): fall back to a TEXTUAL identity
            # scoped to the acquiring class — ``with self.reservoir.
            # lock:`` sites inside one class still intersect with each
            # other (the ActorPool discipline), they just don't unify
            # with the owner class's own ``self.lock`` sites.
            text = dotted_name(expr.value)
            if text is not None:
                scope = cls.qual if cls is not None else module.modname
                return f"{scope}.<{text}>.{expr.attr}"
            return None
        if isinstance(expr, ast.Name):
            resolved = module.resolve(expr)
            if resolved is not None and resolved in self.module_locks:
                return self.module_locks[resolved]
            if _is_lock_name(expr.id):
                return f"{module.modname}.{expr.id}"
            return None
        return None

    def _spawn_entry(
        self,
        callee: ast.expr,
        module: ModuleContext,
        cls: ClassInfo | None,
        local_types: dict[str, str],
    ) -> NodeId | None:
        """Resolve a Thread target / submit callable to a function."""
        dotted = dotted_name(callee)
        if dotted is None:
            return None
        if dotted.startswith("self.") and cls is not None:
            return cls.methods.get(dotted[5:])
        if "." not in dotted:
            nid = self._module_funcs.get(f"{module.modname}.{dotted}")
            if nid is not None:
                return nid
            resolved = module.resolve(callee)
            if resolved is not None:
                return self._module_funcs.get(resolved)
            return None
        if isinstance(callee, ast.Attribute):
            owner = self._infer_type(callee.value, module, cls, local_types)
            owner_cls = self.class_for(owner)
            if owner_cls is not None:
                return self.classes[owner_cls].methods.get(callee.attr)
        resolved = module.resolve(callee)
        if resolved is not None:
            return self._module_funcs.get(resolved)
        return None

    def _extract(self, module: ModuleContext, info: FuncInfo) -> None:
        cls = self.classes.get(info.cls_qual) if info.cls_qual else None
        info.local_types = self._local_types(module, info.fn)
        local_types = info.local_types
        in_init = info.fn.name in ("__init__", "__post_init__", "__new__")

        def attr_kind(node: ast.Attribute) -> tuple[bool, bool]:
            """(is_access, is_write) for a ``self.X`` attribute node."""
            a_type = cls.attr_types.get(node.attr) if cls else None
            if isinstance(node.ctx, (ast.Store, ast.Del)):
                return True, True
            parent = module.parents.get(node)
            if isinstance(parent, ast.Subscript) and parent.value is node:
                if isinstance(parent.ctx, (ast.Store, ast.Del)):
                    return True, True
            if a_type in SAFE_TYPES:
                return False, False  # thread-safe value; calls don't race
            if (
                isinstance(parent, ast.Attribute)
                and parent.value is node
                and isinstance(module.parents.get(parent), ast.Call)
                and module.parents[parent].func is parent  # type: ignore[attr-defined]
            ):
                mutates = (
                    a_type in CONTAINER_TYPES
                    and parent.attr in CONTAINER_MUTATORS
                )
                return True, mutates
            return True, False

        def visit(node: ast.AST, held: frozenset[str]) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return  # nested defs are their own FuncInfo nodes
            if isinstance(node, (ast.With, ast.AsyncWith)):
                inner = held
                for item in node.items:
                    for sub in ast.walk(item.context_expr):
                        if isinstance(sub, ast.Call):
                            _record_call(sub, inner)
                        elif isinstance(sub, ast.Attribute):
                            _record_attr(sub, inner)
                    lock = self._lock_id(
                        item.context_expr, module, cls, local_types
                    )
                    if lock is not None:
                        info.with_sites.append(
                            WithSite(
                                lock=lock,
                                node=item.context_expr,
                                held_before=inner,
                            )
                        )
                        inner = inner | {lock}
                for stmt in node.body:
                    visit(stmt, inner)
                return
            if isinstance(node, ast.Call):
                _record_call(node, held)
            elif isinstance(node, ast.Attribute):
                _record_attr(node, held)
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        recorded_attrs: set[int] = set()
        recorded_calls: set[int] = set()

        def _record_attr(node: ast.Attribute, held: frozenset[str]) -> None:
            if id(node) in recorded_attrs:
                return
            recorded_attrs.add(id(node))
            if not (
                isinstance(node.value, ast.Name) and node.value.id == "self"
            ):
                return
            if cls is None or node.attr in cls.lock_attrs:
                return
            is_access, is_write = attr_kind(node)
            if is_access:
                info.accesses.append(
                    Access(
                        attr=node.attr,
                        write=is_write,
                        node=node,
                        held=held,
                        init=in_init,
                    )
                )

        def _record_call(node: ast.Call, held: frozenset[str]) -> None:
            if id(node) in recorded_calls:
                return
            recorded_calls.add(id(node))
            # spawn sites: Thread/Timer target, executor submit
            resolved = module.resolve(node.func)
            tail = _last(resolved) if resolved else ""
            if tail in ("Thread", "Timer"):
                target_node: ast.expr | None = next(
                    (
                        kw.value
                        for kw in node.keywords
                        if kw.arg in ("target", "function")
                    ),
                    None,
                )
                if target_node is None and len(node.args) >= 2:
                    # positional: Thread(group, target) / Timer(interval, function)
                    target_node = node.args[1]
                if target_node is not None:
                    entry = self._spawn_entry(
                        target_node, module, cls, local_types
                    )
                    if entry is not None:
                        info.spawn_targets.append((entry, node))
            elif (
                isinstance(node.func, ast.Attribute)
                and node.func.attr == "submit"
                and node.args
            ):
                entry = self._spawn_entry(
                    node.args[0], module, cls, local_types
                )
                if entry is not None:
                    info.spawn_targets.append((entry, node))
            # call site (target resolved in a second pass, once all
            # functions are collected)
            recv_type: str | None = None
            recv_text = ""
            if isinstance(node.func, ast.Attribute):
                recv_text = dotted_name(node.func.value) or ""
                recv_type = self._infer_type(
                    node.func.value, module, cls, local_types
                )
            info.calls.append(
                CallSite(
                    node=node,
                    held=held,
                    target=None,
                    recv_type=recv_type,
                    recv_text=recv_text,
                )
            )

        for stmt in info.fn.body:
            visit(stmt, frozenset())

    def _resolve_calls(self) -> None:
        """Second pass: resolve call targets now that every function
        (and class-attribute type) is known."""
        for nid, info in self.functions.items():
            module = self.by_path[nid[0]]
            cls = self.classes.get(info.cls_qual) if info.cls_qual else None
            local_types = info.local_types
            resolved_calls: list[CallSite] = []
            for call in info.calls:
                target: NodeId | None = None
                func = call.node.func
                if isinstance(func, ast.Attribute):
                    if (
                        isinstance(func.value, ast.Name)
                        and func.value.id == "self"
                        and cls is not None
                    ):
                        target = cls.methods.get(func.attr)
                    else:
                        owner = self._infer_type(
                            func.value, module, cls, local_types
                        )
                        owner_cls = self.class_for(owner)
                        if owner_cls is not None:
                            target = self.classes[owner_cls].methods.get(
                                func.attr
                            )
                elif isinstance(func, ast.Name):
                    target = self._module_funcs.get(
                        f"{module.modname}.{func.id}"
                    )
                    if target is None:
                        resolved = module.resolve(func)
                        if resolved is not None:
                            target = self._module_funcs.get(resolved)
                resolved_calls.append(
                    dataclasses.replace(call, target=target)
                )
            info.calls = resolved_calls

    def _add_nested_edges(self) -> None:
        """A nested def runs in (at most) its parent's thread contexts
        and at least its parent's entry lockset — add a parent->nested
        call edge so contexts and locksets propagate."""
        for nid, info in self.functions.items():
            qual = nid[1]
            if "." not in qual:
                continue
            parent_qual = qual.rsplit(".", 1)[0]
            parent = (nid[0], parent_qual)
            if parent in self.functions:
                self.callers[nid].append((parent, frozenset()))
                self.callees[parent].add(nid)

    # -- contexts ------------------------------------------------------------

    def _reachable(self, seeds: list[NodeId]) -> set[NodeId]:
        seen: set[NodeId] = set()
        frontier = [s for s in seeds if s in self.functions]
        while frontier:
            n = frontier.pop()
            if n in seen:
                continue
            seen.add(n)
            frontier.extend(self.callees.get(n, ()))
        return seen

    def _externally_callable(self, nid: NodeId, info: FuncInfo) -> bool:
        """True for the entry points an outside caller can actually
        reach: top-level module functions, DIRECT public/dunder class
        methods, and orphan privates (callbacks). Nested defs are never
        seeds — a closure with a public-looking name runs only in its
        parent's contexts (the parent edge propagates them)."""
        name = _last(nid[1])
        if info.cls_qual is None:
            return "." not in nid[1] or not self.callers.get(nid)
        cls = self.classes.get(info.cls_qual)
        is_direct = cls is not None and cls.methods.get(name) == nid
        if is_direct and (not name.startswith("_") or _is_dunder(name)):
            return True
        return not self.callers.get(nid)

    def _assign_contexts(self) -> None:
        spawn_entries = {entry for _, entry, _ in self.spawns}
        # main: externally-callable entry points that are not spawn
        # targets — then closure over the call graph.
        main_seeds: list[NodeId] = []
        for nid, info in self.functions.items():
            if nid in spawn_entries:
                continue
            if self._externally_callable(nid, info):
                main_seeds.append(nid)
        for nid in self._reachable(main_seeds):
            self.contexts[nid].add(MAIN_CONTEXT)
        # one context per spawn entry, propagated through the graph
        for _site, entry, _node in self.spawns:
            module = self.by_path[entry[0]]
            label = f"thread:{module.modname}.{entry[1]}"
            for nid in self._reachable([entry]):
                self.contexts[nid].add(label)
        # declared thread-shared classes: any thread may enter the
        # public API — a synthetic second context over it.
        for cls in self.classes.values():
            if not cls.shared:
                continue
            label = f"shared:{cls.qual}"
            seeds = [
                nid
                for name, nid in cls.methods.items()
                if not name.startswith("_") or _is_dunder(name)
            ]
            for nid in self._reachable(seeds):
                self.contexts[nid].add(label)

    # -- locksets ------------------------------------------------------------

    def _compute_entry_locks(self) -> None:
        """Entry lockset per function: the intersection over every
        resolvable call site of (caller's entry lockset | locks held at
        the site). Externally-callable functions (main seeds, spawn
        entries) are pinned to the empty set — an external caller holds
        nothing. Iterated to fixpoint (the graph has cycles)."""
        spawn_entries = {entry for _, entry, _ in self.spawns}
        pinned: set[NodeId] = set(spawn_entries)
        for nid, info in self.functions.items():
            if self._externally_callable(nid, info):
                pinned.add(nid)
        entry: dict[NodeId, frozenset[str] | None] = {
            nid: (frozenset() if nid in pinned else None)
            for nid in self.functions
        }
        for _ in range(len(self.functions) + 1):
            changed = False
            for nid in self.functions:
                if nid in pinned:
                    continue
                acc: frozenset[str] | None = None
                for caller, held in self.callers.get(nid, ()):
                    ce = entry.get(caller)
                    if ce is None:
                        continue
                    site = ce | held
                    acc = site if acc is None else (acc & site)
                if acc is not None and acc != entry[nid]:
                    entry[nid] = acc
                    changed = True
            if not changed:
                break
        self.entry_locks = {
            nid: (ls if ls is not None else frozenset())
            for nid, ls in entry.items()
        }

    def _compute_acquires(self) -> None:
        """Locks a function may acquire, directly or transitively."""
        acq: dict[NodeId, set[str]] = {
            nid: {w.lock for w in info.with_sites}
            for nid, info in self.functions.items()
        }
        for _ in range(len(self.functions) + 1):
            changed = False
            for nid in self.functions:
                for callee in self.callees.get(nid, ()):
                    extra = acq[callee] - acq[nid]
                    if extra:
                        acq[nid] |= extra
                        changed = True
            if not changed:
                break
        self.acquires = {nid: frozenset(s) for nid, s in acq.items()}

    # -- views for the rules --------------------------------------------------

    def held_at(self, nid: NodeId, site_held: frozenset[str]) -> frozenset[str]:
        """Full lockset at a site: direct ``with`` scopes plus the
        function's entry lockset."""
        return site_held | self.entry_locks.get(nid, frozenset())

    def class_methods(self, cls: ClassInfo) -> Iterator[tuple[NodeId, FuncInfo]]:
        """Every function belonging to a class — its methods AND their
        nested defs (a closure mutating ``self`` races like its owner)."""
        for nid, info in self.functions.items():
            if info.cls_qual == cls.qual:
                yield nid, info

    def attr_map(
        self, cls: ClassInfo
    ) -> dict[str, list[tuple[NodeId, Access]]]:
        """Per-class attribute-access map: attr -> every (function,
        access) over the whole class body."""
        out: dict[str, list[tuple[NodeId, Access]]] = defaultdict(list)
        for nid, info in self.class_methods(cls):
            for acc in info.accesses:
                out[acc.attr].append((nid, acc))
        return out


# ---------------------------------------------------------------------------
# Stamp-key vocabulary, shared with the contract-drift gate
# (``blendjax_torch/analysis/contracts.py``).

#: Literal sidecar keys every batch dict of the port may carry; the
#: per-run universe extends this with ``*_KEY`` string constants.
SIDECAR_LITERAL_KEYS = frozenset({
    "_shm",
    "_shm_torn",
    "_trace",
    "_traces",
    "_scenario",
    "_scenario_rows",
    "_meta",
    "_seq",
    "_pub_wall",
    "_pub_mono",
    "_telemetry",
})

#: Underscored batch keys that are arrays/control flags and cross the
#: step boundary by design — never sidecar taint even when a ``*_KEY``
#: constant holds them.
NON_SIDECAR_KEYS = frozenset({"_mask", "_partial", "_batched", "_prebatched"})
