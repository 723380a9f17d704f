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
import re
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
        self._dataflow: "Dataflow | None" = None

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

    def dataflow(self) -> "Dataflow":
        """The value-provenance layer (BJX120/121/122), built lazily so
        runs that select only the concurrency rules don't pay for it."""
        if self._dataflow is None:
            self._dataflow = Dataflow(self)
        return self._dataflow


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

# ---------------------------------------------------------------------------
# Value-provenance dataflow layer (BJX120/121/122)
#
# A second, per-function pass over the same shared parse that tracks
# three value properties the captured-step rules need. A "captured
# callable" is the port's counterpart of a ``jax.jit`` wrapping: a name,
# module global or ``self`` attribute bound to ``CapturedStep(fn)``,
# ``build_aot_step(fn, ...)`` or ``torch.cuda.make_graphed_callables(...)``
# (``blendjax_torch/train/aot.py``).
#
# - **sidecar taint** (BJX120): which stamp keys (``_traces``, ``_seq``,
#   the lineage stamps, plus any module constant named ``*_KEY`` holding
#   an underscored string) a dict variable may still carry. Taint enters
#   at subscript stores and stamped dict literals, copies through
#   rebinding / ``dict(batch)`` / ``.copy()``, and leaves through
#   ``.pop``/``del``, filtered dict comprehensions, or a call to a helper
#   whose summary strips (the ``strip_stamps`` loop-over-a-key-tuple
#   shape included). Passing a tainted dict to a captured callable —
#   directly or through a call chain, via per-function summaries
#   iterated to fixpoint over the existing call graph — is the leak. A
#   ``CapturedStep``/``build_aot_step`` set leaves the keys of
#   ``aot._UNKEYED`` out of its graphs (:data:`CAPTURE_UNKEYED_KEYS`),
#   so those are no leak into one.
# - **alias liveness** (BJX121): every captured step call writes its
#   state argument, position 0, in place (a ``CapturedDispatch`` takes
#   only its batch and writes nothing the caller holds). A name bound BEFORE the call to a
#   view of that state (``.detach()``, ``.view``, ``state_dict()``,
#   ``parameters()``, a field or item of it) holds the NEW values after
#   the call and is overwritten again by every later replay; a read of
#   it after the call, before it is rebound, is the use. Re-passing the
#   state itself (``for b in batches: step(state, b)``) is how a captured
#   step is driven and is never a use.
# - **plan-signature derivation** (BJX122): ``CapturedStep`` and
#   ``CapturedDispatch`` key their graphs by ``aot._plan_signature`` — each tensor's shape and dtype,
#   each host plan entry BY VALUE, and the key set. A host plan entry
#   (a host scalar, string or tuple stored in the batch dict) or a key
#   set extended under a per-message-derived key that reaches a captured
#   call without passing through the bucket/decode-plan ladder captures
#   a new graph, with a private memory pool, per distinct value.
#
# Everything is linear in statement order per function (branches are
# walked sequentially — a conditional strip counts, which keeps the
# analysis optimistic/low-noise like the lockset pass above), and the
# interprocedural part rides the compact per-function op lists, not
# the ASTs, so the fixpoint stays cheap.

#: Functions whose return value is a freshly decoded wire message — the
#: canonical taint source: a decoded dict can carry ANY sidecar key the
#: producer stamped (matched on the last dotted segment of the resolved
#: callee name). The port's decoders in ``transport/wire.py``.
WIRE_DECODE_FUNCS = frozenset({"decode_message"})

#: Callables whose result is a captured callable (matched on the last
#: dotted segment of the resolved name).
CAPTURE_CALLS = frozenset({"CapturedStep", "build_aot_step",
                           "make_graphed_callables", "CapturedDispatch"})

#: Of those, the ones that key their graphs by ``aot._plan_signature``
#: and leave :data:`CAPTURE_UNKEYED_KEYS` out of them.
PLAN_KEYED_CALLS = frozenset({"CapturedStep", "build_aot_step",
                              "CapturedDispatch"})

#: Of those, the ones that capture a dispatch outside a step (the
#: counterpart of a ``jax.jit`` of a pure function): every argument is the
#: batch, and none is a state written in place.
DISPATCH_CALLS = frozenset({"CapturedDispatch"})

#: ``blendjax_torch/train/aot.py:_UNKEYED``: the host sidecars a
#: ``CapturedStep`` passes through without keying or copying them
#: (``tests/test_torch_analysis.py`` holds the two equal).
CAPTURE_UNKEYED_KEYS = frozenset({"_meta", "_echo_counter", "_by_reference",
                                  "_scenario", "_scenario_rows"})

#: Shape of a stamp-key VALUE: single leading underscore, lowercase.
#: (``__nd__``/``__bigint__`` checkpoint markers don't match.)
_STAMP_VALUE_RE = re.compile(r"^_[a-z][a-z0-9_]*$")

#: Parameters presumed to carry per-message/per-batch data (BJX122
#: derivation seeds).
_BATCHISH_PARAM_RE = re.compile(
    r"^(?:batch(?:es)?|msgs?|messages?|items?|frames?|samples?|rows?|"
    r"payload|events?)$"
)

#: A call through one of these name segments launders per-message data
#: into a bounded set (the ``pad_to_bucket``/decode-plan ladder).
_LAUNDER_RE = re.compile(r"(?:^|_)(?:bucket|plan|pad|cap|quant)", re.IGNORECASE)

#: Calls whose result is a host value, keyed by value in a plan
#: signature (a tensor is keyed by its shape and dtype only).
_HOST_VALUE_CALLS = frozenset({"int", "float", "bool", "str", "len", "tuple",
                               "round", "item", "tolist"})

#: Methods that return a view or alias of their receiver's storage
#: (BJX121); any other call ends the alias (``.clone()``, ``.cpu()``,
#: ``copy.deepcopy``, ``{k: v.clone() ...}``).
_ALIAS_METHODS = frozenset({
    "detach", "view", "view_as", "reshape", "flatten", "squeeze",
    "unsqueeze", "expand", "t", "transpose", "permute", "narrow", "select",
    "unbind", "split", "chunk", "state_dict", "parameters",
    "named_parameters", "buffers", "named_buffers", "values", "items",
    "get", "__getitem__",
})

#: Containers that hold the aliases they are built from.
_ALIAS_CONTAINERS = frozenset({"list", "tuple", "dict"})


def _is_capture_name(resolved: str | None) -> bool:
    return bool(resolved) and _last(resolved) in CAPTURE_CALLS


@dataclasses.dataclass(frozen=True)
class JitInfo:
    """What a captured callable declares. A captured step writes its
    state, position 0, in place (``writes_state``); a captured dispatch
    (``CapturedDispatch``) takes only its batch. A ``CapturedStep``,
    ``build_aot_step`` set or ``CapturedDispatch`` keys its graphs by the
    batch's plan signature (``plan_keyed``) and leaves ``unkeyed`` out of
    it."""

    desc: str  # display name for messages ("CapturedStep(step)")
    plan_keyed: bool = True
    unkeyed: frozenset[str] = CAPTURE_UNKEYED_KEYS
    writes_state: bool = True


@dataclasses.dataclass(frozen=True)
class DonateUse:
    """BJX121 event: ``var``, an alias of ``state`` taken before the
    captured call ``donate_node``, is read again at ``node``."""

    node: ast.AST
    var: str
    state: str
    donate_node: ast.Call
    jit_desc: str


@dataclasses.dataclass(frozen=True)
class RetraceEvent:
    """BJX122 event at a captured call site: ``arg_desc`` names the host
    plan entry (or the dynamic-key dict) deriving from per-message
    data."""

    node: ast.AST
    arg_desc: str
    jit_desc: str
    keyset: bool  # True: dynamic dict key-set variant


@dataclasses.dataclass(frozen=True)
class LeakEvent:
    """BJX120 event: a dict carrying ``keys`` reached a captured call —
    directly (``via is None``) or by being passed to project function
    ``via`` whose summary forwards it into a captured call."""

    node: ast.AST
    keys: frozenset[str]
    params: frozenset[int]
    jit_desc: str
    via: str | None


@dataclasses.dataclass
class FlowIR:
    """Compact flow-relevant ops of one function, in statement order,
    plus the extraction-time BJX121/122 events."""

    params: tuple[str, ...]  # positional + kwonly names, self/cls dropped
    ops: list[list] = dataclasses.field(default_factory=list)
    donate_uses: list[DonateUse] = dataclasses.field(default_factory=list)
    retraces: list[RetraceEvent] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class FlowSummary:
    """What a caller needs to know about a function's effect on the
    sidecar taint of its arguments and return value."""

    leak_params: dict[int, set[str]] = dataclasses.field(default_factory=dict)
    strip_params: dict[int, set[str]] = dataclasses.field(default_factory=dict)
    add_params: dict[int, set[str]] = dataclasses.field(default_factory=dict)
    return_params: dict[int, set[str]] = dataclasses.field(default_factory=dict)
    return_keys: set[str] = dataclasses.field(default_factory=set)

    def snapshot(self) -> tuple:
        return (
            {k: frozenset(v) for k, v in self.leak_params.items()},
            {k: frozenset(v) for k, v in self.strip_params.items()},
            {k: frozenset(v) for k, v in self.add_params.items()},
            {k: frozenset(v) for k, v in self.return_params.items()},
            frozenset(self.return_keys),
        )


class _Taint:
    """Key-set taint of one dict value. Aliases share the object, so
    an in-place ``pop`` through one name strips every alias — exactly
    Python's reference semantics for dicts."""

    __slots__ = ("keys", "params")

    def __init__(self, keys=(), params=()) -> None:
        self.keys: set[str] = set(keys)
        self.params: set[int] = set(params)

    def fork(self) -> "_Taint":
        return _Taint(self.keys, self.params)


@dataclasses.dataclass
class SimResult:
    leaks: list[LeakEvent] = dataclasses.field(default_factory=list)
    return_keys: set[str] = dataclasses.field(default_factory=set)
    return_params: dict[int, set[str]] = dataclasses.field(default_factory=dict)
    param_final: dict[int, "_Taint"] = dataclasses.field(default_factory=dict)


class Dataflow:
    """The project-wide provenance tables + per-function flow results.

    Build order: string/tuple constants -> the sidecar-key universe ->
    the captured-callable registry (module-level, ``self.attr`` and
    local assignment forms; the port has no decorator form) -> one extraction walk per function (producing
    the op list and the BJX121/122 events) -> the summary fixpoint ->
    one final rule-mode simulation per function (``flow_results``)."""

    _MAX_ROUNDS = 12

    def __init__(self, project: ProjectContext) -> None:
        self.project = project
        self.str_consts: dict[str, str] = {}
        self.tuple_consts: dict[str, frozenset[str]] = {}
        raw_tuples: list[tuple[ModuleContext, str, ast.expr]] = []
        for module in project.modules:
            self._collect_consts(module, raw_tuples)
        self._resolve_tuples(raw_tuples)
        self.sidecar_keys = frozenset(SIDECAR_LITERAL_KEYS) | {
            v
            for name, v in self.str_consts.items()
            if _last(name).endswith("_KEY")
            and _STAMP_VALUE_RE.match(v)
            and v not in NON_SIDECAR_KEYS
        }
        self.jit_globals: dict[str, JitInfo] = {}
        self.jit_attrs: dict[tuple[str, str], JitInfo] = {}
        for module in project.modules:
            self._collect_jits(module)
        self.ir: dict[NodeId, FlowIR] = {}
        for nid in project.functions:
            self.ir[nid] = self._extract_ir(nid)
        self.summaries: dict[NodeId, FlowSummary] = {
            nid: FlowSummary() for nid in project.functions
        }
        self._fixpoint()
        self.flow_results: dict[NodeId, SimResult] = {
            nid: self._simulate(nid, seeded=False) for nid in self.ir
        }

    # -- constants ----------------------------------------------------------

    def _collect_consts(
        self,
        module: ModuleContext,
        raw_tuples: list[tuple[ModuleContext, str, ast.expr]],
    ) -> None:
        for stmt in module.tree.body:
            target: ast.expr | None = None
            value: ast.expr | None = None
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                target, value = stmt.targets[0], stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                target, value = stmt.target, stmt.value
            if not isinstance(target, ast.Name) or value is None:
                continue
            if isinstance(value, ast.Constant) and isinstance(value.value, str):
                self.str_consts[f"{module.modname}.{target.id}"] = value.value
            elif isinstance(value, (ast.Tuple, ast.List, ast.Set)):
                raw_tuples.append((module, target.id, value))

    @staticmethod
    def _resolve_global(module: ModuleContext, node: ast.AST) -> str | None:
        """Fully-qualified name of a Name/Attribute: imports expand
        through the import table; a bare local name is a module-level
        binding of THIS module, so it gets the module prefix."""
        resolved = module.resolve(node)
        if resolved is None:
            return None
        if "." not in resolved:
            return f"{module.modname}.{resolved}"
        return resolved

    def _resolve_tuples(
        self, raw_tuples: list[tuple[ModuleContext, str, ast.expr]]
    ) -> None:
        """Tuple constants of strings, resolving Name elements through
        the import table + the global string table (the ``_STAMP_KEYS``
        shape: a tuple mixing literals and imported ``*_KEY`` names)."""
        for module, name, value in raw_tuples:
            keys: set[str] = set()
            for elt in value.elts:  # type: ignore[attr-defined]
                if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                    keys.add(elt.value)
                else:
                    resolved = self._resolve_global(module, elt)
                    if resolved in self.str_consts:
                        keys.add(self.str_consts[resolved])
            if keys:
                self.tuple_consts[f"{module.modname}.{name}"] = frozenset(keys)

    # -- captured-callable registry ------------------------------------------

    def _parse_jit_call(
        self, module: ModuleContext, node: ast.Call
    ) -> JitInfo | None:
        """``CapturedStep(fn)`` / ``build_aot_step(fn, ...)`` /
        ``make_graphed_callables(fn, ...)`` -> JitInfo, else None."""
        resolved = module.resolve(node.func)
        if not _is_capture_name(resolved):
            return None
        tname = ""
        if node.args:
            tname = dotted_name(node.args[0]) or ""
        kind = _last(resolved or "")
        if kind in PLAN_KEYED_CALLS:
            return JitInfo(desc=f"{kind}({tname or '…'})",
                           writes_state=kind not in DISPATCH_CALLS)
        return JitInfo(desc=f"{kind}({tname or '…'})", plan_keyed=False,
                       unkeyed=frozenset())

    def _collect_jits(self, module: ModuleContext) -> None:
        for stmt in module.tree.body:
            if (
                isinstance(stmt, ast.Assign)
                and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
                and isinstance(stmt.value, ast.Call)
            ):
                info = self._parse_jit_call(module, stmt.value)
                if info is not None:
                    var = f"{module.modname}.{stmt.targets[0].id}"
                    self.jit_globals[var] = info
        for qual, fn, _cls in module.iter_functions():
            nid = (module.relpath, qual)
            # self.<attr> = CapturedStep(...) anywhere in a method body
            finfo = self.project.functions.get(nid)
            if finfo is None or finfo.cls_qual is None:
                continue
            for node in ast.walk(fn):
                if (
                    isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Attribute)
                    and isinstance(node.targets[0].value, ast.Name)
                    and node.targets[0].value.id == "self"
                    and isinstance(node.value, ast.Call)
                ):
                    info = self._parse_jit_call(module, node.value)
                    if info is not None:
                        key = (finfo.cls_qual, node.targets[0].attr)
                        self.jit_attrs.setdefault(key, info)

    def _jit_at_call(
        self,
        module: ModuleContext,
        cls: ClassInfo | None,
        call: ast.Call,
        local_jits: dict[str, JitInfo],
        local_types: dict[str, str],
    ) -> JitInfo | None:
        """JitInfo when the called value is a known captured callable."""
        func = call.func
        if isinstance(func, ast.Name):
            if func.id in local_jits:
                return local_jits[func.id]
            resolved = module.resolve(func)
            if resolved is not None and resolved in self.jit_globals:
                return self.jit_globals[resolved]
            return self.jit_globals.get(f"{module.modname}.{func.id}")
        if isinstance(func, ast.Attribute):
            if (
                isinstance(func.value, ast.Name)
                and func.value.id == "self"
                and cls is not None
            ):
                return self.jit_attrs.get((cls.qual, func.attr))
            resolved = module.resolve(func)
            if resolved is not None and resolved in self.jit_globals:
                return self.jit_globals[resolved]
            owner = self.project._infer_type(
                func.value, module, cls, local_types
            )
            owner_cls = self.project.class_for(owner)
            if owner_cls is not None:
                return self.jit_attrs.get((owner_cls, func.attr))
        return None

    # -- key helpers ---------------------------------------------------------

    def _key_value(self, module: ModuleContext, node: ast.AST) -> str | None:
        """Resolved string value of a dict-key expression: a literal
        or a Name/Attribute reaching a module-level string constant."""
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        resolved = self._resolve_global(module, node)
        if resolved is not None:
            return self.str_consts.get(resolved)
        return None

    def _key_set(
        self,
        module: ModuleContext,
        node: ast.AST,
        loop_keys: dict[str, frozenset[str]],
    ) -> frozenset[str] | None:
        """Sidecar keys a pop/del key expression can denote (a loop
        variable ranging over a key-tuple constant denotes them all)."""
        if isinstance(node, ast.Name) and node.id in loop_keys:
            return loop_keys[node.id] & self.sidecar_keys
        value = self._key_value(module, node)
        if value is not None and value in self.sidecar_keys:
            return frozenset({value})
        return None

    # -- extraction ----------------------------------------------------------

    def _extract_ir(self, nid: NodeId) -> FlowIR:
        project = self.project
        info = project.functions[nid]
        module = project.by_path[nid[0]]
        cls = project.classes.get(info.cls_qual) if info.cls_qual else None
        fn = info.fn
        args = fn.args
        pos = [a.arg for a in (*args.posonlyargs, *args.args)]
        if cls is not None and pos and pos[0] in ("self", "cls"):
            pos = pos[1:]
        ir = FlowIR(params=tuple(pos + [a.arg for a in args.kwonlyargs]))
        call_targets = {id(cs.node): cs.target for cs in info.calls}

        local_jits: dict[str, JitInfo] = {}
        loop_keys: dict[str, frozenset[str]] = {}
        donated: dict[str, ast.Call] = {}
        donated_desc: dict[str, tuple[str, str]] = {}
        flagged_donations: set[tuple[int, str]] = set()
        derived: set[str] = {p for p in ir.params if _BATCHISH_PARAM_RE.match(p)}
        dynamic_dicts: dict[str, ast.AST] = {}
        # BJX121: alias name -> the dotted names it views (its base and
        # the base's prefixes, ``self`` left out)
        aliases: dict[str, frozenset[str]] = {}
        # BJX122: dict name -> its first per-message host plan entry
        plan_entries: dict[str, str] = {}

        def donate_use(name: str, node: ast.AST) -> None:
            call = donated.get(name)
            if call is None or (id(call), name) in flagged_donations:
                return
            flagged_donations.add((id(call), name))
            state, desc = donated_desc[name]
            ir.donate_uses.append(
                DonateUse(
                    node=node,
                    var=name,
                    state=state,
                    donate_node=call,
                    jit_desc=desc,
                )
            )

        def store(name: str) -> None:
            donated.pop(name, None)
            aliases.pop(name, None)

        def prefixes(d: str) -> frozenset[str]:
            parts = d.split(".")
            out = {".".join(parts[:i]) for i in range(1, len(parts) + 1)}
            for p in list(out):
                out |= aliases.get(p, frozenset())
            return frozenset(out - {"self", "cls"})

        def view_base(e: ast.AST) -> str | None:
            """The dotted name ``e`` is a view or alias of, else None (a
            comprehension of views of its loop variable, over a view of
            ``x``, views ``x``)."""
            if isinstance(e, (ast.ListComp, ast.DictComp, ast.GeneratorExp,
                              ast.SetComp)) and len(e.generators) == 1:
                gen = e.generators[0]
                elt = e.value if isinstance(e, ast.DictComp) else e.elt
                bound = {n.id for n in ast.walk(gen.target)
                         if isinstance(n, ast.Name)}
                inner = view_base(elt)
                if inner is not None and inner.split(".")[0] in bound:
                    return view_base(gen.iter)
                return None
            while True:
                if isinstance(e, ast.Call):
                    f = e.func
                    if isinstance(f, ast.Attribute) and f.attr in _ALIAS_METHODS:
                        e = f.value
                    elif (
                        isinstance(f, ast.Name)
                        and f.id in _ALIAS_CONTAINERS
                        and len(e.args) == 1
                    ):
                        e = e.args[0]
                    else:
                        return None
                elif isinstance(e, ast.Subscript):
                    e = e.value
                elif isinstance(e, (ast.Name, ast.Attribute)):
                    return dotted_name(e)
                else:
                    return None

        def is_derived_expr(e: ast.AST) -> bool:
            if isinstance(e, ast.Call):
                fname = dotted_name(e.func)
                if fname and _LAUNDER_RE.search(_last(fname)):
                    return False
            return any(
                isinstance(n, ast.Name)
                and isinstance(n.ctx, ast.Load)
                and n.id in derived
                for n in ast.walk(e)
            )

        def is_host_value(e: ast.AST) -> bool:
            if isinstance(e, ast.Call):
                return _last(dotted_name(e.func) or "") in _HOST_VALUE_CALLS
            if isinstance(e, ast.Subscript):
                e = e.value
            return isinstance(e, ast.Attribute) and e.attr == "shape"

        def plan_entry(key: ast.AST | None, value: ast.AST) -> str | None:
            """``key=value`` when the dict entry is a host plan entry
            deriving from per-message data (keyed by value)."""
            if key is None:
                return None
            kk = self._key_value(module, key)
            if kk is None or kk in CAPTURE_UNKEYED_KEYS:
                return None
            if is_host_value(value) and is_derived_expr(value):
                return f"{kk}={ast.unparse(value)}"
            return None

        def dict_entry(d: ast.Dict) -> str | None:
            return next(
                (e for k, v in zip(d.keys, d.values)
                 for e in [plan_entry(k, v)] if e), None)

        def handle_jit_call(call: ast.Call, jinfo: JitInfo) -> None:
            # BJX121: the views of the state argument taken before the
            # call go stale (applied as the call is scanned, after its
            # own argument loads)
            if call.args and jinfo.writes_state:
                s = dotted_name(call.args[0])
                if s is not None:
                    roots = {s} | aliases.get(s, frozenset())
                    for name, viewed in aliases.items():
                        if name != s and viewed & roots:
                            donated[name] = call
                            donated_desc[name] = (s, jinfo.desc)
            # BJX122: host plan entries deriving from per-message data
            if jinfo.plan_keyed:
                for a in call.args[1 if jinfo.writes_state else 0:]:
                    entry = None
                    if isinstance(a, ast.Dict):
                        entry = dict_entry(a)
                    elif isinstance(a, ast.Name):
                        entry = plan_entries.get(a.id)
                    if entry:
                        ir.retraces.append(
                            RetraceEvent(
                                node=call,
                                arg_desc=entry,
                                jit_desc=jinfo.desc,
                                keyset=False,
                            )
                        )
            # BJX122 key-set variant: a dict whose key set grew under a
            # per-message-derived key captures per distinct key set
            for a in [*call.args, *(kw.value for kw in call.keywords)]:
                if isinstance(a, ast.Name) and a.id in dynamic_dicts:
                    ir.retraces.append(
                        RetraceEvent(
                            node=call,
                            arg_desc=a.id,
                            jit_desc=jinfo.desc,
                            keyset=True,
                        )
                    )

        def scan_dictcomp(e: ast.DictComp):
            for gen in e.generators:
                scan_expr(gen.iter)
                for cond in gen.ifs:
                    scan_expr(cond)
            scan_expr(e.key)
            scan_expr(e.value)
            if len(e.generators) != 1:
                return None
            gen = e.generators[0]
            it = gen.iter
            src: str | None = None
            if (
                isinstance(it, ast.Call)
                and isinstance(it.func, ast.Attribute)
                and it.func.attr == "items"
                and isinstance(it.func.value, ast.Name)
            ):
                src = it.func.value.id
            elif isinstance(it, ast.Name):
                src = it.id
            if src is None:
                return None
            key_var: str | None = None
            if isinstance(gen.target, ast.Tuple) and gen.target.elts:
                first = gen.target.elts[0]
                if isinstance(first, ast.Name):
                    key_var = first.id
            elif isinstance(gen.target, ast.Name):
                key_var = gen.target.id
            removed: set[str] = set()
            for cond in gen.ifs:
                r = self._cond_removed(module, cond, key_var)
                if r is None:  # key-based filter we can't model: all gone
                    return ("filter", src, None)
                removed |= r
            return ("filter", src, frozenset(removed))

        def scan_call(call: ast.Call):
            func = call.func
            scan_expr(func)
            # Nested calls as arguments (``step(collate(batch))``) are
            # materialised through a synthetic local so the outer call
            # sees the inner call's RESULT taint, not an opaque hole.
            nested: dict[int, tuple] = {}

            def scan_arg(v: ast.expr) -> None:
                d = scan_expr(v)
                if (
                    isinstance(v, ast.Call)
                    and d is not None
                    and d[0] not in ("opaque", "jit")
                ):
                    tmp = f"$arg{len(ir.ops)}"
                    assign_desc(tmp, d)
                    nested[id(v)] = ("var", tmp)

            for a in call.args:
                scan_arg(a.value if isinstance(a, ast.Starred) else a)
            for kw in call.keywords:
                scan_arg(kw.value)
            jdef = self._parse_jit_call(module, call)
            if jdef is not None:
                return ("jit", jdef)
            # dict(x) / dict(**x) / x.copy(): key-preserving copies
            if isinstance(func, ast.Name) and func.id == "dict":
                src = None
                if call.args and isinstance(call.args[0], ast.Name):
                    src = call.args[0].id
                for kw in call.keywords:
                    if kw.arg is None and isinstance(kw.value, ast.Name):
                        src = kw.value.id
                if src is not None:
                    return ("copy", src)
                return ("fresh", frozenset())
            if (
                isinstance(func, ast.Attribute)
                and func.attr == "copy"
                and isinstance(func.value, ast.Name)
                and not call.args
            ):
                return ("copy", func.value.id)
            # strip: b.pop(<sidecar key>) / b.pop(k) in a key-tuple loop
            if (
                isinstance(func, ast.Attribute)
                and func.attr == "pop"
                and isinstance(func.value, ast.Name)
                and call.args
            ):
                keys = self._key_set(module, call.args[0], loop_keys)
                if keys:
                    ir.ops.append(["drop", func.value.id, keys])
                return None
            # Wire decode: THE taint source for lineage stamps — a
            # decoded message can carry any sidecar the producer wrote.
            resolved = module.resolve(func)
            if (
                resolved is not None
                and resolved.rsplit(".", 1)[-1] in WIRE_DECODE_FUNCS
            ):
                return ("fresh", self.sidecar_keys)
            jinfo = self._jit_at_call(module, cls, call, local_jits,
                                      info.local_types)
            if jinfo is not None:
                handle_jit_call(call, jinfo)
            callee = call_targets.get(id(call))
            if callee is not None and callee in self.project.functions:
                callee_desc = callee[1]
            else:
                callee, callee_desc = None, ""
            if jinfo is None and callee is None:
                return ("opaque",)
            pos_descs = tuple(
                nested.get(id(a)) or _arg_desc(a) for a in call.args
                if not isinstance(a, ast.Starred)
            )
            kw_descs = tuple(
                (kw.arg, nested.get(id(kw.value)) or _arg_desc(kw.value))
                for kw in call.keywords
                if kw.arg is not None
            )
            op = [
                "call", call, callee, jinfo, callee_desc, pos_descs,
                kw_descs, [],
            ]
            ir.ops.append(op)
            return ("callres", op)

        def _arg_desc(a: ast.AST):
            """Taint descriptor of one call argument."""
            if isinstance(a, ast.Name):
                return ("var", a.id)
            if isinstance(a, ast.Call):
                f = a.func
                if isinstance(f, ast.Name) and f.id == "dict":
                    if a.args and isinstance(a.args[0], ast.Name):
                        return ("copy", a.args[0].id)
                    for kw in a.keywords:
                        if kw.arg is None and isinstance(kw.value, ast.Name):
                            return ("copy", kw.value.id)
            if isinstance(a, ast.Dict):
                keys = frozenset(
                    k
                    for kn in a.keys
                    if kn is not None
                    for k in [self._key_value(module, kn)]
                    if k in self.sidecar_keys
                )
                return ("fresh", keys)
            return None

        def scan_expr(e: ast.AST | None):
            if e is None:
                return None
            if isinstance(e, ast.Name):
                if isinstance(e.ctx, ast.Load):
                    donate_use(e.id, e)
                    return ("var", e.id)
                return None
            if isinstance(e, ast.Attribute):
                d = dotted_name(e)
                if d is not None and isinstance(e.ctx, ast.Load):
                    if d in donated:
                        donate_use(d, e)
                    scan_expr(e.value)
                    return None
                scan_expr(e.value)
                return None
            if isinstance(e, ast.Call):
                return scan_call(e)
            if isinstance(e, ast.Dict):
                src: str | None = None
                keys: set[str] = set()
                for k, v in zip(e.keys, e.values):
                    if k is None:  # {**spread}
                        sub = scan_expr(v)
                        if sub and sub[0] == "var":
                            src = sub[1]
                    else:
                        scan_expr(k)
                        scan_expr(v)
                        kk = self._key_value(module, k)
                        if kk in self.sidecar_keys:
                            keys.add(kk)
                if src is not None:
                    return ("copyadd", src, frozenset(keys))
                return ("fresh", frozenset(keys))
            if isinstance(e, ast.DictComp):
                return scan_dictcomp(e)
            if isinstance(e, ast.Lambda):
                return None  # separate scope; params shadow
            if isinstance(e, (ast.Yield, ast.YieldFrom)):
                emit_ret(scan_expr(e.value))
                return None
            if isinstance(e, ast.IfExp):
                scan_expr(e.test)
                body = scan_expr(e.body)
                orelse = scan_expr(e.orelse)
                return body or orelse
            if isinstance(e, ast.BoolOp):
                descs = [scan_expr(v) for v in e.values]
                return next((d for d in descs if d), None)
            if isinstance(e, ast.Await):
                return scan_expr(e.value)
            for child in ast.iter_child_nodes(e):
                if isinstance(child, ast.expr):
                    scan_expr(child)
                elif isinstance(child, ast.comprehension):
                    scan_expr(child.iter)
                    for cond in child.ifs:
                        scan_expr(cond)
                elif isinstance(child, ast.keyword):
                    scan_expr(child.value)
                elif isinstance(child, (ast.FormattedValue, ast.Starred)):
                    scan_expr(child.value)
            return None

        def assign_desc(t_name: str, desc) -> None:
            """Bind one Name target to a value descriptor."""
            if desc is None or desc[0] == "opaque":
                ir.ops.append(["fresh", t_name, frozenset()])
            elif desc[0] == "var":
                ir.ops.append(["bind", t_name, desc[1]])
            elif desc[0] == "copy":
                ir.ops.append(["copy", t_name, desc[1]])
            elif desc[0] == "copyadd":
                ir.ops.append(["copyadd", t_name, desc[1], desc[2]])
            elif desc[0] == "fresh":
                ir.ops.append(["fresh", t_name, desc[1]])
            elif desc[0] == "filter":
                ir.ops.append(["filter", t_name, desc[1], desc[2]])
            elif desc[0] == "callres":
                desc[1][7].append(t_name)
            elif desc[0] == "jit":
                local_jits[t_name] = desc[1]

        def emit_ret(desc) -> None:
            """Record a return/yield of the value a descriptor denotes.
            Non-var descriptors (a copy, a stamped literal, a call
            result) are materialised through a synthetic local so one
            code path covers every shape of ``return <expr>``."""
            if not desc or desc[0] in ("opaque", "jit"):
                return
            if desc[0] == "var":
                ir.ops.append(["ret", desc[1]])
                return
            tmp = f"$ret{len(ir.ops)}"
            assign_desc(tmp, desc)
            ir.ops.append(["ret", tmp])

        def apply_target(t: ast.expr, desc, value: ast.expr | None) -> None:
            viewed = None
            if value is not None and isinstance(t, (ast.Name, ast.Attribute)):
                base = view_base(value)
                viewed = prefixes(base) if base is not None else None
            if isinstance(t, ast.Name):
                assign_desc(t.id, desc)
                store(t.id)
                if viewed:
                    aliases[t.id] = viewed
                plan_entries.pop(t.id, None)
                if value is not None:
                    if is_derived_expr(value):
                        derived.add(t.id)
                    else:
                        derived.discard(t.id)
                    dynamic_dicts.pop(t.id, None)
                    if isinstance(value, ast.Dict):
                        entry = dict_entry(value)
                        if entry:
                            plan_entries[t.id] = entry
            elif isinstance(t, ast.Tuple) or isinstance(t, ast.List):
                for elt in t.elts:
                    apply_target(
                        elt.value if isinstance(elt, ast.Starred) else elt,
                        None,
                        None,
                    )
            elif isinstance(t, ast.Attribute):
                d = dotted_name(t)
                if d is not None:
                    store(d)
                    if viewed:
                        aliases[d] = viewed
            elif isinstance(t, ast.Subscript):
                scan_expr(t.slice)
                if isinstance(t.value, ast.Name):
                    base = t.value.id
                    kk = self._key_value(module, t.slice)
                    if kk is not None and kk in self.sidecar_keys:
                        ir.ops.append(["add", base, frozenset({kk})])
                    elif kk is None and is_derived_expr(t.slice):
                        dynamic_dicts.setdefault(base, t)
                    entry = plan_entry(t.slice, value) if value else None
                    if entry:
                        plan_entries.setdefault(base, entry)
                else:
                    scan_expr(t.value)

        def exec_stmt(s: ast.stmt) -> None:
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                return  # separate FuncInfo scope
            if isinstance(s, ast.Assign):
                desc = scan_expr(s.value)
                for t in s.targets:
                    apply_target(t, desc, s.value)
                return
            if isinstance(s, ast.AnnAssign):
                if s.value is not None:
                    desc = scan_expr(s.value)
                    apply_target(s.target, desc, s.value)
                return
            if isinstance(s, ast.AugAssign):
                scan_expr(s.value)
                t = s.target
                d = dotted_name(t)
                if d is not None:
                    donate_use(d, t)  # augmented op READS the target
                apply_target(t, None, None)
                return
            if isinstance(s, ast.Expr):
                scan_expr(s.value)
                return
            if isinstance(s, ast.Return):
                emit_ret(scan_expr(s.value))
                return
            if isinstance(s, ast.Delete):
                for t in s.targets:
                    if (
                        isinstance(t, ast.Subscript)
                        and isinstance(t.value, ast.Name)
                    ):
                        keys = self._key_set(module, t.slice, loop_keys)
                        if keys:
                            ir.ops.append(["drop", t.value.id, keys])
                    elif isinstance(t, ast.Name):
                        ir.ops.append(["fresh", t.id, frozenset()])
                        store(t.id)
                return
            if isinstance(s, (ast.For, ast.AsyncFor)):
                desc = scan_expr(s.iter)
                # loop var over a key-tuple constant: `for k in _STAMP_KEYS`
                resolved = self._resolve_global(module, s.iter)
                if (
                    resolved in self.tuple_consts
                    and isinstance(s.target, ast.Name)
                ):
                    loop_keys[s.target.id] = self.tuple_consts[resolved]
                apply_target(s.target, desc, None)
                if isinstance(s.target, ast.Name) and is_derived_expr(s.iter):
                    derived.add(s.target.id)
                for sub in s.body:
                    exec_stmt(sub)
                for sub in s.orelse:
                    exec_stmt(sub)
                return
            if isinstance(s, ast.While):
                scan_expr(s.test)
                for sub in s.body:
                    exec_stmt(sub)
                for sub in s.orelse:
                    exec_stmt(sub)
                return
            if isinstance(s, ast.If):
                scan_expr(s.test)
                snap = dict(donated)
                for sub in s.body:
                    exec_stmt(sub)
                after_body = dict(donated)
                donated.clear()
                donated.update(snap)
                for sub in s.orelse:
                    exec_stmt(sub)
                donated.update(after_body)
                return
            if isinstance(s, (ast.With, ast.AsyncWith)):
                for item in s.items:
                    scan_expr(item.context_expr)
                    if item.optional_vars is not None:
                        apply_target(item.optional_vars, None, None)
                for sub in s.body:
                    exec_stmt(sub)
                return
            if isinstance(s, ast.Try) or s.__class__.__name__ == "TryStar":
                for sub in s.body:
                    exec_stmt(sub)
                for handler in s.handlers:
                    for sub in handler.body:
                        exec_stmt(sub)
                for sub in s.orelse:
                    exec_stmt(sub)
                for sub in s.finalbody:
                    exec_stmt(sub)
                return
            if isinstance(s, (ast.Raise, ast.Assert)):
                for child in ast.iter_child_nodes(s):
                    if isinstance(child, ast.expr):
                        scan_expr(child)
                return
            # Pass/Break/Continue/Import/Global/Nonlocal: nothing to do

        for stmt in fn.body:
            exec_stmt(stmt)
        return ir

    def _cond_removed(
        self, module: ModuleContext, cond: ast.expr, key_var: str | None
    ) -> set[str] | None:
        """Keys a dict-comprehension condition removes. ``set`` =
        exactly those; ``None`` = a key-based filter we can't model
        (treated as removing every sidecar key — filtered rebuilds
        whitelist schema fields in this codebase); conditions that
        never mention the key filter nothing."""
        mentions_key = key_var is not None and any(
            isinstance(n, ast.Name) and n.id == key_var
            for n in ast.walk(cond)
        )
        if not mentions_key:
            return set()
        if (
            isinstance(cond, ast.Compare)
            and len(cond.ops) == 1
            and isinstance(cond.ops[0], ast.NotIn)
            and isinstance(cond.left, ast.Name)
            and cond.left.id == key_var
        ):
            comp = cond.comparators[0]
            if isinstance(comp, (ast.Tuple, ast.List, ast.Set)):
                out: set[str] = set()
                for elt in comp.elts:
                    v = self._key_value(module, elt)
                    if v is not None:
                        out.add(v)
                return out
            resolved = module.resolve(comp)
            if resolved in self.tuple_consts:
                return set(self.tuple_consts[resolved])
        return None

    # -- simulation ----------------------------------------------------------

    def _taint_of(self, desc, env: dict[str, _Taint]) -> _Taint | None:
        if desc is None:
            return None
        if desc[0] == "var":
            return env.get(desc[1])
        if desc[0] == "copy":
            src = env.get(desc[1])
            return src.fork() if src is not None else None
        if desc[0] == "fresh":
            return _Taint(desc[1]) if desc[1] else None
        return None

    def _simulate(self, nid: NodeId, seeded: bool) -> SimResult:
        ir = self.ir[nid]
        res = SimResult()
        env: dict[str, _Taint] = {}
        for i, p in enumerate(ir.params):
            tv = _Taint(self.sidecar_keys if seeded else (), {i})
            env[p] = tv
            res.param_final[i] = tv
        for op in ir.ops:
            tag = op[0]
            if tag == "bind":
                env[op[1]] = env.setdefault(op[2], _Taint())
            elif tag == "copy":
                src = env.get(op[2])
                env[op[1]] = src.fork() if src is not None else _Taint()
            elif tag == "copyadd":
                src = env.get(op[2])
                tv = src.fork() if src is not None else _Taint()
                tv.keys |= op[3]
                env[op[1]] = tv
            elif tag == "fresh":
                env[op[1]] = _Taint(op[2])
            elif tag == "add":
                env.setdefault(op[1], _Taint()).keys |= op[2]
            elif tag == "drop":
                tv = env.get(op[1])
                if tv is not None:
                    tv.keys -= op[2]
            elif tag == "filter":
                src = env.get(op[2])
                if src is None or op[3] is None:
                    env[op[1]] = _Taint()
                else:
                    tv = src.fork()
                    tv.keys -= op[3]
                    env[op[1]] = tv
            elif tag == "ret":
                tv = env.get(op[1])
                if tv is None:
                    continue
                res.return_keys |= tv.keys
                for p in tv.params:
                    removed = self.sidecar_keys - tv.keys
                    if p in res.return_params:
                        res.return_params[p] &= removed
                    else:
                        res.return_params[p] = set(removed)
            elif tag == "call":
                self._sim_call(op, env, res)
        return res

    def _sim_call(self, op: list, env: dict[str, _Taint],
                  res: SimResult) -> None:
        _tag, node, callee, jinfo, callee_desc, pos_descs, kw_descs, dsts = op
        summary = self.summaries.get(callee) if callee is not None else None
        callee_params = self.ir[callee].params if callee in self.ir else ()
        arg_taints: list[tuple[int | None, _Taint | None]] = []
        for i, d in enumerate(pos_descs):
            arg_taints.append((i, self._taint_of(d, env)))
        for name, d in kw_descs:
            idx = callee_params.index(name) if name in callee_params else None
            arg_taints.append((idx, self._taint_of(d, env)))
        if jinfo is not None:
            for _idx, tv in arg_taints:
                keys = tv.keys - jinfo.unkeyed if tv is not None else None
                if keys:
                    res.leaks.append(
                        LeakEvent(
                            node=node,
                            keys=frozenset(keys),
                            params=frozenset(tv.params),
                            jit_desc=jinfo.desc,
                            via=None,
                        )
                    )
            for dst in dsts:
                env[dst] = _Taint()
            return
        if summary is None:
            for dst in dsts:
                env[dst] = _Taint()
            return
        ret = _Taint(summary.return_keys)
        for idx, tv in arg_taints:
            if idx is None or tv is None:
                continue
            leak = summary.leak_params.get(idx)
            if leak:
                hit = tv.keys & leak
                if hit:
                    res.leaks.append(
                        LeakEvent(
                            node=node,
                            keys=frozenset(hit),
                            params=frozenset(tv.params),
                            jit_desc="",
                            via=callee_desc,
                        )
                    )
            strip = summary.strip_params.get(idx)
            if strip:
                tv.keys -= strip
            added = summary.add_params.get(idx)
            if added:
                tv.keys |= added
            passthrough = summary.return_params.get(idx)
            if passthrough is not None:
                ret.keys |= tv.keys - passthrough
                ret.params |= tv.params
        for dst in dsts:
            env[dst] = ret
    # -- fixpoint ------------------------------------------------------------

    def _summary_of(self, nid: NodeId) -> FlowSummary:
        seeded = self._simulate(nid, seeded=True)
        unseeded = self._simulate(nid, seeded=False)
        s = FlowSummary()
        for leak in seeded.leaks:
            for p in leak.params:
                s.leak_params.setdefault(p, set()).update(leak.keys)
        for i, tv in seeded.param_final.items():
            removed = self.sidecar_keys - tv.keys
            if removed:
                s.strip_params[i] = removed
        for i, tv in unseeded.param_final.items():
            if tv.keys:
                s.add_params[i] = set(tv.keys)
        s.return_params = seeded.return_params
        s.return_keys = unseeded.return_keys
        return s

    def _fixpoint(self) -> None:
        for _ in range(self._MAX_ROUNDS):
            changed = False
            for nid in self.ir:
                new = self._summary_of(nid)
                if new.snapshot() != self.summaries[nid].snapshot():
                    self.summaries[nid] = new
                    changed = True
            if not changed:
                break


