"""BJX106 sync-on-inflight-step: same-iteration host sync on a step
output inside a driver hot path; and the port's one sync vocabulary.

**The vocabulary.** What waits for the card and brings a value to the
host, in torch:

- ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()`` and
  ``.to("cpu")`` of a tensor (the fetches);
- ``float()``, ``int()`` and ``bool()`` of a tensor, and
  ``np.asarray``/``np.array``/``np.ascontiguousarray`` of one (the
  casts);
- ``torch.cuda.synchronize()``, ``Stream.synchronize()`` and
  ``Event.synchronize()`` (the waits).

:func:`sync_call` recognizes one; the rules BJX102, 106, 108, 111 and
115 and the card's sync census in ``chip_smoke.py`` read it from here. A tensor that lives in pinned host memory
(``torch.empty(..., pin_memory=True)``, ``.pin_memory()``,
``_pinned_buffer(...)``) is no device value: :func:`host_names` names
the locals bound to one, and no rule counts a fetch or cast of them.

**The rule.** The port's driver (``blendjax_torch/train/driver.py``)
keeps ``inflight`` captured-step replays outstanding; one wait, fetch or
cast of a value dispatched IN THE SAME loop iteration collapses the
pipeline back to dispatch-wait-dispatch. The sanctioned pattern is
completion tracking: retire finished entries with non-blocking
``event.query()`` polls, block only on the entry dispatched ``inflight``
iterations back, and fetch losses at ``sync_every`` boundaries — all of
which sync values produced in EARLIER iterations (helper methods / ring
pops / a sync placed textually BEFORE the dispatch, which reads the
previous iteration's value), none of which this rule flags: a finding
requires the sync to sit at or after the name's assignment within the
same loop body. ``torch.cuda.synchronize()`` names no value: it waits
for everything, so it counts as a sync of every name dispatched before
it in the iteration.

Modules opt in with a ``bjx: driver-hot-path`` marker comment (the same
comment-marker mechanism as BJX102's ``bjx: hot-path``); any module
named ``driver.py`` is always checked.
"""

from __future__ import annotations

import ast
from typing import Iterator, NamedTuple

from blendjax_torch.analysis.core import (
    Finding,
    ModuleContext,
    Rule,
    register,
    walk_shallow,
)
from blendjax_torch.analysis.rules.markers import _is_driver_hot

FETCH_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
HOST_CASTS = frozenset({"float", "int", "bool"})
HOST_ARRAY_CASTS = frozenset(
    {"numpy.asarray", "numpy.array", "numpy.ascontiguousarray"}
)
DEVICE_WAITS = frozenset({"torch.cuda.synchronize"})
WAIT_METHODS = frozenset({"synchronize"})
#: calls whose result is a tensor in pinned host memory
PINNED_CALLS = frozenset({"pin_memory", "_pinned_buffer"})

LoopNode = ast.For | ast.AsyncFor | ast.While


class Sync(NamedTuple):
    """One host sync: its display ``form``, its ``kind`` (``fetch``,
    ``cast`` or ``wait``) and the expression whose value it syncs
    (``None`` for ``torch.cuda.synchronize()``, which waits for all)."""

    form: str
    kind: str
    target: ast.AST | None


def _tail(node: ast.AST) -> str:
    """The last name of a Name/Attribute call target."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _is_cpu(node: ast.AST) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return (
        isinstance(node, ast.Call)
        and _tail(node.func) == "device"
        and bool(node.args)
        and _is_cpu(node.args[0])
    )


def sync_call(node: ast.Call, module: ModuleContext) -> Sync | None:
    """The :class:`Sync` that ``node`` makes, or None."""
    func = node.func
    resolved = module.resolve(func) or ""
    if resolved in DEVICE_WAITS:
        return Sync(f"{resolved}()", "wait", None)
    if isinstance(func, ast.Attribute):
        if func.attr in FETCH_METHODS and not node.args:
            return Sync(f".{func.attr}()", "fetch", func.value)
        if func.attr == "to" and (
            any(_is_cpu(a) for a in node.args[:1])
            or any(kw.arg == "device" and _is_cpu(kw.value)
                   for kw in node.keywords)
        ):
            return Sync(".to('cpu')", "fetch", func.value)
        if func.attr in WAIT_METHODS and not node.args:
            return Sync(".synchronize()", "wait", func.value)
    if (resolved in HOST_CASTS or resolved in HOST_ARRAY_CASTS) and node.args:
        return Sync(f"{resolved}()", "cast", node.args[0])
    return None


def _is_pinned(value: ast.AST) -> bool:
    if not isinstance(value, ast.Call):
        return False
    if _tail(value.func) in PINNED_CALLS:
        return True
    return any(
        kw.arg == "pin_memory"
        and isinstance(kw.value, ast.Constant)
        and kw.value.value is True
        for kw in value.keywords
    )


def host_names(fn: ast.AST) -> set[str]:
    """Locals of ``fn`` bound to a pinned host tensor: fetching or casting
    them is a host read."""
    out: set[str] = set()
    for node in walk_shallow(fn):
        if isinstance(node, ast.Assign) and _is_pinned(node.value):
            for target in node.targets:
                out |= _names(target)
    return out


def _walk_loop(loop: LoopNode) -> Iterator[ast.AST]:
    """Walk a loop's body without descending into nested function/class
    definitions (their bodies run in a different iteration context)."""
    stack: list[ast.AST] = list(loop.body) + list(loop.orelse)
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            stack.extend(ast.iter_child_nodes(node))


def _names(node: ast.AST) -> set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


@register
class InflightSyncRule(Rule):
    id = "BJX106"
    name = "sync-on-inflight-step"
    description = (
        "host sync (.item()/.cpu()/float()/np.asarray/synchronize()) on "
        "a value dispatched in the same loop iteration inside a driver "
        "hot path"
    )

    def check(self, module: ModuleContext) -> Iterator[Finding]:
        if not _is_driver_hot(module):
            return
        for qual, fn, _cls in module.iter_functions():
            seen: set[tuple[int, int]] = set()
            hosts = host_names(fn)
            for node in ast.walk(fn):
                if isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
                    for f in self._scan_loop(module, node, qual, hosts):
                        key = (f.line, f.col)
                        if key not in seen:  # nested loops scan twice
                            seen.add(key)
                            yield f

    def _scan_loop(
        self, module: ModuleContext, loop: LoopNode, qual: str,
        hosts: set[str],
    ) -> Iterator[Finding]:
        nodes = list(_walk_loop(loop))
        # Names bound from ANY call result in this iteration — the step
        # dispatch (`m = step(state, b)`) and anything derived from it —
        # keyed by their FIRST assignment line: a sync that textually
        # precedes the assignment consumes the PREVIOUS iteration's
        # value (the sanctioned sync-one-behind shape) and must not be
        # flagged.
        dispatched: dict[str, int] = {}
        for node in nodes:
            if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call
            ):
                for target in node.targets:
                    for name in _names(target):
                        line = getattr(node, "lineno", 0)
                        if name not in dispatched or line < dispatched[name]:
                            dispatched[name] = line
        for name in hosts:
            dispatched.pop(name, None)
        if not dispatched:
            return
        for node in nodes:
            if not isinstance(node, ast.Call):
                continue
            sync = sync_call(node, module)
            if sync is None:
                continue
            line = getattr(node, "lineno", 0)
            synced = (
                set(dispatched) if sync.target is None
                else _names(sync.target)
            )
            hit = sorted(
                name for name in synced
                if name in dispatched and line >= dispatched[name]
            )
            if hit:
                yield self.finding(
                    module,
                    node,
                    f"{sync.form} on in-flight step output '{hit[0]}' in "
                    f"driver hot path '{qual}' collapses the dispatch "
                    "pipeline to one step deep — track completion per "
                    "entry with event.query() and sync only at "
                    "sync_every boundaries",
                )
