"""BJX101 capture-purity: host side effects reachable from a captured
step.

A CUDA graph records the card's work of ONE call and replays only that:
``CapturedStep`` and ``build_aot_step`` (``blendjax_torch/train/aot.py``)
capture a step the first time its signature is seen, ``CapturedDispatch``
a dispatch outside a step (the decoded form's decode, the echo
reservoir's draw: the JAX package's ``jax.jit`` of each),
``torch.cuda.make_graphed_callables`` captures a callable, and a
``with torch.cuda.graph(g):`` block captures its body. Any Python side
effect inside — ``print``, ``time.*``, file I/O, a host random draw
(``np.random``, ``random``, ``torch.manual_seed``), a module-global
mutation — runs at capture only (or bakes a host value into the graph)
and silently disappears from every replay. The rule marks the functions
handed to a capture wrapper (by name, through ``functools.partial``, or
as a lambda) and the bodies of ``torch.cuda.graph`` blocks, walks the
same-module call graph, and flags impure constructs anywhere reachable.

The rule's scope is the JAX rule's: module globals, not attributes of a
parameter. ``state.step += 1`` inside a captured step
(``blendjax_torch/train/steps.py``) runs at capture only too, and is not
flagged: ``aot.py``'s replay wrapper advances ``state.step`` by the
updates the graph makes, in place of the captured increment.
"""

from __future__ import annotations

import ast
from collections import defaultdict
from typing import Iterator

from blendjax_torch.analysis.core import (
    Finding,
    ModuleContext,
    Rule,
    dotted_name,
    register,
)

#: callables that capture the function handed to them as a CUDA graph
CAPTURE_WRAPPERS = {"CapturedStep", "build_aot_step", "make_graphed_callables",
                    "CapturedDispatch"}
#: context managers whose body is captured
CAPTURE_BLOCKS = {"graph"}
PARTIAL_NAMES = {"partial", "functools.partial"}

TIME_FUNCS = {
    "time.time",
    "time.perf_counter",
    "time.monotonic",
    "time.process_time",
    "time.sleep",
    "time.time_ns",
    "time.perf_counter_ns",
}
SEED_FUNCS = {"torch.manual_seed", "torch.cuda.manual_seed",
              "torch.cuda.manual_seed_all", "torch.seed"}


def _last(name: str | None) -> str:
    return (name or "").rsplit(".", 1)[-1]


def _is_capture_wrapper(module: ModuleContext, node: ast.AST) -> bool:
    return _last(module.resolve(node)) in CAPTURE_WRAPPERS


def _is_capture_block(module: ModuleContext, item: ast.withitem) -> bool:
    ctx = item.context_expr
    if not isinstance(ctx, ast.Call):
        return False
    resolved = module.resolve(ctx.func) or ""
    return resolved.startswith("torch.cuda.") and _last(resolved) in CAPTURE_BLOCKS


@register
class CapturePurityRule(Rule):
    id = "BJX101"
    name = "capture-purity"
    description = (
        "host side effect (print/time/np.random/random/torch.manual_seed/"
        "open/global mutation) in a function reachable from a captured "
        "step (CapturedStep, build_aot_step, make_graphed_callables, a "
        "torch.cuda.graph block)"
    )

    def check(self, module: ModuleContext) -> Iterator[Finding]:
        functions = list(module.iter_functions())
        by_name: dict[str, list[str]] = defaultdict(list)
        nodes: dict[str, ast.AST] = {}
        for qual, fn, _cls in functions:
            nodes[qual] = fn
            by_name[fn.name].append(qual)

        roots: set[str] = set()
        regions: list[tuple[str, ast.AST]] = []
        for node in ast.walk(module.tree):
            if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                _is_capture_block(module, item) for item in node.items
            ):
                block = ast.Module(body=node.body, type_ignores=[])
                regions.append(("<torch.cuda.graph block>", block))
                for inner in ast.walk(block):
                    if isinstance(inner, ast.Call):
                        roots.update(by_name.get(
                            _last(dotted_name(inner.func)), []))
            if not (isinstance(node, ast.Call) and node.args):
                continue
            if not _is_capture_wrapper(module, node.func):
                continue
            wrapped = node.args[0]
            # CapturedStep(functools.partial(step, ...))
            if (
                isinstance(wrapped, ast.Call)
                and module.resolve(wrapped.func) in PARTIAL_NAMES
                and wrapped.args
            ):
                wrapped = wrapped.args[0]
            if isinstance(wrapped, ast.Lambda):
                regions.append(("<lambda>", wrapped))
            else:
                roots.update(by_name.get(_last(dotted_name(wrapped)), []))

        # Same-module call graph: edges by simple callee name (covers
        # both helper(x) and self.helper(x)).
        edges: dict[str, set[str]] = defaultdict(set)
        for qual, fn, _cls in functions:
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    callee = _last(dotted_name(node.func))
                    for target in by_name.get(callee, []):
                        edges[qual].add(target)

        reachable: set[str] = set()
        frontier = list(roots)
        while frontier:
            qual = frontier.pop()
            if qual in reachable:
                continue
            reachable.add(qual)
            frontier.extend(edges[qual])

        seen: set[tuple[int, int]] = set()
        for qual in sorted(reachable):
            yield from self._scan(module, nodes[qual], qual, seen)
        for label, region in regions:
            yield from self._scan(module, region, label, seen)

    def _scan(
        self,
        module: ModuleContext,
        fn: ast.AST,
        qual: str,
        seen: set[tuple[int, int]],
    ) -> Iterator[Finding]:
        assigned: set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                targets: list[ast.expr] = list(node.targets)
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = [node.target]
            else:
                continue
            assigned.update(
                t.id for t in targets if isinstance(t, ast.Name)
            )
        for node in ast.walk(fn):
            key = (getattr(node, "lineno", 0), getattr(node, "col_offset", 0))
            msg = None
            if isinstance(node, ast.Call):
                resolved = module.resolve(node.func) or ""
                simple = dotted_name(node.func)
                if simple == "print":
                    msg = (
                        f"print() in captured '{qual}' runs at capture "
                        "only, never on replay"
                    )
                elif resolved in TIME_FUNCS:
                    msg = (
                        f"{resolved}() in captured '{qual}' is read once "
                        "at capture and never again on replay"
                    )
                elif resolved.startswith(("numpy.random.", "random.")):
                    msg = (
                        f"{resolved}() in captured '{qual}' draws host "
                        "randomness once at capture (draw on the card "
                        "with a torch.Generator)"
                    )
                elif resolved in SEED_FUNCS:
                    msg = (
                        f"{resolved}() in captured '{qual}' reseeds once "
                        "at capture, never on replay"
                    )
                elif simple == "open":
                    msg = (
                        f"open() in captured '{qual}' performs I/O at "
                        "capture only (hoist it out of the step)"
                    )
            elif isinstance(node, ast.Global):
                # Only a `global` name the function actually assigns is
                # a mutation (a read-only declaration is pointless but
                # harmless under capture).
                mutated = [n for n in node.names if n in assigned]
                if mutated:
                    msg = (
                        f"global mutation of {', '.join(mutated)} in "
                        f"captured '{qual}' happens at capture only"
                    )
            if msg and key not in seen:
                seen.add(key)
                yield self.finding(module, node, msg)
