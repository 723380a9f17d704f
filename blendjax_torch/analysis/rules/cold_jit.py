"""BJX125 cold-capture-in-hot-loop: captured-step or step-builder
construction inside a per-step or per-batch loop in a driver hot path
(a ``CapturedDispatch`` too).

The port's instant-start work (``blendjax_torch/train/aot.py``) moves
every capture *before step 0*: ``build_aot_step`` captures the bucket
ladder's signatures at build time, and a ``CapturedStep`` keeps one
CUDA graph per signature for the whole run. Constructing a
``CapturedStep``, a ``build_aot_step`` set, a ``torch.cuda.CUDAGraph``
or ``make_graphed_callables`` — or calling a step builder like
``make_supervised_step``/``make_train_state`` — *inside* the loop that
drives steps silently defeats both: each iteration gets a fresh wrapper
with no graphs, so every step warms up and captures again (seconds
each, and a private memory pool per capture), and none of it is the set
the driver captured. The sanctioned shape is construction at build time
(``TrainDriver.build``, the pipeline constructors) with only replay in
the loop.

Scope mirrors BJX106: modules opting in with ``bjx: driver-hot-path``
(comment marker) plus anything named ``driver.py``.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from blendjax_torch.analysis.core import (
    Finding,
    ModuleContext,
    Rule,
    register,
)
from blendjax_torch.analysis.rules.driver_sync import LoopNode, _walk_loop
from blendjax_torch.analysis.rules.markers import _is_driver_hot

#: bare names of calls that construct a captured artifact
CAPTURE_CONSTRUCTORS = {"CapturedStep", "CapturedDispatch", "CUDAGraph",
                        "make_graphed_callables"}
# Step/state builders by bare name: each returns a fresh step (or makes
# a state), so per-iteration calls capture again per iteration.
BUILDER_NAME_RE = re.compile(
    r"^(?:make_(?:[a-z0-9_]+_)?(?:step|state)|build_aot_step)$"
)


def _bare(func: ast.AST, module: ModuleContext) -> str:
    resolved = module.resolve(func) or ""
    if resolved:
        return resolved.rsplit(".", 1)[-1]
    if isinstance(func, ast.Attribute):
        return func.attr
    return func.id if isinstance(func, ast.Name) else ""


@register
class ColdCaptureInHotLoopRule(Rule):
    id = "BJX125"
    name = "cold-capture-in-hot-loop"
    description = (
        "CapturedStep / build_aot_step / CUDAGraph / step-builder "
        "construction inside a per-step or per-batch loop in a driver "
        "hot path (captures again every iteration; defeats the step set "
        "captured before step 0)"
    )

    def check(self, module: ModuleContext) -> Iterator[Finding]:
        if not _is_driver_hot(module):
            return
        for qual, fn, _cls in module.iter_functions():
            seen: set[tuple[int, int]] = set()
            for node in ast.walk(fn):
                if isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
                    for f in self._scan_loop(module, node, qual):
                        key = (f.line, f.col)
                        if key not in seen:  # nested loops scan twice
                            seen.add(key)
                            yield f

    def _scan_loop(
        self, module: ModuleContext, loop: LoopNode, qual: str
    ) -> Iterator[Finding]:
        for node in _walk_loop(loop):
            if not isinstance(node, ast.Call):
                continue
            bare = _bare(node.func, module)
            if bare not in CAPTURE_CONSTRUCTORS and not BUILDER_NAME_RE.match(
                bare
            ):
                continue
            yield self.finding(
                module,
                node,
                f"'{bare}(...)' constructed inside a loop in driver hot "
                f"path '{qual}': every iteration captures again with no "
                "graphs cached, defeating the step set captured before "
                "step 0 — build steps once (TrainDriver.build / module "
                "scope) and only replay in the loop",
            )
