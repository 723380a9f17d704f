"""BJX112 state-rebound-in-captured-step: a step-like function handed to
a capture wrapper in a driver hot path rebinds a field of its state.

The port's counterpart of donation is the in-place update: a captured
step (``CapturedStep``, ``build_aot_step``,
``torch.cuda.make_graphed_callables``) writes the new parameters and
optimizer moments INTO the tensors its state already holds, so the
run's memory is one copy of the state and every replay finds its inputs
and outputs where the capture left them (the runtime donation audit,
:mod:`blendjax_torch.testing.donation`, pins the storage stability this
buys; ``train.donation_reuse`` reports it). A step that REBINDS a field
of its state parameter — ``state.params = ...``, ``state["opt"] = ...``,
``setattr(state, ...)`` — does so once, at capture: every replay then
writes a tensor the state no longer holds, and the state goes on
reading the tensor the capture's one eager call made. It trains for one
step, which is why it needs a lint, not a test. The JAX rule checks
that the ``donate_argnums`` keyword is present; the port has no such
keyword, so the check becomes this in-place check.

An augmented assignment (``state.step += 1``) is no rebinding of a
tensor: ``Tensor.__iadd__`` writes in place and hands back the same
tensor, and on an int counter ``aot.py``'s replay wrapper advances
``state.step`` itself.

Scope: driver-hot-path modules — the ``bjx: driver-hot-path`` marker
comment or a ``driver.py`` basename (as BJX106/BJX108) plus
``steps.py``/``mesh_driver.py``, where the step builders live.
"Step-like" follows the repo's naming convention: the function's name
carries a ``step``/``fused``/``train`` segment (underscore-anchored, so
``constraint`` never reads as ``train``), or its first parameter is
named ``state``/``st``/``train_state``. A deliberate exception
suppresses with ``# bjx: ignore[BJX112]`` and a justification.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Iterator

from blendjax_torch.analysis.core import (
    Finding,
    ModuleContext,
    Rule,
    register,
    walk_shallow,
)
from blendjax_torch.analysis.rules.markers import _is_driver_hot
from blendjax_torch.analysis.rules.purity import (
    PARTIAL_NAMES,
    _is_capture_wrapper,
)

STEP_MODULE_BASENAMES = {"steps.py", "mesh_driver.py"}
# segment-anchored, not bare substrings: 'constraint'/'constrain'/
# 'strain' must not read as train, while step/_fused/train_step/
# make_echo_fused_step all still hit
STEP_NAME_RE = re.compile(r"(?:^|_)(?:step|fused|train)", re.IGNORECASE)
STATE_PARAM_NAMES = {"state", "st", "train_state"}


def _in_scope(module: ModuleContext) -> bool:
    if os.path.basename(module.relpath) in STEP_MODULE_BASENAMES:
        return True
    return _is_driver_hot(module)


def _function_defs(module: ModuleContext) -> dict[str, ast.AST]:
    """Every function def in the module by BARE name (the innermost def
    wins ties — capture sites reference the local one)."""
    defs: dict[str, ast.AST] = {}
    for _qual, fn, _cls in module.iter_functions():
        defs[fn.name] = fn
    return defs


def _state_param(fn: ast.AST | None) -> str | None:
    args = getattr(fn, "args", None)
    if args is None:
        return None
    pos = list(args.posonlyargs) + list(args.args)
    if not pos:
        return None
    first: str = pos[0].arg
    if first in ("self", "cls") and len(pos) > 1:
        return str(pos[1].arg)
    return first


def _is_step_like(name: str | None, fn: ast.AST | None) -> bool:
    if name and STEP_NAME_RE.search(name):
        return True
    first = _state_param(fn)
    return bool(first and first.lower() in STATE_PARAM_NAMES)


def _rebinding(fn: ast.AST, state: str) -> ast.AST | None:
    """The first statement of ``fn`` that rebinds a field of ``state``."""
    body = fn.body if isinstance(fn.body, list) else [fn.body]
    for stmt in body:
        for node in [stmt, *walk_shallow(stmt)]:
            targets: list[ast.expr] = []
            if isinstance(node, ast.Assign):
                targets = list(node.targets)
            elif isinstance(node, ast.AnnAssign):
                targets = [node.target]
            elif (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "setattr"
                and node.args
                and isinstance(node.args[0], ast.Name)
                and node.args[0].id == state
            ):
                return node
            for t in targets:
                for sub in ast.walk(t):
                    if (
                        isinstance(sub, (ast.Attribute, ast.Subscript))
                        and isinstance(sub.value, ast.Name)
                        and sub.value.id == state
                    ):
                        return node
    return None


@register
class StateReboundInCapturedStepRule(Rule):
    id = "BJX112"
    name = "state-rebound-in-captured-step"
    description = (
        "a step-like function handed to CapturedStep/build_aot_step/"
        "make_graphed_callables in a driver hot path rebinds a field of "
        "its state instead of writing it in place"
    )

    def check(self, module: ModuleContext) -> Iterator[Finding]:
        if not _in_scope(module):
            return
        defs = _function_defs(module)
        for node in ast.walk(module.tree):
            if (
                isinstance(node, ast.Call)
                and node.args
                and _is_capture_wrapper(module, node.func)
            ):
                yield from self._check_call(module, node, defs)

    def _check_call(
        self, module: ModuleContext, node: ast.Call,
        defs: dict[str, ast.AST],
    ) -> Iterator[Finding]:
        target = node.args[0]
        if (
            isinstance(target, ast.Call)
            and module.resolve(target.func) in PARTIAL_NAMES
            and target.args
        ):
            target = target.args[0]
        name: str | None
        fn: ast.AST | None
        if isinstance(target, ast.Name):
            name = target.id
            fn = defs.get(name)
        elif isinstance(target, ast.Lambda):
            name, fn = None, target
        else:
            return  # attribute/call targets: out of the heuristic's reach
        if fn is None or not _is_step_like(name, fn):
            return
        state = _state_param(fn)
        where = _rebinding(fn, state) if state else None
        if where is None:
            return
        yield self.finding(
            module,
            node,
            f"captured step-like '{name or '<lambda>'}' rebinds a field of "
            f"'{state}' (line {getattr(where, 'lineno', '?')}) — the "
            "rebinding runs once at capture and every replay then writes "
            "a tensor the state no longer holds; update the state's "
            "tensors in place (copy_/mul_/add_, an in-place optimizer), or "
            "suppress with a justification",
        )
