"""BJX103 unsafe-deserialization: ungated pickle decode paths.

Unpickling is remote code execution by design; the wire and replay
layers therefore route every pickle decode behind an explicit
``allow_pickle`` parameter (``blendjax_torch/transport/wire.py``,
``blendjax_torch/data/replay.py``). This rule flags any ``pickle.loads`` /
``pickle.load`` / ``pickle.Unpickler`` whose enclosing function or
class does not carry that gate, unless the site is annotated
``# bjx: trusted-source``.
"""

from __future__ import annotations

import ast
from typing import Iterator

from blendjax_torch.analysis.core import Finding, ModuleContext, Rule, register

GATE_PARAM = "allow_pickle"
TRUSTED_MARKER = "bjx: trusted-source"

PICKLE_DECODERS = {
    "pickle.loads",
    "pickle.load",
    "pickle.Unpickler",
    "cPickle.loads",
    "cPickle.load",
    "dill.loads",
    "dill.load",
    "cloudpickle.loads",
    "cloudpickle.load",
}


def _has_gate_param(fn: ast.AST) -> bool:
    args = getattr(fn, "args", None)
    if args is None:
        return False
    every = [
        *args.posonlyargs, *args.args, *args.kwonlyargs,
        *filter(None, [args.vararg, args.kwarg]),
    ]
    return any(a.arg == GATE_PARAM for a in every)


def _references_gate(fn: ast.AST) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and node.id == GATE_PARAM:
            return True
        if isinstance(node, ast.Attribute) and node.attr == GATE_PARAM:
            return True
    return False


@register
class UnsafeDeserializationRule(Rule):
    id = "BJX103"
    name = "unsafe-deserialization"
    description = (
        "pickle decode without an allow_pickle gate in the enclosing "
        "function/class and no trusted-source annotation"
    )

    def check(self, module: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            resolved = module.resolve(node.func)
            if resolved not in PICKLE_DECODERS:
                continue
            if self._gated(module, node):
                continue
            if self._trusted(module, node):
                continue
            yield self.finding(
                module,
                node,
                f"{resolved}() decodes attacker-controllable bytes: gate "
                f"it behind an '{GATE_PARAM}' parameter or annotate the "
                f"call '# {TRUSTED_MARKER}'",
            )

    def _gated(self, module: ModuleContext, call: ast.Call) -> bool:
        node: ast.AST | None = call
        enclosing_class = None
        while node is not None:
            node = module.parents.get(node)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if _has_gate_param(node) or _references_gate(node):
                    return True
            elif isinstance(node, ast.ClassDef) and enclosing_class is None:
                enclosing_class = node
        if enclosing_class is not None:
            # A constructor-level gate covers every method (the replay
            # readers raise in __init__ unless allow_pickle=True).
            for item in enclosing_class.body:
                if isinstance(
                    item, (ast.FunctionDef, ast.AsyncFunctionDef)
                ) and _has_gate_param(item):
                    return True
        return False

    @staticmethod
    def _trusted(module: ModuleContext, call: ast.Call) -> bool:
        for line in (call.lineno, call.lineno - 1):
            if TRUSTED_MARKER in module.line_text(line):
                return True
        return False
