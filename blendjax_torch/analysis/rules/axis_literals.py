"""BJX126 mesh-axis-literal: hardcoded axis names in partition specs.

A hardcoded-axis bug class, with three axes to get wrong: a library
function that spells ``P("data")`` (or ``"fsdp"``/``"tp"``/``"seq"``)
inline has frozen the caller's layout decision. When the caller
threads a different ``data_axis`` — or a :class:`blendjax_torch.parallel
.Layout` composes axes the literal never heard of — the constraint
silently binds to a missing axis and GSPMD constrains the value to
REPLICATED: N-chip throughput becomes 1-chip throughput with no
error, or an fsdp/tp layout quietly trains un-sharded.

The rule flags string constants naming a mesh axis
(``data``/``fsdp``/``tp``/``tensor``/``seq``/``expert``/``pipe``)
passed to a ``PartitionSpec`` construction (any import alias,
including the conventional ``P``) in library code. The layout layer
itself — ``blendjax_torch/parallel/`` — is exempt: deriving specs from axis
names is precisely its job, and every other module should be asking
it (``batch_sharding(mesh, axis=data_axis)``, ``param_sharding_rules``,
``state_shardings(layout=...)``) instead of spelling axes by hand.
Genuinely fixed layouts (a test fixture, a doc example) suppress
inline with ``# bjx: ignore[BJX126]`` and say why.
"""

from __future__ import annotations

import ast
from typing import Iterator

from blendjax_torch.analysis.core import (
    Finding,
    ModuleContext,
    Rule,
    register,
    walk_shallow,
)

#: the named-mesh axis vocabulary (blendjax_torch.parallel.sharding.MESH_AXES;
#: spelled out so the linter stays stdlib-only/import-free)
AXIS_NAMES = frozenset(
    {"data", "fsdp", "tp", "tensor", "seq", "expert", "pipe"}
)

#: the one package allowed to spell axis names into specs
_EXEMPT_PREFIX = "blendjax_torch/parallel/"


def _is_partition_spec(module: ModuleContext, node: ast.Call) -> bool:
    resolved = module.resolve(node.func)
    if resolved is None:
        return False
    return resolved.split(".")[-1] in ("PartitionSpec", "P") or (
        resolved.endswith(".PartitionSpec")
    )


def _axis_literals(node: ast.Call) -> Iterator[str]:
    """Axis-name string constants anywhere in the spec's arguments
    (entries may be strings or tuples of strings — the folded form)."""
    for arg in list(node.args) + [kw.value for kw in node.keywords]:
        for sub in ast.walk(arg):
            if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
                if sub.value in AXIS_NAMES:
                    yield sub.value


@register
class MeshAxisLiteralRule(Rule):
    id = "BJX126"
    name = "mesh-axis-literal"
    description = (
        "hardcoded mesh axis name in a PartitionSpec outside the "
        "layout layer — thread the caller's data_axis/Layout instead "
        "(a literal axis silently constrains to replicated when the "
        "mesh composes differently)"
    )

    def check(self, module: ModuleContext) -> Iterator[Finding]:
        relpath = module.relpath.replace("\\", "/")
        if _EXEMPT_PREFIX in relpath or "/tests/" in relpath or (
            relpath.startswith("tests/")
        ):
            return
        for _qual, fn, _cls in module.iter_functions():
            for node in walk_shallow(fn):
                if not isinstance(node, ast.Call):
                    continue
                if not _is_partition_spec(module, node):
                    continue
                axes = sorted(set(_axis_literals(node)))
                if not axes:
                    continue
                yield self.finding(
                    module,
                    node,
                    "mesh axis name"
                    + ("s " if len(axes) > 1 else " ")
                    + ", ".join(repr(a) for a in axes)
                    + " hardcoded in a PartitionSpec — derive the spec "
                    "from the threaded data_axis/Layout "
                    "(blendjax_torch.parallel: batch_sharding/"
                    "param_sharding_rules/state_shardings) so a "
                    "composed mesh can't silently constrain this "
                    "value to replicated",
                )
