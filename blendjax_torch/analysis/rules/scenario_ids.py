"""BJX113 scenario-id-cardinality: scenario identity in metric names.

The scenario subsystem (:mod:`blendjax_torch.scenario`, docs/scenarios.md)
makes scenario ids a first-class identity axis: every train row is
attributed to one, curricula mint new space versions at runtime, and a
space may declare dozens of named scenarios. The metrics registry keys
series by NAME with no labels, so interpolating a scenario id into a
metric name (``metrics.count(f"scenario.{sid}.rows")``) mints one
registry series per scenario per metric — unbounded the moment ids
come from config or a remote producer instead of a declared space, and
invisible until a report/exporter page balloons.

BJX107 already rejects ALL computed metric names, but only inside
hot-path modules. Scenario accounting is different: it runs anywhere a
consumer touches batches (bench rows, examples, notebooks), and the
correct home for per-scenario state exists —
:class:`blendjax_torch.scenario.accounting.ScenarioAccounting` keeps bounded
per-id dicts exactly like frame lineage keys per-producer state by
btid. So this rule fires in EVERY module (same shape as BJX107, wider
scope, narrower trigger): a registry-method call whose name argument is
dynamic AND visibly derived from a scenario identifier — an f-string /
concatenation / ``.format()``/``%`` interpolating a variable whose name
mentions ``scenario`` (or the conventional ``sid``) — is flagged.
Dynamic names with no scenario identity in them stay BJX107's
(hot-path-only) business.
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
from blendjax_torch.analysis.rules.metric_names import (
    REGISTRY_METHODS,
    _is_registry,
)

def _is_scenario_ident(name: str | None) -> bool:
    if not name:
        return False
    leaf = name.split(".")[-1].lower()
    if leaf in ("sid", "sids"):
        return True
    return "scenario" in leaf


def _scenario_idents(expr: ast.expr) -> list:
    """Names/attributes inside ``expr`` that look like scenario ids."""
    out = []
    for node in ast.walk(expr):
        ident = None
        if isinstance(node, ast.Name):
            ident = node.id
        elif isinstance(node, ast.Attribute):
            ident = node.attr
        if ident is not None and _is_scenario_ident(ident):
            out.append(ident)
    return out


def _dynamic_parts(name_arg: ast.expr) -> list:
    """The interpolated sub-expressions of a dynamic name expression
    (f-string values, concat/``%`` operands, ``.format()`` args); empty
    for constants and shapes we don't recognize."""
    if isinstance(name_arg, ast.JoinedStr):
        return [
            v.value for v in name_arg.values
            if isinstance(v, ast.FormattedValue)
        ]
    if isinstance(name_arg, ast.BinOp) and isinstance(
        name_arg.op, (ast.Add, ast.Mod)
    ):
        return [name_arg.left, name_arg.right]
    if (
        isinstance(name_arg, ast.Call)
        and isinstance(name_arg.func, ast.Attribute)
        and name_arg.func.attr == "format"
    ):
        return list(name_arg.args) + [kw.value for kw in name_arg.keywords]
    return []


@register
class ScenarioIdCardinalityRule(Rule):
    id = "BJX113"
    name = "scenario-id-cardinality"
    description = (
        "scenario id interpolated into a metric-registry name: ids must "
        "come from a declared ScenarioSpace and live as bounded dict "
        "keys in blendjax_torch.scenario.accounting, never as registry series"
    )

    def check(self, module: ModuleContext) -> Iterator[Finding]:
        for qual, fn, _cls in module.iter_functions():
            for node in walk_shallow(fn):
                if not isinstance(node, ast.Call):
                    continue
                func = node.func
                if not (
                    isinstance(func, ast.Attribute)
                    and func.attr in REGISTRY_METHODS
                ):
                    continue
                if not _is_registry(module, func.value):
                    continue
                name_arg: ast.expr | None = None
                if node.args:
                    name_arg = node.args[0]
                else:
                    for kw in node.keywords:
                        if kw.arg == "name":
                            name_arg = kw.value
                            break
                if name_arg is None or isinstance(name_arg, ast.Constant):
                    continue
                idents = []
                for part in _dynamic_parts(name_arg):
                    idents.extend(_scenario_idents(part))
                # a bare variable name that IS the scenario id counts
                # too: metrics.count(scenario_id) has the same
                # cardinality as the f-string form
                if not idents:
                    idents = _scenario_idents(name_arg) if isinstance(
                        name_arg, (ast.Name, ast.Attribute)
                    ) else []
                if not idents:
                    continue
                yield self.finding(
                    module,
                    node,
                    f"scenario identifier {idents[0]!r} interpolated into "
                    f"a metrics.{func.attr}() name in '{qual}': every "
                    "distinct scenario id mints a new registry series — "
                    "use a constant name and key per-scenario state in "
                    "blendjax_torch.scenario.accounting's bounded dicts (the "
                    "lineage-per-btid shape)",
                )
