"""BJX107 metric-name-cardinality: computed metric names in hot paths.

The metrics registry (``blendjax_torch.utils.metrics.Metrics``) keys every
counter, gauge, histogram, and span by its NAME string — there are no
labels, so the name IS the cardinality bound. A constant name is one
registry series forever; an f-string name built from a frame id, a
producer id, or a queue key mints a new series per distinct value and
silently bloats the registry (and every ``report()`` snapshot, every
Prometheus page, every JSONL line) without a single error. In a
hot-path module that bloat also buys a per-call string format.

The rule flags any call to a metrics-registry method (``count``,
``gauge``, ``gauge_max``, ``observe``, ``span``) in a hot-path module
(the same opt-in set BJX102 uses: ``pipeline.py``/``batcher.py`` by
basename, ``# bjx: hot-path`` marker otherwise) whose name argument is
not a string literal. Bounded dynamic names — e.g. one span per ingest
shard — are the sanctioned exception: suppress inline with
``# bjx: ignore[BJX107]`` and say why. Unbounded identity belongs in a
structure keyed by that identity (``blendjax_torch.obs.lineage`` keeps
per-producer histograms in its own dict), not in registry names.
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
from blendjax_torch.analysis.rules.markers import _is_hot

# Registry methods that take a metric name as their first argument.
REGISTRY_METHODS = {"count", "gauge", "gauge_max", "observe", "span"}


def _is_registry(module: ModuleContext, node: ast.expr) -> bool:
    """Does ``node`` (the attribute base of a ``x.count(...)`` call)
    look like a metrics registry? Matches the canonical global
    (``blendjax_torch.utils.metrics.metrics``, under any import alias) and
    anything duck-typed whose final component is ``metrics`` (e.g.
    ``self.metrics``)."""
    resolved = module.resolve(node)
    if resolved is None:
        return False
    return resolved == "metrics" or resolved.endswith(".metrics")


def _kind(node: ast.expr) -> str:
    if isinstance(node, ast.JoinedStr):
        return "f-string"
    if isinstance(node, ast.BinOp):
        return "string expression"
    if isinstance(node, ast.Call):
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr == "format":
            return "str.format()"
        return "call result"
    if isinstance(node, ast.Name):
        return f"variable '{node.id}'"
    return type(node).__name__


@register
class MetricNameCardinalityRule(Rule):
    id = "BJX107"
    name = "metric-name-cardinality"
    description = (
        "non-constant metric name passed to the metrics registry in a "
        "hot-path module (every distinct name mints a new registry "
        "series: unbounded label cardinality)"
    )

    def check(self, module: ModuleContext) -> Iterator[Finding]:
        if not _is_hot(module):
            return
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
                if name_arg is None:
                    continue
                if isinstance(name_arg, ast.Constant) and isinstance(
                    name_arg.value, str
                ):
                    continue
                yield self.finding(
                    module,
                    node,
                    f"non-constant metric name ({_kind(name_arg)}) passed "
                    f"to metrics.{func.attr}() in hot-path '{qual}': every "
                    "distinct name becomes a new registry series — use a "
                    "constant name, or key per-identity state in a bounded "
                    "structure (see blendjax_torch.obs.lineage)",
                )
