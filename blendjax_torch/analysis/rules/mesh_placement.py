"""BJX111 mesh-placement: per-device host loops and host
materialization of gathered tensors in mesh hot paths.

The port's mesh is one process per card (``blendjax_torch/parallel/``):
each rank places ITS rows on ITS card in one copy per field, and ranks
meet only in collectives. Two anti-patterns silently reintroduce
per-card host work that scales the host cost with the mesh size:

- a ``for``/comprehension over a device or rank enumeration
  (``range(torch.cuda.device_count())``, ``dist.get_world_size()``,
  ``mesh.devices``, a mesh's ranks) that calls ``.to(device)`` /
  ``.cuda()`` per device — N copies driven from one process, where each
  rank should place its own rows once;
- host materialization of a gathered global tensor: a fetch or cast of
  the sync vocabulary (:mod:`~blendjax_torch.analysis.rules.
  driver_sync`: ``.cpu()``, ``.numpy()``, ``.tolist()``, ``float()``,
  ``np.asarray()``, ...) on a value bound from ``gather_full`` or
  ``all_gather``, or ANY host loop over such a value (the counterpart of
  the JAX rule's ``.addressable_shards`` walk: every rank's shard
  visited from the host) — each is a card->host round trip of the
  whole mesh's data, and downstream compute on the result runs on the
  host.

Scope: modules opting in with a ``bjx: mesh-hot-path`` marker comment,
plus ``pipeline.py`` and ``mesh_driver.py`` by basename (the placement
layer and the mesh driver are always mesh-hot). Inspection/debug code
outside those modules — or a justified exception inside them — uses
``# bjx: ignore[BJX111]``.
"""

from __future__ import annotations

import ast
from typing import Iterator, Sequence

from blendjax_torch.analysis.core import (
    Finding,
    ModuleContext,
    Rule,
    register,
    walk_shallow,
)
from blendjax_torch.analysis.rules.driver_sync import _names, sync_call
from blendjax_torch.analysis.rules.hotpath import _is_placement
from blendjax_torch.analysis.rules.markers import _is_mesh_hot

DEVICE_ENUM_ATTRS = {"devices", "local_devices", "ranks"}
DEVICE_ENUM_CALLS = {"device_count", "get_world_size"}
GATHER_CALLS = {"gather_full", "all_gather", "all_gather_into_tensor"}


def _tail(module: ModuleContext, func: ast.AST) -> str:
    return (module.resolve(func) or "").split(".")[-1]


def _iterates_devices(it: ast.AST, module: ModuleContext) -> bool:
    """True when an iterator expression enumerates cards or ranks."""
    for node in ast.walk(it):
        if isinstance(node, ast.Attribute) and node.attr in DEVICE_ENUM_ATTRS:
            return True
        if isinstance(node, ast.Call) and (
            _tail(module, node.func) in DEVICE_ENUM_CALLS
        ):
            return True
    return False


def _is_gather(node: ast.AST, module: ModuleContext) -> bool:
    return isinstance(node, ast.Call) and (
        _tail(module, node.func) in GATHER_CALLS
    )


def _contains_placement(
    body_nodes: Sequence[ast.AST], module: ModuleContext
) -> ast.Call | None:
    for stmt in body_nodes:
        for node in ast.walk(stmt):
            if _is_placement(node, module):
                return node  # type: ignore[return-value]
    return None


@register
class MeshPlacementRule(Rule):
    id = "BJX111"
    name = "mesh-placement"
    description = (
        "per-device .to(device) loop or host materialization of a "
        "gathered tensor (fetch of a gather_full/all_gather result, or a "
        "host loop over one) in a mesh hot path"
    )

    def check(self, module: ModuleContext) -> Iterator[Finding]:
        if not _is_mesh_hot(module):
            return
        for qual, fn, _cls in module.iter_functions():
            yield from self._scan(module, fn, qual)

    def _scan(
        self, module: ModuleContext, fn: ast.AST, qual: str
    ) -> Iterator[Finding]:
        nodes = list(walk_shallow(fn))
        # names bound from a gather: fetching those brings every rank's
        # shard to the host
        assembled: dict[str, int] = {}
        for node in nodes:
            if isinstance(node, ast.Assign) and _is_gather(node.value, module):
                for target in node.targets:
                    for name in _names(target):
                        line = getattr(node, "lineno", 0)
                        if name not in assembled or line < assembled[name]:
                            assembled[name] = line

        def gathered(it: ast.AST, line: int) -> bool:
            return any(_is_gather(n, module) for n in ast.walk(it)) or any(
                name in assembled and line >= assembled[name]
                for name in _names(it)
            )

        for node in nodes:
            line = getattr(node, "lineno", 0)
            # per-device placement loops (statement form)
            if isinstance(node, (ast.For, ast.AsyncFor)):
                if _iterates_devices(node.iter, module):
                    put = _contains_placement(node.body, module)
                    if put is not None:
                        yield self.finding(
                            module,
                            put,
                            f"per-device placement inside a device loop "
                            f"in '{qual}': each rank places its own rows "
                            "once on its own card (one process per card)",
                        )
                if gathered(node.iter, line):
                    yield self.finding(
                        module,
                        node,
                        f"host loop over a gathered tensor in '{qual}' "
                        "walks every rank's shard from the host: "
                        "aggregate on the card, or use a process-level "
                        "report instead",
                    )
            # comprehension forms of both patterns
            if isinstance(
                node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                       ast.DictComp)
            ):
                for gen in node.generators:
                    if _iterates_devices(gen.iter, module):
                        put = _contains_placement([node], module)
                        if put is not None:
                            yield self.finding(
                                module,
                                put,
                                f"per-device placement comprehension in "
                                f"'{qual}': each rank places its own rows "
                                "once (one process per card)",
                            )
                    if gathered(gen.iter, line):
                        yield self.finding(
                            module,
                            node,
                            f"comprehension over a gathered tensor in "
                            f"'{qual}' walks every rank's shard from the "
                            "host — aggregate on the card instead",
                        )
            # host materialization of a gathered global tensor
            if isinstance(node, ast.Call):
                sync = sync_call(node, module)
                if sync is None or sync.target is None or sync.kind == "wait":
                    continue
                direct = any(
                    _is_gather(inner, module) for inner in ast.walk(sync.target)
                )
                hit = sorted(
                    name for name in _names(sync.target)
                    if name in assembled and line >= assembled[name]
                )
                if direct or hit:
                    what = f"'{hit[0]}'" if hit else "a gathered tensor"
                    yield self.finding(
                        module,
                        node,
                        f"{sync.form} on {what} in '{qual}' pulls the whole "
                        "global tensor (every rank's shard) back to the "
                        "host — keep it on the card; export metrics, not "
                        "tensors",
                    )
