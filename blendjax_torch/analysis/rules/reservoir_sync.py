"""BJX108 reservoir-host-materialization: host fetch of reservoir
contents in a driver hot path.

The port's reservoirs — the echo ring ``SampleReservoir``
(``blendjax_torch/data/echo.py``) and the RL ring
``TrajectoryReservoir`` (``blendjax_torch/rl/replay.py``) — exist so a
producer-bound pipeline can emit batches at the STEP rate with no host
round trip: ``insert`` writes the ring on the card in place,
``sample``/``gather``/``draw*`` read it there (inside the captured step
for a draw token), and all echo accounting (budgets, ages,
fresh-vs-echoed counters) runs against the HOST-chosen index vector —
never against the card's values. One fetch or cast of the sync
vocabulary (:mod:`~blendjax_torch.analysis.rules.driver_sync`:
``.item()``, ``.cpu()``, ``.numpy()``, ``.tolist()``, ``float()``,
``np.asarray()``, ...) on what a reservoir ``sample``/``insert``/
``gather``/``draw*`` call returns re-serializes the whole loop on a
card fetch per step.

Scope matches BJX106: modules opting in with the ``bjx:
driver-hot-path`` marker comment (plus any ``driver.py``). Reservoir
calls are recognized two ways — by receiver name (any dotted segment
containing ``reservoir``, e.g. ``self.reservoir.sample(...)``) and by
dataflow from a ``SampleReservoir(...)``/``TrajectoryReservoir(...)``
construction in the same function. Both the direct-nesting form
(``res.sample(idx).cpu()``) and the assign-then-fetch form are flagged;
host operations on independently HOST-chosen indices (the sanctioned
accounting pattern) are not, because those values never came from a
reservoir call.
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
from blendjax_torch.analysis.rules.driver_sync import _names, sync_call
from blendjax_torch.analysis.rules.markers import _is_driver_hot

RESERVOIR_METHODS = {"sample", "insert", "gather"}
RESERVOIR_CONSTRUCTORS = ("SampleReservoir", "TrajectoryReservoir")


def _is_draw(attr: str) -> bool:
    return attr in RESERVOIR_METHODS or attr.startswith("draw")


def _receiver_is_reservoir(
    node: ast.Call, reservoir_names: set[str], module: ModuleContext
) -> bool:
    """True when ``node`` is a ``sample``/``insert``/``gather``/``draw*``
    call on something that looks like a reservoir."""
    func = node.func
    if not isinstance(func, ast.Attribute) or not _is_draw(func.attr):
        return False
    recv = func.value
    dotted = module.resolve(recv) or ""
    if any("reservoir" in part.lower() for part in dotted.split(".")):
        return True
    return bool(_names(recv) & reservoir_names)


@register
class ReservoirHostMaterializationRule(Rule):
    id = "BJX108"
    name = "reservoir-host-materialization"
    description = (
        "host fetch (.cpu()/.numpy()/.item()/float()/np.asarray) of a "
        "reservoir sample/insert/gather/draw result in a driver hot path"
    )

    def check(self, module: ModuleContext) -> Iterator[Finding]:
        if not _is_driver_hot(module):
            return
        for qual, fn, _cls in module.iter_functions():
            yield from self._scan_function(module, fn, qual)

    def _scan_function(
        self, module: ModuleContext, fn: ast.AST, qual: str
    ) -> Iterator[Finding]:
        nodes = list(walk_shallow(fn))
        # Names bound from reservoir constructions extend the receiver
        # heuristic to arbitrarily-named locals.
        reservoir_names: set[str] = set()
        for node in nodes:
            if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call
            ):
                resolved = module.resolve(node.value.func) or ""
                if resolved.endswith(RESERVOIR_CONSTRUCTORS):
                    for target in node.targets:
                        reservoir_names |= _names(target)
        # Names bound from reservoir calls, keyed by first-assignment
        # line (a fetch above the assignment reads an unrelated earlier
        # value).
        tainted: dict[str, int] = {}
        for node in nodes:
            if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call
            ) and _receiver_is_reservoir(
                node.value, reservoir_names, module
            ):
                for target in node.targets:
                    for name in _names(target):
                        line = getattr(node, "lineno", 0)
                        if name not in tainted or line < tainted[name]:
                            tainted[name] = line
        for node in nodes:
            if not isinstance(node, ast.Call):
                continue
            sync = sync_call(node, module)
            if sync is None or sync.target is None or sync.kind == "wait":
                continue
            # direct nesting: res.sample(idx).cpu()
            nested = any(
                isinstance(inner, ast.Call)
                and _receiver_is_reservoir(inner, reservoir_names, module)
                for inner in ast.walk(sync.target)
            )
            hit = sorted(
                name for name in _names(sync.target)
                if name in tainted
                and getattr(node, "lineno", 0) >= tainted[name]
            )
            if nested or hit:
                what = (
                    f"'{hit[0]}'" if hit
                    else "a reservoir sample/insert call"
                )
                yield self.finding(
                    module,
                    node,
                    f"{sync.form} on reservoir contents ({what}) in "
                    f"driver hot path '{qual}' forces a card fetch per "
                    "draw — keep echo accounting on the host-chosen "
                    "index vector and let the batch stay on the card",
                )
