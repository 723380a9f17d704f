"""BJX115 host-materialization-in-actor-loop: card fetch of a policy or
reservoir output inside an actor hot loop.

The actor-learner split (:mod:`blendjax_torch.rl`) pins the card's work
to the LEARNER: actors step remote envs against a **host-side policy
snapshot** (host tensors the learner publishes at the ``sync_every``
cadence) and feed the reservoir through its insert — the actor step
loop itself waits on no card value, so it runs at the env layer's own
rendezvous rate whatever the card is doing. One ``.item()``, a wait
(``torch.cuda.synchronize()``, ``stream.synchronize()``,
``event.synchronize()``), or a fetch or cast of the sync vocabulary
(:mod:`~blendjax_torch.analysis.rules.driver_sync`) on a policy output
or a reservoir ``sample``/``gather``/``draw*`` result inside that loop
re-couples every env step to the card's queue — a per-step host sync
in the tightest loop in the system, exactly the regime BJX106/BJX108
guard on the driver side.

Scope: modules opting in with a ``bjx: actor-hot-path`` marker comment
(the BJX102/BJX106 mechanism), plus any module named ``actor.py``.
Within those, ``.item()`` and the waits are flagged anywhere (an actor
module has no sanctioned use for either), while fetches and casts are
flagged only when their argument traces to a policy call (a call on a
``policy``-named receiver/attribute) or a reservoir draw — env outputs
and plain host arithmetic stay unflagged, because those values never
lived on the card. The sanctioned cadence-bounded syncs (the learner's
policy snapshot copy, the reservoir's priority-mirror refresh) live in
learner/replay modules, outside this rule's scope.
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
from blendjax_torch.analysis.rules.markers import _is_actor_hot
from blendjax_torch.analysis.rules.reservoir_sync import _is_draw


def _is_policy_call(node: ast.Call, module: ModuleContext) -> bool:
    """A call whose callee names a policy: ``self.policy(...)``,
    ``policy(...)``, ``self._policy.act(...)`` — any dotted segment
    containing ``policy``."""
    dotted = module.resolve(node.func) or ""
    return any("policy" in part.lower() for part in dotted.split("."))


def _is_reservoir_draw(node: ast.Call, module: ModuleContext) -> bool:
    func = node.func
    if not isinstance(func, ast.Attribute) or not _is_draw(func.attr):
        return False
    dotted = module.resolve(func.value) or ""
    return any("reservoir" in part.lower() for part in dotted.split("."))


def _is_device_source(node: ast.AST, module: ModuleContext) -> bool:
    return isinstance(node, ast.Call) and (
        _is_policy_call(node, module) or _is_reservoir_draw(node, module)
    )


@register
class ActorLoopMaterializationRule(Rule):
    id = "BJX115"
    name = "host-materialization-in-actor-loop"
    description = (
        "host sync (.item()/synchronize()/.cpu()/np.asarray/float) of a "
        "policy or reservoir output inside an actor hot loop"
    )

    def check(self, module: ModuleContext) -> Iterator[Finding]:
        if not _is_actor_hot(module):
            return
        for qual, fn, _cls in module.iter_functions():
            yield from self._scan_function(module, fn, qual)

    def _scan_function(
        self, module: ModuleContext, fn: ast.AST, qual: str
    ) -> Iterator[Finding]:
        nodes = list(walk_shallow(fn))
        # Names bound from policy/reservoir-draw calls, keyed by first
        # assignment line (a fetch textually above the assignment reads
        # an unrelated earlier value — the BJX106/BJX108 convention).
        tainted: dict[str, int] = {}
        for node in nodes:
            if isinstance(node, ast.Assign) and _is_device_source(
                node.value, module
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
            if sync is None:
                continue
            if sync.form == ".item()":
                yield self.finding(
                    module, node,
                    f".item() in actor hot loop '{qual}' forces a "
                    "per-step card->host transfer (act from the "
                    "host-side policy snapshot instead)",
                )
                continue
            if sync.kind == "wait":
                yield self.finding(
                    module, node,
                    f"{sync.form} in actor hot loop '{qual}' couples env "
                    "stepping to the card's queue (the learner owns all "
                    "card waits)",
                )
                continue
            arg = sync.target
            nested = any(
                _is_device_source(inner, module) for inner in ast.walk(arg)
            )
            hit = sorted(
                name for name in _names(arg)
                if name in tainted
                and getattr(node, "lineno", 0) >= tainted[name]
            )
            if nested or hit:
                what = (
                    f"'{hit[0]}'" if hit
                    else "a policy/reservoir call result"
                )
                yield self.finding(
                    module, node,
                    f"{sync.form} of {what} in actor hot loop "
                    f"'{qual}' brings a card value to the host per env "
                    "step — publish a host-side policy snapshot at the "
                    "sync cadence instead",
                )
