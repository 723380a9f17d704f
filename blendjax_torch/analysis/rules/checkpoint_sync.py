"""BJX114 checkpoint-in-hot-path: synchronous checkpoint IO on a
driver hot path.

The port's checkpoint subsystem (``blendjax_torch.checkpoint``) is
built so a snapshot never blocks a step dispatch: ``save_async`` clones
the state's tensors on the replay's stream and returns, and the
card->host copies and file writes run on the ``SnapshotManager``'s own
thread. One synchronous ``save()`` / ``wait()`` / ``restore()`` /
``wait_until_finished()`` on a checkpoint manager inside the dispatch
loop re-serializes training on disk latency — tens of milliseconds to
seconds per snapshot, exactly the stall the async design exists to
avoid.

Scope matches BJX106/BJX108: modules opting in with the ``bjx:
driver-hot-path`` marker (plus any ``driver.py``). Checkpoint-manager
calls are recognized two ways — by receiver name (any dotted segment
containing ``checkpoint`` or ``ckpt``, e.g. ``self.checkpoint.wait()``)
and by dataflow from a ``SnapshotManager(...)`` /
``CheckpointManager(...)`` construction in the same function.
``save_async``/``request_checkpoint``/``latest_step`` are not flagged.
The sanctioned synchronous points — the preemption flush and the
teardown ``checkpoint_now`` in ``blendjax_torch/train/driver.py``, where
the process is exiting — carry inline ``# bjx: ignore[BJX114]``
suppressions with their justification.
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
from blendjax_torch.analysis.rules.driver_sync import _names
from blendjax_torch.analysis.rules.markers import _is_driver_hot

SYNC_METHODS = {"save", "wait", "restore", "wait_until_finished"}
MANAGER_CONSTRUCTORS = ("SnapshotManager", "CheckpointManager")
RECEIVER_MARKERS = ("checkpoint", "ckpt")


def _receiver_is_checkpoint(
    node: ast.Call, manager_names: set[str], module: ModuleContext
) -> bool:
    """True when ``node`` is a synchronous checkpoint-manager call."""
    func = node.func
    if not isinstance(func, ast.Attribute):
        return False
    if func.attr not in SYNC_METHODS:
        return False
    recv = func.value
    dotted = module.resolve(recv) or ""
    if any(
        marker in part.lower()
        for part in dotted.split(".")
        for marker in RECEIVER_MARKERS
    ):
        return True
    return bool(_names(recv) & manager_names)


@register
class CheckpointSyncRule(Rule):
    id = "BJX114"
    name = "checkpoint-in-hot-path"
    description = (
        "synchronous checkpoint save()/wait()/restore() on a "
        "checkpoint-like receiver in a driver hot path"
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
        manager_names: set[str] = set()
        for node in nodes:
            if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call
            ):
                resolved = module.resolve(node.value.func) or ""
                if resolved.endswith(MANAGER_CONSTRUCTORS):
                    for target in node.targets:
                        manager_names |= _names(target)
        for node in nodes:
            if not isinstance(node, ast.Call):
                continue
            if not _receiver_is_checkpoint(node, manager_names, module):
                continue
            attr = node.func.attr  # type: ignore[union-attr]
            yield self.finding(
                module,
                node,
                f"synchronous checkpoint {attr}() in driver hot path "
                f"'{qual}' blocks the dispatch loop on disk IO — use "
                "save_async()/request_checkpoint() (the "
                "SnapshotManager writer thread owns the card->host "
                "copies and file writes); sanctioned sync points "
                "(preemption flush, teardown) suppress inline with "
                "justification",
            )
