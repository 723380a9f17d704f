"""BJX110 fleet-thread-affinity: blocking launcher lifecycle calls on
ingest/draw hot paths.

The elastic launcher surface (``blendjax_torch.launcher.ProcessLauncher``)
is subprocess lifecycle: ``wait()`` blocks until every producer exits,
``scale_to``/``add_instance`` spawn processes and sit in a bind grace
window, ``retire_instance`` drains via SIGTERM + bounded wait, and
``assert_alive``/``poll_processes``/``respawn_instance`` take the
launcher's membership lock (behind which all of the above run). None of
that belongs on a thread whose job is to keep frames moving: a
``scale_to`` on the ingest thread stalls every producer's receive queue
for seconds, and a respawn there ties the child's lifetime to a thread
that dies with the pipeline (``launcher.py`` documents exactly this
hazard for its Linux reaper path). The sanctioned homes are the fleet
controller's own thread (``FleetController.start()``), the main thread,
or any dedicated control thread — see docs/fleet.md.

The rule flags calls to the lifecycle set on a launcher-like receiver
(a name or attribute chain whose final component is ``launcher`` or
ends in ``_launcher``) inside a hot-path module (the BJX102 opt-in set:
``pipeline.py``/``batcher.py`` by basename, ``# bjx: hot-path`` marker
otherwise). The receiver gate keeps generic ``wait()``s —
``tracker.wait()``, ``event.wait()``, ``proc.wait()`` — out of scope.
Deliberate exceptions (e.g. a bounded liveness check on a path that
only runs once the stream is ALREADY stalled) suppress inline with
``# bjx: ignore[BJX110]`` and say why.
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

# Blocking (or lock-taking, hence transitively blocking) subprocess
# lifecycle methods on the ProcessLauncher surface.
LIFECYCLE_METHODS = {
    "wait",
    "scale_to",
    "assert_alive",
    "poll_processes",
    "add_instance",
    "retire_instance",
    "respawn_instance",
}


def _is_launcher(module: ModuleContext, node: ast.expr) -> bool:
    """Does ``node`` (the attribute base of ``x.wait()``) look like a
    launcher handle? Matches ``launcher``, ``self.launcher``,
    ``pipeline.launcher``, ``blender_launcher``, ... — the repo-wide
    naming convention for ProcessLauncher instances."""
    resolved = module.resolve(node)
    if resolved is None:
        return False
    leaf = resolved.rsplit(".", 1)[-1]
    return leaf == "launcher" or leaf.endswith("_launcher")


@register
class FleetThreadAffinityRule(Rule):
    id = "BJX110"
    name = "fleet-thread-affinity"
    description = (
        "blocking launcher/subprocess lifecycle call (wait/scale_to/"
        "assert_alive/poll_processes/add_instance/retire_instance/"
        "respawn_instance) on a launcher receiver inside an ingest/draw "
        "hot-path module"
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
                    and func.attr in LIFECYCLE_METHODS
                ):
                    continue
                if not _is_launcher(module, func.value):
                    continue
                yield self.finding(
                    module,
                    node,
                    f"launcher.{func.attr}() in hot-path '{qual}' runs "
                    "subprocess lifecycle (blocking waits / the "
                    "membership lock) on a thread that should be moving "
                    "frames — drive scaling from the fleet controller's "
                    "control thread (FleetController.start()) or the "
                    "main thread instead",
                )
