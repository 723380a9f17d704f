"""BJX109 wall-clock-duration: ``time.time()`` differences used as
durations in a hot-path module.

``time.time()`` is NOT monotonic: NTP slews and steps it (VMs routinely
jump tens of milliseconds; a step can go backwards), so a duration
computed as the difference of two wall-clock reads silently corrupts
exactly the telemetry this repo stakes its diagnosis on — a stall
doctor fed a negative ``ingest.recv`` span, an SLO watchdog breaching
on a clock step rather than a real stall. Durations must come from
``time.monotonic()`` (or ``time.perf_counter()``, the span clock).

The one legitimate wall-clock subtraction is CROSS-PROCESS math:
``now - msg["_pub_wall"]`` (lineage staleness, trace wire hops), where
wall time is the only shared clock. The rule therefore flags a
subtraction only when BOTH operands derive from *local* ``time.time()``
reads — a direct call, or a local name assigned from one in the same
function — which is precisely the ``t0 = time.time(); ...;
time.time() - t0`` duration idiom and never the wire-stamp math (one
side of that comes off the message, not a local clock read).

Checked modules: the BJX102 hot-path set (``bjx: hot-path`` marker or
the streaming basenames) plus the BJX106 driver set
(``bjx: driver-hot-path`` or ``driver.py``) — the modules whose timing
feeds the doctor/watchdog signal chain.
"""

from __future__ import annotations

import ast
from typing import Iterator

from blendjax_torch.analysis.core import (
    Finding,
    ModuleContext,
    Rule,
    register,
)
from blendjax_torch.analysis.rules.markers import _is_driver_hot, _is_hot

WALL_CLOCK = "time.time"


@register
class WallClockDurationRule(Rule):
    id = "BJX109"
    name = "wall-clock-duration"
    description = (
        "difference of two local time.time() reads used as a duration "
        "in a hot-path/driver-hot-path module (wall clock steps under "
        "NTP — use time.monotonic())"
    )

    def check(self, module: ModuleContext) -> Iterator[Finding]:
        if not (_is_hot(module) or _is_driver_hot(module)):
            return
        for qual, fn, _cls in module.iter_functions():
            yield from self._scan(module, fn, qual)

    def _scan(
        self, module: ModuleContext, fn: ast.AST, qual: str
    ) -> Iterator[Finding]:
        # Local names bound (directly) to a time.time() read, keyed by
        # first assignment line: `t0 = time.time()` taints t0.
        wall: dict[str, int] = {}
        for node in ast.walk(fn):
            if (
                isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)
                and module.resolve(node.value.func) == WALL_CLOCK
            ):
                for target in node.targets:
                    if isinstance(target, ast.Name):
                        line = getattr(node, "lineno", 0)
                        if (
                            target.id not in wall
                            or line < wall[target.id]
                        ):
                            wall[target.id] = line

        def derived(operand: ast.AST, at_line: int) -> bool:
            if isinstance(operand, ast.Call):
                return module.resolve(operand.func) == WALL_CLOCK
            if isinstance(operand, ast.Name):
                return operand.id in wall and at_line >= wall[operand.id]
            return False

        for node in ast.walk(fn):
            if not (
                isinstance(node, ast.BinOp)
                and isinstance(node.op, ast.Sub)
            ):
                continue
            line = getattr(node, "lineno", 0)
            if derived(node.left, line) and derived(node.right, line):
                yield self.finding(
                    module,
                    node,
                    f"wall-clock duration in hot path '{qual}': both "
                    "sides of this subtraction are local time.time() "
                    "reads — NTP steps/slews corrupt the duration; use "
                    "time.monotonic() (durations) or the span clock "
                    "time.perf_counter(). Cross-process staleness math "
                    "(one side from a wire stamp) is not affected.",
                )
