"""Built-in rules of the port's analyzer; importing this package
registers them."""

from __future__ import annotations

from blendjax_torch.analysis.rules import (  # noqa: F401  (registration side effects)
    axis_literals,
    concurrency,
    deserialization,
    fleet_affinity,
    inflate,
    metric_names,
    resource_leak,
    scenario_ids,
    wall_clock,
    zmq_affinity,
)
