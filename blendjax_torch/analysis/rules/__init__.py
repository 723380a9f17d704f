"""Built-in rules of the port's analyzer; importing this package
registers them."""

from __future__ import annotations

from blendjax_torch.analysis.rules import (  # noqa: F401  (registration side effects)
    actor_loop,
    axis_literals,
    checkpoint_sync,
    cold_jit,
    concurrency,
    deserialization,
    donation,
    driver_sync,
    fleet_affinity,
    hotpath,
    inflate,
    mesh_placement,
    metric_names,
    purity,
    reservoir_sync,
    resource_leak,
    retrace_risk,
    scenario_ids,
    stamp_leak,
    use_after_donate,
    wall_clock,
    zmq_affinity,
)
