"""Elastic producer-fleet control (port of ``blendjax/fleet``).

- :class:`~blendjax_torch.fleet.controller.FleetController`: a control
  loop that reads the stall doctor's verdict (and, optionally, a health
  probe) each tick and scales the launcher's producers between ``min``
  and ``max`` with hysteresis and cooldown (``fleet.*`` metrics, a
  bounded event log);
- the elastic membership it drives: ``ProcessLauncher.add_instance`` /
  ``retire_instance(drain=True)`` / ``respawn_instance`` and
  ``connect`` / ``disconnect`` on ``RemoteStream``, ``ShardedHostIngest``
  and ``StreamDataPipeline``;
- :class:`~blendjax_torch.fleet.admission.AdmissionServer`: a REP
  endpoint where producers on other machines announce ``{btid,
  data_addr, telemetry}`` and join the ingest set over TCP;
- :mod:`blendjax_torch.fleet.synthetic`: the synthetic producer tier (the
  port's host C++ rasterizer), rate-capped on demand so both scaling
  regimes can be reached.

Nothing here imports torch: producer processes import the synthetic tier.
"""

from __future__ import annotations

from blendjax_torch.fleet.admission import (  # noqa: F401
    AdmissionServer,
    announce,
    leave,
)
from blendjax_torch.fleet.controller import (  # noqa: F401
    FleetController,
    FleetPolicy,
)
from blendjax_torch.fleet.synthetic import (  # noqa: F401
    SYNTHETIC_PRODUCER,
    synthetic_fleet,
)

__all__ = [
    "AdmissionServer",
    "announce",
    "leave",
    "FleetController",
    "FleetPolicy",
    "SYNTHETIC_PRODUCER",
    "synthetic_fleet",
]
