"""Closed-loop domain randomization (port of ``blendjax/scenario``).

- :mod:`~blendjax_torch.scenario.space`: a declarative, versioned,
  pickle-free :class:`ScenarioSpace` of named scenarios over uniform,
  gaussian, categorical and mixture parameter distributions, with mixture
  weights and a compact grammar;
- :mod:`~blendjax_torch.scenario.service`: :class:`ScenarioService`
  publishes the space to every producer over PAIR duplex channels, also
  to producers that join or leave while the run goes on;
- on the producer side,
  :class:`blendjax_torch.producer.scenario.ScenarioApplicator` samples
  from the latest space, applies the draw to the scene and stamps
  ``_scenario`` into every message;
- :mod:`~blendjax_torch.scenario.accounting`: exact per-scenario row
  counts, fresh and echoed splits (an echoed row carries the scenario of
  the row that filled its slot), loss histograms and per-version counts;
- :mod:`~blendjax_torch.scenario.curriculum`: :class:`ScenarioCurriculum`
  feeds per-scenario losses back into the mixture weights and the
  Gaussian parameters, re-published on a cadence.

numpy, zmq and msgpack only until the curriculum adapts parameters
(:mod:`blendjax_torch.train.score`): producer processes import the space
and the stamp keys without torch.
"""

from __future__ import annotations

from blendjax_torch.scenario.accounting import (  # noqa: F401
    SCENARIO_KEY,
    SCENARIO_ROWS_KEY,
    ScenarioAccounting,
    accounting,
    batch_row_scenarios,
)
from blendjax_torch.scenario.curriculum import ScenarioCurriculum  # noqa: F401
from blendjax_torch.scenario.service import ScenarioService  # noqa: F401
from blendjax_torch.scenario.space import (  # noqa: F401
    Choice,
    Const,
    Dist,
    Gaussian,
    Mixture,
    Scenario,
    ScenarioSpace,
    Uniform,
)

__all__ = [
    "SCENARIO_KEY",
    "SCENARIO_ROWS_KEY",
    "ScenarioAccounting",
    "accounting",
    "batch_row_scenarios",
    "ScenarioCurriculum",
    "ScenarioService",
    "Choice",
    "Const",
    "Dist",
    "Gaussian",
    "Mixture",
    "Scenario",
    "ScenarioSpace",
    "Uniform",
]
