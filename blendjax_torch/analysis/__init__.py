"""blendjax_torch.analysis — the port's static analyzer (``bjx-lint``),
the port of ``blendjax/analysis/``.

The streaming path's safety contract rests on invariants no runtime
test covers cheaply: pickle only behind explicit ``allow_pickle`` gates,
ZMQ sockets used only on the thread that created them, every socket and
context closed on every path, bounded metric names, monotonic durations,
no launcher lifecycle on an ingest thread, no raw inflate on the hot
path, and every attribute that threads share guarded by a common lock.
This package turns them into an AST-level gate over the port::

    python -m blendjax_torch.analysis blendjax_torch/

It imports the standard library only, so it runs anywhere, Blender's
Python included. The rules of this package are the JAX package's rules
that hold for the port unchanged:

- per file: ``BJX103`` unsafe-deserialization, ``BJX104``
  zmq-thread-affinity, ``BJX105`` socket-leak, ``BJX107``
  metric-name-cardinality, ``BJX109`` wall-clock-duration, ``BJX110``
  fleet-thread-affinity, ``BJX113`` scenario-id-cardinality, ``BJX116``
  host-inflate-in-hot-path and ``BJX126`` mesh-axis-literal;
- whole program, over one :class:`~blendjax_torch.analysis.project.
  ProjectContext` (shared AST cache, thread-spawn graph, locksets):
  ``BJX117`` unlocked-shared-mutation, ``BJX118`` lock-order-inversion
  and ``BJX119`` blocking-call-under-lock. ``--no-project`` skips them.
  The runtime complement is :mod:`blendjax_torch.testing.threadguard`
  (``BLENDJAX_THREADGUARD=1``).

The rules that need the port's own vocabulary of host syncs (BJX102,
106, 108, 111, 114, 115) and of captured steps (BJX101, 112, 120, 121,
122, 125) are not here yet (``ROADMAP.md``, Queue A item 9.2); their ids
are unknown rule ids to ``--select``.

Two flag-gated passes ride the same parse: ``--contracts`` (``BJX123``:
metric names, wire stamp keys and ``BLENDJAX_*`` env knobs
cross-checked against ``blendjax_torch/docs/``) and
``--strict-suppressions`` (``BJX124``: every suppression marker carries
its justification).

Suppress one finding with an inline ``# bjx: ignore[BJX117]`` and a
reason; the committed baseline ``blendjax_torch/analysis/baseline.json``
is empty.
"""

from __future__ import annotations

from blendjax_torch.analysis.core import (
    Finding,
    ModuleContext,
    ProjectRule,
    Rule,
    all_rules,
    analyze_modules,
    analyze_paths,
    analyze_project_modules,
    analyze_source,
    check_suppression_hygiene,
    load_baseline,
    parse_paths,
    register,
    write_baseline,
)
from blendjax_torch.analysis.contracts import check_contracts

__all__ = [
    "Finding",
    "ModuleContext",
    "ProjectRule",
    "Rule",
    "all_rules",
    "analyze_modules",
    "analyze_paths",
    "analyze_project_modules",
    "analyze_source",
    "check_contracts",
    "check_suppression_hygiene",
    "load_baseline",
    "parse_paths",
    "register",
    "write_baseline",
]
