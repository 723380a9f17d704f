"""blendjax_torch.analysis — the port's static analyzer (``bjx-lint``),
the port of ``blendjax/analysis/``.

The port's performance and safety contract rests on invariants no
runtime test covers cheaply: no host side effect inside a captured step,
no host sync inside the streaming and driver hot loops, captured state
written in place and never read through a stale view, bounded graph
signatures, pickle only behind explicit ``allow_pickle`` gates, ZMQ
sockets used only on the thread that created them, every socket and
context closed on every path, bounded metric names, monotonic
durations, and every attribute that threads share guarded by a common
lock. This package turns them into an AST-level gate over the port::

    python -m blendjax_torch.analysis blendjax_torch/

It imports the standard library only, so it runs anywhere, Blender's
Python included. It registers the JAX analyzer's rule ids
(``blendjax_torch/docs/static-analysis.md``):

- per file: ``BJX101`` capture-purity, ``BJX102``
  host-sync-in-hot-path, ``BJX103`` unsafe-deserialization, ``BJX104``
  zmq-thread-affinity, ``BJX105`` socket-leak, ``BJX106``
  sync-on-inflight-step, ``BJX107`` metric-name-cardinality, ``BJX108``
  reservoir-host-materialization, ``BJX109`` wall-clock-duration,
  ``BJX110`` fleet-thread-affinity, ``BJX111`` mesh-placement,
  ``BJX112`` state-rebound-in-captured-step, ``BJX113``
  scenario-id-cardinality, ``BJX114`` checkpoint-in-hot-path, ``BJX115``
  host-materialization-in-actor-loop, ``BJX116``
  host-inflate-in-hot-path, ``BJX125`` cold-capture-in-hot-loop and
  ``BJX126`` mesh-axis-literal;
- whole program, over one :class:`~blendjax_torch.analysis.project.
  ProjectContext` (shared AST cache, thread-spawn graph, locksets and
  the value-provenance dataflow layer): ``BJX117``
  unlocked-shared-mutation, ``BJX118`` lock-order-inversion, ``BJX119``
  blocking-call-under-lock, and the captured-step dataflow rules
  ``BJX120`` stamp-leak-into-capture, ``BJX121`` stale-alias-after-capture
  and ``BJX122`` recapture-risk. ``--no-project`` skips them. The runtime
  complements are :mod:`blendjax_torch.testing.threadguard`
  (``BLENDJAX_THREADGUARD=1``), :mod:`blendjax_torch.testing.donation`
  and ``chip_smoke.py``'s sync census.

The rules on host syncs and captured steps are ported by meaning: the
sync vocabulary (``.item()``, ``.cpu()``, ``float()`` of a tensor,
``torch.cuda.synchronize()``, stream and event waits) lives in
:mod:`~blendjax_torch.analysis.rules.driver_sync`, and a captured
callable (``CapturedStep``, ``build_aot_step``,
``make_graphed_callables``) stands where the JAX rules read ``jax.jit``.

Two flag-gated passes ride the same parse: ``--contracts`` (``BJX123``:
metric names, wire stamp keys and ``BLENDJAX_*`` env knobs
cross-checked against ``blendjax_torch/docs/``) and
``--strict-suppressions`` (``BJX124``: every suppression marker carries
its justification).

Suppress one finding with an inline ``# bjx: ignore[BJX117]`` and a
reason; the committed baseline ``blendjax_torch/analysis/baseline.json``
holds one entry, the counterpart of the JAX package's one.
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
