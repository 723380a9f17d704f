"""RL bottleneck doctor: env-bound against learner-bound (port of
``blendjax/rl/doctor.py``).

The actor-learner stack's verdicts, decided by the reservoir's fill rate
against the learner's sample waits:

===============  ==========================================================
verdict          evidence
===============  ==========================================================
env-bound        the learner waited on the reservoir for a meaningful
                 fraction of its draws (``rl.sample_waits`` against
                 ``rl.draws``): the actors cannot keep up. Lever: more env
                 producers.
learner-bound    no sample waits while the actors insert ``surplus`` times
                 more transitions than the learner draws: fresh
                 transitions are overwritten undrawn. Lever: fewer
                 producers or a faster learner step.
rl-balanced      neither side dominates: replay absorbs the rate gap.
rl-idle          no ``rl.*`` evidence yet.
===============  ==========================================================

:func:`diagnose_rl` is pure over a plain ``Metrics.report()`` dict and
returns the pipeline doctor's :class:`~blendjax_torch.obs.doctor.Verdict`.
A fleet controller scales env producers on these verdicts:
``FleetController(diagnose=diagnose_rl_current, policy=FleetPolicy.rl())``
(:mod:`blendjax_torch.fleet`).
"""

from __future__ import annotations

from blendjax_torch.obs.doctor import Verdict
from blendjax_torch.utils.metrics import metrics

#: Verdict kinds, in the order the decision procedure tests them.
RL_VERDICTS = ("env-bound", "learner-bound", "rl-balanced", "rl-idle")

#: Insert/draw surplus above which a wait-free run reads learner-bound:
#: actors producing this many times more transitions than the learner
#: consumes means fresh data dies undrawn in the ring.
DEFAULT_SURPLUS = 1.5

#: Fraction of learner draws that blocked on the reservoir above which
#: the run reads env-bound. Every run starts with one warmup wait at
#: min_fill, so the signal must DILUTE as healthy draws accumulate —
#: a bare ``waits > 0`` test would ratchet the fleet to max_instances
#: off that single wait and never let it scale back down.
DEFAULT_WAIT_FRACTION = 0.05


def diagnose_rl(report: dict, surplus: float = DEFAULT_SURPLUS,
                wait_fraction: float = DEFAULT_WAIT_FRACTION,
                min_evidence: int = 1) -> Verdict:
    """Classify one metrics snapshot of an actor-learner run."""
    counters = report.get("counters", {})
    spans = report.get("spans", {})
    inserted = int(counters.get("rl.transitions", 0))
    drawn = int(counters.get("rl.fresh", 0)) + int(
        counters.get("rl.replayed", 0)
    )
    draws = int(counters.get("rl.draws", 0))
    waits = int(counters.get("rl.sample_waits", 0))
    frac = waits / max(draws, 1)
    shares = {
        "inserted": inserted,
        "drawn": drawn,
        "draws": draws,
        "sample_waits": waits,
        "wait_fraction": round(frac, 4),
        "sample_wait_ms": round(
            spans.get("rl.sample_wait", {}).get("total_ms", 0.0), 1
        ),
    }
    if inserted < min_evidence and drawn < min_evidence:
        return Verdict(
            "rl-idle", "no rl.* transition or draw evidence yet",
            "start the actors/learner (or wait for warmup)", shares,
        )
    if waits > 0 and (frac >= wait_fraction or draws == 0):
        return Verdict(
            "env-bound",
            f"the learner blocked on the reservoir {waits}x "
            f"({frac:.1%} of {draws} draws, "
            f"{shares['sample_wait_ms']}ms total) — "
            f"{inserted} transitions inserted vs {drawn} drawn",
            "scale UP env producers (fleet) or raise actor throughput",
            shares,
        )
    if drawn and inserted > drawn * surplus:
        return Verdict(
            "learner-bound",
            f"actors inserted {inserted} transitions while the learner "
            f"drew {drawn} (> {surplus}x surplus, zero sample waits) — "
            "fresh transitions are overwritten before first use",
            "scale DOWN env producers or speed up the learner step",
            shares,
        )
    return Verdict(
        "rl-balanced",
        f"{inserted} inserted / {drawn} drawn with zero sample waits — "
        "replay absorbs the rate gap",
        "no action needed", shares,
    )


def diagnose_rl_current(**kwargs) -> Verdict:
    """:func:`diagnose_rl` over the process-wide metrics registry —
    the ``diagnose=`` hook a fleet controller takes."""
    return diagnose_rl(metrics.report(), **kwargs)


__all__ = [
    "DEFAULT_SURPLUS",
    "RL_VERDICTS",
    "diagnose_rl",
    "diagnose_rl_current",
]
