"""Fleet-wide observability for mesh runs: one report across ranks (port
of ``blendjax/obs/fleetview.py``).

On a mesh every rank (one process per card) runs its own ingest, so the
doctor, lineage and trace registries each hold one rank's view:

- :func:`process_snapshot`: this rank's metrics, lineage and trace
  snapshot plus its doctor verdict, tagged with its rank in the default
  process group (``process``, ``processes``: ``(0, 1)`` without one);
- :func:`gather_fleet_snapshots`: every rank's snapshot on every rank
  (``torch.distributed.all_gather_object``; one process returns its own);
- :func:`fleet_report`: the aggregate: per-rank verdicts, lineage merged
  under ``p{rank}/{btid}`` keys, summed seq gaps and trace completions,
  and the dominant verdict.

The module imports torch only inside the gather.
"""

from __future__ import annotations

import json


def _process_info() -> tuple:
    """(rank, world size) of the default process group; (0, 1) without one
    (producer processes, a single-card run)."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank()), int(dist.get_world_size())
    except Exception:
        pass
    return 0, 1


def process_snapshot(driver: dict | None = None,
                     prefetch: int | None = None) -> dict:
    """This rank's observability snapshot, rank-tagged. ``driver`` may be
    a ``TrainDriver.stats`` dict (ring-full blocks feed the verdict);
    ``prefetch`` is the ingest queue bound."""
    from blendjax_torch.obs.doctor import diagnose_current
    from blendjax_torch.obs.lineage import lineage
    from blendjax_torch.obs.trace import tracer
    from blendjax_torch.utils.metrics import metrics

    index, count = _process_info()
    return {
        "process": index,
        "processes": count,
        "metrics": metrics.report(),
        "lineage": lineage.report(),
        "seq_gaps": lineage.total_gaps(),
        "trace": tracer.report(),
        "verdict": diagnose_current(driver=driver,
                                    prefetch=prefetch).render(),
        "driver": dict(driver) if driver else None,
    }


def gather_fleet_snapshots(snapshot: dict | None = None,
                           driver: dict | None = None,
                           prefetch: int | None = None) -> list:
    """Every rank's snapshot, in rank order, on every rank (a collective:
    every rank calls it). A pre-built ``snapshot`` is gathered instead of
    :func:`process_snapshot`. Snapshots cross as JSON text, so every rank
    gets plain values."""
    local = snapshot if snapshot is not None else process_snapshot(
        driver=driver, prefetch=prefetch)
    _, count = _process_info()
    text = json.dumps(local, default=str)
    if count <= 1:
        return [json.loads(text)]
    import torch.distributed as dist

    out = [None] * count
    dist.all_gather_object(out, text)
    return [json.loads(t) for t in out]


def dominant_verdict(kinds):
    """The most common actionable verdict kind of ``kinds`` (one per rank,
    in rank order; not ``balanced`` or ``idle``), else the most common;
    ties go to the first seen. ``None`` when there is none."""
    counts: dict = {}
    for kind in kinds:
        if kind:
            counts[kind] = counts.get(kind, 0) + 1
    actionable = {k: n for k, n in counts.items()
                  if k not in ("balanced", "idle")}
    pool = actionable or counts
    return max(pool, key=pool.get) if pool else None


def fleet_report(snapshots: list) -> dict:
    """Aggregate per-rank snapshots into one fleet view: lineage entries
    re-keyed ``p{rank}/{btid}`` (never merged by btid), gap and trace
    counters summed, verdicts per rank with a ``dominant`` pick (the most
    common actionable kind, else the most common)."""
    lineage: dict = {}
    verdicts: dict = {}
    seq_gaps = 0
    trace_completed = 0
    trace_unordered = 0
    for snap in snapshots:
        p = int(snap.get("process", 0))
        for btid, entry in (snap.get("lineage") or {}).items():
            lineage[f"p{p}/{btid}"] = entry
        seq_gaps += int(snap.get("seq_gaps") or 0)
        tr = snap.get("trace") or {}
        trace_completed += int(tr.get("completed") or 0)
        trace_unordered += int(tr.get("unordered") or 0)
        verdicts[f"p{p}"] = snap.get("verdict")
    dominant = dominant_verdict(
        v.split("—")[0].removeprefix("doctor:").strip()
        for v in verdicts.values() if v)
    return {
        "processes": len(snapshots),
        "verdicts": verdicts,
        "dominant_verdict": dominant,
        "lineage": lineage,
        "seq_gaps": seq_gaps,
        "trace_completed": trace_completed,
        "trace_unordered": trace_unordered,
    }


__all__ = ["dominant_verdict", "fleet_report", "gather_fleet_snapshots",
           "process_snapshot"]
