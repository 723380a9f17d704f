"""Session-state assembly: one versioned dict over the run's host-side
components (the port's copy of ``blendjax/checkpoint/session.py``).

The train state (parameters and optimizer moments) is half of a
resumable run; the other half is what the consumer side accumulates: the
echo reservoir's ring, slot accounting, scenario stamps and generator
states, the scenario ledger and curriculum, the per-producer lineage
positions, the fleet's membership, the driver's counters. Each component
has ``state_dict() -> dict`` and ``load_state_dict(dict)`` with
pickle-free values, and this module composes them:

>>> session = collect_session(
...     echo=echo, scenario=accounting, curriculum=curriculum,
...     lineage=lineage, fleet=controller,
... )
>>> mgr.save_async(step, leaves, session=session)
>>> restored = mgr.restore(template)
>>> restore_session(restored.session, echo=echo, scenario=accounting,
...                 curriculum=curriculum, lineage=lineage,
...                 fleet=controller)

A component's ``load_state_dict`` leaves it bitwise-continuable: the
resumed echo pipeline draws the same slots with the same augmentation as
the uninterrupted run, the curriculum resumes the same evidence windows,
and the lineage reads the producers' fresh numbering as restarts.
"""

from __future__ import annotations

import time

#: Bumped when the session layout changes incompatibly;
#: :func:`restore_session` refuses documents newer than this build reads.
SESSION_VERSION = 1

_META_KEYS = ("_version", "_wall_time")


def collect_session(**components) -> dict:
    """One session dict: each named component contributes its
    ``state_dict()`` (``None`` is skipped; a plain dict passes as it is)."""
    out: dict = {"_version": SESSION_VERSION, "_wall_time": time.time()}
    for name, comp in components.items():
        if comp is None:
            continue
        out[name] = comp if isinstance(comp, dict) else comp.state_dict()
    return out


def restore_session(session: dict, strict: bool = False,
                    **components) -> list:
    """Load each named component's slice of ``session``; returns the names
    restored. A component without a saved slice is left as it is
    (``strict=True`` raises instead)."""
    version = int(session.get("_version", 0))
    if version > SESSION_VERSION:
        raise ValueError(
            f"session snapshot is version {version}; this build reads "
            f"<= {SESSION_VERSION}"
        )
    restored, missing = [], []
    for name, comp in components.items():
        if comp is None:
            continue
        if name not in session:
            missing.append(name)
            continue
        comp.load_state_dict(session[name])
        restored.append(name)
    if strict and missing:
        raise ValueError(
            f"session snapshot has no state for {missing} (present: "
            f"{sorted(k for k in session if k not in _META_KEYS)})"
        )
    return restored


#: The key under which a mesh snapshot keeps the sessions of ranks 1..N-1
#: (rank 0's components stay where a one-card session puts them, so a
#: one-card resume and either package's ``restore_session`` read them
#: unchanged and pass this key by).
MESH_KEY = "mesh"

#: Session slices every rank shares (the driver's counters: each rank of a
#: mesh steps in step with the others), kept once, at the top.
SHARED_KEYS = ("driver",) + _META_KEYS


def _host(obj):
    """``obj`` with every tensor copied to a host array (before it crosses
    a gloo gather, so no rank unpickles another's card tensor)."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(v) for v in obj)
    return obj


def gather_session(session: dict, agreement) -> dict | None:
    """A mesh snapshot's session (a collective: every rank calls it at the
    same step, with the :class:`~blendjax_torch.parallel.mesh.StepAgreement`
    its steps share). Rank 0 gets its own ``session`` with the other ranks'
    under :data:`MESH_KEY` (``{"world_size": N, "ranks": [rank 1's, ...]}``,
    without the shared slices); the others get ``None`` (rank 0 writes)."""
    sessions = agreement.gather_objects(_host(session))
    if agreement.rank != agreement.ranks[0]:
        return None
    merged = dict(sessions[0])
    merged[MESH_KEY] = {
        "world_size": len(sessions),
        "ranks": [{k: v for k, v in s.items() if k not in SHARED_KEYS}
                  for s in sessions[1:]],
    }
    return merged


def rank_session(session: dict, rank: int) -> tuple:
    """This rank's slice of a (mesh or one-card) snapshot's ``session``:
    ``(slice, world_size)``. Rank 0 takes the top level (without the
    :data:`MESH_KEY`); rank ``r`` takes the saved rank ``r``'s components
    with the shared slices beside them, or the shared slices alone when the
    saved run had no rank ``r`` (its components then start fresh)."""
    saved = session.get(MESH_KEY) or {}
    world = int(saved.get("world_size", 1))
    shared = {k: v for k, v in session.items() if k in SHARED_KEYS}
    if rank == 0:
        return {k: v for k, v in session.items() if k != MESH_KEY}, world
    ranks = saved.get("ranks") or []
    if rank - 1 < len(ranks):
        return {**ranks[rank - 1], **shared}, world
    return shared, world


__all__ = ["MESH_KEY", "SESSION_VERSION", "SHARED_KEYS", "collect_session",
           "gather_session", "rank_session", "restore_session"]
