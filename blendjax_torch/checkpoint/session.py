"""Session-state assembly: one versioned dict over the run's host-side
components (the port's copy of ``blendjax/checkpoint/session.py``).

The train state (parameters and optimizer moments) is half of a
resumable run; the other half is what the consumer side accumulates: the
echo reservoir's ring, slot accounting and generator states, the driver's
counters. Each component has ``state_dict() -> dict`` and
``load_state_dict(dict)`` with pickle-free values, and this module
composes them:

>>> session = collect_session(echo=echo)
>>> mgr.save_async(step, leaves, session=session)
>>> restored = mgr.restore(template)
>>> restore_session(restored.session, echo=echo)

A component's ``load_state_dict`` leaves it bitwise-continuable: the
resumed echo pipeline draws the same slots with the same augmentation as
the uninterrupted run.
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


__all__ = ["SESSION_VERSION", "collect_session", "restore_session"]
