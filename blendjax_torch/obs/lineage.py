"""Frame lineage stamps (from ``blendjax/obs/lineage.py``; so far only
:func:`strip_stamps`, which replay needs).

A publisher stamps each message with its sequence number and publish
times, and may add a telemetry snapshot and a sampled frame trace. Those
stamps describe the transport of a message and go stale on replay. The
scenario stamp (``_scenario``) describes the content and is not a stamp:
it survives replay.
"""

from __future__ import annotations

SEQ_KEY = "_seq"
PUB_WALL_KEY = "_pub_wall"
PUB_MONO_KEY = "_pub_mono"
TELEMETRY_KEY = "_telemetry"
TRACE_KEY = "_trace"

_STAMP_KEYS = (SEQ_KEY, PUB_WALL_KEY, PUB_MONO_KEY, TELEMETRY_KEY,
               TRACE_KEY)


def strip_stamps(msg: dict) -> dict:
    """Remove the lineage, telemetry and trace stamps without accounting
    them: the replay path (recorded publish times would read as hours of
    staleness, a looped replay as endless restarts)."""
    for k in _STAMP_KEYS:
        msg.pop(k, None)
    return msg


__all__ = ["strip_stamps"]
