"""Checkpoint, resume and preemption (the port of ``blendjax/checkpoint``).

Asynchronous snapshots of the train state in the JAX package's on-disk
format (so either package restores the other's), a pickle-free session
store for the host-side run state, and SIGTERM drain-and-snapshot. numpy,
msgpack and torch only.
"""

from blendjax_torch.checkpoint.format import pack_session, unpack_session
from blendjax_torch.checkpoint.preempt import (
    PreemptionGuard,
    PreemptionRequested,
)
from blendjax_torch.checkpoint.session import (
    MESH_KEY,
    SESSION_VERSION,
    collect_session,
    gather_session,
    rank_session,
    restore_session,
)
from blendjax_torch.checkpoint.snapshot import (
    Restored,
    SnapshotManager,
    committed_steps,
)

__all__ = [
    "MESH_KEY",
    "SESSION_VERSION",
    "PreemptionGuard",
    "PreemptionRequested",
    "Restored",
    "SnapshotManager",
    "collect_session",
    "committed_steps",
    "gather_session",
    "pack_session",
    "rank_session",
    "restore_session",
    "unpack_session",
]
