"""Test tooling of the port: the threadguard sanitizer
(:mod:`blendjax_torch.testing.threadguard`, stdlib only).

The JAX package's Blender doubles (``fake_bpy``, ``fake_gpu``,
``fake_blender``) and its ``equivalence`` helpers are not ported yet; the
port's tests use the JAX package's.
"""

from blendjax_torch.testing.threadguard import (
    LockDisciplineError,
    ThreadAffinityError,
    ThreadGuardError,
    guard,
    unguard,
)

__all__ = [
    "LockDisciplineError",
    "ThreadAffinityError",
    "ThreadGuardError",
    "guard",
    "unguard",
]
