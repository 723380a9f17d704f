"""Test tooling of the port: the Blender doubles, the threadguard
sanitizer, the equivalence scaffold and the donation audit.

- :func:`install_fake_bpy` registers stub ``bpy``/``gpu`` modules
  (:mod:`~blendjax_torch.testing.fake_bpy`,
  :mod:`~blendjax_torch.testing.fake_gpu`) with the API surface the
  port's producer runtime uses, so ``blendjax_torch.producer`` and any
  ``*.blend.py`` scene script run in plain CPython.
- ``python -m blendjax_torch.testing.fake_blender`` emulates the Blender
  CLI on those stubs; :func:`write_fake_blender` writes a ``blender``
  wrapper that runs it, for ``discover_blender`` and ``BlenderLauncher``.
- :mod:`~blendjax_torch.testing.threadguard`: the runtime thread-affinity
  and lock-discipline sanitizer (standard library only).
- :mod:`~blendjax_torch.testing.equivalence` and
  :class:`DonationAudit` (:mod:`~blendjax_torch.testing.donation`) import
  ``torch``, so they load lazily: the doubles must stay importable in
  Blender's Python, which has no torch.

The doubles and the sanitizer import neither ``torch`` nor the JAX
package. ``fake_blender`` loads lazily too, so that ``python -m`` runs it
as a module that was not imported yet.
"""

from blendjax_torch.testing.fake_bpy import install as install_fake_bpy
from blendjax_torch.testing.fake_bpy import reset as reset_fake_bpy
from blendjax_torch.testing.threadguard import (
    LockDisciplineError,
    ThreadAffinityError,
    ThreadGuardError,
    guard,
    unguard,
)

__all__ = [
    "DonationAudit",
    "LockDisciplineError",
    "ThreadAffinityError",
    "ThreadGuardError",
    "guard",
    "install_fake_bpy",
    "reset_fake_bpy",
    "unguard",
    "write_fake_blender",
]


def __getattr__(name):
    if name == "write_fake_blender":
        from blendjax_torch.testing.fake_blender import write_fake_blender

        return write_fake_blender
    if name == "DonationAudit":
        from blendjax_torch.testing.donation import DonationAudit

        return DonationAudit
    raise AttributeError(name)
