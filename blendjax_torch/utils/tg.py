"""Zero-overhead indirection to the threadguard sanitizer (the port of
``blendjax/utils/tg.py``).

Modules declare their concurrency contracts by wrapping the objects the
contracts are about::

    from blendjax_torch.utils.tg import guard
    ...
    self.counters = guard({}, name="metrics.counters", lock=self._lock)

With ``BLENDJAX_THREADGUARD`` unset, ``""``, ``"0"`` or ``"false"`` (the
default, and every hot path's contract) ``guard`` is the identity
function: no proxy, no per-access cost, and
:mod:`blendjax_torch.testing.threadguard` is never imported. With any
other value (``BLENDJAX_THREADGUARD=1``) the sanitizer wraps the object
and raises :class:`~blendjax_torch.testing.threadguard.ThreadGuardError`
on any affinity or lock-discipline violation.

The switch is read ONCE at import (process start): the sanitizer changes
what attribute access means on wired objects, which is not something to
toggle mid-run. Tests that need the real ``guard`` whatever the
environment import it from ``blendjax_torch.testing.threadguard``.
"""

from __future__ import annotations

import os

if os.environ.get("BLENDJAX_THREADGUARD", "0") not in ("", "0", "false"):
    from blendjax_torch.testing.threadguard import guard
else:

    def guard(obj, **kwargs):  # noqa: ARG001 - mirror the real signature
        """Disabled sanitizer: identity (see module docstring)."""
        return obj


__all__ = ["guard"]
