"""Minimal slot/callback dispatcher (copied from
``blendjax/producer/signal.py``): ``add`` with partial argument binding,
``remove``, ``invoke``. The animation controller's lifecycle events are
signals."""

from __future__ import annotations

import functools


class Signal:
    """An observable event: handlers are invoked in registration order."""

    def __init__(self):
        self._slots: list = []

    def add(self, fn, *args, **kwargs):
        """Register ``fn`` with ``args`` / ``kwargs`` partially bound;
        returns the registered handle, for :meth:`remove`."""
        handle = functools.partial(fn, *args, **kwargs) if args or kwargs else fn
        self._slots.append(handle)
        return handle

    def remove(self, handle) -> None:
        self._slots.remove(handle)

    def clear(self) -> None:
        self._slots.clear()

    def invoke(self, *args, **kwargs) -> None:
        for slot in list(self._slots):
            slot(*args, **kwargs)

    def __len__(self) -> int:
        return len(self._slots)
