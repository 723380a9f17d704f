"""Preemption: drain the ring and snapshot before the SIGTERM deadline
(the port's copy of ``blendjax/checkpoint/preempt.py``).

Preemptible capacity sends SIGTERM and grants a grace window before
SIGKILL. The guard's handler only sets a flag (a signal handler must not
touch the card, files or locks: the interrupted thread may hold any of
them); the :class:`~blendjax_torch.train.TrainDriver` honours the flag at
its next ``submit``, a step boundary, where it drains its ring, snapshots
synchronously and raises :class:`PreemptionRequested` for the run loop to
exit cleanly. ``kill -9`` gets no handler: the periodic snapshots
(``checkpoint_every``) and the atomic commit cover it.
"""

from __future__ import annotations

import logging
import signal
import threading

from blendjax_torch.constants import LOGGER_NAME

logger = logging.getLogger(f"{LOGGER_NAME}.checkpoint")


class PreemptionRequested(RuntimeError):
    """Raised by the driver once the preemption snapshot committed (or
    failed, which the message says): the run loop's clean exit."""


class PreemptionGuard:
    """Signal handlers that request a drain and a snapshot.

    >>> guard = PreemptionGuard(driver)        # installs SIGTERM
    >>> try:
    ...     for batch in pipeline: driver.submit(batch)
    ... except PreemptionRequested:
    ...     pass                               # the snapshot committed
    >>> guard.uninstall()

    ``driver=None`` gives a bare flag (:attr:`requested`); :meth:`attach`
    hooks a driver later. Handlers install on the main thread only
    (CPython's rule); elsewhere the guard warns and :meth:`request` still
    works. ``signals_seen`` counts the signals handled.
    """

    def __init__(self, driver=None, signals=(signal.SIGTERM,),
                 install: bool = True):
        self.signals = tuple(signals)
        self._event = threading.Event()
        self._previous: dict = {}
        self.installed = False
        self.signals_seen = 0
        if driver is not None:
            self.attach(driver)
        if install:
            self.install()

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def request(self) -> None:
        """Preempt programmatically (the signal's effect)."""
        self._event.set()

    def attach(self, driver) -> "PreemptionGuard":
        driver.preempt = self
        return self

    def _handler(self, signum, frame) -> None:
        # set a flag and count, nothing else: the drain and the snapshot
        # run on the train thread at its next step boundary
        self._event.set()
        self.signals_seen += 1

    def install(self) -> bool:
        if self.installed:
            return True
        try:
            for sig in self.signals:
                self._previous[sig] = signal.signal(sig, self._handler)
        except ValueError:
            self._previous.clear()
            logger.warning(
                "PreemptionGuard: not on the main thread; signal handlers "
                "not installed (request() still works)"
            )
            return False
        self.installed = True
        return True

    def uninstall(self) -> None:
        for sig, prev in self._previous.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, TypeError):
                pass
        self._previous.clear()
        self.installed = False

    def __enter__(self) -> "PreemptionGuard":
        return self

    def __exit__(self, *exc) -> None:
        self.uninstall()


__all__ = ["PreemptionGuard", "PreemptionRequested"]
