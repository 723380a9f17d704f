"""Dispatch-ahead train driver (port of ``blendjax/train/driver.py``).

Keeps up to ``inflight`` steps queued on the card. After each step the
driver records a CUDA event; finished entries retire through a
non-blocking ``event.query()``, and the host blocks (on the oldest entry
only) when the ring is full of unfinished steps. A loss value is fetched
to the host only every ``sync_every`` steps and at :meth:`drain`. On the
CPU there are no events: every step is complete when it returns.

Stats (:attr:`stats`): ``steps``, ``dispatches`` (step calls),
``inflight_hwm`` (ring high-water mark), ``host_blocks`` (genuine
ring-full waits) and ``syncs`` (loss fetches). Checkpointing, AOT warm
starts, the device ledger and the MFU gauge wait for later slices.
"""

from __future__ import annotations

import collections

import torch


class TrainDriver:
    """Wraps ``step(state, batch) -> (state, {"loss": tensor})``."""

    def __init__(self, step, state, inflight: int = 4, sync_every: int = 32,
                 pad_partial: bool = True, buckets=None):
        self.step = step
        self.state = state
        self.inflight = max(1, int(inflight))
        self.sync_every = max(0, int(sync_every or 0))
        self.pad_partial = bool(pad_partial)
        self.buckets = buckets
        # ring entries: (loss tensor, completion event or None)
        self._pending: collections.deque = collections.deque()
        self.losses: list = []
        self.steps = 0
        self.dispatches = 0
        self.inflight_hwm = 0
        self.host_blocks = 0

    @staticmethod
    def _is_done(entry) -> bool:
        event = entry[1]
        return event is None or event.query()

    def _block_oldest(self) -> None:
        entry = self._pending.popleft()
        if not self._is_done(entry):
            self.host_blocks += 1
            entry[1].synchronize()

    def _sync_oldest(self) -> None:
        """Periodic loss fetch: the oldest in-flight loss blocks least."""
        if self._pending:
            loss, _event = self._pending.popleft()
            self.losses.append(float(loss.reshape(-1)[-1]))

    def ensure_ring_slot(self) -> None:
        """Retire finished entries; block on the oldest while the ring is
        full."""
        pending = self._pending
        while pending and self._is_done(pending[0]):
            pending.popleft()
        while len(pending) >= self.inflight:
            self._block_oldest()

    def submit(self, batch) -> None:
        """Queue one step without waiting for its result."""
        if self.pad_partial and batch.get("_partial") and "_mask" not in batch:
            from blendjax_torch.data.batcher import pad_to_bucket

            batch = pad_to_bucket(batch, buckets=self.buckets)
        self.ensure_ring_slot()
        self.state, m = self.step(self.state, batch)
        loss = m["loss"]
        event = None
        if loss.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(loss.device))
        self.dispatches += 1
        self.steps += 1
        self._pending.append((loss, event))
        self.inflight_hwm = max(self.inflight_hwm, len(self._pending))
        if self.sync_every and self.steps % self.sync_every == 0:
            self._sync_oldest()

    def drain(self):
        """Wait for every queued step and return the newest loss."""
        if not self._pending:
            return self.losses[-1] if self.losses else None
        val = float(self._pending[-1][0].reshape(-1)[-1])
        self._pending.clear()  # the fetch waited for every older step
        self.losses.append(val)
        return val

    def finish(self):
        """Drain and return ``(state, final_loss)``."""
        return self.state, self.drain()

    def run(self, batches, max_steps: int | None = None):
        """Drive a batch iterable; returns ``(state, final_loss)``."""
        for batch in batches:
            self.submit(batch)
            if max_steps is not None and self.steps >= max_steps:
                break
        return self.finish()

    @property
    def stats(self) -> dict:
        return {
            "steps": self.steps,
            "dispatches": self.dispatches,
            "inflight": self.inflight,
            "inflight_hwm": self.inflight_hwm,
            "host_blocks": self.host_blocks,
            "syncs": len(self.losses),
        }
