"""Dispatch-ahead train driver (port of ``blendjax/train/driver.py``).

Keeps up to ``inflight`` steps queued on the card. After each step the
driver records a CUDA event; finished entries retire through a
non-blocking ``event.query()``, and the host blocks (on the oldest entry
only) when the ring is full of unfinished steps. A loss value is fetched
to the host only every ``sync_every`` steps and at :meth:`drain`. On the
CPU there are no events: every step is complete when it returns.

Stats (:attr:`stats`): ``steps``, ``dispatches`` (step calls),
``inflight_hwm`` (ring high-water mark), ``host_blocks`` (genuine
ring-full waits), ``syncs`` (loss fetches), ``images_retired`` (images of
retired steps, counted as the JAX driver's ``_batch_images`` counts
them), ``startup_ms`` (:meth:`build`'s wall time), ``time_to_first_step_ms``
(construction, or :meth:`build`'s entry, to the first retired step),
``mfu`` (retired images/s x ``flops_per_image`` / ``peak_flops`` over the
run, first dispatch to last retirement) and, from a captured step
(:mod:`blendjax_torch.train.aot`), ``aot_fallbacks``, ``graph_replays``
and ``signatures``. Checkpointing, resume and the cost-model FLOPs wait
for later slices; the port has no metrics registry yet.
"""

from __future__ import annotations

import collections
import time

import torch

#: Known peak dense bf16 FLOP/s, matched by substring against the card's
#: name (NVIDIA data sheets; first match wins, the specific names first).
KNOWN_PEAK_FLOPS = (
    ("h100 pcie", 756e12),
    ("h100", 989e12),  # the SXM part
    ("h200", 989e12),
    ("a100", 312e12),
)


def default_peak_flops(device_name: str | None = None) -> float | None:
    """The card's peak dense bf16 FLOP/s from :data:`KNOWN_PEAK_FLOPS`
    (``None`` for an unknown card or no card)."""
    if device_name is None:
        if not torch.cuda.is_available():
            return None
        device_name = torch.cuda.get_device_name(0)
    name = device_name.lower()
    return next((peak for sub, peak in KNOWN_PEAK_FLOPS if sub in name), None)


class TrainDriver:
    """Wraps ``step(state, batch) -> (state, {"loss": tensor})``.

    ``place`` (e.g. ``pipeline.feeder.place`` with
    ``StreamDataPipeline(place_in_driver=True)``) takes each host batch to
    the card right before its step, once a ring slot is free, so the copy
    overlaps the steps in flight. ``flops_per_image`` and ``peak_flops``
    feed ``stats["mfu"]``; ``peak_flops`` defaults from the card's name."""

    def __init__(self, step, state, inflight: int = 4, sync_every: int = 32,
                 pad_partial: bool = True, buckets=None,
                 flops_per_image: float | None = None,
                 peak_flops: float | None = None, place=None):
        self.step = step
        self.state = state
        self.inflight = max(1, int(inflight))
        self.sync_every = max(0, int(sync_every or 0))
        self.pad_partial = bool(pad_partial)
        self.buckets = buckets
        self.place = place
        self.flops_per_image = (float(flops_per_image) if flops_per_image
                                else None)
        self.peak_flops = float(peak_flops) if peak_flops else None
        if self.flops_per_image and not self.peak_flops:
            self.peak_flops = default_peak_flops()
        # ring entries: (loss tensor, completion event or None, images)
        self._pending: collections.deque = collections.deque()
        self.losses: list = []
        self.steps = 0
        self.dispatches = 0
        self.inflight_hwm = 0
        self.host_blocks = 0
        self.images_retired = 0
        self.startup_ms: float | None = None
        self._t_created = time.monotonic()
        self._t_first_dispatch: float | None = None
        self._t_first_retire: float | None = None
        self._t_last_retire: float | None = None

    @classmethod
    def build(cls, model, example_batch, *, loss_fn=None, optimizer=None,
              learning_rate: float = 1e-3, augment=None, augment_rng=None,
              precision=None, aot: bool = True,
              aot_cache_dir: str | None = None, device=None,
              **driver_kwargs):
        """Model -> ready driver, with the step captured per ladder shape.

        ``make_train_state`` (on ``device``: ``cuda`` unless ``"cpu"``),
        ``make_supervised_step`` with ``loss_fn``, ``augment``,
        ``augment_rng`` and ``precision``, then, with ``aot``,
        :func:`blendjax_torch.train.aot.build_aot_step` captures one graph
        for every bucket-ladder shape of ``example_batch`` before step 0
        (behind the keyed manifest in ``aot_cache_dir`` when given). The
        build's wall time lands on ``startup_ms``, and
        ``time_to_first_step_ms`` counts from the build's entry.
        ``resume`` and the cost-model FLOPs wait for later slices."""
        from blendjax_torch.train.steps import (
            make_supervised_step,
            make_train_state,
        )

        t0 = time.monotonic()
        if not isinstance(example_batch, dict) or "image" not in example_batch:
            raise TypeError(
                "build() needs a full example batch dict (at least 'image' "
                "and the loss's fields) to derive the capture ladder"
            )
        state = make_train_state(model, optimizer=optimizer,
                                 learning_rate=learning_rate, device=device)
        step = make_supervised_step(loss_fn=loss_fn, augment=augment,
                                    augment_rng=augment_rng,
                                    precision=precision)
        if aot:
            from blendjax_torch.train.aot import build_aot_step, cache_key

            buckets = driver_kwargs.get("buckets")
            step = build_aot_step(
                step, state, example_batch, buckets=buckets,
                cache_dir=aot_cache_dir,
                key=cache_key(model=model, precision=precision,
                              buckets=buckets) if aot_cache_dir else None,
            )
        drv = cls(step, state, **driver_kwargs)
        drv._t_created = t0  # the cold-start clock starts at build entry
        drv.startup_ms = (time.monotonic() - t0) * 1e3
        return drv

    @staticmethod
    def _batch_images(batch) -> int:
        """Images this batch trains on: a draw token's index count, a
        packed group's K' x the per-batch lead of ``_spec`` (its ``xy``
        field's, else the largest), K x B of a (K, B, H, W, C) image, else
        the leading dim. Shape reads only."""
        idx = batch.get("_echo_idx")
        if idx is None:
            idx = batch.get("_rl_idx")
        if idx is not None:
            return int(len(idx))
        packed = batch.get("_packed")
        if packed is not None:
            spec = batch.get("_spec") or ()
            lead = next((s[0] for n, _d, s, *_r in spec if n == "xy"), None)
            if lead is None:
                lead = max((s[0] for _n, _d, s, *_r in spec if s), default=1)
            return int(packed.shape[0]) * int(lead)
        img = batch.get("image")
        if img is not None and getattr(img, "ndim", 0) >= 4:
            shp = img.shape
            return int(shp[0] * shp[1]) if img.ndim >= 5 else int(shp[0])
        return int(next((v.shape[0] for k, v in batch.items()
                         if not k.startswith("_")
                         and getattr(v, "ndim", 0) >= 1), 0))

    @staticmethod
    def _is_done(entry) -> bool:
        event = entry[1]
        return event is None or event.query()

    def _retire(self, entry) -> None:
        now = time.monotonic()
        if self._t_first_retire is None:
            self._t_first_retire = now
        self._t_last_retire = now
        self.images_retired += entry[2]

    def _block_oldest(self) -> None:
        entry = self._pending.popleft()
        if not self._is_done(entry):
            self.host_blocks += 1
            entry[1].synchronize()
        self._retire(entry)

    def _sync_oldest(self) -> None:
        """Periodic loss fetch: the oldest in-flight loss blocks least."""
        if self._pending:
            entry = self._pending.popleft()
            self.losses.append(float(entry[0].reshape(-1)[-1]))
            self._retire(entry)

    def ensure_ring_slot(self) -> None:
        """Retire finished entries; block on the oldest while the ring is
        full."""
        pending = self._pending
        while pending and self._is_done(pending[0]):
            self._retire(pending.popleft())
        while len(pending) >= self.inflight:
            self._block_oldest()

    def submit(self, batch) -> None:
        """Queue one step without waiting for its result."""
        if self.pad_partial and batch.get("_partial") and "_mask" not in batch:
            from blendjax_torch.data.batcher import pad_to_bucket

            batch = pad_to_bucket(batch, buckets=self.buckets)
        self.ensure_ring_slot()
        if self.place is not None:
            batch = self.place(batch)
        images = self._batch_images(batch)
        if self._t_first_dispatch is None:
            self._t_first_dispatch = time.monotonic()
        self.state, m = self.step(self.state, batch)
        loss = m["loss"]
        event = None
        if loss.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(loss.device))
        self.dispatches += 1
        self.steps += 1
        self._pending.append((loss, event, images))
        self.inflight_hwm = max(self.inflight_hwm, len(self._pending))
        if self.sync_every and self.steps % self.sync_every == 0:
            self._sync_oldest()

    def drain(self):
        """Wait for every queued step and return the newest loss."""
        if not self._pending:
            return self.losses[-1] if self.losses else None
        val = float(self._pending[-1][0].reshape(-1)[-1])
        # the fetch waited for every older step: retire them all
        while self._pending:
            self._retire(self._pending.popleft())
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
    def time_to_first_step_ms(self) -> float | None:
        """Construction (or :meth:`build`'s entry) to the first retired
        step; ``None`` until one retires."""
        if self._t_first_retire is None:
            return None
        return (self._t_first_retire - self._t_created) * 1e3

    @property
    def mfu(self) -> float | None:
        """Retired images per second, first dispatch to last retirement,
        x ``flops_per_image`` / ``peak_flops``; ``None`` without both knobs
        or a retired step."""
        if not (self.flops_per_image and self.peak_flops
                and self.images_retired and self._t_last_retire):
            return None
        dt = max(self._t_last_retire - self._t_first_dispatch, 1e-9)
        return self.images_retired / dt * self.flops_per_image / self.peak_flops

    @property
    def stats(self) -> dict:
        return {
            "steps": self.steps,
            "dispatches": self.dispatches,
            "inflight": self.inflight,
            "inflight_hwm": self.inflight_hwm,
            "host_blocks": self.host_blocks,
            "syncs": len(self.losses),
            "images_retired": self.images_retired,
            "startup_ms": self.startup_ms,
            "time_to_first_step_ms": self.time_to_first_step_ms,
            "flops_per_image": self.flops_per_image,
            "peak_flops": self.peak_flops,
            "mfu": self.mfu,
            "aot_fallbacks": getattr(self.step, "aot_fallbacks", None),
            "graph_replays": getattr(self.step, "graph_replays", None),
            "signatures": (len(self.step.signatures)
                           if hasattr(self.step, "signatures") else None),
        }
