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
run, first dispatch to last retirement), ``checkpoints`` (snapshots handed
to the manager) and, from a captured step
(:mod:`blendjax_torch.train.aot`), ``aot_fallbacks``, ``graph_replays``
and ``signatures``.

Checkpointing (:mod:`blendjax_torch.checkpoint`): with ``checkpoint=`` a
:class:`~blendjax_torch.checkpoint.SnapshotManager`, every
``checkpoint_every`` steps and after :meth:`TrainDriver.request_checkpoint`
the step boundary hands the state (under the JAX package's leaf paths,
:func:`blendjax_torch.weights.train_state_leaves`) and the session
(``session_state()`` plus the driver's own counters) to the manager, which
clones the tensors on the replay's stream and writes them on its own
thread. A :class:`~blendjax_torch.checkpoint.PreemptionGuard` makes the
next ``submit`` drain, snapshot and raise
:class:`~blendjax_torch.checkpoint.PreemptionRequested`.
``build(resume=True)`` restores the newest snapshot before the graphs are
captured.

Metrics (:mod:`blendjax_torch.utils.metrics`, the JAX driver's names): the
``train.dispatch`` span around each step call and ``train.dispatches``;
the ``train.inflight_hwm`` gauge (``gauge_max`` on every dispatch);
``ckpt.preemptions`` when a preemption is honoured; ``driver.ring_wait`` and ``train.host_blocks`` for a genuine ring-full
wait; ``driver.loss_sync`` around each loss fetch; each retired entry's
dispatch-to-retirement time in ``train.step_device_ms`` (an upper bound of
the step's device time: a finished entry is seen within one submit); and,
with ``flops_per_image`` and ``peak_flops``, the live ``train.mfu`` gauge
(retired images/s over windows of >= 1 s, and over the whole run at
:meth:`drain`). Sampled frame traces (:mod:`blendjax_torch.obs.trace`) come
off the batch before the step call, are stamped ``step_dispatch``, ride the
ring entry and are stamped ``step_retire`` and completed at retirement. A
:class:`~blendjax_torch.obs.devledger.RetraceAudit` watches a captured step
for signatures met after warm-up. A step that carries device-ledger entries
(:meth:`build`'s AOT set, a captured step) gives the cost-model FLOPs per
image (``mfu_source`` ``"cost-model"``) unless ``flops_per_image`` is
passed by hand (``"hand-fed"``). Scenario stamps (``_scenario`` and the
echo draw's per-row ``_scenario_rows``, :mod:`blendjax_torch.scenario`) are
host sidecars and come off the batch before the step call, as traces do;
the caller's batch keeps them for the accounting.
"""

from __future__ import annotations

import collections
import threading
import time

import torch

from blendjax_torch.obs.devledger import RetraceAudit, default_peak_flops
from blendjax_torch.obs.trace import (
    TERMINAL_STAGE,
    pop_traces as trace_pop,
    stage as trace_stage,
    tracer,
)
from blendjax_torch.train.steps import batch_images
from blendjax_torch.scenario.accounting import SCENARIO_KEY, SCENARIO_ROWS_KEY
from blendjax_torch.utils.metrics import metrics


class TrainDriver:
    """Wraps ``step(state, batch) -> (state, {"loss": tensor})``.

    ``place`` (e.g. ``pipeline.feeder.place`` with
    ``StreamDataPipeline(place_in_driver=True)``) takes each host batch to
    the card right before its step, once a ring slot is free, so the copy
    overlaps the steps in flight. ``flops_per_image`` and ``peak_flops``
    feed ``stats["mfu"]``; ``peak_flops`` defaults from the card's name.
    ``checkpoint``, ``checkpoint_every`` and ``session_state`` (a callable
    returning a dict of pickle-free host state) snapshot the run (see the
    module docstring)."""

    #: Losses kept in the session snapshot: the step counters carry the
    #: continuity, so the tail is bounded and a snapshot's size does not
    #: grow with the run.
    LOSS_TAIL = 4096

    def __init__(self, step, state, inflight: int = 4, sync_every: int = 32,
                 pad_partial: bool = True, buckets=None,
                 flops_per_image: float | None = None,
                 peak_flops: float | None = None, checkpoint=None,
                 checkpoint_every: int = 0, session_state=None, place=None):
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
        self.mfu_source = "hand-fed" if self.flops_per_image else None
        self._adopt_cost_model_flops(step)
        if self.flops_per_image and not self.peak_flops:
            self.peak_flops = default_peak_flops()
        self.retrace_audit = RetraceAudit.for_step(step)
        self.checkpoint = checkpoint
        self.checkpoint_every = max(0, int(checkpoint_every or 0))
        self.session_state = session_state
        self.checkpoints = 0
        self._ckpt_request = threading.Event()
        # a PreemptionGuard attaches itself here
        self.preempt = None
        self.resumed_session = None
        # ring entries: (loss tensor, completion event or None, images,
        # dispatch time, frame traces)
        self._pending: collections.deque = collections.deque()
        self._mfu_mark: tuple | None = None  # (t_mono, images_retired)
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
              learning_rate: float = 1e-3, rng=None, augment=None,
              augment_rng=None, precision=None, aot: bool = True,
              aot_cache_dir: str | None = None, resume: bool = False,
              device=None, **driver_kwargs):
        """Model -> ready driver, with the step captured per ladder shape.

        ``model.init_params(rng)`` when ``rng`` is given, then
        ``make_train_state`` (on ``device``: ``cuda`` unless ``"cpu"``);
        with ``resume=True`` and a ``checkpoint=`` manager in
        ``driver_kwargs`` the newest snapshot is restored into that state
        (its driver counters loaded, its session left on
        ``driver.resumed_session``) BEFORE any graph is captured;
        ``make_supervised_step`` with ``loss_fn``, ``augment``,
        ``augment_rng`` and ``precision``; then, with ``aot``,
        :func:`blendjax_torch.train.aot.build_aot_step` captures one graph
        for every bucket-ladder shape of ``example_batch`` before step 0
        (behind the keyed manifest in ``aot_cache_dir`` when given). The
        build's wall time lands on ``startup_ms``, and
        ``time_to_first_step_ms`` counts from the build's entry. The
        captured graphs' device-ledger entries give ``flops_per_image``
        (``mfu_source="cost-model"``) unless it is passed by hand."""
        from blendjax_torch.train.steps import (
            make_supervised_step,
            make_train_state,
        )
        from blendjax_torch.weights import (
            load_train_state_leaves,
            train_state_leaves,
        )

        t0 = time.monotonic()
        if not isinstance(example_batch, dict) or "image" not in example_batch:
            raise TypeError(
                "build() needs a full example batch dict (at least 'image' "
                "and the loss's fields) to derive the capture ladder"
            )
        if rng is not None:
            model.init_params(int(rng))
        state = make_train_state(model, optimizer=optimizer,
                                 learning_rate=learning_rate, device=device)
        session = None
        mgr = driver_kwargs.get("checkpoint")
        if resume and mgr is not None:
            restored = mgr.restore(train_state_leaves(state))
            if restored is not None:
                load_train_state_leaves(state, restored.state)
                session = restored.session
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
                ledger_name=f"{type(model).__name__}.supervised_step",
            )
        drv = cls(step, state, **driver_kwargs)
        drv._t_created = t0  # the cold-start clock starts at build entry
        drv.startup_ms = (time.monotonic() - t0) * 1e3
        drv.resumed_session = session
        if isinstance(session, dict) and session.get("driver"):
            drv.load_state_dict(session["driver"])
        return drv

    def _adopt_cost_model_flops(self, step) -> None:
        """The cost-model MFU numerator from the device ledger: when no
        ``flops_per_image`` was passed by hand, the step's ledger entries
        (its captured graphs) give FLOPs per image, from the entry of the
        most images (an AOT ladder's full batch, a packed group of K
        batches). Accounting only: never fails a build."""
        if self.flops_per_image:
            return
        try:
            entries = [
                e for e in (getattr(step, "ledger_entries", None) or [])
                if isinstance(e.get("flops"), float) and e.get("batch_images")
            ]
            if not entries:
                return
            e = max(entries, key=lambda e: e["batch_images"])
            self.flops_per_image = e["flops"] / e["batch_images"]
            self.mfu_source = "cost-model"
            if not self.peak_flops:
                self.peak_flops = default_peak_flops()
        except Exception:  # pragma: no cover - accounting only
            pass

    _batch_images = staticmethod(batch_images)

    @staticmethod
    def _is_done(entry) -> bool:
        event = entry[1]
        return event is None or event.query()

    def _retire(self, entry) -> None:
        """Host bookkeeping of one finished entry: the dispatch-to-retirement
        histogram, the live MFU gauge and the terminal stamp of its frame
        traces (the loss is not fetched here)."""
        _loss, _event, images, t0, traces = entry
        now = time.monotonic()
        if self._t_first_retire is None:
            self._t_first_retire = now
        self._t_last_retire = now
        metrics.observe("train.step_device_ms", (now - t0) * 1e3)
        self.images_retired += images
        if self.flops_per_image and self.peak_flops:
            if self._mfu_mark is None:
                self._mfu_mark = (now, self.images_retired)
            elif now - self._mfu_mark[0] >= 1.0:
                t_mark, img_mark = self._mfu_mark
                rate = (self.images_retired - img_mark) / (now - t_mark)
                metrics.gauge("train.mfu", round(
                    rate * self.flops_per_image / self.peak_flops, 6))
                self._mfu_mark = (now, self.images_retired)
        if traces:
            for tr in traces:
                trace_stage(tr, TERMINAL_STAGE)
                tracer.complete(tr)

    def _block_oldest(self) -> None:
        entry = self._pending.popleft()
        if not self._is_done(entry):
            self.host_blocks += 1
            metrics.count("train.host_blocks")
            with metrics.span("driver.ring_wait"):
                entry[1].synchronize()
        self._retire(entry)

    def _sync_oldest(self) -> None:
        """Periodic loss fetch: the oldest in-flight loss blocks least."""
        if self._pending:
            entry = self._pending.popleft()
            with metrics.span("driver.loss_sync"):
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

    def submit(self, batch, post: bool = True) -> None:
        """Queue one step without waiting for its result. ``post=False``
        leaves the step-boundary work (:meth:`post_dispatch`) to the
        caller."""
        if self.preempt is not None and self.preempt.requested:
            self._preempt_flush()
        if self.pad_partial and batch.get("_partial") and "_mask" not in batch:
            from blendjax_torch.data.batcher import pad_to_bucket

            batch = pad_to_bucket(batch, buckets=self.buckets)
        self.ensure_ring_slot()
        if self.place is not None:
            batch = self.place(batch)
        # frame traces are host metadata: off the batch before the step
        traces = trace_pop(batch)
        if traces:
            for tr in traces:
                trace_stage(tr, "step_dispatch")
        if SCENARIO_ROWS_KEY in batch or SCENARIO_KEY in batch:
            # host sidecars (strings, None): a new dict, so the caller's
            # batch keeps them for the scenario accounting
            batch = {k: v for k, v in batch.items()
                     if k not in (SCENARIO_ROWS_KEY, SCENARIO_KEY)}
        images = self._batch_images(batch)
        if self._t_first_dispatch is None:
            self._t_first_dispatch = time.monotonic()
        with metrics.span("train.dispatch"):
            self.state, m = self.step(self.state, batch)
        metrics.count("train.dispatches")
        if self.retrace_audit is not None:
            self.retrace_audit.observe(batch)
        loss = m["loss"]
        event = None
        if loss.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(loss.device))
        self.dispatches += 1
        self.steps += 1
        self._pending.append((loss, event, images, time.monotonic(), traces))
        self.inflight_hwm = max(self.inflight_hwm, len(self._pending))
        # every dispatch, so a registry reset mid-run still sees the gauge
        metrics.gauge_max("train.inflight_hwm", len(self._pending))
        if post:
            self.post_dispatch()

    def post_dispatch(self) -> None:
        """The step-boundary work after a step call: the periodic loss
        fetch and the snapshot hand-off (every ``checkpoint_every`` steps
        or on request). The hand-off clones the state on the replay's
        stream and returns; nothing here waits for the card but the loss
        fetch."""
        if self.sync_every and self.steps % self.sync_every == 0:
            self._sync_oldest()
        if self.checkpoint is not None and (
            self._ckpt_request.is_set()
            or (self.checkpoint_every
                and self.steps % self.checkpoint_every == 0)
        ):
            self._ckpt_request.clear()
            self._dispatch_checkpoint()

    # -- checkpointing ----------------------------------------------------------

    def request_checkpoint(self) -> None:
        """Thread-safe: snapshot at the next step boundary."""
        self._ckpt_request.set()

    def _dispatch_checkpoint(self) -> None:
        """Hand the state and the session to the snapshot manager."""
        from blendjax_torch.weights import train_state_leaves

        session = {}
        if callable(self.session_state):
            session = dict(self.session_state() or {})
        session.setdefault("driver", self.state_dict())
        self.checkpoint.save_async(self.steps, train_state_leaves(self.state),
                                   session=session)
        self.checkpoints += 1

    def _preempt_flush(self) -> None:
        """The SIGTERM path: drain the ring, snapshot, wait for the commit,
        then raise for the run loop to exit."""
        from blendjax_torch.checkpoint import PreemptionRequested

        self.drain()
        outcome = "no checkpoint manager attached"
        if self.checkpoint is not None:
            self._dispatch_checkpoint()
            # the one synchronous snapshot wait on the step path: the
            # process is about to exit
            self.checkpoint.wait()
            err = getattr(self.checkpoint, "last_error", None)
            outcome = (
                f"snapshot FAILED ({err!r}); resuming from the last "
                "committed step" if err is not None else "snapshot committed"
            )
        metrics.count("ckpt.preemptions")
        raise PreemptionRequested(
            f"preemption honored at step {self.steps}: {outcome}")

    def checkpoint_now(self, wait: bool = True) -> None:
        """Snapshot out of band (teardown, evaluation boundaries): drain the
        ring, snapshot, and with ``wait`` block until it commits."""
        if self.checkpoint is None:
            raise RuntimeError("no checkpoint manager attached")
        self.drain()
        self._dispatch_checkpoint()
        if wait:
            self.checkpoint.wait()
            err = getattr(self.checkpoint, "last_error", None)
            if err is not None:
                raise RuntimeError(
                    f"checkpoint_now: snapshot write failed: {err!r}"
                ) from err

    def state_dict(self) -> dict:
        """The driver's counters for the session: a resumed driver goes on
        with the same step numbering, so the loss fetches, the snapshot
        cadence and the augmentation seeds line up with the uninterrupted
        run."""
        tail = self.losses[-self.LOSS_TAIL:]
        return {
            "steps": self.steps,
            "dispatches": self.dispatches,
            "images_retired": self.images_retired,
            "checkpoints": self.checkpoints,
            "losses": [float(v) for v in tail],
            "losses_total": len(self.losses),
        }

    def load_state_dict(self, d: dict) -> None:
        self.steps = int(d["steps"])
        self.dispatches = int(d.get("dispatches", d["steps"]))
        self.images_retired = int(d.get("images_retired", 0))
        self.checkpoints = int(d.get("checkpoints", 0))
        self.losses = [float(v) for v in d.get("losses", [])]

    def drain(self):
        """Wait for every queued step and return the newest loss."""
        if not self._pending:
            return self.losses[-1] if self.losses else None
        val = float(self._pending[-1][0].reshape(-1)[-1])
        # the fetch waited for every older step: retire them all
        while self._pending:
            self._retire(self._pending.popleft())
        mfu = self.mfu
        if mfu is not None:  # the whole run's, at the drain barrier
            metrics.gauge("train.mfu", round(mfu, 6))
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
            "checkpoints": self.checkpoints,
            "startup_ms": self.startup_ms,
            "time_to_first_step_ms": self.time_to_first_step_ms,
            "flops_per_image": self.flops_per_image,
            "peak_flops": self.peak_flops,
            "mfu": self.mfu,
            "mfu_source": self.mfu_source,
            "aot_fallbacks": getattr(self.step, "aot_fallbacks", None),
            "graph_replays": getattr(self.step, "graph_replays", None),
            "signatures": (len(self.step.signatures)
                           if hasattr(self.step, "signatures") else None),
        }
