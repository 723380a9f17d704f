"""Data echoing: a sample reservoir on the card and re-augmentation per
draw, for producer-bound pipelines (port of ``blendjax/data/echo.py``).

When the producers render fewer frames than the step can train on, each
decoded frame is reused several times, with fresh random augmentation on
every draw so the repeats are decorrelated (Choi et al., "Faster Neural
Network Training with Data Echoing", 2020).

- :class:`SampleReservoir`: the last ``capacity`` decoded samples as a
  preallocated ring on the card (:mod:`blendjax_torch.data.ring`),
  written in place so its storage never moves. Draw indices are chosen on
  the host, so the echo accounting needs no device value.
- :class:`EchoingPipeline`: wraps a decoded ``StreamDataPipeline`` (or any
  iterable of batch dicts) and yields train batches at the step's rate.
  A background thread drains the inner pipeline; the draw loop inserts
  the fresh batches, composes each batch of slot indices under the echo
  budget (``max_echo_factor`` draws per sample, ``min_fresh_fraction``
  per batch), and blocks for fresh frames only when the budget is spent.
  With ``emit_draws=True`` it yields draw tokens, and
  :func:`blendjax_torch.train.make_echo_fused_step` gathers and augments
  inside the step call.

Ordering on the card: the drain thread runs the inner pipeline on the
CUDA stream that was current where iteration started, the stream the
inserts and the steps use too, so a decoded batch is complete before its
insert, and an insert queued after a step cannot overwrite the rows that
step gathers.

Checkpoints: both classes have ``state_dict`` / ``load_state_dict`` (the
ring's contents, the counters and the host generator's bit state), so a
resumed echo run draws the same slots with the same augmentation as the
uninterrupted one; ``warm_start=`` fills the reservoir from a recording
before the first draw.

Metrics (:mod:`blendjax_torch.utils.metrics`, the JAX package's names and
sites): the ``echo.insert``, ``echo.sample`` and ``echo.wait_fresh``
spans; ``echo.inserted``, ``echo.fresh``, ``echo.echoed``,
``echo.saturated_waits`` and ``echo.skipped_partial``; the
``echo.reservoir_fill``, ``echo.unique_fraction`` and ``echo.factor``
gauges; the ``echo.sample_age_s`` histogram. A sampled frame trace is stamped
``reservoir_insert`` when its batch enters the ring and parked on the
batch's first slot; the first draw of that slot stamps it
``reservoir_sample`` and carries it to the step (an overwritten slot drops
its trace). :meth:`EchoingPipeline.doctor` names the bound; :attr:`stats`
keeps the instance counters.

Scenarios (:mod:`blendjax_torch.scenario`): each slot remembers the
``_scenario`` stamp of the row that filled it (a host list; rows without a
stamp clear their slots), and every draw carries its rows' stamps as
``_scenario_rows`` and accounts them, fresh or echoed, in the process-wide
ledger, so an echoed row counts under the scenario that rendered it.

On a mesh (``mesh=`` or ``sharding=``): the ring's capacity axis is split
over the batch axes (:mod:`blendjax_torch.data.ring`), every rank inserts
its rows of each fresh global batch and gets its rows of each draw, and
slots, draw indices and the accounting stay global, as on one card. Every
rank runs the same host composition, so the ranks insert the same fresh
batches at the same points: the drain thread keeps pulling the inner
pipeline as on one card, and before each draw the ranks agree
(:class:`~blendjax_torch.parallel.mesh.RankAgreement`) to insert as many
pending fresh batches as the rank with the fewest has, and end together.
The inserts (an all-gather each) and the draws stay in the iterating
thread, in one order on every rank. A draw is cut to each rank's rows,
which the standard ops augment alone with the one-card draw's numbers;
each insert all-gathers the ranks' scenario stamps (host objects). A
draw gathers on the card, so a fused echo step over it captures whole.
"""

from __future__ import annotations

# bjx: driver-hot-path (the drain thread and the draw loop: BJX106/BJX108
# — no same-iteration host syncs, no host fetch of reservoir results,
# accounting runs on host-chosen indices — and BJX109, BJX114, BJX116
# and BJX125 hold in this module)

import collections
import contextlib
import functools
import logging
import math
import queue
import threading
import time

import numpy as np
import torch

from blendjax_torch.constants import LOGGER_NAME
from blendjax_torch.data.ring import (
    allocate_ring,
    make_ring_insert,
    ring_gather,
    ring_ways,
    validate_ring_capacity,
)
from blendjax_torch.device import resolve_device
from blendjax_torch.obs.trace import TRACES_KEY
from blendjax_torch.obs.trace import pop_traces as trace_pop
from blendjax_torch.obs.trace import stage as trace_stage
from blendjax_torch.ops.augment import (
    SeededAugment,
    color_jitter,
    fold_seed,
    make_batch_augment,
    random_crop_with_points,
    random_flip_with_points,
)
from blendjax_torch.parallel.sharding import leading_axes
from blendjax_torch.scenario.accounting import (
    SCENARIO_ROWS_KEY,
    batch_row_scenarios,
)
from blendjax_torch.scenario.accounting import accounting as scenario_accounting
from blendjax_torch.utils.metrics import metrics
from blendjax_torch.utils.tg import guard

logger = logging.getLogger(f"{LOGGER_NAME}.data")


def _on_device(v, device) -> torch.Tensor:
    if isinstance(v, np.ndarray):
        v = torch.from_numpy(np.ascontiguousarray(v))
    return v.to(device)


class SampleReservoir:
    """Ring of the last ``capacity`` samples on ``device`` (``cuda``
    unless ``device="cpu"``; no GPU and no device raises).

    One preallocated tensor per field, leading dim ``capacity``, shaped
    from the first insert. :meth:`insert` writes B rows at ``(cursor +
    arange(B)) % capacity`` in place. :meth:`sample` gathers host-chosen
    rows and applies ``augment`` (``fn(seed, batch) -> batch``, e.g.
    :func:`blendjax_torch.ops.augment.make_batch_augment`) with the seed
    ``fold_seed(rng, counter)`` of an internal draw counter, so two draws
    of one slot augment differently, and each draw's augmentation is a
    pure function of (construction ``rng``, counter).

    ``sharding`` (:func:`blendjax_torch.parallel.ring_sharding`) splits the
    ring over the batch axes: :meth:`insert` takes this rank's rows of a
    global batch, slots and draw indices are global, and a draw is
    gathered whole on every rank and cut to this rank's rows, which a
    row-local augmentation (:attr:`~blendjax_torch.ops.augment.SeededAugment.row_local`)
    augments alone with their numbers of the one-card draw of the same
    counter; any other ``augment`` runs on the whole draw before the cut.
    """

    def __init__(self, capacity: int, augment=None, rng: int = 0,
                 sharding=None, device=None):
        self.capacity = int(capacity)
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        validate_ring_capacity(self.capacity, sharding)
        self.sharding = sharding
        self.ways = ring_ways(sharding)
        self.device = resolve_device(device)
        self.augment = augment
        self._seed = int(rng)
        self._buffers: dict | None = None
        self._spec: dict | None = None  # field -> (row shape, dtype)
        self._insert_fn = make_ring_insert(self.capacity, sharding)
        self._cursor = 0
        self.size = 0  # filled slots (== capacity once wrapped)
        self.inserts = 0  # samples inserted, lifetime
        self._draws = 0  # draw counter folded into the augment seed
        from blendjax_torch.train.aot import CapturedDispatch

        # sample()'s gather and augmentation: one CUDA graph per ring (its
        # tensors, read in place) and draw size; the draw counter seeds
        # the generators on the host before each replay
        self.dispatch = CapturedDispatch(
            self._token_draw, self.device, "echo_draw",
            generators=lambda token: self.draw_generators(),
            reseed=lambda token: self.seed_draw(token["_echo_counter"]),
            mesh=getattr(sharding, "mesh", None))

    def insert(self, batch: dict) -> np.ndarray:
        """Write one batch of samples (host numpy or tensors, one leading
        dim) into the ring; returns the host array of slots written. A
        batch larger than ``capacity`` keeps its newest ``capacity`` rows.

        Draw tokens made before an insert die with it (:meth:`draw`
        raises), as the JAX package's donated buffers do."""
        if not batch:
            raise ValueError("insert() needs at least one array field")
        batch = {k: _on_device(v, self.device) for k, v in batch.items()}
        lead = next(iter(batch.values())).shape[0] * self.ways
        if lead > self.capacity:
            if self.ways > 1:
                raise ValueError(
                    f"a global batch of {lead} rows does not fit a sharded "
                    f"ring of {self.capacity}")
            batch = {k: v[-self.capacity:] for k, v in batch.items()}
            lead = self.capacity
        if self._buffers is None:
            self._spec = {k: (tuple(v.shape[1:]), v.dtype)
                          for k, v in batch.items()}
            self._buffers = allocate_ring(self.capacity, batch,
                                          sharding=self.sharding,
                                          device=self.device)
        else:
            if set(batch) != set(self._spec):
                raise ValueError(
                    f"insert fields {sorted(batch)} != reservoir fields "
                    f"{sorted(self._spec)}"
                )
            for k, v in batch.items():
                shape, dtype = self._spec[k]
                if tuple(v.shape[1:]) != shape or v.dtype != dtype:
                    raise ValueError(
                        f"field {k!r}: got {tuple(v.shape[1:])}/{v.dtype}, "
                        f"reservoir holds {shape}/{dtype}"
                    )
        with metrics.span("echo.insert"):
            self._insert_fn(self._buffers, batch, self._cursor)
        # same tensors, new dict: tokens holding the old dict are stale
        self._buffers = dict(self._buffers)
        slots = (self._cursor + np.arange(lead)) % self.capacity
        self._cursor = (self._cursor + lead) % self.capacity
        self.size = min(self.size + lead, self.capacity)
        self.inserts += lead
        return slots

    def _require(self) -> None:
        if self._buffers is None:
            raise RuntimeError("reservoir is empty: insert() first")

    def _draw_body(self, buffers, idx, counter):
        out = ring_gather(buffers, idx, sharding=self.sharding,
                          capacity=self.capacity)
        if self.augment is None:
            return self._local(out)
        seed = fold_seed(self._seed, int(counter))
        if self.ways > 1 and getattr(self.augment, "row_local", False):
            from blendjax_torch.parallel.sharding import rank_range

            out = self._local(out)
            start, _n = rank_range(self.sharding.mesh,
                                   leading_axes(self.sharding), len(idx))
            return self.augment(seed, out, rows=(start, len(idx)))
        return self._local(self.augment(seed, out))

    def _token_draw(self, token: dict) -> dict:
        """The draw a :meth:`draw_token` names, the function
        :attr:`dispatch` captures (a sharded ring's gather keeps its
        all-reduce in the graph)."""
        return self._draw_body(token["_echo_buffers"], token["_echo_idx"],
                               token["_echo_counter"])

    def _local(self, batch: dict) -> dict:
        """This rank's rows of a whole draw (all of it off a mesh)."""
        if self.ways <= 1:
            return batch
        from blendjax_torch.parallel.sharding import local_rows

        return {k: local_rows(v, self.sharding) for k, v in batch.items()}

    def draw_generators(self) -> list:
        """The generators a draw's augmentation takes its random numbers
        from (:class:`~blendjax_torch.ops.augment.SeededAugment`), for a
        CUDA graph to register; empty for raw repeats."""
        if isinstance(self.augment, SeededAugment):
            return self.augment.generators(self.device)
        return []

    def seed_draw(self, counter: int) -> None:
        """Seed the draw generators for draw ``counter`` on the host, as
        :meth:`draw` does before it draws: the host half of a draw that a
        graph replays."""
        if isinstance(self.augment, SeededAugment):
            self.augment.seed(fold_seed(self._seed, int(counter)),
                              self.device)

    def check_token(self, buffers) -> None:
        """Raise unless ``buffers`` is the ring of a token made since the
        last insert (see :meth:`draw`)."""
        self._require()
        if buffers is not self._buffers:
            raise RuntimeError(
                "draw token outlived an insert: the ring slots it names may "
                "have been overwritten (run the step before inserting again)"
            )

    def sample(self, idx) -> dict:
        """Gather the rows at host-chosen ``idx`` (B,) and augment them;
        advances the draw counter. On the card one replay of the graph of
        this ring and draw size (:attr:`dispatch`), which returns fresh
        tensors; an ``augment`` that is a plain ``fn(seed, batch)`` (not a
        :class:`~blendjax_torch.ops.augment.SeededAugment`) takes its seed
        on the host, which a graph would freeze, so its draws run eagerly
        and count ``dispatch.eager_calls``."""
        token = self.draw_token(idx)
        plain = self.augment is not None and not isinstance(self.augment,
                                                            SeededAugment)
        with metrics.span("echo.sample"):
            if plain and self.device.type == "cuda":
                return self.dispatch.eager(token)
            return self.dispatch(token)

    def gather(self, idx) -> dict:
        """Raw gather of ``idx`` rows: no augmentation, no counter advance."""
        self._require()
        return self._local(ring_gather(self._buffers, idx,
                                       sharding=self.sharding,
                                       capacity=self.capacity))

    def draw(self, buffers, idx, counter) -> dict:
        """The gather + augment body that
        :func:`blendjax_torch.train.make_echo_fused_step` runs inside its
        step call: the same arithmetic as :meth:`sample` for the same
        counter. ``buffers`` must be the ring of a token made since the
        last insert; an older token raises, because the slots it names
        may hold other samples now."""
        self.check_token(buffers)
        return self._draw_body(buffers, idx, counter)

    def draw_token(self, idx) -> dict:
        """One fused-draw token: the ring (by reference), the host
        indices and this draw's counter. Advances the counter :meth:`sample`
        uses; no device work happens here. A captured step copies the
        indices into its static index buffer (``_echo_idx``) and its graph
        gathers from that device tensor, on a sharded ring too."""
        self._require()
        token = {
            "_by_reference": ("_echo_buffers",),
            "_echo_buffers": self._buffers,
            "_echo_idx": np.asarray(idx, np.int64),
            "_echo_counter": self._draws,
        }
        self._draws += 1
        return token

    @property
    def fields(self) -> tuple:
        return tuple(self._spec) if self._spec else ()

    def device_buffers(self) -> dict:
        """``{field: tensor}`` of the ring: the same tensors for the run,
        written in place (the input of
        :class:`blendjax_torch.testing.DonationAudit`)."""
        return dict(self._buffers or {})

    # -- session snapshot (blendjax_torch.checkpoint) ------------------------

    def state_dict(self) -> dict:
        """The ring and its counters. The buffers ride by reference: the
        snapshot manager clones them on the current stream and copies them
        to the host on its own thread."""
        d = {
            "capacity": self.capacity,
            "cursor": self._cursor,
            "size": self.size,
            "inserts": self.inserts,
            "draws": self._draws,
            "built": self._buffers is not None,
        }
        if self._buffers is not None:
            d["buffers"] = dict(self._buffers)
        return d

    def load_state_dict(self, d: dict) -> None:
        """Rebuild the ring from a snapshot; the draw counter is restored
        too, so the next draw seeds its augmentation as the uninterrupted
        run's would."""
        if int(d["capacity"]) != self.capacity:
            raise ValueError(
                f"snapshot reservoir capacity {d['capacity']} != configured "
                f"{self.capacity}"
            )
        self._cursor = int(d["cursor"])
        self.size = int(d["size"])
        self.inserts = int(d["inserts"])
        self._draws = int(d["draws"])
        if not d.get("built"):
            return
        bufs = {k: np.asarray(v) for k, v in d["buffers"].items()}
        # the draw graphs read the old ring in place
        self.dispatch.clear()
        self._buffers = allocate_ring(self.capacity, initial=bufs,
                                      sharding=self.sharding,
                                      device=self.device)
        self._spec = {k: (tuple(v.shape[1:]), v.dtype)
                      for k, v in self._buffers.items()}


class EchoingPipeline:
    """Yield train batches at the step rate from a producer-bound stream,
    drawing each sample up to ``max_echo_factor`` times with fresh
    augmentation per draw.

    - ``pipeline``: a ``StreamDataPipeline(chunk=1, emit_packed=False)``
      or any iterable of decoded batch dicts.
    - ``capacity``: reservoir size in samples.
    - ``max_echo_factor``: the most draws of one inserted sample, its
      fresh draw included. Never exceeded.
    - ``min_fresh_fraction``: the least share of first-use samples in
      each batch (0 disables; relaxed once the inner pipeline has ended).
    - ``augment``: ``"default"`` (:func:`default_echo_augment`), ``None``
      (raw repeats) or ``fn(seed, batch) -> batch``.
    - ``emit_draws``: yield draw tokens ``{"_echo_buffers", "_echo_idx",
      "_echo_counter", "_by_reference"}`` for ``make_echo_fused_step``
      instead of gathered batches; composition, accounting and
      augmentation are the same.
    - ``device``: where the reservoir lives; ``None`` takes the inner
      pipeline's device, else ``cuda`` (raises without a GPU).
    - ``warm_start``: a recording (path, list or prefix) that fills the
      reservoir through the replay pipeline before the first draw, so
      the first steps do not wait for live frames;
      ``warm_start_allow_pickle`` admits a pickle-bearing recording.
    - ``requests``: on a mesh, a
      :class:`~blendjax_torch.parallel.mesh.StepAgreement` whose step
      requests ride the agreement before each draw (the driver's, or a
      direct loop's; the inner pipeline's agreement runs on the drain
      thread and must not carry them).

    :attr:`stats`: ``fresh + echoed == steps * batch`` exactly;
    ``saturated_waits`` counts the waits for fresh frames with the budget
    spent; ``skipped_partial`` the padded tail batches not inserted.
    """

    _DONE = object()

    def __init__(self, pipeline, capacity: int = 256,
                 max_echo_factor: int = 8, min_fresh_fraction: float = 0.0,
                 batch_size: int | None = None, augment="default",
                 image_key: str = "image", points_key: str | None = None,
                 rng: int = 0, warm_start=None,
                 warm_start_allow_pickle: bool = False, mesh=None,
                 sharding=None, emit_draws: bool = False, device=None,
                 requests=None):
        from blendjax_torch.parallel.sharding import (
            check_sharding,
            ring_sharding,
        )

        if mesh is not None:
            from blendjax_torch.parallel.mesh import check_mesh

            check_mesh(mesh)
            if sharding is None:
                sharding = ring_sharding(mesh)
        check_sharding(sharding)
        self.pipeline = pipeline
        self.warm_start = warm_start
        self.warm_start_allow_pickle = bool(warm_start_allow_pickle)
        self.capacity = int(capacity)
        self.max_echo_factor = max(1, int(max_echo_factor))
        self.min_fresh_fraction = float(min_fresh_fraction)
        if not 0.0 <= self.min_fresh_fraction <= 1.0:
            raise ValueError(
                f"min_fresh_fraction must be in [0, 1], got "
                f"{min_fresh_fraction}"
            )
        self.batch_size = (
            int(batch_size) if batch_size
            else getattr(pipeline, "batch_size", None)
        )
        tiles = getattr(pipeline, "tiles", None)
        if tiles is not None and (
            getattr(tiles, "chunk", 1) > 1
            or getattr(tiles, "emit_packed", False)
        ):
            raise ValueError(
                "EchoingPipeline needs a decoded per-batch pipeline: "
                "construct the StreamDataPipeline with chunk=1 and "
                "emit_packed=False"
            )
        self.image_key = image_key
        self.points_key = points_key
        if augment == "default":
            augment = default_echo_augment(image_key=image_key,
                                           points_key=points_key)
        self.emit_draws = bool(emit_draws)
        if device is None:
            device = getattr(pipeline, "device", None)
        ways = ring_ways(sharding)
        if ways > 1 and self.batch_size and self.batch_size % ways:
            raise ValueError(
                f"batch_size={self.batch_size} must divide evenly over the "
                f"{ways}-way batch axis: every card takes an equal share of "
                "each drawn batch")
        reservoir = SampleReservoir(self.capacity, augment=augment, rng=rng,
                                    sharding=sharding, device=device)
        self.device = reservoir.device
        # first-use affinity: the reservoir (ring + draw counter) is
        # single-thread by contract, bound to whichever thread first draws
        # or inserts (the iterating thread; the drain thread only feeds
        # the queue) and snapshot by state_dict on that same thread.
        # threadguard enforces it when BLENDJAX_THREADGUARD=1.
        self.reservoir = guard(reservoir, name="echo.reservoir",
                               affinity="first-use")
        self._np_rng = np.random.default_rng(int(rng))
        # host-side per-slot accounting (numpy, never device values)
        self._use = np.zeros(self.capacity, np.int64)
        self._t_insert = np.zeros(self.capacity, np.float64)
        self._filled = np.zeros(self.capacity, bool)
        # per-slot scenario stamps (host; None for unstamped rows)
        self._slot_scen: list = [None] * self.capacity
        self._scen_active = False
        self._queue: queue.Queue = queue.Queue(maxsize=2)
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._err_lock = threading.Lock()
        self._inner_error: BaseException | None = None
        self._inner_done = False
        # on a mesh of several ranks: the agreement on fresh inserts, the
        # fresh batches taken off the queue but not inserted yet, and
        # whether this rank's drain thread has finished
        self._agreement = None
        self.requests = requests
        if sharding is not None and sharding.mesh.mesh.numel() > 1:
            from blendjax_torch.parallel.mesh import RankAgreement

            self._agreement = RankAgreement(sharding.mesh)
        self._pending: collections.deque = collections.deque()
        self._drained = False
        self._warned_sidecars = False
        self._warned_partial = False
        # sampled frame traces parked on the first slot of their batch
        self._slot_traces: dict = {}
        self.steps = 0
        self.fresh = 0
        self.echoed = 0
        self.inserted = 0
        self.saturated_waits = 0
        self.skipped_partial = 0
        self.max_uses = 0  # most draws of any one sample so far
        self.drain_busy_s = 0.0  # CPU seconds of the drain thread

    # -- inner-pipeline drain thread ------------------------------------------

    def _drain(self, stream) -> None:
        cpu0 = time.thread_time()
        try:
            # the iterating thread's stream: decode, insert and step are
            # ordered on it
            ctx = (torch.cuda.stream(stream) if stream is not None
                   else contextlib.nullcontext())
            with ctx:
                for b in iter(self.pipeline):
                    # this thread's CPU seconds so far (its host share)
                    # single-writer observability float: one atomic reference
                    # store per batch, read by report()
                    # bjx: ignore[BJX117] — as blendjax/data/shard_ingest.py:311
                    self.drain_busy_s = time.thread_time() - cpu0
                    while not self._stop.is_set():
                        try:
                            self._queue.put(b, timeout=0.25)
                            break
                        except queue.Full:
                            continue
                    if self._stop.is_set():
                        return
        except BaseException as e:  # re-raised in the draw loop
            with self._err_lock:
                self._inner_error = e
        finally:
            while not self._stop.is_set():
                try:
                    self._queue.put(self._DONE, timeout=0.25)
                    break
                except queue.Full:
                    continue

    # -- reservoir feeding ----------------------------------------------------

    def _insert_fresh(self, batch: dict, stamped: bool = True) -> None:
        """Insert one fresh batch. On a sharded ring its rows' stamps are
        all-gathered unless ``stamped`` is false (no rank's batch of this
        insert carries any, as the ranks agreed)."""
        if "_packed" in batch or "__packed__" in batch:
            raise ValueError(
                "EchoingPipeline received a packed (emit_packed) batch; "
                "echoing needs decoded batches"
            )
        if "_mask" in batch or batch.get("_partial"):
            # a bucket-padded tail: its padded rows would train on zeros
            if not self._warned_partial:
                self._warned_partial = True
                logger.warning(
                    "skipping a partial/masked tail batch: echoing its "
                    "padded rows would train on zeros"
                )
            self.skipped_partial += 1
            metrics.count("echo.skipped_partial")
            return
        arrays = {
            k: v for k, v in batch.items()
            if not k.startswith("_") and getattr(v, "ndim", 0) >= 1
        }
        if not arrays:
            return
        lead = max(
            (v.shape[0] for v in arrays.values()),
            key=lambda s: sum(1 for v in arrays.values() if v.shape[0] == s),
        )
        fields = {k: v for k, v in arrays.items() if v.shape[0] == lead}
        dropped = sorted(set(arrays) - set(fields))
        if dropped and not self._warned_sidecars:
            self._warned_sidecars = True
            logger.info(
                "reservoir echoes fields %s; sidecars %s are dropped "
                "from echoed batches", sorted(fields), dropped,
            )
        if self.batch_size is None:
            self.batch_size = int(lead) * self.reservoir.ways
        trs = trace_pop(batch)
        scen_rows = batch_row_scenarios(batch, int(lead))
        if self.reservoir.ways > 1 and stamped:
            scen_rows = self._global_stamps(scen_rows, int(lead))
        slots = self.reservoir.insert(fields)
        if scen_rows is not None:
            self._scen_active = True
            # a batch larger than the ring kept its newest rows only
            for s, r in zip(slots, scen_rows[-len(slots):]):
                self._slot_scen[int(s)] = r
        elif self._scen_active:
            # unstamped rows overwrite stamped slots: never leak a dead
            # scenario onto a new sample
            for s in slots:
                self._slot_scen[int(s)] = None
        if self._slot_traces:
            # overwritten slots drop their parked traces with their frames
            for s in slots:
                self._slot_traces.pop(int(s), None)
        if trs:
            for tr in trs:
                trace_stage(tr, "reservoir_insert")
            # insert() returns host numpy slots, as
            # blendjax/data/echo.py:637: this int() reads a host value
            # bjx: ignore[BJX108] — host slot index, not a card fetch
            self._slot_traces[int(slots[0])] = trs
        self._use[slots] = 0
        self._t_insert[slots] = time.monotonic()
        self._filled[slots] = True
        self.inserted += len(slots)
        metrics.count("echo.inserted", len(slots))
        metrics.gauge("echo.reservoir_fill", int(self._filled.sum()))

    def _global_stamps(self, mine, lead: int):
        """Every row's stamp of a global batch on a sharded ring: the
        ranks all-gather their rows' stamps (``mine``, this rank's
        ``lead`` rows, or None) and order them by their place on the batch
        axes (the ranks of a model axis hold the same rows; the first
        rank's stand). None when no rank's rows are stamped."""
        from blendjax_torch.parallel.mesh import axes_index

        sh = self.reservoir.sharding
        where = axes_index(sh.mesh, leading_axes(sh))
        got = self._agreement.gather_objects((where, mine))
        if all(rows is None for _w, rows in got):
            return None
        by_place: dict = {}
        for w, rows in got:
            by_place.setdefault(w, rows if rows is not None
                                else [None] * lead)
        return [r for w in sorted(by_place) for r in by_place[w]]

    def _poll_fresh(self, block: bool, timeout: float = 0.25) -> bool:
        """Insert pending fresh batches (at most the backlog present at
        entry, so a fast fleet cannot starve the draws); with
        ``block=True`` wait up to ``timeout`` for one when none is
        pending. Returns whether anything was inserted."""
        if self._agreement is not None:
            return self._poll_agreed(block, timeout)
        got = False
        for _ in range(max(self._queue.qsize(), 1)):
            try:
                b = self._queue.get_nowait()
            except queue.Empty:
                break
            if b is self._DONE:
                self._inner_done = True
                return got
            self._insert_fresh(b)
            got = True
        if not got and block and not self._inner_done:
            try:
                with metrics.span("echo.wait_fresh"):
                    b = self._queue.get(timeout=timeout)
            except queue.Empty:
                return False
            if b is self._DONE:
                self._inner_done = True
                return False
            self._insert_fresh(b)
            got = True
        return got

    def _take_pending(self, block: bool, timeout: float) -> None:
        """Move fresh batches off the queue (at most 2 held), waiting up to
        ``timeout`` for one with ``block=True`` when none is held."""
        while len(self._pending) < 2 and not self._drained:
            try:
                b = self._queue.get_nowait()
            except queue.Empty:
                break
            if b is self._DONE:
                self._drained = True
            else:
                self._pending.append(b)
        if block and not self._pending and not self._drained:
            try:
                with metrics.span("echo.wait_fresh"):
                    b = self._queue.get(timeout=timeout)
            except queue.Empty:
                return
            if b is self._DONE:
                self._drained = True
            else:
                self._pending.append(b)

    def _poll_agreed(self, block: bool, timeout: float) -> bool:
        """:meth:`_poll_fresh` on a mesh: every rank inserts as many of its
        pending fresh batches as the rank with the fewest holds, so the
        ranks' reservoirs, accounting and draws stay the same; the stream
        ends for all when a finished rank has none left (the others drop
        what they hold), and a failed one raises on every rank. A bit per
        held batch says whether it carries scenario stamps, so that an
        insert gathers the stamps only when some rank's batch has them."""
        self._take_pending(block, timeout)
        with self._err_lock:
            err = self._inner_error
        stamps = sum(1 << i for i, b in enumerate(self._pending)
                     if batch_row_scenarios(b, 1) is not None)
        mine = [len(self._pending), int(self._drained), int(err is not None),
                stamps]
        if self.requests is not None:  # the step boundary's requests
            mine.append(self.requests.carry())
        got = self._agreement.gather(mine)
        if self.requests is not None:
            self.requests.settle(got[:, 4])
        if got[:, 2].any():
            if err is not None:
                raise err  # a crashed stream is not a clean end of stream
            raise RuntimeError(
                "the inner stream of mesh rank(s) "
                f"{np.flatnonzero(got[:, 2]).tolist()} failed")
        n = int(got[:, 0].min())
        for i in range(n):
            self._insert_fresh(self._pending.popleft(),
                               stamped=bool((got[:, 3] >> i & 1).any()))
        if (got[:, 1].astype(bool) & (got[:, 0] == n)).any():
            if self._pending:
                logger.warning(
                    "echo on a mesh: a rank's stream ended; this rank drops "
                    "%d fresh batches it holds", len(self._pending))
                self._pending.clear()
            self._inner_done = True
        return n > 0

    # -- draw composition -----------------------------------------------------

    def _compose_draw(self) -> np.ndarray | None:
        """A batch of slot indices within the echo budget, or None when
        the reservoir cannot supply one now (empty, saturated, or short of
        the fresh floor). Sampling is without replacement from the
        multiset of remaining per-slot draws, so no slot exceeds
        ``max_echo_factor`` uses, not even within one batch."""
        b = self.batch_size
        if not b:
            return None
        slots = np.flatnonzero(self._filled)
        if not len(slots):
            return None
        rem = np.maximum(self.max_echo_factor - self._use[slots], 0)
        if int(rem.sum()) < b:
            return None
        fresh = slots[self._use[slots] == 0]
        need_fresh = math.ceil(self.min_fresh_fraction * b)
        if len(fresh) < need_fresh:
            if not self._inner_done:
                return None
            need_fresh = len(fresh)  # stream over: drain the budget
        picks = []
        if need_fresh:
            chosen = self._np_rng.choice(fresh, size=need_fresh, replace=False)
            picks.append(chosen)
            rem[np.searchsorted(slots, chosen)] -= 1
        rest = b - need_fresh
        if rest:
            pool = np.repeat(slots, rem)
            picks.append(self._np_rng.choice(pool, size=rest, replace=False))
        return self._np_rng.permutation(np.concatenate(picks))

    # -- iteration ------------------------------------------------------------

    def __iter__(self):
        if self.warm_start:
            self._warm_fill()
        if self._thread is None:
            self._stop.clear()
            stream = (torch.cuda.current_stream(self.device)
                      if self.device.type == "cuda" else None)
            self._thread = threading.Thread(
                target=self._drain, args=(stream,),
                name="blendjax-torch-echo-drain", daemon=True,
            )
            self._thread.start()
        return self._draws()

    def _draws(self):
        waiting = False
        while True:
            if self._stop.is_set():
                return
            self._poll_fresh(block=False)
            with self._err_lock:
                err = self._inner_error
            if err is not None and self._agreement is None:
                raise err  # a crashed stream is not a clean end of stream
            idx = self._compose_draw()
            if idx is None:
                if self._inner_done and (self._agreement is not None
                                         or self._queue.empty()):
                    return
                if not waiting and self._filled.any():
                    waiting = True  # one count per wait episode
                    self.saturated_waits += 1
                    metrics.count("echo.saturated_waits")
                self._poll_fresh(block=True)
                continue
            waiting = False
            if self.emit_draws:
                batch = self.reservoir.draw_token(idx)
            else:
                batch = self.reservoir.sample(idx)
            if self._slot_traces:
                # the first draw of a traced batch's slot carries its traces
                out_traces = []
                for s in set(int(i) for i in idx):
                    trs = self._slot_traces.pop(s, None)
                    if trs:
                        out_traces.extend(trs)
                if out_traces:
                    for tr in out_traces:
                        trace_stage(tr, "reservoir_sample")
                    batch[TRACES_KEY] = out_traces
            # fresh counts first uses: a slot drawn twice in one batch is
            # one fresh and one echo
            first = np.zeros(len(idx), bool)
            first[np.unique(idx, return_index=True)[1]] = True
            fresh_rows = first & (self._use[idx] == 0)
            fresh_n = int(fresh_rows.sum())
            if self._scen_active:
                # each drawn row carries its slot's stamp, into the batch
                # and the ledger
                scen = [self._slot_scen[int(i)] for i in idx]
                batch[SCENARIO_ROWS_KEY] = scen
                scenario_accounting.observe_rows(scen, fresh=fresh_rows)
            np.add.at(self._use, idx, 1)
            # idx and _use are host numpy (_compose_draw), as
            # blendjax/data/echo.py:799,802: no card value is read here
            # bjx: ignore[BJX106] — host accounting on the host index vector
            self.max_uses = max(self.max_uses, int(self._use[idx].max()))
            # one registry call for the whole age vector
            metrics.observe_many(
                "echo.sample_age_s", time.monotonic() - self._t_insert[idx])
            self.steps += 1
            self.fresh += fresh_n
            self.echoed += len(idx) - fresh_n
            metrics.count("echo.fresh", fresh_n)
            metrics.count("echo.echoed", len(idx) - fresh_n)
            # the gauges read the registry's counters, so they agree with
            # the windowed echo.* counters after a metrics.reset()
            f = metrics.counter_value("echo.fresh")
            drawn = f + metrics.counter_value("echo.echoed")
            metrics.gauge("echo.unique_fraction",
                          round(f / drawn, 4) if drawn else 0.0)
            metrics.gauge("echo.factor", round(
                drawn / max(metrics.counter_value("echo.inserted"), 1), 4))
            yield batch

    # -- warm start ------------------------------------------------------------

    def _warm_fill(self) -> None:
        """Fill the reservoir from the ``warm_start`` recording through the
        whole replay pipeline (tile recordings decode bit-exact), one
        reservoir's worth of batches."""
        from blendjax_torch.data.pipeline import StreamDataPipeline

        if self.batch_size is None:
            raise ValueError(
                "warm_start needs a known batch_size (pass batch_size= or "
                "wrap a StreamDataPipeline)"
            )
        warm = StreamDataPipeline.from_recording(
            self.warm_start, batch_size=self.batch_size,
            allow_pickle=self.warm_start_allow_pickle, device=self.device,
            sharding=self.reservoir.sharding,
        )
        budget = math.ceil(self.capacity / self.batch_size)
        with warm:
            it = iter(warm)
            for _ in range(budget):
                try:
                    self._insert_fresh(next(it))
                except StopIteration:
                    break
        logger.info("warm-started the reservoir with %d samples from %r",
                    int(self._filled.sum()), self.warm_start)

    # -- session snapshot (blendjax_torch.checkpoint) ------------------------

    def state_dict(self) -> dict:
        """What a resumed echo pipeline needs to go on bitwise: the
        reservoir (ring and draw counter), the per-slot use counts, fill
        and scenario stamps, the host generator's bit state and the
        counters. Insert
        times are stored as ages (a monotonic clock does not survive the
        process). The arrays are copies: this thread keeps updating its
        own while the writer encodes them."""
        now = time.monotonic()
        return {
            "reservoir": self.reservoir.state_dict(),
            "use": self._use.copy(),
            "filled": self._filled.copy(),
            "age_s": now - self._t_insert,
            "slot_scen": list(self._slot_scen),
            "scen_active": self._scen_active,
            "rng": self._np_rng.bit_generator.state,
            "batch_size": self.batch_size,
            "steps": self.steps,
            "fresh": self.fresh,
            "echoed": self.echoed,
            "inserted": self.inserted,
            "saturated_waits": self.saturated_waits,
            "max_uses": self.max_uses,
        }

    def load_state_dict(self, d: dict) -> None:
        """Restore before iteration starts (the drain thread has not
        touched the reservoir yet); raises once iterating."""
        if self._thread is not None:
            raise RuntimeError(
                "load_state_dict must run before iteration starts")
        self.reservoir.load_state_dict(d["reservoir"])
        self._use = np.asarray(d["use"], np.int64).copy()
        self._filled = np.asarray(d["filled"], bool).copy()
        self._t_insert = time.monotonic() - np.asarray(d["age_s"], np.float64)
        self._slot_scen = list(d.get("slot_scen") or [None] * self.capacity)
        self._scen_active = bool(d.get("scen_active", False))
        self._np_rng.bit_generator.state = d["rng"]
        if d.get("batch_size"):
            self.batch_size = int(d["batch_size"])
        self.steps = int(d.get("steps", 0))
        self.fresh = int(d.get("fresh", 0))
        self.echoed = int(d.get("echoed", 0))
        self.inserted = int(d.get("inserted", 0))
        self.saturated_waits = int(d.get("saturated_waits", 0))
        self.max_uses = int(d.get("max_uses", 0))

    # -- lifecycle / observability --------------------------------------------

    @property
    def stats(self) -> dict:
        drawn = self.fresh + self.echoed
        return {
            "steps": self.steps,
            "inserted": self.inserted,
            "fresh": self.fresh,
            "echoed": self.echoed,
            "saturated_waits": self.saturated_waits,
            "skipped_partial": self.skipped_partial,
            "reservoir_fill": int(self._filled.sum()),
            "max_uses": self.max_uses,
            "drain_busy_s": self.drain_busy_s,
            "unique_fraction": (
                round(self.fresh / drawn, 4) if drawn else None
            ),
            "echo_factor": (
                round(drawn / self.inserted, 4) if self.inserted else None
            ),
        }

    def doctor(self, driver=None):
        """Stall-doctor verdict for the echoing pipeline: the wrapped
        pipeline's doctor when it has one (its prefetch bound and queue
        gauges feed the diagnosis), else the process-wide registries; the
        ``echo.*`` counters drive the echo-mitigated and echo-saturated
        arms."""
        inner = getattr(self.pipeline, "doctor", None)
        if inner is not None:
            return inner(driver)
        from blendjax_torch.obs import diagnose_current

        return diagnose_current(driver=getattr(driver, "stats", driver))

    def stop(self) -> None:
        self._stop.set()
        stop = getattr(self.pipeline, "stop", None)
        if stop is not None:
            stop()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


def default_echo_augment(image_key: str = "image",
                         points_key: str | None = None):
    """The stock per-draw chain: color jitter (label-safe for any task),
    plus a paired flip and a pad-2 crop when ``points_key`` names a
    (B, P, 2) pixel-coordinate field. Returns ``fn(seed, batch)``."""
    ops = [color_jitter]
    if points_key is not None:
        ops = [
            random_flip_with_points,
            functools.partial(random_crop_with_points, pad=2),
            color_jitter,
        ]
    return make_batch_augment(*ops, image_key=image_key,
                              points_key=points_key)


__all__ = ["EchoingPipeline", "SampleReservoir", "default_echo_augment"]
