"""TrajectoryReservoir: device-resident replay of transitions (port of
``blendjax/rl/replay.py``).

Transitions are flat dicts of arrays sharing a leading dim (``obs``,
``action``, ``reward``, ``done``, ``next_obs`` and any bootstrap field an
actor attaches). They live in a ring preallocated on the card
(:mod:`blendjax_torch.data.ring`), one tensor per field, beside a
per-slot priority vector, also on the card. Both are updated in place for
the life of the run: their ``data_ptr()`` never moves (the port's
counterpart of the reference's donation audit), so a CUDA graph of the
learner step reads them where they are.

- ``insert`` writes the rows and stamps the new slots' priorities to the
  running max. It runs on the actor thread, so it queues its work on the
  learner's stream (:attr:`stream`) and under :attr:`lock`: a lock alone
  does not order work on two CUDA streams. The host rows go through
  pinned buffers (one ring per field, each reused once its copy is done),
  so an insert never waits for the learner's queued steps.
- indices are chosen on the host (:meth:`compose`): uniform draws from
  the filled slots, or prioritized draws from a host mirror of the
  priorities refreshed every ``priority_refresh_every`` draws (one
  (capacity,) fetch, under ``rl.priority_sync``), with the reference's
  numpy generator, so both packages draw the same indices.
- a learner step is one CUDA graph replay: :meth:`draw_token` hands the
  step (:mod:`blendjax_torch.rl.steps`) the ring and the priorities by
  reference with the host indices, importance weights and the write-back
  slots (``_rl_write``: each drawn slot's last occurrence, and the spare
  slot past the end for the others, so the priority write-back of a draw
  that repeats a slot is deterministic where XLA's scatter is not).

On a mesh (``mesh=`` / ``sharding=``) the ring is sharded over the batch
axes (:func:`blendjax_torch.parallel.ring_sharding`; whole on every rank
of a mesh whose batch axes have one rank, such as ``{"data": 1, "tp":
2}``); the priority vector stays whole on every rank. On a mesh of
several ranks inserts are queued on the rank that makes them
and applied on every rank by :meth:`sync_inserts`, a collective the
learner runs before each compose: the ranks all-gather their queued
transitions over a gloo group of their own and apply them in rank order,
each writing the slots of its shard, so their host accounting and numpy
generator stay identical and they compose the same indices.

Metrics (the reference's ``rl.*`` names): counters ``rl.transitions``,
``rl.draws``, ``rl.fresh``, ``rl.replayed``; gauges ``rl.reservoir_fill``,
``rl.replay_ratio``; histogram ``rl.sample_age_s``; spans ``rl.insert``,
``rl.sample``, ``rl.priority_sync``.
"""

from __future__ import annotations

# bjx: driver-hot-path (BJX106/BJX108: accounting runs on host-chosen
# indices; the one priority-mirror fetch is cadence-bounded, see
# _refresh_priorities; BJX109, BJX116 and BJX125 hold in this module)

import contextlib
import threading
import time

import numpy as np
import torch

from blendjax_torch.device import HostStager, resolve_device
from blendjax_torch.utils.metrics import metrics


def _as_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


# bjx: thread-shared (actor pool inserts from its thread while the
# learner draws: every public entry point must hold `lock` — BJX117)
class TrajectoryReservoir:
    """Ring of the last ``capacity`` transitions on the card.

    - ``prioritized``: proportional prioritized sampling (``p_i^alpha``);
      new rows start at the running max priority, the learner overwrites
      a drawn row's priority with its ``|TD| + eps``.
    - ``alpha`` / ``beta``: sampling sharpness and importance-weight
      correction; weights are normalized by their batch max and ride the
      token as ``_rl_weights`` (all ones under uniform sampling).
    - ``priority_refresh_every``: draws between host-mirror refreshes.
    - ``mesh`` / ``sharding``: shard the ring over the mesh's batch axes.
    - ``device``: ``cuda`` unless ``"cpu"``. Inserts queue on
      :attr:`stream`, the current CUDA stream at construction
      (:class:`~blendjax_torch.rl.RLTrainDriver` sets it to its own).
    """

    def __init__(self, capacity: int, rng=0, mesh=None, sharding=None,
                 prioritized: bool = False, alpha: float = 0.6,
                 beta: float = 0.4, priority_eps: float = 1e-3,
                 priority_refresh_every: int = 16, device=None):
        from blendjax_torch.data.ring import (
            make_ring_gather,
            validate_ring_capacity,
        )

        self.capacity = int(capacity)
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if sharding is None and mesh is not None:
            from blendjax_torch.parallel.sharding import ring_sharding

            sharding = ring_sharding(mesh)
        validate_ring_capacity(self.capacity, sharding)
        self.sharding = sharding
        self.device = resolve_device(device)
        self.stream = (torch.cuda.current_stream(self.device)
                       if self.device.type == "cuda" else None)
        self.prioritized = bool(prioritized)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.priority_eps = float(priority_eps)
        self.priority_refresh_every = max(1, int(priority_refresh_every))
        self.lock = threading.RLock()
        seed = rng if isinstance(rng, int) else 0
        self._np_rng = np.random.default_rng(seed)
        self._buffers = None  # {field: device tensor}
        self._prio_store = None  # (capacity + 1,): the last slot is spare
        self._priorities = None  # view of the first capacity slots
        self._spec: dict | None = None
        # fixed by the capacity and the layout, so set before the ring is
        # shared: draw() reads it without the lock
        self._gather_fn = make_ring_gather(self.capacity, sharding)
        self._pinned = HostStager()
        self._agreement = None
        self._pending: list = []  # a mesh rank's queued inserts
        self._cursor = 0
        self.size = 0
        self.inserts = 0
        self._draws = 0
        self._pmax = 1.0
        self._use = np.zeros(self.capacity, np.int64)
        self._t_insert = np.zeros(self.capacity, np.float64)
        self._filled = np.zeros(self.capacity, bool)
        self._prio_host = np.ones(self.capacity, np.float32)
        self._draws_at_refresh = 0
        self.fresh = 0
        self.replayed = 0

    # -- the ring -------------------------------------------------------------

    @property
    def ways(self) -> int:
        from blendjax_torch.data.ring import ring_ways

        return ring_ways(self.sharding)

    @property
    def agrees(self) -> bool:
        """Whether inserts are agreed across ranks: the ring's mesh has
        more than one rank (a ring sharded over the batch axes, or whole
        on every rank of a model axis, whose ranks train the same rows)."""
        from blendjax_torch.parallel.sharding import mesh_chip_count

        return (self.sharding is not None
                and mesh_chip_count(self.sharding.mesh) > 1)

    def _build(self, fields: dict, initial=None, prio_initial=None) -> None:
        """Allocate the ring from one example batch of host arrays (or
        place a restored ``initial``) and the priority vector."""
        from blendjax_torch.data.ring import allocate_ring, ring_spec

        tensors = {k: torch.from_numpy(np.ascontiguousarray(v[:1]))
                   for k, v in fields.items()}
        self._spec = ring_spec(tensors)
        if initial is not None:
            self._buffers = allocate_ring(
                self.capacity, sharding=self.sharding, device=self.device,
                initial={k: np.ascontiguousarray(v)
                         for k, v in initial.items()})
        else:
            self._buffers = allocate_ring(
                self.capacity, fields={k: t.to(self.device)
                                       for k, t in tensors.items()},
                sharding=self.sharding)
        store = torch.ones(self.capacity + 1, dtype=torch.float32)
        if prio_initial is not None:
            store[:self.capacity] = torch.from_numpy(
                np.asarray(prio_initial, np.float32))
        self._prio_store = store.to(self.device)
        self._priorities = self._prio_store[:self.capacity]

    def _on_stream(self):
        """Queue the work inside on :attr:`stream` (the learner's)."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def _write(self, rows: dict, cursor: int, pmax: float) -> None:
        """Write one batch of host rows at ``cursor`` (wrapping) and stamp
        their slots' priorities, on :attr:`stream`."""
        from blendjax_torch.data.ring import _shard_range

        lead = int(next(iter(rows.values())).shape[0])
        slots = (cursor + np.arange(lead)) % self.capacity
        first, local = _shard_range(self.capacity, self.sharding)
        mine = np.flatnonzero((slots >= first) & (slots < first + local))
        with self._on_stream():
            # contiguous runs of this rank's slots: at most three
            runs = np.split(mine, np.flatnonzero(np.diff(slots[mine]) != 1) + 1)
            for run in runs:
                if not len(run):
                    continue
                dst0 = int(slots[run[0]]) - first
                n = len(run)
                for k, buf in self._buffers.items():
                    self._pinned.copy(buf[dst0:dst0 + n], rows[k][run])
            for run in np.split(slots, np.flatnonzero(np.diff(slots) != 1) + 1):
                self._priorities[int(run[0]):int(run[0]) + len(run)].fill_(pmax)

    def _check(self, transitions: dict) -> None:
        from blendjax_torch.data.ring import ring_spec

        spec = ring_spec({k: torch.from_numpy(np.ascontiguousarray(v[:1]))
                          for k, v in transitions.items()})
        if set(spec) != set(self._spec):
            raise ValueError(
                "transition structure changed: reservoir holds "
                f"{sorted(self._spec)}, insert got {sorted(spec)}")
        for k, (shape, dtype) in spec.items():
            eshape, edtype = self._spec[k]
            if shape != eshape or dtype != edtype:
                raise ValueError(
                    f"field {k}: got {shape}/{dtype}, reservoir holds "
                    f"{eshape}/{edtype}")

    # -- operations -------------------------------------------------------------

    def insert(self, transitions: dict) -> np.ndarray:
        """Write one batch of transitions (a flat dict of arrays sharing a
        leading dim); returns the host slot-index vector. Thread-safe: the
        actor pool calls this from its own thread while the learner draws.
        On a mesh of several ranks the batch is queued until
        :meth:`sync_inserts` applies it on every rank (the slots it will
        take are returned)."""
        if not isinstance(transitions, dict) or not transitions:
            raise ValueError("insert() needs at least one array field")
        rows = {k: _as_numpy(v) for k, v in transitions.items()}
        lead = int(next(iter(rows.values())).shape[0])
        if any(v.shape[0] != lead for v in rows.values()):
            raise ValueError(
                "transition fields must share one leading dim; got "
                f"{[v.shape[0] for v in rows.values()]}")
        if lead > self.capacity:
            rows = {k: v[-self.capacity:] for k, v in rows.items()}
            lead = self.capacity
        with self.lock:
            if self._spec is None:
                self._build(rows)
            else:
                self._check(rows)
            if self.agrees:
                queued = sum(int(next(iter(r.values())).shape[0])
                             for r in self._pending)
                self._pending.append(rows)
                return (self._cursor + queued + np.arange(lead)) % self.capacity
            return self._apply(rows)

    def _apply(self, rows: dict) -> np.ndarray:
        lead = int(next(iter(rows.values())).shape[0])
        with metrics.span("rl.insert"):
            self._write(rows, self._cursor, self._pmax)
        slots = (self._cursor + np.arange(lead)) % self.capacity
        self._cursor = (self._cursor + lead) % self.capacity
        self.size = min(self.size + lead, self.capacity)
        self.inserts += lead
        self._use[slots] = 0
        self._t_insert[slots] = time.monotonic()
        self._filled[slots] = True
        self._prio_host[slots] = self._pmax
        fill = int(self._filled.sum())
        metrics.count("rl.transitions", lead)
        metrics.gauge("rl.reservoir_fill", fill)
        return slots

    def sync_inserts(self, flag: int = 0) -> int:
        """Apply every rank's queued inserts on every rank, in rank order (a
        collective over a gloo group of the mesh's ranks: every rank calls
        it, as often as the others). ``flag`` is a small int each rank
        contributes (the learner's timeout and dead-actor signals); the
        largest is returned. A no-op returning ``flag`` off a mesh of
        several ranks."""
        if not self.agrees:
            return int(flag)
        import torch.distributed as dist

        from blendjax_torch.parallel.mesh import RankAgreement

        with self.lock:
            pending, self._pending = self._pending, []
            if self._agreement is None:
                self._agreement = RankAgreement(self.sharding.mesh)
            agreement = self._agreement
        gathered: list = [None] * len(agreement.ranks)
        dist.all_gather_object(gathered, (int(flag), pending),
                               group=agreement.group)
        with self.lock:
            for _flag, batches in gathered:
                for rows in batches:
                    if self._spec is None:
                        self._build(rows)
                    self._apply(rows)
        return max(int(f) for f, _ in gathered)

    # -- host-side draw composition ---------------------------------------------

    def _refresh_priorities(self) -> None:
        """The cadence-bounded host mirror of the device priorities: one
        (capacity,) copy every ``priority_refresh_every`` draws."""
        with metrics.span("rl.priority_sync"):
            self._prio_host = self._priorities.detach().cpu().numpy().copy()
        np.maximum(self._prio_host, self.priority_eps, out=self._prio_host)
        if self._filled.any():
            # the true running max, even once |TD| falls below 1
            self._pmax = float(self._prio_host[self._filled].max())
        self._draws_at_refresh = self._draws

    def compose(self, batch_size: int):
        """``batch_size`` slot indices (with replacement) and their
        importance weights, or ``None`` while the reservoir is empty. Host
        work only, with the reference's numpy draws."""
        b = int(batch_size)
        with self.lock:
            if self.size < 1 or self._buffers is None:
                return None
            slots = np.flatnonzero(self._filled)
            if self.prioritized:
                if (self._draws - self._draws_at_refresh
                        >= self.priority_refresh_every):
                    self._refresh_priorities()
                p = self._prio_host[slots].astype(np.float64) ** self.alpha
                p /= p.sum()
                idx = self._np_rng.choice(slots, size=b, p=p)
                chosen = p[np.searchsorted(slots, idx)]
                w = (len(slots) * chosen) ** -self.beta
                weights = (w / w.max()).astype(np.float32)
            else:
                idx = self._np_rng.choice(slots, size=b)
                weights = np.ones(b, np.float32)
        return np.asarray(idx, np.int32), weights

    # -- draws --------------------------------------------------------------------

    def _account_draw(self, idx: np.ndarray) -> None:
        # a slot drawn twice in one batch is one fresh + one replay, so
        # fresh + replayed == draws * batch exactly
        first = np.zeros(len(idx), bool)
        first[np.unique(idx, return_index=True)[1]] = True
        fresh_rows = first & (self._use[idx] == 0)
        fresh_n = int(fresh_rows.sum())
        np.add.at(self._use, idx, 1)
        self.fresh += fresh_n
        self.replayed += len(idx) - fresh_n
        self._draws += 1
        metrics.count("rl.draws")
        metrics.count("rl.fresh", fresh_n)
        metrics.count("rl.replayed", len(idx) - fresh_n)
        metrics.observe_many("rl.sample_age_s",
                             time.monotonic() - self._t_insert[idx])
        drawn = self.fresh + self.replayed
        metrics.gauge("rl.replay_ratio",
                      round(self.replayed / drawn, 4) if drawn else 0.0)

    def write_slots(self, idx) -> np.ndarray:
        """The priority write-back slots of a draw: each slot's last
        occurrence in ``idx`` keeps it, every earlier occurrence writes the
        spare slot ``capacity`` (never read), so each real slot is written
        once and the result does not depend on the scatter's order."""
        idx = np.asarray(idx, np.int64)
        out = np.full(len(idx), self.capacity, np.int32)
        last = len(idx) - 1 - np.unique(idx[::-1], return_index=True)[1]
        out[last] = idx[last]
        return out

    def draw_token(self, idx, weights=None) -> dict:
        """The token a learner step consumes: the ring and the priority
        vector (with its spare slot) by reference, the host indices, the
        importance weights and the write-back slots. No device work; hold
        :attr:`lock` from here through the step's dispatch (the learner
        driver does)."""
        idx = np.asarray(idx, np.int32)
        if weights is None:
            weights = np.ones(len(idx), np.float32)
        with self.lock:
            if self._buffers is None:
                raise RuntimeError("reservoir is empty: insert() first")
            self._account_draw(idx)
            return {
                "_by_reference": ("_rl_buffers", "_rl_prio"),
                "_rl_buffers": self._buffers,
                "_rl_prio": self._prio_store,
                "_rl_idx": idx,
                "_rl_weights": np.asarray(weights, np.float32),
                "_rl_write": self.write_slots(idx),
            }

    def commit_priorities(self, new_priorities) -> None:
        """Take a priority vector into the device one, in place (the
        learner steps already write it in place; this is for callers that
        hold a new one)."""
        with self.lock:
            new = torch.as_tensor(new_priorities, dtype=torch.float32)
            if new.data_ptr() != self._prio_store.data_ptr():
                self._priorities.copy_(new.reshape(-1)[:self.capacity])

    def draw(self, buffers, idx):
        """The gather the learner steps run inside their call: rows ``idx``
        of every field, this rank's rows on a mesh."""
        return self._gather_fn(buffers, idx)

    def sample(self, idx) -> dict:
        """An eager gather of ``idx`` rows (inspection and tests), with the
        accounting the fused path keeps."""
        idx = np.asarray(idx, np.int32)
        with self.lock:
            if self._buffers is None:
                raise RuntimeError("reservoir is empty: insert() first")
            self._account_draw(idx)
            with metrics.span("rl.sample"):
                return self._gather_fn(self._buffers, idx)

    def device_buffers(self) -> dict:
        """``{field: tensor}`` of the ring, with the priority store under
        ``_priorities``: the same tensors for the run, written in place
        (the input of :class:`blendjax_torch.testing.DonationAudit`)."""
        with self.lock:
            out = dict(self._buffers or {})
            if self._prio_store is not None:
                out["_priorities"] = self._prio_store
            return out

    @property
    def fields(self) -> tuple:
        with self.lock:
            return tuple(self._spec) if self._spec else ()

    @property
    def stats(self) -> dict:
        with self.lock:
            drawn = self.fresh + self.replayed
            return {
                "size": self.size,
                "inserts": self.inserts,
                "draws": self._draws,
                "fresh": self.fresh,
                "replayed": self.replayed,
                "replay_ratio": (round(self.replayed / drawn, 4)
                                 if drawn else None),
                "prioritized": self.prioritized,
                "pmax": round(self._pmax, 6),
            }

    # -- session snapshot ---------------------------------------------------------

    def state_dict(self) -> dict:
        """Ring, priorities, host accounting and the generator state, the
        reference's keys (restorable by either package). The ring and
        priorities are device clones taken under the lock on
        :attr:`stream` (the snapshot writer copies them to the host later);
        a sharded ring is gathered whole on every rank. Insert times are
        stored as ages."""
        with self.lock:
            now = time.monotonic()
            d = {
                "capacity": self.capacity,
                "cursor": self._cursor,
                "size": self.size,
                "inserts": self.inserts,
                "draws": self._draws,
                "fresh": self.fresh,
                "replayed": self.replayed,
                "pmax": self._pmax,
                "prioritized": self.prioritized,
                "use": self._use.copy(),
                "filled": self._filled.copy(),
                "age_s": now - self._t_insert,
                "prio_host": self._prio_host.copy(),
                "rng": self._np_rng.bit_generator.state,
                "built": self._buffers is not None,
            }
            if self._buffers is not None:
                with self._on_stream():
                    d["buffers"] = {k: self._whole(v).clone()
                                    for k, v in self._buffers.items()}
                    d["priorities"] = self._priorities.clone()
            return d

    def _whole(self, buf: torch.Tensor) -> torch.Tensor:
        if self.ways <= 1:
            return buf
        from blendjax_torch.parallel.collectives import all_gather
        from blendjax_torch.parallel.sharding import leading_axes

        return all_gather(buf, self.sharding.mesh, leading_axes(self.sharding),
                          differentiable=False)

    def load_state_dict(self, d: dict) -> None:
        """Rebuild from a snapshot of either package, under this
        reservoir's own sharding; the draw counters and the generator state
        make the resumed sampling continue the uninterrupted run's."""
        if int(d["capacity"]) != self.capacity:
            raise ValueError(
                f"snapshot reservoir capacity {d['capacity']} != configured "
                f"{self.capacity}")
        with self.lock:
            self._cursor = int(d["cursor"])
            self.size = int(d["size"])
            self.inserts = int(d["inserts"])
            self._draws = int(d["draws"])
            self.fresh = int(d.get("fresh", 0))
            self.replayed = int(d.get("replayed", 0))
            self._pmax = float(d.get("pmax", 1.0))
            self._use = np.asarray(d["use"], np.int64).copy()
            self._filled = np.asarray(d["filled"], bool).copy()
            now = time.monotonic()
            self._t_insert = now - np.asarray(d["age_s"], np.float64)
            self._prio_host = np.asarray(d["prio_host"], np.float32).copy()
            self._np_rng.bit_generator.state = d["rng"]
            self._draws_at_refresh = self._draws
            self._pending = []
            if not d.get("built"):
                return
            bufs = {k: _as_numpy(v) for k, v in d["buffers"].items()}
            prio = _as_numpy(d["priorities"]).astype(np.float32)
            if self._buffers is None:
                self._build(bufs, initial=bufs, prio_initial=prio)
                return
            # restore in place: a captured learner graph keeps reading the
            # same storage
            from blendjax_torch.data.ring import _shard_range

            first, local = _shard_range(self.capacity, self.sharding)
            with torch.no_grad():
                for k, buf in self._buffers.items():
                    src = torch.from_numpy(np.ascontiguousarray(
                        bufs[k][first:first + local]))
                    buf.copy_(src.to(buf.dtype))
                self._priorities.copy_(torch.from_numpy(prio))


__all__ = ["TrajectoryReservoir"]
