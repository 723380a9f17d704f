"""RLTrainDriver: the actor-learner loop as a MeshTrainDriver (port of
``blendjax/rl/learner.py``).

Actors (:class:`~blendjax_torch.rl.actor.ActorPool`) fill the
:class:`~blendjax_torch.rl.replay.TrajectoryReservoir` from their own
thread while this driver samples: every learner step is one host index
composition and one call of a :mod:`blendjax_torch.rl.steps` step (one
CUDA graph replay when the step is a
:class:`~blendjax_torch.train.CapturedStep`), riding the dispatch ring,
metrics and checkpointing of :class:`~blendjax_torch.train.TrainDriver`.

- :meth:`train_step` holds the reservoir lock from ``draw_token`` through
  ``submit`` (the ring wait runs before it, so an actor insert never waits
  on the card behind the lock), and the inserts queue on this driver's
  stream (:attr:`TrajectoryReservoir.stream`).
- every ``sync_every`` steps the actors get a host copy of the parameters
  (one device-to-host copy, :func:`blendjax_torch.weights.flax_tree`,
  under ``rl.policy_sync``).
- a learner that waits for the reservoir counts ``rl.sample_waits`` and
  spends the ``rl.sample_wait`` span (the doctor's env-bound evidence); a
  dead actor pool or ``sample_timeout_s`` without a batch raises.
- the checkpoint session holds the reservoir, the actor pool and the
  driver's counters (:meth:`restore_session`).

Without a mesh and without a process group the driver runs on one card
(no collective). On a mesh of N ranks every rank runs a driver; the
reservoir's ring is sharded over the batch axes (whole on the ranks of a
model axis) and the ranks agree before each compose on
the inserts applied (:meth:`TrajectoryReservoir.sync_inserts`, which also
carries each rank's timeout and dead-actor signals, so the ranks raise
together), so they compose the same indices; rank 0 runs the actors. A
:class:`~blendjax_torch.train.CapturedStep` of the step (``mesh=``) is
one CUDA graph replay per learner step on an NCCL mesh of any size, the
sharded ring's gather inside it; on a gloo group it runs eagerly
(``eager_calls``).
"""

from __future__ import annotations

# bjx: driver-hot-path (BJX106, BJX108, BJX109, BJX114, BJX116 and
# BJX125 hold here exactly as in driver.py)

import time

import torch

from blendjax_torch.train.mesh_driver import MeshTrainDriver
from blendjax_torch.utils.metrics import metrics

_TIMED_OUT, _ACTOR_DIED = 1, 2


class RLTrainDriver(MeshTrainDriver):
    """Drive an RL learner against a reservoir and an actor pool.

    ``step`` is a :func:`~blendjax_torch.rl.make_dqn_step` /
    :func:`~blendjax_torch.rl.make_pg_step` product over THIS driver's
    ``reservoir`` (or a :class:`~blendjax_torch.train.CapturedStep` of
    one); ``state`` an :class:`~blendjax_torch.rl.RLTrainState`.

    - ``batch_size``: transitions per learner step;
    - ``min_fill``: transitions required before the first step (default
      ``batch_size``);
    - ``sync_every``: the loss-sync cadence of the base driver and the
      actors' policy-refresh cadence;
    - ``sample_timeout_s``: seconds to wait for the reservoir before
      raising.
    """

    def __init__(self, step, state, reservoir, actors=None, *, mesh=None,
                 batch_size: int = 32, min_fill: int | None = None,
                 sample_timeout_s: float = 60.0, **driver_kwargs):
        import torch.distributed as dist

        if mesh is None and dist.is_available() and dist.is_initialized():
            from blendjax_torch.parallel import create_mesh

            mesh = create_mesh({"data": -1}, devices=(
                "cpu" if reservoir.device.type == "cpu" else None))
        self.reservoir = reservoir
        self.actors = actors
        self.batch_size = int(batch_size)
        self.min_fill = int(min_fill if min_fill is not None else batch_size)
        self.sample_timeout_s = float(sample_timeout_s)
        self.sample_waits = 0
        driver_kwargs.setdefault("session_state", self._session_state)
        super().__init__(step, state, mesh, **driver_kwargs)
        if reservoir.device.type == "cuda":
            # inserts queue behind the steps on this driver's stream
            reservoir.stream = torch.cuda.current_stream(reservoir.device)

    def _batch_images(self, batch) -> int:
        # a token's indices are the whole draw on every rank
        idx = batch.get("_rl_idx")
        return int(len(idx)) if idx is not None else super()._batch_images(
            batch)

    # -- the learner loop ---------------------------------------------------------

    def _agree(self, flag: int) -> int:
        """The ranks' queued inserts applied everywhere, and the largest
        of their flags (``flag`` alone off a mesh of several ranks)."""
        return self.reservoir.sync_inserts(flag)

    def _actor_flag(self) -> int:
        if self.actors is not None and self.actors._error is not None:
            return _ACTOR_DIED
        return 0

    def _raise_for(self, flag: int) -> None:
        if flag >= _ACTOR_DIED:
            if self.actors is not None:
                self.actors.check()
            raise RuntimeError("actor loop died on another rank")
        if flag >= _TIMED_OUT:
            raise TimeoutError(
                f"reservoir never reached {self.min_fill} transitions within "
                f"{self.sample_timeout_s}s (size={self.reservoir.size}) — are "
                "the actors running?")

    def _wait_for_batch(self):
        """Block (bounded) until the reservoir can compose a batch: the
        learner's only wait, counted and spanned as the doctor's env-bound
        evidence. A dead actor thread surfaces here on every step."""
        if self.actors is not None:
            self.actors.check()
        self._raise_for(self._agree(self._actor_flag()))
        # one warm-up gate, checked before composing: a compose advances
        # the generator, so a below-fill call must not burn a draw
        if self.reservoir.size >= self.min_fill:
            composed = self.reservoir.compose(self.batch_size)
            if composed is not None:
                return composed
        self.sample_waits += 1
        metrics.count("rl.sample_waits")
        deadline = time.monotonic() + self.sample_timeout_s
        with metrics.span("rl.sample_wait"):
            while True:
                flag = self._actor_flag()
                if time.monotonic() > deadline:
                    flag = max(flag, _TIMED_OUT)
                self._raise_for(self._agree(flag))
                if self.reservoir.size >= self.min_fill:
                    composed = self.reservoir.compose(self.batch_size)
                    if composed is not None:
                        return composed
                time.sleep(0.002)

    def train_step(self) -> None:
        """One learner step: compose host indices, draw a token and submit
        the step, the token and the submit under the reservoir lock; the
        ring wait before it and the loss fetch, checkpoint and policy sync
        after it run outside the lock."""
        idx, weights = self._wait_for_batch()
        self.ensure_ring_slot()
        with self.reservoir.lock:
            token = self.reservoir.draw_token(idx, weights)
            self.submit(token, post=False)
        self.post_dispatch()
        if (self.actors is not None and self.sync_every
                and self.steps % self.sync_every == 0):
            self._sync_policy()

    def _sync_policy(self) -> None:
        """Push a host copy of the parameters to the actors (one
        device-to-host copy of all of them, in flax's layout, which
        :func:`~blendjax_torch.rl.np_mlp_forward` reads)."""
        from blendjax_torch.weights import flax_tree

        with metrics.span("rl.policy_sync"):
            snapshot = flax_tree(self.state.model)
        self.actors.update_policy(snapshot)

    def run_steps(self, n: int, max_seconds: float | None = None):
        """Run ``n`` learner steps (bounded by ``max_seconds``); returns the
        drained final loss."""
        deadline = time.monotonic() + max_seconds if max_seconds else None
        for _ in range(int(n)):
            self.train_step()
            if deadline is not None and time.monotonic() > deadline:
                break
        return self.drain()

    # -- session snapshot ---------------------------------------------------------

    def _session_state(self) -> dict:
        """The reservoir and the actor pool, snapshotted under one hold of
        the reservoir lock (an insert between the two would leave
        ``env_steps`` and ``inserts`` out of step after a resume); the base
        driver adds its counters under ``driver``."""
        with self.reservoir.lock:
            session = {"replay": self.reservoir.state_dict()}
            if self.actors is not None:
                session["actor"] = self.actors.state_dict()
            return session

    def restore_session(self, session: dict) -> list:
        """Load the RL slices of a restored session (either package's)."""
        from blendjax_torch.checkpoint.session import restore_session

        return restore_session(session, replay=self.reservoir,
                               actor=self.actors, driver=self)

    @property
    def stats(self) -> dict:
        s = super().stats
        s["sample_waits"] = self.sample_waits
        s["reservoir"] = self.reservoir.stats
        if self.actors is not None:
            s["actor"] = self.actors.stats
        return s


__all__ = ["RLTrainDriver"]
