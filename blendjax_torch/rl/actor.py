"""ActorPool: background env-stepping threads feeding the reservoir (port
of ``blendjax/rl/actor.py``; host numpy only, copied).

A background thread drives a vector env
(:class:`~blendjax_torch.env.vector.BatchedRemoteEnv`) in lockstep, turns
each vector step into a batch of transitions and inserts them into a
:class:`~blendjax_torch.rl.replay.TrajectoryReservoir`. The actor loop
touches no device value: actions come from a host-side snapshot of the
learner's parameters (:meth:`ActorPool.update_policy`, pushed every
``sync_every`` learner steps from the learner's thread), evaluated in
numpy by :class:`HostQPolicy`.

Bootstrap: auto-reset hands back the fresh episode's first observation,
so the pool reads each done row's ``infos[i]["final_observation"]`` for
``next_obs``.

Metrics: counter ``rl.env_steps``, histograms ``rl.episode_return`` and
``rl.episode_length``, gauge ``rl.epsilon``, counter ``rl.policy_syncs``.
"""

from __future__ import annotations

import threading

import numpy as np

from blendjax_torch.utils.logging import get_logger
from blendjax_torch.utils.metrics import metrics
from blendjax_torch.utils.tg import guard

logger = get_logger("rl")


def np_mlp_forward(params: dict, x: np.ndarray,
                   activation=None) -> np.ndarray:
    """Pure-numpy forward of a flax ``Dense`` stack (``Dense_0`` ..
    ``Dense_k``, kernels (in, out), relu between, linear head): how the
    actor evaluates the learner's host snapshot
    (:func:`blendjax_torch.weights.flax_tree`) without a device call.
    Works for :class:`blendjax_torch.models.QNetwork` and any
    same-shaped MLP head."""
    act = activation if activation is not None else (
        lambda v: np.maximum(v, 0.0)
    )
    layers = sorted(
        (k for k in params if k.startswith("Dense_")),
        key=lambda k: int(k.split("_")[1]),
    )
    if not layers:
        raise ValueError(
            f"no Dense_* layers in snapshot (keys: {sorted(params)})"
        )
    x = np.asarray(x, np.float32)
    for i, name in enumerate(layers):
        layer = params[name]
        x = x @ np.asarray(layer["kernel"]) + np.asarray(layer["bias"])
        if i < len(layers) - 1:
            x = act(x)
    return x


class HostQPolicy:
    """Epsilon-greedy action selection over a host Q-network snapshot.

    ``epsilon`` anneals linearly from ``eps_start`` to ``eps_end`` over
    ``eps_steps`` policy calls; before the first snapshot arrives every
    action is uniform random (the warmup exploration phase). Returns
    int32 ACTION INDICES — map them onto env actions with the pool's
    ``action_map``."""

    def __init__(self, n_actions: int, eps_start: float = 1.0,
                 eps_end: float = 0.05, eps_steps: int = 2000,
                 seed: int = 0):
        self.n_actions = int(n_actions)
        self.eps_start = float(eps_start)
        self.eps_end = float(eps_end)
        self.eps_steps = max(1, int(eps_steps))
        self.calls = 0
        self._rng = np.random.default_rng(seed)

    @property
    def epsilon(self) -> float:
        frac = min(self.calls / self.eps_steps, 1.0)
        return self.eps_start + (self.eps_end - self.eps_start) * frac

    def __call__(self, snapshot, obs: np.ndarray) -> np.ndarray:
        n = obs.shape[0]
        eps = self.epsilon
        self.calls += 1
        metrics.gauge("rl.epsilon", round(eps, 4))
        random_a = self._rng.integers(0, self.n_actions, size=n)
        if snapshot is None:
            return random_a.astype(np.int32)
        q = np_mlp_forward(snapshot, obs)
        greedy = np.argmax(q, axis=-1)
        explore = self._rng.random(n) < eps
        return np.where(explore, random_a, greedy).astype(np.int32)

    def state_dict(self) -> dict:
        return {
            "calls": self.calls,
            "rng": self._rng.bit_generator.state,
        }

    def load_state_dict(self, d: dict) -> None:
        self.calls = int(d["calls"])
        self._rng.bit_generator.state = d["rng"]


class ActorPool:
    """Drive a vector env from a background thread into a reservoir.

    - ``env``: a ``BatchedRemoteEnv``-shaped vector env (``reset() ->
      (obs, infos)``, ``step(actions) -> (obs, reward, done, infos)``
      with auto-reset + ``final_observation`` infos).
    - ``reservoir``: the :class:`~blendjax_torch.rl.replay
      .TrajectoryReservoir` transitions land in.
    - ``policy``: host callable ``fn(snapshot, obs (N, D)) -> actions``
      (e.g. :class:`HostQPolicy`). The snapshot is whatever the learner
      last pushed through :meth:`update_policy` (``None`` until then).
    - ``action_map``: optional per-index env-action lookup (a sequence
      or ``fn(indices) -> env_actions``) — the reservoir stores the
      policy's raw action indices, the env receives mapped actions
      (e.g. discrete index -> motor velocity for the cartpole DQN).
    - ``extra_fields``: optional ``fn(obs, actions, reward, done,
      infos) -> dict`` appended to each transition batch (bootstrap
      metadata beyond the standard five fields).

    Exact accounting: every vector row stepped increments
    ``rl.env_steps`` AND becomes exactly one inserted transition
    (``rl.transitions``), so ``env_steps == reservoir.inserts`` for a
    pool that owns its reservoir — the seq-style identity the bench
    asserts.
    """

    def __init__(self, env, reservoir, policy, action_map=None,
                 extra_fields=None, return_tail: int = 256):
        self.env = env
        # lock discipline, enforced at runtime under threadguard: every
        # reservoir touch from this pool happens inside `with
        # self.reservoir.lock:` (the insert+accounting cut); the lock
        # handle itself is exempt — it must be fetchable to acquire.
        self.reservoir = guard(
            reservoir, name="rl.reservoir", lock=reservoir.lock,
            exempt=("lock",),
        )
        self.policy = policy
        if action_map is not None and not callable(action_map):
            table = np.asarray(action_map)
            action_map = lambda idx: table[np.asarray(idx)]  # noqa: E731
        self.action_map = action_map
        self.extra_fields = extra_fields
        self.env_steps = 0
        self.episodes = 0
        self.policy_version = 0
        self.return_tail = int(return_tail)
        self.episode_returns: list = []  # (env_steps_at_done, return)
        self._snapshot = None
        self._ep_ret = None
        self._ep_len = None
        self._obs = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # -- learner-side surface -------------------------------------------------

    def update_policy(self, snapshot) -> None:
        """Install a fresh host-side param snapshot (nested dicts of numpy
        arrays: the learner copies its parameters to the host on ITS
        thread at the ``sync_every`` cadence and hands the result here;
        a reference swap, no lock needed for the reader)."""
        # Deliberate lock-free publish: a single atomic reference
        # swap; the actor reads whole snapshots only.
        # bjx: ignore[BJX117] — atomic reference publish
        self._snapshot = snapshot
        # ...but the version counter is read-modify-write: share the
        # accounting cut's lock so stats() reads a consistent pair
        with self.reservoir.lock:
            self.policy_version += 1
        metrics.count("rl.policy_syncs")

    # -- the actor loop -------------------------------------------------------

    def _transition(self, obs, actions, nobs, reward, done, infos) -> dict:
        next_obs = np.asarray(nobs)
        if done.any():
            # auto-reset handed back the FRESH episode's first obs;
            # bootstrap targets need the terminal one the vector-env
            # contract parks in infos (satellite: final_observation)
            next_obs = next_obs.copy()
            for i in np.flatnonzero(done):
                fin = infos[i].get("final_observation")
                if fin is not None:
                    next_obs[i] = np.asarray(fin)
        out = {
            "obs": np.asarray(obs, np.float32),
            "action": np.asarray(actions),
            "reward": np.asarray(reward, np.float32),
            "done": np.asarray(done, bool),
            "next_obs": next_obs.astype(np.float32),
        }
        if self.extra_fields is not None:
            out.update(
                self.extra_fields(obs, actions, reward, done, infos)
            )
        return out

    def _account_episodes(self, reward, done) -> None:
        self._ep_ret += reward
        self._ep_len += 1
        for i in np.flatnonzero(done):
            ret = float(self._ep_ret[i])
            self.episodes += 1
            self.episode_returns.append((self.env_steps, ret))
            del self.episode_returns[: -self.return_tail]
            metrics.observe("rl.episode_return", ret)
            metrics.observe("rl.episode_length", int(self._ep_len[i]))
            self._ep_ret[i] = 0.0
            self._ep_len[i] = 0

    def _run(self) -> None:
        try:
            if self._obs is None:
                obs, _ = self.env.reset()
                self._obs = np.asarray(obs, np.float32)
                n = self._obs.shape[0]
                self._ep_ret = np.zeros(n, np.float64)
                self._ep_len = np.zeros(n, np.int64)
            while not self._stop.is_set():
                obs = self._obs
                actions = self.policy(self._snapshot, obs)
                env_actions = (
                    self.action_map(actions)
                    if self.action_map is not None else actions
                )
                nobs, reward, done, infos = self.env.step(env_actions)
                trans = self._transition(
                    obs, actions, nobs, reward, done, infos
                )
                # insert + counter/episode accounting as ONE cut under
                # the reservoir lock (reentrant — insert takes it too):
                # a checkpoint snapshotting reservoir-then-actor under
                # the same lock can never capture inserts and
                # env_steps mid-update, which would break the exact
                # env_steps == inserts identity forever after a resume
                with self.reservoir.lock:
                    self.reservoir.insert(trans)
                    self.env_steps += len(done)
                    self._account_episodes(reward, done)
                metrics.count("rl.env_steps", len(done))
                self._obs = np.asarray(nobs, np.float32)
        except BaseException as e:  # surfaced by the learner's check()
            if not self._stop.is_set():
                # Single-writer atomic reference publish; check()
                # only ever reads None -> exception.
                # bjx: ignore[BJX117] — atomic reference publish
                self._error = e
                logger.exception("actor loop died")

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "ActorPool":
        assert self._thread is None, "already started"
        # a restart after a transient death must come up healthy: a
        # stale error would make every check() re-raise forever
        self._error = None
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="blendjax-rl-actor", daemon=True
        )
        self._thread.start()
        return self

    def check(self) -> None:
        """Raise the actor thread's error into the caller (the learner
        polls this between steps — a dead actor must not starve the
        run silently)."""
        if self._error is not None:
            raise RuntimeError("actor loop died") from self._error

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def __enter__(self) -> "ActorPool":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- observability / session snapshot -------------------------------------

    @property
    def stats(self) -> dict:
        # Same critical section as the actor's insert+accounting cut:
        # an unlocked read here could pair a post-episode `episodes`
        # with a pre-episode `episode_returns` (BJX117).
        with self.reservoir.lock:
            recent = [r for _, r in self.episode_returns[-32:]]
            return {
                "env_steps": self.env_steps,
                "episodes": self.episodes,
                "policy_version": self.policy_version,
                "mean_return": (
                    round(float(np.mean(recent)), 3) if recent else None
                ),
            }

    def state_dict(self) -> dict:
        """Host counters + the reward-curve tail + the policy's
        exploration state, read under the reservoir lock so the cut is
        consistent with the actor's insert+accounting critical section
        (and with a reservoir snapshot taken under the same lock:
        :meth:`RLTrainDriver._session_state` holds it across both).
        Env processes restart fresh on resume (their episodes are
        transient by design — lineage reads producer restarts, not
        drops), so no env state is persisted."""
        with self.reservoir.lock:
            return self._state_dict_locked()

    def _state_dict_locked(self) -> dict:
        d = {
            "env_steps": self.env_steps,
            "episodes": self.episodes,
            "policy_version": self.policy_version,
            "episode_returns": [
                [int(s), float(r)] for s, r in self.episode_returns
            ],
        }
        pol_sd = getattr(self.policy, "state_dict", None)
        if pol_sd is not None:
            d["policy"] = pol_sd()
        return d

    def load_state_dict(self, d: dict) -> None:
        if self._thread is not None:
            raise RuntimeError(
                "load_state_dict must run before the actor starts"
            )
        # The actor thread can't be running (checked above), but the
        # restore still takes the accounting cut's lock so a concurrent
        # stats()/state_dict() reader sees old-or-new, never a mix.
        with self.reservoir.lock:
            self.env_steps = int(d["env_steps"])
            self.episodes = int(d["episodes"])
            self.policy_version = int(d.get("policy_version", 0))
            self.episode_returns = [
                (int(s), float(r)) for s, r in d.get("episode_returns", [])
            ]
        pol = d.get("policy")
        if pol is not None and hasattr(self.policy, "load_state_dict"):
            self.policy.load_state_dict(pol)


__all__ = ["ActorPool", "HostQPolicy", "np_mlp_forward"]
