"""Gymnasium adapter for remote-controlled producer environments (copied
from ``blendjax/env/gymnasium_adapter.py``): Gymnasium's API (the
terminated/truncated split, ``reset(seed=...) -> (obs, info)``) over a
launched :class:`~blendjax_torch.env.RemoteEnv`."""

from __future__ import annotations

import gymnasium
import numpy as np

from blendjax_torch.env.remote import launch_env


class GymnasiumRemoteEnv(gymnasium.Env):
    """A Gymnasium env whose physics run in a launched producer process.

    ``script`` is the producer; the spaces describe the remote env; other
    keyword arguments become the producer's CLI flags.
    """

    metadata = {"render_modes": ["human", "rgb_array"]}

    def __init__(
        self,
        script: str,
        scene: str = "",
        observation_space=None,
        action_space=None,
        render_mode: str | None = None,
        real_time: bool = False,
        max_episode_steps: int | None = None,
        **launch_kwargs,
    ):
        self.render_mode = render_mode
        self.observation_space = observation_space or gymnasium.spaces.Box(
            -np.inf, np.inf, shape=(4,), dtype=np.float32
        )
        self.action_space = action_space or gymnasium.spaces.Box(
            -1.0, 1.0, shape=(1,), dtype=np.float32
        )
        self.max_episode_steps = max_episode_steps
        self._elapsed = 0
        self._ctx = launch_env(
            script=script, scene=scene, real_time=real_time, **launch_kwargs
        )
        self._env = self._ctx.__enter__()

    def reset(self, *, seed=None, options=None):
        super().reset(seed=seed)
        self._elapsed = 0
        # the seed crosses the wire: the producer's episode RNG sets the
        # initial state, so seeding the local np_random alone would leave
        # seeded resets non-deterministic
        obs, info = self._env.reset(seed=seed)
        return self._obs(obs), info

    def step(self, action):
        if isinstance(action, np.ndarray) and action.size == 1:
            action = float(action.reshape(()))
        obs, reward, done, info = self._env.step(action)
        self._elapsed += 1
        truncated = (
            self.max_episode_steps is not None
            and self._elapsed >= self.max_episode_steps
        )
        return self._obs(obs), reward, bool(done), bool(truncated), info

    def _obs(self, obs):
        if obs is None:
            return None
        return np.asarray(obs).astype(self.observation_space.dtype)

    def render(self):
        if self.render_mode in ("rgb_array", "human"):
            return self._env.render(mode=self.render_mode)
        return None

    def close(self):
        self._ctx.__exit__(None, None, None)


class OpenAIRemoteEnv(GymnasiumRemoteEnv):
    """The classic gym call shape over the Gymnasium adapter: ``reset() ->
    obs`` and ``step() -> (obs, reward, done, info)`` with ``done =
    terminated or truncated``, without importing ``gym``."""

    def reset(self, **kwargs):  # type: ignore[override]
        obs, _info = super().reset(**kwargs)
        return obs

    def step(self, action):  # type: ignore[override]
        obs, reward, terminated, truncated, info = super().step(action)
        return obs, reward, bool(terminated or truncated), info
