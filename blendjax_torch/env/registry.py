"""Gymnasium registry entry of the port's built-in environment (copied
from ``blendjax/env/registry.py``): importing :mod:`blendjax_torch.env`
registers ``blendjax_torch/Cartpole-v0``, which launches the port's
packaged headless producer (:mod:`blendjax_torch.producer.scripts.cartpole`).
``gymnasium.make`` keyword arguments go to the factory (``real_time=True``,
``render_mode='rgb_array'``). The JAX package's ids (``blendjax/...`` and
its legacy alias) stay the JAX package's.
"""

from __future__ import annotations

import os

import gymnasium
import numpy as np

from blendjax_torch.env.gymnasium_adapter import GymnasiumRemoteEnv

CARTPOLE_SCRIPT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "producer", "scripts", "cartpole.py",
)

ENV_IDS = ("blendjax_torch/Cartpole-v0",)


def make_cartpole(render_mode: str | None = None, **kwargs):
    """Factory behind the cartpole id."""
    render_every = kwargs.pop("render_every", 0)
    # both render modes need the producer to render frames
    if render_mode in ("rgb_array", "human") and not render_every:
        render_every = 1
    launch_kwargs = dict(kwargs)
    if render_every:
        launch_kwargs["render_every"] = render_every
    # Unbounded spaces: the terminal observation lands outside the
    # termination box (|theta| > 0.4, |x| > 3.0), which bounded limits
    # would flag in Gymnasium's env checker; the action is the motor's
    # target velocity.
    return GymnasiumRemoteEnv(
        script=CARTPOLE_SCRIPT,
        observation_space=gymnasium.spaces.Box(
            -np.inf, np.inf, shape=(4,), dtype=np.float32
        ),
        action_space=gymnasium.spaces.Box(
            -np.inf, np.inf, shape=(1,), dtype=np.float32
        ),
        render_mode=render_mode,
        **launch_kwargs,
    )


def register_envs() -> None:
    """Register the built-in envs with Gymnasium (idempotent)."""
    for env_id in ENV_IDS:
        if env_id not in gymnasium.registry:
            gymnasium.register(
                id=env_id,
                entry_point="blendjax_torch.env.registry:make_cartpole",
                max_episode_steps=500,
            )
