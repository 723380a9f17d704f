"""Producer script: a remote-controlled cartpole environment (copied from
``blendjax/producer/scripts/cartpole.py``).

The physics run in :class:`blendjax_torch.producer.sim.CartpoleScene`; the
episodes and the RPC are :class:`~blendjax_torch.producer.BaseEnv` and
:class:`~blendjax_torch.producer.RemoteControlledAgent` on the launcher's
``GYM`` socket. The Gymnasium id ``blendjax_torch/Cartpole-v0``
(:mod:`blendjax_torch.env.registry`) launches this file.

Flags: ``--real-time`` switches the agent to free-running mode;
``--render-every N`` sends the scene's rgb frame every N frames.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from blendjax_torch.producer import (
    BaseEnv,
    RemoteControlledAgent,
    parse_launch_args,
)
from blendjax_torch.producer.sim import CartpoleScene, SimEngine
from blendjax_torch.transport import term_context


class CartpoleEnv(BaseEnv):
    def __init__(self, agent, scene: CartpoleScene):
        super().__init__(agent)
        self.scene = scene

    def _env_reset(self):
        self.scene.reset()

    def _env_prepare_step(self, action):
        self.scene.apply_motor(float(np.asarray(action).reshape(())))

    def _env_post_step(self):
        x, x_dot, th, th_dot = self.scene.state
        done = bool(abs(th) > 0.4 or abs(x) > 3.0)
        return {
            "obs": self.scene.observation_vector(),
            "reward": 0.0 if done else 1.0,
            "done": done,
        }

    def _default_renderer(self):
        return self.scene.render


def main() -> None:
    args, remainder = parse_launch_args(sys.argv)
    ap = argparse.ArgumentParser()
    ap.add_argument("--real-time", action="store_true", default=False)
    ap.add_argument("--no-real-time", dest="real_time", action="store_false")
    ap.add_argument("--render-every", type=int, default=0)
    opts = ap.parse_args(remainder)

    scene = CartpoleScene(seed=args.btseed)
    agent = RemoteControlledAgent(
        args.btsockets["GYM"], real_time=opts.real_time
    )
    env = CartpoleEnv(agent, scene)
    if opts.render_every > 0:
        env.attach_default_renderer(every_nth=opts.render_every)
    try:
        env.run(SimEngine(scene))
    finally:
        agent.close()
        term_context()


if __name__ == "__main__":
    main()
