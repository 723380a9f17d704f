"""Balance the remote cartpole with a hand-tuned controller.

The port of the JAX package's ``examples/control/cartpole.py``: a
proportional controller on the pole angle drives the motor velocity
through ``gymnasium.make("blendjax_torch/Cartpole-v0")``, the headless env
that ``import blendjax_torch.env`` registers. Nothing here places tensors,
so it takes no ``--device``.

Run: ``python -m blendjax_torch.examples.control.cartpole``
"""

from __future__ import annotations

import argparse

import gymnasium
import numpy as np

import blendjax_torch.env  # noqa: F401  (registers blendjax_torch/Cartpole-v0)


def control(obs) -> float:
    """P(D)-controller: push the cart under the falling pole."""
    x, x_dot, theta, theta_dot = np.asarray(obs, np.float32)
    return float(8.0 * theta + 1.0 * theta_dot + 0.2 * x)


def main(steps_total: int = 300, argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=steps_total,
                    help="env steps to run")
    args = ap.parse_args(argv)
    env = gymnasium.make("blendjax_torch/Cartpole-v0", seed=3, proto="ipc")
    episodes = []
    try:
        obs, _ = env.reset()
        total, steps = 0.0, 0
        for _ in range(args.steps):
            obs, reward, terminated, truncated, info = env.step(
                np.array([control(obs)], np.float32)
            )
            total += reward
            steps += 1
            if terminated or truncated:
                print(f"episode end after {steps} steps, return {total}")
                episodes.append((steps, total))
                obs, _ = env.reset()
                total, steps = 0.0, 0
        print(f"final: {steps} steps balanced, return {total}")
    finally:
        env.close()
    return {"episodes": episodes, "final_steps": steps, "final_return": total}


if __name__ == "__main__":
    main()
