"""REINFORCE on the card against a fleet of remote cartpole producers.

The port of the JAX package's ``examples/control/train_reinforce.py``:
batched envs collect rollouts over the RPC plane while the policy/value
update runs on the card (``--device cpu`` keeps it on the host). The
action noise comes from a ``torch.Generator`` seeded with the reference's
key seed (1), on the policy's device.

Run: ``python -m blendjax_torch.examples.control.train_reinforce --iters 20``
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=2)
    ap.add_argument("--horizon", type=int, default=64)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--gamma", type=float, default=0.98)
    ap.add_argument(
        "--device", default="cuda",
        help="'cuda' (the default; raises without a card) or 'cpu'",
    )
    args = ap.parse_args(argv)

    import torch

    from blendjax_torch.device import device_flag
    from blendjax_torch.env import BatchedRemoteEnv
    from blendjax_torch.models import PolicyValueNet

    device = device_flag(args.device)
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "cartpole_producer.py")
    model = PolicyValueNet(action_dim=1).init_params(0).to(device)
    # optax.adam's defaults
    opt = torch.optim.Adam(model.parameters(), lr=args.lr,
                           betas=(0.9, 0.999), eps=1e-8)
    gen = torch.Generator(device=device).manual_seed(1)

    def log_prob(mean, log_std, a):
        var = torch.exp(2 * log_std)
        return -0.5 * (
            ((a - mean) ** 2) / var + 2 * log_std + math.log(2 * math.pi)
        ).sum(-1)

    def update(obs, actions, returns):
        mean, log_std, value = model(obs)
        adv = returns - value
        pg = -(log_prob(mean, log_std, actions) * adv.detach()).mean()
        vloss = (adv ** 2).mean()
        loss = pg + 0.5 * vloss
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    @torch.no_grad()
    def act(obs):
        mean, log_std, _ = model(obs)
        noise = torch.randn(mean.shape, generator=gen, device=device)
        return mean + torch.exp(log_std) * noise

    def on_device(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    history = []
    with BatchedRemoteEnv(script=script, num_envs=args.envs) as venv:
        obs, _ = venv.reset()
        for it in range(args.iters):
            O, A, R, D = [], [], [], []
            for _ in range(args.horizon):
                a = act(on_device(np.asarray(obs, np.float32))).cpu().numpy()
                nobs, reward, done, _ = venv.step(a[:, 0])
                O.append(obs); A.append(a); R.append(reward); D.append(done)
                obs = nobs
            # discounted returns (zeroed across episode boundaries)
            ret = np.zeros(args.envs, np.float32)
            returns = np.zeros((args.horizon, args.envs), np.float32)
            for t in reversed(range(args.horizon)):
                ret = R[t] + args.gamma * ret * (~D[t])
                returns[t] = ret
            loss = update(
                on_device(np.concatenate(O).astype(np.float32)),
                on_device(np.concatenate(A).astype(np.float32)),
                on_device(returns.reshape(-1)),
            )
            mean_reward = float(np.mean(R))
            history.append((mean_reward, float(loss)))
            print(
                f"iter {it}: mean_reward={mean_reward:.3f} "
                f"loss={float(loss):.4f}"
            )
    return {"history": history}


if __name__ == "__main__":
    main()
