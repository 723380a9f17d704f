"""DQN on cartpole through the port's RL stack (``blendjax_torch.rl``).

The port of the JAX package's ``examples/control/train_dqn.py``. Where
``train_reinforce.py`` collects synchronous rollouts by hand, this example
runs the actor-learner shape: background actors drive a fleet of remote
cartpole producers against a host-side policy snapshot, transitions land in
the ``TrajectoryReservoir`` on the card (prioritized by default), and the
learner trains at full step rate with one step call per step (gather + TD
loss + update + priority write-back), one CUDA graph replay on the card
(``--device cpu``: eager). ``--checkpoint DIR`` arms the session store
(the port's ``SnapshotManager``, the JAX package's format) so a killed run
resumes mid-curve (``--resume``).

Run: ``python -m blendjax_torch.examples.control.train_dqn --steps 400``
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=2)
    ap.add_argument("--steps", type=int, default=400,
                    help="learner steps")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--capacity", type=int, default=512)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--gamma", type=float, default=0.98)
    ap.add_argument("--uniform", action="store_true",
                    help="uniform instead of prioritized replay")
    ap.add_argument("--sync-every", type=int, default=8,
                    help="learner steps between actor policy syncs")
    ap.add_argument("--checkpoint", default=None,
                    help="session-store directory (blendjax_torch."
                    "checkpoint.SnapshotManager)")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument(
        "--device", default="cuda",
        help="'cuda' (the default; raises without a card) or 'cpu'",
    )
    args = ap.parse_args(argv)

    if args.resume and not args.checkpoint:
        ap.error("--resume requires --checkpoint DIR")

    from blendjax_torch.device import device_flag
    from blendjax_torch.env import BatchedRemoteEnv
    from blendjax_torch.models import QNetwork
    from blendjax_torch.rl import (
        ActorPool,
        HostQPolicy,
        RLTrainDriver,
        TrajectoryReservoir,
        make_dqn_step,
        make_rl_train_state,
    )
    from blendjax_torch.train import CapturedStep

    device = device_flag(args.device)
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "cartpole_producer.py")
    reservoir = TrajectoryReservoir(
        args.capacity, rng=0, prioritized=not args.uniform, device=device,
    )
    model = QNetwork(hidden=(32, 32), n_actions=3).init_params(0)
    state = make_rl_train_state(
        model, np.zeros((1, 4), np.float32), learning_rate=args.lr,
        device=device,
    )
    if args.resume:
        from blendjax_torch.checkpoint import SnapshotManager
        from blendjax_torch.weights import (
            load_train_state_leaves,
            train_state_leaves,
        )

        # the train state before the step is captured: a restore copies
        # into the same tensors
        restored = SnapshotManager(args.checkpoint).restore(
            train_state_leaves(state))
        if restored is not None:
            load_train_state_leaves(state, restored.state)
    else:
        restored = None
    step = CapturedStep(make_dqn_step(reservoir, gamma=args.gamma))
    mgr = None
    if args.checkpoint:
        from blendjax_torch.checkpoint import SnapshotManager

        mgr = SnapshotManager(args.checkpoint)
    out: dict = {}
    try:
        with BatchedRemoteEnv(script=script, num_envs=args.envs,
                              seed=0) as venv:
            pool = ActorPool(
                venv, reservoir,
                HostQPolicy(3, eps_steps=1500, seed=0),
                # discrete action index -> motor velocity
                action_map=np.array([-2.0, 0.0, 2.0], np.float32),
            )
            driver = RLTrainDriver(
                step, state, reservoir, actors=pool,
                batch_size=args.batch, min_fill=2 * args.batch,
                sync_every=args.sync_every, inflight=2,
                checkpoint=mgr,
                checkpoint_every=args.ckpt_every if mgr else 0,
            )
            if args.resume:
                if restored is None:
                    # a fresh or empty checkpoint dir has nothing to
                    # resume: start from scratch instead of crashing
                    print(f"no committed snapshot in "
                          f"{args.checkpoint!r}: starting fresh")
                else:
                    names = driver.restore_session(restored.session)
                    print(f"resumed at step {driver.steps} "
                          f"(restored: {', '.join(names)})")
            start = driver.steps
            with pool:
                report_every = max(args.steps // 8, 1)
                while driver.steps < args.steps:
                    driver.train_step()
                    if driver.steps % report_every == 0:
                        driver.drain()
                        s = driver.stats
                        print(
                            f"step {s['steps']}: "
                            f"loss={driver.losses[-1]:.4f} "
                            f"mean_return={s['actor']['mean_return']} "
                            f"episodes={s['actor']['episodes']} "
                            f"replay_ratio="
                            f"{s['reservoir']['replay_ratio']}"
                        )
                loss = driver.drain()
            print(
                f"final: loss={loss:.4f} "
                f"mean_return={pool.stats['mean_return']} "
                f"env_steps={pool.env_steps} "
                f"transitions={reservoir.inserts}"
            )
            out.update(loss=loss, mean_return=pool.stats["mean_return"],
                       env_steps=pool.env_steps,
                       transitions=reservoir.inserts, steps=driver.steps,
                       start=start, step=step, losses=list(driver.losses))
    finally:
        if mgr is not None:
            mgr.close()
    return out


if __name__ == "__main__":
    main()
