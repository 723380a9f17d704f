"""Batched remote environments: a fleet of producers stepped in lockstep
(copied from ``blendjax/env/vector.py``). Each remote step is a blocking
RPC, so a thread pool overlaps the N round trips and the results stack
into arrays. With ``real_time=False`` producers wait for their next
command, so lockstep batching is exact."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from blendjax_torch.env.remote import RemoteEnv, _kwargs_to_cli


class BatchedRemoteEnv:
    """N producer instances of ``script``, stepped and reset in lockstep.

    ``step(actions)`` takes (N, ...) actions and returns stacked ``(obs
    (N, ...), reward (N,), done (N,), infos)``. A done row resets at once
    (the vector-env contract): its terminal observation rides in
    ``infos[i]["final_observation"]`` and the stacked ``obs`` holds the
    fresh episode's first observation.
    """

    def __init__(self, script: str, num_envs: int = 4, seed: int = 0,
                 timeoutms: int = 30_000, **producer_kwargs):
        from blendjax_torch.launcher.launcher import PythonProducerLauncher

        extra = _kwargs_to_cli(producer_kwargs) if producer_kwargs else []
        self.launcher = PythonProducerLauncher(
            script=script,
            num_instances=num_envs,
            named_sockets=["GYM"],
            seed=seed,
            instance_args=[list(extra) for _ in range(num_envs)],
        )
        self.launcher.__enter__()
        self.envs = [
            RemoteEnv(a, timeoutms=timeoutms)
            for a in self.launcher.addresses["GYM"]
        ]
        self.num_envs = num_envs
        self._pool = ThreadPoolExecutor(max_workers=num_envs)
        self._closed = False

    def reset(self, seed=None):
        """Reset every env; ``seed`` (an int: env i gets ``seed + i``, or
        one seed per env) reseeds each producer's episode RNG."""
        if seed is None:
            seeds = [None] * self.num_envs
        elif np.ndim(seed) == 0:
            seeds = [int(seed) + i for i in range(self.num_envs)]
        else:
            seeds = [int(s) for s in seed]
        obs_info = list(
            self._pool.map(
                lambda es: es[0].reset(seed=es[1]),
                zip(self.envs, seeds),
            )
        )
        return np.stack([np.asarray(o) for o, _ in obs_info]), [
            i for _, i in obs_info
        ]

    def step(self, actions):
        def one(env_action):
            env, a = env_action
            obs, reward, done, info = env.step(np.asarray(a).tolist())
            if done:
                info = dict(info)
                info["final_observation"] = obs
                obs, _ = env.reset()
            return obs, reward, done, info

        results = list(self._pool.map(one, zip(self.envs, actions)))
        obs = np.stack([np.asarray(r[0]) for r in results])
        reward = np.asarray([r[1] for r in results], np.float32)
        done = np.asarray([r[2] for r in results], bool)
        infos = [r[3] for r in results]
        return obs, reward, done, infos

    def close(self):
        """Idempotent teardown: the pool first (queued work cancelled, the
        RPCs in flight bounded by their timeouts), so no worker still uses
        a socket when it is closed; then the envs and the launcher."""
        if self._closed:
            return
        self._closed = True
        self._pool.shutdown(wait=True, cancel_futures=True)
        for e in self.envs:
            e.close()
        self.launcher.__exit__(None, None, None)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
