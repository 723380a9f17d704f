"""The port's remote environments against the JAX package's, on the CPU,
with real producer processes.

- Seeded episodes: ``reset(seed=7)`` and 200 steps under one action
  sequence (resets at ``done``) give the same observations, rewards and
  dones in every pairing of consumer and producer: port-port, port
  consumer with the JAX producer, JAX consumer with the port producer,
  each held against JAX-JAX.
- ``BatchedRemoteEnv``: lockstep steps, the autoreset with its terminal
  observation, seeded resets, against the JAX package's.
- The gymnasium adapter and ``gymnasium.make("blendjax_torch/Cartpole-v0")``
  (observations and rendered frames against ``blendjax/Cartpole-v0``).

Every socket here has a receive timeout, and every launcher a bounded
teardown.
"""

import os

import numpy as np
import pytest

import blendjax.env as JE
import blendjax_torch.env as TE
from blendjax.launcher import PythonProducerLauncher as JLauncher
from blendjax_torch.env import remote as TR
from blendjax_torch.launcher import PythonProducerLauncher as TLauncher
from blendjax_torch.transport import ReceiveTimeoutError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = {
    "port": os.path.join(REPO, "blendjax_torch", "producer", "scripts",
                         "cartpole.py"),
    "jax": os.path.join(REPO, "blendjax", "producer", "scripts",
                        "cartpole.py"),
}
TIMEOUT = 20_000
STEPS = 200


def _episodes(consumer, producer, seed=7):
    """``reset(seed)`` then STEPS fixed actions; returns every
    (obs, reward, done) and the reset observations."""
    env_cls = TE.RemoteEnv if consumer == "port" else JE.RemoteEnv
    launcher = (TLauncher if producer == "port" else JLauncher)(
        script=SCRIPTS[producer], num_instances=1, named_sockets=["GYM"],
        seed=0, proto="ipc")
    actions = np.random.default_rng(0).uniform(-4, 4, STEPS)
    out = []
    with launcher as ln:
        env = env_cls(ln.addresses["GYM"][0], timeoutms=TIMEOUT)
        try:
            obs, info = env.reset(seed=seed)
            out.append(("reset", obs, info.get("time")))
            for a in actions:
                obs, reward, done, info = env.step(float(a))
                out.append((obs, reward, done))
                if done:
                    obs, _ = env.reset()
                    out.append(("reset", obs))
        finally:
            env.close()
    return out


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            if isinstance(u, np.ndarray):
                assert u.dtype == v.dtype == np.float32
                np.testing.assert_array_equal(u, v)
            else:
                assert u == v


@pytest.fixture(scope="module")
def reference_episodes():
    return _episodes("jax", "jax")


@pytest.mark.parametrize("consumer,producer", [
    ("port", "port"), ("port", "jax"), ("jax", "port")])
def test_seeded_episodes_match_across_packages(reference_episodes, consumer,
                                                producer):
    got = _episodes(consumer, producer)
    _assert_same(got, reference_episodes)
    assert sum(isinstance(x[0], str) for x in got) > 1, "no episode ended"


def test_two_seeded_resets_start_identical_episodes():
    """The producer's episode RNG is reseeded over the wire: the same
    seed twice in one process gives the same trajectory."""
    with TLauncher(script=SCRIPTS["port"], named_sockets=["GYM"],
                   proto="ipc") as ln:
        env = TE.RemoteEnv(ln.addresses["GYM"][0], timeoutms=TIMEOUT)
        try:
            runs = []
            for _ in range(2):
                obs, _ = env.reset(seed=11)
                run = [obs]
                for a in (0.5, -1.0, 2.0, 0.0, -3.0):
                    run.append(env.step(a)[0])
                runs.append(np.stack(run))
            np.testing.assert_array_equal(runs[0], runs[1])
            other, _ = env.reset(seed=12)
            assert not np.array_equal(other, runs[0][0])
        finally:
            env.close()


def _batched(mod, script):
    env = mod.BatchedRemoteEnv(script, num_envs=2, seed=0, timeoutms=TIMEOUT)
    out = []
    try:
        obs, infos = env.reset(seed=3)
        out.append(obs)
        assert obs.shape == (2, 4) and len(infos) == 2
        actions = np.stack([np.full(60, 5.0), np.full(60, -5.0)], axis=1)
        for a in actions:
            obs, reward, done, infos = env.step(a)
            assert obs.shape == (2, 4) and reward.dtype == np.float32
            finals = [i.get("final_observation") for i in infos]
            out.append((obs, reward, done, finals))
    finally:
        env.close()
        env.close()  # idempotent
    return out


def test_batched_env_lockstep_and_autoreset_match_the_reference():
    port = _batched(TE, SCRIPTS["port"])
    ref = _batched(JE, SCRIPTS["jax"])
    np.testing.assert_array_equal(port[0], ref[0])
    ended = 0
    for (po, pr, pd, pf), (ro, rr, rd, rf) in zip(port[1:], ref[1:]):
        np.testing.assert_array_equal(po, ro)
        np.testing.assert_array_equal(pr, rr)
        np.testing.assert_array_equal(pd, rd)
        for i, d in enumerate(pd):
            assert (pf[i] is not None) == bool(d)
            if d:
                ended += 1
                np.testing.assert_array_equal(pf[i], rf[i])
                # the terminal observation, not the fresh episode's first
                assert abs(pf[i][2]) > 0.4 or abs(pf[i][0]) > 3.0
    assert ended >= 2


def test_gymnasium_make_matches_the_reference():
    import gymnasium

    assert "blendjax_torch/Cartpole-v0" in gymnasium.registry
    trajectories, frames = [], []
    for env_id in ("blendjax_torch/Cartpole-v0", "blendjax/Cartpole-v0"):
        env = gymnasium.make(env_id, render_mode="rgb_array")
        try:
            obs, info = env.reset(seed=5)
            run = [obs]
            for a in (1.0, -2.0, 0.5, 3.0):
                obs, reward, terminated, truncated, info = env.step(
                    np.array([a], np.float32))
                assert reward == 1.0 and not terminated and not truncated
                run.append(obs)
            trajectories.append(np.stack(run))
            frame = env.render()
            assert frame.dtype == np.uint8 and frame.shape == (240, 320, 4)
            frames.append(frame)
        finally:
            env.close()
    np.testing.assert_array_equal(trajectories[0], trajectories[1])
    np.testing.assert_array_equal(frames[0], frames[1])


def test_the_classic_call_shape_and_truncation():
    env = TE.OpenAIRemoteEnv(script=SCRIPTS["port"], max_episode_steps=3,
                             proto="ipc")
    try:
        obs = env.reset(seed=1)
        assert obs.shape == (4,) and obs.dtype == np.float32
        dones = [env.step(0.0)[2] for _ in range(3)]
        assert dones == [False, False, True]  # truncated at 3
    finally:
        env.close()


def test_kwargs_to_cli_is_the_references():
    from blendjax.env import remote as JR

    kw = {"real_time": False, "render_every": 2, "shape": (4, 5),
          "fast": True, "name": "x"}
    assert TR._kwargs_to_cli(kw) == JR._kwargs_to_cli(kw)


def test_render_keeps_the_last_frame_headless():
    from blendjax_torch.env.rendering import RENDER_BACKENDS, create_renderer

    assert "array" in RENDER_BACKENDS
    viewer = create_renderer("array")
    viewer.imshow(np.zeros((2, 2, 3), np.uint8))
    assert len(viewer.frames) == 1
    viewer.close()
    assert viewer.frames == []
    with TR.launch_env(SCRIPTS["port"], proto="ipc", render_every=1) as env:
        env.reset(seed=0)
        env.step(0.0)
        assert env.render(mode="rgb_array").shape == (240, 320, 4)
        env.render(mode="human", backend="array")
        assert len(env._viewer.frames) == 1


def test_a_remote_env_without_a_producer_times_out():
    env = TE.RemoteEnv("tcp://127.0.0.1:9", timeoutms=100)
    try:
        with pytest.raises(ReceiveTimeoutError):
            env.reset()
    finally:
        env.close()
