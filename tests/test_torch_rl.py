"""The port's RL actor-learner stack (blendjax_torch.rl) against the JAX
package's (blendjax.rl), on the CPU: the trajectory reservoir (index for
index from one seed), the host policy and actor pool (hermetic fake
vector env), the DQN and policy-gradient steps, the learner driver, its
session across the two packages, the doctor, the lock discipline, and the
mesh learner at world 2 over gloo (rank bodies in ``torch_dist_ranks.py``).

Bars: ``tol_loss`` 1e-5 on losses and priorities, 1e-4 relative (1e-6
absolute) on parameters after an update (the JAX package's equivalence
contract); the scripted learner runs, on one rank and on two, within
``F32_EXACT_ATOL = 5e-6`` of the JAX 1-device run
(``tests/test_mesh_driver.py``), and with the state split over ``fsdp``
or ``tp`` at world 2 within the same bar of the JAX package's
``make_rl_train_state(rules=...)`` on the same mesh. The reservoir's
indices, weights and accounting match exactly.
"""

import functools
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as W
from blendjax.models import QNetwork as JaxQ
from blendjax.parallel import create_mesh as jax_create_mesh
from blendjax.rl import ActorPool as JaxActorPool
from blendjax.rl import HostQPolicy as JaxHostQPolicy
from blendjax.rl import RLTrainDriver as JaxRLDriver
from blendjax.rl import TrajectoryReservoir as JaxReservoir
from blendjax.rl import diagnose_rl as jax_diagnose_rl
from blendjax.rl import make_dqn_step as jax_dqn_step
from blendjax.rl import make_pg_step as jax_pg_step
from blendjax.rl import make_rl_train_state as jax_rl_state
from blendjax.rl import mesh_rl_step_kwargs as jax_mesh_rl_step_kwargs
from blendjax_torch.models import PolicyValueNet, QNetwork
from blendjax_torch.rl import (
    ActorPool,
    HostQPolicy,
    RLTrainDriver,
    TrajectoryReservoir,
    diagnose_rl,
    make_dqn_step,
    make_pg_step,
    make_rl_train_state,
    np_mlp_forward,
)
from blendjax_torch.testing.donation import tree_pointers
from blendjax_torch.utils.metrics import metrics
from blendjax_torch.weights import (
    flax_params,
    flax_tree,
    policy_from_flax,
    train_state_leaves,
)

TOL_LOSS = 1e-5
F32_EXACT_ATOL = 5e-6
HIDDEN = (16,)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


class FakeVecEnv:
    """The JAX test's deterministic 4-dim vector env: fixed-horizon
    episodes with the BatchedRemoteEnv contract (auto-reset and a
    distinctive ``final_observation`` of 9.0)."""

    def __init__(self, n=4, horizon=12, seed=0):
        self.n = n
        self.h = horizon
        self.rng = np.random.default_rng(seed)
        self.t = np.zeros(n, int)

    def _obs(self):
        return self.rng.normal(size=(self.n, 4)).astype(np.float32)

    def reset(self, seed=None):
        self.t[:] = 0
        return self._obs(), [{} for _ in range(self.n)]

    def step(self, actions):
        self.t += 1
        done = self.t >= self.h
        obs = self._obs()
        infos = [{} for _ in range(self.n)]
        for i in np.flatnonzero(done):
            infos[i]["final_observation"] = np.full(4, 9.0, np.float32)
            self.t[i] = 0
        return obs, np.ones(self.n, np.float32), done, infos


def _batch(n=8, seed=0, with_ret=False):
    rng = np.random.default_rng(seed)
    out = {"obs": rng.normal(size=(n, 4)).astype(np.float32),
           "action": rng.integers(0, 3, size=n).astype(np.int32),
           "reward": rng.normal(size=n).astype(np.float32),
           "done": rng.random(n) < 0.2,
           "next_obs": rng.normal(size=(n, 4)).astype(np.float32)}
    if with_ret:
        out["ret"] = rng.normal(size=n).astype(np.float32)
    return out


def _res(capacity, **kw):
    return TrajectoryReservoir(capacity, device="cpu", **kw)


@functools.lru_cache(maxsize=None)
def _q_params(hidden=HIDDEN, seed=0):
    """QNetwork weights from numpy through the flax tree's shapes."""
    shapes = jax.eval_shape(lambda: JaxQ(hidden=hidden, n_actions=3).init(
        jax.random.key(0), jnp.zeros((1, 4), jnp.float32)))
    rng = np.random.default_rng(seed)

    def fill(s):
        fan_in = s.shape[0] if len(s.shape) > 1 else 8
        return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree.map(fill, shapes["params"])


def _port_q(hidden=HIDDEN):
    m = QNetwork(hidden=hidden, n_actions=3)
    m.load_state_dict(policy_from_flax(_q_params(hidden)))
    return m


def _jax_state(hidden=HIDDEN, target=True):
    p = jax.tree.map(jnp.asarray, _q_params(hidden))
    st = jax_rl_state(JaxQ(hidden=hidden, n_actions=3),
                      np.zeros((1, 4), np.float32), target=target)
    return st.replace(params=p, opt_state=st.tx.init(p),
                      target_params=(jax.tree.map(jnp.array, p)
                                     if target else None))


# -- TrajectoryReservoir ------------------------------------------------------------


def test_reservoir_insert_gather_round_trip_and_wraparound():
    res = _res(16)
    b = _batch(8)
    slots = res.insert(b)
    assert list(slots) == list(range(8))
    out = res.sample(np.arange(8))
    assert set(out) == {"obs", "action", "reward", "done", "next_obs"}
    for k, v in b.items():
        np.testing.assert_array_equal(out[k].numpy(), v)
    assert out["done"].dtype == torch.bool
    for seed in range(1, 4):
        res.insert(_batch(8, seed=seed))
    assert res.size == 16 and res.inserts == 32
    # slots 0..7 now hold the fourth batch (wrapped twice)
    np.testing.assert_array_equal(res.sample(np.arange(8))["obs"].numpy(),
                                  _batch(8, seed=2)["obs"])


def test_reservoir_storage_is_allocated_once():
    res = _res(8)
    res.insert(_batch(8))
    before = tree_pointers(res.device_buffers())
    assert set(res.device_buffers()) == {"obs", "action", "reward", "done",
                                         "next_obs", "_priorities"}
    res.insert(_batch(8, seed=1))
    res.insert(_batch(5, seed=2))
    assert tree_pointers(res.device_buffers()) == before


def test_reservoir_rejects_shape_and_structure_drift():
    res = _res(8)
    res.insert(_batch(4))
    with pytest.raises(ValueError, match="structure"):
        res.insert({"obs": np.zeros((2, 4), np.float32)})
    bad = dict(_batch(2), obs=np.zeros((2, 5), np.float32))
    with pytest.raises(ValueError, match="field"):
        res.insert(bad)
    with pytest.raises(ValueError, match="leading dim"):
        res.insert(dict(_batch(2), reward=np.zeros(3, np.float32)))


def test_reservoir_exact_fresh_replayed_accounting():
    res = _res(8, rng=3)
    res.insert(_batch(8))
    res.draw_token(np.array([0, 0, 1, 2], np.int32))
    assert (res.fresh, res.replayed) == (3, 1)
    res.draw_token(np.array([0, 1, 3], np.int32))
    assert (res.fresh, res.replayed) == (4, 3)


@pytest.mark.parametrize("prioritized", [False, True],
                         ids=["uniform", "prioritized"])
def test_compose_matches_the_reference_index_for_index(prioritized):
    """Same seed, same inserts, the same priorities on the device: the
    port composes the reference's indices and importance weights, draw
    after draw, with the same accounting (the priority mirror refreshed
    every other draw)."""
    kw = dict(rng=5, prioritized=prioritized, priority_refresh_every=2)
    port, ref = _res(32, **kw), JaxReservoir(32, **kw)
    assert port.compose(4) is None and ref.compose(4) is None
    prio = np.random.default_rng(1).uniform(0.1, 3.0, 32).astype(np.float32)
    for i in range(5):
        b = _batch(8, seed=i)
        np.testing.assert_array_equal(port.insert(b), ref.insert(b))
        if i == 2:
            port.commit_priorities(torch.from_numpy(prio))
            ref.commit_priorities(jnp.asarray(prio))
        for _ in range(2):
            a, b2 = port.compose(16), ref.compose(16)
            np.testing.assert_array_equal(a[0], b2[0])
            np.testing.assert_allclose(a[1], b2[1], rtol=1e-6)
            port.draw_token(*a)
            ref.draw_token(*b2)
    assert port.stats == ref.stats
    if not prioritized:
        assert np.all(a[1] == 1.0)


def test_prioritized_compose_follows_priorities():
    res = _res(8, rng=0, prioritized=True, priority_refresh_every=1)
    res.insert(_batch(8))
    p = res._priorities.clone()
    p[5] = 1e6
    res.commit_priorities(p)
    res._draws = res._draws_at_refresh + res.priority_refresh_every
    idx, w = res.compose(64)
    assert np.mean(idx == 5) > 0.9
    if (idx != 5).any():
        assert w[idx == 5].max() <= w[idx != 5].min() + 1e-6


def test_reservoir_state_dict_round_trip_continues_sampling():
    res = _res(8, rng=7, prioritized=True)
    res.insert(_batch(8))
    res.draw_token(*res.compose(4))
    snap = res.state_dict()
    twin = _res(8, rng=7, prioritized=True)
    twin.load_state_dict(snap)
    a, b = res.compose(4), twin.compose(4)
    assert np.array_equal(a[0], b[0]) and np.allclose(a[1], b[1])
    assert (twin.size, twin.inserts, twin.fresh, twin.replayed) == (
        res.size, res.inserts, res.fresh, res.replayed)
    got, want = twin.sample(np.arange(8)), res.sample(np.arange(8))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())


def test_reservoir_capacity_mismatch_refuses_restore():
    res = _res(8)
    res.insert(_batch(4))
    with pytest.raises(ValueError, match="capacity"):
        _res(16).load_state_dict(res.state_dict())


# -- host policy and actors ----------------------------------------------------------------


def test_np_mlp_forward_matches_both_qnetworks():
    """The actors' numpy forward of the learner's host snapshot
    (``flax_tree``) against the port's QNetwork and the JAX package's on
    the same weights."""
    obs = np.random.default_rng(0).normal(size=(5, 4)).astype(np.float32)
    hidden = (16, 8)
    model = _port_q(hidden)
    snap = flax_tree(model)
    assert sorted(snap) == ["Dense_0", "Dense_1", "Dense_2"]
    got = np_mlp_forward(snap, obs)
    np.testing.assert_allclose(got, model(torch.from_numpy(obs))
                               .detach().numpy(), rtol=1e-5, atol=1e-6)
    want = np.asarray(JaxQ(hidden=hidden, n_actions=3).apply(
        {"params": _q_params(hidden)}, obs))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    for k in snap:
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(snap[k][leaf],
                                          _q_params(hidden)[k][leaf])


def test_policy_value_net_matches_flax():
    from blendjax.models import PolicyValueNet as JaxPV

    jm = JaxPV(hidden=(8, 8), action_dim=2)
    obs = np.random.default_rng(2).normal(size=(3, 4)).astype(np.float32)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(1), obs)
                          ["params"])
    tm = PolicyValueNet(hidden=(8, 8), action_dim=2)
    tm.load_state_dict(policy_from_flax(params))
    assert PolicyValueNet(action_dim=2).log_std.tolist() == [-0.5, -0.5]
    want = jm.apply({"params": params}, obs)
    got = tm(torch.from_numpy(obs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-6)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert [p for p, _t, _l in flax_params(tm)] == [
        jax.tree_util.keystr(k) for k, _ in flat]


def test_host_q_policy_draws_the_reference_actions():
    """Random until a snapshot arrives, then epsilon-greedy: the same
    actions as the JAX package's policy from the same seed."""
    obs = np.random.default_rng(4).normal(size=(6, 4)).astype(np.float32)
    port, ref = HostQPolicy(3, eps_steps=10, seed=3), JaxHostQPolicy(
        3, eps_steps=10, seed=3)
    snap = flax_tree(_port_q())
    for i in range(12):
        s = None if i < 2 else snap
        a, b = port(s, obs), ref(s, obs)
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    greedy = HostQPolicy(3, eps_start=0.0, eps_end=0.0)(snap, obs)
    np.testing.assert_array_equal(
        greedy, np.argmax(np_mlp_forward(snap, obs), axis=-1))
    assert port.state_dict()["calls"] == 12


def test_actor_pool_feeds_reservoir_with_final_obs_bootstrap():
    res = _res(256)
    pool = ActorPool(FakeVecEnv(n=4, horizon=3), res, HostQPolicy(3, seed=0))
    with pool:
        deadline = time.monotonic() + 20
        while res.inserts < 48 and time.monotonic() < deadline:
            time.sleep(0.01)
    assert res.inserts >= 48
    assert pool.env_steps == res.inserts
    assert pool.episodes >= 4
    out = res.sample(np.arange(res.size))
    done = out["done"].numpy()
    nxt = out["next_obs"].numpy()
    assert done.any()
    assert np.allclose(nxt[done], 9.0)
    assert not np.allclose(nxt[~done], 9.0)


def test_actor_pool_state_dict_round_trip():
    res = _res(64)
    pool = ActorPool(FakeVecEnv(n=2, horizon=4), res, HostQPolicy(3, seed=2))
    pool.env_steps, pool.episodes = 40, 5
    pool.episode_returns = [(8, 4.0), (40, 4.0)]
    pool.policy.calls = 17
    twin = ActorPool(FakeVecEnv(n=2, horizon=4), res, HostQPolicy(3, seed=2))
    twin.load_state_dict(pool.state_dict())
    assert (twin.env_steps, twin.episodes) == (40, 5)
    assert twin.episode_returns == [(8, 4.0), (40, 4.0)]
    assert twin.policy.calls == 17


def test_actor_pool_surfaces_thread_errors_via_check():
    class DeadEnv(FakeVecEnv):
        def step(self, actions):
            raise RuntimeError("env exploded")

    res = _res(16)
    pool = ActorPool(DeadEnv(n=2), res, HostQPolicy(3))
    with pool:
        deadline = time.monotonic() + 10
        while pool._error is None and time.monotonic() < deadline:
            time.sleep(0.01)
    with pytest.raises(RuntimeError, match="actor loop died"):
        pool.check()
    healthy = ActorPool(FakeVecEnv(n=2), res, HostQPolicy(3))
    healthy._error = RuntimeError("stale")
    with healthy:
        healthy.check()


@pytest.mark.parametrize("name", ["f32", "bf16-compute", "bf16-grads"])
def test_policy_value_and_grad_has_aux_and_module_kwargs(name):
    """``has_aux`` carries a per-row value out of the loss, as
    ``jax.value_and_grad`` does (the RL steps' TD errors), under every
    policy, and ``module_kwargs`` names the models' compute dtype as the
    reference's does."""
    from blendjax.precision import resolve_policy as jax_resolve
    from blendjax_torch.precision import (
        policy_value_and_grad,
        resolve_policy,
    )

    policy = resolve_policy(name)
    assert set(policy.module_kwargs()) == set(
        jax_resolve(name).module_kwargs()) == {"dtype"}
    assert policy.module_kwargs()["dtype"] == policy.compute_dtype
    model = _port_q()
    obs = torch.from_numpy(_batch(6)["obs"])

    def loss_fn(m, batch):
        q = m(batch)
        return (q ** 2).mean(), q.detach()[:, 0]

    (loss, aux), grads = policy_value_and_grad(loss_fn, model, obs, policy,
                                               has_aux=True)
    plain, grads0 = policy_value_and_grad(
        lambda m, b: loss_fn(m, b)[0], model, obs, policy)
    assert aux.shape == (6,) and loss.item() == plain.item()
    for g, g0, p in zip(grads, grads0, model.parameters()):
        assert g.dtype == p.dtype and torch.equal(g, g0)


# -- the learner steps -----------------------------------------------------------------


def _pair_reservoirs(capacity=32, with_ret=False, **kw):
    port, ref = _res(capacity, rng=0, **kw), JaxReservoir(capacity, rng=0,
                                                          **kw)
    for i in range(3):
        b = _batch(8, seed=10 + i, with_ret=with_ret)
        port.insert(b)
        ref.insert(b)
    return port, ref


def _close_tree(got, want, what):
    for k in want:
        for leaf in want[k]:
            np.testing.assert_allclose(
                got[k][leaf], np.asarray(want[k][leaf]), rtol=1e-4,
                atol=1e-6, err_msg=f"{what} {k}/{leaf}")


def test_dqn_step_matches_the_reference():
    """One double-DQN step on the same draw (slots repeated in it): the
    loss, the Adam-updated parameters, the Polyak target and the
    priorities against the JAX step. Slots drawn once carry the
    reference's priority; a slot drawn more than once, where XLA leaves
    the winner undefined, holds its last occurrence's |td| + eps."""
    port_res, ref_res = _pair_reservoirs(prioritized=True)
    idx, w = port_res.compose(24)
    idx2, w2 = ref_res.compose(24)
    np.testing.assert_array_equal(idx, idx2)
    counts = np.bincount(idx, minlength=32)
    assert (counts > 1).any() and (counts == 1).any()
    jst = _jax_state()
    jstep = jax_dqn_step(ref_res, JaxQ(hidden=HIDDEN, n_actions=3).apply,
                         gamma=0.98, tau=0.05, donate=False)
    jst, jm = jstep(jst, ref_res.draw_token(idx2, w2))
    state = make_rl_train_state(_port_q(), device="cpu")
    step = make_dqn_step(port_res, gamma=0.98, tau=0.05)
    token = port_res.draw_token(idx, w)
    pre = flax_tree(state.model)
    state, m = step(state, token)
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=TOL_LOSS)
    assert state.step == 1
    _close_tree(flax_tree(state.model), jst.params, "params")
    _close_tree(flax_tree(state.target), jst.target_params, "target")
    got = port_res._priorities.numpy()
    want = np.asarray(ref_res._priorities)
    once = counts == 1
    np.testing.assert_allclose(got[once], want[once], rtol=TOL_LOSS)
    untouched = counts == 0
    np.testing.assert_array_equal(got[untouched], want[untouched])
    # the repeated slots: the last occurrence's |td| + eps, from the
    # pre-update parameters (numpy)
    rows = {k: v.numpy() for k, v in port_res.sample(idx).items()}
    q = np_mlp_forward(pre, rows["obs"])
    qn_o = np_mlp_forward(pre, rows["next_obs"])
    qn_t = np_mlp_forward(pre, rows["next_obs"])  # target == params at start
    nv = qn_t[np.arange(24), np.argmax(qn_o, -1)]
    td = q[np.arange(24), rows["action"]] - (
        rows["reward"] + 0.98 * (1.0 - rows["done"]) * nv)
    for slot in np.flatnonzero(counts > 1):
        last = np.flatnonzero(idx == slot)[-1]
        assert got[slot] == pytest.approx(abs(td[last]) + 1e-3, rel=1e-4)


def test_pg_step_matches_the_reference():
    port_res, ref_res = _pair_reservoirs(with_ret=True)
    idx, w = port_res.compose(16)
    ref_res.compose(16)
    counts = np.bincount(idx, minlength=32)
    jst = _jax_state(target=False)
    jstep = jax_pg_step(ref_res, JaxQ(hidden=HIDDEN, n_actions=3).apply,
                        donate=False)
    jst, jm = jstep(jst, ref_res.draw_token(idx, w))
    state = make_rl_train_state(_port_q(), device="cpu", target=False)
    assert state.target is None
    state, m = make_pg_step(port_res)(state, port_res.draw_token(idx, w))
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=TOL_LOSS)
    _close_tree(flax_tree(state.model), jst.params, "params")
    once = counts == 1
    np.testing.assert_allclose(port_res._priorities.numpy()[once],
                               np.asarray(ref_res._priorities)[once],
                               rtol=TOL_LOSS)


# -- the learner driver ------------------------------------------------------------------


def test_learner_driver_end_to_end_exact_accounting():
    metrics.reset()
    res = _res(128, rng=0, prioritized=True)
    pool = ActorPool(FakeVecEnv(n=4, horizon=8), res,
                     HostQPolicy(3, eps_steps=64, seed=1))
    state = make_rl_train_state(_port_q(), device="cpu")
    driver = RLTrainDriver(make_dqn_step(res), state, res, actors=pool,
                           batch_size=16, min_fill=32, sync_every=4,
                           inflight=2)
    with pool:
        loss = driver.run_steps(12)
    assert np.isfinite(loss)
    assert driver.steps == 12 and driver.dispatches == 12
    assert res.fresh + res.replayed == 12 * 16
    assert pool.policy_version >= 3
    s = driver.stats
    assert s["reservoir"]["draws"] == 12
    assert s["actor"]["env_steps"] == res.inserts
    assert s["images_retired"] == 12 * 16 and s["layout"] == "single"
    counters = metrics.report()["counters"]
    assert counters["rl.draws"] == 12
    assert counters["rl.env_steps"] == pool.env_steps


def test_learner_driver_times_out_without_actors():
    res = _res(64)
    state = make_rl_train_state(_port_q(), device="cpu")
    driver = RLTrainDriver(make_dqn_step(res), state, res, batch_size=8,
                           sample_timeout_s=0.2)
    with pytest.raises(TimeoutError, match="reservoir never reached"):
        driver.train_step()


def _jax_scripted(prioritized=False):
    """The JAX package's learner on a 1-device mesh over the scripted
    insert sequence of ``torch_dist_ranks.rl_inserts``."""
    mesh = jax_create_mesh({"data": 1}, devices=jax.devices()[:1])
    res = JaxReservoir(64, rng=0, prioritized=prioritized)
    step = jax_dqn_step(res, JaxQ(hidden=HIDDEN, n_actions=3).apply,
                        gamma=0.98)
    drv = JaxRLDriver(step, _jax_state(), res, mesh=mesh, batch_size=16,
                      min_fill=8, sync_every=1, inflight=1)
    for ins in W.rl_inserts():
        res.insert(ins)
        for _ in range(2):
            drv.train_step()
    drv.drain()
    return {"losses": np.asarray(drv.losses), "params": drv.state.params,
            "prio": np.asarray(res._priorities), "stats": res.stats}


@pytest.mark.parametrize("prioritized", [False, True],
                         ids=["uniform", "prioritized"])
def test_one_rank_learner_matches_the_jax_learner(prioritized):
    """The port's learner without a mesh on the scripted insert sequence:
    the same draws (exact accounting), losses within F32_EXACT_ATOL of the
    JAX 1-device run's."""
    want = _jax_scripted(prioritized)
    res = _res(64, rng=0, prioritized=prioritized)
    state = make_rl_train_state(_port_q(), device="cpu")
    drv = RLTrainDriver(make_dqn_step(res, gamma=0.98), state, res,
                        batch_size=16, min_fill=8, sync_every=1, inflight=1)
    for ins in W.rl_inserts():
        res.insert(ins)
        for _ in range(2):
            drv.train_step()
    drv.drain()
    assert res.stats == want["stats"]
    np.testing.assert_allclose(np.asarray(drv.losses), want["losses"],
                               rtol=0, atol=F32_EXACT_ATOL)
    _close_tree(flax_tree(state.model), want["params"], "params")


# the state split over a model axis at world 2: (mesh axes, rules as
# (pattern, spec) pairs); QNetwork's kernels are (4, 16) and (16, 3).
# fsdp: the default rule (each kernel's largest dim over fsdp; an explicit
# fsdp entry would be placed a second time by that default)
SPLIT_RL = {
    "fsdp": ((("data", 1), ("fsdp", 2)), ()),
    "tp": ((("data", 1), ("tp", 2)),
           ((r"Dense_0/kernel$", (None, "tp")),
            (r"Dense_1/kernel$", ("tp", None)))),
}


@functools.lru_cache(maxsize=None)
def _jax_split_scripted(name):
    """The JAX learner with ``make_rl_train_state(rules=..., mesh=...)``
    and ``mesh_rl_step_kwargs(rules=...)`` on the 2-device mesh of
    ``SPLIT_RL[name]`` over the scripted insert sequence."""
    from blendjax.parallel import PartitionRule as JaxRule

    axes, pairs = SPLIT_RL[name]
    rules = tuple(JaxRule(p, spec) for p, spec in pairs)
    mesh = jax_create_mesh(dict(axes), devices=jax.devices()[:2])
    model = JaxQ(hidden=HIDDEN, n_actions=3)
    st = jax_rl_state(model, np.zeros((1, 4), np.float32), mesh=mesh,
                      rules=rules)
    p = jax.tree.map(lambda a, v: jax.device_put(jnp.asarray(v), a.sharding),
                     st.params, _q_params())
    st = st.replace(params=p, opt_state=st.tx.init(p),
                    target_params=jax.tree.map(jnp.array, p))
    specs = {str(v.sharding.spec) for v in jax.tree_util.tree_leaves(p)}
    res = JaxReservoir(64, rng=0)
    step = jax_dqn_step(res, model.apply, gamma=0.98,
                        **jax_mesh_rl_step_kwargs(st, mesh, rules=rules))
    drv = JaxRLDriver(step, st, res, mesh=mesh, batch_size=16, min_fill=8,
                      sync_every=1, inflight=1)
    for ins in W.rl_inserts():
        res.insert(ins)
        for _ in range(2):
            drv.train_step()
    drv.drain()
    return {"losses": np.asarray(drv.losses), "params": drv.state.params,
            "target": drv.state.target_params,
            "prio": np.asarray(res._priorities), "stats": res.stats,
            "specs": specs}


@pytest.fixture(scope="module")
def mesh_ranks(tmp_path_factory):
    """The mesh learner at world 2 (gloo), replicated and split over a
    model axis, while this process runs the JAX side."""
    cases = [("rl_mesh", {"params_np": _q_params()})] + [
        (f"rl_mesh:{name}", {"params_np": _q_params(), "axes": dict(axes),
                             "rules": rules})
        for name, (axes, rules) in SPLIT_RL.items()]
    out: dict = {}

    def run():
        try:
            out["ranks"] = W.run_worlds(
                {2: cases}, str(tmp_path_factory.mktemp("ranks")))
        except BaseException as e:
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    _jax_scripted(False)
    for name in SPLIT_RL:
        _jax_split_scripted(name)
    t.join(200.0)
    assert not t.is_alive(), "the ranks did not finish"
    if "error" in out:
        raise out["error"]
    return out["ranks"]


@pytest.mark.parametrize("rank", [0, 1])
def test_mesh_learner_at_world_2_matches_the_jax_learner(mesh_ranks, rank):
    """Rank 0 inserts, both ranks agree on the inserts before each compose
    and draw the same indices, each trains its rows of the draw with the
    gradients all-reduced: the JAX 1-device losses within F32_EXACT_ATOL,
    the ring split in two, the whole priority vector on every rank."""
    per = mesh_ranks[2][rank]["rl_mesh"]
    if "error" in per:
        pytest.fail(per["error"])
    want = _jax_scripted(False)
    assert per["stats"] == want["stats"]
    assert per["steps"] == 12 and per["images"] == 12 * 16
    assert per["ring_rows"] == 32
    np.testing.assert_allclose(per["losses"], want["losses"], rtol=0,
                               atol=F32_EXACT_ATOL)
    _close_tree(per["params"], want["params"], "params")
    np.testing.assert_allclose(per["prio"], want["prio"], rtol=1e-4,
                               atol=1e-6)
    other = mesh_ranks[2][1 - rank]["rl_mesh"]
    np.testing.assert_array_equal(per["prio"], other["prio"])
    np.testing.assert_array_equal(per["losses"], other["losses"])


@pytest.mark.parametrize("name", list(SPLIT_RL))
@pytest.mark.parametrize("rank", [0, 1])
def test_split_rl_state_at_world_2_matches_the_jax_split_state(
        mesh_ranks, rank, name):
    """The DQN state split by fsdp or tp rules at world 2 (the online and
    the target network each rank's shards, gathered on use; fsdp folds
    into the batch: each rank trains its rows): the same draws, losses
    within F32_EXACT_ATOL of the JAX package's split state on the same
    2-device mesh, parameters and target within the parameter bar, the
    priorities within it and alike on both ranks; the state's snapshot
    leaves load into a split state of other weights and read back the
    same."""
    per = mesh_ranks[2][rank][f"rl_mesh:{name}"]
    if "error" in per:
        pytest.fail(per["error"])
    want = _jax_split_scripted(name)
    assert any(name in s for s in want["specs"]), want["specs"]
    assert per["sharded"] and per["round_trip"]
    halved = [a != b for a, b in zip(per["local"], per["full"])]
    assert any(halved) and per["target_local"] == per["local"]
    assert per["stats"] == want["stats"]
    assert per["steps"] == 12 and per["images"] == 12 * 16
    np.testing.assert_allclose(per["losses"], want["losses"], rtol=0,
                               atol=F32_EXACT_ATOL)
    _close_tree(per["params"], want["params"], "params")
    _close_tree(per["target"], want["target"], "target")
    np.testing.assert_allclose(per["prio"], want["prio"], rtol=1e-4,
                               atol=1e-6)
    other = mesh_ranks[2][1 - rank][f"rl_mesh:{name}"]
    np.testing.assert_array_equal(per["prio"], other["prio"])
    np.testing.assert_array_equal(per["losses"], other["losses"])


# -- sessions across the packages ------------------------------------------------------


def _jax_leaf_paths(st) -> list:
    flat = jax.tree_util.tree_flatten_with_path(st)[0]
    return sorted(jax.tree_util.keystr(p) for p, _ in flat)


def test_rl_state_leaves_are_the_jax_rl_train_states():
    state = make_rl_train_state(_port_q(), device="cpu")
    assert sorted(train_state_leaves(state)) == _jax_leaf_paths(_jax_state())


def _port_stack(tmp, seed=3):
    from blendjax_torch.checkpoint import SnapshotManager

    res = _res(64, rng=0, prioritized=True)
    pool = ActorPool(FakeVecEnv(n=2, horizon=6), res, HostQPolicy(3, seed=seed))
    state = make_rl_train_state(_port_q(), device="cpu")
    mgr = SnapshotManager(str(tmp))
    drv = RLTrainDriver(make_dqn_step(res), state, res, actors=pool,
                        batch_size=8, min_fill=16, checkpoint=mgr, inflight=1)
    return res, pool, state, mgr, drv


def _jax_stack(tmp, seed=3):
    from blendjax.checkpoint import SnapshotManager as JSnapshotManager

    res = JaxReservoir(64, rng=0, prioritized=True)
    pool = JaxActorPool(FakeVecEnv(n=2, horizon=6), res,
                        JaxHostQPolicy(3, seed=seed))
    state = _jax_state()
    mgr = JSnapshotManager(str(tmp))
    drv = JaxRLDriver(jax_dqn_step(res, JaxQ(hidden=HIDDEN,
                                             n_actions=3).apply),
                      state, res, actors=pool, batch_size=8, min_fill=16,
                      checkpoint=mgr, inflight=1,
                      mesh=jax_create_mesh({"data": 1},
                                           devices=jax.devices()[:1]))
    return res, pool, state, mgr, drv


def _leaves_np(leaves: dict) -> dict:
    return {k: (v.detach().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in leaves.items()}


@pytest.mark.parametrize("direction", ["port_to_port", "port_to_jax",
                                       "jax_to_port"])
def test_learner_session_round_trip(tmp_path, direction):
    """An RL run checkpoints through the session store and a fresh stack
    (of the same package or the other) resumes it: the train state leaves
    bit-equal, the reservoir's and actors' accounting, and the next
    composed draw index for index."""
    make_src, make_dst = {
        "port_to_port": (_port_stack, _port_stack),
        "port_to_jax": (_port_stack, _jax_stack),
        "jax_to_port": (_jax_stack, _port_stack),
    }[direction]
    res, pool, state, mgr, drv = make_src(tmp_path / "src")
    with pool:
        drv.run_steps(5)
    drv.checkpoint_now(wait=True)
    src_leaves = (_leaves_np(train_state_leaves(drv.state))
                  if isinstance(res, TrajectoryReservoir) else
                  {jax.tree_util.keystr(p): np.asarray(v) for p, v in
                   jax.tree_util.tree_flatten_with_path(drv.state)[0]})
    res2, pool2, state2, mgr2, drv2 = make_dst(tmp_path / "dst")
    if isinstance(res2, TrajectoryReservoir):
        from blendjax_torch.checkpoint import SnapshotManager

        r = SnapshotManager(str(tmp_path / "src")).restore(
            train_state_leaves(state2))
        from blendjax_torch.weights import load_train_state_leaves

        load_train_state_leaves(state2, r.state)
        got = _leaves_np(train_state_leaves(state2))
    else:
        from blendjax.checkpoint import SnapshotManager as JSnapshotManager

        r = JSnapshotManager(str(tmp_path / "src")).restore(state2)
        drv2.state = r.state
        got = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
               jax.tree_util.tree_flatten_with_path(r.state)[0]}
    names = drv2.restore_session(r.session)
    assert set(names) == {"replay", "actor", "driver"}
    assert sorted(got) == sorted(src_leaves)
    for k in src_leaves:
        np.testing.assert_array_equal(got[k], src_leaves[k], err_msg=k)
    assert drv2.steps == drv.steps == 5
    assert res2.stats == res.stats
    assert pool2.env_steps == pool.env_steps == res.inserts
    a, b = res.compose(8), res2.compose(8)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_allclose(a[1], b[1], rtol=1e-6)
    with pool2:
        loss = drv2.run_steps(2)
    assert np.isfinite(loss) and drv2.steps == 7
    mgr.close()
    mgr2.close()


# -- the doctor --------------------------------------------------------------------------


def _report(counters=None, spans=None):
    return {"counters": counters or {}, "spans": spans or {}, "gauges": {}}


@pytest.mark.parametrize("report,kind", [
    (_report(), "rl-idle"),
    (_report({"rl.transitions": 100, "rl.fresh": 90, "rl.replayed": 110,
              "rl.draws": 20, "rl.sample_waits": 3},
             {"rl.sample_wait": {"total_ms": 1200.0}}), "env-bound"),
    (_report({"rl.transitions": 100, "rl.fresh": 100, "rl.replayed": 400,
              "rl.draws": 500, "rl.sample_waits": 1}), "rl-balanced"),
    (_report({"rl.transitions": 1000, "rl.fresh": 100, "rl.replayed": 100}),
     "learner-bound"),
    (_report({"rl.transitions": 100, "rl.fresh": 100, "rl.replayed": 500}),
     "rl-balanced"),
], ids=["idle", "env-bound", "warmup-wait-not-sticky", "learner-bound",
        "balanced"])
def test_diagnose_rl_matches_the_reference(report, kind):
    got, want = diagnose_rl(report), jax_diagnose_rl(report)
    assert got.kind == want.kind == kind
    assert (got.reason, got.advice, got.shares) == (
        want.reason, want.advice, want.shares)


# -- the lock discipline -------------------------------------------------------------------


class CountingLock:
    def __init__(self):
        self.inner = threading.RLock()
        self.entries = 0

    def __enter__(self):
        self.entries += 1
        return self.inner.__enter__()

    def __exit__(self, *exc):
        return self.inner.__exit__(*exc)


def _filled(**kw):
    res = _res(8, **kw)
    res.insert({"obs": np.zeros((4, 3), np.float32),
                "reward": np.ones(4, np.float32)})
    return res


def test_reservoir_stats_and_fields_take_the_lock():
    res = _filled()
    probe = CountingLock()
    res.lock = probe
    assert res.stats["inserts"] == 4
    assert probe.entries == 1
    assert len(res.fields) == 2
    assert probe.entries == 2


def test_reservoir_empty_checks_run_under_the_lock():
    res = _res(4)
    probe = CountingLock()
    res.lock = probe
    with pytest.raises(RuntimeError, match="insert"):
        res.draw_token(np.zeros(2, np.int32))
    with pytest.raises(RuntimeError, match="insert"):
        res.sample(np.zeros(2, np.int32))
    assert probe.entries == 2


def test_actor_stats_and_restore_share_the_accounting_cut():
    res = _filled()
    probe = CountingLock()
    res.lock = probe
    pool = ActorPool(FakeVecEnv(), res, HostQPolicy(2))
    before = probe.entries
    assert pool.stats["env_steps"] == 0
    assert probe.entries == before + 1
    pool.load_state_dict({"env_steps": 7, "episodes": 1,
                          "episode_returns": [[7, 1.5]]})
    assert probe.entries == before + 2
    assert pool.stats["env_steps"] == 7
