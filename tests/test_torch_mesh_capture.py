"""Mesh steps the JAX package compiles, as the port captures them, against
the JAX package (CPU).

The ranks (``torch_dist_ranks.py``) run on gloo at worlds 1, 2 and 4 at
once while this process runs the JAX package on its virtual CPU devices.
On the CPU, and over gloo, ``CapturedStep`` runs its step eagerly
(``eager_calls``); the graphs themselves, bit-equal with the eager steps,
are held on the card (``tests/test_torch_mesh_aot_card.py`` and
``chip_smoke.py``).

- The sharded ring's gather works on the card from a device index tensor:
  at every world it is the JAX package's ``make_ring_gather(sharding)``
  bit for bit (compared as bytes), for random draws with repeats, one
  slot repeated, a draw one rank holds and a draw that misses ranks, with
  a bool field among the fields; it reads no index on the host.
- The echo fused step over a sharded ring, and the DQN learner over one,
  each through ``CapturedStep(step, mesh=mesh)``, train the JAX package's
  losses at worlds 2 and 4: the echo step within rtol 1e-4 of the JAX mesh
  echo step (``tests/test_torch_echo.py``'s echo parity bar), the learner
  within ``F32_EXACT_ATOL`` of the JAX learner
  (``tests/test_torch_rl.py``'s bar).
- ``train_transformer.py`` on ``data=1,seq=2`` (ring and Ulysses) and
  ``train.py`` on ``{"data": 2}`` step through a ``CapturedStep`` that
  runs eagerly over gloo, one eager call per step, with the losses of the
  bare mesh step.
"""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_ranks as W
from blendjax.data import ring as JR
from blendjax.data.echo import SampleReservoir as JaxReservoir
from blendjax.models import CubeRegressor as JaxCube
from blendjax.parallel import create_mesh as jax_create_mesh
from blendjax.parallel import replicated as jax_replicated
from blendjax.parallel import ring_sharding as jax_ring_sharding
from blendjax.train import make_mesh_echo_fused_step as jax_echo_step
from blendjax.train import make_train_state as jax_train_state
from test_torch_mesh_driver import _params
from test_torch_rl import F32_EXACT_ATOL, _close_tree, _jax_scripted, _q_params

ECHO_RTOL = 1e-4
WORLDS = (1, 2, 4)
STEPS = 4


@functools.lru_cache(maxsize=None)
def _jax_gather(world: int, name: str) -> dict:
    """The JAX package's sharded gather of draw ``name`` on a ``world``-way
    ring."""
    mesh = jax_create_mesh({"data": world}, devices=jax.devices()[:world])
    sh = jax_ring_sharding(mesh)
    bufs = jax.device_put(W.ring_fields(), sh)
    got = JR.make_ring_gather(sh)(bufs, W.ring_draws()[name])
    return {k: np.asarray(v) for k, v in got.items()}


@functools.lru_cache(maxsize=None)
def _jax_echo_losses(world: int) -> np.ndarray:
    """The JAX package's mesh echo step on ``{"data": world}`` over the
    same inserts and draws as ``torch_dist_ranks.case_echo_capture``."""
    mesh = jax_create_mesh({"data": world}, devices=jax.devices()[:world])
    state = jax_train_state(JaxCube(features=W.FEATURES, dtype=jnp.float32),
                            np.zeros((W.B, W.HW, W.HW, 4), np.uint8),
                            mesh=mesh)
    params = jax.device_put(jax.tree.map(jnp.asarray, _params()),
                            jax_replicated(mesh))
    state = state.replace(params=params, opt_state=state.tx.init(params))
    res = JaxReservoir(64, augment=None, rng=7,
                       sharding=jax_ring_sharding(mesh))
    step = jax_echo_step(state, mesh, res, donate=False, precision="f32")
    idx_rng = np.random.default_rng(11)
    losses = []
    for hb in W.messages(4):
        res.insert({"image": hb["image"], "xy": hb["xy"]})
        for _ in range(2):
            token = res.draw_token(idx_rng.integers(0, res.size, W.B))
            state, m = step(state, token)
            losses.append(float(m["loss"]))
    return np.asarray(losses)


_FORMER = ["--steps", str(STEPS), "--instances", "1", "--batch", "8",
           "--shape", "32", "32", "--patch", "8", "--dim", "32",
           "--depth", "1", "--heads", "2", "--mesh", "data=1,seq=2"]


def _cases(world: int, prefix: str) -> list:
    cases = [("ring_gather", {})]
    if world >= 2:
        cases += [("echo_capture", {"params_np": _params()}),
                  ("rl_mesh:captured", {"params_np": _q_params(),
                                        "captured": True})]
    if world == 2:
        cases += [
            (f"example_capture:{mode}", {
                "argv": _FORMER + ["--sp-mode", mode],
                "relpath": "datagen/train_transformer.py"})
            for mode in ("ring", "ulysses")]
        cases.append(("example_capture:train", {"argv": [
            "--steps", str(STEPS), "--batch", "8", "--shape", "32", "32",
            "--replay", prefix]}))
    return cases


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every world's ranks, while this process runs the JAX side."""
    from test_torch_mesh_examples import write_frames

    tmp = tmp_path_factory.mktemp("capture")
    prefix = str(tmp / "rec")
    write_frames(f"{prefix}_00.bjr", 8 * STEPS)
    out: dict = {}

    def run():
        try:
            out["ranks"] = W.run_worlds(
                {w: _cases(w, prefix) for w in WORLDS}, str(tmp / "ranks"),
                timeout=200.0)
        except BaseException as e:  # raised below, in the test
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    for world in WORLDS:
        for name in W.ring_draws():
            _jax_gather(world, name)
    for world in (2, 4):
        _jax_echo_losses(world)
    _jax_scripted(False)
    t.join(230.0)
    assert not t.is_alive(), "the ranks did not finish"
    if "error" in out:
        raise out["error"]
    return out["ranks"]


def _result(ranks, world, name):
    per_rank = [r[name] for r in ranks[world]]
    for r in per_rank:
        if isinstance(r, dict) and "error" in r:
            pytest.fail(r["error"])
    return per_rank


def _bytes(a) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint8)


# -- the sharded gather ---------------------------------------------------------------


@pytest.mark.parametrize("name", list(W.ring_draws()))
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_gather_is_the_jax_gather_bit_for_bit(ranks, world, name):
    """Every rank gets the whole draw as the JAX package's sharded gather
    gives it, byte for byte and in its dtype (the bool field too), and
    its own rows of it; one all-reduce moves the draw's row bytes."""
    want = _jax_gather(world, name)
    n = len(W.ring_draws()[name])
    row_bytes = sum(v[0].nbytes for v in W.ring_fields().values())
    for r, per in enumerate(_result(ranks, world, "ring_gather")):
        assert per["local_rows"] == W.RING_CAPACITY // world
        got = per[name]
        assert got["reduced"] == n * row_bytes
        for k, v in want.items():
            assert got["whole"][k].dtype == v.dtype, k
            assert got["whole"][k].shape == v.shape, k
            np.testing.assert_array_equal(_bytes(got["whole"][k]), _bytes(v),
                                          err_msg=k)
            rows = slice(r * n // world, (r + 1) * n // world)
            np.testing.assert_array_equal(_bytes(got["mine"][k]),
                                          _bytes(v[rows]), err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_gather_reads_no_index_on_the_host(ranks, world):
    """With ``Tensor.numpy``, ``tolist``, ``cpu`` and ``item`` raising, a
    gather from a device index tensor still runs: nothing reads the
    draw's indices on the host."""
    for per in _result(ranks, world, "ring_gather"):
        assert per["host_read"] is None, per["host_read"]


# -- the echo and RL steps over a sharded ring ----------------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_captured_echo_step_on_a_sharded_ring_trains_the_jax_losses(
        ranks, world):
    """``CapturedStep(make_mesh_echo_fused_step(...), mesh=mesh)`` over a
    ring sharded on ``{"data": world}``: one eager call per step over
    gloo, no replay, and the JAX package's mesh echo losses within
    ECHO_RTOL, alike on every rank."""
    want = _jax_echo_losses(world)
    per_rank = _result(ranks, world, "echo_capture")
    for per in per_rank:
        assert per["ring_rows"] == 64 // world
        assert per["eager_calls"] == per["steps"] == len(want)
        assert per["replays"] == 0
        np.testing.assert_allclose(per["losses"], want, rtol=ECHO_RTOL)
        np.testing.assert_array_equal(per["losses"], per_rank[0]["losses"])


@pytest.mark.parametrize("world", [2, 4])
def test_captured_dqn_learner_on_a_sharded_ring_trains_the_jax_losses(
        ranks, world):
    """The mesh learner through ``CapturedStep(step, mesh=mesh)``: one
    eager call per learner step over gloo, the JAX learner's losses
    within F32_EXACT_ATOL, its parameters and priorities within the
    parameter bar, the priorities alike on every rank."""
    want = _jax_scripted(False)
    per_rank = _result(ranks, world, "rl_mesh:captured")
    for per in per_rank:
        assert per["eager_calls"] == per["steps"] == 12
        assert per["ring_rows"] == 64 // world
        assert per["stats"] == want["stats"]
        np.testing.assert_allclose(per["losses"], want["losses"], rtol=0,
                                   atol=F32_EXACT_ATOL)
        _close_tree(per["params"], want["params"], "params")
        np.testing.assert_allclose(per["prio"], want["prio"], rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_array_equal(per["prio"], per_rank[0]["prio"])


# -- the datagen examples on a mesh ----------------------------------------------------


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_train_transformer_captures_its_sequence_parallel_step(ranks, mode):
    """``train_transformer.py --mesh data=1,seq=2``: the step is a
    ``CapturedStep`` whatever the mesh's axes, eager over gloo (one eager
    call per step), and the example's losses are the bare step's."""
    for per in _result(ranks, 2, f"example_capture:{mode}"):
        wrapped, bare = per["wrapped"], per["bare"]
        assert wrapped["step_type"] == "CapturedStep"
        assert wrapped["eager_calls"] == STEPS
        assert bare["step_type"] != "CapturedStep"
        assert wrapped["losses"] and wrapped["losses"] == bare["losses"]
        assert "images/sec over mesh {'data': 1, 'seq': 2}" in (
            wrapped["text"])


def test_train_py_steps_its_direct_loop_through_a_captured_step(ranks):
    """``train.py`` on ``{"data": 2}`` without a driver (raw batches):
    the direct loop steps through a ``CapturedStep``, eager over gloo,
    with the bare mesh step's losses."""
    for per in _result(ranks, 2, "example_capture:train"):
        wrapped, bare = per["wrapped"], per["bare"]
        assert wrapped["step_type"] == "CapturedStep"
        assert wrapped["eager_calls"] == STEPS
        assert bare["step_type"] != "CapturedStep"
        assert wrapped["last_loss"] == bare["last_loss"]
        assert wrapped["losses"] == bare["losses"]


# -- what a replay adds ------------------------------------------------------------------


class _Replayed:
    """A stand-in for a captured CUDA graph: replay does nothing."""

    replays = 0

    def replay(self):
        self.replays += 1


def test_a_replay_adds_every_collective_kind_and_ulysses_calls():
    """A captured step's replay adds the tally taken once at capture to
    the process counts, every kind (``collective-permute`` and
    ``all-to-all`` among them), and the host calls it holds (Ulysses'
    ``calls`` and ``flash_calls``), once per replay."""
    import torch

    from blendjax_torch.device import HostStager
    from blendjax_torch.obs.devledger import COLLECTIVE_KINDS
    from blendjax_torch.parallel import ulysses
    from blendjax_torch.parallel.collectives import (
        collective_counts,
        tally_diff,
    )
    from blendjax_torch.train.aot import _Graph

    per_kind = {k: 8 * (i + 1) for i, k in enumerate(COLLECTIVE_KINDS)}
    tally = {"ops": len(per_kind), "total_bytes": sum(per_kind.values()),
             "per_kind": per_kind, "per_axis": {"seq": 40, "data": 80}}
    graph = _Graph(None, _Replayed(), {}, torch.zeros(()), 1, {}, {}, [],
                   HostStager(), collectives=tally,
                   calls={"ulysses.calls": 16, "ulysses.flash_calls": 16})

    class State:
        step = 0

    ulysses.reset_counts()
    before = collective_counts()
    for _ in range(3):
        graph(State, {})
    added = tally_diff(collective_counts(), before)
    assert {"collective-permute", "all-to-all"} <= set(per_kind)
    assert added["per_kind"] == {k: 3 * v for k, v in per_kind.items()}
    assert added["per_axis"] == {"seq": 120, "data": 240}
    assert ulysses.calls == ulysses.flash_calls == 48
    assert graph.graph.replays == 3 and State.step == 3
    ulysses.reset_counts()


def test_ulysses_counts_a_call_where_it_runs_off_a_capture():
    """Off a capture (no diverted stream) a counted call goes straight to
    Ulysses' counts."""
    from blendjax_torch.kernels.counting import count_call
    from blendjax_torch.parallel import ulysses

    ulysses.reset_counts()
    count_call("ulysses.calls")
    count_call("ulysses.flash_calls")
    count_call("ulysses.calls")
    assert (ulysses.calls, ulysses.flash_calls) == (2, 1)
    ulysses.reset_counts()
