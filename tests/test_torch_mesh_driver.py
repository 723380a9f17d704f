"""The port's MeshTrainDriver, mesh pipeline and sharded echo against the
JAX package's (CPU).

The port runs worlds 1, 2 and 4 on gloo, all at once (rank bodies in
``torch_dist_ranks.py``); the JAX package runs the same recorded streams
through its own MeshTrainDriver on a 1-device mesh, from the same weights.

Bars (the JAX package's, ``tests/test_mesh_driver.py``): the data layout at
every world size within ``F32_EXACT_ATOL`` of the JAX 1-device losses, the
fsdp and tp layouts within ``CROSS_LAYOUT_ATOL``; echo accounting exact;
a sharded snapshot restores bit for bit on one card and in the JAX
package.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch_dist_ranks as W
from blendjax.data import StreamDataPipeline as JaxPipeline
from blendjax.data.echo import EchoingPipeline as JaxEcho
from blendjax.data.echo import SampleReservoir as JaxReservoir
from blendjax.models import CubeRegressor as JaxCube
from blendjax.parallel import create_mesh as jax_create_mesh
from blendjax.parallel import replicated as jax_replicated
from blendjax.train import MeshTrainDriver as JaxMeshDriver

F32_EXACT_ATOL = 5e-6
CROSS_LAYOUT_ATOL = 5e-5


@functools.lru_cache(maxsize=None)
def _params():
    jm = JaxCube(features=W.FEATURES, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.zeros((1, W.HW, W.HW, 4), jnp.uint8)))
    rng = np.random.default_rng(0)

    def fill(s):
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 16
        return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree.map(fill, shapes["params"])


def _jax_driver(batch=W.B, fused=False, inflight=2):
    mesh = jax_create_mesh({"data": 1}, devices=jax.devices()[:1])
    drv = JaxMeshDriver.build(
        JaxCube(features=W.FEATURES, dtype=jnp.float32), mesh,
        np.zeros((batch, W.HW, W.HW, 4), np.uint8), fused=fused,
        sync_every=1, inflight=inflight)
    params = jax.device_put(jax.tree.map(jnp.asarray, _params()),
                            jax_replicated(mesh))
    drv.state = drv.state.replace(params=params,
                                  opt_state=drv.state.tx.init(params))
    return mesh, drv


@functools.lru_cache(maxsize=None)
def _jax_losses(kind: str):
    if kind == "data":
        mesh, drv = _jax_driver()
        with JaxPipeline(iter(W.messages(10)), batch_size=W.B,
                         mesh=mesh) as pipe:
            for sb in pipe:
                drv.submit(sb)
    elif kind == "fused":
        mesh, drv = _jax_driver(batch=8, fused=True)
        with JaxPipeline(iter(W.tile_messages(6, 8)), batch_size=8,
                         mesh=mesh, chunk=2, emit_packed=True) as pipe:
            for sb in pipe:
                drv.submit(sb)
    else:  # scripted reservoir draws
        mesh, drv = _jax_driver(inflight=1)
        res = JaxReservoir(64, augment=None, rng=7)
        idx_rng = np.random.default_rng(11)
        for hb in W.messages(4):
            res.insert({"image": hb["image"], "xy": hb["xy"]})
            for _ in range(2):
                drv.submit(res.sample(idx_rng.integers(0, res.size, W.B)))
    drv.finish()
    return np.concatenate([np.ravel(v) for v in drv.losses])


@functools.lru_cache(maxsize=None)
def _jax_echo():
    mesh = jax_create_mesh({"data": 1}, devices=jax.devices()[:1])
    inner = JaxPipeline(iter(W.messages(6)), batch_size=W.B, mesh=mesh)
    echo = JaxEcho(inner, capacity=6 * W.B, max_echo_factor=4, augment=None,
                   mesh=mesh, batch_size=W.B)
    with echo:
        n = sum(1 for _ in echo)
    return {"inserted": echo.inserted, "fresh": echo.fresh,
            "echoed": echo.echoed, "steps": echo.steps, "draws": n}


def _cases(world, snap_dir):
    p = _params()
    data = {"axes": {"data": -1}}
    cases = [("drive:data", {"params_np": p, **data})]
    if world >= 2:
        cases += [
            ("drive:fused", {"params_np": p, **data, "fused": True,
                             "chunk": 2, "n_msgs": 6}),
            ("pipeline_rules", data),
            ("reservoir", {"params_np": p, **data}),
            ("echo", {"params_np": p, **data}),
            ("live:even", {"params_np": p, **data}),
            ("live:uneven", {"params_np": p, **data,
                             "counts": [10, 6, 8, 9][:world]}),
        ]
    if world == 4:
        cases += [
            ("drive:fsdp", {"params_np": p, "axes": {"data": 2, "fsdp": 2},
                            "layout": "data2xfsdp2"}),
            ("drive:tp", {"params_np": p, "axes": {"data": 2, "tp": 2},
                          "layout": "data2xtp2"}),
            ("snapshot", {"params_np": p, "axes": {"data": 2, "fsdp": 2},
                          "layout": "data2xfsdp2", "path": snap_dir}),
            ("live:tp", {"params_np": p, "axes": {"data": 2, "tp": 2}}),
        ]
    return cases


@pytest.fixture(scope="module")
def snap_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("snapshot"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, snap_dir):
    """Every case, on worlds 1, 2 and 4 at once."""
    return W.run_worlds({w: _cases(w, snap_dir) for w in (1, 2, 4)},
                        str(tmp_path_factory.mktemp("ranks")))


def _result(ranks, world, name):
    per_rank = [r[name] for r in ranks[world]]
    for r in per_rank:
        if isinstance(r, dict) and "error" in r:
            pytest.fail(r["error"])
    return per_rank


# -- the data layout ------------------------------------------------------------------


@pytest.mark.parametrize("world", [1, 2, 4])
def test_data_layout_losses_match_the_jax_single_device_mesh(ranks, world):
    """The acceptance gate: one recorded stream through the port's
    MeshTrainDriver at world 1, 2 and 4, every rank reporting the global
    loss, against the JAX package's 1-device mesh, step for step."""
    want = _jax_losses("data")
    for per in _result(ranks, world, "drive:data"):
        assert per["losses"].shape == want.shape == (10,)
        np.testing.assert_allclose(per["losses"], want, rtol=0,
                                   atol=F32_EXACT_ATOL)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_one_step_call_per_step_and_the_mesh_stats(ranks, world):
    for per in _result(ranks, world, "drive:data"):
        assert per["train_dispatch"] == per["dispatches"] == per["steps"] == 10
        assert per["decode_dispatch"] == 0
        assert per["stats"] == {"chips": world, "processes": world,
                                "layout": "data", "data_axis_size": world}
        # images count the global batch, on every rank, and the MFU peak
        # is the mesh's cards' together
        assert per["images_retired"] == 10 * W.B
        assert per["lead"] == W.B // world
        assert per["peak_flops"] == pytest.approx(world * 1e12)
        assert per["fleet"] == (world, [f"p{i}" for i in range(world)])


def test_fused_mesh_step_decodes_per_rank_and_matches(ranks):
    """Packed tile groups travel whole and each rank decodes its rows
    inside the step: one step call per chunk group, no standalone decode,
    and the JAX 1-device mesh's losses."""
    want = _jax_losses("fused")
    for per in _result(ranks, 2, "drive:fused"):
        assert per["train_dispatch"] == per["dispatches"] == 3
        assert per["decode_dispatch"] == 0
        np.testing.assert_allclose(per["losses"], want, rtol=0,
                                   atol=F32_EXACT_ATOL)


@pytest.mark.parametrize("world", [2, 4])
def test_batch_must_divide_and_the_tail_pads_mesh_divisibly(ranks, world):
    """A batch the axis does not divide is refused by name; a 3-row tail
    pads to the smallest bucket the axis divides, split evenly."""
    per = _result(ranks, world, "pipeline_rules")
    for r, got in enumerate(per):
        assert "divide evenly" in got["refused"]
        assert got["leads"] == [W.B // world, W.B // world, 4 // world]
    mask = np.concatenate([got["tail_mask"] for got in per])
    assert mask.tolist() == [1.0, 1.0, 1.0, 0.0]


# -- live producers ---------------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_live_producers_feed_each_rank_its_own_rows(ranks, world):
    """Each rank's pipeline assembles its B/world rows from its own
    producer (PUSH to one PULL) and the mesh trains the global batches
    the JAX 1-device mesh trains from the recording."""
    want = _jax_losses("data")
    for per in _result(ranks, world, "live:even"):
        assert per["rank_batch"] == W.B // world
        assert per["leads"] == [W.B // world] * 10
        assert per["messages"] == 10
        np.testing.assert_allclose(per["losses"], want, rtol=0,
                                   atol=F32_EXACT_ATOL)


@pytest.mark.parametrize("world", [2, 4])
def test_live_ranks_end_together_when_one_stream_ends(ranks, world):
    """Rank 1's producer sends 6 messages, the others more: every rank
    stops after 6 steps (no unmatched collective, no hang), with the
    losses of the first 6 global batches."""
    want = _jax_losses("data")[:6]
    for per in _result(ranks, world, "live:uneven"):
        assert per["steps"] == 6
        np.testing.assert_allclose(per["losses"], want, rtol=0,
                                   atol=F32_EXACT_ATOL)


def test_live_producers_feed_a_tp_group_its_leaders_rows(ranks):
    """Live producers on data2 x tp2: each data group's first rank ingests
    from its producer and broadcasts every host batch over the tp group,
    so both ranks of a tp group train on the same rows, every row of the
    recorded stream appears once across the data groups, and no rank but
    the leaders took a message off the producers."""
    per = _result(ranks, 4, "live:tp")
    by_group: dict = {}
    for got in per:
        assert got["rank_batch"] == W.B // 2
        assert got["leads"] == [W.B // 2] * 10
        assert got["messages"] == (10 if got["leader"] else 0)
        by_group.setdefault(got["group"], []).append(got["xy"])
    assert sorted(by_group) == [0, 1]
    for xys in by_group.values():
        assert len(xys) == 2
        for a, b in zip(*xys):
            np.testing.assert_array_equal(a, b)
    want = np.concatenate([m["xy"] for m in W.messages(10)])
    got = np.concatenate([np.concatenate([by_group[g][0][i] for g in (0, 1)])
                          for i in range(10)])
    np.testing.assert_array_equal(got, want)


def test_live_tp_group_trains_the_jax_replay_losses(ranks):
    """The same live run's losses against the JAX package's replay of the
    recorded stream (its 1-device mesh), within the cross-layout bar."""
    want = _jax_losses("data")
    for got in _result(ranks, 4, "live:tp"):
        np.testing.assert_allclose(got["losses"], want, rtol=0,
                                   atol=CROSS_LAYOUT_ATOL)


# -- the fsdp and tp layouts ----------------------------------------------------------


@pytest.mark.parametrize("layout,axis", [("fsdp", "fsdp"), ("tp", "tp")])
def test_model_axis_layouts_train_the_same_losses(ranks, layout, axis):
    """data2×fsdp2 and data2×tp2: the state sharded over the model axis,
    the losses of the replicated run within the cross-layout bar, and less
    state resident per rank than replicated. fsdp gathers its shards on
    use; tp computes with its blocks in place (the convolutions make this
    rank's channels, all-gathered into the next one; the hidden Dense is
    column-split and the head row-split, summed over tp), gathering no
    parameter (``blendjax_torch/docs/mesh-split.md``)."""
    want = _jax_losses("data")
    rep = _result(ranks, 4, "drive:data")[0]["resident"]
    for per in _result(ranks, 4, f"drive:{layout}"):
        np.testing.assert_allclose(per["losses"], want, rtol=0,
                                   atol=CROSS_LAYOUT_ATOL)
        assert any(axis in (e if isinstance(e, tuple) else (e,))
                   for spec in per["specs"] for e in spec), per["specs"]
        assert per["stats"]["layout"] == f"data×{layout}"
        assert per["resident"] < rep
        if layout == "fsdp":
            # every large leaf halves; biases stay whole
            assert per["resident"] < 0.6 * rep
        kinds = per["tally"]["per_kind"]
        assert kinds["all-gather"] > 0 and kinds["all-reduce"] > 0
        if layout == "tp":
            # the activations cross tp, never a kernel
            assert per["gathers"] == 0
            assert per["tally"]["per_axis"]["tp"] > 0
        else:
            assert per["gathers"] > 0


# -- the sharded reservoir and echo ----------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_reservoir_layout_and_scripted_draws(ranks, world):
    """Capacity splits over the batch axis (stable storage); a capacity
    the axis does not divide is refused; scripted draws through the mesh
    step train the JAX 1-device losses."""
    want = _jax_losses("draws")
    for per in _result(ranks, world, "reservoir"):
        assert "divide evenly" in per["refused"]
        assert per["ring_rows"] == 64 // world
        assert per["stable"]
        assert per["drawn_lead"] == W.B // world
        np.testing.assert_allclose(per["losses"], want, rtol=0,
                                   atol=F32_EXACT_ATOL)


@pytest.mark.parametrize("world", [2, 4])
def test_echo_accounting_exact_on_the_mesh(ranks, world):
    """Run to exhaustion with capacity for every sample: each sample is
    drawn exactly max_echo_factor times; the counts are the JAX package's
    1-device run's, and one step call per draw."""
    want = _jax_echo()
    for per in _result(ranks, world, "echo"):
        assert per["inserted"] == want["inserted"] == 6 * W.B
        assert per["fresh"] == per["inserted"]
        assert per["fresh"] + per["echoed"] == per["steps"] * W.B
        assert (per["steps"], per["fresh"], per["echoed"]) == (
            want["steps"], want["fresh"], want["echoed"])
        assert per["dispatches"] == per["steps"]
        assert "divide evenly" in per["refused"]
        assert np.all(np.isfinite(per["losses"]))


# -- a sharded snapshot ---------------------------------------------------------------------


def test_sharded_snapshot_restores_on_one_card_and_in_the_jax_package(
        ranks, snap_dir):
    """A data2×fsdp2 state after 2 updates gathers to one card's leaves
    (the same on every rank, loaded back onto the mesh bit for bit); the
    snapshot rank 0 wrote restores into the single-card port and into the
    JAX package's TrainState."""
    import torch

    from blendjax.checkpoint import SnapshotManager as JaxSnapshots
    from blendjax.train import make_train_state as jax_state
    from blendjax_torch.checkpoint import SnapshotManager
    from blendjax_torch.models import CubeRegressor
    from blendjax_torch.train import make_train_state
    from blendjax_torch.weights import (
        from_flax,
        load_train_state_leaves,
        train_state_leaves,
    )

    per = _result(ranks, 4, "snapshot")
    leaves = per[0]["leaves"]
    for got in per:
        assert got["sharded"] and got["reloaded_equal"]
        for k, v in leaves.items():
            np.testing.assert_array_equal(got["leaves"][k], v, err_msg=k)
    assert int(leaves[".step"]) == 2
    assert int(leaves[".opt_state[0].count"]) == 2
    tm = CubeRegressor(features=W.FEATURES, dtype=torch.float32)
    tm.load_state_dict(from_flax(_params()))
    state = make_train_state(tm, device="cpu")
    r = SnapshotManager(snap_dir).restore(train_state_leaves(state))
    load_train_state_leaves(state, r.state)
    for k, v in train_state_leaves(state).items():
        np.testing.assert_array_equal(np.asarray(v), leaves[k], err_msg=k)
    template = jax_state(JaxCube(features=W.FEATURES, dtype=jnp.float32),
                         jnp.zeros((1, W.HW, W.HW, 4), jnp.uint8))
    restored = JaxSnapshots(snap_dir).restore(template)
    assert restored.step == 2
    flat, _ = jax.tree_util.tree_flatten_with_path(restored.state)
    got = {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}
    assert set(got) == set(leaves)
    for k, v in leaves.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_a_streamformer_snapshot_restores_in_the_jax_package(tmp_path):
    """StreamFormer's train state under the JAX package's leaf paths (the
    reverse of streamformer_from_flax): the port trains 2 updates and
    snapshots; the JAX package restores the snapshot onto its own
    StreamFormer TrainState with exactly the port's leaves."""
    import torch

    from blendjax.checkpoint import SnapshotManager as JaxSnapshots
    from blendjax.models import StreamFormer as JaxFormer
    from blendjax.train import make_train_state as jax_state
    from blendjax_torch.checkpoint import SnapshotManager
    from blendjax_torch.models import StreamFormer
    from blendjax_torch.train import corner_loss
    from blendjax_torch.train import steps as S
    from blendjax_torch.weights import streamformer_from_flax, train_state_leaves

    cfg = dict(patch=8, dim=32, depth=2, num_heads=4, num_outputs=16)
    images = jnp.zeros((1, 32, 64, 4), jnp.uint8)
    template = jax_state(JaxFormer(**cfg, dtype=jnp.float32), images)
    model = StreamFormer(**cfg, dtype=torch.float32, attn_backend="xla",
                         image_shape=(32, 64))
    model.load_state_dict(streamformer_from_flax(
        jax.tree.map(np.asarray, template.params)))
    state = S.make_train_state(model, device="cpu")

    def loss(m, batch):
        return corner_loss(m(batch["image"]).reshape(-1, 8, 2), batch["xy"],
                           image_shape=(32, 64))

    step = S.make_supervised_step(loss_fn=loss, precision="f32")
    rng = np.random.default_rng(2)
    for _ in range(2):
        step(state, {"image": torch.from_numpy(rng.integers(
            0, 256, (2, 32, 64, 4), dtype=np.uint8)),
            "xy": torch.from_numpy(rng.uniform(0, 32, (2, 8, 2))
                                   .astype(np.float32))})
    leaves = {k: (v.detach().numpy() if isinstance(v, torch.Tensor)
                  else np.asarray(v))
              for k, v in train_state_leaves(state).items()}
    flat, _ = jax.tree_util.tree_flatten_with_path(template)
    assert list(leaves) == [jax.tree_util.keystr(p) for p, _ in flat]
    mgr = SnapshotManager(str(tmp_path))
    mgr.save(2, leaves)
    mgr.close()
    restored = JaxSnapshots(str(tmp_path)).restore(template)
    assert restored.step == 2 and int(restored.state.step) == 2
    flat, _ = jax.tree_util.tree_flatten_with_path(restored.state)
    for p, v in flat:
        k = jax.tree_util.keystr(p)
        np.testing.assert_array_equal(np.asarray(v), leaves[k], err_msg=k)
