"""Captured steps on states split over a model axis, against the JAX
package (CPU).

``MeshTrainDriver.build(aot=True, aot_batch=...)`` takes every layout the
JAX package compiles: ``data×fsdp``, ``data×tp`` and ``data×expert``. The
port runs worlds 2 and 4 on gloo at once (rank bodies in
``torch_dist_ranks.py``) while this process runs the JAX package's
``MeshTrainDriver.build(aot=True, aot_batch=...)`` on its virtual CPU
devices, on the same mesh. On the CPU nothing is captured (the ladder runs
the eager step); the graphs themselves, bit-equal with the eager step, are
held on the card (``tests/test_torch_mesh_aot_card.py`` and
``chip_smoke.py``'s two-rank phase, sub-leg (e)).

Bars: the losses within ``CROSS_LAYOUT_ATOL`` (5e-5,
``tests/test_mesh_driver.py``'s bar across layouts: the sums of a split
step run in another order); the aot build's losses equal to the eager
build's; a split state's shards bit for bit after ``_snapshot``, three
updates and ``_restore``; the argument bytes of ``data2×fsdp2`` below
those of ``data4`` by at least ``0.625 x |fsdp|`` (the JAX package's
``test_fsdp_hbm_ledger_fraction`` bar, 2.5 at fsdp 4, scaled to fsdp 2:
the replicated biases and norms and the batch keep it under |fsdp|).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_ranks as W
from blendjax.data import StreamDataPipeline as JaxPipeline
from blendjax.models import StreamFormer as JaxFormer
from blendjax.parallel import batch_sharding as jax_batch_sharding
from blendjax.parallel import create_mesh as jax_create_mesh
from blendjax.train import MeshTrainDriver as JaxMeshDriver
from blendjax_torch.parallel import Layout, PartitionRule
from blendjax_torch.train import cache_key

CROSS_LAYOUT_ATOL = 5e-5
FSDP_FRACTION = 0.625

# name: (mesh axes, layout name or None, MoE model, world)
MESHES = {
    "data1xfsdp2": ((("data", 1), ("fsdp", 2)), "data1xfsdp2", False, 2),
    "data1xtp2": ((("data", 1), ("tp", 2)), "data1xtp2", False, 2),
    "data1xexpert2": ((("data", 1), ("expert", 2)), None, True, 2),
    "data2xfsdp1": ((("data", 2), ("fsdp", 1)), None, False, 2),
    "data2xfsdp2": ((("data", 2), ("fsdp", 2)), "data2xfsdp2", False, 4),
    "data2xtp2": ((("data", 2), ("tp", 2)), "data2xtp2", False, 4),
    "data2xexpert2": ((("data", 2), ("expert", 2)), None, True, 4),
    "data4": ((("data", 4),), "data4", False, 4),
}
SPLIT = [n for n in MESHES if n != "data4"]
CACHE_LAYOUTS = ("data2", "data2", "data1xfsdp2", "data1xtp2", "data1xtp2")


@functools.lru_cache(maxsize=None)
def _former_params(moe: bool):
    """Seeded StreamFormer parameters in the flax tree's shapes."""
    cfg = W.FORMER_MOE if moe else W.FORMER_TP
    jm = JaxFormer(**cfg, dtype=jnp.float32, attn_backend="xla")
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.zeros((1, 32, 32, 4), jnp.uint8)))
    rng = np.random.default_rng(0)

    def fill(path, s):
        if jax.tree_util.keystr(path).endswith("['scale']"):
            return np.ones(s.shape, np.float32)
        if len(s.shape) == 1:
            return (rng.normal(size=s.shape) * 0.1).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes["params"])


def _jax_loss(state, p, batch):
    from blendjax.train import corner_loss

    pred = state.apply_fn({"params": p}, batch["image"])
    return corner_loss(pred.reshape(-1, 8, 2), batch["xy"],
                       image_shape=batch["image"].shape[1:3])


@functools.lru_cache(maxsize=None)
def _jax_aot_losses(name: str):
    """The JAX package's ``MeshTrainDriver.build(aot=True, aot_batch=...,
    layout=...)`` on the same mesh over the same messages."""
    axes, layout, moe, _world = MESHES[name]
    mesh = jax_create_mesh(dict(axes), devices=jax.devices()[
        :int(np.prod([s for _, s in axes]))])
    cfg = W.FORMER_MOE if moe else W.FORMER_TP
    first = W.former_messages()[0]
    bs = jax_batch_sharding(mesh)
    drv = JaxMeshDriver.build(
        JaxFormer(**cfg, dtype=jnp.float32, attn_backend="xla"), mesh,
        np.zeros((8, 32, 32, 4), np.uint8), loss_fn=_jax_loss, layout=layout,
        aot=True, aot_batch={"image": jax.device_put(first["image"], bs),
                             "xy": jax.device_put(first["xy"], bs)},
        buckets=(8,), sync_every=1, inflight=1)
    params = jax.tree.map(lambda a, v: jax.device_put(jnp.asarray(v),
                                                      a.sharding),
                          drv.state.params, _former_params(moe))
    drv.state = drv.state.replace(params=params,
                                  opt_state=drv.state.tx.init(params))
    with JaxPipeline(iter(W.former_messages()), batch_size=8,
                     mesh=mesh) as pipe:
        for sb in pipe:
            drv.submit(sb)
    drv.finish()
    return np.asarray(drv.losses)


@functools.lru_cache(maxsize=None)
def _jax_data_losses():
    """The JAX package's losses on ``{"data": 2}`` (what a size-1 fsdp
    axis must train)."""
    mesh = jax_create_mesh({"data": 2}, devices=jax.devices()[:2])
    drv = JaxMeshDriver.build(
        JaxFormer(**W.FORMER_TP, dtype=jnp.float32, attn_backend="xla"),
        mesh, np.zeros((8, 32, 32, 4), np.uint8), loss_fn=_jax_loss,
        sync_every=1, inflight=1)
    params = jax.tree.map(lambda a, v: jax.device_put(jnp.asarray(v),
                                                      a.sharding),
                          drv.state.params, _former_params(False))
    drv.state = drv.state.replace(params=params,
                                  opt_state=drv.state.tx.init(params))
    with JaxPipeline(iter(W.former_messages()), batch_size=8,
                     mesh=mesh) as pipe:
        for sb in pipe:
            drv.submit(sb)
    drv.finish()
    return np.asarray(drv.losses)


def _cases(world, tmp):
    out = [(f"mesh_aot:{name}", {"params_np": _former_params(moe),
                                 "axes": dict(axes), "layout": layout,
                                 "moe": moe})
           for name, (axes, layout, moe, w) in MESHES.items() if w == world]
    if world == 2:
        out.append(("aot_cache", {"params_np": _former_params(False),
                                  "tmp": tmp, "layouts": CACHE_LAYOUTS}))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both worlds' ranks, while this process runs the JAX side."""
    import threading

    tmp = str(tmp_path_factory.mktemp("ranks"))
    cases = {w: _cases(w, tmp) for w in (2, 4)}
    out: dict = {}

    def run():
        try:
            out["ranks"] = W.run_worlds(cases, tmp, timeout=240.0)
        except BaseException as e:  # raised below, in the test
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    for name in SPLIT:
        if name != "data2xfsdp1":
            _jax_aot_losses(name)
    _jax_data_losses()
    t.join(280.0)
    assert not t.is_alive(), "the ranks did not finish"
    if "error" in out:
        raise out["error"]
    return out["ranks"]


def _result(ranks, name):
    world = MESHES[name][3] if name in MESHES else 2
    key = f"mesh_aot:{name}" if name in MESHES else name
    per_rank = [r[key] for r in ranks[world]]
    for r in per_rank:
        if isinstance(r, dict) and "error" in r:
            pytest.fail(r["error"])
    return per_rank


@pytest.mark.parametrize("name", [n for n in SPLIT if n != "data2xfsdp1"])
def test_aot_split_layouts_train_the_jax_aot_losses(ranks, name):
    """``build(aot=True)`` on a split state: an AOT step set over the
    bucket ladder (no fallback), the losses of the JAX package's
    ``build(aot=True)`` on the same mesh within CROSS_LAYOUT_ATOL, and
    the eager build's losses exactly."""
    want = _jax_aot_losses(name)
    for per in _result(ranks, name):
        assert per["sharded"], "the layout did not split the state"
        assert per["step"] == "AotStepSet" and per["signatures"] >= 1
        assert per["fallbacks"] == 0
        np.testing.assert_allclose(per["aot"], want, rtol=0,
                                   atol=CROSS_LAYOUT_ATOL)
        assert per["aot"].shape == want.shape == (4,)
        np.testing.assert_array_equal(per["aot"], per["eager"])


def test_an_fsdp_axis_of_one_rank_gathers_and_trains_the_data_losses(ranks):
    """data2 x fsdp1: the state is split (each shard whole), the step
    gathers every fsdp shard over one rank (all-gathers on the fsdp axis
    in the first step call's tally), and the losses are the JAX package's
    on ``{"data": 2}`` within CROSS_LAYOUT_ATOL, with and without aot."""
    want = _jax_data_losses()
    for per in _result(ranks, "data2xfsdp1"):
        assert per["sharded"] and per["step"] == "AotStepSet"
        tally = per["tally"]
        assert tally["per_kind"]["all-gather"] > 0
        assert any("fsdp" in ax for ax in tally["per_axis"]), tally
        np.testing.assert_allclose(per["aot"], want, rtol=0,
                                   atol=CROSS_LAYOUT_ATOL)
        np.testing.assert_array_equal(per["aot"], per["eager"])


@pytest.mark.parametrize("name", SPLIT)
def test_snapshot_and_restore_give_the_shards_back_bit_for_bit(ranks, name):
    """What a capture does around its warm-up: ``_snapshot`` of a split
    state, three updates (which move every shard and moment), then
    ``_restore``: this rank's shards and their optimizer's tensors are
    the snapshot's, bit for bit."""
    for per in _result(ranks, name):
        assert per["moved"] > 0
        assert per["restored"]


def test_a_manifest_written_under_one_layout_reads_cold_under_another(ranks):
    """One aot manifest, builds on data2, data2, data1xfsdp2, data1xtp2
    and data1xtp2 (data2 and data1xfsdp2 give each rank 4 rows: one
    signature): a layout's second build reads warm, a new layout's first
    reads cold."""
    for per in _result(ranks, "aot_cache"):
        (l0, h0, m0), (l1, h1, m1), (l2, h2, m2), (l3, h3, m3), \
            (l4, h4, m4) = per
        assert (l0, l1, l2, l3, l4) == CACHE_LAYOUTS
        assert h0 == 0 and m0 > 0
        assert h1 == m0 and m1 == 0
        assert h2 == 0 and m2 > 0
        assert h3 == 0 and m3 > 0
        assert h4 == m3 and m4 == 0


def test_cache_key_moves_with_the_mesh_the_layout_and_the_rules():
    base = dict(model="m", buckets=(4, 8))
    keys = {
        cache_key(**base),
        cache_key(**base, mesh="DeviceMesh('cuda', [0, 1], "
                  "mesh_dim_names=('data',))"),
        cache_key(**base, mesh="DeviceMesh('cuda', [[0, 1]], "
                  "mesh_dim_names=('data', 'fsdp'))"),
        cache_key(**base, layout="data1xfsdp2"),
        cache_key(**base, layout=Layout("data1xtp2", data=1, tp=2)),
        cache_key(**base, rules=(PartitionRule("qkv/kernel$", ("tp", None)),)),
        cache_key(**base, rules=(PartitionRule("qkv/kernel$", (None, "tp")),)),
    }
    assert len(keys) == 7
    assert cache_key(**base, layout="data1xfsdp2") == cache_key(
        **base, layout="data1xfsdp2")


def test_fsdp_argument_bytes_are_a_fraction_of_the_replicated_layouts(ranks):
    """The port's counterpart of ``test_fsdp_hbm_ledger_fraction``: the
    bytes a captured step takes as arguments (the state it updates in
    place and this rank's batch) under data2 x fsdp2 against data4, at
    world 4. Bar: ``0.625 x |fsdp|`` = 1.25, the JAX test's 2.5 at fsdp 4
    scaled to fsdp 2."""
    rep = [p["argument_bytes"] for p in _result(ranks, "data4")]
    fsdp = [p["argument_bytes"] for p in _result(ranks, "data2xfsdp2")]
    assert len(set(rep)) == 1 and len(set(fsdp)) == 1
    assert rep[0] / fsdp[0] > FSDP_FRACTION * 2, (rep, fsdp)
    assert rep[0] / fsdp[0] < 2, (rep, fsdp)
