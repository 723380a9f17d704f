"""The port's parallel modules against the JAX package's (CPU).

The port runs world 2 and world 4 on gloo (the rank bodies are in
``torch_dist_ranks.py``: one process group per world for the whole
module, every case run there, asserted here case by case); the JAX side
runs on a mesh of the same shape over the first 2 or 4 of conftest's 8
virtual CPU devices. Same numpy inputs from seeds on both sides.

Tolerances (f32): collectives exact but for f32 sums (rtol 1e-6); ring and
Ulysses attention, forward and gradients, atol 2e-5 (the JAX package's
own bar for them); the Ulysses StreamFormer loss rtol 1e-5, its gradients
rtol 1e-4 / atol 1e-6; the sharded decode bit for bit.
"""

import functools
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_dist_ranks as W
from blendjax.models import CubeRegressor as JaxCube
from blendjax.models import StreamFormer as JaxFormer
from blendjax.parallel import create_mesh as jax_create_mesh
from blendjax.parallel import sharding as JS
from blendjax.parallel.mesh import MeshSpec as JaxMeshSpec
from blendjax_torch.parallel import sharding as S
from blendjax_torch.parallel.mesh import MeshSpec
from blendjax_torch.weights import streamformer_from_flax

ATTN_ATOL = 2e-5
# ring attention (f32 streaming softmax over bf16 operands) against local
# attention in a bf16 StreamFormer: the relative bar on per-update losses
# (chip_smoke.py holds its ring leg to it against the flash kernels)
BF16_LOSS_REL = 2e-2
WORLDS = (2, 4)


def _jmesh(axes, n):
    return jax_create_mesh(axes, devices=jax.devices()[:n])


def _np_params(model, example, seed):
    """Parameters of ``model``'s flax tree from a numpy seed (the shapes
    from ``jax.eval_shape``, which compiles nothing): normal, scaled by
    each leaf's fan-in, so both sides start from the same weights."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0), example))
    rng = np.random.default_rng(seed)

    def fill(s):
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 16
        return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree.map(fill, shapes["params"])


@functools.lru_cache(maxsize=None)
def _cube_params():
    return _np_params(JaxCube(features=W.FEATURES, dtype=jnp.float32),
                      jnp.zeros((1, W.HW, W.HW, 4), jnp.uint8), 0)


def _former(mesh=None):
    """The Ulysses StreamFormer on ``mesh``; without one the dense model
    (the same parameter tree, for ``init``)."""
    sp = {} if mesh is None else {"use_ring": True, "sp_mode": "ulysses",
                                  "mesh": mesh}
    return JaxFormer(patch=8, dim=32, depth=1, num_heads=4, num_outputs=16,
                     dtype=jnp.float32, attn_backend="xla", **sp)


@functools.lru_cache(maxsize=None)
def _former_inputs():
    images = np.random.default_rng(5).integers(0, 256, (4, 32, 32, 4),
                                               dtype=np.uint8)
    return images, _np_params(_former(), jnp.asarray(images), 1)


ATTN_CASES = [(kind, causal) for kind in ("ring", "ulysses")
              for causal in (False, True)]


def _cases(world):
    cube = _cube_params()
    images, former = _former_inputs()
    cases = [
        ("mesh", {"specs": [{"data": -1}, {"data": -1, "tp": 2},
                            {"data": 2, "seq": -1}, {"data": 3}]}),
        ("collectives", {"n": world}),
        ("decode", {"axes": {"data": -1}}),
        ("collective_bytes", {"params_np": cube,
                              "axes": {"data": -1, "seq": 2}}),
        ("ulysses_heads", {"axes": {"data": world // 2, "seq": 2}}),
        ("fleet", {}),
    ]
    for kind, causal in ATTN_CASES:
        cases.append((f"attention:{kind}:{causal}", {
            "kind": kind, "causal": causal,
            "axes": {"data": world // 2, "seq": 2}}))
    if world == 2:
        cases.append(("ring_bf16", {"params_np": former, "images": images,
                                    "axes": {"seq": 2}}))
    if world == 4:
        cases.append(("shard_params", {"axes": {"fsdp": 2, "tp": 2}}))
        cases.append(("former_grad", {"params_np": former, "images": images,
                                      "axes": {"data": 2, "seq": 2}}))
    return cases


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case of this module, run once per world (both at once)."""
    return W.run_worlds({w: _cases(w) for w in WORLDS},
                        str(tmp_path_factory.mktemp("ranks")))


def _result(ranks, world, name, rank=None):
    per_rank = [r[name] for r in ranks[world]]
    for r in per_rank:
        if isinstance(r, dict) and "error" in r:
            pytest.fail(r["error"])
    return per_rank if rank is None else per_rank[rank]


# -- mesh resolution, layouts and partition rules --------------------------------


@pytest.mark.parametrize("axes,n", [
    ({"data": -1}, 8), ({"data": -1, "tensor": 2}, 8), ({"data": 2, "seq": 4}, 8),
    ({"data": 3}, 8), ({"data": -1, "tp": -1}, 8), ({"data": -1, "fsdp": 3}, 8),
])
def test_mesh_spec_resolution_matches_the_reference(axes, n):
    try:
        want = JaxMeshSpec(dict(axes)).resolve(n)
    except AssertionError:
        with pytest.raises(ValueError):
            MeshSpec(dict(axes)).resolve(n)
        return
    assert MeshSpec(dict(axes)).resolve(n) == want


@pytest.mark.parametrize("world", WORLDS)
def test_create_mesh_builds_the_device_mesh(ranks, world):
    got = _result(ranks, world, "mesh", 0)
    assert got["{'data': -1}"] == {"data": world}
    assert got["{'data': -1, 'tp': 2}"] == {"data": world // 2, "tp": 2}
    assert got["{'data': 2, 'seq': -1}"] == {"data": 2, "seq": world // 2}
    assert got["{'data': 3}"].startswith("ValueError")


@pytest.mark.parametrize("layout", [
    None, "data", "data×fsdp", "data2xfsdp4", "data4×tp2", "tensor", "seq4",
    {"data": 2, "tp": 4}, "data×fsdp×tp",
])
def test_layout_resolution_matches_the_reference(layout):
    got, want = S.resolve_layout(layout), JS.resolve_layout(layout)
    assert (got.name, got.data, got.fsdp, got.tp, got.seq) == (
        want.name, want.data, want.fsdp, want.tp, want.seq)
    assert got.mesh_axes() == want.mesh_axes()
    with pytest.raises(ValueError, match="unknown layout axis"):
        S.resolve_layout("data×pipe3")


def _fake_mesh(shape: dict):
    """A stand-in with a mesh's names and shape, for spec arithmetic that
    needs no process group."""
    return types.SimpleNamespace(mesh_dim_names=tuple(shape),
                                 mesh=np.zeros(tuple(shape.values())))


def _spec(s):
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e
                 for e in tuple(s))


MESHES = [{"data": 2, "fsdp": 4}, {"data": 4, "tp": 2},
          {"fsdp": 4, "tensor": 2}, {"data": 2, "fsdp": 2, "tp": 2},
          {"data": 8}]


@pytest.mark.parametrize("shape", MESHES)
def test_partition_rules_match_the_reference(shape):
    """First match wins, a missing or size-1 axis drops, the generic
    defaults fill in: the same specs as the reference on every parameter
    of a StreamFormer and a CubeRegressor, with the model's rules."""
    jm = jax_create_mesh(shape)
    tm = _fake_mesh(shape)
    _, former = _former_inputs()
    rules = tuple(JS.DEFAULT_TP_RULES) + (
        JS.PartitionRule(r"^Dense_0/kernel$", ("tp",)),)
    port_rules = _former_rules()
    trees = [(former, rules, port_rules), (_cube_params(), (), ())]
    for tree, jr, pr in trees:
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        for path, v in flat:
            keys = tuple(str(k.key) for k in path)
            want = JS.param_sharding_rules(jm, path, v, rules=jr).spec
            got = S.param_sharding_rules(tm, keys, v.shape, rules=pr).spec
            assert _spec(got) == _spec(want), (keys, got, want)


def _former_rules():
    from blendjax_torch.models import StreamFormer

    return StreamFormer(patch=8, dim=32, depth=1, num_heads=4,
                        image_shape=(32, 32)).partition_rules()


def test_the_model_rules_are_the_references():
    jr = _former().partition_rules()
    pr = _former_rules()
    assert [(r.pattern, r.spec) for r in pr] == [
        (r.pattern, r.spec) for r in jr]
    assert S.resolve_rules(rules=(), model=object()) == ()
    assert S.resolve_rules(layout="data") == ()


@pytest.mark.parametrize("shape,layout", [
    ({"data": 2, "fsdp": 2}, "data2xfsdp2"), ({"data": 2, "tp": 2}, "data2xtp2"),
])
def test_state_shardings_cover_the_optimizer_moments(shape, layout):
    """The derived state tree puts mu and nu on their parameters' layout,
    under the JAX package's leaf paths, spec for spec as its own."""
    import torch

    from blendjax.train import make_train_state as jax_state
    from blendjax_torch.models import CubeRegressor
    from blendjax_torch.train import make_train_state
    from blendjax_torch.weights import from_flax

    jm = jax_create_mesh(shape, devices=jax.devices()[:4])
    jst = jax.eval_shape(lambda: jax_state(
        JaxCube(features=W.FEATURES, dtype=jnp.float32),
        jnp.zeros((1, W.HW, W.HW, 4), jnp.uint8)))
    rules = JS.resolve_rules(layout=layout)
    want = JS.state_shardings(jst, mesh=jm, rules=rules)
    flat, _ = jax.tree_util.tree_flatten_with_path(want)
    want_specs = {jax.tree_util.keystr(p): _spec(s.spec) for p, s in flat
                  if s is not None}
    tm = CubeRegressor(features=W.FEATURES, dtype=torch.float32)
    tm.load_state_dict(from_flax(_cube_params()))
    state = make_train_state(tm, device="cpu")
    got = S.state_shardings(state, mesh=_fake_mesh(shape), layout=layout)
    moments = [k for k in got if ".mu[" in k or ".nu[" in k]
    assert len(moments) == 2 * len([k for k in got if ".params[" in k])
    for path, sh in got.items():
        if path in want_specs:
            assert _spec(sh.spec) == want_specs[path], path
    axis = "fsdp" if "fsdp" in shape else "tp"
    assert any(axis in S._entry_axes(e) for k in moments
               for e in got[k].spec)


def test_validate_batch_sharding_gate():
    mesh = _fake_mesh({"data": 4, "tp": 2})
    ok = S.batch_sharding(mesh)
    assert S.validate_batch_sharding(ok) is ok
    assert S.validate_batch_sharding(S.Sharding(mesh, (None, "seq"))) is not None
    for spec, axis in (((("tp",),), "tp"), ((None, "tp"), "tp"),
                       ((("fsdp",),), "fsdp")):
        with pytest.raises(ValueError, match=axis):
            S.validate_batch_sharding(S.Sharding(mesh, spec))
    fold = S.batch_sharding(_fake_mesh({"data": 2, "fsdp": 4}))
    assert fold.spec == (("data", "fsdp"),)
    assert S.leading_shard_count(fold) == 8
    assert S.leading_shard_count(S.batch_sharding(mesh)) == 4
    assert S.replicated(mesh).spec == () and S.leading_shard_count(None) == 1


def test_shard_params_places_dtensor_shards(ranks):
    """The generic rules on an fsdp x tp mesh: a (256, 128) kernel's last
    dim over tp and its largest free dim over fsdp, as DTensor Shard
    placements whose shards gather back to the tensor; a bias
    replicated."""
    for per in _result(ranks, 4, "shard_params"):
        kernel, bias = per["dense/kernel"], per["b"]
        assert kernel["local"] == (128, 64) and kernel["equal"]
        assert kernel["placements"] == ["Shard(dim=0)", "Shard(dim=1)"]
        assert bias["local"] == (7,) and bias["equal"]
        assert bias["placements"] == ["Replicate()", "Replicate()"]


# -- collectives ------------------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["sum", "mean", "gather", "permute"])
def test_collectives_and_their_gradients(ranks, world, name):
    from blendjax.parallel import (
        all_gather,
        all_reduce_mean,
        all_reduce_sum,
        ring_permute,
    )

    mesh = _jmesh({"data": world}, world)
    x = jnp.asarray(np.arange(2 * world * 3, dtype=np.float32)
                    .reshape(2 * world, 3))
    w3 = jnp.asarray(np.random.default_rng(0).random((2, 3)), jnp.float32)
    wn = jnp.asarray(np.random.default_rng(1).random((2 * world, 3)),
                     jnp.float32)
    fn, w = {
        "sum": (lambda x: all_reduce_sum(x, mesh), w3),
        "mean": (lambda x: all_reduce_mean(x, mesh), w3),
        "gather": (lambda x: all_gather(x, mesh), wn),
        "permute": (lambda x: ring_permute(x, mesh, axis="data"), wn),
    }[name]
    y = np.asarray(fn(x))
    g = np.asarray(jax.grad(lambda x: (fn(x) * w).sum())(x))
    got = _result(ranks, world, "collectives")
    for r, per in enumerate(got):
        gy, gg = per[name]
        want_y = y[2 * r:2 * r + 2] if name == "permute" else y
        np.testing.assert_allclose(gy, want_y, rtol=1e-6)
        np.testing.assert_allclose(gg, g[2 * r:2 * r + 2], rtol=1e-6)


# -- ring and Ulysses attention ---------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind,causal", ATTN_CASES)
def test_sequence_parallel_attention_matches_the_reference(ranks, world,
                                                           kind, causal):
    """Forward and gradients of ring / Ulysses attention on data x seq,
    each rank's blocks placed back into the global arrays, against the
    JAX package's on a mesh of the same shape."""
    from blendjax.parallel import ring_attention, ulysses_attention

    mesh = _jmesh({"data": world // 2, "seq": 2}, world)
    q, k, v, g = (jnp.asarray(a) for a in W.attention_inputs())
    spec = NamedSharding(mesh, P("data", "seq"))
    qs, ks, vs = (jax.device_put(a, spec) for a in (q, k, v))
    fn = ring_attention if kind == "ring" else ulysses_attention
    kw = {} if kind == "ring" else {"backend": "xla"}

    def f(q, k, v):
        o = fn(q, k, v, mesh, axis="seq", causal=causal, **kw)
        return (o * g).sum(), o

    (_, o), grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True))(qs, ks, vs)
    want = {"o": np.asarray(o), "dq": np.asarray(grads[0]),
            "dk": np.asarray(grads[1]), "dv": np.asarray(grads[2])}
    got = {key: np.zeros_like(val) for key, val in want.items()}
    for per in _result(ranks, world, f"attention:{kind}:{causal}"):
        di, si, bl, tl = per["where"]
        for key in got:
            got[key][di * bl:(di + 1) * bl, si * tl:(si + 1) * tl] = per[key]
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=ATTN_ATOL,
                                   err_msg=key)


@pytest.mark.parametrize("world", WORLDS)
def test_ulysses_head_divisibility_guard(ranks, world):
    assert "divisible" in _result(ranks, world, "ulysses_heads", 0)


def test_streamformer_ulysses_grad_step_matches_the_reference(ranks):
    """A Ulysses StreamFormer on data 2 x seq 2 (weights from
    streamformer_from_flax): loss and every gradient as the JAX
    package's on the same mesh shape."""
    images, params = _former_inputs()
    mesh = _jmesh({"data": 2, "seq": 2}, 4)
    model = _former(mesh)
    x = jax.device_put(jnp.asarray(images), JS.batch_sharding(mesh))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jnp.mean(model.apply({"params": p}, x) ** 2)))(params)
    want = {k: v.numpy() for k, v in streamformer_from_flax(
        jax.tree.map(np.asarray, grads)).items()}
    for per in _result(ranks, 4, "former_grad"):
        assert per["loss"] == pytest.approx(float(loss), rel=1e-5)
        assert set(per["grads"]) == set(want)
        for k, g in per["grads"].items():
            np.testing.assert_allclose(g, want[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)


def test_ring_attention_bf16_losses_within_the_bf16_bar(ranks):
    """A bf16 StreamFormer trains through ring attention on a 2-way seq
    axis with the per-update losses of local attention, within
    BF16_LOSS_REL (the bar the chip's ring leg is held to)."""
    for per in _result(ranks, 2, "ring_bf16"):
        ring, local = np.asarray(per["ring"]), np.asarray(per["local"])
        assert np.all(np.isfinite(ring)) and ring.shape == (3,)
        np.testing.assert_allclose(ring, local, rtol=BF16_LOSS_REL)


# -- the sharded decode ------------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_decode_is_bit_exact(ranks, world):
    """Each rank's rows of decode_tile_delta(mesh=) and of
    decode_packed_superbatch(mesh=) equal those rows of the JAX package's
    sharded decode, bit for bit; a batch the axis does not divide
    raises."""
    from blendjax.ops import tiles as JT

    msgs = W.tile_messages(2, batch=8)
    mesh = _jmesh({"data": world}, world)
    ref = jnp.asarray(msgs[0]["image" + JT.TILEREF_SUFFIX])
    ref_tiles = JT.tile_ref(ref, (16, 32))
    idx = jnp.asarray(msgs[1]["image" + JT.TILEIDX_SUFFIX])
    tiles = jnp.asarray(msgs[1]["image" + JT.TILES_SUFFIX])
    want = np.asarray(JT.decode_tile_delta(
        ref_tiles, idx, tiles, (W.HW, W.HW, 4), mesh=mesh, data_axis="data"))
    xy = msgs[1]["xy"]
    for per in _result(ranks, world, "decode"):
        rows = slice(per["rank"] * 8 // world, (per["rank"] + 1) * 8 // world)
        np.testing.assert_array_equal(per["one"], want[rows])
        for kk in range(2):
            np.testing.assert_array_equal(per["image"][kk], want[rows])
            np.testing.assert_array_equal(per["xy"][kk], xy[rows])
        assert "divide evenly" in per["odd"]


# -- the collective ledger ---------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_collective_bytes_match_the_layout(ranks, world):
    """One mesh supervised step all-reduces the f32 gradients (every
    parameter once) and the loss over ``data``; one Ulysses call moves q,
    k, v and o once each through an all-to-all over ``seq``. Nothing else."""
    for per in _result(ranks, world, "collective_bytes"):
        step, uly = per["step"], per["ulysses"]
        grad_bytes = per["param_numel"] * 4
        assert step["per_kind"]["all-reduce"] == grad_bytes + 4
        assert step["total_bytes"] == grad_bytes + 4 and step["ops"] == 2
        assert step["per_axis"] == {"data": grad_bytes + 4}
        assert uly["per_kind"]["all-to-all"] == 4 * 2 * 8 * 4 * 8 * 4
        assert uly["ops"] == 4 and uly["per_axis"] == {
            "seq": uly["total_bytes"]}


@pytest.mark.parametrize("world", WORLDS)
def test_fleet_snapshots_gather_every_rank(ranks, world):
    per = _result(ranks, world, "fleet")
    for r in per:
        assert r["processes"] == list(range(world))
        assert r["counts"] == [world] * world
        rep = r["report"]
        assert rep["processes"] == world
        assert set(rep["verdicts"]) == {f"p{i}" for i in range(world)}
