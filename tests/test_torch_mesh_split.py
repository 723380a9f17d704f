"""How the port's mesh path splits the work, against the JAX package (CPU).

The port runs worlds 2 and 4 on gloo, at once (rank bodies in
``torch_dist_ranks.py``), while this process runs the JAX package on its
virtual CPU devices. ``blendjax_torch/docs/mesh-split.md`` lists the
collectives of the JAX package's compiled steps that these tests read the
port's tally against.

- tp: a StreamFormer on ``{"data": 2, "tp": 2}`` and ``{"data": 1, "tp":
  4}`` trains the JAX package's losses on the same mesh within
  ``CROSS_LAYOUT_ATOL`` (``tests/test_mesh_driver.py``'s 5e-5); each rank
  holds its block of every split kernel, gathers none, and issues exactly
  the all-gathers, all-to-alls and sums the note lists. One ``Block`` with
  its kernels split over tp=2 holds the JAX ``Block``'s output and input
  gradient within 1e-5 (f32; the rows of a row-split product summed in
  another order).
- echo: a ring sharded over worlds 2 and 4 gives each rank its rows of
  the one-card draw of the same counter, bit for bit, with the apply run
  on those rows alone; stamped batches are accounted as on one card and
  in the JAX package.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_ranks as W
from blendjax.data import StreamDataPipeline as JaxPipeline
from blendjax.models import StreamFormer as JaxFormer
from blendjax.parallel import create_mesh as jax_create_mesh
from blendjax.train import MeshTrainDriver as JaxMeshDriver

CROSS_LAYOUT_ATOL = 5e-5
BLOCK_ATOL = 1e-5

MESHES = {"data2xtp2": (("data", 2), ("tp", 2)),
          "tp4": (("data", 1), ("tp", 4)),
          "data2xtp1": (("data", 2), ("tp", 1))}
# the world each mesh runs in (a tp axis of size 1 splits over one rank)
WORLD = {"data2xtp2": 4, "tp4": 4, "data2xtp1": 2}


@functools.lru_cache(maxsize=None)
def _former_params():
    """Seeded StreamFormer parameters in the flax tree's shapes."""
    jm = JaxFormer(**W.FORMER_TP, dtype=jnp.float32, attn_backend="xla")
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
def _jax_tp_losses(axes: tuple):
    mesh = jax_create_mesh(dict(axes), devices=jax.devices()[
        :int(np.prod([s for _, s in axes]))])
    drv = JaxMeshDriver.build(
        JaxFormer(**W.FORMER_TP, dtype=jnp.float32, attn_backend="xla"),
        mesh, np.zeros((8, 32, 32, 4), np.uint8), loss_fn=_jax_loss,
        sync_every=1, inflight=1)
    params = jax.tree.map(lambda a, v: jax.device_put(jnp.asarray(v),
                                                      a.sharding),
                          drv.state.params, _former_params())
    drv.state = drv.state.replace(params=params,
                                  opt_state=drv.state.tx.init(params))
    with JaxPipeline(iter(W.former_messages()), batch_size=8,
                     mesh=mesh) as pipe:
        for sb in pipe:
            drv.submit(sb)
    drv.finish()
    return np.asarray(drv.losses)


def _block_inputs():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 16, 32)).astype(np.float32)
    g = rng.normal(size=(2, 16, 32)).astype(np.float32)
    return x, g


@functools.lru_cache(maxsize=None)
def _jax_block():
    """The JAX ``Block``'s parameters, output and input gradient of
    ``sum(out * g)``."""
    from blendjax.models.transformer import Block as JaxBlock

    x, g = _block_inputs()
    blk = JaxBlock(num_heads=4, dtype=jnp.float32, attn_backend="xla")
    shapes = jax.eval_shape(lambda: blk.init(jax.random.key(0),
                                             jnp.asarray(x)))
    rng = np.random.default_rng(9)
    params = jax.tree.map(lambda s: (rng.normal(size=s.shape) * 0.2)
                          .astype(np.float32), shapes["params"])

    def f(xv):
        return blk.apply({"params": params}, xv)

    out, vjp = jax.vjp(f, jnp.asarray(x))
    return params, np.asarray(out), np.asarray(vjp(jnp.asarray(g))[0])


def _cases(world):
    tp = [(f"tp:{name}", {"params_np": _former_params(), "axes": dict(axes)})
          for name, axes in MESHES.items() if WORLD[name] == world]
    if world == 2:
        x, g = _block_inputs()
        return [("tp_block", {"params_np": _jax_block()[0], "x": x, "g": g,
                              "axes": {"tp": 2}}),
                ("tp:heads", {"params_np": None, "axes": {"data": 1, "tp": 2},
                              "cfg": {**W.FORMER_TP, "num_heads": 3,
                                      "dim": 24}}),
                ("echo_rows", {}), ("echo_stamps", {}),
                ("echo_stamp_gathers", {})] + tp
    return tp + [
        ("echo_rows", {}), ("echo_stamps", {}), ("echo_stamp_gathers", {})]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both worlds' ranks, while this process computes the JAX side."""
    import threading

    cases = {w: _cases(w) for w in (2, 4)}
    out: dict = {}

    def run():
        try:
            out["ranks"] = W.run_worlds(
                cases, str(tmp_path_factory.mktemp("ranks")))
        except BaseException as e:  # raised below, in the test
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    for axes in MESHES.values():
        _jax_tp_losses(axes)
    _jax_block()
    _jax_stamps()
    t.join(200.0)
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


# -- tensor parallelism -----------------------------------------------------------------


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tp_losses_match_the_jax_package_on_the_same_mesh(ranks, mesh):
    want = _jax_tp_losses(MESHES[mesh])
    for per in _result(ranks, WORLD[mesh], f"tp:{mesh}"):
        assert per["losses"].shape == want.shape == (4,)
        np.testing.assert_allclose(per["losses"], want, rtol=0,
                                   atol=CROSS_LAYOUT_ATOL)


SPLIT = {  # parameter -> the torch dim tp splits (the rules' and generic)
    "patch_embed.weight": 0, "pos_embed": 2, "head.weight": 0,
    "blocks.{i}.attn.qkv.weight": 0, "blocks.{i}.attn.qkv.bias": 0,
    "blocks.{i}.attn.proj.weight": 1, "blocks.{i}.fc1.weight": 0,
    "blocks.{i}.fc2.weight": 1,
}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_each_tp_rank_holds_its_block_of_every_split_kernel(ranks, mesh):
    """Every split kernel is 1/tp of its full size on its rank through the
    steps (no parameter gathered), the replicated leaves are whole, and a
    rank holds less state than the replicated whole (all of it at tp=1)."""
    tp = dict(MESHES[mesh])["tp"]
    names = {n.format(i=i): d for n, d in SPLIT.items()
             for i in range(W.FORMER_TP["depth"])}
    for per in _result(ranks, WORLD[mesh], f"tp:{mesh}"):
        assert per["gathers"] == 0
        for name, full in per["full"].items():
            local = per["local"][name]
            if name in names:
                want = list(full)
                want[names[name]] //= tp
                assert local == tuple(want), name
            else:
                assert local == full, name
        full_bytes = 4 * sum(int(np.prod(s)) for s in per["full"].values())
        if tp == 1:
            # parameters, 2 moments and a step count each
            assert per["resident"] == 3 * full_bytes + 4 * len(per["full"])
        else:
            assert per["resident"] < 3 * full_bytes


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tp_collectives_are_the_notes_and_gather_no_kernel(ranks, mesh):
    """The first step call's tally, byte for byte: over tp the patch
    embedding's and the head's outputs all-gathered, the sliced biases'
    gradients all-gathered (fc1's, the patch embedding's, the head's),
    the qkv bias moved onto the heads and back by all-to-all, the
    row-split products (proj, fc2) summed forward and the column-split
    inputs (qkv, fc1, head) summed backward; over data one all-reduce of
    the local gradients and the loss. No kernel is all-gathered. At tp=1
    the same collectives run, each over one rank."""
    sizes = dict(MESHES[mesh])
    tp, depth = sizes["tp"], W.FORMER_TP["depth"]
    c, out = W.FORMER_TP["dim"], W.FORMER_TP["num_outputs"]
    h = W.FORMER_TP["num_heads"]
    tokens = 16
    for per in _result(ranks, WORLD[mesh], f"tp:{mesh}"):
        b = per["lead"]
        act = b * tokens * c * 4  # one (B, T, C) f32 activation
        gathers = act + b * out * 4 + (depth * 4 * c + c + out) * 4
        a2a = depth * 2 * 3 * (h // tp) * (c // h) * 4
        sums = depth * 4 * act + b * c * 4
        local = sum(int(np.prod(s)) for s in per["local"].values())
        kinds, axes = per["tally"]["per_kind"], per["tally"]["per_axis"]
        assert kinds["all-gather"] == gathers
        assert kinds["all-to-all"] == a2a
        assert kinds["reduce-scatter"] == kinds["collective-permute"] == 0
        assert axes["tp"] == gathers + a2a + sums
        assert axes["data"] == (local + 1) * 4


def test_a_tp_split_block_matches_the_jax_block(ranks):
    """One ``Block`` with qkv column-split by heads, proj row-split, fc1
    column-split and fc2 row-split over tp=2: every rank's output and the
    input gradient are the JAX ``Block``'s on the same parameters."""
    _params, out, dx = _jax_block()
    for per in _result(ranks, 2, "tp_block"):
        assert per["qkv_local"] == (3 * 32 // 2, 32)
        np.testing.assert_allclose(per["out"], out, rtol=0, atol=BLOCK_ATOL)
        np.testing.assert_allclose(per["dx"], dx, rtol=0, atol=BLOCK_ATOL)


def test_tp_refuses_a_head_count_it_does_not_divide(ranks):
    for per in _result(ranks, 2, "tp:heads"):
        assert per["refused"] is not None
        assert "3 attention heads" in per["refused"]


# -- the sharded echo ring ----------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_draw_rows_are_the_one_card_draws(ranks, world):
    for per in _result(ranks, world, "echo_rows"):
        assert per["row_local"]
        assert per["equal"] and all(per["equal"])


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_draw_applies_the_augmentation_to_its_rows_only(ranks,
                                                                world):
    for per in _result(ranks, world, "echo_rows"):
        assert per["applied"] == [W.B // world] * len(per["equal"])


@functools.lru_cache(maxsize=None)
def _jax_stamps():
    """The JAX package's one-card run of the same stamped stream."""
    import time

    import blendjax.data.echo as mod
    from blendjax.scenario import ScenarioAccounting

    led = ScenarioAccounting()
    orig, mod.scenario_accounting = mod.scenario_accounting, led
    batches = W._stamped()
    ref = [None]

    def paced():
        for i, b in enumerate(batches):
            if i:
                deadline = time.monotonic() + 60.0
                while ref[0].saturated_waits < i:
                    assert time.monotonic() < deadline
                    time.sleep(0.002)
            yield b

    try:
        pipe = mod.EchoingPipeline(paced(), augment=None, batch_size=8,
                                   rng=3, capacity=32, max_echo_factor=4)
        ref[0] = pipe
        rows = []
        with pipe:
            for b in pipe:
                rows.append(b.get("_scenario_rows"))
    finally:
        mod.scenario_accounting = orig
    return {"rows": rows, "totals": led.totals(),
            "counts": (pipe.fresh, pipe.echoed, pipe.steps),
            "slots": list(pipe._slot_scen)}


@pytest.mark.parametrize("world", [2, 4])
def test_stamped_batches_on_a_sharded_ring_are_accounted_as_one_card(
        ranks, world):
    """Each rank's per-draw stamps, per-scenario fresh and echoed totals,
    counts and per-slot stamps equal the one-card run's and the JAX
    package's."""
    want = _jax_stamps()
    for per in _result(ranks, world, "echo_stamps"):
        got, one = per["mesh"], per["one"]
        assert got == one
        assert got["totals"] == want["totals"]
        assert got["counts"] == want["counts"]
        assert got["rows"] == want["rows"]
        assert got["slots"] == want["slots"]
        fresh, echoed, steps = got["counts"]
        assert sum(f + e for f, e in got["totals"].values()) == steps * 8
        assert set(got["totals"]) == {"even", "odd"}


@pytest.mark.parametrize("world", [2, 4])
def test_a_sharded_ring_gathers_stamps_only_for_stamped_inserts(ranks,
                                                                world):
    """Of 8 inserts, 2 stamped in every row and 2 in their first half of
    rows (on some ranks only) are all-gathered, the 4 unstamped are not,
    and the draws, ledger and slots are the one-card run's."""
    for per in _result(ranks, world, "echo_stamp_gathers"):
        assert per["mesh"] == per["one"]
        assert per["gathers"] == 4
        assert set(per["one"]["totals"]) == {"all", "half"}
        fresh, echoed, steps = per["one"]["counts"]
        assert fresh == 8 * 8  # every batch inserted and drawn


# -- row-local augmentation (one process) ---------------------------------------------------


@pytest.mark.parametrize("ways", [2, 4])
def test_row_local_augment_is_the_whole_draws_rows(ways):
    """Every standard op drawn for the whole draw and applied to a slice
    of its rows gives that slice of the whole draw's result, bit for bit
    (uint8 images, pixel points)."""
    import functools as ft

    import torch

    from blendjax_torch.ops import augment as A

    aug = A.make_batch_augment(
        A.random_flip_with_points, ft.partial(A.random_crop_with_points,
                                              pad=3),
        A.color_jitter, ft.partial(A.random_cutout, size=6),
        image_key="image", points_key="xy")
    rng = np.random.default_rng(ways)
    batch = {"image": torch.from_numpy(rng.integers(0, 256, (8, 20, 24, 4),
                                                    dtype=np.uint8)),
             "xy": torch.from_numpy((rng.random((8, 8, 2)) * 20)
                                    .astype(np.float32))}
    whole = aug(5, batch)
    n = 8 // ways
    for r in range(ways):
        part = aug(5, {k: v[r * n:(r + 1) * n] for k, v in batch.items()},
                   rows=(r * n, 8))
        for k in ("image", "xy"):
            assert torch.equal(part[k], whole[k][r * n:(r + 1) * n]), k
