"""The echo slice: augment ops, the device ring, the reservoir, the echo
pipeline and the echo-fused step of blendjax_torch against the JAX package.

JAX's threefry keys cannot be reproduced in torch, so each augment op's
apply is held against the JAX op given the JAX op's own draws (uint8
results exact, float results to atol 1e-6). Ring and reservoir contents
match exactly. One echo-fused update matches the JAX one from the same
weights, ring contents and indices (augment None, f32, TF32 off) to
rtol 1e-4, the bar of the fused-step parity test. The echo accounting is
checked from recorded sources on the CPU (no producers, no timing).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blendjax.data import ring as JR
from blendjax.ops import augment as JA
from blendjax.ops import image as JI
from blendjax_torch.data import ring as R
from blendjax_torch.ops import augment as A

B, H, W = 4, 16, 32


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """At most two torch threads: the suite runs six workers on eight
    cores beside timing-sensitive tests of the JAX package."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _images(seed=0, dtype=np.uint8, b=B):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (b, H, W, 4), dtype=np.uint8)
    return x if dtype == np.uint8 else (x / 255.0).astype(np.float32)


def _points(seed=1, b=B):
    rng = np.random.default_rng(seed)
    return (rng.random((b, 8, 2)) * [W, H]).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# -- augment: apply against the JAX op given its draws ------------------------


def _jax_crop_offsets(key, b, pad):
    keys = jax.random.split(key, b)
    return np.asarray(jax.vmap(
        lambda k: jnp.stack(JA._crop_offsets(k, pad)))(keys))


@pytest.mark.parametrize("pad", [2, 4])
def test_crop_apply_matches_jax(pad):
    key = jax.random.key(5)
    x = _images()
    want = np.asarray(JA.random_crop(key, jnp.asarray(x), pad=pad))
    offsets = _jax_crop_offsets(key, B, pad)
    got = A.apply_crop(_t(x), _t(offsets), pad)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len({tuple(o) for o in offsets}) > 1


@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["u8", "f32"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_color_jitter_apply_matches_jax(dtype, seed):
    key = jax.random.key(seed)
    x = _images(seed, dtype)
    want = np.asarray(JA.color_jitter(key, jnp.asarray(x)))
    kb, kc = jax.random.split(key)
    shape = (B, 1, 1, 1)
    bright = jax.random.uniform(kb, shape, minval=-0.2, maxval=0.2)
    contr = 1.0 + jax.random.uniform(kc, shape, minval=-0.2, maxval=0.2)
    got = A.apply_color_jitter(_t(x), _t(bright).reshape(B),
                               _t(contr).reshape(B))
    assert got.dtype == torch.from_numpy(x).dtype
    if dtype == np.uint8:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("size", [6, 16])
def test_cutout_apply_matches_jax(size):
    key = jax.random.key(7)
    x = _images(3)
    want = np.asarray(JA.random_cutout(key, jnp.asarray(x), size=size, fill=9))
    keys = jax.random.split(key, B)
    cy = jax.vmap(lambda k: jax.random.randint(k, (), 0, H))(keys)
    cx = jax.vmap(lambda k: jax.random.randint(
        jax.random.fold_in(k, 1), (), 0, W))(keys)
    centres = np.stack([np.asarray(cy), np.asarray(cx)], axis=-1)
    got = A.apply_cutout(_t(x), _t(centres), size=size, fill=9)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("axis", [1, 2])
def test_flip_with_points_apply_matches_jax(axis):
    key = jax.random.key(11)
    x, p = _images(4), _points()
    wi, wp = JA.random_flip_with_points(key, jnp.asarray(x), jnp.asarray(p),
                                        axis=axis)
    bits = np.asarray(JI._flip_bits(key, B))
    gi, gp = A.apply_flip_with_points(_t(x), _t(p), _t(bits), axis)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    assert 0 < bits.sum() < B


def test_crop_with_points_apply_matches_jax():
    key = jax.random.key(13)
    x, p = _images(5), _points(2)
    wi, wp = JA.random_crop_with_points(key, jnp.asarray(x), jnp.asarray(p),
                                        pad=3)
    offsets = _jax_crop_offsets(key, B, 3)
    gi = A.apply_crop(_t(x), _t(offsets), 3)
    gp = A.shift_points(_t(p), _t(offsets), 3)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))


def test_draws_fall_in_their_ranges():
    gen = torch.Generator().manual_seed(0)
    off = A.crop_offsets(gen, 512, 4)
    assert off.shape == (512, 2) and off.min() == 0 and off.max() == 8
    bright, contr = A.jitter_factors(gen, 512, 0.2, 0.3)
    assert bright.abs().max() <= 0.2 and (contr - 1).abs().max() <= 0.3
    c = A.cutout_centres(gen, 512, H, W)
    assert c[:, 0].max() == H - 1 and c[:, 1].max() == W - 1 and c.min() == 0


def test_batch_augment_folds_the_seed_per_op():
    ops = (A.random_flip_with_points,
           functools.partial(A.random_crop_with_points, pad=2),
           A.color_jitter)
    aug = A.make_batch_augment(*ops, points_key="xy")
    x, p = _t(_images(6)), _t(_points(3))
    out = aug(123, {"image": x, "xy": p, "frameid": torch.arange(B)})
    img, pts = x, p
    for i, op in enumerate(ops):
        gen = A.seeded_generator(A.fold_seed(123, i), "cpu")
        if i < 2:
            img, pts = op(gen, img, pts)
        else:
            img = op(gen, img)
    assert torch.equal(out["image"], img) and torch.equal(out["xy"], pts)
    assert torch.equal(out["frameid"], torch.arange(B))
    again = aug(123, {"image": x, "xy": p})
    assert torch.equal(again["image"], out["image"])
    other = aug(124, {"image": x, "xy": p})
    assert not torch.equal(other["image"], out["image"])
    assert aug(1, {"xy": p}) == {"xy": p}
    with pytest.raises(ValueError, match="points_key"):
        A.make_batch_augment(A.random_flip_with_points)
    with pytest.raises(KeyError, match="xy"):
        aug(1, {"image": x})
    composed = A.make_augment(A.random_flip, A.color_jitter)(9, x)
    assert composed.shape == x.shape and composed.dtype == torch.uint8


def test_fold_seed_mixes_and_stays_in_range():
    seen = {A.fold_seed(0, c) for c in range(1000)}
    assert len(seen) == 1000
    assert all(0 <= s < 2 ** 63 for s in seen)
    assert A.fold_seed(7, 1, 2) != A.fold_seed(7, 2, 1)


# -- ring -------------------------------------------------------------------


def _ring_batch(seed, b=3):
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 256, (b, 4, 8, 4), dtype=np.uint8),
            "xy": rng.random((b, 8, 2)).astype(np.float32)}


def test_ring_insert_and_gather_match_jax():
    cap = 5
    first = _ring_batch(0)
    assert R.ring_spec({k: _t(v) for k, v in first.items()}) == JR.ring_spec(first)
    jbufs = JR.allocate_ring(cap, fields=first)
    jins = JR.make_ring_insert(cap)
    tbufs = R.allocate_ring(cap, {k: _t(v) for k, v in first.items()})
    ptrs = {k: v.data_ptr() for k, v in tbufs.items()}
    ins = R.make_ring_insert(cap)
    cursor = 0
    for seed in range(4):  # 12 rows through 5 slots: wraps twice
        batch = _ring_batch(seed)
        jbufs = jins(jbufs, batch, np.int32(cursor))
        assert ins(tbufs, {k: _t(v) for k, v in batch.items()}, cursor) is tbufs
        cursor = (cursor + 3) % cap
        for k in tbufs:
            np.testing.assert_array_equal(tbufs[k].numpy(), np.asarray(jbufs[k]))
    assert {k: v.data_ptr() for k, v in tbufs.items()} == ptrs
    idx = np.array([4, 0, 0, 2], np.int32)
    want = JR.ring_gather(jbufs, idx)
    got = R.ring_gather(tbufs, idx)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    got["image"].zero_()  # a gather is a copy
    assert tbufs["image"].sum() > 0


def test_ring_refuses_a_sharding_and_overfull_batches():
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 5"):
        R.allocate_ring(4, {"x": torch.zeros(1)}, sharding=object())
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        R.make_ring_insert(4, sharding=object())
    bufs = R.allocate_ring(2, {"x": torch.zeros(1, 3)})
    with pytest.raises(ValueError, match="do not fit"):
        R.ring_slot_update(2, bufs, {"x": torch.zeros(3, 3)}, 0)
    restored = R.allocate_ring(2, initial={"x": np.ones((2, 3), np.float32)})
    assert restored["x"].sum() == 6


# -- reservoir ----------------------------------------------------------------


def test_reservoir_matches_jax_reservoir():
    from blendjax.data.echo import SampleReservoir as JaxReservoir
    from blendjax_torch.data import SampleReservoir

    jres = JaxReservoir(6, augment=None)
    tres = SampleReservoir(6, augment=None, device="cpu")
    for seed, b in ((0, 4), (1, 4), (2, 9)):  # the last batch overfills
        batch = _ring_batch(seed, b)
        np.testing.assert_array_equal(tres.insert(batch), jres.insert(batch))
        assert (tres.size, tres.inserts) == (jres.size, jres.inserts)
    idx = np.array([5, 1, 1, 3])
    want, got = jres.sample(idx), tres.sample(idx)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert tres.fields == ("image", "xy") and tres._draws == 1
    with pytest.raises(ValueError, match="fields"):
        tres.insert({"image": _ring_batch(3)["image"]})
    with pytest.raises(ValueError, match="reservoir holds"):
        tres.insert({"image": np.zeros((1, 4, 8, 3), np.uint8),
                     "xy": np.zeros((1, 8, 2), np.float32)})


def test_eager_and_fused_draws_give_the_same_augmentation():
    from blendjax_torch.data import SampleReservoir, default_echo_augment

    def make():
        res = SampleReservoir(8, augment=default_echo_augment(points_key="xy"),
                              rng=42, device="cpu")
        res.insert({"image": _images(8, b=8), "xy": _points(4, b=8)})
        return res

    eager, fused = make(), make()
    idx = np.array([7, 3, 3, 0])
    for _ in range(3):  # counters 0, 1, 2 on both sides
        a = eager.sample(idx)
        tok = fused.draw_token(idx)
        b = fused.draw(tok["_echo_buffers"], tok["_echo_idx"],
                       tok["_echo_counter"])
        assert torch.equal(a["image"], b["image"])
        assert torch.equal(a["xy"], b["xy"])
    again = eager.sample(idx)  # counter 3: a new augmentation
    assert not torch.equal(again["image"], a["image"])
    raw = eager.gather(idx)
    assert not torch.equal(raw["image"], a["image"])  # augmented
    assert eager._draws == 4


def test_a_token_held_across_an_insert_is_refused():
    from blendjax_torch.data import SampleReservoir

    res = SampleReservoir(4, augment=None, device="cpu")
    res.insert(_ring_batch(0, 4))
    ptrs = res.data_ptrs()
    tok = res.draw_token([0, 1])
    before = res.draw(tok["_echo_buffers"], tok["_echo_idx"],
                      tok["_echo_counter"])
    res.insert(_ring_batch(1, 2))  # overwrites slots 0 and 1
    assert res.data_ptrs() == ptrs
    with pytest.raises(RuntimeError, match="outlived an insert"):
        res.draw(tok["_echo_buffers"], tok["_echo_idx"], tok["_echo_counter"])
    # what the step gathered before the insert is unchanged by it
    np.testing.assert_array_equal(before["image"].numpy(),
                                  _ring_batch(0, 4)["image"][:2])


# -- the echo-fused step against the JAX one --------------------------------


def test_echo_fused_update_matches_jax():
    from blendjax.data.echo import SampleReservoir as JaxReservoir
    from blendjax.models import CubeRegressor as JaxCube
    from blendjax.train import make_echo_fused_step as jax_echo_step
    from blendjax.train import make_train_state as jax_state
    from blendjax_torch.data import SampleReservoir
    from blendjax_torch.models import CubeRegressor
    from blendjax_torch.train import make_echo_fused_step, make_train_state
    from blendjax_torch.weights import from_flax

    shape = (16, 32, 4)
    features = (4, 8)
    jm = JaxCube(features=features, dtype=jnp.float32)
    jstate = jax_state(jm, jnp.zeros((1, *shape), jnp.uint8))
    tm = CubeRegressor(features=features, dtype=torch.float32)
    tm.load_state_dict(from_flax(jax.tree.map(np.asarray, jstate.params)))
    state = make_train_state(tm, device="cpu")

    rng = np.random.default_rng(9)
    ring = {"image": rng.integers(0, 256, (8, *shape), dtype=np.uint8),
            "xy": (rng.random((8, 8, 2)) * [32, 16]).astype(np.float32)}
    jres, tres = JaxReservoir(8, augment=None), SampleReservoir(
        8, augment=None, device="cpu")
    jres.insert(ring)
    tres.insert(ring)
    jstep = jax_echo_step(jres.draw, precision="f32", donate=False)
    tstep = make_echo_fused_step(tres.draw)
    want, got = [], []
    for idx in ([0, 5, 5, 2], [7, 1, 3, 3]):
        jstate, jm_ = jstep(jstate, jres.draw_token(np.array(idx)))
        want.append(float(jm_["loss"]))
        state, m = tstep(state, tres.draw_token(np.array(idx)))
        got.append(float(m["loss"]))
    assert state.step == 2
    # the second loss is taken after one AdamW update on each side
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(
        tm.head.weight.detach().numpy(),
        np.asarray(jstate.params["Dense_1"]["kernel"]).T, rtol=1e-4, atol=1e-6)


def test_echo_step_takes_a_fresh_batch_through_the_supervised_step():
    from blendjax_torch.models import CubeRegressor
    from blendjax_torch.train import (
        make_echo_fused_step,
        make_supervised_step,
        make_train_state,
    )

    def draw(*a):
        raise AssertionError("a fresh batch must not reach the reservoir")

    batch = {"image": _t(_images(2)), "xy": _t(_points(5)), "_meta": {}}
    a = make_train_state(CubeRegressor(features=(4,), dtype=torch.float32)
                         .init_params(0), device="cpu")
    b = make_train_state(CubeRegressor(features=(4,), dtype=torch.float32)
                         .init_params(0), device="cpu")
    _, m1 = make_echo_fused_step(draw)(a, batch)
    _, m2 = make_supervised_step()(b, {"image": batch["image"],
                                       "xy": batch["xy"]})
    assert torch.equal(m1["loss"], m2["loss"])


# -- the echo pipeline: exact accounting from recorded sources ---------------


def _recorded_batches(n, b=B, seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": rng.integers(0, 256, (b, H, W, 4), dtype=np.uint8),
             "xy": rng.random((b, 8, 2)).astype(np.float32),
             "frameid": np.arange(i * b, (i + 1) * b)} for i in range(n)]


@pytest.mark.parametrize("factor,min_fresh", [(1, 0.0), (3, 0.0), (3, 0.5),
                                              (8, 0.25)])
def test_echo_accounting_is_exact(factor, min_fresh):
    from blendjax_torch.data import EchoingPipeline

    source = _recorded_batches(10)
    echo = EchoingPipeline(iter(source), capacity=12, max_echo_factor=factor,
                           min_fresh_fraction=min_fresh, batch_size=B,
                           augment=None, device="cpu", rng=3)
    drawn = {}
    with echo:
        for batch in echo:
            assert batch["image"].shape == (B, H, W, 4)
            for fid in batch["frameid"].tolist():
                drawn[fid] = drawn.get(fid, 0) + 1
    s = echo.stats
    assert s["fresh"] + s["echoed"] == s["steps"] * B
    assert s["inserted"] == 10 * B
    assert max(drawn.values()) <= factor and s["max_uses"] <= factor
    assert s["max_uses"] == max(drawn.values())
    if factor == 1:
        assert s["echoed"] == 0 and s["fresh"] == len(drawn)
    else:
        assert s["echoed"] > 0
    assert s["fresh"] == len(drawn)  # first uses are exactly the fresh draws


def test_echo_pipeline_trains_end_to_end_from_recorded_messages():
    """Recorded tile messages -> StreamDataPipeline(decoded form) ->
    EchoingPipeline(emit_draws) -> make_echo_fused_step -> TrainDriver:
    decoded frames equal the rendered ones, the accounting is exact, the
    ring never moves and every step is one call."""
    from blendjax_torch.data import EchoingPipeline, StreamDataPipeline
    from blendjax_torch.models import CubeRegressor
    from blendjax_torch.producer import CubeScene, TileBatchPublisher
    from blendjax_torch.train import (
        TrainDriver,
        make_echo_fused_step,
        make_train_state,
    )

    class Capture:
        def __init__(self):
            self.msgs = []

        def publish(self, **msg):
            self.msgs.append(dict(msg, btid=0, _seq=len(self.msgs)))

    scene = CubeScene(shape=(32, 64), seed=1)
    cap = Capture()
    tp = TileBatchPublisher(cap, scene.background_image(), 2, tile=(16, 32),
                            alpha_slice=False, capacity=4)
    buf = np.empty((32, 64, 4), np.uint8)
    frames = []
    for f in range(1, 13):
        scene.step(f)
        scene.render(out=buf)
        frames.append(buf.copy())
        tp.add(buf, xy=np.zeros((8, 2), np.float32), frameid=np.int64(f))
    decoded = list(StreamDataPipeline(iter([dict(m) for m in cap.msgs]),
                                      batch_size=2, device="cpu",
                                      emit_packed=False))
    assert all(set(b) >= {"image", "xy", "frameid"} for b in decoded)
    np.testing.assert_array_equal(
        torch.cat([b["image"] for b in decoded]).numpy(), np.stack(frames))

    pipe = StreamDataPipeline(iter([dict(m) for m in cap.msgs]), batch_size=2,
                              device="cpu", emit_packed=False)
    echo = EchoingPipeline(pipe, capacity=8, max_echo_factor=3,
                           emit_draws=True, rng=1)
    assert echo.device == torch.device("cpu")
    state = make_train_state(CubeRegressor(features=(4, 8)).init_params(0),
                             device="cpu")
    drv = TrainDriver(make_echo_fused_step(echo.reservoir.draw), state,
                      inflight=2, sync_every=2)
    ptrs = None
    with echo:
        for token in echo:
            drv.submit(token)
            ptrs = ptrs or echo.reservoir.data_ptrs()
    _, loss = drv.finish()
    s = echo.stats
    assert s["fresh"] + s["echoed"] == s["steps"] * 2 == drv.steps * 2
    assert s["echoed"] > 0 and s["max_uses"] <= 3 and s["inserted"] == 12
    assert drv.dispatches == drv.steps and np.isfinite(loss)
    assert all(np.isfinite(v) for v in drv.losses)
    assert echo.reservoir.data_ptrs() == ptrs


def test_echo_pipeline_refuses_what_it_cannot_echo():
    from blendjax_torch.data import EchoingPipeline, StreamDataPipeline

    packed = StreamDataPipeline([], batch_size=2, device="cpu",
                                emit_packed=True)
    with pytest.raises(ValueError, match="emit_packed=False"):
        EchoingPipeline(packed, device="cpu")
    for kw in ({"mesh": object()}, {"sharding": object()}):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 5"):
            EchoingPipeline([], device="cpu", **kw)
    with pytest.raises(ValueError, match="min_fresh_fraction"):
        EchoingPipeline([], device="cpu", min_fresh_fraction=1.5)
    echo = EchoingPipeline(iter([{"_packed": torch.zeros(1, 8)}]),
                           batch_size=2, device="cpu")
    with pytest.raises(ValueError, match="packed"):
        list(echo)
    echo.stop()


def test_echo_pipeline_skips_padded_tails_and_surfaces_errors():
    from blendjax_torch.data import EchoingPipeline

    tail = dict(_recorded_batches(1)[0], _partial=True)
    echo = EchoingPipeline(iter(_recorded_batches(2) + [tail]), batch_size=B,
                           capacity=8, max_echo_factor=2, augment=None,
                           device="cpu")
    with echo:
        n = sum(1 for _ in echo)
    assert echo.stats["skipped_partial"] == 1 and n == echo.stats["steps"]
    assert echo.stats["inserted"] == 2 * B

    def broken():
        yield _recorded_batches(1)[0]
        raise OSError("stream died")

    echo = EchoingPipeline(broken(), batch_size=B, capacity=8,
                           max_echo_factor=100, augment=None, device="cpu")
    with echo, pytest.raises(OSError, match="stream died"):
        for _ in echo:
            pass
