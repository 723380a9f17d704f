"""The train layer of blendjax_torch against the JAX package on the CPU:
precision policies, gradient accumulation, the eval step, the capture
ladder and its manifest, the driver's image counting, start-up stamps and
MFU, host placement in the driver, and the augmentation's seed fold.

Every comparison runs both packages from the same numpy inputs and the
same weights (``blendjax_torch.weights.from_flax``) in float32 (TF32 off on
the torch side). Tolerances: forward values rtol 1e-5; losses and
parameters after 3 AdamW updates rtol 1e-4 / atol 1e-5 (reduction order
compounds over the updates); bf16-grads gradients two bf16 ulps (2**-7)
relative, with an absolute floor of 2**-7 x the tensor's largest |value|
(each side rounds its own f32 gradient to bf16).

On the CPU every step runs eagerly by design; the captured steps (one
CUDA graph per signature) are held against the eager step on a card in
``tests/test_torch_graphs.py``.
"""

import copy
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blendjax.precision as JP
from blendjax.models import CubeRegressor as JaxCube
from blendjax.train import TrainDriver as JaxDriver
from blendjax.train import make_eval_step as jax_eval_step
from blendjax.train import make_supervised_step as jax_supervised_step
from blendjax.train import make_train_state as jax_state
from blendjax.train.aot import batch_specs_for_ladder as jax_specs
from blendjax_torch import precision as P
from blendjax_torch.models import CubeRegressor
from blendjax_torch.ops import augment as A
from blendjax_torch.train import aot
from blendjax_torch.train import steps as S
from blendjax_torch.train.driver import TrainDriver, default_peak_flops
from blendjax_torch.weights import from_flax

FEATURES = (8, 16, 8)
SHAPE = (32, 48, 4)


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


def _pair(seed=0):
    """A flax CubeRegressor (f32), its params, and the port's twin."""
    jm = JaxCube(features=FEATURES, dtype=jnp.float32)
    params = jm.init(jax.random.key(seed), jnp.zeros((1, *SHAPE), jnp.uint8))
    tm = CubeRegressor(features=FEATURES, dtype=torch.float32)
    tm.load_state_dict(from_flax(jax.tree.map(np.asarray, params["params"])))
    return jm, params["params"], tm


def _batch(b=8, seed=1, mask=None):
    rng = np.random.default_rng(seed)
    out = {"image": rng.integers(0, 256, (b, *SHAPE), dtype=np.uint8),
           "xy": rng.uniform(0, 48, (b, 8, 2)).astype(np.float32)}
    if mask is not None:
        out["_mask"] = np.asarray(mask, np.float32)
    return out


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _jax_train_state(jm, params):
    st = jax_state(jm, jnp.zeros((1, *SHAPE), jnp.uint8))
    return st.replace(params=params, opt_state=st.tx.init(params))


def _port_params(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _jax_params(params):
    return {k: v.numpy() for k, v in
            from_flax(jax.tree.map(np.asarray, params)).items()}


# -- precision policies -------------------------------------------------------


@pytest.mark.parametrize("name", [None, "f32", "bf16-compute", "bf16-grads",
                                  "fp8", "BF16"])
def test_resolve_policy_matches_jax(name):
    try:
        want = JP.resolve_policy(name)
    except ValueError as e:
        with pytest.raises(ValueError, match="unknown precision policy"):
            P.resolve_policy(name)
        assert "unknown precision policy" in str(e)
        return
    got = P.resolve_policy(name)
    assert got.name == want.name
    for field in ("compute_dtype", "param_dtype", "accum_dtype",
                  "grad_reduce_dtype"):
        j, t = getattr(want, field), getattr(got, field)
        assert (j is None) == (t is None)
        if j is not None:
            assert str(t).removeprefix("torch.") == jnp.dtype(j).name
    assert P.resolve_policy(got) is got
    assert sorted(P.POLICIES) == sorted(JP.POLICIES)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cast_floating_matches_jax(dtype):
    rng = np.random.default_rng(3)
    tree = {"w": rng.normal(size=(3, 4)).astype(np.float32),
            "n": np.arange(5, dtype=np.int32),
            "nested": [rng.normal(size=(2,)).astype(np.float32),
                       np.zeros(2, np.uint8)]}
    want = JP.cast_floating(jax.tree.map(jnp.asarray, tree), jnp.dtype(dtype))
    got = P.cast_floating(
        {"w": torch.from_numpy(tree["w"]), "n": torch.from_numpy(tree["n"]),
         "nested": [torch.from_numpy(a) for a in tree["nested"]]},
        getattr(torch, dtype))
    pairs = [(got["w"], want["w"]), (got["n"], want["n"])] + list(
        zip(got["nested"], want["nested"]))
    for t, j in pairs:
        assert str(t.dtype).removeprefix("torch.") == jnp.dtype(j.dtype).name
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j, np.float32))


def test_bf16_grads_gradients_match_jax():
    """The same f32 model, differentiated under bf16-grads: every gradient
    went through bf16 (exactly representable there) and agrees with the
    JAX policy's within two bf16 ulps."""
    from blendjax.train.steps import corner_loss as jloss

    jm, params, tm = _pair()
    batch = _batch(mask=[1, 1, 1, 1, 1, 0, 1, 0])
    jb = _j(batch)

    def scalar_loss(p):
        return jloss(jm.apply({"params": p}, jb["image"]), jb["xy"],
                     image_shape=SHAPE[:2], mask=jb["_mask"])

    jl, jg = JP.policy_value_and_grad(scalar_loss, params, JP.BF16_GRADS)
    want = _jax_params(jg)
    loss, grads = P.policy_value_and_grad(S._default_loss, tm, _t(batch),
                                          P.BF16_GRADS)
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    names = [n for n, _ in tm.named_parameters()]
    assert len(grads) == len(names) == len(want)
    for name, g in zip(names, grads):
        assert g.dtype == torch.float32
        assert torch.equal(g, g.to(torch.bfloat16).float()), name
        w = want[name]
        np.testing.assert_allclose(g.numpy(), w, rtol=2 ** -7,
                                   atol=2 ** -7 * float(np.abs(w).max()),
                                   err_msg=name)


def _old_update(state, batch):
    """The update as the port made it before the precision policies:
    zero_grad, backward, optimizer step."""
    state.optimizer.zero_grad(set_to_none=True)
    loss = S._default_loss(state.model, batch)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return loss.detach()


@pytest.mark.parametrize("policy", ["f32", "bf16-compute"])
def test_policies_keep_the_old_numerics_bit_for_bit(policy):
    _, _, tm = _pair()
    tm.dtype = P.resolve_policy(policy).compute_dtype
    a = S.make_train_state(copy.deepcopy(tm), device="cpu")
    b = S.make_train_state(copy.deepcopy(tm), device="cpu")
    step = S.make_supervised_step(precision=policy)
    for i in range(3):
        batch = _t(_batch(seed=10 + i))
        _, m = step(a, batch)
        assert torch.equal(m["loss"], _old_update(b, batch))
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n
    assert a.step == b.step == 3


# -- gradient accumulation ----------------------------------------------------


@pytest.mark.parametrize("accum", [2, 4])
def test_accum_steps_matches_jax(accum):
    """3 updates of accum_steps=N on three batches, f32 on both sides:
    losses rtol 1e-4, parameters rtol 1e-4 / atol 1e-5."""
    jm, params, tm = _pair()
    jstate = _jax_train_state(jm, params)
    jstep = jax_supervised_step(accum_steps=accum, precision="f32",
                                donate=False)
    state = S.make_train_state(tm, device="cpu")
    step = S.make_supervised_step(accum_steps=accum, precision="f32")
    for i in range(3):
        batch = _batch(seed=20 + i)
        jstate, jm_ = jstep(jstate, _j(batch))
        _, m = step(state, _t(batch))
        assert float(m["loss"]) == pytest.approx(float(jm_["loss"]), rel=1e-4)
    want = _jax_params(jstate.params)
    for name, got in _port_params(state.model).items():
        np.testing.assert_allclose(got, want[name], rtol=1e-4, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("accum", [2, 4])
def test_accum_steps_against_one_step_on_the_port(accum):
    """Summed micro-batch gradients are the whole batch's up to float
    associativity: loss rtol 1e-6, gradients atol 1e-6 (f32); a lead that
    N does not divide raises."""
    _, _, tm = _pair()
    state = S.make_train_state(tm, device="cpu")
    batch = _t(_batch(mask=[1, 0, 1, 1, 1, 1, 0, 1]))
    whole, g1 = S._grads(state, batch, S._default_loss, P.F32, 1)
    split, gn = S._grads(state, batch, S._default_loss, P.F32, accum)
    # the masked loss of a split batch is the mean of per-part means
    with torch.no_grad():
        parts = [S._default_loss(tm, {k: v.reshape(accum, -1, *v.shape[1:])[i]
                                      for k, v in batch.items()})
                 for i in range(accum)]
    assert float(split) == pytest.approx(float(sum(parts) / accum), rel=1e-6)
    unmasked = {k: v for k, v in batch.items() if k != "_mask"}
    w, gw = S._grads(state, unmasked, S._default_loss, P.F32, 1)
    s, gs = S._grads(state, unmasked, S._default_loss, P.F32, accum)
    assert float(s) == pytest.approx(float(w), rel=1e-6)
    for a, b in zip(gw, gs):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)
    step = S.make_supervised_step(accum_steps=3, precision="f32")
    with pytest.raises(ValueError, match="not divisible"):
        step(state, batch)
    assert float(whole) > 0 and len(g1) == len(gn)


# -- eval step ----------------------------------------------------------------


@pytest.mark.parametrize("mask", [None, [1, 1, 0, 1, 0, 0, 1, 1]])
def test_eval_step_matches_jax_and_leaves_the_state(mask):
    jm, params, tm = _pair()
    batch = _batch(seed=5, mask=mask)
    want = jax_eval_step()(_jax_train_state(jm, params), _j(batch))
    state = S.make_train_state(tm, device="cpu")
    before = copy.deepcopy(_port_params(state.model))
    got = S.make_eval_step()(state, _t(batch))
    for key in ("loss", "px_err"):
        assert float(got[key]) == pytest.approx(float(want[key]), rel=1e-5)
    assert state.step == 0 and not state.optimizer.state
    for name, value in _port_params(state.model).items():
        np.testing.assert_array_equal(value, before[name])


# -- the ladder, the key and the manifest -------------------------------------


@pytest.mark.parametrize("lead", [8, 32])
@pytest.mark.parametrize("buckets", [None, (4, 8)])
def test_batch_specs_for_ladder_match_jax(lead, buckets):
    batch = _batch(b=lead)
    batch["_meta"] = [{}] * lead
    want = jax_specs(batch, buckets)
    got = aot.batch_specs_for_ladder(batch, buckets)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in g:
            shape, dtype = g[k]
            assert shape == tuple(w[k].shape)
            assert str(dtype).removeprefix("torch.") == np.dtype(w[k].dtype).name


KEY_PARTS = {
    "model": CubeRegressor(features=FEATURES), "precision": "bf16-grads",
    "mesh": "data=1", "decode_plan": "tile", "buckets": (1, 2, 4),
    "layout": "data", "rules": ("r",),
}


@pytest.mark.parametrize("part", [*KEY_PARTS, "torch", "device"])
def test_cache_key_is_stable_and_moved_by_each_part(part, monkeypatch):
    base = aot.cache_key(model="m", buckets=(1, 2))
    assert base == aot.cache_key(model="m", buckets=(1, 2))
    assert len(base) == 32
    if part == "torch":
        monkeypatch.setattr(torch, "__version__", "0.0.0-other")
        moved = aot.cache_key(model="m", buckets=(1, 2))
    elif part == "device":
        monkeypatch.setattr(aot, "_device_name", lambda: "Other Card")
        moved = aot.cache_key(model="m", buckets=(1, 2))
    else:
        kw = {"model": "m", "buckets": (1, 2), part: KEY_PARTS[part]}
        moved = aot.cache_key(**kw)
    assert moved != base


@pytest.fixture
def build_dirs(monkeypatch):
    """configure_compilation_cache moves the build directories; put them
    back after the test."""
    from blendjax_torch._native import build as native_build
    from blendjax_torch.kernels import build as kernel_build

    monkeypatch.setattr(kernel_build, "BUILD_DIR", kernel_build.BUILD_DIR)
    monkeypatch.setattr(native_build, "BUILD_DIR", native_build.BUILD_DIR)
    return kernel_build, native_build


def test_manifest_counts_cold_then_warm(tmp_path, build_dirs):
    kernel_build, native_build = build_dirs
    _, _, tm = _pair()
    example = _batch()
    cache = str(tmp_path / "cache")
    sets = []
    for _ in range(2):
        state = S.make_train_state(copy.deepcopy(tm), device="cpu")
        sets.append(aot.build_aot_step(S.make_supervised_step(), state,
                                       example, cache_dir=cache, key="k"))
    cold, warm = sets
    n = len(aot.batch_specs_for_ladder(example))
    assert len(cold.signatures) == n == 5  # full + ladder 1, 2, 4, 8
    assert (cold.cache_hits, cold.cache_misses) == (0, n)
    assert (warm.cache_hits, warm.cache_misses) == (n, 0)
    with open(os.path.join(cache, "aot_manifest.json")) as f:
        assert len(json.load(f)["k"]) == n
    other = aot.build_aot_step(
        S.make_supervised_step(), S.make_train_state(tm, device="cpu"),
        example, cache_dir=cache, key="other key")
    assert (other.cache_hits, other.cache_misses) == (0, n)
    assert kernel_build.BUILD_DIR.parent == tmp_path / "cache"
    assert native_build.BUILD_DIR.parent == tmp_path / "cache"
    assert not [p for p in os.listdir(cache) if p.endswith(".tmp")]


# -- the driver ----------------------------------------------------------------


def test_build_on_the_cpu_stamps_start_up_and_takes_the_ladder():
    """TrainDriver.build(aot=True) on the CPU: every ladder signature is
    known before step 0, a ragged tail is padded onto it (no fallback),
    an unseen shape counts aot_fallbacks, and the start-up stamps land."""
    _, _, tm = _pair()
    example = _batch()
    eager = S.make_train_state(copy.deepcopy(tm), device="cpu")
    drv = TrainDriver.build(tm, example, aot=True, device="cpu",
                            precision="f32", sync_every=0)
    assert isinstance(drv.step, aot.AotStepSet)
    assert drv.startup_ms > 0 and drv.time_to_first_step_ms is None
    assert drv.stats["signatures"] == 5
    ref = S.make_supervised_step(precision="f32")
    tail = {**_t(_batch(b=3, seed=7)), "_partial": True}
    for batch in (_t(example), tail):
        drv.submit(batch)
        want = ref(eager, _padded(batch))[1]["loss"]
        assert drv.drain() == pytest.approx(float(want), rel=0, abs=0)
    assert drv.stats["aot_fallbacks"] == 0
    drv.submit(_t(_batch(b=5, seed=8)))  # 5 rows, not a ladder shape
    drv.drain()
    st = drv.stats
    assert st["aot_fallbacks"] == 1 and st["steps"] == 3
    assert st["images_retired"] == 8 + 4 + 5  # the tail trains a bucket of 4
    assert st["time_to_first_step_ms"] >= st["startup_ms"] > 0
    assert drv.state.step == 3


def _padded(batch):
    """What the driver steps on: a partial batch padded to its bucket."""
    from blendjax_torch.data.batcher import pad_to_bucket

    return pad_to_bucket(batch) if batch.get("_partial") else batch


def _image_cases():
    rng = np.random.default_rng(0)
    spec = (("image__tileidx", "<i4", (8, 24), 0, 0),
            ("xy", "<f4", (8, 8, 2), 0, 0))
    return {
        "packed": {"_packed": np.zeros((3, 100), np.uint8), "_spec": spec},
        "packed no xy": {"_packed": np.zeros((2, 100), np.uint8),
                         "_spec": (("a", "<f4", (6, 2), 0, 0),
                                   ("b", "<f4", (4,), 0, 0))},
        "decoded superbatch": {"image": np.zeros((4, 8, 8, 8, 4), np.uint8)},
        "plain": {"image": np.zeros((8, 8, 8, 4), np.uint8)},
        "echo token": {"_echo_idx": rng.integers(0, 9, 12), "_echo_counter": 3},
        "fields only": {"xy": np.zeros((5, 8, 2)), "_meta": [1, 2]},
    }


@pytest.mark.parametrize("case", list(_image_cases()))
def test_images_retired_counts_as_the_jax_driver(case):
    batch = _image_cases()[case]
    want = JaxDriver._batch_images(batch)
    assert TrainDriver._batch_images(batch) == want > 0

    def step(state, b):
        return state, {"loss": torch.zeros(())}

    drv = TrainDriver(step, None, pad_partial=False)
    for _ in range(3):
        drv.submit(batch)
    drv.drain()
    assert drv.images_retired == 3 * want


def test_mfu_from_hand_fed_flops(monkeypatch):
    clock = iter(float(t) for t in range(100))
    monkeypatch.setattr("blendjax_torch.train.driver.time.monotonic",
                        lambda: next(clock))

    def step(state, b):
        return state, {"loss": torch.zeros(())}

    drv = TrainDriver(step, None, flops_per_image=2e9, peak_flops=1e12,
                      sync_every=0)
    assert drv.mfu is None
    for _ in range(4):
        drv.submit({"image": np.zeros((8, 4, 4, 4), np.uint8)})
    drv.drain()
    dt = drv._t_last_retire - drv._t_first_dispatch
    assert dt > 0 and drv.images_retired == 32
    assert drv.stats["mfu"] == pytest.approx(32 / dt * 2e9 / 1e12, rel=1e-12)
    assert TrainDriver(step, None).mfu is None


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 989e12), ("NVIDIA H100 PCIe", 756e12),
    ("NVIDIA H200", 989e12), ("Some Other Card", None)])
def test_default_peak_flops_by_card_name(name, peak):
    assert default_peak_flops(name) == peak


class _Capture:
    def __init__(self):
        self.msgs = []

    def publish(self, **msg):
        self.msgs.append(dict(msg, btid=0, _seq=len(self.msgs)))


def _recorded_messages(n=8, batch=2):
    from blendjax_torch.producer import CubeScene, TileBatchPublisher

    scene = CubeScene(shape=SHAPE[:2], seed=3)
    cap = _Capture()
    tp = TileBatchPublisher(cap, scene.background_image(), batch,
                            tile=(16, 16), alpha_slice=False, capacity=6)
    buf = np.empty(SHAPE, np.uint8)
    for f in range(1, n * batch + 1):
        scene.step(f)
        scene.render(out=buf)
        tp.add(buf, hint=scene.raster.last_drawn,
               xy=scene.camera.world_to_pixel(scene.corners_world()).astype(
                   np.float32), frameid=np.int64(f))
    return cap.msgs


def test_place_in_driver_trains_as_the_feeder_path():
    """The same recorded messages through the feeder path and through
    place_in_driver (host batches placed by the driver): the same losses,
    bit for bit."""
    from blendjax_torch.data import StreamDataPipeline

    msgs = _recorded_messages()
    _, _, tm = _pair()
    losses = {}
    for in_driver in (False, True):
        pipe = StreamDataPipeline(iter(copy.deepcopy(msgs)), batch_size=2,
                                  device="cpu", chunk=2,
                                  place_in_driver=in_driver)
        state = S.make_train_state(copy.deepcopy(tm), device="cpu")
        drv = TrainDriver(S.make_fused_tile_step(precision="f32"), state,
                          sync_every=1,
                          place=pipe.feeder.place if in_driver else None)
        seen = []
        for b in pipe:
            seen.append(isinstance(b["_packed"], np.ndarray))
            drv.submit(b)
        drv.drain()
        assert all(seen) == in_driver and len(seen) == 4
        losses[in_driver] = drv.losses
        assert drv.images_retired == 16
    assert losses[True] == losses[False] and len(losses[True]) == 4
    with pytest.raises(ValueError, match="place_in_driver"):
        StreamDataPipeline([], batch_size=2, device="cpu", emit_packed=False,
                           place_in_driver=True)


# -- augmentation seeds ---------------------------------------------------------


def _images(b=4, seed=6):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (b, *SHAPE), dtype=np.uint8))


@pytest.mark.parametrize("builder", ["supervised", "chunked"])
def test_supervised_augment_folds_the_step_into_the_seed(builder):
    """The images a step's loss sees are make_augment's for
    fold_seed(augment_rng, step), update by update: the same (rng, step)
    gives the same images, another step others; a chunk of K updates sees
    what K per-batch calls see."""
    aug = A.make_augment(A.random_flip, A.color_jitter)
    seen = []

    def loss_fn(model, batch):
        seen.append(batch["image"].clone())
        return S._default_loss(model, batch)

    _, _, tm = _pair()
    images = [_images(seed=s) for s in (6, 7, 8)]
    xy = torch.zeros((4, 8, 2))
    state = S.make_train_state(tm, device="cpu")
    if builder == "supervised":
        step = S.make_supervised_step(loss_fn, augment=aug, augment_rng=7)
        for x in images:
            step(state, {"image": x, "xy": xy})
    else:
        step = S.make_chunked_supervised_step(loss_fn, augment=aug,
                                              augment_rng=7)
        step(state, {"image": torch.stack(images),
                     "xy": xy.expand(3, 4, 8, 2)})
    assert state.step == 3 and len(seen) == 3
    for i, (x, got) in enumerate(zip(images, seen)):
        assert torch.equal(got, aug(A.fold_seed(7, i), x))
    assert not torch.equal(aug(A.fold_seed(7, 0), images[0]),
                           aug(A.fold_seed(7, 1), images[0]))
    assert not torch.equal(aug(A.fold_seed(8, 0), images[0]), seen[0])


@pytest.mark.parametrize("slot", [0, 3])
def test_reseed_then_draw_gives_the_eager_draws(slot):
    """The host half of a captured draw: seeding the persistent generators
    and drawing from them gives exactly what a call draws."""
    aug = A.make_batch_augment(
        A.random_flip_with_points,
        functools.partial(A.random_crop_with_points, pad=2), A.color_jitter,
        points_key="xy")
    batch = {"image": _images(), "xy": torch.rand((4, 8, 2)) * 32}
    want = aug(11, batch, slot=slot)
    aug(99, batch, slot=slot)  # move the generators on
    aug.seed(11, "cpu", slot)
    got = aug._apply(aug.generators("cpu", slot), batch)
    for k in ("image", "xy"):
        assert torch.equal(got[k], want[k])
    assert len(aug.generators("cpu", slot)) == 3
    assert aug.generators("cpu", slot) is aug.generators("cpu", slot)


def test_step_hooks_seed_each_update_of_a_chunk():
    aug = A.make_augment(A.color_jitter)
    step = S.make_fused_tile_step(augment=aug, augment_rng=5)
    _, _, tm = _pair()
    state = S.make_train_state(tm, device="cpu")
    state.step = 10
    batch = {"_packed": torch.zeros((3, 4), dtype=torch.uint8)}
    gens = step.generators(state, batch)
    assert len(gens) == 3
    step.reseed(state, batch)
    for k, gen in enumerate(gens):
        fresh = A.seeded_generator(A.fold_seed(A.fold_seed(5, 10 + k), 0),
                                   "cpu")
        assert torch.equal(torch.rand(4, generator=gen),
                           torch.rand(4, generator=fresh))
    plain = S.make_fused_tile_step()
    assert plain.generators(state, batch) == []


def test_launches_on_a_diverted_stream_go_to_its_tally(monkeypatch):
    """A graph's warm-up and capture count their launches into a tally
    (what each replay adds) by stream: autograd's backward thread queues
    on the forward's stream and is diverted with it, while a launch on
    another stream (the echo drain thread's K1 and K3) still counts into
    the wrappers."""
    import threading
    from types import SimpleNamespace

    from blendjax_torch import kernels as K
    from blendjax_torch.kernels.counting import count_launch, diverted

    capture, other = SimpleNamespace(cuda_stream=1), SimpleNamespace(
        cuda_stream=2)
    current = threading.local()
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: getattr(current, "stream", other))

    def launch_on(stream, wrapper):
        current.stream = stream
        count_launch(wrapper)

    K.reset_launch_counts()
    with diverted(capture) as tally:
        current.stream = capture
        count_launch(K.decode_spatial)
        count_launch(K.flash_attention_fwd, "sm90")
        for stream, wrapper in ((capture, K.flash_attention_bwd_dq),
                                (other, K.gamma_normalize)):
            worker = threading.Thread(target=launch_on,
                                      args=(stream, wrapper))
            worker.start()
            worker.join(timeout=10)
            assert not worker.is_alive()
        with pytest.raises(RuntimeError, match="already diverted"):
            with diverted(capture):
                pass
    assert tally == {"launches": {"decode_spatial": 1,
                                  "flash_attention_fwd": 1,
                                  "flash_attention_bwd_dq": 1},
                     "variants": {"flash_attention_fwd": {"sm90": 1}}}
    counts = K.launch_counts()
    assert counts["gamma_normalize"] == 1 and counts["decode_spatial"] == 0
    count_launch(K.decode_spatial)  # the context has ended
    for _ in range(3):
        K.add_launches(tally["launches"], tally["variants"])
    assert K.launch_counts()["decode_spatial"] == 4
    assert K.variant_counts()["flash_attention_fwd"] == {"sm90": 3,
                                                         "simple": 0}
    K.reset_launch_counts()
