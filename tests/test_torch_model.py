"""CubeRegressor and training-step parity: blendjax_torch against the JAX package.

Both sides run in float32 on the CPU from the same weights (carried over
by ``blendjax_torch.weights.from_flax``) and the same numpy inputs.
Tolerances: the forward pass agrees to rtol 1e-5 (sums taken in another
order); the fused-step loss trajectory to rtol 1e-4 (AdamW plus
convolution reduction order compound over the updates). TF32 is off on
the torch side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from blendjax.models import CubeRegressor as JaxCube
from blendjax.ops import tiles as JT
from blendjax_torch.models import CubeRegressor
from blendjax_torch.models.cnn import same_pads
from blendjax_torch.ops import tiles as T
from blendjax_torch.weights import from_flax

FEATURES = (8, 16, 8)


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


def _pair(shape, seed=0):
    """A flax CubeRegressor (f32) and the port's with the same weights."""
    jm = JaxCube(features=FEATURES, dtype=jnp.float32)
    params = jm.init(jax.random.key(seed), jnp.zeros((1, *shape), jnp.uint8))
    params_np = jax.tree.map(np.asarray, params["params"])
    tm = CubeRegressor(features=FEATURES, dtype=torch.float32)
    tm.load_state_dict(from_flax(params_np))
    return jm, params, tm


@pytest.mark.parametrize("shape", [(32, 48, 4), (33, 47, 4)])
def test_forward_matches_flax_f32(shape):
    """Even sizes pin flax's (0, 1) 'SAME' padding, odd sizes its (1, 1)."""
    jm, params, tm = _pair(shape)
    x = np.random.default_rng(1).integers(0, 256, (3, *shape), dtype=np.uint8)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 8, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_same_padding_trap():
    assert same_pads(32, 3, 2) == (0, 1)
    assert same_pads(33, 3, 2) == (1, 1)
    x = torch.randn(1, 2, 8, 8, generator=torch.Generator().manual_seed(0))
    w = torch.randn(3, 2, 3, 3, generator=torch.Generator().manual_seed(1))
    flax_like = F.conv2d(F.pad(x, (0, 1, 0, 1)), w, stride=2)
    symmetric = F.conv2d(x, w, stride=2, padding=1)
    assert flax_like.shape == symmetric.shape
    assert not torch.allclose(flax_like, symmetric)


def test_gelu_is_the_tanh_form():
    v = np.linspace(-4, 4, 101).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(v)))  # flax nn.gelu default
    got = F.gelu(torch.from_numpy(v), approximate="tanh").numpy()
    # the two tanh formulas round differently in the last float32 bits
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    exact = F.gelu(torch.from_numpy(v)).numpy()
    assert np.abs(exact - want).max() > 1e-4


def test_from_flax_layouts():
    _, params, tm = _pair((32, 48, 4))
    p = params["params"]
    assert tuple(tm.convs[0].weight.shape) == (8, 4, 3, 3)
    np.testing.assert_array_equal(
        tm.convs[1].weight.detach().numpy(),
        np.asarray(p["Conv_1"]["kernel"]).transpose(3, 2, 0, 1),
    )
    np.testing.assert_array_equal(
        tm.head.weight.detach().numpy(), np.asarray(p["Dense_1"]["kernel"]).T
    )


def test_default_policy_is_bf16_compute_with_f32_master_params(monkeypatch):
    tm = CubeRegressor(features=FEATURES).init_params(0)
    seen = []
    orig = F.conv2d

    def spy(x, w, b=None, **kw):
        seen.append((x.dtype, w.dtype))
        return orig(x, w, b, **kw)

    monkeypatch.setattr(F, "conv2d", spy)
    x = torch.from_numpy(
        np.random.default_rng(2).integers(0, 256, (2, 32, 48, 4), dtype=np.uint8)
    )
    out = tm(x)
    assert len(seen) == len(FEATURES)
    assert all(d == (torch.bfloat16, torch.bfloat16) for d in seen)
    assert out.dtype == torch.float32  # the head runs in f32
    out.sum().backward()
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert all(p.grad.dtype == torch.float32 for p in tm.parameters())


def test_init_params_follows_flax_lecun_normal():
    tm = CubeRegressor().init_params(3)
    w = tm.convs[1].weight.detach()
    fan_in = w[0].numel()
    assert abs(float(w.std()) - (1 / fan_in) ** 0.5) < 0.1 * (1 / fan_in) ** 0.5
    assert float(w.abs().max()) <= 2 * (1 / fan_in) ** 0.5 / 0.8796 + 1e-6
    assert all(not layer.bias.detach().any() for layer in tm.convs)
    again = CubeRegressor().init_params(3)
    assert torch.equal(again.convs[1].weight, tm.convs[1].weight)


def test_train_state_uses_optax_adamw_defaults():
    from blendjax_torch.train import make_train_state

    st = make_train_state(CubeRegressor(features=FEATURES), device="cpu")
    g = st.optimizer.param_groups[0]
    assert isinstance(st.optimizer, torch.optim.AdamW)
    assert (g["lr"], g["betas"], g["eps"], g["weight_decay"]) == (
        1e-3, (0.9, 0.999), 1e-8, 1e-4
    )


def test_corner_loss_matches_jax_with_and_without_mask():
    from blendjax.train.steps import corner_loss as jloss
    from blendjax_torch.train import corner_loss

    rng = np.random.default_rng(4)
    pred = rng.normal(100, 50, (4, 8, 2)).astype(np.float32)
    xy = rng.normal(100, 50, (4, 8, 2)).astype(np.float32)
    mask = np.array([1, 1, 0, 1], np.float32)
    for m in (None, mask):
        want = float(jloss(jnp.asarray(pred), jnp.asarray(xy), (48, 64),
                           None if m is None else jnp.asarray(m)))
        got = float(corner_loss(torch.from_numpy(pred), torch.from_numpy(xy),
                                (48, 64),
                                None if m is None else torch.from_numpy(m)))
        assert got == pytest.approx(want, rel=1e-6)


class _Capture:
    def __init__(self):
        self.msgs = []

    def publish(self, **msg):
        self.msgs.append(msg)


def _recorded_superbatch(shape, k=2, batch=4, seed=9):
    """One packed chunk group from the port's producer path (cube scene,
    (16, 32) tiles), with its decode plan."""
    from blendjax_torch.producer import CubeScene, TileBatchPublisher

    scene = CubeScene(shape=shape[:2], seed=seed)
    cap = _Capture()
    tp = TileBatchPublisher(cap, scene.background_image(), batch,
                            tile=(16, 32), alpha_slice=False, capacity=24)
    buf = np.empty(shape, np.uint8)
    for frame in range(1, k * batch + 1):
        scene.step(frame)
        scene.render(out=buf)
        tp.add(buf, hint=scene.raster.last_drawn,
               xy=scene.camera.world_to_pixel(scene.corners_world()).astype(
                   np.float32),
               frameid=np.int64(frame))
    refs, bufs = {}, []
    for msg in cap.msgs:
        msg.pop("_prebatched")
        msg.pop("btid", None)
        T.pop_stream_refs(msg, refs, None)
        (name, geom), = T.pop_tile_batches(msg)
        packed, spec = T.pack_fields(msg)
        bufs.append(packed)
    return refs[("image", None)], np.stack(bufs), spec, geom


def test_fused_step_loss_trajectory_matches_jax():
    """Two calls of each package's fused step on the same recorded chunk
    group (2 updates per call): the four f32 losses agree to rtol 1e-4."""
    from blendjax.train import make_fused_tile_step as jax_fused
    from blendjax.train import make_train_state as jax_state
    from blendjax_torch.train import make_fused_tile_step, make_train_state

    shape = (64, 128, 4)
    ref, packed, spec, geom = _recorded_superbatch(shape)
    jm, params, tm = _pair(shape)
    jstate = jax_state(jm, jnp.zeros((1, *shape), jnp.uint8))
    jstate = jstate.replace(
        params=params["params"], opt_state=jstate.tx.init(params["params"])
    )
    jstep = jax_fused(precision="f32", donate=False)
    jbatch = {
        "_packed": jnp.asarray(packed), "_refs": {"image": JT.tile_ref(ref, (16, 32))},
        "_spec": spec, "_names": ("image",), "_geoms": (geom,), "_rle": (),
    }
    state = make_train_state(tm, device="cpu")
    step = make_fused_tile_step()
    tbatch = {
        "_packed": torch.from_numpy(packed),
        "_refs": {"image": T.tile_ref(torch.from_numpy(ref), (16, 32))},
        "_spec": spec, "_names": ("image",), "_geoms": (geom,), "_rle": (),
    }
    want, got = [], []
    for _ in range(2):
        jstate, jm_ = jstep(jstate, jbatch)
        want.extend(np.asarray(jm_["loss"]).tolist())
        state, m = step(state, tbatch)
        got.extend(m["loss"].tolist())
    assert len(got) == 4 and state.step == 4
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]  # it trains
