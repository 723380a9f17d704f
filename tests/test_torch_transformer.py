"""StreamFormer parity: blendjax_torch.models.StreamFormer against the JAX
package's flax StreamFormer.

A small model (patch 8, dim 32, depth 2, 4 heads) on 32x64x4 uint8
frames, f32 on both sides, weights carried over by
``blendjax_torch.weights.streamformer_from_flax``, inputs from numpy with
a seed. Tolerances: the forward agrees to rtol 1e-5; parameter gradients
of the bench loss and the fused-step loss trajectory to rtol 1e-4 (sums
taken in another order, compounded by AdamW over the updates). The
port's ``flash`` backend runs the kernels' plain versions here (CPU
tensors). TF32 is off on the torch side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from blendjax.models import StreamFormer as JaxFormer
from blendjax_torch.models import LayerNorm, StreamFormer
from blendjax_torch.models.cnn import same_pads
from blendjax_torch.ops import tiles as T
from blendjax_torch.weights import streamformer_from_flax

SMALL = dict(patch=8, dim=32, depth=2, num_heads=4, num_outputs=16)
SHAPE = (32, 64, 4)


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


def _pair(shape=SHAPE, backend="flash", seed=0):
    """A flax StreamFormer (f32) and the port's with the same weights."""
    jm = JaxFormer(**SMALL, dtype=jnp.float32, attn_backend="xla")
    params = jm.init(jax.random.key(seed), jnp.zeros((1, *shape), jnp.uint8))
    params_np = jax.tree.map(np.asarray, params["params"])
    tm = StreamFormer(**SMALL, dtype=torch.float32, attn_backend=backend,
                      image_shape=shape[:2])
    tm.load_state_dict(streamformer_from_flax(params_np))
    return jm, params, tm


def _images(n=3, shape=SHAPE, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (n, *shape),
                                                dtype=np.uint8)


def _torch_loss(model, batch):
    """The bench's StreamFormer loss (``bench.py:1084-1089``)."""
    from blendjax_torch.train import corner_loss

    return corner_loss(model(batch["image"]).reshape(-1, 8, 2), batch["xy"],
                       image_shape=tuple(batch["image"].shape[1:3]))


def _jax_loss(state, params, batch):
    from blendjax.train import corner_loss

    pred = state.apply_fn({"params": params}, batch["image"])
    return corner_loss(pred.reshape(-1, 8, 2), batch["xy"],
                       image_shape=batch["image"].shape[1:3])


@pytest.mark.parametrize("backend", ["xla", "flash"])
@pytest.mark.parametrize("shape", [SHAPE, (33, 65, 4)])
def test_forward_matches_flax_f32(backend, shape):
    """Odd sizes pin the 'SAME' padding of the patch embedding."""
    jm, params, tm = _pair(shape, backend)
    x = _images(shape=shape)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 16) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_parameter_gradients_of_the_bench_loss_match_jax():
    jm, params, tm = _pair()
    x = _images(4)
    xy = np.random.default_rng(2).uniform(0, 64, (4, 8, 2)).astype(np.float32)

    def loss(p):
        pred = jm.apply({"params": p}, jnp.asarray(x))
        from blendjax.train import corner_loss

        return corner_loss(pred.reshape(-1, 8, 2), jnp.asarray(xy),
                           image_shape=x.shape[1:3])

    want_loss, grads = jax.value_and_grad(loss)(params["params"])
    want = streamformer_from_flax(jax.tree.map(np.asarray, grads))
    got_loss = _torch_loss(tm, {"image": torch.from_numpy(x),
                                "xy": torch.from_numpy(xy)})
    got_loss.backward()
    assert float(got_loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].grad.numpy()
        np.testing.assert_allclose(g, w.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()),
                                   err_msg=name)


def test_fused_step_loss_trajectory_matches_jax():
    """Two calls of each package's fused step on one recorded chunk group
    (2 updates per call): the four f32 losses agree to rtol 1e-4."""
    from test_torch_model import _recorded_superbatch

    from blendjax import ops as JOPS
    from blendjax.train import make_fused_tile_step as jax_fused
    from blendjax.train import make_train_state as jax_state
    from blendjax_torch.train import make_fused_tile_step, make_train_state

    ref, packed, spec, geom = _recorded_superbatch(SHAPE)
    jm, params, tm = _pair()
    jstate = jax_state(jm, jnp.zeros((1, *SHAPE), jnp.uint8))
    jstate = jstate.replace(
        params=params["params"], opt_state=jstate.tx.init(params["params"])
    )
    jstep = jax_fused(_jax_loss, precision="f32", donate=False)
    jbatch = {
        "_packed": jnp.asarray(packed),
        "_refs": {"image": JOPS.tiles.tile_ref(ref, (16, 32))},
        "_spec": spec, "_names": ("image",), "_geoms": (geom,), "_rle": (),
    }
    state = make_train_state(tm, device="cpu")
    step = make_fused_tile_step(_torch_loss)
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


def test_layer_norm_is_flax_layer_norm():
    """epsilon 1e-6, variance as E[x^2] - E[x]^2 in f32, f32 result for a
    bf16 input."""
    import flax.linen as nn

    rng = np.random.default_rng(3)
    x = (rng.standard_normal((4, 6, 32)) * 1e-3 + 5.0).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    ln = nn.LayerNorm(dtype=jnp.float32)
    p = ln.init(jax.random.key(0), xb)
    want = np.asarray(ln.apply(p, xb))
    got = LayerNorm(32)(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    assert LayerNorm(32).eps == 1e-6
    tight = torch.from_numpy(x[:, :, :] - x.mean(-1, keepdims=True)) * 1e-2
    torch_default = F.layer_norm(tight, (32,))  # eps 1e-5
    assert (LayerNorm(32)(tight) - torch_default).abs().max() > 1e-3


def test_qkv_splits_into_q_k_v_in_that_order():
    """The DenseGeneral kernel (C, 3, H, D) flattens so that the reshape
    to (B, T, 3, H, D) gives q, k, v; a swapped split changes the output."""
    from blendjax.models.transformer import MultiHeadAttention as JaxMHA
    from blendjax_torch.models import MultiHeadAttention
    from blendjax_torch.weights import _dense

    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 32)).astype(np.float32)
    jmha = JaxMHA(4, dtype=jnp.float32, attn_backend="xla")
    p = jmha.init(jax.random.key(1), jnp.asarray(x))
    want = np.asarray(jmha.apply(p, jnp.asarray(x)))
    tm = MultiHeadAttention(32, 4, dtype=torch.float32)
    sd = {}
    for name in ("qkv", "proj"):
        _dense(sd, name, jax.tree.map(np.asarray, p["params"][name]))
    tm.load_state_dict(sd)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        w = tm.qkv.weight.reshape(3, 32, 32)
        tm.qkv.weight.copy_(w[[1, 0, 2]].reshape(96, 32))  # k, q, v
        assert np.abs(tm(torch.from_numpy(x)).numpy() - want).max() > 1e-3


def test_patch_embedding_same_padding():
    assert same_pads(32, 8, 8) == (0, 0)
    assert same_pads(33, 8, 8) == (3, 4)
    tm = StreamFormer(**SMALL, image_shape=(33, 65))
    assert tm.grid == (5, 9) and tm.pos_embed.shape == (1, 45, 32)


def test_mlp_uses_the_tanh_gelu(monkeypatch):
    seen = []
    orig = F.gelu

    def spy(x, approximate="none"):
        seen.append(approximate)
        return orig(x, approximate=approximate)

    monkeypatch.setattr(F, "gelu", spy)
    StreamFormer(**SMALL, image_shape=SHAPE[:2]).init_params(0)(
        torch.from_numpy(_images(1)))
    assert seen == ["tanh"] * SMALL["depth"]


def test_bf16_compute_with_f32_master_parameters(monkeypatch):
    """Every projection runs in bf16 except the f32 head; pos_embed is cast
    before the add, so the residual stream entering block 0 is bf16; the
    parameters and their gradients stay f32."""
    tm = StreamFormer(**SMALL, image_shape=SHAPE[:2]).init_params(0)
    seen = []
    orig = F.linear

    def spy(x, w, b=None):
        seen.append((x.dtype, w.dtype))
        return orig(x, w, b)

    monkeypatch.setattr(F, "linear", spy)
    entering = []
    tm.blocks[0].register_forward_pre_hook(
        lambda mod, args: entering.append(args[0].dtype))
    out = tm(torch.from_numpy(_images(2)))
    assert entering == [torch.bfloat16]
    assert len(seen) == 4 * SMALL["depth"] + 1
    assert all(d == (torch.bfloat16, torch.bfloat16) for d in seen[:-1])
    assert seen[-1] == (torch.float32, torch.float32)
    assert out.dtype == torch.float32
    out.sum().backward()
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert all(p.grad.dtype == torch.float32 for p in tm.parameters())


def test_init_params_follows_flax_defaults():
    tm = StreamFormer(patch=8, dim=64, depth=2, num_heads=4,
                      image_shape=SHAPE[:2]).init_params(3)
    qkv = tm.blocks[1].attn.qkv.weight.detach()
    std = (1 / 64) ** 0.5  # DenseGeneral's fan-in is C
    assert abs(float(qkv.std()) - std) < 0.1 * std
    assert float(qkv.abs().max()) <= 2 * std / 0.8796 + 1e-6
    fan = 8 * 8 * 4
    pe = tm.patch_embed.weight.detach()
    assert abs(float(pe.std()) - fan ** -0.5) < 0.1 * fan ** -0.5
    assert abs(float(tm.pos_embed.detach().std()) - 0.02) < 0.002
    for ln in (tm.blocks[0].norm1, tm.blocks[1].norm2, tm.norm):
        assert torch.equal(ln.weight, torch.ones(64))
        assert not ln.bias.any()
    assert all(not m.bias.any() for m in tm.modules()
               if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d)))
    again = StreamFormer(patch=8, dim=64, depth=2, num_heads=4,
                         image_shape=SHAPE[:2]).init_params(3)
    assert torch.equal(again.pos_embed, tm.pos_embed)
    assert torch.equal(again.blocks[1].attn.qkv.weight, qkv)


def test_converter_names_match_a_real_flax_tree():
    jm, params, tm = _pair()
    sd = streamformer_from_flax(jax.tree.map(np.asarray, params["params"]))
    assert set(sd) == set(tm.state_dict())
    p = params["params"]
    np.testing.assert_array_equal(
        sd["blocks.1.attn.qkv.weight"].numpy(),
        np.asarray(p["block1"]["MultiHeadAttention_0"]["qkv"]["kernel"])
        .reshape(32, 96).T)
    np.testing.assert_array_equal(
        sd["patch_embed.weight"].numpy(),
        np.asarray(p["patch_embed"]["kernel"]).transpose(3, 2, 0, 1))


@pytest.mark.parametrize("kwargs", [
    {"use_ring": True}, {"mesh": object()}, {"sp_mode": "ulysses"},
    {"num_experts": 2}, {"remat": True},
])
def test_later_slice_options_raise(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 5"):
        StreamFormer(**SMALL, **kwargs)
