"""Scoring of the port (blendjax_torch.train.score, blendjax_torch.models.
Discriminator) against the JAX package's, on the CPU.

Bars: ``GaussianSimParams`` ``log_prob`` within 1e-5 relative, and ``mu``,
``log_sigma``, the baseline and the returned mean loss within 1e-6 after
each of several updates (f32, the same seeded theta and losses; the JAX
side's ``sample`` draws with threefry, which torch cannot reproduce, so
theta is fixed); the port's own sample moments over 200 000 draws within
0.01 of the stated mean and sigma. ``Discriminator`` with the flax weights
carried across: logits within 1e-5 in f32 at an odd size (30x22, where
``'SAME'`` pads (1, 2)) and an even one, the gradients of the summed logit
with respect to the input and the first convolution's kernel within 1e-5
(relative to their largest entry), and the default bf16 compute within
3e-2 of flax's bf16.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blendjax.models import Discriminator as JaxDiscriminator
from blendjax.train.score import GaussianSimParams as JaxSim
from blendjax.train.score import chunk_across as jax_chunk_across
from blendjax_torch.models import Discriminator
from blendjax_torch.train.score import GaussianSimParams, chunk_across
from blendjax_torch.weights import discriminator_from_flax, flax_tree

FEATURES = (8, 16)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


# -- GaussianSimParams ------------------------------------------------------


def _theta_losses(seed, n=16, d=3):
    rng = np.random.default_rng(seed)
    theta = rng.normal(1.0, 0.7, (n, d)).astype(np.float32)
    losses = (np.abs(theta - 2.0).sum(-1)
              + rng.normal(0, 0.1, n)).astype(np.float32)
    return theta, losses


def test_log_prob_matches_the_reference():
    theta, _ = _theta_losses(0)
    mu, ls = [0.5, -1.0, 2.0], [0.1, -0.3, 0.0]
    got = GaussianSimParams(mu, ls, device="cpu").log_prob(
        torch.from_numpy(theta))
    want = JaxSim(mu, ls).log_prob(jnp.asarray(theta))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_update_matches_the_reference_over_several_steps():
    kw = dict(learning_rate=0.2, baseline_decay=0.8)
    port = GaussianSimParams([0.5, -1.0, 2.0], [0.1, -0.3, 0.0],
                             device="cpu", **kw)
    ref = JaxSim([0.5, -1.0, 2.0], [0.1, -0.3, 0.0], **kw)
    for step in range(4):
        theta, losses = _theta_losses(step + 1)
        got, want = port.update(theta, losses), ref.update(theta, losses)
        assert abs(got - want) <= 1e-6
        np.testing.assert_allclose(port.mu.numpy(), np.asarray(ref.mu),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(port.log_sigma.numpy(),
                                   np.asarray(ref.log_sigma), atol=1e-6,
                                   rtol=0)
        assert abs(float(port.baseline) - float(ref.baseline)) <= 1e-6
    assert port.mu.dtype == torch.float32 and not port.mu.requires_grad


def test_update_takes_tensors_and_keeps_the_device():
    sim = GaussianSimParams([0.0], [0.0], device="cpu")
    theta, losses = _theta_losses(3, d=1)
    sim.update(torch.from_numpy(theta), torch.from_numpy(losses))
    assert sim.mu.device.type == "cpu" and torch.isfinite(sim.mu).all()


def test_sample_moments_match_the_stated_distribution():
    sim = GaussianSimParams([1.5, -2.0], np.log([0.5, 2.0]), device="cpu")
    gen = torch.Generator().manual_seed(0)
    draws = sim.sample(gen, 200_000)
    assert draws.shape == (200_000, 2) and draws.dtype == torch.float32
    np.testing.assert_allclose(draws.mean(0).numpy(), [1.5, -2.0], atol=0.01)
    np.testing.assert_allclose(draws.std(0).numpy(), [0.5, 2.0], atol=0.01)
    # an explicit generator: the same seed draws the same samples
    again = sim.sample(torch.Generator().manual_seed(0), 200_000)
    assert torch.equal(draws, again)


@pytest.mark.parametrize("side", ["port", "jax"])
def test_score_update_moves_toward_low_loss(side):
    """The reference's densityopt case on both packages: loss |theta - 2|
    pulls mu down from 5."""
    if side == "port":
        sim = GaussianSimParams(mu=[5.0], log_sigma=[0.0],
                                learning_rate=0.2, device="cpu")
        gen = torch.Generator().manual_seed(0)

        def draw():
            return sim.sample(gen, 16).numpy()
    else:
        sim = JaxSim(mu=[5.0], log_sigma=[0.0], learning_rate=0.2)
        keys = iter(jax.random.split(jax.random.key(0), 30))

        def draw():
            return np.asarray(sim.sample(next(keys), 16))
    for _ in range(30):
        theta = draw()
        sim.update(theta, np.abs(theta[:, 0] - 2.0))
    assert float(sim.mu[0]) < 4.0


def test_the_default_device_is_the_card():
    """No device means the card: on a host without one the entry point
    raises instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GaussianSimParams([0.0], [0.0])


@pytest.mark.parametrize("n,k", [(5, 2), (1, 3), (7, 7), (0, 2)])
def test_chunk_across_matches_the_reference(n, k):
    items = list(range(n))
    assert chunk_across(items, k) == jax_chunk_across(items, k)


# -- Discriminator ------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _flax(hw, dtype=jnp.float32, seed=0):
    """The flax model and weights made from a numpy seed through the flax
    tree's shapes (``jax.eval_shape``: flax's own init compiles for
    seconds here): kernels scaled by 1/sqrt(fan_in), and random GroupNorm
    scales and biases, so the affine half is checked too."""
    model = JaxDiscriminator(features=FEATURES, dtype=dtype)
    x = jax.ShapeDtypeStruct((2, *hw, 4), jnp.float32)
    shapes = jax.eval_shape(model.init, jax.random.key(0), x)["params"]
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(sd.shape[:-1]))
            v = rng.normal(0.0, 1.0 / np.sqrt(fan_in), sd.shape)
        else:
            v = rng.normal(1.0 if name == "scale" else 0.0, 0.2, sd.shape)
        return v.astype(np.float32)

    return model, jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.lru_cache(maxsize=None)
def _apply(hw, dtype=jnp.float32):
    model, params = _flax(hw, dtype)
    return jax.jit(lambda x: model.apply({"params": params}, x))


def _port(params, dtype=torch.float32):
    d = Discriminator(features=FEATURES, dtype=dtype)
    d.load_state_dict(discriminator_from_flax(params))
    return d


def _images(hw, seed=1, uint8=False):
    rng = np.random.default_rng(seed)
    if uint8:
        return rng.integers(0, 256, (2, *hw, 4), dtype=np.uint8)
    return rng.random((2, *hw, 4), dtype=np.float32)


@pytest.mark.parametrize("hw", [(30, 22), (32, 32)], ids=["odd", "even"])
@pytest.mark.parametrize("uint8", [False, True], ids=["float", "uint8"])
def test_logits_match_flax_with_its_weights(hw, uint8):
    _, params = _flax(hw)
    x = _images(hw, uint8=uint8)
    want = np.asarray(_apply(hw)(jnp.asarray(x)))
    with torch.no_grad():
        got = _port(params)(torch.from_numpy(x)).numpy()
    assert got.shape == (2,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_padding_one_would_be_wrong_at_the_odd_size():
    """The trap the explicit SAME pads avoid: torch's symmetric
    ``padding=1`` shifts every output row at an odd size."""
    _, params = _flax((30, 22))
    x = _images((30, 22))
    want = np.asarray(_apply((30, 22))(jnp.asarray(x)))
    d = _port(params)
    with torch.no_grad():
        y = torch.from_numpy(x).permute(0, 3, 1, 2)
        for conv, norm in zip(d.convs, d.norms):
            y = torch.nn.functional.conv2d(y, conv.weight, stride=2,
                                           padding=1)
            y = torch.nn.functional.leaky_relu(norm(y), 0.2)
        wrong = d.head(y.mean(dim=(2, 3)))[:, 0].numpy()
    assert np.abs(wrong - want).max() > 1e-3


def test_gradients_match_flax():
    hw = (30, 22)
    model, params = _flax(hw)
    x = _images(hw)

    def total(p, xx):
        return model.apply({"params": p}, xx).sum()

    gp, gx = jax.jit(jax.grad(total, argnums=(0, 1)))(params,
                                                       jnp.asarray(x))
    d = _port(params)
    xt = torch.from_numpy(x).requires_grad_(True)
    d(xt).sum().backward()

    def close(got, want):
        want = np.asarray(want)
        scale = max(np.abs(want).max(), 1e-12)
        assert np.abs(got - want).max() / scale <= 1e-5

    close(xt.grad.numpy(), gx)
    # OIHW here, HWIO in flax
    close(d.convs[0].weight.grad.permute(2, 3, 1, 0).numpy(),
          gp["Conv_0"]["kernel"])


def test_default_compute_is_bf16_with_an_f32_head():
    hw = (30, 22)
    _, params = _flax(hw, dtype=None)
    x = _images(hw, uint8=True)
    want = np.asarray(_apply(hw, None)(jnp.asarray(x)))
    d = _port(params, dtype=None)
    with torch.no_grad():
        got = d(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=3e-2, rtol=3e-2)


def test_flax_tree_gives_the_weights_back():
    _, params = _flax((16, 16))
    tree = flax_tree(_port(params))
    flat = dict(jax.tree_util.tree_leaves_with_path(params))
    got = dict(jax.tree_util.tree_leaves_with_path(tree))
    assert set(map(str, flat)) == set(map(str, got))
    for path, v in flat.items():
        np.testing.assert_array_equal(got[path], np.asarray(v))


def test_init_params_is_flax_shaped():
    d = Discriminator(features=FEATURES).init_params(0)
    assert all(torch.equal(n.weight, torch.ones_like(n.weight))
               for n in d.norms)
    assert d.convs[0].weight.shape == (8, 4, 4, 4)
    assert d.convs[0].bias is None and d.norms[0].eps == 1e-6
