"""Gamma normalize (K3) and the image ops: blendjax_torch against the JAX package.

The plain K3 (``gamma_normalize_plain``, what a CPU tensor runs) is held
against the Pallas kernel in interpret mode and against the JAX entry
point's plain path, over all 256 uint8 values and an odd-row shape, at
gamma 2.2 and 1.0. Tolerances: f32 atol 1e-6 (``pow`` and the 1/255
scaling may round the last bit differently: x * f32(1/255) in the kernel,
x / 255 in the JAX plain path); bf16 within one bf16 ulp (a last-bit f32
difference can move a value across a bf16 rounding boundary). The CUDA
kernel itself is held against the plain version on a card by the
``cuda``-marked test in ``tests/test_torch_guard.py`` (no JAX there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blendjax.ops import image as JI
from blendjax_torch.kernels.image import gamma_normalize, gamma_normalize_plain
from blendjax_torch.ops import image as TI

SHAPES = [(1, 4, 16, 4), (1, 37, 8, 4)]  # all 256 values; odd rows
DTYPES = [("f32", torch.float32, jnp.float32),
          ("bf16", torch.bfloat16, jnp.bfloat16)]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """At most two torch threads: the suite runs six workers on eight
    cores beside timing-sensitive tests of the JAX package."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _input(shape):
    if shape == (1, 4, 16, 4):
        return np.arange(256, dtype=np.uint8).reshape(shape)
    return np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)


def _assert_close(got: torch.Tensor, want, name: str) -> None:
    want = np.asarray(want)
    if got.dtype == torch.bfloat16:
        # bf16 ulps apart: non-negative values order as their bit patterns
        g = got.view(torch.int16).numpy().astype(np.int32)
        w = np.asarray(torch.from_numpy(want.astype(np.float32))
                       .to(torch.bfloat16).view(torch.int16)).astype(np.int32)
        assert np.abs(g - w).max() <= 1, name
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("gamma", [2.2, 1.0])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d[0])
def test_plain_k3_matches_the_pallas_kernel(shape, gamma, dtype):
    _, tdt, jdt = dtype
    x = _input(shape)
    want = JI._pallas_gamma_normalize(jnp.asarray(x), gamma=gamma, dtype=jdt,
                                      interpret=True)
    got = gamma_normalize_plain(torch.from_numpy(x), gamma, tdt)
    assert got.shape == shape and got.dtype == tdt
    _assert_close(got, np.asarray(want.astype(jnp.float32)), "vs pallas")


def _jax_plain(x, gamma, jdt):
    """The JAX entry point's plain path with its ``gamma`` passed on:
    ``uint8_gamma_normalize(use_pallas=False)`` itself drops the argument
    (``blendjax/ops/image.py:108`` calls ``gamma_correct`` with its default
    2.2), so at other gammas it is rebuilt from its own two parts."""
    if gamma == 2.2:
        return JI.uint8_gamma_normalize(jnp.asarray(x), gamma=gamma,
                                        dtype=jdt, use_pallas=False)
    return JI.gamma_correct(
        JI.normalize_uint8(jnp.asarray(x), jnp.float32), gamma).astype(jdt)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("gamma", [2.2, 1.0])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d[0])
def test_entry_point_matches_the_jax_plain_path(shape, gamma, dtype):
    _, tdt, jdt = dtype
    x = _input(shape)
    want = _jax_plain(x, gamma, jdt)
    got = TI.uint8_gamma_normalize(torch.from_numpy(x), gamma=gamma, dtype=tdt)
    _assert_close(got, np.asarray(want.astype(jnp.float32)), "vs jnp")


def test_the_reference_plain_path_drops_gamma():
    """A fault of the reference, kept out of the port: the JAX plain path
    returns the gamma-2.2 result for every gamma, while its Pallas kernel
    and both of the port's paths honour the argument."""
    x = jnp.asarray(_input((1, 4, 16, 4)))
    at_one = JI.uint8_gamma_normalize(x, gamma=1.0, use_pallas=False)
    at_default = JI.uint8_gamma_normalize(x, gamma=2.2, use_pallas=False)
    np.testing.assert_array_equal(np.asarray(at_one), np.asarray(at_default))
    pallas = JI._pallas_gamma_normalize(x, gamma=1.0, interpret=True)
    port = TI.uint8_gamma_normalize(torch.from_numpy(np.array(x)), gamma=1.0)
    _assert_close(port, np.asarray(pallas), "port honours gamma")
    assert float(np.abs(np.asarray(pallas) - np.asarray(at_one)).max()) > 0.1


def test_entry_point_picks_by_device():
    x = torch.from_numpy(_input((1, 37, 8, 4)))
    before = gamma_normalize.launches
    assert torch.equal(TI.uint8_gamma_normalize(x),
                       gamma_normalize_plain(x, 2.2, torch.float32))
    assert torch.equal(TI.uint8_gamma_normalize(x, use_kernel=False),
                       gamma_normalize_plain(x, 2.2, torch.float32))
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        TI.uint8_gamma_normalize(x, use_kernel=True)
    # the wrapper on a CPU tensor runs the plain version and counts nothing
    assert torch.equal(gamma_normalize(x), gamma_normalize_plain(x))
    assert gamma_normalize.launches == before


def test_k3_refuses_what_it_does_not_take():
    x = torch.zeros((2, 3), dtype=torch.uint8)
    with pytest.raises(TypeError, match="uint8"):
        gamma_normalize(x.float())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gamma_normalize(x, 2.2, torch.float16)
    with pytest.raises(RuntimeError, match="no gamma-normalize kernel"):
        gamma_normalize(x.to("meta"))


def test_gamma_correct_matches_jax():
    v = np.linspace(-0.5, 1.5, 257).astype(np.float32)
    want = np.asarray(JI.gamma_correct(jnp.asarray(v), 2.2))
    got = TI.gamma_correct(torch.from_numpy(v), 2.2).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("axis", [1, 2])
def test_flip_apply_matches_jax_given_its_bits(axis):
    import jax

    x = np.random.default_rng(1).integers(0, 256, (6, 16, 32, 4), np.uint8)
    key = jax.random.key(3)
    bits = np.asarray(JI._flip_bits(key, 6))
    want = np.asarray(JI.random_flip(key, jnp.asarray(x), axis=axis))
    got = TI.apply_flip(torch.from_numpy(x), torch.from_numpy(bits.copy()), axis)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < bits.sum() < 6  # both branches exercised


def test_flip_draw_is_a_fair_coin_per_sample():
    gen = torch.Generator().manual_seed(0)
    bits = TI._flip_bits(gen, 4096)
    assert bits.dtype == torch.bool and 1800 < int(bits.sum()) < 2300
    x = torch.arange(2 * 3 * 4 * 1, dtype=torch.uint8).reshape(2, 3, 4, 1)
    out = TI.random_flip(torch.Generator().manual_seed(1), x)
    for i in range(2):
        assert torch.equal(out[i], x[i]) or torch.equal(out[i], x[i].flip(1))
