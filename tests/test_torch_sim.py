"""The port's simulation scenes against the JAX package's, on the CPU.

The same seed and the same steps give, on both packages:

- uint8 frames equal bit for bit, on the C++ path and on the numpy path
  (C++ against C++, numpy against numpy: the two paths differ at
  triangle-edge pixels), for the cube, falling-cubes, supershape and
  cartpole scenes;
- the cartpole's state and the falling cubes' positions and velocities
  equal exactly (float64), through resets, reseeds and the motor action;
- ``CubeScene.observation_into`` writes what ``observation`` returns.

Scenes step through :class:`SimEngine` the way the animation controller
drives them.
"""

import numpy as np
import pytest

from blendjax.producer import sim as JS
from blendjax_torch.producer import sim as TS

STEPS = 6


def _ref_path(scene, native):
    """The JAX scene's rasterizer on its C++ path (which must have built)
    or on its numpy path."""
    if native:
        assert scene.raster._native_frame is not None
    else:
        scene.raster._native_frame = None
    return scene


def _pair(name, native, **kw):
    port = getattr(TS, name)(native=native, **kw)
    ref = _ref_path(getattr(JS, name)(**kw), native)
    return port, ref


SCENES = {
    "CubeScene": dict(shape=(48, 64), seed=3),
    "FallingCubesScene": dict(shape=(48, 64), seed=5, num_cubes=4),
    "SupershapeScene": dict(shape=(64, 64), seed=0, segments=40),
    "CartpoleScene": dict(shape=(48, 64), seed=9),
}


@pytest.mark.parametrize("native", [True, False], ids=["cpp", "numpy"])
@pytest.mark.parametrize("name", list(SCENES))
def test_scene_frames_match_the_reference(native, name):
    port, ref = _pair(name, native, **SCENES[name])
    engines = (TS.SimEngine(port), JS.SimEngine(ref))
    np.testing.assert_array_equal(port.background_image(),
                                  ref.background_image())
    if name == "SupershapeScene":
        for scene in (port, ref):
            scene.set_params([7.0, 1.0, 3.0, 3.0], shape_id=4)
    if name == "CartpoleScene":
        for scene in (port, ref):
            scene.apply_motor(2.0)
    for frame in range(1, STEPS + 1):
        for engine in engines:
            engine.frame_set(frame)
        a, b = port.render(), ref.render()
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    if hasattr(ref, "observation"):
        a, b = port.observation(STEPS), ref.observation(STEPS)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


def test_cartpole_state_matches_the_reference_exactly():
    """The state through reset, motor actions (clipped to +-5), steps,
    a reseed and a second episode: exact float64."""
    port, ref = TS.CartpoleScene(shape=(24, 32), seed=11), JS.CartpoleScene(
        shape=(24, 32), seed=11)
    actions = np.random.default_rng(0).uniform(-8, 8, 120)
    for episode in range(2):
        for scene in (port, ref):
            if episode:
                scene.reseed(42)
            scene.reset()
        np.testing.assert_array_equal(port.state, ref.state)
        for frame, a in enumerate(actions, 1):
            for scene in (port, ref):
                scene.apply_motor(a)
                scene.step(frame)
            assert port.motor_velocity == ref.motor_velocity
            assert port.state.dtype == ref.state.dtype == np.float64
            np.testing.assert_array_equal(port.state, ref.state)
        np.testing.assert_array_equal(port.observation_vector(),
                                      ref.observation_vector())


def test_falling_cubes_match_the_reference_exactly():
    port = TS.FallingCubesScene(shape=(24, 32), seed=2, num_cubes=8)
    ref = JS.FallingCubesScene(shape=(24, 32), seed=2, num_cubes=8)
    for episode in range(2):
        if episode:
            port.reset()
            ref.reset()
        for name in ("pos", "vel", "rot", "rotvel", "colors"):
            np.testing.assert_array_equal(getattr(port, name),
                                          getattr(ref, name))
        for frame in range(1, 80):  # long enough to bounce
            port.step(frame)
            ref.step(frame)
            np.testing.assert_array_equal(port.pos, ref.pos)
            np.testing.assert_array_equal(port.vel, ref.vel)
            np.testing.assert_array_equal(port.rot, ref.rot)
    assert (port.vel[:, 2] > 0).any(), "no cube bounced"


def test_supershape_radius_matches_the_reference():
    theta = np.linspace(0, 2 * np.pi, 97)
    for params in ([6.0, 1.0, 1.0, 1.0], [7.0, 0.2, 1.7, 1.7],
                   [3.0, 4.5, 10.0, 10.0]):
        np.testing.assert_array_equal(TS.supershape_radius(theta, *params),
                                      JS.supershape_radius(theta, *params))


@pytest.mark.parametrize("native", [True, False], ids=["cpp", "numpy"])
def test_observation_into_equals_observation(native):
    """``observation_into`` renders into a slot of a batch buffer; its
    slot equals ``observation`` of a twin scene on the same seed (and the
    JAX package's ``observation_into``)."""
    shape, b = (40, 56), 3
    port, twin = (TS.CubeScene(shape=shape, seed=8, native=native)
                  for _ in range(2))
    ref = _ref_path(JS.CubeScene(shape=shape, seed=8), native)
    bufs = [{"image": np.zeros((b, *shape, 4), np.uint8),
             "xy": np.zeros((b, 8, 2), np.float32),
             "frameid": np.zeros((b,), np.int64)} for _ in range(2)]
    for frame in range(1, b + 1):
        for scene in (port, twin, ref):
            scene.step(frame)
        port.observation_into(frame, bufs[0], frame - 1)
        ref.observation_into(frame, bufs[1], frame - 1)
        obs = twin.observation(frame)
        np.testing.assert_array_equal(bufs[0]["image"][frame - 1],
                                      obs["image"])
        np.testing.assert_array_equal(bufs[0]["xy"][frame - 1], obs["xy"])
        assert bufs[0]["frameid"][frame - 1] == obs["frameid"] == frame
    for k in bufs[0]:
        np.testing.assert_array_equal(bufs[0][k], bufs[1][k])


def test_reseed_starts_identical_episodes():
    """``reseed`` replaces the episode RNG: two reseeds to one seed give
    the same reset state on the port, and the JAX package's value."""
    port = TS.CartpoleScene(shape=(24, 32), seed=0)
    ref = JS.CartpoleScene(shape=(24, 32), seed=0)
    states = []
    for _ in range(2):
        port.reseed(7)
        port.reset()
        states.append(port.state.copy())
        port.step(1)
    ref.reseed(7)
    ref.reset()
    np.testing.assert_array_equal(states[0], states[1])
    np.testing.assert_array_equal(states[0], ref.state)
