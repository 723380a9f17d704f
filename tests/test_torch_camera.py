"""The port's camera against the JAX package's, on the CPU.

- A camera whose attributes change after construction projects with the
  new values on both sides: each of ``position``, ``rotation``, ``shape``,
  ``focal_mm``, ``sensor_mm``, ``ortho_scale``, ``clip_near`` and
  ``clip_far`` changed in turn, the pixels of random world points equal
  to 1e-12 and the rasterizer's frame (C++ and numpy paths) equal bit for
  bit (ROADMAP Queue C, C5: the port built its matrices once).
- The eight cases of ``tests/test_camera.py`` on both packages: each
  analytic truth holds on the port, and the port's values equal the JAX
  package's to 1e-12.
"""

import numpy as np
import pytest

from blendjax.producer import camera as JC
from blendjax.producer import sim as JS
from blendjax.producer import utils as JU
from blendjax_torch.producer import camera as TC
from blendjax_torch.producer import sim as TS
from blendjax_torch.producer import utils as TU

TOL = dict(rtol=0, atol=1e-12)

# attribute -> the value it is changed to (the C5 cases)
CHANGES = {
    "position": (5.0, -7.0, 3.0),
    "rotation": JU.look_at_matrix((6.0, -6.0, 4.0), (0.3, -0.2, 0.4)),
    "shape": (40, 72),
    "focal_mm": 35.0,
    "sensor_mm": 24.0,
    "ortho_scale": 7.0,
    "clip_near": 1.5,
    "clip_far": 11.0,
}


def _points(seed, n=64):
    return np.random.default_rng(seed).uniform(-1.5, 1.5, (n, 3))


def _jax_raster(shape, native):
    r = JS.Rasterizer(shape=shape)
    if native:
        assert r._native_frame is not None, "the JAX C++ did not build"
    else:
        r._native_frame = None
    return r


def _cube(seed):
    rng = np.random.default_rng(seed)
    tris, faces = TS.cube_triangles(
        (0, 0, 0), 1.0, TS.rotation_xyz(*rng.uniform(0, 2 * np.pi, 3)))
    colors = np.repeat(rng.integers(40, 255, (1, 3)).astype(np.uint8), 12, 0)
    return tris, colors


def _frames(cams, native, tris, colors):
    """The frame of each camera through a fresh rasterizer of its shape
    (the port's and the JAX package's, on the same path)."""
    port_cam, ref_cam = cams
    port = TS.Rasterizer(shape=port_cam.shape, native=native)
    ref = _jax_raster(ref_cam.shape, native)
    return (port.render(port_cam, tris, colors),
            ref.render(ref_cam, tris, colors))


@pytest.mark.parametrize("native", [True, False], ids=["cpp", "numpy"])
def test_a_moved_camera_renders_as_the_reference_camera(native):
    """The C5 case itself: look_at from (6, -6, 4) at (48, 64), then
    ``position = (5, -7, 3)`` on both sides. The port's pixels and frames
    must follow the move (they stayed at the old pose before the repair,
    up to 17 px off)."""
    kw = dict(eye=(6.0, -6.0, 4.0), target=(0, 0, 0), shape=(48, 64))
    cams = (TC.Camera.look_at(**kw), JC.Camera.look_at(**kw))
    tris, colors = _cube(0)
    before = _frames(cams, native, tris, colors)
    for cam in cams:
        cam.position = (5.0, -7.0, 3.0)
    pts = TU.cube_vertices((0, 0, 0), 1.0)
    np.testing.assert_allclose(cams[0].world_to_pixel(pts),
                               cams[1].world_to_pixel(pts), **TOL)
    after = _frames(cams, native, tris, colors)
    np.testing.assert_array_equal(after[0], after[1])
    assert not np.array_equal(after[0], before[0]), "the move changed nothing"


@pytest.mark.parametrize("attr", list(CHANGES))
@pytest.mark.parametrize("base", ["perspective", "ortho"])
def test_each_attribute_change_projects_as_the_reference(attr, base):
    """Every attribute changed after construction, on a perspective and
    an orthographic camera: pixels, depths and NDC equal the JAX
    package's, the matrices too, and the NDC differ from the unchanged
    camera's (the change took effect; an orthographic camera has no focal
    length or sensor)."""
    if attr == "ortho_scale" and base == "perspective":
        extra = {}  # turning a pinhole camera orthographic
    else:
        extra = {"ortho_scale": 5.0} if base == "ortho" else {}
    kw = dict(eye=(6.0, -6.0, 4.0), target=(0, 0, 0), shape=(48, 64), **extra)
    port, ref = TC.Camera.look_at(**kw), JC.Camera.look_at(**kw)
    pts = _points(1)
    old = port.world_to_ndc(pts)[0]
    for cam in (port, ref):
        setattr(cam, attr, CHANGES[attr])
    for origin in ("upper-left", "lower-left"):
        p_px, p_d = port.world_to_pixel(pts, origin=origin, return_depth=True)
        r_px, r_d = ref.world_to_pixel(pts, origin=origin, return_depth=True)
        np.testing.assert_allclose(p_px, r_px, **TOL)
        np.testing.assert_allclose(p_d, r_d, **TOL)
    np.testing.assert_allclose(port.world_to_ndc(pts)[0],
                               ref.world_to_ndc(pts)[0], **TOL)
    np.testing.assert_allclose(port.view_matrix, ref.view_matrix, **TOL)
    np.testing.assert_allclose(port.proj_matrix, ref.proj_matrix, **TOL)
    if not (base == "ortho" and attr in ("focal_mm", "sensor_mm")):
        assert not np.allclose(port.world_to_ndc(pts)[0], old)


@pytest.mark.parametrize("native", [True, False], ids=["cpp", "numpy"])
@pytest.mark.parametrize("attr", list(CHANGES))
def test_each_attribute_change_renders_as_the_reference(native, attr):
    """The rasterizer's frame after each change, bit for bit against the
    JAX package's on the same path, into the same buffer as before the
    change (the dirty-rect clear spans the old and the new cube)."""
    kw = dict(eye=(6.0, -6.0, 4.0), target=(0, 0, 0), shape=(48, 64))
    if attr == "shape":
        # the rasterizer takes a camera of its own shape: both change
        kw["shape"] = CHANGES["shape"]
    cams = (TC.Camera.look_at(**kw), JC.Camera.look_at(**kw))
    tris, colors = _cube(2)
    shape = cams[0].shape
    port = TS.Rasterizer(shape=shape, native=native)
    ref = _jax_raster(shape, native)
    bufs = [np.empty((*shape, 4), np.uint8) for _ in range(2)]
    port.render(cams[0], tris, colors, out=bufs[0])
    ref.render(cams[1], tris, colors, out=bufs[1])
    np.testing.assert_array_equal(bufs[0], bufs[1])
    if attr != "shape":
        for cam in cams:
            setattr(cam, attr, CHANGES[attr])
    port.render(cams[0], tris, colors, out=bufs[0])
    ref.render(cams[1], tris, colors, out=bufs[1])
    np.testing.assert_array_equal(bufs[0], bufs[1])


# -- the eight cases of tests/test_camera.py, on both packages ---------------


def _ortho(C, U):
    cam = C.Camera(position=(0, 0, 10), rotation=np.eye(3), shape=(100, 100),
                   ortho_scale=4.0)
    px, depth = cam.world_to_pixel(
        [[0, 0, 0], [1, 0, 0], [0, 1, 0], [-1, -1, 0]], return_depth=True)
    np.testing.assert_allclose(px, [[50, 50], [75, 50], [50, 25], [25, 75]],
                               atol=1e-6)
    np.testing.assert_allclose(depth, [10, 10, 10, 10], atol=1e-9)
    return [px, depth]


def _perspective(C, U):
    f, s = 50.0, 36.0
    cam = C.Camera(position=(0, 0, 5), shape=(100, 100), focal_mm=f,
                   sensor_mm=s)
    px, depth = cam.world_to_pixel([[0, 0, 0], [1, 0, 0]], return_depth=True)
    np.testing.assert_allclose(px[0], [50, 50], atol=1e-6)
    np.testing.assert_allclose(px[1, 0], (2 * f / s / 5.0 + 1) * 50,
                               atol=1e-6)
    np.testing.assert_allclose(depth, [5, 5], atol=1e-9)
    px2 = cam.world_to_pixel([[1, 0, -5]])
    assert abs(px2[0, 0] - 50) < abs(px[1, 0] - 50)
    return [px, depth, px2]


def _lower_left(C, U):
    cam = C.Camera(position=(0, 0, 10), shape=(100, 200), ortho_scale=4.0)
    ul = cam.world_to_pixel([[0, 0.5, 0]], origin="upper-left")
    ll = cam.world_to_pixel([[0, 0.5, 0]], origin="lower-left")
    np.testing.assert_allclose(ul[0, 1] + ll[0, 1], 100, atol=1e-6)
    assert ll[0, 1] > 50
    return [ul, ll]


def _look_at(C, U):
    eye = np.array([4.0, -7.0, 3.0])
    cam = C.Camera.look_at(eye=eye, target=(0, 0, 0), shape=(200, 300))
    px, depth = cam.world_to_pixel([[0, 0, 0]], return_depth=True)
    np.testing.assert_allclose(px[0], [150, 100], atol=1e-6)
    np.testing.assert_allclose(depth[0], np.linalg.norm(eye), atol=1e-9)
    np.testing.assert_allclose(cam.rotation @ cam.rotation.T, np.eye(3),
                               atol=1e-12)
    return [px, depth, cam.rotation]


def _bbox(C, U):
    cam = C.Camera(position=(0, 0, 10), shape=(100, 100), ortho_scale=4.0)
    bbox = cam.bbox_world_to_pixel([[-1, -1, 0], [1, 1, 0], [0, 0, 0]])
    np.testing.assert_allclose(bbox, [25, 25, 75, 75], atol=1e-6)
    return [bbox, cam.bbox_world_to_pixel([[-1, -1, 0], [1, 1, 0]],
                                          origin="lower-left")]


def _hom_dehom(C, U):
    x = np.random.default_rng(0).normal(size=(7, 3))
    np.testing.assert_allclose(U.dehom(U.hom(x)), x, atol=1e-12)
    return [U.hom(x), U.hom(x, value=2.5), U.dehom(U.hom(x, value=2.0))]


def _spherical(C, U):
    rng = np.random.default_rng(1)
    center = np.array([1.0, 2.0, 3.0])
    out = []
    for _ in range(50):
        p = U.random_spherical_loc(radius_range=(2, 3), center=center,
                                   rng=rng)
        assert 2 - 1e-9 <= np.linalg.norm(p - center) <= 3 + 1e-9
        out.append(p)
    return out


def _degenerate_up(C, U):
    m = U.look_at_matrix((0, 0, 5), (0, 0, 0), up=(0, 0, 1))
    assert np.isfinite(m).all()
    np.testing.assert_allclose(m @ m.T, np.eye(3), atol=1e-9)
    return [m, U.look_at_matrix((0, 0, -5), (0, 0, 0), up=(0, 0, 1))]


CASES = {f.__name__[1:]: f for f in (
    _ortho, _perspective, _lower_left, _look_at, _bbox, _hom_dehom,
    _spherical, _degenerate_up)}


@pytest.mark.parametrize("case", list(CASES))
def test_camera_cases_match_the_reference(case):
    port = CASES[case](TC, TU)
    ref = CASES[case](JC, JU)
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a, b, **TOL)


def test_coincident_eye_and_target_raise():
    """The port raises ``ValueError`` where the JAX package asserts (an
    ``assert`` vanishes under ``python -O``)."""
    with pytest.raises(ValueError, match="coincide"):
        TU.look_at_matrix((1, 2, 3), (1, 2, 3))
    with pytest.raises(ValueError, match="origin"):
        TC.Camera().ndc_to_pixel([[0, 0]], origin="center")
