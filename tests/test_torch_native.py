"""The producers' host C++ (``blendjax_torch/_native``) against the JAX
package's, byte for byte, on the CPU.

- Render: the port's ``bjt_render_frame`` against the JAX package's
  ``bjx_render_frame`` (``blendjax._native.load_render_frame``), and the
  port's numpy twin against the JAX numpy path, on the same scenes and
  seeds for several consecutive frames into one buffer (the dirty-rect
  clears) and into the internal buffer. C++ is compared with C++ and numpy
  with numpy: the two paths differ by rounding at triangle-edge pixels.
- Scan: the port's ``bjt_tile_delta`` against the JAX native and the JAX
  numpy encoder, with and without the rasterizer's hint, at (16, 32) and
  16x16 tiles, for C = 3 and 4.
- Palettizer: the port's ``bjt_palettize`` against the JAX native one
  (indices, palette order, count, misses past capacity), the port's numpy
  twin against the JAX numpy one, and the port's C++ against the JAX numpy
  path on what both decode to (the numpy paths number colours by value,
  the C++ ones by first sight).

Tolerance: none; every comparison is ``array_equal``.
"""

import numpy as np
import pytest

import blendjax._native as JN
from blendjax.ops import tiles as JT
from blendjax.producer import camera as JC
from blendjax.producer import sim as JS
from blendjax_torch.ops import tiles as T
from blendjax_torch.producer import camera as TC
from blendjax_torch.producer import sim as TS

FRAMES = 6  # consecutive frames per scene: the first clears everything


def _jax_raster(raster, native: bool):
    """A JAX-package rasterizer on its C++ path (which must have built) or
    on its numpy path."""
    if native:
        assert raster._native_frame is not None, "the JAX C++ did not build"
    else:
        raster._native_frame = None
    return raster


@pytest.mark.parametrize("native", [True, False], ids=["cpp", "numpy"])
@pytest.mark.parametrize("shape,seed,half", [
    ((480, 640), 0, 1.0),   # the smoke legs' frames
    ((64, 96), 3, 1.0),
    ((120, 160), 7, 2.5),   # a cube that fills and leaves the frame
])
@pytest.mark.parametrize("into", ["buffer", "internal"])
def test_cube_frames_match_jax(native, shape, seed, half, into):
    port = TS.CubeScene(shape=shape, seed=seed, half_extent=half,
                        native=native)
    ref = JS.CubeScene(shape=shape, seed=seed, half_extent=half)
    _jax_raster(ref.raster, native)
    np.testing.assert_array_equal(port.background_image(),
                                  ref.background_image())
    a = np.empty((*shape, 4), np.uint8)
    b = np.empty((*shape, 4), np.uint8)
    for frame in range(1, FRAMES + 1):
        port.step(frame)
        ref.step(frame)
        if into == "buffer":
            got, want = port.render(out=a), ref.render(out=b)
            assert got is a and want is b
        else:
            got, want = port.render(), ref.render()
        np.testing.assert_array_equal(got, want, err_msg=f"frame {frame}")
        assert port.raster.last_drawn == ref.raster.last_drawn


def _triangles(rng, n):
    """Random triangles around the origin; some cross the near plane or
    leave the frame."""
    centers = rng.uniform(-4, 4, (n, 1, 3))
    return centers + rng.uniform(-2.5, 2.5, (n, 3, 3))


@pytest.mark.parametrize("native", [True, False], ids=["cpp", "numpy"])
@pytest.mark.parametrize("channels", [3, 4])
def test_random_triangles_match_jax(native, channels):
    """Overlapping triangles (the z-buffer), near-plane culls, colours with
    and without alpha, a background that is not black, one buffer over
    several renders and then a new buffer (a full clear)."""
    rng = np.random.default_rng(11)
    shape = (72, 104)
    kw = dict(eye=(3.0, -3.0, 2.0), target=(0, 0, 0), shape=shape)
    port_cam, ref_cam = TC.Camera.look_at(**kw), JC.Camera.look_at(**kw)
    bg = (10, 20, 30, 200)
    port = TS.Rasterizer(shape, background=bg, native=native)
    ref = _jax_raster(JS.Rasterizer(shape, background=bg), native)
    a, b = (np.empty((*shape, 4), np.uint8) for _ in range(2))
    for i in range(5):
        n = int(rng.integers(1, 30))
        tris = _triangles(rng, n)
        cols = rng.integers(0, 256, (n, channels), dtype=np.uint8)
        if i == 3:  # a fresh pair of buffers
            a, b = (np.empty((*shape, 4), np.uint8) for _ in range(2))
        np.testing.assert_array_equal(port.render(port_cam, tris, cols, out=a),
                                      ref.render(ref_cam, tris, cols, out=b))
        assert port.last_drawn == ref.last_drawn


def test_the_cpp_render_refuses_what_it_does_not_take():
    port = TS.Rasterizer((32, 48))
    cam = TC.Camera.look_at(eye=(3.0, -3.0, 2.0), target=(0, 0, 0),
                            shape=(32, 48))
    tris = _triangles(np.random.default_rng(0), 2)
    with pytest.raises(ValueError, match="colors"):
        port.render(cam, tris, np.zeros((2, 3), np.float64))
    with pytest.raises(ValueError, match="colors"):
        port.render(cam, tris, np.zeros((3, 3), np.uint8))
    other = TC.Camera.look_at(eye=(3.0, -3.0, 2.0), target=(0, 0, 0),
                              shape=(64, 48))
    with pytest.raises(ValueError, match="camera shape"):
        port.render(other, tris, np.zeros((2, 3), np.uint8))
    with pytest.raises(ValueError, match="triangles"):
        port.render(cam, tris.reshape(2, 9), np.zeros((2, 3), np.uint8))
    with pytest.raises(ValueError, match="background"):
        TS.Rasterizer((32, 48), background=(0, 0, 0))


def _frames(n, shape, seed):
    """A random reference and ``n`` frames with a few repainted rectangles
    each, and the pixel rect that holds every change (the hint)."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 256, shape, dtype=np.uint8)
    out = []
    for i in range(n):
        f = ref.copy()
        y0, x0 = int(rng.integers(0, shape[0] - 20)), int(rng.integers(0, shape[1] - 40))
        y1, x1 = y0 + int(rng.integers(1, 20)), x0 + int(rng.integers(1, 40))
        if i == n - 1:  # an unchanged frame: no tile at all
            out.append((f, (y0, y1, x0, x1)))
            continue
        for _ in range(3):
            ya = int(rng.integers(y0, y1))
            xa = int(rng.integers(x0, x1))
            f[ya:y1, xa:x1, int(rng.integers(0, shape[2]))] ^= np.uint8(
                rng.integers(1, 256))
        out.append((f, (y0, y1, x0, x1)))
    return ref, out


@pytest.mark.parametrize("tile", [(16, 32), (16, 16)])
@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("hint", [True, False], ids=["hint", "no-hint"])
def test_tile_scan_matches_jax(tile, channels, hint):
    ref, frames = _frames(6, (64, 128, channels), seed=channels)
    port = T.TileDeltaEncoder(ref, tile=tile)
    port_np = T.TileDeltaEncoder(ref, tile=tile, native=False)
    jax_cpp = JT.TileDeltaEncoder(ref, tile=tile)
    assert jax_cpp._native is not None, "the JAX C++ did not build"
    jax_np = JT.TileDeltaEncoder(ref, tile=tile)
    jax_np._native = None
    for f, rect in frames:
        h = rect if hint else None
        idx, tiles = (a.copy() for a in port.encode(f, hint=h))
        for other in (jax_cpp, jax_np):
            oi, ot = other.encode(f, hint=h)
            np.testing.assert_array_equal(idx, oi)
            np.testing.assert_array_equal(tiles, ot)
        ni, nt = port_np.encode(f, hint=h)
        np.testing.assert_array_equal(ni, jax_np.encode(f, hint=h)[0])
        np.testing.assert_array_equal(nt, tiles)
        assert tiles.shape[1:] == (*tile, channels)


def test_tile_scan_of_a_strided_frame_matches_jax():
    """A frame that is a view (not C-contiguous) scans like a copy."""
    ref, frames = _frames(3, (64, 128, 4), seed=9)
    port = T.TileDeltaEncoder(ref[..., :3], tile=16)
    want = JT.TileDeltaEncoder(ref[..., :3], tile=16)
    want._native = None
    for f, _ in frames:
        idx, tiles = port.encode(f[..., :3])
        wi, wt = want.encode(f[..., :3])
        np.testing.assert_array_equal(idx, wi)
        np.testing.assert_array_equal(tiles, wt)


@pytest.fixture
def jax_numpy_palettizer(monkeypatch):
    """The JAX package's palettizer with its C++ switched off."""
    monkeypatch.setattr(JN, "load_palettize", lambda: None)
    return JT._palettize_flat


def _pixels(colors, channels, n, seed):
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 256, (colors, channels), dtype=np.uint8)
    return table[rng.integers(0, colors, n)]


@pytest.mark.parametrize("colors,cap", [
    (3, 256), (12, 256), (100, 256), (256, 256), (257, 256), (300, 256),
    (40, 40), (41, 40), (5, 4),
])
@pytest.mark.parametrize("channels", [3, 4])
def test_palettizer_matches_jax(jax_numpy_palettizer, colors, cap, channels):
    flat = _pixels(colors, channels, 4096, seed=colors * 10 + channels)
    assert JN.load_palettize() is None  # the fixture holds for the JAX side
    got = T._palettize_flat(flat, cap)
    got_np = T._palettize_flat(flat, cap, native=False)
    want_np = jax_numpy_palettizer(flat, cap)
    native = JN.build.load_palettize()
    assert native is not None, "the JAX C++ did not build"
    if colors > cap:
        assert got is None and got_np is None and want_np is None
        return
    # the JAX C++ palettizer, called as JT._palettize_flat calls it
    import ctypes

    u8 = ctypes.POINTER(ctypes.c_uint8)
    pal = np.zeros((cap, channels), np.uint8)
    idx = np.empty((len(flat),), np.uint8)
    count = native(flat.ctypes.data_as(u8), len(flat), channels, cap,
                   pal.ctypes.data_as(u8), idx.ctypes.data_as(u8))
    assert got[2] == count == colors
    np.testing.assert_array_equal(got[0], idx)  # first-sight order
    np.testing.assert_array_equal(got[1], pal)
    for a, b in zip(got_np[:2], want_np[:2]):  # value order
        np.testing.assert_array_equal(a, b)
    assert got_np[2] == want_np[2] == colors
    # C++ against the JAX numpy path: the same pixels back
    np.testing.assert_array_equal(got[1][got[0]], flat)
    np.testing.assert_array_equal(want_np[1][want_np[0]], flat)


@pytest.mark.parametrize("tile", [(16, 32), (16, 16)])
@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("colors", [3, 12, 100, 300])
def test_palettize_tiles_matches_jax(monkeypatch, tile, channels, colors):
    """``palettize_tiles``: C++ against the JAX C++ (packed bytes, palette,
    bits, misses), numpy against the JAX numpy path, and C++ against the
    JAX numpy path on the tiles both expand back to."""
    tiles = _pixels(colors, channels, 2 * 5 * tile[0] * tile[1],
                    seed=colors).reshape(2, 5, *tile, channels)
    got = T.palettize_tiles(tiles)
    want = JT.palettize_tiles(tiles)
    got_np = T.palettize_tiles(tiles, native=False)
    monkeypatch.setattr(JN, "load_palettize", lambda: None)
    want_np = JT.palettize_tiles(tiles)
    if colors > 256:
        assert got is want is got_np is want_np is None
        return
    for a, b in ((got, want), (got_np, want_np)):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2] == b[2]
    assert got[2] == want_np[2]
    for packed, pal, bits in (got, want_np):
        np.testing.assert_array_equal(
            T.expand_palette_tiles_np(packed, pal, bits, tile, channels),
            tiles)


def test_the_producer_batches_match_between_paths():
    """The tile publisher's messages from the C++ path and the numpy path
    hold the same tile indices and decode to the same tiles (frames from
    one renderer, so only the encoder differs)."""
    from blendjax_torch.producer import TileBatchPublisher

    class Capture:
        def __init__(self):
            self.msgs = []

        def publish(self, **msg):
            self.msgs.append(msg)

    scene = TS.CubeScene(shape=(64, 128), seed=4)
    caps = [Capture(), Capture()]
    pubs = [TileBatchPublisher(cap, scene.background_image(), 4,
                               tile=(16, 32), alpha_slice=False, capacity=24,
                               native=native)
            for cap, native in zip(caps, (True, False))]
    buf = np.empty((64, 128, 4), np.uint8)
    for frame in range(1, 13):
        scene.step(frame)
        scene.render(out=buf)
        for pub in pubs:
            pub.add(buf, hint=scene.raster.last_drawn, frameid=np.int64(frame))
    assert len(caps[0].msgs) == len(caps[1].msgs) == 3
    for a, b in zip(caps[0].msgs, caps[1].msgs):
        np.testing.assert_array_equal(a["image__tileidx"], b["image__tileidx"])
        tiles = []
        for msg in (a, b):
            bits = next(k for k, s in T.TILEPAL_SUFFIXES.items()
                        if "image" + s in msg)
            tiles.append(T.expand_palette_tiles_np(
                msg["image" + T.TILEPAL_SUFFIXES[bits]],
                msg["image" + T.PALETTE_SUFFIX], bits, (16, 32), 4))
        np.testing.assert_array_equal(tiles[0], tiles[1])
