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
    one renderer, so only the encoder differs). With full RGBA tiles the
    C++ path takes the fused per-frame palette form, whose padding slots
    (the sentinel index, dropped by the decoder) expand to palette colour
    0: only the changed tiles are compared."""
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
    assert pubs[0]._fused_ok and not pubs[1]._fused_ok
    for a, b in zip(caps[0].msgs, caps[1].msgs):
        np.testing.assert_array_equal(a["image__tileidx"], b["image__tileidx"])
        valid = a["image__tileidx"] < pubs[0].encoder.num_tiles
        tiles = []
        for msg in (a, b):
            bits = next(k for k, s in T.TILEPAL_SUFFIXES.items()
                        if "image" + s in msg)
            tiles.append(T.expand_palette_tiles_np(
                msg["image" + T.TILEPAL_SUFFIXES[bits]],
                msg["image" + T.PALETTE_SUFFIX], bits, (16, 32), 4)[valid])
        np.testing.assert_array_equal(tiles[0], tiles[1])


# -- the fused scan + per-frame palettizer (Queue A item 1) -----------------------


def _palidx_frames(shape, channels, n=5, seed=0):
    """Cube frames, then a frame of more than 256 colours in the cube's
    rect, then cube frames again."""
    scene = TS.CubeScene(shape=shape, seed=seed)
    rng = np.random.default_rng(seed)
    buf = np.empty((*shape, 4), np.uint8)
    frames = []
    for f in range(1, n + 1):
        scene.step(f)
        scene.render(out=buf)
        frame = buf[..., :channels].copy()
        rect = scene.raster.last_drawn
        if f == 3:  # outside the drawn rect: no scan hint for this frame
            frame[:16, :32] = rng.integers(0, 256, (16, 32, channels))
            rect = None
        frames.append((frame, rect))
    return np.ascontiguousarray(scene.background_image()[..., :channels]), \
        frames


def _table(c):
    return {"keys": np.zeros(1024, np.uint32),
            "vals": np.full(1024, -1, np.int16),
            "table": np.zeros((256, c), np.uint8),
            "count": np.zeros(1, np.int64)}


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("cap", [256, 16, 4])
@pytest.mark.parametrize("reset", [True, False], ids=["per-frame", "kept"])
def test_fused_scan_matches_jax(channels, cap, reset):
    """bjt_tile_delta_palidx against the JAX package's bjx_tile_delta_palidx
    on the same frames: the count (-1 past ``cap`` colours), the tile
    indices, the palette indices and the whole colour table (keys, slots,
    colours, count) after every call, with the table reset per frame or
    kept across frames."""
    from blendjax_torch._native import tile_delta_palidx

    jfn = JN.load_tile_delta_palidx()
    assert jfn is not None, "the JAX C++ did not build"
    fn = tile_delta_palidx()
    h, w, th, tw = 64, 128, 16, 32
    ref, frames = _palidx_frames((h, w), channels)
    n = (h // th) * (w // tw)
    tables = [_table(channels), _table(channels)]
    outs = [(np.zeros(n, np.int32), np.zeros((n, th * tw), np.uint8))
            for _ in range(2)]
    seen_miss = False
    for frame, _hint in frames:
        counts = []
        for f, t, (idx, pal) in zip((fn, jfn), tables, outs):
            if reset:
                t["vals"].fill(-1)
                t["count"][0] = 0
            counts.append(f(
                frame.ctypes.data, ref.ctypes.data, h, w, channels, th, tw,
                0, h // th, 0, w // tw, idx.ctypes.data, pal.ctypes.data,
                t["keys"].ctypes.data, t["vals"].ctypes.data,
                t["table"].ctypes.data, t["count"].ctypes.data, cap))
        assert counts[0] == counts[1]
        seen_miss |= counts[0] < 0
        for key in ("keys", "vals", "table", "count"):
            np.testing.assert_array_equal(tables[0][key], tables[1][key])
        k = counts[0]
        if k >= 0:
            np.testing.assert_array_equal(outs[0][0][:k], outs[1][0][:k])
            np.testing.assert_array_equal(outs[0][1][:k], outs[1][1][:k])
    assert seen_miss  # the >256-colour frame misses at every cap


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("tile", [(16, 32), (16, 16)])
@pytest.mark.parametrize("hint", [True, False], ids=["hint", "no-hint"])
def test_encode_palidx_matches_the_jax_encoder(channels, tile, hint):
    """TileDeltaEncoder.encode_palidx, palette and palette_count against
    the JAX encoder's, frame by frame with a reset per frame; both return
    None on the frame of more than 256 colours."""
    ref, frames = _palidx_frames((64, 128), channels)
    port = T.TileDeltaEncoder(ref, tile)
    jax_enc = JT.TileDeltaEncoder(ref, tile=tile)
    assert port.palidx_available() and jax_enc.palidx_available()
    nones = 0
    for frame, rect in frames:
        port.reset_palette()
        jax_enc.reset_palette()
        kw = {"hint": rect if hint and rect is not None else None}
        a, b = port.encode_palidx(frame, **kw), jax_enc.encode_palidx(frame,
                                                                      **kw)
        assert (a is None) == (b is None)
        if a is None:
            nones += 1
            continue
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        assert port.palette_count == jax_enc.palette_count > 0
        np.testing.assert_array_equal(port.palette, jax_enc.palette)
    assert nones == 1
    assert not T.TileDeltaEncoder(ref, tile, native=False).palidx_available()


class _Capture:
    def __init__(self):
        self.msgs = []

    def publish(self, **msg):
        self.msgs.append(msg)


@pytest.mark.parametrize("channels,alpha_slice", [(4, False), (3, True)])
@pytest.mark.parametrize("tile", [(16, 32), (16, 16)])
@pytest.mark.parametrize("rich", [(), (3,), range(3, 14)],
                         ids=["cube", "one-miss", "latch"])
def test_fused_publisher_messages_match_jax(channels, alpha_slice, tile,
                                            rich):
    """The port's TileBatchPublisher against the JAX package's on the same
    cube frames: every message key for key, with the same dtypes, shapes
    and bytes. It takes the fused path where the reference does (full
    channels, or an RGB stream under alpha slicing); a frame of more than
    256 colours turns its batch raw (the rows already indexed expanded
    through their own palettes), and eight such batches latch the fused
    path off on both."""
    from blendjax.producer.tile_publisher import TileBatchPublisher as JPub
    from blendjax_torch.producer import TileBatchPublisher

    scene = TS.CubeScene(shape=(64, 128), seed=2)
    rng = np.random.default_rng(1)
    buf = np.empty((64, 128, 4), np.uint8)
    frames = []
    for f in range(1, 61):
        scene.step(f)
        scene.render(out=buf)
        frame = buf[..., :channels].copy()
        rect = scene.raster.last_drawn
        if f // 4 in rich and f % 4 == 2:  # the batch's second row
            frame[:16, :32] = rng.integers(0, 256, (16, 32, channels))
            rect = None  # outside the drawn rect: no scan hint
        frames.append((frame, rect))
    bg = np.ascontiguousarray(scene.background_image()[..., :channels])
    caps = [_Capture(), _Capture()]
    pubs = [cls(cap, bg, 4, tile=tile, alpha_slice=alpha_slice, capacity=8,
                ref_interval=5)
            for cls, cap in ((TileBatchPublisher, caps[0]), (JPub, caps[1]))]
    assert pubs[0]._fused_ok and pubs[1]._fused_ok
    for i, (frame, rect) in enumerate(frames):
        for pub in pubs:
            pub.add(frame, hint=rect, xy=np.full((8, 2), i, np.float32),
                    frameid=np.int64(i))
    for pub in pubs:
        pub.flush()
    assert pubs[0]._fused_ok == pubs[1]._fused_ok == (len(rich) < 8)
    assert len(caps[0].msgs) == len(caps[1].msgs) == 15
    forms = set()
    for a, b in zip(*(c.msgs for c in caps)):
        assert sorted(a) == sorted(b)
        for k, v in a.items():
            if isinstance(v, np.ndarray):
                assert v.dtype == b[k].dtype and v.shape == b[k].shape, k
                assert v.tobytes() == b[k].tobytes(), k
            else:
                assert v == b[k], k
        forms.add("raw" if "image__tiles" in a else
                  "per-frame" if a["image__palette"].ndim == 3 else "batch")
    assert "per-frame" in forms and (("raw" in forms) == bool(rich))
