"""Tile-delta codec parity: blendjax_torch against the JAX package.

Inputs come from a numpy seed and go through both packages on the CPU.
The JAX side runs its Pallas decode kernels in interpret mode (as
tests/test_tiles.py does); the port's side runs the kernels' plain twins,
which its wrappers take for CPU tensors. Tolerance: bit-exact everywhere
(uint8 frames, packed bytes, unpacked fields).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blendjax.ops import tiles as JT
from blendjax_torch.ops import tiles as T

SHAPE = (64, 128, 4)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """At most two torch threads: the suite runs six workers on eight
    cores beside timing-sensitive tests of the JAX package."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _frames(n, shape=SHAPE, seed=0, rgb_only=False):
    """A random reference plus ``n`` frames with a few repainted
    rectangles each (alpha untouched with ``rgb_only``)."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 256, shape, dtype=np.uint8)
    frames = []
    for _ in range(n):
        f = ref.copy()
        for _ in range(3):
            y0, x0 = rng.integers(0, shape[0] - 8), rng.integers(0, shape[1] - 8)
            y1, x1 = y0 + rng.integers(2, 20), x0 + rng.integers(2, 40)
            c = 3 if rgb_only else shape[2]
            f[y0:y1, x0:x1, :c] = rng.integers(0, 256, c, dtype=np.uint8)
        frames.append(f)
    return ref, frames


def _encode(ref, frames, tile, capacity=None):
    """Port encoder vs the JAX package's numpy encoder: same deltas."""
    enc = T.TileDeltaEncoder(ref, tile=tile)
    jenc = JT.TileDeltaEncoder(ref, tile=tile)
    jenc._native = None
    deltas = []
    for f in frames:
        fi, ft = (a.copy() for a in enc.encode(f))
        ji, jt = jenc.encode(f)
        np.testing.assert_array_equal(fi, ji)
        np.testing.assert_array_equal(ft, jt)
        deltas.append((fi, ft))
    idx, tiles = T.pack_batch(deltas, enc.num_tiles, capacity=capacity)
    jidx, jtiles = JT.pack_batch(deltas, enc.num_tiles, capacity=capacity)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(tiles, jtiles)
    return idx, tiles


def _both(ref, idx, tiles, tile, use_pallas=True):
    """(JAX decode, port decode, host numpy decode) of one batch."""
    rt = JT.tile_ref(ref, tile)
    want = np.asarray(JT.decode_tile_delta(
        rt, jnp.asarray(idx), jnp.asarray(tiles), ref.shape,
        use_pallas=use_pallas,
    ))
    got = T.decode_tile_delta(
        T.tile_ref(torch.from_numpy(ref), tile), torch.from_numpy(idx),
        torch.from_numpy(tiles), ref.shape,
    ).numpy()
    return want, got, T.decode_tile_delta_np(ref, idx, tiles)


@pytest.mark.parametrize("tile,rgb_only,channels", [
    ((16, 32), False, 4),   # flagship: K1
    ((16, 16), False, 4),   # square: K2
    ((16, 32), True, 3),    # Ct < C through K1
    ((16, 16), True, 3),    # Ct < C through K2
    ((8, 32), False, 4),    # another rectangle: K1
])
def test_decode_matches_jax_pallas(tile, rgb_only, channels):
    ref, frames = _frames(5, seed=3, rgb_only=rgb_only)
    idx, tiles = _encode(ref, frames, tile)
    tiles = np.ascontiguousarray(tiles[..., :channels])
    want, got, host = _both(ref, idx, tiles, tile)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, host)
    for i, f in enumerate(frames):
        np.testing.assert_array_equal(got[i], f)


@pytest.mark.parametrize("tile", [(16, 32), (16, 16)])
def test_decode_sentinel_rows_and_empty_capacity(tile):
    """A row of sentinels and K == 0 both give the reference frames."""
    rng = np.random.default_rng(29)
    ref = rng.integers(0, 256, SHAPE, dtype=np.uint8)
    n = (SHAPE[0] // tile[0]) * (SHAPE[1] // tile[1])
    idx = np.full((3, 4), n, np.int32)
    idx[0, :2] = [1, 5]
    tiles = rng.integers(0, 256, (3, 4, *tile, 4), dtype=np.uint8)
    want, got, _ = _both(ref, idx, tiles, tile)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[1], ref)
    idx0 = np.empty((3, 0), np.int32)
    tiles0 = np.empty((3, 0, *tile, 4), np.uint8)
    # the JAX package's K == 0 shortcut lives in its spatial kernel; the
    # square geometry is compared against its XLA scatter path
    want0, got0, _ = _both(ref, idx0, tiles0, tile,
                           use_pallas=tile[0] != tile[1] or None)
    np.testing.assert_array_equal(got0, want0)
    for i in range(3):
        np.testing.assert_array_equal(got0[i], ref)


@pytest.mark.parametrize("case", [
    "dense", "sentinel row", "K > one block's slot run", "negative -1",
    "out of range",
])
def test_decode_scatter_matches_the_pallas_kernel(case):
    """K2 (its plain twin on the CPU) against ``_pallas_decode_scatter`` in
    interpret mode: slots (B, N, th*tw*C), bit-exact. Index rows hold up
    to K = 40 distinct slots of N = 32 (more than the 16 slots one block
    of the CUDA kernel owns), sentinels N, -1 and indices past N; each
    writes nothing. (The interpret-mode Pallas kernel stores into a padded
    (B, N + 1) buffer, so -1 lands in its pad slot; a deeper negative
    would wrap into a real slot there and is held to the port's contract
    in the next test instead.)"""
    from blendjax_torch.kernels.decode import decode_scatter

    rng = np.random.default_rng(41)
    tile = (16, 16)
    n = (SHAPE[0] // tile[0]) * (SHAPE[1] // tile[1])  # 32 slots
    k = 40 if case == "K > one block's slot run" else 12
    ref = rng.integers(0, 256, (n, *tile, 4), dtype=np.uint8)
    idx = np.full((3, k), n, np.int32)
    for row in range(3):
        m = min(k, n) if case == "K > one block's slot run" else 9
        idx[row, :m] = rng.choice(n, m, replace=False)
    if case == "sentinel row":
        idx[1] = n
    elif case == "negative -1":
        idx[:, 9:] = -1
    elif case == "out of range":
        idx[:, 9:] = [n + 1, 2 * n, 2**31 - 1]
    tiles = rng.integers(0, 256, (3, k, *tile, 4), dtype=np.uint8)
    want = np.asarray(JT._pallas_decode_scatter(
        jnp.asarray(ref), jnp.asarray(idx), jnp.asarray(tiles),
        interpret=True))
    got = decode_scatter(torch.from_numpy(ref), torch.from_numpy(idx),
                         torch.from_numpy(tiles)).numpy()
    assert got.shape == (3, n, 16 * 16 * 4)
    np.testing.assert_array_equal(got, want)


def test_decode_scatter_negative_indices_write_nothing():
    """Any index outside [0, N) leaves its slot's reference tile in place."""
    from blendjax_torch.kernels.decode import decode_scatter

    rng = np.random.default_rng(43)
    n = 32
    ref = rng.integers(0, 256, (n, 16, 16, 4), dtype=np.uint8)
    idx = np.array([[3, -2, -n, -(2**31), 7], [-5, 0, n, -1, 31]], np.int32)
    tiles = rng.integers(0, 256, (2, 5, 16, 16, 4), dtype=np.uint8)
    got = decode_scatter(torch.from_numpy(ref), torch.from_numpy(idx),
                         torch.from_numpy(tiles)).numpy()
    want = np.broadcast_to(ref.reshape(1, n, -1), (2, n, 1024)).copy()
    for b, row in enumerate(idx):
        for j, s in enumerate(row):
            if 0 <= s < n:
                want[b, s] = tiles[b, j].reshape(-1)
    np.testing.assert_array_equal(got, want)


def test_encoder_rows_hold_unique_indices():
    """Duplicate indices within a row are outside the kernels' contract;
    the encoder and pack_batch never produce them."""
    ref, frames = _frames(6, seed=5)
    enc = T.TileDeltaEncoder(ref, tile=(16, 32))
    deltas = [tuple(a.copy() for a in enc.encode(f)) for f in frames]
    idx, _ = T.pack_batch(deltas, enc.num_tiles)
    for row in idx:
        real = row[row < enc.num_tiles]
        assert len(np.unique(real)) == len(real)
        assert (np.diff(real) > 0).all()


@pytest.mark.parametrize("colors,bits", [(3, 2), (12, 4), (100, 8)])
def test_palette_tiles_match_jax(colors, bits):
    rng = np.random.default_rng(colors)
    table = rng.integers(0, 256, (colors, 4), dtype=np.uint8)
    tiles = table[rng.integers(0, colors, (2, 3, 16, 32))]
    packed, pal, got_bits = T.palettize_tiles(tiles)
    assert got_bits == bits
    assert JT.palettize_tiles(tiles)[2] == bits
    want = np.asarray(JT.expand_palette_tiles(
        jnp.asarray(packed), jnp.asarray(pal), bits, (16, 32), 4
    ))
    got = T.expand_palette_tiles(
        torch.from_numpy(packed), torch.from_numpy(pal), bits, (16, 32), 4
    ).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tiles)
    # per-row palettes over a stacked chunk axis (the JAX vmap case)
    pals = np.stack([pal, pal[::-1].copy()])
    packs = np.stack([packed, packed])
    want = np.asarray(JT.expand_palette_tiles(
        jnp.asarray(packs), jnp.asarray(pals), bits, (16, 32), 4
    ))
    got = T.expand_palette_tiles(
        torch.from_numpy(packs), torch.from_numpy(pals), bits, (16, 32), 4
    ).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("colors", [4, 16, 200])
def test_palette_frames_match_jax(colors):
    rng = np.random.default_rng(colors + 1)
    table = rng.integers(0, 256, (colors, 4), dtype=np.uint8)
    frames = table[rng.integers(0, colors, (3, 16, 24))]
    packed, pal, bits = T.palettize_frames(frames)
    # the JAX package's native palettizer orders colours by first sight,
    # the numpy one by value: same width, same frames, other indices
    assert JT.palettize_frames(frames)[2] == bits
    want = np.asarray(JT.expand_palette_frames(
        jnp.asarray(packed), jnp.asarray(pal), bits, 16, 24, 4
    ))
    got = T.expand_palette_frames(
        torch.from_numpy(packed), torch.from_numpy(pal), bits, 16, 24, 4
    ).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, frames)


def test_rle_ndr_group_matches_jax():
    rng = np.random.default_rng(7)
    plane = np.repeat(rng.integers(0, 4, (6, 40), dtype=np.uint8), 9, axis=1)
    buf, cap, isz = T.rle_encode_rows(plane)
    jbuf, jcap, jisz = JT.rle_encode_rows(plane)
    np.testing.assert_array_equal(buf, jbuf)
    assert (cap, isz) == (jcap, jisz)
    want = np.asarray(JT.rle_expand_packed(jnp.asarray(buf), plane.shape,
                                           isz, cap))
    got = T.rle_expand_packed(torch.from_numpy(buf), plane.shape, isz,
                              cap).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, plane)
    # pixel runs (isz = 4) over a stacked chunk axis
    px = np.repeat(rng.integers(0, 256, (2, 5, 4), dtype=np.uint8), 7, axis=1)
    buf, cap, isz = T.rle_encode_rows(px)
    assert isz == 4
    stacked = torch.from_numpy(np.stack([buf, buf]))
    got = T.rle_expand_packed(stacked, px.shape, isz, cap).numpy()
    np.testing.assert_array_equal(got, np.stack([px, px]))


def _fields(rng):
    return {
        "odd": rng.integers(0, 256, (7,), dtype=np.uint8),  # misaligns
        "idx": rng.integers(-5, 100, (3, 5)).astype(np.int32),
        "big": rng.integers(-(2**30), 2**30, (4,)),          # int64 -> int32
        "xy": rng.normal(size=(3, 8, 2)).astype(np.float32),
        "f64": rng.normal(size=(5,)),                        # -> float32
        "flag": np.array([True, False, True]),
        "u16": rng.integers(0, 60000, (3,)).astype(np.uint16),
    }


def test_pack_and_unpack_fields_match_jax():
    rng = np.random.default_rng(11)
    fields = _fields(rng)
    buf, spec = T.pack_fields(fields)
    jbuf, jspec = JT.pack_fields(fields)
    np.testing.assert_array_equal(buf, jbuf)
    assert spec == jspec
    want = JT.unpack_fields(jnp.asarray(buf), spec)
    got = T.unpack_fields(torch.from_numpy(buf), spec)
    for k in fields:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # stacked (K', total) groups, as the fused step unpacks them
    buf2, _ = T.pack_fields(_fields(np.random.default_rng(12)))
    stacked = np.stack([buf, buf2])
    want = jax.vmap(lambda p: JT.unpack_fields(p, spec))(jnp.asarray(stacked))
    got = T.unpack_fields(torch.from_numpy(stacked), spec)
    for k in fields:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_pack_fields_narrowing_is_range_checked():
    with pytest.raises(ValueError, match="do not fit"):
        T.pack_fields({"t": np.array([2**40])})


class _Capture:
    def __init__(self):
        self.msgs = []

    def publish(self, **msg):
        self.msgs.append(msg)


def _recorded_group(tile, k=2, rle=False, flat=False):
    """K messages of the port's publisher, packed and stacked as the
    pipeline's host stage does, with their decode plan. ``flat`` draws
    few-colour frames, so the tiles ride as 2-bit palette indices."""
    from blendjax_torch.producer import TileBatchPublisher
    from blendjax_torch.transport import wire

    ref, frames = _frames(4 * k, seed=17)
    if flat:
        rng = np.random.default_rng(18)
        colors = rng.integers(0, 256, (3, 4), dtype=np.uint8)
        ref[:] = colors[0]
        for f in frames:
            f[:] = colors[0]
            y, x = rng.integers(0, SHAPE[0] - 20), rng.integers(0, SHAPE[1] - 40)
            f[y:y + 20, x:x + 40] = colors[1]
            f[y + 5:y + 10, x:x + 10] = colors[2]
    cap = _Capture()
    n = (SHAPE[0] // tile[0]) * (SHAPE[1] // tile[-1])
    tp = TileBatchPublisher(cap, ref, 4, tile=tile, alpha_slice=False,
                            capacity=n)
    for i, f in enumerate(frames):
        tp.add(f, xy=np.full((8, 2), i, np.float32), frameid=np.int64(i))
    bufs = []
    for msg in cap.msgs:
        msg = wire.decode_message(
            wire.encode_message(msg, compress_rle=rle, compress_min_bytes=64,
                                rle_cap=512),
            defer_rle=True,
        )
        msg.pop("_prebatched")
        T.pop_stream_refs(msg, {}, None)
        (name, geom), = T.pop_tile_batches(msg)
        rle_groups = T.pop_rle_batches(msg)
        buf, spec = T.pack_fields(msg)
        bufs.append(buf)
    return ref, frames, np.stack(bufs), spec, geom, rle_groups


@pytest.mark.parametrize("tile,rle,flat", [
    ((16, 32), False, False), ((16, 16), False, False),
    ((16, 32), False, True), ((16, 32), True, True),
])
def test_decode_packed_superbatch_matches_jax(tile, rle, flat):
    ref, frames, packed, spec, geom, rle_groups = _recorded_group(
        tile, rle=rle, flat=flat
    )
    if flat:
        assert any(s[0].startswith("image__tilepal2") for s in spec)
    if rle:
        assert rle_groups, "the palette plane should ride as an ndr group"
    want = JT.decode_packed_superbatch(
        jnp.asarray(packed), {"image": JT.tile_ref(ref, tile)}, spec,
        ("image",), (geom,), rle_groups=rle_groups,
    )
    got = T.decode_packed_superbatch(
        torch.from_numpy(packed),
        {"image": T.tile_ref(torch.from_numpy(ref), tile)}, spec,
        ("image",), (geom,), rle_groups=rle_groups,
    )
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_array_equal(
        got["image"].numpy().reshape(-1, *ref.shape), np.stack(frames)
    )
