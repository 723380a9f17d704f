"""Lossless tile-delta encoding for image streams (port of ``blendjax/ops/tiles.py``).

Producers ship only the tiles of a frame that differ from a reference
image (the scene background); the consumer reconstructs exact frames on
the card. Two halves live here:

- **host half** (numpy only; producers import it without torch):
  :class:`TileDeltaEncoder`, :func:`pack_batch`, the palette and
  run-length ("ndr") codecs, :func:`pack_fields` and the message
  bookkeeping helpers. Copies of the JAX package's numpy paths.
- **device half** (torch, imported inside each function):
  :func:`unpack_fields`, :func:`rle_expand_packed`, the byte-LUT palette
  expands, :func:`tile_ref`, the packed decode entry points and
  :func:`decode_tile_delta`, which hands the frame reconstruction to the
  CUDA kernels of :mod:`blendjax_torch.kernels.decode`.

Wire convention (identical to the JAX package's): an image field
``name`` travels as ``name__tileidx`` (B, K) int32 with sentinel
``N = GH*GW`` for padding, ``name__tileshape`` ``[H, W, C, t]`` (square)
or ``[H, W, C, th, tw]``, and either raw ``name__tiles`` (B, K, th, tw,
Ct) or palette indices ``name__tilepal2/4/8`` plus ``name__palette``.
The reference rides once (or every Nth batch) as ``name__tileref``.
"""

from __future__ import annotations

import numpy as np

TILE = 32  # default tile side

TILEIDX_SUFFIX = "__tileidx"
TILES_SUFFIX = "__tiles"
TILESHAPE_SUFFIX = "__tileshape"
TILEREF_SUFFIX = "__tileref"
TILEPAL2_SUFFIX = "__tilepal2"
TILEPAL4_SUFFIX = "__tilepal4"
TILEPAL8_SUFFIX = "__tilepal8"
PALETTE_SUFFIX = "__palette"
FRAMEPAL2_SUFFIX = "__framepal2"
FRAMEPAL4_SUFFIX = "__framepal4"
FRAMEPAL8_SUFFIX = "__framepal8"
FRAMESHAPE_SUFFIX = "__frameshape"

FRAMEPAL_SUFFIXES = {
    2: FRAMEPAL2_SUFFIX, 4: FRAMEPAL4_SUFFIX, 8: FRAMEPAL8_SUFFIX,
}
TILEPAL_SUFFIXES = {
    2: TILEPAL2_SUFFIX, 4: TILEPAL4_SUFFIX, 8: TILEPAL8_SUFFIX,
}


# -- host half: geometry ------------------------------------------------------


def pack_palette_indices(idx, bits: int):
    """Pack uint8 palette indices along the last axis: 4 per byte for
    ``bits=2``, 2 per byte for ``bits=4`` (first index in the high bits),
    pass-through for ``bits=8``."""
    if bits == 2:
        return (
            (idx[..., 0::4] << 6) | (idx[..., 1::4] << 4)
            | (idx[..., 2::4] << 2) | idx[..., 3::4]
        )
    if bits == 4:
        return (idx[..., 0::2] << 4) | idx[..., 1::2]
    return idx


def unpack_palette_indices(packed, bits: int):
    """Inverse of :func:`pack_palette_indices` for numpy arrays."""
    lead = packed.shape[:-1]
    m = packed.shape[-1]
    if bits == 2:
        return np.stack(
            [packed >> 6, (packed >> 4) & 3, (packed >> 2) & 3, packed & 3],
            axis=-1,
        ).reshape(*lead, m * 4)
    if bits == 4:
        return np.stack([packed >> 4, packed & 0xF], axis=-1).reshape(
            *lead, m * 2
        )
    return packed


def tile_hw(tile):
    """Tile spec (an int side or a ``(rows, cols)`` pair) -> ``(th, tw)``."""
    if isinstance(tile, (tuple, list, np.ndarray)):
        if len(tile) != 2:
            raise ValueError(f"tile spec must be an int or (th, tw), got {tile!r}")
        return int(tile[0]), int(tile[1])
    return int(tile), int(tile)


def geom_tile(geom):
    """Wire geometry -> ``(th, tw)``: ``[h, w, c, t]`` or ``[h, w, c, th, tw]``."""
    if len(geom) >= 5:
        return int(geom[3]), int(geom[4])
    return int(geom[3]), int(geom[3])


def tileshape_wire(h, w, c, tile):
    """Geometry -> the wire ``__tileshape`` list (square tiles keep the
    4-element form)."""
    th, tw = tile_hw(tile)
    base = [int(h), int(w), int(c), th]
    return base if th == tw else base + [tw]


def tile_grid(shape, tile=TILE):
    """(H, W, C) image shape -> (GH, GW) tile grid; raises when the tile
    does not divide the image."""
    th, tw = tile_hw(tile)
    h, w = int(shape[0]), int(shape[1])
    if h % th or w % tw:
        raise ValueError(f"tile {th}x{tw} does not divide image {h}x{w}")
    return h // th, w // tw


# -- host half: encoder -------------------------------------------------------


class TileDeltaEncoder:
    """Per-stream encoder: images -> ``(idx, tiles)`` deltas against ``ref``.

    The changed-tile scan runs in the port's host C++
    (``blendjax_torch/_native/tiledelta.cpp`` ``bjt_tile_delta``, built at
    construction; a failed build raises). ``native=False`` runs the numpy
    twin, the numpy path of the JAX package's encoder: the same deltas.
    :meth:`encode_palidx` is the fused scan and palettizer
    (``bjt_tile_delta_palidx``), native only.
    """

    def __init__(self, ref: np.ndarray, tile=TILE, native: bool = True):
        ref = np.ascontiguousarray(ref)
        if ref.dtype != np.uint8 or ref.ndim != 3:
            raise ValueError(
                f"ref must be (H, W, C) uint8, got {ref.shape} {ref.dtype}"
            )
        self.ref = ref
        self.th, self.tw = tile_hw(tile)
        self.grid = tile_grid(ref.shape, (self.th, self.tw))
        self.num_tiles = self.grid[0] * self.grid[1]
        c = ref.shape[2]
        self._idx = np.empty((self.num_tiles,), np.int32)
        self._tiles = np.empty((self.num_tiles, self.th, self.tw, c), np.uint8)
        self.native = bool(native)
        self._pal_state = None  # the fused path's colour table, made lazily
        if self.native:
            from blendjax_torch._native import tile_delta

            self._scan = tile_delta()

    def tile_bounds(self, hint):
        """Pixel rect ``hint`` -> tile-grid scan bounds ``(ty0, ty1, tx0,
        tx1)`` (the full grid for ``hint=None``)."""
        th, tw = self.th, self.tw
        gh, gw = self.grid
        if hint is None:
            return 0, gh, 0, gw
        y0, y1, x0, x1 = hint
        return (
            max(y0 // th, 0), min(-(-y1 // th), gh),
            max(x0 // tw, 0), min(-(-x1 // tw), gw),
        )

    def encode(self, img: np.ndarray, hint=None):
        """One frame -> ``(idx int32[K], tiles uint8[K, th, tw, C])``,
        views into internal staging valid until the next call. ``hint``
        (a pixel rect ``(y0, y1, x0, x1)`` outside which the frame equals
        the reference) bounds the scan."""
        th, tw = self.th, self.tw
        gh, gw = self.grid
        if img.shape != self.ref.shape or img.dtype != np.uint8:
            raise ValueError(
                f"frame shape {img.shape}/{img.dtype} != ref "
                f"{self.ref.shape}/uint8"
            )
        ty0, ty1, tx0, tx1 = self.tile_bounds(hint)
        if ty0 >= ty1 or tx0 >= tx1:
            return self._idx[:0], self._tiles[:0]
        h, w, c = self.ref.shape
        if self.native:
            img = np.ascontiguousarray(img)
            k = self._scan(
                img.ctypes.data, self.ref.ctypes.data, h, w, c, th, tw,
                ty0, ty1, tx0, tx1, self._idx.ctypes.data,
                self._tiles.ctypes.data,
            )
            return self._idx[:k], self._tiles[:k]
        v = img.reshape(gh, th, gw, tw, c)
        r = self.ref.reshape(gh, th, gw, tw, c)
        sub = (v[ty0:ty1, :, tx0:tx1] != r[ty0:ty1, :, tx0:tx1]).any(
            axis=(1, 3, 4)
        )
        sy, sx = np.nonzero(sub)
        idx = ((sy + ty0) * gw + (sx + tx0)).astype(np.int32)
        k = len(idx)
        self._idx[:k] = idx
        self._tiles[:k] = v[idx // gw, :, idx % gw]
        return self._idx[:k], self._tiles[:k]


    # -- fused scan + palettize (native only) --------------------------------

    def palidx_available(self) -> bool:
        """Whether :meth:`encode_palidx` can run: the native path (its
        library builds, or the build raises) and at most 4 channels."""
        if not self.native or self.ref.shape[2] > 4:
            return False
        if getattr(self, "_palidx", None) is None:
            from blendjax_torch._native import tile_delta_palidx

            self._palidx = tile_delta_palidx()
        return True

    def reset_palette(self) -> None:
        """Empty the colour table (the publisher does so once per frame)."""
        if self._pal_state is not None:
            self._pal_state["vals"].fill(-1)
            self._pal_state["count"][0] = 0

    @property
    def palette(self) -> np.ndarray:
        """(256, C) uint8 colour table, filled up to :attr:`palette_count`."""
        return self._pal_state["table"]

    @property
    def palette_count(self) -> int:
        return int(self._pal_state["count"][0]) if self._pal_state else 0

    def encode_palidx(self, img: np.ndarray, hint=None):
        """One frame -> ``(idx int32[K], palidx uint8[K, th*tw])``, views
        into internal staging valid until the next call: the changed tiles
        as indices into the encoder's colour table (:attr:`palette`), in
        one pass and without raw tiles. ``None`` when a pixel would take
        the table past 256 colours (the table stays valid; the caller
        falls back to :meth:`encode`) or when the fused path is not
        available. The caller resets the table (:meth:`reset_palette`)."""
        if not self.palidx_available():
            return None
        if img.shape != self.ref.shape or img.dtype != np.uint8:
            raise ValueError(
                f"frame shape {img.shape}/{img.dtype} != ref "
                f"{self.ref.shape}/uint8"
            )
        img = np.ascontiguousarray(img)
        h, w, c = self.ref.shape
        if self._pal_state is None:
            s = {
                "keys": np.zeros(1024, np.uint32),
                "vals": np.full(1024, -1, np.int16),
                "table": np.zeros((256, c), np.uint8),
                "count": np.zeros(1, np.int64),
            }
            self._palidx_stage = np.empty(
                (self.num_tiles, self.th * self.tw), np.uint8)
            # the persistent buffers' addresses, taken once: the call is
            # the producer's per-frame hot path
            s["ptrs"] = (
                self.ref.ctypes.data, self._idx.ctypes.data,
                self._palidx_stage.ctypes.data, s["keys"].ctypes.data,
                s["vals"].ctypes.data, s["table"].ctypes.data,
                s["count"].ctypes.data,
            )
            self._pal_state = s
        ty0, ty1, tx0, tx1 = self.tile_bounds(hint)
        (p_ref, p_idx, p_stage, p_keys, p_vals, p_table, p_count
         ) = self._pal_state["ptrs"]
        k = self._palidx(
            img.ctypes.data, p_ref, h, w, c, self.th, self.tw,
            ty0, ty1, tx0, tx1, p_idx, p_stage, p_keys, p_vals, p_table,
            p_count, 256,
        )
        if k < 0:
            return None
        return self._idx[:k], self._palidx_stage[:k]


def pack_batch(deltas, num_tiles: int, bucket: int = 16, capacity=None):
    """Pack per-frame ``(idx, tiles)`` deltas into ``(idx (B, K) int32,
    tiles (B, K, th, tw, C) uint8)``. ``capacity`` pins K (when it fits);
    otherwise K is the largest per-frame count rounded up to ``bucket``.
    Padding slots carry the sentinel ``num_tiles`` and zeroed tiles. A
    row never holds the same index twice (the encoder emits each changed
    tile once)."""
    b = len(deltas)
    kmax = max((len(i) for i, _ in deltas), default=0)
    bucket = max(int(bucket), 1)
    if capacity is not None and int(capacity) >= kmax:
        cap = int(capacity)
    else:
        cap = max(-(-kmax // bucket) * bucket, bucket)
    cap = min(cap, num_tiles)
    th, tw, c = deltas[0][1].shape[1:4]
    idx = np.full((b, cap), num_tiles, np.int32)
    tiles = np.empty((b, cap, th, tw, c), np.uint8)
    for i, (fi, ft) in enumerate(deltas):
        k = len(fi)
        idx[i, :k] = fi
        tiles[i, :k] = ft
        tiles[i, k:] = 0
    return idx, tiles


def pop_stream_refs(msg: dict, refs: dict, btid) -> None:
    """Pop every ``<name>__tileref`` of a message into ``refs[(name, btid)]``."""
    for key in [k for k in msg if k.endswith(TILEREF_SUFFIX)]:
        refs[(key[: -len(TILEREF_SUFFIX)], btid)] = msg.pop(key)


def pop_tile_batches(msg: dict):
    """Pop the ``__tileshape`` entries: ``[(name, geom), ...]`` (empty for
    non-tile messages). The payload fields stay in the message."""
    out = []
    for key in [k for k in msg if k.endswith(TILESHAPE_SUFFIX)]:
        name = key[: -len(TILESHAPE_SUFFIX)]
        out.append((name, tuple(int(v) for v in msg.pop(key))))
    return out


def pop_tile_payload(fields: dict, name: str, geom, expand):
    """Pop ``name``'s tile payload and return the K-leading tile array;
    ``expand`` is :func:`expand_palette_tiles` (device) or
    :func:`expand_palette_tiles_np` (host)."""
    t = geom_tile(geom)
    for bits, suffix in TILEPAL_SUFFIXES.items():
        if name + suffix in fields:
            packed = fields.pop(name + suffix)
            pal = fields.pop(name + PALETTE_SUFFIX)
            return expand(packed, pal, bits, t, pal.shape[-1])
    return fields.pop(name + TILES_SUFFIX)


def decode_tile_delta_np(ref: np.ndarray, idx: np.ndarray,
                         tiles: np.ndarray) -> np.ndarray:
    """Host (numpy) reconstruction, same semantics as
    :func:`decode_tile_delta`: sentinels are dropped and channel-sliced
    tiles restore their remaining channels from ``ref``."""
    h, w, c = ref.shape
    th, tw = tiles.shape[2], tiles.shape[3]
    gh, gw = tile_grid(ref.shape, (th, tw))
    n = gh * gw
    b = idx.shape[0]
    ct = tiles.shape[-1]
    out = np.broadcast_to(ref, (b, h, w, c)).copy()
    ov = out.reshape(b, gh, th, gw, tw, c)
    for bi in range(b):
        m = idx[bi] < n
        real = idx[bi][m]
        ov[bi, real // gw, :, real % gw, :, :ct] = tiles[bi][m]
    return out


def tile_ref_np(ref: np.ndarray, tile=TILE) -> np.ndarray:
    """(H, W, C) -> tiled view (N, th, tw, C), host side."""
    h, w, c = ref.shape
    th, tw = tile_hw(tile)
    gh, gw = tile_grid(ref.shape, (th, tw))
    return np.ascontiguousarray(
        ref.reshape(gh, th, gw, tw, c).transpose(0, 2, 1, 3, 4)
        .reshape(gh * gw, th, tw, c)
    )


# -- host half: palette codec -------------------------------------------------


def _palettize_flat(flat: np.ndarray, max_colors: int, native: bool = True):
    """(N, C) uint8 pixels -> ``(idx (N,) uint8, palette (max_colors, C),
    count)``, or ``None`` with more than ``max_colors`` distinct colors.
    ``native`` runs the port's C++ palettizer (``bjt_palettize``; colours
    numbered by first sight, and ``None`` for C > 4 as well); ``False`` the
    numpy twin (colours numbered by value)."""
    n, c = flat.shape
    if native:
        from blendjax_torch._native import palettize

        flat = np.ascontiguousarray(flat)
        pal = np.zeros((max_colors, c), np.uint8)
        idx = np.empty((n,), np.uint8)
        count = palettize()(flat.ctypes.data, n, c, max_colors,
                            pal.ctypes.data, idx.ctypes.data)
        return None if count < 0 else (idx, pal, count)
    key = np.zeros(n, np.uint32)
    for j in range(c):
        key |= flat[:, j].astype(np.uint32) << (8 * j)
    uniq, idx32 = np.unique(key, return_inverse=True)
    count = len(uniq)
    if count > max_colors:
        return None
    pal = np.zeros((max_colors, c), np.uint8)
    for j in range(c):
        pal[:count, j] = (uniq >> (8 * j)).astype(np.uint8)
    return idx32.astype(np.uint8), pal, count


def palettize_tiles(tiles: np.ndarray, max_colors: int = 256,
                    native: bool = True):
    """Palette-compress a packed tile array (B, K, th, tw, C): returns
    ``(packed, palette, bits)`` (2/4/8-bit indices by the batch's color
    count; palette (4|16|256, C) zero-padded), or ``None``. ``native``:
    as :func:`_palettize_flat`."""
    max_colors = min(int(max_colors), 256)
    b, k, th, tw, c = tiles.shape
    tt = th * tw
    out = _palettize_flat(
        np.ascontiguousarray(tiles).reshape(-1, c), max_colors, native
    )
    if out is None:
        return None
    idx, pal, count = out
    if count <= 4 and tt % 4 == 0:
        pal4 = np.zeros((4, c), np.uint8)
        pal4[: min(len(pal), 4)] = pal[:4]
        return pack_palette_indices(idx, 2).reshape(b, k, tt // 4), pal4, 2
    if count <= 16 and tt % 2 == 0:
        pal16 = np.zeros((16, c), np.uint8)
        pal16[: min(len(pal), 16)] = pal[:16]
        return pack_palette_indices(idx, 4).reshape(b, k, tt // 2), pal16, 4
    return idx.reshape(b, k, tt), pal, 8


def palettize_frames(frames: np.ndarray, max_colors: int = 256):
    """Palette-compress full frames (B, H, W, C) with one palette per
    frame: ``(packed (B, H*W*bits/8), palette (B, cap, C), bits)`` or
    ``None`` when a frame holds more than ``max_colors`` colors."""
    max_colors = min(int(max_colors), 256)
    b, h, w, c = frames.shape
    hw = h * w
    frames = np.ascontiguousarray(frames)
    rows = []
    for i in range(b):
        out = _palettize_flat(frames[i].reshape(-1, c), max_colors)
        if out is None:
            return None
        rows.append(out)
    cmax = max((r[2] for r in rows), default=0)
    if cmax <= 4 and hw % 4 == 0:
        bits, cap = 2, 4
    elif cmax <= 16 and hw % 2 == 0:
        bits, cap = 4, 16
    else:
        bits, cap = 8, 256
    palette = np.zeros((b, cap, c), np.uint8)
    packed = np.empty((b, hw * bits // 8), np.uint8)
    for i, (idx, pal, count) in enumerate(rows):
        palette[i, :count] = pal[:count]
        packed[i] = pack_palette_indices(idx, bits)
    return packed, palette, bits


def expand_palette_tiles_np(packed, palette, bits: int, t, c: int):
    """Host twin of :func:`expand_palette_tiles`."""
    th, tw = tile_hw(t)
    if palette.ndim >= 3:
        return np.stack([
            expand_palette_tiles_np(p, q, bits, t, c)
            for p, q in zip(packed, palette)
        ])
    lead = packed.shape[:-1]
    return palette[unpack_palette_indices(packed, bits)].reshape(
        *lead, th, tw, c
    )


def expand_palette_frames_np(packed, palette, bits: int, h: int, w: int,
                             c: int):
    """Host twin of :func:`expand_palette_frames`."""
    if palette.ndim >= 3:
        return np.stack([
            expand_palette_frames_np(p, q, bits, h, w, c)
            for p, q in zip(packed, palette)
        ])
    lead = packed.shape[:-1]
    return palette[unpack_palette_indices(packed, bits)].reshape(
        *lead, h, w, c
    )


def pop_frame_palette_payload(fields: dict, name: str, bits: int, h: int,
                              w: int, c: int, expand):
    """Pop ``name``'s full-frame palette payload and return the frames."""
    packed = fields.pop(name + FRAMEPAL_SUFFIXES[bits])
    pal = fields.pop(name + PALETTE_SUFFIX)
    return expand(packed, pal, bits, h, w, c)


def pop_frame_palette_batches(hb: dict):
    """Pop each ``name__frameshape``: ``[(name, (h, w, c, bits)), ...]``."""
    out = []
    for key in [k for k in hb if k.endswith(FRAMESHAPE_SUFFIX)]:
        name = key[: -len(FRAMESHAPE_SUFFIX)]
        h, w, c, bits = (int(v) for v in hb.pop(key))
        out.append((name, (h, w, c, bits)))
    return out


# -- host half: run-length "ndr" codec ----------------------------------------
#
# Packed per-row layout (rows, cap*(isz+2)) uint8:
#   [values: cap x isz bytes][run lo-bytes: cap][run hi-bytes: cap]
# Unused tail entries carry run == 0.

NDR_SUFFIX = "__ndr"
NDRSPEC_SUFFIX = "__ndrspec"

RLE_MAX_RUN = 0xFFFF
RLE_BUCKET = 64


def rle_item_size(shape) -> int:
    """Run item width: the trailing channel dim when it looks like pixels
    ((..., C) with 2 <= C <= 4), else single bytes."""
    if len(shape) >= 2 and 2 <= int(shape[-1]) <= 4:
        return int(shape[-1])
    return 1


def rle_packed_stride(cap: int, isz: int) -> int:
    return int(cap) * (int(isz) + 2)


def _rle_geometry(shape, isz: int):
    """shape -> (rows, items per row); rows are the leading axis."""
    shape = tuple(int(s) for s in shape)
    total = 1
    for s in shape:
        total *= s
    rows = shape[0] if len(shape) >= 2 else 1
    if rows <= 0 or total <= 0:
        raise ValueError(f"ndr geometry needs a non-empty shape, got {shape}")
    row_bytes, rem = divmod(total, rows)
    if rem or row_bytes % isz:
        raise ValueError(
            f"ndr geometry {shape} does not split into rows of whole "
            f"{isz}-byte items"
        )
    return rows, row_bytes // isz


def rle_encode_rows(arr: np.ndarray, cap: int | None = None,
                    bucket: int = RLE_BUCKET):
    """Run-length encode a uint8 array row-wise: ``(buf, cap, isz)``, or
    ``None`` when ineligible or when a pinned ``cap`` is too small."""
    if not isinstance(arr, np.ndarray) or arr.dtype != np.uint8 or arr.size == 0:
        return None
    isz = rle_item_size(arr.shape)
    try:
        rows, t = _rle_geometry(arr.shape, isz)
    except ValueError:
        isz = 1
        rows, t = _rle_geometry(arr.shape, isz)
    flat = np.ascontiguousarray(arr).reshape(rows, t, isz)
    per = []
    kmax = 1
    for r in range(rows):
        row = flat[r]
        change = np.empty(t, np.bool_)
        change[0] = True
        if t > 1:
            np.any(row[1:] != row[:-1], axis=1, out=change[1:])
        starts = np.flatnonzero(change)
        runs = np.diff(np.append(starts, t)).astype(np.int64)
        if len(runs) and runs.max() > RLE_MAX_RUN:
            reps = (runs + RLE_MAX_RUN - 1) // RLE_MAX_RUN
            vals = np.repeat(row[starts], reps, axis=0)
            split = np.full(int(reps.sum()), RLE_MAX_RUN, np.int64)
            split[np.cumsum(reps) - 1] = runs - (reps - 1) * RLE_MAX_RUN
            runs = split
        else:
            vals = row[starts]
        kmax = max(kmax, len(runs))
        per.append((vals, runs))
    if cap is not None:
        if kmax > int(cap):
            return None
        cap = int(cap)
    else:
        bucket = max(int(bucket), 1)
        cap = max(-(-kmax // bucket) * bucket, bucket)
    buf = np.zeros((rows, rle_packed_stride(cap, isz)), np.uint8)
    vals_plane = buf[:, : cap * isz].reshape(rows, cap, isz)
    lo_plane = buf[:, cap * isz: cap * (isz + 1)]
    hi_plane = buf[:, cap * (isz + 1):]
    for r, (vals, runs) in enumerate(per):
        k = len(runs)
        vals_plane[r, :k] = vals
        lo_plane[r, :k] = (runs & 0xFF).astype(np.uint8)
        hi_plane[r, :k] = (runs >> 8).astype(np.uint8)
    return buf, cap, isz


def _rle_runs_np(buf: np.ndarray, cap: int, isz: int):
    vals = buf[:, : cap * isz].reshape(buf.shape[0], cap, isz)
    lo = buf[:, cap * isz: cap * (isz + 1)].astype(np.uint32)
    hi = buf[:, cap * (isz + 1):].astype(np.uint32)
    return vals, lo | (hi << 8)


def rle_validate_packed(buf, shape, isz: int, cap: int) -> None:
    """Hostile-stream guards for a packed run buffer: declared geometry,
    exact buffer shape, and run sums equal to the declared row length."""
    isz, cap = int(isz), int(cap)
    if isz < 1 or isz > 16 or cap < 1:
        raise ValueError(f"ndr spec out of bounds (isz={isz}, cap={cap})")
    rows, t = _rle_geometry(shape, isz)
    buf = np.asarray(buf)
    if buf.dtype != np.uint8 or buf.shape != (rows, rle_packed_stride(cap, isz)):
        raise ValueError(
            f"ndr buffer shape {buf.shape}/{buf.dtype} does not match "
            f"declared rows={rows} cap={cap} isz={isz}"
        )
    _, runs = _rle_runs_np(buf, cap, isz)
    sums = runs.sum(axis=1)
    if not (sums == t).all():
        raise ValueError(
            f"ndr rows do not expand to the declared {t} items "
            f"(row sums {sums.min()}..{sums.max()})"
        )


def rle_expand_packed_np(buf: np.ndarray, shape, isz: int, cap: int):
    """Host inverse of :func:`rle_encode_rows` (validates first)."""
    rle_validate_packed(buf, shape, isz, cap)
    shape = tuple(int(s) for s in shape)
    rows, _t = _rle_geometry(shape, int(isz))
    vals, runs = _rle_runs_np(np.asarray(buf), int(cap), int(isz))
    out = np.concatenate(
        [np.repeat(vals[r], runs[r], axis=0) for r in range(rows)]
    )
    return out.reshape(shape)


def pop_rle_batches(fields: dict):
    """Pop each ``<base>__ndrspec``: the static plan ``((base, (shape, isz,
    cap)), ...)``; the ``<base>__ndr`` buffers stay in ``fields``."""
    out = []
    for key in [k for k in fields if k.endswith(NDRSPEC_SUFFIX)]:
        base = key[: -len(NDRSPEC_SUFFIX)]
        shape, isz, cap = fields.pop(key)
        out.append((base, (tuple(int(s) for s in shape), int(isz), int(cap))))
    return tuple(out)


# -- host half: packed single-transfer form -----------------------------------
#
# A batch dict collapses into ONE uint8 buffer plus a static spec, so the
# whole batch crosses to the card in one copy; unpack_fields re-slices it
# there. 64-bit payloads are value-cast to 32 bits first (always: the
# port keeps 32-bit device fields, like the JAX package without x64), and
# an integer that does not fit raises instead of wrapping.

_PACK_NARROW = {
    np.dtype(np.float64): np.float32,
    np.dtype(np.int64): np.int32,
    np.dtype(np.uint64): np.uint32,
}


def _narrow_for_pack(name: str, arr: np.ndarray) -> np.ndarray:
    target = _PACK_NARROW[arr.dtype]
    if arr.dtype.kind in "iu" and arr.size:
        info = np.iinfo(target)
        lo, hi = int(arr.min()), int(arr.max())
        if lo < info.min or hi > info.max:
            raise ValueError(
                f"pack_fields: field {name!r} ({arr.dtype}) holds values "
                f"[{lo}, {hi}] that do not fit {np.dtype(target)}; pre-cast "
                "the field on the producer"
            )
    return arr.astype(target)


def pack_fields(fields: dict):
    """Concatenate ndarray fields into ``(buf uint8[total], spec)``, where
    ``spec`` is a hashable tuple of ``(name, dtype_str, shape, offset,
    nbytes)`` for :func:`unpack_fields`."""
    spec = []
    offset = 0
    parts = []
    for name, arr in fields.items():
        arr = np.ascontiguousarray(arr)
        if arr.dtype in _PACK_NARROW:
            arr = _narrow_for_pack(name, arr)
        raw = arr.view(np.uint8).reshape(-1)
        spec.append((name, arr.dtype.str, tuple(int(x) for x in arr.shape),
                     offset, raw.nbytes))
        parts.append(raw)
        offset += raw.nbytes
    return np.concatenate(parts), tuple(spec)


# -- device half ----------------------------------------------------------------


def _torch_dtype(dt: np.dtype):
    import torch

    return {
        "u1": torch.uint8, "i1": torch.int8, "i2": torch.int16,
        "u2": torch.uint16, "i4": torch.int32, "u4": torch.uint32,
        "i8": torch.int64, "u8": torch.uint64, "f2": torch.float16,
        "f4": torch.float32, "f8": torch.float64,
    }[f"{dt.kind}{dt.itemsize}"]


def _view_ready(raw, itemsize: int) -> bool:
    """Whether ``raw.view(dtype)`` to a ``itemsize``-byte type is legal
    without a copy (unit last stride, aligned offset and strides)."""
    return (
        raw.stride(-1) == 1
        and raw.storage_offset() % itemsize == 0
        and all(s % itemsize == 0 for s in raw.stride()[:-1])
    )


def unpack_fields(buf, spec):
    """Inverse of :func:`pack_fields` on a uint8 tensor ``buf`` of shape
    ``(..., total)``: byte slices reinterpreted with ``Tensor.view(dtype)``
    (copied first only where the slice is misaligned for the type).
    Returns ``{name: tensor (..., *shape)}``."""
    lead = tuple(buf.shape[:-1])
    out = {}
    for name, dtype_str, shape, offset, nbytes in spec:
        dt = np.dtype(dtype_str)
        raw = buf.narrow(-1, offset, nbytes)
        if dt == np.uint8:
            arr = raw
        elif dt == np.bool_:
            arr = raw != 0
        else:
            if dt.itemsize > 1 and not _view_ready(raw, dt.itemsize):
                raw = raw.clone()  # fresh storage: offset 0, dense rows
            arr = raw.view(_torch_dtype(dt))
        out[name] = arr.reshape(*lead, *shape)
    return out


def rle_expand_packed(buf, shape, isz: int, cap: int):
    """Device inverse of :func:`rle_encode_rows`: ``buf`` is ``(...,
    rows, stride)``; one ``cumsum`` over the run planes plus one
    ``searchsorted(right=True)`` per row, indices clamped to ``cap - 1``
    (a hostile buffer can only give wrong pixels, never an out-of-bounds
    read). Returns ``(..., *shape)``."""
    import torch

    shape = tuple(int(s) for s in shape)
    isz, cap = int(isz), int(cap)
    _rows, t = _rle_geometry(shape, isz)
    stride = rle_packed_stride(cap, isz)
    lead = tuple(buf.shape[:-2])
    flat = buf.reshape(-1, stride)
    vals = flat[:, : cap * isz].reshape(-1, cap, isz)
    lo = flat[:, cap * isz: cap * (isz + 1)].to(torch.int64)
    hi = flat[:, cap * (isz + 1):].to(torch.int64)
    ends = torch.cumsum(lo | (hi << 8), dim=1)
    pos = torch.arange(t, device=buf.device, dtype=torch.int64)
    pos = pos.expand(flat.shape[0], t).contiguous()
    idx = torch.searchsorted(ends, pos, right=True).clamp_(max=cap - 1)
    out = torch.gather(vals, 1, idx[..., None].expand(-1, -1, isz))
    return out.reshape(*lead, *shape)


def expand_rle_fields(fields: dict, rle_groups) -> dict:
    """Expand every deferred run buffer of an unpacked field dict in place."""
    for base, (shape, isz, cap) in rle_groups:
        fields[base] = rle_expand_packed(
            fields.pop(base + NDR_SUFFIX), shape, isz, cap
        )
    return fields


def _unpack_palette_indices_t(packed, bits: int):
    """Torch twin of :func:`unpack_palette_indices`."""
    import torch

    lead = tuple(packed.shape[:-1])
    m = packed.shape[-1]
    if bits == 2:
        return torch.stack(
            [packed >> 6, (packed >> 4) & 3, (packed >> 2) & 3, packed & 3],
            dim=-1,
        ).reshape(*lead, m * 4)
    if bits == 4:
        return torch.stack([packed >> 4, packed & 0xF], dim=-1).reshape(
            *lead, m * 2
        )
    return packed


def _palette_lut(palette, bits: int):
    """Palette ``(..., cap, C)`` -> byte LUT ``(..., E, px*C)``: for
    ``bits < 8`` each of the 256 byte values maps to its ``8/bits``
    pixels; for ``bits == 8`` the palette itself (``E = cap``)."""
    import torch

    if bits == 8:
        return palette
    px = 8 // bits
    byte = torch.arange(256, dtype=torch.uint8, device=palette.device)
    nib = _unpack_palette_indices_t(byte[:, None], bits).long()
    nib = nib.clamp_(max=palette.shape[-2] - 1)  # (256, px)
    lut = palette[..., nib, :]  # (..., 256, px, C)
    return lut.reshape(*palette.shape[:-2], 256, px * palette.shape[-1])


def _palette_expand(packed, palette, bits: int):
    """One gather per packed byte through the byte LUT. ``palette`` is
    ``(cap, C)`` for the whole array or ``(*lead, cap, C)`` with ``lead``
    a prefix of ``packed``'s leading dims (each row gathers through its
    own table: the JAX package's ``vmap`` cases). Returns
    ``(*packed.shape, px*C)``."""
    import torch

    lut = _palette_lut(palette, bits)
    entries, width = lut.shape[-2], lut.shape[-1]
    idx = packed.long()
    if entries < 256:
        idx = idx.clamp(max=entries - 1)
    plead = tuple(palette.shape[:-2])
    if not plead:
        return lut[idx]
    if tuple(packed.shape[: len(plead)]) != plead:
        raise ValueError(
            f"per-row palette lead {plead} does not prefix packed "
            f"{tuple(packed.shape)}"
        )
    rows = int(np.prod(plead))
    flat = idx.reshape(rows, -1)
    out = torch.gather(
        lut.reshape(rows, entries, width), 1,
        flat[..., None].expand(-1, -1, width),
    )
    return out.reshape(*packed.shape, width)


def expand_palette_tiles(packed, palette, bits: int, t, c: int):
    """Device inverse of :func:`palettize_tiles`: ``packed`` (..., K,
    th*tw*bits/8) uint8 -> (..., K, th, tw, C)."""
    th, tw = tile_hw(t)
    lead = tuple(packed.shape[:-1])
    return _palette_expand(packed, palette, bits).reshape(*lead, th, tw, c)


def expand_palette_frames(packed, palette, bits: int, h: int, w: int,
                          c: int):
    """Device inverse of :func:`palettize_frames`: (..., H*W*bits/8) ->
    (..., H, W, C)."""
    lead = tuple(packed.shape[:-1])
    return _palette_expand(packed, palette, bits).reshape(*lead, h, w, c)


def tile_ref(ref, tile=TILE):
    """Reference image (H, W, C) tensor -> tiled (N, th, tw, C) view,
    contiguous; computed once per stream."""
    h, w, c = ref.shape
    th, tw = tile_hw(tile)
    gh, gw = tile_grid(ref.shape, (th, tw))
    return ref.reshape(gh, th, gw, tw, c).permute(0, 2, 1, 3, 4).reshape(
        gh * gw, th, tw, c
    ).contiguous()


def select_decode_kernel(th: int, tw: int, c: int) -> str:
    """The port's kernel rule: square tiles take the slot scatter (K2,
    :func:`blendjax_torch.kernels.decode.decode_scatter`), every other
    geometry the direct-spatial gather (K1,
    :func:`blendjax_torch.kernels.decode.decode_spatial`). Both accept
    any tile size; each kernel picks 16-byte copies when its rows allow
    and byte copies otherwise, so no geometry is refused."""
    del c  # both kernels take any channel count
    return "scatter" if th == tw else "spatial"


def _rank_rows(mesh, data_axis, b: int):
    """``(start, size)`` of this rank's rows of a ``b``-row batch split
    over ``data_axis`` of ``mesh`` (None: not split); a batch the axis
    does not divide raises."""
    if mesh is None:
        return None
    from blendjax_torch.parallel.sharding import rank_range

    return rank_range(mesh, data_axis, b)


def decode_tile_delta(ref_tiles, idx, tiles, shape, mesh=None,
                      data_axis="data"):
    """Reconstruct exact frames on the device of ``ref_tiles``.

    ``ref_tiles``: (N, th, tw, C) from :func:`tile_ref`; ``idx``: (B, K)
    int32, sentinel N = no-op; ``tiles``: (B, K, th, tw, Ct). ``Ct < C``
    restores the remaining channels from the reference first (one
    gather, sentinel rows clamped to a real tile). ``K == 0`` returns the
    reference broadcast without launching a kernel. Otherwise
    :func:`select_decode_kernel` picks K1 or K2. Returns (B, H, W, C)
    uint8, bit-exact.

    With ``mesh`` (one process per card) the batch is split over
    ``data_axis`` and this rank decodes only its rows, against the
    reference every rank holds (the JAX package's ``shard_map`` of the
    kernel over the batch): it returns (B / ways, H, W, C), this rank's
    rows of the one-card result. ``B`` must divide."""
    import torch

    from blendjax_torch.kernels.decode import decode_scatter, decode_spatial

    rows = _rank_rows(mesh, data_axis, int(idx.shape[0]))
    if rows is not None:
        idx = idx[rows[0]:rows[0] + rows[1]]
        tiles = tiles[rows[0]:rows[0] + rows[1]]

    h, w, c = (int(s) for s in shape)
    th, tw, ct = (int(s) for s in tiles.shape[-3:])
    gh, gw = tile_grid((h, w, c), (th, tw))
    n = gh * gw
    b, k = idx.shape
    if ct < c:
        filled = ref_tiles[..., ct:][idx.long().clamp(0, n - 1)]
        tiles = torch.cat([tiles, filled], dim=-1)
    if k == 0:
        ref_img = ref_tiles.reshape(gh, gw, th, tw, c).permute(
            0, 2, 1, 3, 4
        ).reshape(1, h, w, c)
        return ref_img.expand(b, h, w, c)
    ref_tiles = ref_tiles.contiguous()
    idx = idx.contiguous()
    tiles = tiles.contiguous()
    if select_decode_kernel(th, tw, c) == "spatial":
        return decode_spatial(ref_tiles, idx, tiles, (h, w, c))
    slots = decode_scatter(ref_tiles, idx, tiles)  # (B, N, th*tw*C)
    return slots.reshape(b, gh, gw, th, tw, c).permute(
        0, 1, 3, 2, 4, 5
    ).reshape(b, h, w, c)


def _local_fields(fields: dict, rows, b: int) -> dict:
    """This rank's rows (dim 1) of every (K', B, ...) field; a tile
    group's palette is per batch (K', colors, C) and stays whole."""
    if rows is None:
        return fields
    start, size = rows
    return {k: (v[:, start:start + size]
                if getattr(v, "ndim", 0) >= 2 and v.shape[1] == b
                and not k.endswith(PALETTE_SUFFIX) else v)
            for k, v in fields.items()}


def decode_packed_superbatch(packed, refs, spec, names, geoms, rle_groups=(),
                             mesh=None, data_axis="data"):
    """Decode a stacked chunk group ``packed`` (K', total) uint8 to full
    fields: every name's tiles decode flattened over K'*B in one kernel
    call. Returns ``{field: (K', B, ...)}``; sidecar fields keep their
    (K', ...) shapes. With ``mesh`` the packed buffer is every rank's and
    each rank decodes (and keeps) only its rows of the batch axis, as
    :func:`decode_tile_delta` with ``mesh``."""
    fields = expand_rle_fields(unpack_fields(packed, spec), rle_groups)
    b_all = next((int(fields[n + TILEIDX_SUFFIX].shape[1]) for n in names),
                 None)
    rows = (_rank_rows(mesh, data_axis, b_all) if b_all is not None
            else None)
    fields = _local_fields(fields, rows, b_all)
    for name, geom in zip(names, geoms):
        idx = fields.pop(name + TILEIDX_SUFFIX)
        tiles = pop_tile_payload(fields, name, geom, expand_palette_tiles)
        kk, b = idx.shape[:2]
        img = decode_tile_delta(
            refs[name],
            idx.reshape(kk * b, *idx.shape[2:]),
            tiles.reshape(kk * b, *tiles.shape[2:]),
            geom[:3],
        )
        fields[name] = img.reshape(kk, b, *img.shape[1:])
    return fields


def decode_packed_pal_batch(packed, spec, pal_groups, rle_groups=()):
    """Decode one packed full-frame-palette batch (total,) to fields."""
    fields = expand_rle_fields(unpack_fields(packed, spec), rle_groups)
    for name, (h, w, c, bits) in pal_groups:
        fields[name] = pop_frame_palette_payload(
            fields, name, bits, h, w, c, expand_palette_frames
        )
    return fields


def decode_packed_pal_superbatch(packed, spec, pal_groups, rle_groups=(),
                                 mesh=None, data_axis="data"):
    """(K', total) stacked palette buffers -> (K', B, ...) fields; each
    group member gathers through its own palette (the device functions
    above treat leading dims as rows, which is the JAX package's vmap
    over the chunk axis). With ``mesh`` each rank keeps its rows."""
    fields = decode_packed_pal_batch(packed, spec, pal_groups, rle_groups)
    if mesh is None or not pal_groups:
        return fields
    b = int(fields[pal_groups[0][0]].shape[1])
    return _local_fields(fields, _rank_rows(mesh, data_axis, b), b)
