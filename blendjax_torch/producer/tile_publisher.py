"""Producer-side sparse streaming: batch + tile-delta-encode + publish
(copied from the numpy path of ``blendjax/producer/tile_publisher.py``).

Every ``batch_size`` frames one prebatched message goes out carrying only
the tiles that changed against the reference image, plus the reference
itself in the stream's first message (and every ``ref_interval``-th).

- **Sticky capacity**: the per-frame tile capacity K is a per-stream
  high-water mark (30% headroom at first, grown in 32-tile steps on
  overflow) or pinned by ``capacity``, so the consumer sees stable shapes.
- **Alpha slicing**: when every frame's alpha matches the reference's,
  only RGB crosses the wire; the consumer restores alpha on the card.
- **Palette** (``palette=True``): with full-channel tiles (no alpha
  slicing) on the native path, the changed-tile scan and the palettizer
  run FUSED, one pass per frame against a colour table reset per frame:
  each row of the batch ships its own palette (a (B, cap, C) array), the
  largest row's colour count picking 2, 4 or 8-bit indices. A frame with
  more than 256 colours turns its batch back into raw tiles (the rows
  already indexed are expanded through their own palettes), and eight
  such batches in a row latch the fused path off. Otherwise, when the
  batch's changed tiles hold at most 256 colours, they ship as 2/4/8-bit
  indices into one batch palette (two passes).

The scans and the palettizers run in the port's host C++ (``native=True``,
the default; a failed build raises) or, without the fused path, in their
numpy twins (``native=False``). The consumer decodes every form.
"""

from __future__ import annotations

import numpy as np

from blendjax_torch.ops.tiles import (
    PALETTE_SUFFIX,
    TILE,
    TILEIDX_SUFFIX,
    TILEPAL_SUFFIXES,
    TILEREF_SUFFIX,
    TILES_SUFFIX,
    TILESHAPE_SUFFIX,
    TileDeltaEncoder,
    pack_batch,
    pack_palette_indices,
    palettize_tiles,
    tileshape_wire,
)


class TileBatchPublisher:
    """Accumulates frames and publishes tile-delta batch messages through
    ``publisher`` (a :class:`blendjax_torch.transport.DataPublisherSocket`
    owned by the caller). ``ref``: the (H, W, C) uint8 reference image of
    the ``field`` the consumer rebuilds. ``palette=False`` ships raw
    tiles."""

    def __init__(self, publisher, ref: np.ndarray, batch_size: int,
                 tile=TILE, field: str = "image", alpha_slice: bool = True,
                 ref_interval: int = 0, palette: bool = True,
                 capacity: int | None = None, native: bool = True):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self.publisher = publisher
        self.batch_size = int(batch_size)
        self.field = field
        self.alpha_slice = bool(alpha_slice)
        self.ref_interval = max(0, int(ref_interval))
        self.palette = bool(palette)  # latched off after repeated misses
        self._palette_misses = 0
        self.native = bool(native)
        self.encoder = TileDeltaEncoder(ref, tile=tile, native=native)
        self.th, self.tw = self.encoder.th, self.encoder.tw
        self._ref = self.encoder.ref
        if self._ref.shape[2] == 4:
            # the reference's alpha plane per flat tile id: the alpha-
            # static check touches only the tiles a frame changed
            gh, gw = self.encoder.grid
            self._ref_tile_alpha = np.ascontiguousarray(
                self._ref[:, :, 3].reshape(gh, self.th, gw, self.tw)
                .transpose(0, 2, 1, 3).reshape(gh * gw, self.th, self.tw)
            )
        else:
            self._ref_tile_alpha = None
        self._deltas: list = []
        self._extras: dict = {}
        self._alpha_static = True
        self._ref_sent = False
        self._capacity: int | None = (
            min(int(capacity), self.encoder.num_tiles) if capacity else None
        )
        self.batches_published = 0
        # once the capacity is fixed, frames encode straight into these
        # (B, K, ...) arrays; they never leave the process (publish ships
        # copies or palette-packed fresh arrays)
        self._batch_idx: np.ndarray | None = None
        self._batch_tiles: np.ndarray | None = None
        self._row = 0
        # the fused scan + palettize: full-channel tiles (alpha slicing
        # needs raw tiles for its check; an RGB stream has no alpha to
        # slice) on the native path
        self._fused_ok = (
            self.palette
            and not (self.alpha_slice and self._ref_tile_alpha is not None)
            and self.encoder.palidx_available()
        )
        self._raw_batch = False  # this batch fell back to raw tiles
        self._batch_pal: np.ndarray | None = None
        # per row of the batch: its palette snapshot and colour count
        self._row_pals: list = [None] * self.batch_size
        self._row_counts: list = [0] * self.batch_size

    def add(self, image: np.ndarray, hint=None, **extras) -> None:
        """Add one frame plus its per-frame sidecar fields; publishes when
        the batch fills. ``hint`` bounds the changed-tile scan."""
        if self._fused_ok and not self._raw_batch and self._capacity is not None:
            # a fresh colour table per frame: one frame's colour count,
            # not the batch's, sets the index width
            self.encoder.reset_palette()
            out = self.encoder.encode_palidx(image, hint=hint)
            if out is not None:
                fi, fpal = out
                k = len(fi)
                if k > self._capacity:
                    self._grow(k)
                self._ensure_batch_arrays()
                i = self._row
                self._batch_idx[i, :k] = fi
                self._batch_idx[i, k:] = self.encoder.num_tiles
                self._batch_pal[i, :k] = fpal
                self._batch_pal[i, k:] = 0
                self._row_counts[i] = self.encoder.palette_count
                self._row_pals[i] = self.encoder.palette[
                    : self.encoder.palette_count].copy()
                self._row += 1
                for key, v in extras.items():
                    self._extras.setdefault(key, []).append(v)
                if self._row == self.batch_size:
                    self._publish()
                return
            # more than 256 colours: finish this batch as raw tiles, the
            # rows already indexed expanded back; repeated misses latch
            # the fused path off
            self._raw_batch = True
            self._palette_misses += 1
            if self._palette_misses >= 8:
                self._fused_ok = False
            self._depalettize_rows()
        fi, ft = self.encoder.encode(image, hint=hint)
        if self._ref_tile_alpha is not None and self._alpha_static:
            self._alpha_static = np.array_equal(
                ft[..., 3], self._ref_tile_alpha[fi]
            )
        if self._capacity is not None:
            k = len(fi)
            if k > self._capacity:
                self._grow(k)
            self._ensure_batch_arrays()
            i = self._row
            self._batch_idx[i, :k] = fi
            self._batch_idx[i, k:] = self.encoder.num_tiles  # sentinel
            self._batch_tiles[i, :k] = ft
            self._batch_tiles[i, k:] = 0
            self._row += 1
        else:
            # first batch without a pinned capacity: buffer; _publish
            # fixes the sticky capacity
            self._deltas.append((fi.copy(), ft.copy()))
        for key, v in extras.items():
            self._extras.setdefault(key, []).append(v)
        if self._row + len(self._deltas) == self.batch_size:
            self._publish()

    def _ensure_batch_arrays(self) -> None:
        if self._batch_idx is None:
            c = self._ref.shape[2]
            self._batch_idx = np.empty(
                (self.batch_size, self._capacity), np.int32
            )
            self._batch_tiles = np.empty(
                (self.batch_size, self._capacity, self.th, self.tw, c),
                np.uint8,
            )
        if self._fused_ok and self._batch_pal is None:
            self._batch_pal = np.empty(
                (self.batch_size, self._capacity, self.th * self.tw),
                np.uint8,
            )

    def _grow(self, kmax: int) -> None:
        """Overflow: widen the capacity (32-tile steps) and migrate the
        rows already packed this batch."""
        new_cap = min(-(-kmax // 32) * 32, self.encoder.num_tiles)
        old_idx, old_tiles, n = self._batch_idx, self._batch_tiles, self._row
        old_pal = self._batch_pal
        self._capacity = new_cap
        self._batch_idx = None
        self._batch_pal = None
        self._ensure_batch_arrays()
        if n and old_idx is not None:
            self._batch_idx[:n, : old_idx.shape[1]] = old_idx[:n]
            self._batch_idx[:n, old_idx.shape[1]:] = self.encoder.num_tiles
            self._batch_tiles[:n, : old_tiles.shape[1]] = old_tiles[:n]
            self._batch_tiles[:n, old_tiles.shape[1]:] = 0
            if old_pal is not None and self._batch_pal is not None:
                self._batch_pal[:n, : old_pal.shape[1]] = old_pal[:n]
                self._batch_pal[:n, old_pal.shape[1]:] = 0

    def _depalettize_rows(self) -> None:
        """Fused -> raw mid-batch: rebuild the raw tiles of the rows
        already indexed, each through its own palette snapshot."""
        n = self._row
        if not n or self._batch_pal is None:
            return
        self._ensure_batch_arrays()
        c = self._ref.shape[2]
        for i in range(n):
            colors = np.zeros((256, c), np.uint8)
            rp = self._row_pals[i]
            if rp is not None:
                colors[: len(rp)] = rp
            self._batch_tiles[i] = colors[self._batch_pal[i]].reshape(
                self._capacity, self.th, self.tw, c)
        # padding slots ship zeroed tiles, not palette colour 0
        pad = self._batch_idx[:n] == self.encoder.num_tiles
        self._batch_tiles[:n][pad] = 0

    def flush(self) -> None:
        """Publish a buffered partial batch (end of a finite stream)."""
        if self._deltas or self._row:
            self._publish()

    def _finish_publish(self, msg: dict) -> None:
        """Both publish forms' tail: sidecar fields, the reference on the
        first message and every ``ref_interval``-th, the batch state
        reset, the publish."""
        for k, vals in self._extras.items():
            msg[k] = np.stack([np.asarray(v) for v in vals])
        keyframe = (
            self.ref_interval > 0
            and self.batches_published % self.ref_interval == 0
        )
        if not self._ref_sent or keyframe:
            msg[self.field + TILEREF_SUFFIX] = self._ref
            self._ref_sent = True
        self._deltas.clear()
        self._extras = {}
        self._alpha_static = True
        self._row = 0
        self._raw_batch = False
        self._row_pals = [None] * self.batch_size
        self._row_counts = [0] * self.batch_size
        self.publisher.publish(**msg)
        self.batches_published += 1

    def _publish_fused(self) -> None:
        """The rows are palette indices already: ship them with one
        palette per row, zero-padded to the index width's colour count."""
        n = self._row
        h, w, c = self._ref.shape
        idx = self._batch_idx[:n].copy()
        pal_idx = self._batch_pal[:n]
        self._palette_misses = 0
        counts = self._row_counts[:n]
        cmax = max(counts) if counts else 0
        tt = self.th * self.tw
        if cmax <= 4 and tt % 4 == 0:
            bits, cap_colors = 2, 4
        elif cmax <= 16 and tt % 2 == 0:
            bits, cap_colors = 4, 16
        else:
            bits, cap_colors = 8, 256
        # fresh arrays: the batch arrays are reused and publish may hand
        # its buffers on by reference
        packed = (pack_palette_indices(pal_idx, bits) if bits < 8
                  else pal_idx.copy())
        pal = np.zeros((n, cap_colors, c), np.uint8)
        for i in range(n):
            pal[i, : counts[i]] = self._row_pals[i]
        self._finish_publish({
            "_prebatched": True,
            self.field + TILEIDX_SUFFIX: idx,
            self.field + TILESHAPE_SUFFIX: tileshape_wire(
                h, w, c, (self.th, self.tw)),
            self.field + TILEPAL_SUFFIXES[bits]: packed,
            self.field + PALETTE_SUFFIX: pal,
        })

    def _publish(self) -> None:
        if (self._fused_ok and not self._raw_batch and self._row
                and not self._deltas):
            self._publish_fused()
            return
        if self._deltas:
            kmax = max((len(i) for i, _ in self._deltas), default=0)
            if self._capacity is None:
                kmax = max(int(kmax * 1.3), 1)
            if self._capacity is None or kmax > self._capacity:
                self._capacity = min(
                    -(-kmax // 32) * 32, self.encoder.num_tiles
                )
            idx, tiles = pack_batch(
                self._deltas, self.encoder.num_tiles, capacity=self._capacity
            )
            fresh = True
        else:
            n = self._row
            idx = self._batch_idx[:n].copy()
            tiles = self._batch_tiles[:n]
            fresh = False
        if (
            self.alpha_slice and self._alpha_static
            and self._ref_tile_alpha is not None
        ):
            tiles = np.ascontiguousarray(tiles[..., :3])
            fresh = True
        h, w, c = self._ref.shape
        msg = {
            "_prebatched": True,
            self.field + TILEIDX_SUFFIX: idx,
            self.field + TILESHAPE_SUFFIX: tileshape_wire(
                h, w, c, (self.th, self.tw)
            ),
        }
        compressed = (palettize_tiles(tiles, native=self.native)
                      if self.palette else None)
        if compressed is not None:
            self._palette_misses = 0
            packed, pal, bits = compressed
            msg[self.field + TILEPAL_SUFFIXES[bits]] = packed
            msg[self.field + PALETTE_SUFFIX] = pal
        else:
            if self.palette:
                # colour-rich scene: stop paying the palette scan after
                # enough consecutive misses
                self._palette_misses += 1
                if self._palette_misses >= 8:
                    self.palette = False
            msg[self.field + TILES_SUFFIX] = tiles if fresh else tiles.copy()
        self._finish_publish(msg)
