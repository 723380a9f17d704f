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
- **Palette**: when the batch's changed tiles hold at most 256 colours,
  the tiles ship as 2/4/8-bit indices into one batch palette.

The changed-tile scan and the palettizer run in the port's host C++
(``native=True``, the default; a failed build raises) or in their numpy
twins (``native=False``). The JAX package's fused scan+palettize path
(per-frame palettes) is not part of this port; the consumer decodes both
palette forms.
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
    palettize_tiles,
    tileshape_wire,
)


class TileBatchPublisher:
    """Accumulates frames and publishes tile-delta batch messages through
    ``publisher`` (a :class:`blendjax_torch.transport.DataPublisherSocket`
    owned by the caller). ``ref``: the (H, W, C) uint8 reference image of
    the ``image`` field."""

    field = "image"

    def __init__(self, publisher, ref: np.ndarray, batch_size: int,
                 tile=TILE, alpha_slice: bool = True, ref_interval: int = 0,
                 capacity: int | None = None, native: bool = True):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self.publisher = publisher
        self.batch_size = int(batch_size)
        self.alpha_slice = bool(alpha_slice)
        self.ref_interval = max(0, int(ref_interval))
        self.palette = True  # latched off after repeated palette misses
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

    def add(self, image: np.ndarray, hint=None, **extras) -> None:
        """Add one frame plus its per-frame sidecar fields; publishes when
        the batch fills. ``hint`` bounds the changed-tile scan."""
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

    def _grow(self, kmax: int) -> None:
        """Overflow: widen the capacity (32-tile steps) and migrate the
        rows already packed this batch."""
        new_cap = min(-(-kmax // 32) * 32, self.encoder.num_tiles)
        old_idx, old_tiles, n = self._batch_idx, self._batch_tiles, self._row
        self._capacity = new_cap
        self._batch_idx = None
        self._ensure_batch_arrays()
        if n and old_idx is not None:
            self._batch_idx[:n, : old_idx.shape[1]] = old_idx[:n]
            self._batch_idx[:n, old_idx.shape[1]:] = self.encoder.num_tiles
            self._batch_tiles[:n, : old_tiles.shape[1]] = old_tiles[:n]
            self._batch_tiles[:n, old_tiles.shape[1]:] = 0

    def flush(self) -> None:
        """Publish a buffered partial batch (end of a finite stream)."""
        if self._deltas or self._row:
            self._publish()

    def _publish(self) -> None:
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
        self.publisher.publish(**msg)
        self.batches_published += 1
