"""``RemoteIterableDataset`` for ``torch.utils.data.DataLoader``, copied
from ``blendjax/data/torch_compat.py``: the reference's class shape, on
the port's transport, for users who keep their ``DataLoader`` loop.

Each ``DataLoader`` worker opens its own stream and takes its share of
``max_items`` (through ``get_worker_info()``). Messages are normalised to
per-item dicts: producer-batched messages (``_batched`` /
``_prebatched``) are split, and tile-delta and full-frame palette messages
are rebuilt on the host with the port's numpy tile codec, bit-exact, so
items carry plain ``image`` arrays whatever the wire encoding.
``max_items`` counts items after that split. The trace and scenario
stamps (:data:`TRACE_KEY`, :data:`SCENARIO_KEY`) are dropped, since
``default_collate`` needs the same keys in every item. Recording waits
for the replay slice.
"""

from __future__ import annotations

import itertools
import logging

import torch.utils.data as tud

from blendjax_torch import constants
from blendjax_torch.constants import LOGGER_NAME
from blendjax_torch.data.batcher import batched_views
from blendjax_torch.data.stream import RECORDING_NOT_PORTED, RemoteStream

logger = logging.getLogger(f"{LOGGER_NAME}.data")

# the JAX package's sampled frame-trace and scenario stamp keys
TRACE_KEY = "_trace"
SCENARIO_KEY = "_scenario"

# consecutive tile messages skipped for want of a reference before the
# dataset gives up
MAX_CONSECUTIVE_SKIPS = 64


class RemoteIterableDataset(tud.IterableDataset):
    """Items from all producer ``addresses``, one stream per worker."""

    def __init__(self, addresses,
                 queue_size: int = constants.DEFAULT_QUEUE_SIZE,
                 timeoutms: int = constants.DEFAULT_TIMEOUTMS,
                 max_items: int | None = None, item_transform=None,
                 record_path_prefix: str | None = None,
                 allow_pickle: bool = False):
        if record_path_prefix is not None:
            raise NotImplementedError(RECORDING_NOT_PORTED)
        self.addresses = addresses
        self.queue_size = queue_size
        self.timeoutms = timeoutms
        self.max_items = max_items
        self.item_transform = item_transform
        self.allow_pickle = bool(allow_pickle)
        self._refs: dict = {}     # (field, btid) -> reference image
        self._skipped: set = set()

    def enable_recording(self, prefix: str):
        raise NotImplementedError(RECORDING_NOT_PORTED)

    def stream_length(self, max_items: int):
        self.max_items = max_items

    def _items(self, stream):
        """Messages -> items: rebuild tile deltas on the host, split
        producer-batched messages, apply ``item_transform``. References
        persist on the instance across epochs; a tile message whose
        reference has not reached this worker yet is skipped (producers
        feeding several workers should resend it: ``ref_interval``)."""
        from blendjax_torch.ops.tiles import (
            TILEIDX_SUFFIX,
            decode_tile_delta_np,
            expand_palette_frames_np,
            expand_palette_tiles_np,
            pop_frame_palette_batches,
            pop_frame_palette_payload,
            pop_stream_refs,
            pop_tile_batches,
            pop_tile_payload,
        )

        transform = self.item_transform or (lambda x: x)
        consecutive_skips = 0
        for msg in stream:
            msg.pop(TRACE_KEY, None)
            msg.pop(SCENARIO_KEY, None)
            batched = bool(msg.pop("_batched", False)) | bool(
                msg.pop("_prebatched", False)
            )
            btid = msg.get("btid")
            pop_stream_refs(msg, self._refs, btid)
            for name, (h, w, c, bits) in pop_frame_palette_batches(msg):
                msg[name] = pop_frame_palette_payload(
                    msg, name, bits, h, w, c, expand_palette_frames_np
                )
            skip = False
            for name, geom in pop_tile_batches(msg):
                ref = self._refs.get((name, btid))
                if ref is None:
                    if (name, btid) not in self._skipped:
                        self._skipped.add((name, btid))
                        logger.warning(
                            "skipping tile messages for %r from producer %r "
                            "until a reference image arrives", name, btid,
                        )
                    skip = True
                    continue
                idx = msg.pop(name + TILEIDX_SUFFIX)
                tiles = pop_tile_payload(msg, name, geom,
                                         expand_palette_tiles_np)
                msg[name] = decode_tile_delta_np(ref, idx, tiles)
            if skip:
                consecutive_skips += 1
                if consecutive_skips >= MAX_CONSECUTIVE_SKIPS:
                    raise RuntimeError(
                        f"{MAX_CONSECUTIVE_SKIPS} consecutive tile messages "
                        "skipped waiting for a reference image; with several "
                        "DataLoader workers set TileBatchPublisher("
                        "ref_interval=N) so every worker receives one"
                    )
                continue
            consecutive_skips = 0
            if not batched:
                yield transform(msg)
                continue
            for item in batched_views(msg):
                yield transform(item)

    def __iter__(self):
        info = tud.get_worker_info()
        worker_index = info.id if info is not None else 0
        num_workers = info.num_workers if info is not None else 1
        # the message stream runs unbounded: max_items caps items after
        # the batch split, with the reference's per-worker share
        stream = RemoteStream(
            self.addresses, queue_size=self.queue_size,
            timeoutms=self.timeoutms, worker_index=worker_index,
            num_workers=num_workers, copy_arrays=True,
            allow_pickle=self.allow_pickle,
        )
        messages = iter(stream)
        items = self._items(messages)
        if self.max_items is None:
            return items
        share = self.max_items // num_workers
        if worker_index == 0:
            share += self.max_items % num_workers

        def capped():
            try:
                yield from itertools.islice(items, share)
            finally:
                items.close()
                messages.close()  # the socket closes at the cap

        return capped()
