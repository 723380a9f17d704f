"""Device feeding for tile-delta streams (port of ``blendjax/data/pipeline.py``).

- :class:`DeviceFeeder` places host batches on the card: each array is
  copied into a pinned host buffer and sent with one ``non_blocking`` copy
  on a side stream; the compute stream waits on that copy's event, so
  transfers overlap the steps already queued.
- :class:`TileStreamDecoder` ``host_stage`` is the single-device part of
  the JAX package's: it keeps each producer's reference image (tiled, on
  the card), validates deferred run-length buffers, and packs every chunk
  group of compatible batches into ONE uint8 buffer; ``device_stage``
  attaches the decode plan the fused train step consumes.
- :class:`StreamDataPipeline` chains stream -> ingest (one thread, or one
  per shard of the producers) -> host stage -> feeder -> device stage.

Two forms are ported: the fused form (``emit_packed=True``: packed chunk
groups that ``make_fused_tile_step`` decodes inside the step) and the
decoded form (``emit_packed=False``, the default, as in the JAX package:
every chunk group decoded on the card by K1/K2 as it arrives; with
``chunk=1`` the input of the echo reservoir, with ``chunk=K`` (K, B, ...)
superbatches). A finite stream's ``_partial`` tail is bucket-padded with
a ``_mask`` before the host stage (``pad_partial=True``). Multi-host
assembly and mesh shardings wait for the multi-GPU slice (ROADMAP Queue A
item 5).

Metrics (:mod:`blendjax_torch.utils.metrics`, the JAX package's names and
sites): the ``feed.place`` span and the ``place`` frame-trace stamp of each
placement; the host stage's ``tiles.*``, ``pal.*`` and ``rle.*`` byte and
batch counters and its ``tiles.pack`` span; the ``decode.dispatch`` span
(and the ``decode`` stamp) of the decoded form.
:meth:`StreamDataPipeline.doctor` names the run's bound
(:mod:`blendjax_torch.obs.doctor`).
"""

from __future__ import annotations

import collections
import hashlib
import logging

import numpy as np
import torch

from blendjax_torch.constants import LOGGER_NAME
from blendjax_torch.device import resolve_device
from blendjax_torch.obs.trace import stamp_batch as trace_stamp_batch
from blendjax_torch.ops import tiles as T
from blendjax_torch.utils.metrics import metrics

logger = logging.getLogger(f"{LOGGER_NAME}.data")


class DeviceFeeder:
    """Places host batch dicts on ``device`` with a prefetch ring.

    On CUDA every ndarray field (rank >= 1) is written into a pinned host
    buffer (a small ring per shape and dtype, reused once the copy that
    last read it has finished) and copied with ``non_blocking=True`` on a
    side stream; one event per batch orders the compute stream after the
    copies. On the CPU the arrays are wrapped without a copy. ``_meta``
    and scalar sidecars stay on the host.
    """

    PINNED_KEYS_LIMIT = 64

    def __init__(self, device=None, prefetch: int = 2):
        self.device = resolve_device(device)
        self.prefetch = max(1, int(prefetch))
        self._cuda = self.device.type == "cuda"
        self._copy_stream = (
            torch.cuda.Stream(self.device) if self._cuda else None
        )
        self._pinned: dict = {}
        self._ring = self.prefetch + 2

    def _pinned_slot(self, arr: np.ndarray):
        key = (arr.shape, arr.dtype.str)
        slots = self._pinned.get(key)
        if slots is None:
            if len(self._pinned) >= self.PINNED_KEYS_LIMIT:
                self._pinned.clear()
            slots = self._pinned[key] = collections.deque()
        if len(slots) < self._ring:
            entry = [torch.from_numpy(np.empty_like(arr)).pin_memory(), None]
        else:
            entry = slots.popleft()
            if entry[1] is not None:
                entry[1].synchronize()  # the last copy out of it is done
        slots.append(entry)
        return entry

    def place(self, batch: dict) -> dict:
        """One placement of a host batch (the ``feed.place`` span, and the
        ``place`` stamp on its frame traces); returns the device batch."""
        with metrics.span("feed.place"):
            out = self._place(batch)
        trace_stamp_batch(out, "place")
        return out

    def _place(self, batch: dict) -> dict:
        arrays = {
            k: v for k, v in batch.items()
            if k != "_meta" and isinstance(v, np.ndarray) and v.ndim >= 1
        }
        out = {k: v for k, v in batch.items() if k not in arrays}
        if not self._cuda:
            for k, v in arrays.items():
                out[k] = torch.from_numpy(
                    v if v.flags.writeable else v.copy()
                ).to(self.device)
            return out
        compute = torch.cuda.current_stream(self.device)
        entries = []
        with torch.cuda.stream(self._copy_stream):
            for k, v in arrays.items():
                entry = self._pinned_slot(v)
                entry[0].numpy()[...] = v
                out[k] = entry[0].to(self.device, non_blocking=True)
                entries.append(entry)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        for entry in entries:
            entry[1] = done
        compute.wait_event(done)
        for k in arrays:
            # allocated on the side stream, used on the compute stream
            out[k].record_stream(compute)
        return out

    def __call__(self, host_batches):
        """Iterate device batches, keeping ``prefetch`` placements ahead
        of the consumer."""
        ring: collections.deque = collections.deque()
        it = iter(host_batches)
        while True:
            while len(ring) < self.prefetch:
                try:
                    ring.append(self.place(next(it)))
                except StopIteration:
                    while ring:
                        yield ring.popleft()
                    return
            yield ring.popleft()


class TileStreamDecoder:
    """Host/device stage pair for tile-delta and full-frame palette
    streams in the fused form.

    ``chunk=K`` groups K consecutive compatible batches (same packed
    layout, same reference content) into one stacked (K', total) buffer;
    a mismatch flushes a shorter group. Refs are keyed per (field,
    producer ``btid``): PUSH is FIFO per producer, so a producer's
    reference precedes its deltas. In a chunked or packed stream a
    non-tile batch flushes the open group and travels alone as a K'=1
    superbatch; in the decoded form with ``chunk=1`` it passes as it is.

    ``emit_packed=False`` decodes each group on the card in
    :meth:`device_stage`: plain batches with ``chunk=1``, (K', B, ...)
    superbatches with their ``_meta`` otherwise.
    """

    def __init__(self, device=None, chunk: int = 1,
                 emit_packed: bool = False):
        self.device = resolve_device(device)
        self.chunk = max(1, int(chunk))
        self.emit_packed = bool(emit_packed)
        self._warned_mixed = False
        self._refs: dict = {}        # (name, btid) -> device ref tiles
        self._host_refs: dict = {}   # (name, btid) -> host copy
        self._ref_digest: dict = {}  # (name, btid) -> content hash
        self._shapes: dict = {}      # name -> wire geometry
        self._skipped: set = set()
        self._plans: collections.deque = collections.deque()

    def reset(self) -> None:
        """Drop queued plans (call when re-iterating a pipeline)."""
        self._plans.clear()

    def _take_refs(self, hb: dict, btid) -> None:
        new_refs: dict = {}
        T.pop_stream_refs(hb, new_refs, btid)
        for ref in new_refs.values():
            # keyframe refs are wire bytes too
            metrics.count("tiles.wire_bytes", int(ref.nbytes))
        for key, ref in new_refs.items():
            cached = self._host_refs.get(key)
            if cached is not None and np.array_equal(cached, ref):
                continue  # keyframe repeating the reference we hold
            self._host_refs[key] = np.array(ref)
            self._ref_digest[key] = int.from_bytes(
                hashlib.blake2b(
                    self._host_refs[key].tobytes(), digest_size=8
                ).digest(), "little",
            )
            tile = T.geom_tile(tuple(
                int(v) for v in hb.get(
                    key[0] + T.TILESHAPE_SUFFIX, [0, 0, 0, T.TILE]
                )
            ))
            self._refs[key] = T.tile_ref(
                torch.from_numpy(self._host_refs[key]).to(self.device), tile
            )

    def host_stage(self, host_batches):
        group: dict = {}
        pal_group: dict = {}
        for hb in host_batches:
            btid = hb.get("btid")
            self._take_refs(hb, btid)
            rle_groups = T.pop_rle_batches(hb)
            if rle_groups:
                decoded = packed_bytes = 0
                for base, (shape, isz, cap) in rle_groups:
                    buf = hb[base + T.NDR_SUFFIX]
                    T.rle_validate_packed(buf, shape, isz, cap)
                    packed_bytes += int(buf.nbytes)
                    decoded += int(np.prod(shape))
                metrics.count("rle.batches")
                metrics.count("rle.packed_bytes", packed_bytes)
                metrics.count("rle.decoded_bytes", decoded)
            has_tiles = any(k.endswith(T.TILESHAPE_SUFFIX) for k in hb)
            pal_groups = T.pop_frame_palette_batches(hb)
            if pal_groups or (rle_groups and not has_tiles):
                arrays = {
                    k: v for k, v in hb.items() if isinstance(v, np.ndarray)
                }
                rest = {k: v for k, v in hb.items() if k not in arrays}
                with metrics.span("tiles.pack"):
                    buf, spec = T.pack_fields(arrays)
                if pal_groups:
                    metrics.count("pal.batches")
                    metrics.count("pal.wire_bytes", int(buf.nbytes))
                for name, (h_, w_, c_, bits) in pal_groups:
                    lead = int(arrays[name + T.FRAMEPAL_SUFFIXES[bits]]
                               .shape[0])
                    metrics.count("pal.decoded_bytes",
                                  int(h_ * w_ * c_) * lead)
                gkey = (spec, tuple(pal_groups), rle_groups)
                if pal_group and pal_group["key"] != gkey:
                    yield from self._flush_pal_group(pal_group)
                if not pal_group:
                    pal_group.update(key=gkey, bufs=[], rests=[])
                pal_group["bufs"].append(buf)
                pal_group["rests"].append(rest)
                if len(pal_group["bufs"]) == self.chunk:
                    yield from self._flush_pal_group(pal_group)
                continue
            names = []
            missing = False
            for name, geom in T.pop_tile_batches(hb):
                if (name, btid) not in self._refs:
                    if (name, btid) not in self._skipped:
                        self._skipped.add((name, btid))
                        logger.warning(
                            "skipping tile batches for %r from producer %r "
                            "until its reference image arrives", name, btid,
                        )
                    missing = True
                    continue
                self._shapes[name] = geom
                names.append(name)
            if missing:
                continue
            if not names:
                if self.chunk > 1 or self.emit_packed:
                    if not self._warned_mixed:
                        self._warned_mixed = True
                        logger.warning(
                            "non-tile message in a chunk=%d stream: flushing "
                            "the group and sending it as a K'=1 superbatch",
                            self.chunk,
                        )
                    yield from self._flush_group(group)
                    yield from self._flush_pal_group(pal_group)
                    metrics.count("tiles.degraded_groups")
                    self._plans.append(("raw1",))
                else:  # decoded per batch: a raw batch passes as it is
                    self._plans.append(("raw",))
                yield hb
                continue
            arrays = {k: v for k, v in hb.items() if isinstance(v, np.ndarray)}
            rest = {k: v for k, v in hb.items() if k not in arrays}
            with metrics.span("tiles.pack"):
                buf, spec = T.pack_fields(arrays)
            metrics.count("tiles.batches")
            metrics.count("tiles.wire_bytes", int(buf.nbytes))
            for name in names:
                h_, w_, c_ = self._shapes[name][:3]
                lead = int(arrays[name + T.TILEIDX_SUFFIX].shape[0])
                # what the equivalent raw frames would have moved
                metrics.count("tiles.decoded_bytes", int(h_ * w_ * c_) * lead)
            gkey = (
                tuple(names), spec,
                tuple(self._ref_digest.get((n, btid)) for n in names),
                rle_groups,
            )
            if group and group["key"] != gkey:
                yield from self._flush_group(group)
            if not group:
                # refs pinned at group formation: a producer that restarts
                # with a new scene must not change an in-flight group
                group.update(
                    key=gkey, bufs=[], rests=[],
                    refs={n: self._refs[(n, btid)] for n in names},
                    geoms=tuple(self._shapes[n] for n in names),
                )
            group["bufs"].append(buf)
            group["rests"].append(rest)
            if len(group["bufs"]) == self.chunk:
                yield from self._flush_group(group)
        yield from self._flush_group(group)
        yield from self._flush_pal_group(pal_group)

    def _flush_pal_group(self, pal_group):
        if not pal_group:
            return
        spec, pal_groups, rle_groups = pal_group["key"]
        self._plans.append(
            ("palchunk", spec, pal_group["rests"], pal_groups, rle_groups)
        )
        stacked = np.stack(pal_group["bufs"])
        pal_group.clear()
        yield {"__packed__": stacked}

    def _flush_group(self, group):
        if not group:
            return
        names, spec, _digests, rle_groups = group["key"]
        self._plans.append(
            ("chunk", names, spec, group["rests"], group["refs"],
             group["geoms"], rle_groups)
        )
        stacked = np.stack(group["bufs"])
        group.clear()
        yield {"__packed__": stacked}

    def device_stage(self, device_batches):
        """Attach each placed buffer's decode plan: tile groups yield
        ``{"_packed", "_refs", "_spec", "_names", "_geoms", "_rle",
        "_meta"}``, palette groups ``{"_packed", "_spec", "_pal", "_rle",
        "_meta"}``, and a lone raw batch its fields with a leading K'=1
        axis. The decoded form (``emit_packed=False``) yields each batch's
        fields decoded instead, with its host sidecars."""
        if not self.emit_packed:
            yield from self._decoded(device_batches)
            return
        for db in device_batches:
            plan = self._plans.popleft()
            if plan[0] == "raw1":
                for k, v in list(db.items()):
                    if k != "_meta" and getattr(v, "ndim", 0) >= 1:
                        db[k] = v[None]
                yield db
                continue
            if plan[0] == "palchunk":
                _, spec, rests, pal_groups, rle_groups = plan
                yield {
                    "_packed": db["__packed__"], "_spec": spec,
                    "_pal": pal_groups, "_rle": rle_groups, "_meta": rests,
                }
                continue
            _, names, spec, rests, refs, geoms, rle_groups = plan
            yield {
                "_packed": db["__packed__"], "_refs": refs, "_spec": spec,
                "_names": tuple(names), "_geoms": geoms, "_rle": rle_groups,
                "_meta": rests,
            }

    def _decoded(self, device_batches):
        """Decode every placed group on the card (tile groups through
        K1/K2, palette groups through the byte-LUT gather). With
        ``chunk=1`` yield ``{field: (B, ...), **host sidecars}``, else
        ``{field: (K', B, ...), "_meta": [sidecars per batch]}``; a raw
        batch passes as it is (``chunk=1``) or with a leading K'=1 axis."""
        for db in device_batches:
            plan = self._plans.popleft()
            if plan[0] == "raw":
                yield db
                continue
            if plan[0] == "raw1":
                for k, v in list(db.items()):
                    if k != "_meta" and getattr(v, "ndim", 0) >= 1:
                        db[k] = v[None]
                yield db
                continue
            with metrics.span("decode.dispatch"):
                if plan[0] == "palchunk":
                    _, spec, rests, pal_groups, rle_groups = plan
                    fields = T.decode_packed_pal_superbatch(
                        db["__packed__"], spec, pal_groups, rle_groups)
                else:
                    _, names, spec, rests, refs, geoms, rle_groups = plan
                    fields = T.decode_packed_superbatch(
                        db["__packed__"], refs, spec, names, geoms,
                        rle_groups)
            if self.chunk > 1:
                out = {"_meta": rests, **fields}
            else:
                out = dict(rests[0])
                out.update({k: v[0] for k, v in fields.items()})
            trace_stamp_batch(out, "decode")
            yield out


class StreamDataPipeline:
    """Producer addresses -> device batches.

    ``addresses`` is a producer address (or list), or any iterable of
    message dicts (a :class:`~blendjax_torch.data.replay.ReplayStream`:
    :meth:`from_recording`). ``emit_packed=False`` (the default, the
    decoded form) yields each batch decoded on the card, ``{"image": (B,
    H, W, C) uint8, "xy": ..., ...}``, the input of
    :class:`~blendjax_torch.data.echo.EchoingPipeline`, or with ``chunk=K``
    (K, B, ...) superbatches. ``emit_packed=True`` (the fused form) yields
    packed groups for ``make_fused_tile_step``; ``chunk=K`` groups K
    batches per device transfer and train-step call.
    ``place_in_driver=True`` (fused form) yields the packed groups still on
    the host, for ``TrainDriver(place=pipeline.feeder.place)``. ``device=None``
    means ``cuda`` and raises when no GPU is present.

    ``ingest_workers > 1`` partitions the producer addresses over that many
    receive threads (:class:`~blendjax_torch.data.shard_ingest.ShardedHostIngest`,
    one :class:`~blendjax_torch.data.stream.RemoteStream` per shard with
    its gaps tracked) with one shared decode-ahead executor of
    ``inflate_workers`` threads (0: decode inline); ``max_items`` is then
    one budget of messages for the whole pool. An opaque iterable or a
    single address falls back to the single-thread ingest, with a warning.
    ``emit_partial_final`` emits a finite stream's ragged tail as a
    ``_partial`` batch, which ``pad_partial`` (on by default) zero-pads to
    its bucket with a float32 ``_mask`` before the host stage;
    ``pad_partial=False`` keeps the exact ragged tail. Other keyword
    arguments go to the stream (``record_path_prefix`` tees every
    message received to a recording, per shard).
    """

    def __init__(self, addresses, batch_size: int, device=None,
                 prefetch: int = 2, chunk: int = 1, emit_packed: bool = False,
                 place_in_driver: bool = False, ingest_workers: int = 1,
                 inflate_workers: int = 2, emit_partial_final: bool = False,
                 pad_partial: bool = True, max_items: int | None = None,
                 **stream_kwargs):
        from blendjax_torch.data.stream import RemoteStream

        if place_in_driver and not emit_packed:
            raise ValueError(
                "place_in_driver=True yields host batches for the driver's "
                "place; the decoded form decodes on the card in the pipeline"
            )
        self.place_in_driver = bool(place_in_driver)
        self.ingest_workers = max(1, int(ingest_workers))
        self.inflate_workers = max(0, int(inflate_workers))
        self.emit_partial_final = bool(emit_partial_final)
        self.pad_partial = bool(pad_partial)
        self.device = resolve_device(device)
        self._addresses = None
        if hasattr(addresses, "__iter__") and not isinstance(
            addresses, (list, tuple, str)
        ):
            self.stream = addresses
        else:
            self._addresses = (
                [addresses] if isinstance(addresses, str) else list(addresses)
            )
            if self.ingest_workers > 1 and (
                "worker_index" in stream_kwargs
                or "num_workers" in stream_kwargs
            ):
                raise ValueError(
                    "ingest_workers > 1 cannot be combined with explicit "
                    "worker_index/num_workers stream kwargs: the shard "
                    "pool owns the worker slots"
                )
            stream_kwargs.setdefault("defer_rle", True)
            self.stream = RemoteStream(self._addresses, max_items=max_items,
                                       **stream_kwargs)
        self._stream_kwargs = dict(stream_kwargs)
        self.max_items = max_items
        self.shards: list = [self.stream]
        self.batch_size = int(batch_size)
        self.prefetch = prefetch
        self.ingest = None
        self.feeder = DeviceFeeder(device=self.device, prefetch=prefetch)
        self.tiles = TileStreamDecoder(
            device=self.device, chunk=chunk, emit_packed=emit_packed
        )

    @classmethod
    def from_recording(cls, source, batch_size: int, loop: bool = False,
                       allow_pickle: bool = False, **kwargs):
        """Replay a ``.bjr`` recording (a path, a list of paths or a
        ``record_path_prefix``; a reference ``.btr`` needs
        ``allow_pickle=True``) through the whole pipeline: a recorded
        tile stream decodes to the same frames as the live one, with no
        producer running. ``loop=True`` replays it again and again."""
        from blendjax_torch.data.replay import ReplayStream

        return cls(ReplayStream(source, allow_pickle=allow_pickle, loop=loop),
                   batch_size=batch_size, **kwargs)

    @property
    def seq_gaps(self) -> int:
        """Messages the producers numbered that never arrived."""
        return sum(getattr(s, "seq_gaps", 0) for s in self.shards)

    @property
    def reorders(self) -> int:
        """Messages that arrived after a later number of their producer."""
        return sum(getattr(s, "reorders", 0) for s in self.shards)

    @property
    def restarts(self) -> int:
        """Producers that numbered from 0 again."""
        return sum(getattr(s, "restarts", 0) for s in self.shards)

    @property
    def messages(self) -> int:
        """Messages the shard streams accounted."""
        return sum(getattr(s, "messages", 0) for s in self.shards)

    def queue_depth(self) -> int:
        return 0 if self.ingest is None else self.ingest.queue_depth()

    def doctor(self, driver=None):
        """One-line bottleneck verdict for the live pipeline
        (:mod:`blendjax_torch.obs.doctor`) from the current metrics
        snapshot and frame lineage. ``driver`` may be a ``TrainDriver`` (or
        its ``stats``) so ring-full blocks feed the diagnosis; the
        pipeline's ``prefetch`` lets the queue-depth high-water gauge count
        as backpressure.

        >>> print(pipe.doctor().render())
        """
        from blendjax_torch.obs import diagnose_current

        stats = getattr(driver, "stats", driver)
        metrics.gauge("ingest.queue_depth", self.queue_depth())
        return diagnose_current(driver=stats, prefetch=self.prefetch)

    def shard_stats(self) -> list:
        """Per shard stream: its addresses, the messages it received off
        the socket and accounted, the items and batches ingested, its
        decodes on the inflate pool, and its wire counts (decoded and wire
        bytes, shared-memory reads and torn slots)."""
        ingest = self.ingest
        out = []
        for i, s in enumerate(self.shards):
            if ingest is None:
                items = batches = 0
            elif hasattr(ingest, "shard_items"):
                items = ingest.shard_items[i]
                batches = ingest.shard_batches[i]
            else:
                items, batches = ingest.items_in, ingest.batches_out
            counts = getattr(s, "counts", None)
            out.append({
                "addresses": list(getattr(s, "addresses", ())),
                "received": getattr(s, "received", None),
                "messages": getattr(s, "messages", None),
                "items": items, "batches": batches,
                "pool_decodes": getattr(s, "pool_decodes", 0),
                **(counts.as_dict() if counts is not None else {}),
            })
        return out

    def _shard_streams(self):
        """One stream per partition of the addresses, or None when the
        pipeline takes the single-thread ingest."""
        if self.ingest_workers <= 1:
            return None
        from blendjax_torch.data.stream import RemoteStream, partition_addresses

        if self._addresses is None:
            logger.warning(
                "ingest_workers=%d requested but the source is an opaque "
                "iterable (not producer addresses): falling back to "
                "single-threaded ingest", self.ingest_workers,
            )
            return None
        shards = partition_addresses(self._addresses, self.ingest_workers)
        if len(shards) < 2:
            logger.warning(
                "ingest_workers=%d requested but only one producer address "
                "is available: falling back to single-threaded ingest",
                self.ingest_workers,
            )
            return None
        kwargs = dict(self._stream_kwargs)
        # enable_recording() may have set the tee after construction:
        # each shard records to its own worker-indexed file
        prefix = getattr(self.stream, "record_path_prefix", None)
        if prefix is not None:
            kwargs["record_path_prefix"] = prefix
            kwargs["record_max_messages"] = self.stream.record_max_messages
        return [
            RemoteStream(shard, worker_index=i, num_workers=len(shards),
                         track_gaps=True, **kwargs)
            for i, shard in enumerate(shards)
        ]

    def __iter__(self):
        from blendjax_torch.data.batcher import HostIngest

        streams = self._shard_streams()
        if streams is not None:
            from blendjax_torch.data.shard_ingest import ShardedHostIngest

            self.shards = streams
            self.ingest = ShardedHostIngest(
                streams, batch_size=self.batch_size, prefetch=self.prefetch,
                emit_partial_final=self.emit_partial_final,
                max_messages=self.max_items,
                inflate_workers=self.inflate_workers,
            ).start()
        else:
            self.shards = [self.stream]
            self.ingest = HostIngest(
                self.stream, batch_size=self.batch_size,
                prefetch=self.prefetch,
                emit_partial_final=self.emit_partial_final,
            ).start()
        self.tiles.reset()
        source = (self._pad_partial_stage(self.ingest) if self.pad_partial
                  else self.ingest)
        host = self.tiles.host_stage(source)
        if self.place_in_driver:
            # host batches with their decode plans: the driver's place
            # (``TrainDriver(place=pipeline.feeder.place)``) copies each
            # to the card right before its step
            return iter(self.tiles.device_stage(host))
        return iter(self.tiles.device_stage(self.feeder(host)))

    def _pad_partial_stage(self, batches):
        """Zero-pad each ``_partial`` tail batch to its bucket of
        ``batch_size`` on the host and add its float32 ``_mask``, before
        the tile handling and the placement, so every later stage sees a
        bucket shape."""
        from blendjax_torch.data.batcher import pad_to_bucket

        for hb in batches:
            if hb.get("_partial"):
                hb = pad_to_bucket(hb, batch_size=self.batch_size)
            yield hb

    def stop(self) -> None:
        if self.ingest is not None:
            self.ingest.stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
