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
a ``_mask`` before the host stage (``pad_partial=True``).

On a mesh (``mesh=``, one process per card): ``batch_size`` is the global
batch, which must divide the batch axes, and every rank runs its own
pipeline and yields its rows of each global batch, the JAX package's
multi-host form (``make_array_from_process_local_data``). Where the rows
come from depends on the source:

- Live producers (``addresses``): each data group (one rank, or the
  ranks of a model axis outside the batch) assembles its own
  ``batch_size / ways`` rows from its producers, as each JAX process feeds
  its local rows; on a model axis its first rank ingests and broadcasts
  each host batch to the group before the host stage
  (:class:`~blendjax_torch.parallel.mesh.ModelAxisGroup`). Before each
  batch the ranks agree (:class:`~blendjax_torch.parallel.mesh.RankAgreement`)
  that each has one of the same form: they end together when any data
  group's stream ends, and different forms raise (no unmatched collective).
- A recording or an iterable: every rank reads the same stream and keeps
  the rows the batch sharding (:func:`blendjax_torch.parallel.batch_sharding`,
  ``data`` with ``fsdp`` folded in) gives it, those the JAX mesh places on
  its device. The feeder places a raw batch's rows of this rank; a packed
  tile group travels whole (bytes cannot split) and each rank decodes its
  rows with K1 or K2 (:func:`~blendjax_torch.ops.tiles.decode_packed_superbatch`
  with ``mesh``). A partial tail pads to a bucket the batch axes divide.

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
import threading

import numpy as np
import torch

from blendjax_torch.constants import LOGGER_NAME
from blendjax_torch.device import resolve_device
from blendjax_torch.obs.trace import stamp_batch as trace_stamp_batch
from blendjax_torch.ops import tiles as T
from blendjax_torch.utils.metrics import metrics

logger = logging.getLogger(f"{LOGGER_NAME}.data")


def _batch_layout(mesh, data_axis: str, sharding):
    """The batch sharding of a mesh run (``sharding`` or the mesh's
    :func:`~blendjax_torch.parallel.batch_sharding`), checked; None off a
    mesh."""
    if mesh is None and sharding is None:
        return None
    from blendjax_torch.parallel.sharding import (
        batch_sharding,
        check_sharding,
        validate_batch_sharding,
    )

    if sharding is None:
        from blendjax_torch.parallel.mesh import check_mesh

        sharding = batch_sharding(check_mesh(mesh), axis=data_axis)
    return validate_batch_sharding(check_sharding(sharding),
                                   data_axis=data_axis)


def _lead_axes(sharding) -> tuple:
    from blendjax_torch.parallel.sharding import leading_axes

    return leading_axes(sharding)


def _signature(batch: dict) -> int:
    """A 62-bit hash of what decides the step program a batch runs: each
    array field's shape and dtype, the chunk group's length and its decode
    plan."""
    parts = []
    for k in sorted(batch):
        v = batch[k]
        if hasattr(v, "shape") and hasattr(v, "dtype"):
            parts.append((k, tuple(v.shape), str(v.dtype)))
        elif k == "_meta":
            parts.append((k, len(v)))
        elif k in ("_spec", "_names", "_geoms", "_rle", "_pal"):
            parts.append((k, repr(v)))
        elif k == "_refs":
            parts.append((k, sorted((n, tuple(r.shape))
                                    for n, r in v.items())))
    digest = hashlib.blake2b(repr(parts).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 2


class DeviceFeeder:
    """Places host batch dicts on ``device`` with a prefetch ring.

    On CUDA every ndarray field (rank >= 1) is written into a pinned host
    buffer (a ring per shape and dtype, a buffer reused once the copy that
    last read it has finished) and copied with ``non_blocking=True`` on a
    side stream; one event per batch orders the compute stream after the
    copies. On the CPU the arrays are wrapped without a copy. ``_meta``,
    the scenario stamps (``_scenario``, ``_scenario_rows``) and other
    non-array sidecars stay on the host as they are.

    ``throttle`` (the JAX feeder's name and default, 8) bounds the
    transfers outstanding: it is the number of pinned buffers per shape
    and dtype, so a placement waits only when all ``throttle`` of them
    still hold a copy the card has not finished. Each such wait counts
    ``feed.throttle_blocks`` and runs under the ``feed.throttle_wait``
    span, the doctor's feed-bound evidence. ``throttle=0`` (or None)
    removes the bound: a busy ring grows by one buffer instead of waiting.

    With ``mesh`` (or a batch ``sharding``) every array field but a packed
    group's buffer keeps this rank's rows (:func:`~blendjax_torch.parallel.sharding.local_rows`),
    as does a per-row ``_meta`` or ``_scenario_rows``, before the copy.
    """

    PINNED_KEYS_LIMIT = 64

    def __init__(self, device=None, prefetch: int = 2, mesh=None,
                 data_axis: str = "data", sharding=None, throttle: int = 8):
        self.sharding = _batch_layout(mesh, data_axis, sharding)
        self.device = resolve_device(device)
        self.prefetch = max(1, int(prefetch))
        self.throttle = max(0, int(throttle or 0))
        self._cuda = self.device.type == "cuda"
        self._copy_stream = (
            torch.cuda.Stream(self.device) if self._cuda else None
        )
        self._pinned: dict = {}

    @staticmethod
    def _pinned_buffer(arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.empty_like(arr)).pin_memory()

    def _pinned_slot(self, arr: np.ndarray):
        """A pinned buffer for ``arr``: the oldest of its ring once the
        copy out of it has finished, a new one while the ring is short of
        ``throttle``, else the oldest after a counted wait. The entry
        handed out holds no event until its placement records one, so a
        second field of the same shape and dtype in that placement never
        gets the same buffer (the ring grows past ``throttle`` if one
        batch holds more such fields)."""
        key = (arr.shape, arr.dtype.str)
        slots = self._pinned.get(key)
        if slots is None:
            if len(self._pinned) >= self.PINNED_KEYS_LIMIT:
                self._pinned.clear()
            slots = self._pinned[key] = collections.deque()
        # entries are handed out oldest first, so a head with no event
        # means every entry of the ring is taken by this placement
        head = slots[0][1] if slots else None
        if head is not None and head.query():
            entry = slots.popleft()
        elif (not self.throttle or len(slots) < self.throttle
              or head is None):
            entry = [self._pinned_buffer(arr), None]
        else:
            entry = slots.popleft()
            metrics.count("feed.throttle_blocks")
            with metrics.span("feed.throttle_wait"):
                head.synchronize()  # the last copy out of it is done
        entry[1] = None  # taken until this placement records its copies
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
        if self.sharding is not None:
            from blendjax_torch.parallel.sharding import local_rows

            leads = {v.shape[0] for k, v in arrays.items()
                     if k != "__packed__"}
            arrays = {k: v if k == "__packed__" else local_rows(
                v, self.sharding) for k, v in arrays.items()}
            for k in ("_meta", "_scenario_rows"):
                side = out.get(k)
                if (len(leads) == 1 and isinstance(side, list)
                        and len(side) in leads):
                    # a per-row sidecar follows its rows
                    rows = local_rows(np.arange(len(side)), self.sharding)
                    out[k] = [side[i] for i in rows]
        if not self._cuda:
            # a copy: the assembler fills its buffers again while the
            # consumer may still hold this batch (on the card the pinned
            # stager copies the batch out)
            for k, v in arrays.items():
                out[k] = torch.from_numpy(v.copy()).to(self.device)
            return out
        compute = torch.cuda.current_stream(self.device)
        entries = []
        try:
            with torch.cuda.stream(self._copy_stream):
                for k, v in arrays.items():
                    entry = self._pinned_slot(v)
                    entries.append(entry)
                    entry[0].numpy()[...] = v
                    out[k] = entry[0].to(self.device, non_blocking=True)
        finally:
            # every buffer taken, even by a placement that failed, is
            # free again once the copies queued so far have finished
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

    ``chunk_strict=True`` makes that non-tile batch raise instead
    (``RuntimeError``), for a consumer that takes superbatches only.

    ``sharding`` (the batch sharding of a mesh) makes each rank decode only
    its rows of every group. ``multihost`` is the JAX package's name for
    that form and the only one the port has (one process per card):
    ``multihost=False`` with a split batch raises.
    """

    def __init__(self, device=None, chunk: int = 1,
                 emit_packed: bool = False, sharding=None,
                 multihost: bool | None = None, chunk_strict: bool = False):
        from blendjax_torch.parallel.sharding import leading_shard_count

        if multihost is False and leading_shard_count(sharding) > 1:
            raise ValueError(
                "multihost=False: the port runs one process per card, so a "
                "split batch is always assembled per rank (the multi-host "
                "form)")
        self.sharding = sharding
        self.device = resolve_device(device)
        self.chunk = max(1, int(chunk))
        self.emit_packed = bool(emit_packed)
        self.chunk_strict = bool(chunk_strict)
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
                    if self.chunk_strict:
                        raise RuntimeError(
                            "chunk>1 requires an all-tile-encoded stream: a "
                            "non-tile message arrived, and the chunked step "
                            "consumer expects (K, B, ...) superbatches only "
                            "(chunk_strict=True)"
                        )
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
            mesh = getattr(self.sharding, "mesh", None)
            axes = _lead_axes(self.sharding)
            with metrics.span("decode.dispatch"):
                if plan[0] == "palchunk":
                    _, spec, rests, pal_groups, rle_groups = plan
                    fields = T.decode_packed_pal_superbatch(
                        db["__packed__"], spec, pal_groups, rle_groups,
                        mesh=mesh, data_axis=axes)
                else:
                    _, names, spec, rests, refs, geoms, rle_groups = plan
                    fields = T.decode_packed_superbatch(
                        db["__packed__"], refs, spec, names, geoms,
                        rle_groups, mesh=mesh, data_axis=axes)
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
    ``pad_partial=False`` keeps the exact ragged tail. ``schema`` (a
    :class:`~blendjax_torch.data.schema.StreamSchema`) fixes the stream's
    contract instead of inferring it from the first item;
    ``chunk_strict=True`` raises on a non-tile message in a chunked or
    packed stream instead of sending it as a K'=1 superbatch. Other keyword
    arguments go to the producers' stream (``record_path_prefix`` tees
    every message received to a recording, per shard); a source that is an
    iterable or a recording takes none, and any raises ``TypeError``.

    :meth:`connect` and :meth:`disconnect` change the producer set while
    the pipeline runs (the fleet controller's membership calls); an
    iterable or a recording refuses them.

    ``mesh`` (or a batch ``sharding``; ``data_axis`` names the batch axis)
    makes ``batch_size`` the global batch and yields this rank's rows (the
    module docstring): with producer addresses each rank's pipeline takes
    ``batch_size / ways`` rows from its own producers (:attr:`rank_batch`)
    and the ranks agree before each batch; a recording is read whole on
    every rank, which keeps its rows.

    With a ``launcher`` (a :class:`~blendjax_torch.launcher.ProcessLauncher`
    whose producers publish on ``addresses``) and no ``on_timeout`` of the
    caller's, a receive timeout becomes a health check of the producers:
    ``launcher.assert_alive()`` raises the launcher's dead-producer error,
    or respawns the dead with ``respawn=True``; with every producer alive
    the stream waits again, at most 3 times. Each shard stream has a retry
    budget of its own, and the checks of all shards run one at a time.
    """

    def __init__(self, addresses, batch_size: int, device=None,
                 prefetch: int = 2, chunk: int = 1, emit_packed: bool = False,
                 place_in_driver: bool = False, ingest_workers: int = 1,
                 inflate_workers: int = 2, emit_partial_final: bool = False,
                 pad_partial: bool = True, max_items: int | None = None,
                 launcher=None, mesh=None, data_axis: str = "data",
                 sharding=None, schema=None, chunk_strict: bool = False,
                 **stream_kwargs):
        from blendjax_torch.data.stream import RemoteStream
        from blendjax_torch.parallel.sharding import leading_shard_count

        live = not (hasattr(addresses, "__iter__") and not isinstance(
            addresses, (list, tuple, str)))
        if not live and stream_kwargs:
            raise TypeError(
                f"options {sorted(stream_kwargs)} go to a producers' "
                "stream; an iterable or recorded source takes none of them"
            )

        sharding = _batch_layout(mesh, data_axis, sharding)
        ways = leading_shard_count(sharding)
        if ways > 1 and int(batch_size) % ways:
            raise ValueError(
                f"batch_size={batch_size} must divide evenly over the "
                f"{ways}-way batch axis of the mesh: every card takes an "
                "equal shard of each global batch")
        self.mesh = getattr(sharding, "mesh", None)
        self.sharding = sharding
        # live producers on a mesh of several ranks: this data group's own
        # rows, agreed; on a model axis its first rank ingests them
        self.local_rows = (live and self.mesh is not None
                           and int(self.mesh.mesh.numel()) > 1)
        self.rank_batch = int(batch_size) // (ways if self.local_rows else 1)
        self._agreement = None
        self._group = None
        if self.local_rows:
            from blendjax_torch.parallel.mesh import (
                ModelAxisGroup,
                RankAgreement,
            )
            from blendjax_torch.parallel.sharding import leading_axes

            self._agreement = RankAgreement(self.mesh)
            if ways != int(self.mesh.mesh.numel()):
                self._group = ModelAxisGroup(self.mesh,
                                             leading_axes(sharding))
            sharding = None  # the rows are this rank's already
        ingests = self._group is None or self._group.is_leader

        self.launcher = launcher
        self._auto_timeout = (
            launcher is not None and "on_timeout" not in stream_kwargs
        )
        self._launcher_lock = threading.Lock()
        if self._auto_timeout:
            stream_kwargs["on_timeout"] = self._launcher_on_timeout()
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
        elif not ingests:
            # a model-axis group's other ranks receive its leader's
            # batches: no socket of theirs may take the producers' messages
            self.stream = None
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
        self.shards: list = [self.stream] if ingests else []
        self.batch_size = int(batch_size)
        self.schema = schema
        self.prefetch = prefetch
        self.ingest = None
        # a chunked stream already makes K-fold fewer transfers: no
        # throttle (the JAX package's choice)
        self.feeder = DeviceFeeder(device=self.device, prefetch=prefetch,
                                   sharding=sharding,
                                   throttle=0 if chunk > 1 else 8)
        self.tiles = TileStreamDecoder(
            device=self.device, chunk=chunk, emit_packed=emit_packed,
            sharding=sharding, chunk_strict=chunk_strict,
        )

    def _launcher_on_timeout(self):
        """A launcher health hook with a retry budget of its own (each
        shard gets a fresh one, so one silent producer cannot spend its
        peers' retries); ``assert_alive`` runs under one lock across the
        shards' threads."""
        launcher = self.launcher
        retries = {"left": 3}

        def on_timeout():
            with self._launcher_lock:
                # Runs only once the stream has already stalled (a receive
                # timeout), so the bounded liveness check costs no throughput.
                # bjx: ignore[BJX110] — as blendjax/data/pipeline.py:1416
                launcher.assert_alive()  # raises, or respawns the dead
            # every producer alive but silent: wait again a bounded
            # number of times (a slow start or a respawn), then fail
            retries["left"] -= 1
            return retries["left"] >= 0

        return on_timeout

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

    # -- elastic membership ---------------------------------------------------

    def connect(self, addr: str) -> None:
        """Admit one producer endpoint while the pipeline runs: to the
        sharded ingest pool when one is live, else to the stream (the
        socket operation runs on the thread that owns the socket). The
        address list keeps a later iteration in step."""
        if self._addresses is not None and addr not in self._addresses:
            self._addresses.append(addr)
        target = (self.ingest if hasattr(self.ingest, "connect")
                  else self.stream)
        connect = getattr(target, "connect", None)
        if connect is None:
            raise RuntimeError(
                "this pipeline's source does not support runtime "
                "membership (an iterable or a recording)")
        connect(addr)

    def disconnect(self, addr: str) -> None:
        """Drop one producer endpoint while the pipeline runs. Retire the
        producer first and keep receiving through a grace window: zmq
        drops the messages still queued on the endpoint's pipe."""
        if self._addresses is not None and addr in self._addresses:
            self._addresses.remove(addr)
        target = (self.ingest if hasattr(self.ingest, "disconnect")
                  else self.stream)
        disconnect = getattr(target, "disconnect", None)
        if disconnect is not None:
            disconnect(addr)

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
        streams = []
        for i, shard in enumerate(shards):
            if self._auto_timeout:
                kwargs["on_timeout"] = self._launcher_on_timeout()
            streams.append(RemoteStream(
                shard, worker_index=i, num_workers=len(shards),
                track_gaps=True, **kwargs))
        return streams

    def __iter__(self):
        from blendjax_torch.data.batcher import HostIngest

        if self.stream is None:  # a model-axis group's rank that receives
            self.tiles.reset()
            return self._stages(self._shared(None))
        streams = self._shard_streams()
        if streams is not None:
            from blendjax_torch.data.shard_ingest import ShardedHostIngest

            self.shards = streams
            self.ingest = ShardedHostIngest(
                streams, batch_size=self.rank_batch, schema=self.schema,
                prefetch=self.prefetch,
                emit_partial_final=self.emit_partial_final,
                max_messages=self.max_items,
                inflate_workers=self.inflate_workers,
            ).start()
        else:
            self.shards = [self.stream]
            self.ingest = HostIngest(
                self.stream, batch_size=self.rank_batch, schema=self.schema,
                prefetch=self.prefetch,
                emit_partial_final=self.emit_partial_final,
            ).start()
        self.tiles.reset()
        source = self.ingest
        if self._group is not None:
            source = self._shared(source)
        return self._stages(source)

    def _stages(self, source):
        """Host stage, feeder, device stage and the ranks' agreement over
        the ingested host batches ``source``."""
        if self.local_rows:
            source = self._until_tail(source)
        elif self.pad_partial:
            source = self._pad_partial_stage(source)
        host = self.tiles.host_stage(source)
        if self.place_in_driver:
            # host batches with their decode plans: the driver's place
            # (``TrainDriver(place=pipeline.feeder.place)``) copies each
            # to the card right before its step
            out = self.tiles.device_stage(host)
        else:
            out = self.tiles.device_stage(self.feeder(host))
        if self._agreement is not None:
            out = self._agreed(out)
        return iter(out)

    def _shared(self, batches):
        """A model-axis group's host batches: the leader ingests
        (``batches``) and broadcasts each over the group, then its end or
        its failure; the others (``batches`` None) yield what arrives."""
        group = self._group
        if batches is None:
            while True:
                got = group.share()
                if got is None:
                    return
                if isinstance(got, str):
                    raise RuntimeError(
                        f"the ingest of model-axis group leader rank "
                        f"{group.leader} failed: {got}")
                yield got
        try:
            for hb in batches:
                group.share(hb)
                yield hb
        except GeneratorExit:
            raise  # the consumers of every rank stopped at this batch
        except BaseException as e:
            group.share(f"{type(e).__name__}: {e}")
            raise
        group.share(None)

    def _agreed(self, batches):
        """Live producers on a mesh: before each batch the ranks agree
        that every one of them has one, of the same form
        (:func:`_signature`). They all stop when one rank's stream ends or
        fails (the batches the others hold then are dropped, with a
        warning); batches of different forms raise. Either way no rank
        issues a step the others do not."""
        it = iter(batches)
        while True:
            try:
                batch = next(it)
            except StopIteration:
                batch = None
            except BaseException:
                self._agreement.gather([-2])  # let the others stop too
                raise
            mine = -1 if batch is None else _signature(batch)
            got = self._agreement.gather([mine])[:, 0]
            if (got == -2).any():
                raise RuntimeError(
                    "the stream of mesh rank(s) "
                    f"{np.flatnonzero(got == -2).tolist()} failed")
            if (got < 0).any():
                if batch is not None:
                    logger.warning(
                        "live mesh pipeline: a rank's stream ended; this "
                        "rank drops the batch it holds and stops with it")
                    metrics.count("feed.mesh_dropped_batches")
                return
            if (got != got[0]).any():
                raise RuntimeError(
                    "live mesh pipeline: the ranks' batches differ in form "
                    "(shapes, chunk length or decode plan), so their steps "
                    "would issue different collectives; make every rank's "
                    "producers send the same layout")
            yield batch

    def _until_tail(self, batches):
        """Live producers on a mesh: a rank's ragged tail ends its stream
        (its mask would add a collective to its step that the other ranks'
        full batches do not issue)."""
        for hb in batches:
            if hb.get("_partial"):
                logger.warning(
                    "live mesh pipeline: a ragged tail ends this rank's "
                    "stream")
                metrics.count("feed.mesh_dropped_batches")
                return
            yield hb

    def _pad_partial_stage(self, batches):
        """Zero-pad each ``_partial`` tail batch to its bucket of
        ``batch_size`` on the host and add its float32 ``_mask``, before
        the tile handling and the placement, so every later stage sees a
        bucket shape. On a mesh the buckets are the multiples of the batch
        axes' size, so every rank keeps an equal share of a padded tail."""
        from blendjax_torch.data.batcher import bucket_sizes, pad_to_bucket
        from blendjax_torch.parallel.sharding import leading_shard_count

        buckets = None
        ways = leading_shard_count(self.sharding)
        if ways > 1:
            # never empty: the constructor enforced batch_size % ways
            buckets = tuple(b for b in bucket_sizes(self.batch_size)
                            if b % ways == 0)
        for hb in batches:
            if hb.get("_partial"):
                hb = pad_to_bucket(hb, batch_size=self.batch_size,
                                   buckets=buckets)
            yield hb

    def stop(self) -> None:
        if self.ingest is not None:
            self.ingest.stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
