"""Host-side batch assembly (copied from ``blendjax/data/batcher.py``;
the sharded ingest is in :mod:`blendjax_torch.data.shard_ingest`).

:class:`HostIngest` runs the stream on a background thread: per-item
messages are validated and written into preallocated, recycled batch
buffers (:class:`BatchAssembler`); prebatched messages (tile-delta
batches) pass through untouched. A bounded queue plus the socket HWMs
carry backpressure to the producers.

Metrics (:mod:`blendjax_torch.utils.metrics`, the JAX package's names and
sites): the ``ingest.recv`` span (the ingest thread blocked on the stream)
and ``ingest.queue_wait`` (the consumer blocked on the queue);
``ingest.items``, ``ingest.batches`` and ``ingest.queue_full_waits``; the
``ingest.queue_depth`` gauge and its ``ingest.queue_depth_hwm``. A sampled
frame trace is popped off its message, stamped ``batch`` and rides the
next batch emitted (``_traces``).
"""

from __future__ import annotations

import logging
import queue
import threading
import time

import numpy as np

from blendjax_torch.constants import LOGGER_NAME
from blendjax_torch.data.schema import SchemaError, StreamSchema
from blendjax_torch.obs.trace import TRACE_KEY, TRACES_KEY
from blendjax_torch.obs.trace import stage as trace_stage
from blendjax_torch.utils.metrics import metrics

logger = logging.getLogger(f"{LOGGER_NAME}.data")


def batched_views(item: dict):
    """Per-item views of a producer-batched message (every ndarray field
    carries a leading batch dim); other fields replicate into each item."""
    lead = next(
        (v.shape[0] for v in item.values()
         if isinstance(v, np.ndarray) and v.ndim > 0),
        0,
    )
    for i in range(lead):
        yield {
            k: v[i] if isinstance(v, np.ndarray) and v.shape[:1] == (lead,)
            else v
            for k, v in item.items()
        }


def passthrough_batch(item: dict, schema: StreamSchema, batch_size: int):
    """A producer-batched item whose fields already match the schema at
    ``batch_size`` is a batch: hand it on with zero copies (None when any
    field mismatches)."""
    for k, spec in schema.fields.items():
        v = item.get(k)
        if not (
            isinstance(v, np.ndarray)
            and v.shape == (batch_size, *spec.shape)
            and v.dtype == spec.dtype
        ):
            return None
    batch = {k: item[k] for k in schema.fields}
    meta = {k: item[k] for k in schema.meta_keys if k in item}
    batch["_meta"] = [
        {k: v[i] if isinstance(v, np.ndarray) and len(v) == batch_size else v
         for k, v in meta.items()}
        for i in range(batch_size)
    ]
    return batch


def bucket_sizes(batch_size: int) -> tuple:
    """Power-of-two bucket ladder up to and including ``batch_size``."""
    batch_size = max(1, int(batch_size))
    sizes = []
    b = 1
    while b < batch_size:
        sizes.append(b)
        b <<= 1
    sizes.append(batch_size)
    return tuple(sizes)


def pad_to_bucket(batch: dict, batch_size: int | None = None,
                  buckets=None) -> dict:
    """Zero-pad a partial batch's leading dim up to a bucket and attach a
    float32 ``_mask`` (1 for real rows): the masked losses then score the
    padded batch like its exact-shape form. Works on numpy arrays and on
    tensors."""
    meta = batch.get("_meta")
    if isinstance(meta, list) and meta:
        lead = len(meta)
    else:
        counts: dict = {}
        for v in batch.values():
            if getattr(v, "ndim", 0) >= 1:
                counts[v.shape[0]] = counts.get(v.shape[0], 0) + 1
        lead = max(counts, key=lambda s: (counts[s], s), default=0)
    if not lead:
        return batch
    if buckets is None:
        buckets = bucket_sizes(batch_size) if batch_size else ()
    target = min((b for b in buckets if b >= lead), default=None)
    if target is None:
        target = 1
        while target < lead:
            target <<= 1
    out = {}
    device = None  # where the batch's tensors live, if it has any
    for k, v in batch.items():
        if k == "_partial":
            continue
        if getattr(v, "ndim", 0) >= 1 and v.shape[0] == lead and target > lead:
            if isinstance(v, np.ndarray):
                v = np.pad(v, [(0, target - lead)] + [(0, 0)] * (v.ndim - 1))
            else:
                import torch

                pad = torch.zeros(
                    (target - lead, *v.shape[1:]), dtype=v.dtype,
                    device=v.device,
                )
                v = torch.cat([v, pad])
        if not isinstance(v, np.ndarray) and hasattr(v, "device"):
            device = v.device
        out[k] = v
    mask = np.zeros(target, np.float32)
    mask[:lead] = 1.0
    if device is not None:  # a tensor batch gets a tensor mask beside it
        import torch

        # non_blocking: a pageable source is staged before the call
        # returns, and the copy does not wait for the queued steps
        mask = torch.from_numpy(mask).to(device, non_blocking=True)
    out["_mask"] = mask
    return out


def prebatched_lead(item: dict) -> int:
    """Leading dim of a prebatched message: its ``*__tileidx`` field's
    when present, else the first array field's."""
    from blendjax_torch.ops.tiles import TILEIDX_SUFFIX

    for k, v in item.items():
        if k.endswith(TILEIDX_SUFFIX) and isinstance(v, np.ndarray) and v.ndim:
            return v.shape[0]
    return next(
        (v.shape[0] for v in item.values()
         if isinstance(v, np.ndarray) and v.ndim > 0),
        0,
    )


class BatchAssembler:
    """Packs per-item dicts into a pool of ``num_buffers`` preallocated
    batch dicts, cycled so a completed batch stays valid while it is
    transferred."""

    def __init__(self, schema: StreamSchema, batch_size: int,
                 num_buffers: int = 3):
        self.schema = schema
        self.batch_size = int(batch_size)
        self._pool = [
            {k: np.empty((self.batch_size, *spec.shape), spec.dtype)
             for k, spec in schema.fields.items()}
            for _ in range(num_buffers)
        ]
        self._meta: list = []
        self._cursor = 0
        self._active = 0

    def add(self, item: dict):
        """Add one item; returns the completed batch when full, else None."""
        buf = self._pool[self._active]
        for k in self.schema.fields:
            buf[k][self._cursor] = item[k]
        self._meta.append(
            {k: item[k] for k in self.schema.meta_keys if k in item}
        )
        self._cursor += 1
        if self._cursor < self.batch_size:
            return None
        batch = dict(buf)
        batch["_meta"] = self._meta
        self._meta = []
        self._cursor = 0
        self._active = (self._active + 1) % len(self._pool)
        return batch

    def flush(self):
        """The partial final batch (fields cut to the filled rows, tagged
        ``_partial=True``), or None when nothing is pending."""
        if self._cursor == 0:
            return None
        buf = self._pool[self._active]
        batch = {k: buf[k][: self._cursor] for k in self.schema.fields}
        batch["_meta"] = self._meta
        batch["_partial"] = True
        self._meta = []
        self._cursor = 0
        self._active = (self._active + 1) % len(self._pool)
        return batch


def infer_schema(item: dict, batched: bool) -> StreamSchema:
    """The stream schema from the first item (the first row of a
    producer-batched message)."""
    first = next(batched_views(item), None) if batched else item
    if first is None:
        raise SchemaError(
            "batched message has no array field with a leading batch dim "
            f"(keys: {sorted(item)})"
        )
    return StreamSchema.infer(first)


def warn_prebatched_lead(owner, lead: int) -> None:
    """Warn once per ingest when a prebatched message's lead differs
    from the pipeline's batch size (it passes through as it is)."""
    if lead != owner.batch_size and not owner._warned_prebatch:
        owner._warned_prebatch = True
        logger.warning(
            "prebatched message carries %d items but the pipeline "
            "batch_size is %d; passing through as-is", lead, owner.batch_size,
        )


class HostIngest:
    """Background thread: stream -> validate -> assemble -> bounded queue.

    ``validate_every`` validates one item in N against the schema;
    ``emit_partial_final`` emits a finite stream's ragged tail as a
    ``_partial=True`` batch instead of dropping it."""

    _DONE = object()

    def __init__(self, stream, batch_size: int,
                 schema: StreamSchema | None = None, prefetch: int = 2,
                 validate_every: int = 1, emit_partial_final: bool = False):
        self.stream = stream
        self.batch_size = batch_size
        self.schema = schema
        self.prefetch = prefetch
        self.validate_every = max(1, int(validate_every))
        self.emit_partial_final = bool(emit_partial_final)
        self._queue: queue.Queue = queue.Queue(maxsize=prefetch)
        self._error: BaseException | None = None
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._warned_prebatch = False
        self._pending_traces: list = []
        self.batches_out = 0
        self.items_in = 0

    def _emit(self, batch) -> None:
        if self._pending_traces:
            batch[TRACES_KEY] = self._pending_traces
            self._pending_traces = []
        depth = self._queue.qsize()
        metrics.gauge("ingest.queue_depth", depth)
        metrics.gauge_max("ingest.queue_depth_hwm", depth)
        while not self._stop.is_set():
            try:
                self._queue.put(batch, timeout=0.25)
                self.batches_out += 1
                metrics.count("ingest.batches")
                return
            except queue.Full:
                metrics.count("ingest.queue_full_waits")
                continue

    def _run(self):
        try:
            assembler = None
            exhausted = False
            stream_it = iter(self.stream)
            while True:
                with metrics.span("ingest.recv"):
                    try:
                        item = next(stream_it)
                    except StopIteration:
                        exhausted = True
                        break
                if self._stop.is_set():
                    break
                # the sampled trace is a publish stamp, not a data field:
                # off the item before the schema sees it; it rides the
                # next batch emitted
                tr = item.pop(TRACE_KEY, None)
                if tr is not None:
                    trace_stage(tr, "batch")
                    self._pending_traces.append(tr)
                if item.pop("_prebatched", False):
                    lead = prebatched_lead(item)
                    warn_prebatched_lead(self, lead)
                    self.items_in += lead
                    metrics.count("ingest.items", lead)
                    self._emit(item)
                    continue
                batched = bool(item.pop("_batched", False))
                if self.schema is None:
                    self.schema = infer_schema(item, batched)
                if assembler is None:
                    assembler = BatchAssembler(
                        self.schema, self.batch_size,
                        num_buffers=self.prefetch + 1,
                    )
                if batched:
                    whole = passthrough_batch(item, self.schema, self.batch_size)
                    if whole is not None:
                        self.items_in += self.batch_size
                        metrics.count("ingest.items", self.batch_size)
                        self._emit(whole)
                        continue
                    items = batched_views(item)
                else:
                    items = (item,)
                for one in items:
                    if self.items_in % self.validate_every == 0:
                        self.schema.validate(one)
                    self.items_in += 1
                    metrics.count("ingest.items")
                    batch = assembler.add(one)
                    if batch is not None:
                        self._emit(batch)
            if exhausted and self.emit_partial_final and assembler is not None:
                tail = assembler.flush()
                if tail is not None:
                    self._emit(tail)
        except BaseException as e:  # re-raised in the consumer thread
            self._error = e
        finally:
            while True:  # the sentinel must be delivered (or stop() wins)
                try:
                    self._queue.put(self._DONE, timeout=0.25)
                    break
                except queue.Full:
                    if self._stop.is_set():
                        break

    def start(self) -> "HostIngest":
        if self._thread is not None:
            raise RuntimeError("already started")
        clear = getattr(self.stream, "clear_stop_request", None)
        if clear is not None:
            clear()
        self._thread = threading.Thread(
            target=self._run, name="blendjax-torch-ingest", daemon=True
        )
        self._thread.start()
        return self

    def queue_depth(self) -> int:
        """Current prefetch-queue occupancy (observability gauge)."""
        return self._queue.qsize()

    def _get(self):
        """The next queued batch, or ``None`` once ``stop()`` drained the
        end-of-stream sentinel (a consumer on another thread must still
        see the end)."""
        while True:
            try:
                return self._queue.get(timeout=0.25)
            except queue.Empty:
                if self._stop.is_set() and not self._thread.is_alive():
                    return None

    def __iter__(self):
        if self._thread is None:
            self.start()
        while True:
            with metrics.span("ingest.queue_wait"):
                batch = self._get()
            if batch is None:
                return
            if batch is self._DONE:
                if self._error is not None:
                    raise self._error
                return
            yield batch

    def stop(self, timeout: float = 10.0):
        self._stop.set()
        request_stop = getattr(self.stream, "request_stop", None)
        if request_stop is not None:
            request_stop()
        if self._thread is None:
            return
        deadline = time.monotonic() + timeout
        while self._thread.is_alive():
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            self._thread.join(timeout=min(0.05, remaining))
        if self._thread.is_alive():
            raise RuntimeError(
                f"ingest thread did not exit within {timeout:.1f}s of stop()"
            )
