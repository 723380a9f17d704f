"""Sharded parallel ingest: one receive/decode worker thread per shard of
the producer fleet (copied from ``blendjax/data/shard_ingest.py``).

:class:`~blendjax_torch.data.batcher.HostIngest` receives, decodes,
validates and copies every item on one thread behind one PULL socket.
Here the fleet is partitioned over N workers:

- each worker iterates its own stream, so its PULL socket is made on the
  worker thread (a zmq socket belongs to one thread);
- zmq receives, zlib inflates and numpy copies release the GIL, so the
  workers overlap on real cores;
- items go straight into shared batch buffers through a slot reservation
  that locks only the cursor (:class:`ParallelBatchAssembler`);
- completed batches go into one bounded queue, so backpressure still
  reaches the producers' sockets;
- one shared executor (``inflate_workers``) decodes ahead for every
  shard stream (:meth:`~blendjax_torch.data.stream.RemoteStream.set_inflate_pool`).

Batches come out in completion order: PUSH/PULL fan-in gives no order
across producers anyway. Each producer's whole stream lands on one shard,
whose stream accounts its lineage (gaps, reorders, restarts) exactly as
the single-thread path does. Counters are plain attributes,
``shard_items`` and ``shard_batches`` (one entry per shard), summed by
``items_in`` and ``batches_out``, and the registry's, as in
:class:`~blendjax_torch.data.batcher.HostIngest` (the recv span is
``ingest.recv.shard<i>``, one per shard). A sampled frame trace rides the
batch that holds its message's first item.
"""

from __future__ import annotations

# bjx: hot-path (the parallel receive/decode/assemble loop: BJX107,
# BJX109, BJX110 and BJX116 hold in this module)

import concurrent.futures
import queue
import threading
import time

import numpy as np

from blendjax_torch.data.batcher import (
    batched_views,
    infer_schema,
    passthrough_batch,
    prebatched_lead,
    warn_prebatched_lead,
)
from blendjax_torch.data.schema import StreamSchema
from blendjax_torch.obs.trace import TRACE_KEY, TRACES_KEY
from blendjax_torch.obs.trace import stage as trace_stage
from blendjax_torch.utils.metrics import metrics


class _PendingBatch:
    """One batch being filled: its buffers and a countdown of slots; the
    writer of the last slot emits it."""

    __slots__ = ("buffers", "index", "meta", "remaining", "lock", "traces")

    def __init__(self, buffers: dict, batch_size: int, index: int = 0):
        self.buffers = buffers
        self.index = index  # of ``buffers`` in the assembler's pool
        self.meta: list = [None] * batch_size
        self.remaining = batch_size
        self.lock = threading.Lock()
        # sampled traces riding this batch: appended between a writer's
        # reserve() and write(), so the completing write sees them all
        self.traces: list = []


class ParallelBatchAssembler:
    """Slot-reserving batch assembler for concurrent writers.

    :meth:`reserve` hands out ``(pending, slot)`` under a short lock (the
    cursor and the buffer rotation only); :meth:`write` copies the item
    into its slot with no lock held and returns the completed batch when
    it filled the batch's last outstanding slot. Size the buffer pool to
    at least the pending batches + the queue depth + 1.

    The pool rotates over the buffers whose batch is complete: a buffer
    whose batch still has a slot reserved and unwritten (its writer
    descheduled while later batches fill) is skipped, and when every
    buffer holds an incomplete batch :meth:`reserve` waits for one to
    complete. Rotating blindly would hand that buffer to a new batch, and
    the late write would land in the new batch while the old one came out
    with the new one's rows.
    """

    def __init__(self, schema: StreamSchema, batch_size: int,
                 num_buffers: int = 4):
        self.schema = schema
        self.batch_size = int(batch_size)
        self._pool = [
            {k: np.empty((self.batch_size, *spec.shape), spec.dtype)
             for k, spec in schema.fields.items()}
            for _ in range(num_buffers)
        ]
        self._lock = threading.Lock()
        # notified when a batch completes and frees its buffer's turn
        self._completed = threading.Condition(self._lock)
        self._incomplete: set = set()  # pool indices of unfinished batches
        self._active = 0
        self._cursor = 0
        self._pending: _PendingBatch | None = None

    def reserve(self) -> tuple:
        """Claim one slot; returns ``(pending, slot_index)``. A new batch
        takes the next buffer in rotation whose batch is complete, and
        waits while none is."""
        n = len(self._pool)
        with self._lock:
            while self._pending is None:
                index = next((i % n for i in range(self._active,
                                                   self._active + n)
                              if i % n not in self._incomplete), None)
                if index is None:
                    self._completed.wait()
                    continue
                self._active = (index + 1) % n
                self._incomplete.add(index)
                self._pending = _PendingBatch(self._pool[index],
                                              self.batch_size, index)
                self._cursor = 0
            pending = self._pending
            slot = self._cursor
            self._cursor += 1
            if self._cursor == self.batch_size:
                self._pending = None
            return pending, slot

    def write(self, pending: _PendingBatch, slot: int, item: dict):
        """Fill a reserved slot; the completed batch when this was its last
        outstanding slot, else None."""
        buf = pending.buffers
        for k in self.schema.fields:
            buf[k][slot] = item[k]
        pending.meta[slot] = {
            k: item[k] for k in self.schema.meta_keys if k in item
        }
        with pending.lock:
            pending.remaining -= 1
            done = pending.remaining == 0
        if not done:
            return None
        with self._lock:
            self._incomplete.discard(pending.index)
            self._completed.notify()
        batch = dict(pending.buffers)
        batch["_meta"] = pending.meta
        if pending.traces:
            batch[TRACES_KEY] = pending.traces
        return batch

    def add(self, item: dict):
        """Reserve and write in one call."""
        pending, slot = self.reserve()
        return self.write(pending, slot, item)

    def flush(self):
        """The partial final batch (``_partial=True``), or None. Call it
        only once every writer has stopped."""
        with self._lock:
            pending, filled = self._pending, self._cursor
            self._pending = None
            if pending is not None:
                self._incomplete.discard(pending.index)
        if pending is None or filled == 0:
            return None
        batch = {k: pending.buffers[k][:filled] for k in self.schema.fields}
        batch["_meta"] = pending.meta[:filled]
        batch["_partial"] = True
        if pending.traces:
            batch[TRACES_KEY] = pending.traces
        return batch


class ShardedHostIngest:
    """N worker threads, one stream each: receive -> decode -> validate ->
    parallel assembly -> one bounded queue.

    ``streams`` holds one iterable per shard, typically
    :class:`~blendjax_torch.data.stream.RemoteStream` over a partition of
    the producer addresses
    (:func:`~blendjax_torch.data.stream.partition_addresses`). Iterate it
    like :class:`~blendjax_torch.data.batcher.HostIngest`: an error on any
    shard is raised in the consumer, and ``stop()`` winds every worker
    down. ``max_messages`` is one budget for the whole pool (shards own
    disjoint producers, so an even split could wait on messages only
    another shard receives). ``inflate_workers`` sizes the executor shared
    by every stream that takes one; 0 decodes inline.
    """

    _DONE = object()

    def __init__(self, streams, batch_size: int,
                 schema: StreamSchema | None = None, prefetch: int = 2,
                 validate_every: int = 1, emit_partial_final: bool = False,
                 max_messages: int | None = None, inflate_workers: int = 2):
        self.streams = list(streams)
        if not self.streams:
            raise ValueError("ShardedHostIngest needs at least one stream")
        self.inflate_workers = max(0, int(inflate_workers))
        self._inflate_pool = None
        self.batch_size = int(batch_size)
        self.schema = schema
        self.prefetch = prefetch
        self.validate_every = max(1, int(validate_every))
        self.emit_partial_final = bool(emit_partial_final)
        self._queue: queue.Queue = queue.Queue(maxsize=prefetch)
        self._threads: list = []
        self._error: BaseException | None = None
        self._warned_prebatch = False
        self._infer_lock = threading.Lock()
        self._assembler: ParallelBatchAssembler | None = None
        self._active = 0
        self._active_lock = threading.Lock()
        # set by stop() only: on the budget and error paths the consumer
        # still drains and waits for the end sentinel
        self._consumer_stop = False
        self._msg_budget = None if max_messages is None else int(max_messages)
        self._budget_lock = threading.Lock()
        # one slot per shard, each written by its own worker only
        self.shard_items = [0] * len(self.streams)
        self.shard_batches = [0] * len(self.streams)

    @property
    def items_in(self) -> int:
        return sum(self.shard_items)

    @property
    def batches_out(self) -> int:
        return sum(self.shard_batches)

    # -- elastic membership --------------------------------------------------

    def connect(self, addr: str) -> None:
        """Admit a producer endpoint: the shard with the fewest addresses
        takes it (its own worker applies it to its socket)."""
        if self._addr_owner(addr) is not None:
            return
        shard = min(
            (s for s in self.streams if hasattr(s, "connect")),
            key=lambda s: len(getattr(s, "addresses", ())), default=None,
        )
        if shard is None:
            raise RuntimeError("no shard stream supports runtime connect()")
        shard.connect(addr)

    def disconnect(self, addr: str) -> None:
        """Retire a producer endpoint from the shard that owns it."""
        owner = self._addr_owner(addr)
        if owner is not None:
            owner.disconnect(addr)

    def _addr_owner(self, addr: str):
        for s in self.streams:
            if addr in getattr(s, "addresses", ()):
                return s
        return None

    def _request_stop_all(self) -> None:
        for stream in self.streams:
            request_stop = getattr(stream, "request_stop", None)
            if request_stop is not None:
                request_stop()

    # -- worker side ---------------------------------------------------------

    def _emit(self, idx: int, batch) -> None:
        depth = self._queue.qsize()
        metrics.gauge("ingest.queue_depth", depth)
        metrics.gauge_max("ingest.queue_depth_hwm", depth)
        # bail only when the consumer is gone
        while not self._consumer_stop:
            try:
                self._queue.put(batch, timeout=0.25)
                # bjx: ignore[BJX117] — per-slot single-writer, as blendjax/data/shard_ingest.py:311
                self.shard_batches[idx] += 1
                metrics.count("ingest.batches")
                return
            except queue.Full:
                metrics.count("ingest.queue_full_waits")
                continue

    def _ensure_assembler(self, item: dict, batched: bool):
        """Schema inference and the assembler, once, under a lock: the
        first item of any shard sets the schema every shard validates
        against."""
        with self._infer_lock:
            if self.schema is None:
                self.schema = infer_schema(item, batched)
            if self._assembler is None:
                # every worker may hold a pending batch while the queue
                # holds `prefetch` and the consumer one more
                self._assembler = ParallelBatchAssembler(
                    self.schema, self.batch_size,
                    num_buffers=self.prefetch + len(self.streams) + 2,
                )
        return self._assembler

    def _consume(self, idx: int, item: dict) -> None:
        tr = item.pop(TRACE_KEY, None)
        if tr is not None:
            trace_stage(tr, "batch")
        if item.pop("_prebatched", False):
            lead = prebatched_lead(item)
            warn_prebatched_lead(self, lead)
            # bjx: ignore[BJX117] — per-slot single-writer, as blendjax/data/shard_ingest.py:365
            self.shard_items[idx] += lead
            metrics.count("ingest.items", lead)
            if tr is not None:
                item[TRACES_KEY] = [tr]
            self._emit(idx, item)
            return
        batched = bool(item.pop("_batched", False))
        assembler = self._assembler
        if assembler is None:
            assembler = self._ensure_assembler(item, batched)
        if batched:
            whole = passthrough_batch(item, self.schema, self.batch_size)
            if whole is not None:
                self.shard_items[idx] += self.batch_size
                metrics.count("ingest.items", self.batch_size)
                if tr is not None:
                    whole[TRACES_KEY] = [tr]
                self._emit(idx, whole)
                return
            items = batched_views(item)
        else:
            items = (item,)
        for one in items:
            if self.shard_items[idx] % self.validate_every == 0:
                self.schema.validate(one)
            self.shard_items[idx] += 1
            metrics.count("ingest.items")
            pending, slot = assembler.reserve()
            if tr is not None:
                # once, on the batch holding the message's first item
                with pending.lock:
                    pending.traces.append(tr)
                tr = None
            batch = assembler.write(pending, slot, one)
            if batch is not None:
                self._emit(idx, batch)

    def _take_budget(self) -> bool:
        """Claim one message of the shared budget; False when spent. The
        claim that spends it winds the pool down (a message another shard
        received after that is dropped, at most once)."""
        if self._msg_budget is None:
            return True
        with self._budget_lock:
            if self._msg_budget <= 0:
                return False
            self._msg_budget -= 1
            drained = self._msg_budget == 0
        if drained:
            self._request_stop_all()
        return True

    def _run_shard(self, idx: int) -> None:
        stream_it = iter(self.streams[idx])
        # one series per shard, bounded by the pool's size
        span_name = f"ingest.recv.shard{idx}"
        while True:
            # bjx: ignore[BJX107] — one series per shard, as blendjax/data/shard_ingest.py:434
            with metrics.span(span_name):
                try:
                    item = next(stream_it)
                except StopIteration:
                    return
            if not self._take_budget():
                return
            # Advisory racy read: worst case one extra item is consumed; the
            # authoritative error read in __iter__ is sequenced by the _DONE
            # sentinel.
            # bjx: ignore[BJX117] — as blendjax/data/shard_ingest.py:444
            if self._consumer_stop or self._error is not None:
                return
            self._consume(idx, item)

    def _worker(self, idx: int) -> None:
        try:
            self._run_shard(idx)
        except BaseException as e:  # raised in the consumer thread
            with self._active_lock:
                if self._error is None:
                    self._error = e
            self._request_stop_all()
        finally:
            with self._active_lock:
                self._active -= 1
                last = self._active == 0
            if last:
                self._shutdown_pool()  # no stream submits any more
                if (self._error is None and not self._consumer_stop
                        and self.emit_partial_final
                        and self._assembler is not None):
                    # every peer has returned: the assembler is quiet
                    tail = self._assembler.flush()
                    if tail is not None:
                        self._emit(idx, tail)
                while True:  # the sentinel must arrive (or stop() wins)
                    try:
                        self._queue.put(self._DONE, timeout=0.25)
                        break
                    except queue.Full:
                        if self._consumer_stop:
                            break

    def _shutdown_pool(self) -> None:
        """Take the shared executor down, from whichever side gets here
        first (the last worker or stop()); the other finds None."""
        with self._active_lock:
            pool, self._inflate_pool = self._inflate_pool, None
        if pool is not None:
            pool.shutdown(wait=False)

    # -- consumer side -------------------------------------------------------

    def start(self) -> "ShardedHostIngest":
        if self._threads:
            raise RuntimeError("already started")
        with self._active_lock:
            hookable = [s for s in self.streams
                        if hasattr(s, "set_inflate_pool")]
            if self.inflate_workers and hookable:
                self._inflate_pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=self.inflate_workers,
                    thread_name_prefix="blendjax-torch-inflate",
                )
                for s in hookable:
                    s.set_inflate_pool(self._inflate_pool)
            self._active = len(self.streams)
        for stream in self.streams:
            clear = getattr(stream, "clear_stop_request", None)
            if clear is not None:
                clear()
        for i in range(len(self.streams)):
            t = threading.Thread(target=self._worker, args=(i,),
                                 name=f"blendjax-torch-ingest-{i}",
                                 daemon=True)
            self._threads.append(t)
            t.start()
        return self

    def queue_depth(self) -> int:
        """Current prefetch-queue occupancy (observability gauge)."""
        return self._queue.qsize()

    def _get(self):
        """The next queued batch, or ``None`` once ``stop()`` drained the
        end sentinel."""
        while True:
            try:
                return self._queue.get(timeout=0.25)
            except queue.Empty:
                if self._consumer_stop and not any(
                        t.is_alive() for t in self._threads):
                    return None

    def __iter__(self):
        if not self._threads:
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
        # Monotonic bool flag, single writer (the consumer); reads see it
        # within one queue item.
        # bjx: ignore[BJX117] — as blendjax/data/shard_ingest.py:573
        self._consumer_stop = True
        self._request_stop_all()
        if not self._threads:
            return
        deadline = time.monotonic() + timeout
        while any(t.is_alive() for t in self._threads):
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            for t in self._threads:
                t.join(timeout=min(0.05, max(remaining, 0.01)))
        self._shutdown_pool()
        alive = [t.name for t in self._threads if t.is_alive()]
        if alive:
            raise RuntimeError(
                f"ingest workers {alive} did not exit within {timeout:.1f}s "
                "of stop()"
            )
