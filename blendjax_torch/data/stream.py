"""Live message stream from a fleet of producers (copied from
``blendjax/data/stream.py``).

Every publisher numbers its messages (``_seq``) and stamps their publish
times; the stream hands each message to the process-wide frame lineage
(``ingest`` of :data:`blendjax_torch.obs.lineage.lineage`, as the JAX
stream does), which pops the stamps, keeps per-producer staleness and the
latest piggybacked telemetry, and returns the message's sequence verdict.
The stream sums the verdicts into its own counts: ``seq_gaps`` (messages
a producer numbered that never arrived), ``reorders`` (late arrivals of
an older number, which keep the high-water mark) and ``restarts`` (a
producer numbering from 0 again), so a run can assert that its fleet
delivered everything. A sampled frame trace (``_trace``) is stamped
``recv``. Its other counters are plain attributes too: ``received``
(messages taken off the socket), ``messages`` (those accounted),
``pool_decodes`` (messages decoded on an inflate pool, also the registry's
``wire.pool_decodes``) and, in ``counts`` (a
:class:`~blendjax_torch.transport.wire.WireCounts`), the decoded and wire
bytes and the shared-memory reads and torn slots.

``record_path_prefix`` tees the raw wire frames of every message received
to a ``.bjr`` recording (:mod:`blendjax_torch.data.replay`, one file per
worker) before anything else touches it, in the order received; with
decode-ahead too, so a recording holds exactly the ``received`` messages
(up to ``record_max_messages``).
"""

from __future__ import annotations

# bjx: hot-path (the live receive loop: BJX107, BJX109, BJX110 and
# BJX116 hold in this module)

import collections
import concurrent.futures
import logging
import time

from blendjax_torch import constants
from blendjax_torch.constants import LOGGER_NAME
from blendjax_torch.obs.lineage import lineage
from blendjax_torch.obs.trace import TRACE_KEY, stage as trace_stage
from blendjax_torch.transport import (
    DataReceiverSocket,
    ReceiveTimeoutError,
    WireCounts,
)
from blendjax_torch.utils.metrics import metrics

logger = logging.getLogger(f"{LOGGER_NAME}.data")

# Decode-ahead depth with an inflate pool: one message decoding on the
# pool while the iterating thread waits in the next receive. Deeper buys
# nothing and holds more zero-copy frame buffers alive.
DECODE_AHEAD = 2

def partition_addresses(addresses, num_shards: int) -> list:
    """Round-robin partition of producer addresses into at most
    ``num_shards`` non-empty groups, one per ingest worker; round-robin
    keeps a launcher's early and late instances mixed across shards."""
    if isinstance(addresses, str):
        addresses = [addresses]
    addresses = list(addresses)
    n = max(1, min(int(num_shards), len(addresses)))
    return [addresses[i::n] for i in range(n)]


class RemoteStream:
    """Iterable over decoded messages from all ``addresses``.

    ``max_items`` bounds the items yielded, split over ``num_workers``
    with the remainder on worker 0 (:meth:`worker_items`);
    ``item_transform`` maps each item. A receive that waits ``timeoutms``
    calls ``on_timeout`` (True: keep waiting) or raises
    ``ReceiveTimeoutError``. ``defer_rle`` leaves run-length frames of
    prebatched messages packed for the device-side expansion;
    ``copy_arrays`` makes every array writable; ``allow_pickle`` admits
    pickled messages. Gaps are tracked when this consumer sees each
    producer's whole stream: by default only with ``num_workers == 1``
    (several consumers on the same addresses each see a strided share);
    the sharded ingest passes ``track_gaps=True``, since its shards own
    disjoint producers. A torn shared-memory message is accounted (its
    stamps arrived) and skipped.
    """

    def __init__(self, addresses, queue_size: int = constants.DEFAULT_QUEUE_SIZE,
                 timeoutms: int = constants.DEFAULT_TIMEOUTMS,
                 max_items: int | None = None, item_transform=None,
                 record_path_prefix: str | None = None,
                 record_max_messages: int | None = None,
                 worker_index: int = 0, num_workers: int = 1,
                 copy_arrays: bool = False, allow_pickle: bool = False,
                 on_timeout=None, track_gaps: bool | None = None,
                 defer_rle: bool = False):
        if isinstance(addresses, str):
            addresses = [addresses]
        self.addresses = list(addresses)
        self.queue_size = queue_size
        self.timeoutms = timeoutms
        self.max_items = max_items
        self.item_transform = item_transform
        self.record_path_prefix = record_path_prefix
        self.record_max_messages = record_max_messages
        self.worker_index = int(worker_index)
        self.num_workers = int(num_workers)
        self.copy_arrays = bool(copy_arrays)
        self.allow_pickle = bool(allow_pickle)
        self.on_timeout = on_timeout
        self.track_gaps = (
            self.num_workers == 1 if track_gaps is None else bool(track_gaps)
        )
        self.defer_rle = bool(defer_rle)
        self.counts = WireCounts()
        self.seq_gaps = 0
        self.reorders = 0
        self.restarts = 0
        self.received = 0
        self.messages = 0
        self.pool_decodes = 0
        self._stop_requested = False
        self._inflate_pool = None
        # connect/disconnect from any thread; applied by the iterating
        # thread, which owns the socket
        self._membership_ops: collections.deque = collections.deque()

    # -- elastic membership -------------------------------------------------

    def connect(self, addr: str) -> None:
        """Admit a producer endpoint; applied at the iterating thread's
        next poll slice (<= 250 ms), or by the next ``__iter__``."""
        if addr not in self.addresses:
            self.addresses.append(addr)
        self._membership_ops.append(("connect", addr))

    def disconnect(self, addr: str) -> None:
        """Retire a producer endpoint (drain it first: zmq drops what is
        still queued on its pipe)."""
        if addr in self.addresses:
            self.addresses.remove(addr)
        self._membership_ops.append(("disconnect", addr))

    def _apply_membership(self, recv) -> None:
        while self._membership_ops:
            op, addr = self._membership_ops.popleft()
            try:
                if op == "connect":
                    recv.connect(addr)
                else:
                    recv.disconnect(addr)
            except Exception:
                logger.warning("membership %s %r failed; skipping", op, addr,
                               exc_info=True)
                if op == "connect" and addr in self.addresses:
                    self.addresses.remove(addr)

    # -- control ------------------------------------------------------------

    def set_inflate_pool(self, pool) -> None:
        """Attach a shared ``concurrent.futures`` executor (``None``
        detaches); read once when iteration starts. With a pool the
        stream decodes ahead: the pool decodes message N while the
        iterating thread receives N+1, and items come in receive order."""
        self._inflate_pool = pool

    def request_stop(self) -> None:
        """Ask a blocked iteration to exit at its next poll slice (<=250 ms)."""
        self._stop_requested = True

    def clear_stop_request(self) -> None:
        self._stop_requested = False

    def enable_recording(self, prefix: str, max_messages=None):
        """Tee from the next iteration on (reference ``dataset.py:53-58``)."""
        self.record_path_prefix = prefix
        self.record_max_messages = max_messages

    def worker_items(self) -> int | None:
        """This worker's share of ``max_items``."""
        if self.max_items is None:
            return None
        share = self.max_items // self.num_workers
        if self.worker_index == 0:
            share += self.max_items % self.num_workers
        return share

    # -- receive ------------------------------------------------------------

    def _account(self, msg: dict):
        """Account the publish stamps through the frame lineage and sum the
        sequence verdict into this stream's counts; stamp a sampled trace
        ``recv``; return the item (``None`` for a torn shared-memory
        message, whose stamps arrived intact and are accounted)."""
        gap, reordered, restarted = lineage.ingest(
            msg, track_gaps=self.track_gaps)
        self.messages += 1
        if gap:
            self.seq_gaps += gap
        if reordered:
            self.reorders += 1
        if restarted:
            self.restarts += 1
        if msg.pop("_shm_torn", False):
            return None  # counted in counts.shm_torn when resolved
        tr = msg.get(TRACE_KEY)
        if tr is not None:
            trace_stage(tr, "recv")
        return self.item_transform(msg) if self.item_transform else msg

    def _recv_sliced(self, recv):
        """One message's raw frames, received with ``timeoutms``
        semantics, polled in <=250 ms slices so :meth:`request_stop` is
        honoured; None when stopped."""
        deadline = time.monotonic() + self.timeoutms / 1e3
        while True:
            self._apply_membership(recv)
            if self._stop_requested:
                return None
            remaining_ms = (deadline - time.monotonic()) * 1e3
            slice_ms = max(0, min(250, int(remaining_ms)))
            try:
                return recv.recv_frames(timeoutms=slice_ms)
            except ReceiveTimeoutError:
                if remaining_ms <= 0:
                    raise ReceiveTimeoutError(
                        f"no message within {self.timeoutms} ms from "
                        f"{self.addresses}"
                    ) from None

    def _iter_decode_ahead(self, recv, recorder, limit, pool):
        """Receive on this thread, decode on ``pool``, yield in receive
        order. The decode jobs run without the intra-message pool (a job
        that submitted into its own small executor could deadlock it),
        and never more messages are received than ``limit`` needs. A
        stop drops the decodes in flight (at most once), after they ran,
        so ``counts`` covers everything ``received``."""
        pending: collections.deque = collections.deque()
        try:
            yield from self._decode_ahead(recv, recorder, limit, pool, pending)
        finally:
            concurrent.futures.wait([fut for fut, _raw in pending])

    def _decode_ahead(self, recv, recorder, limit, pool, pending):
        n = 0
        while limit is None or n < limit:
            if self._stop_requested:
                return
            raw = None
            if not pending:
                try:
                    raw = self._recv_sliced(recv)
                except ReceiveTimeoutError:
                    if self.on_timeout is not None and self.on_timeout():
                        continue
                    raise
                if raw is None:  # request_stop()
                    return
            elif limit is None or n + len(pending) < limit:
                self._apply_membership(recv)
                try:
                    raw = recv.recv_frames(timeoutms=0)
                except ReceiveTimeoutError:
                    raw = None
            if raw is not None:
                self.received += 1
                if recorder is not None:  # the tee, in receive order
                    recorder.save(raw)
                # raw holds the frame buffers alive until the decode ran
                pending.append(
                    (pool.submit(recv.decode_frames, raw, self.copy_arrays),
                     raw)
                )
                self.pool_decodes += 1
                metrics.count("wire.pool_decodes")
                if len(pending) < DECODE_AHEAD and (
                    limit is None or n + len(pending) < limit
                ):
                    continue
            fut, _raw = pending.popleft()
            item = self._account(fut.result())
            if item is None:
                continue
            yield item
            n += 1

    def __iter__(self):
        # the socket is made here, on the iterating thread, which owns it
        limit = self.worker_items()
        if limit == 0:
            return
        recv = DataReceiverSocket(
            self.addresses, queue_size=self.queue_size,
            timeoutms=self.timeoutms, allow_pickle=self.allow_pickle,
            defer_rle=self.defer_rle, counts=self.counts,
        )
        recorder = None
        try:
            if self.record_path_prefix is not None:
                from blendjax_torch.data.replay import FileRecorder

                recorder = FileRecorder(
                    FileRecorder.filename(self.record_path_prefix,
                                          self.worker_index),
                    max_messages=self.record_max_messages,
                ).__enter__()
            pool = self._inflate_pool
            if pool is not None:
                yield from self._iter_decode_ahead(recv, recorder, limit,
                                                   pool)
                return
            n = 0
            while limit is None or n < limit:
                try:
                    raw = self._recv_sliced(recv)
                except ReceiveTimeoutError:
                    if self.on_timeout is not None and self.on_timeout():
                        continue
                    raise
                if raw is None:  # request_stop()
                    return
                self.received += 1
                if recorder is not None:  # the tee, before any decode
                    recorder.save(raw)
                item = self._account(recv.decode_frames(raw,
                                                        self.copy_arrays))
                if item is None:
                    continue
                yield item
                n += 1
        finally:
            if recorder is not None:
                recorder.__exit__(None, None, None)
            recv.close()
