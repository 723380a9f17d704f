"""Live message stream from a fleet of producers (copied from
``blendjax/data/stream.py``; recording waits for the replay slice).

Every publisher numbers its messages (``_seq``); the stream pops those
stamps and counts, per producer, the messages that never arrived
(``seq_gaps``) and restarts (a sequence that goes backwards), so a run can
assert that its fleet delivered everything. Its other counters are plain
attributes too: ``received`` (messages taken off the socket),
``messages`` (those accounted), ``pool_decodes``
(messages decoded on an inflate pool) and, in ``counts`` (a
:class:`~blendjax_torch.transport.wire.WireCounts`), the decoded and wire
bytes and the shared-memory reads and torn slots.
"""

from __future__ import annotations

import collections
import concurrent.futures
import logging
import time

from blendjax_torch import constants
from blendjax_torch.constants import LOGGER_NAME
from blendjax_torch.transport import (
    DataReceiverSocket,
    ReceiveTimeoutError,
    WireCounts,
)

logger = logging.getLogger(f"{LOGGER_NAME}.data")

# Decode-ahead depth with an inflate pool: one message decoding on the
# pool while the iterating thread waits in the next receive. Deeper buys
# nothing and holds more zero-copy frame buffers alive.
DECODE_AHEAD = 2

RECORDING_NOT_PORTED = (
    "recording a stream is not ported yet: it comes with checkpoint and "
    "replay (ROADMAP Queue A item 5)"
)


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
                 worker_index: int = 0, num_workers: int = 1,
                 copy_arrays: bool = False, allow_pickle: bool = False,
                 on_timeout=None, track_gaps: bool | None = None,
                 defer_rle: bool = False):
        if record_path_prefix is not None:
            raise NotImplementedError(RECORDING_NOT_PORTED)
        if isinstance(addresses, str):
            addresses = [addresses]
        self.addresses = list(addresses)
        self.queue_size = queue_size
        self.timeoutms = timeoutms
        self.max_items = max_items
        self.item_transform = item_transform
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
        self.restarts = 0
        self.received = 0
        self.messages = 0
        self.pool_decodes = 0
        self._last_seq: dict = {}
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
        raise NotImplementedError(RECORDING_NOT_PORTED)

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
        """Pop the publish stamps, update the per-producer gap count, and
        return the item (``None`` for a torn shared-memory message)."""
        seq = msg.pop("_seq", None)
        msg.pop("_pub_wall", None)
        msg.pop("_pub_mono", None)
        self.messages += 1
        if seq is not None and self.track_gaps:
            key = msg.get("btid")
            last = self._last_seq.get(key)
            if last is not None:
                if seq > last + 1:
                    self.seq_gaps += seq - last - 1
                elif seq <= last:
                    self.restarts += 1
            self._last_seq[key] = seq
        if msg.pop("_shm_torn", False):
            return None  # counted in counts.shm_torn when resolved
        return self.item_transform(msg) if self.item_transform else msg

    def _recv_sliced(self, recv, frames_only: bool = False):
        """One receive with ``timeoutms`` semantics, polled in <=250 ms
        slices so :meth:`request_stop` is honoured; None when stopped."""
        deadline = time.monotonic() + self.timeoutms / 1e3
        while True:
            self._apply_membership(recv)
            if self._stop_requested:
                return None
            remaining_ms = (deadline - time.monotonic()) * 1e3
            slice_ms = max(0, min(250, int(remaining_ms)))
            try:
                if frames_only:
                    return recv.recv_frames(timeoutms=slice_ms)
                return recv.recv(timeoutms=slice_ms,
                                 copy_arrays=self.copy_arrays)
            except ReceiveTimeoutError:
                if remaining_ms <= 0:
                    raise ReceiveTimeoutError(
                        f"no message within {self.timeoutms} ms from "
                        f"{self.addresses}"
                    ) from None

    def _iter_decode_ahead(self, recv, limit, pool):
        """Receive on this thread, decode on ``pool``, yield in receive
        order. The decode jobs run without the intra-message pool (a job
        that submitted into its own small executor could deadlock it),
        and never more messages are received than ``limit`` needs. A
        stop drops the decodes in flight (at most once), after they ran,
        so ``counts`` covers everything ``received``."""
        pending: collections.deque = collections.deque()
        try:
            yield from self._decode_ahead(recv, limit, pool, pending)
        finally:
            concurrent.futures.wait([fut for fut, _raw in pending])

    def _decode_ahead(self, recv, limit, pool, pending):
        n = 0
        while limit is None or n < limit:
            if self._stop_requested:
                return
            raw = None
            if not pending:
                try:
                    raw = self._recv_sliced(recv, frames_only=True)
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
                # raw holds the frame buffers alive until the decode ran
                pending.append(
                    (pool.submit(recv.decode_frames, raw, self.copy_arrays),
                     raw)
                )
                self.pool_decodes += 1
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
        try:
            pool = self._inflate_pool
            if pool is not None:
                yield from self._iter_decode_ahead(recv, limit, pool)
                return
            n = 0
            while limit is None or n < limit:
                try:
                    msg = self._recv_sliced(recv)
                except ReceiveTimeoutError:
                    if self.on_timeout is not None and self.on_timeout():
                        continue
                    raise
                if msg is None:  # request_stop()
                    return
                self.received += 1
                item = self._account(msg)
                if item is None:
                    continue
                yield item
                n += 1
        finally:
            recv.close()
