"""The data-stream socket pair (copied from ``blendjax/transport/channels.py``).

PUSH (bind, small SNDHWM, IMMEDIATE) -> PULL (connect to all producers,
RCVHWM): backpressure through small queues, fair fan-in, at-most-once
delivery. A poll timeout raises :class:`ReceiveTimeoutError`.

Each published message carries ``_seq`` (a per-publisher counter) and
publish times, so the consumer's frame lineage counts gaps, reorders and
restarts exactly (:mod:`blendjax_torch.obs.lineage`); every
``telemetry_every``-th message also carries ``_telemetry``, a
msgpack-native snapshot of the publishing process's metrics registry, and
every ``trace_every``-th a sampled frame trace ``_trace``
(:mod:`blendjax_torch.obs.trace`), in the JAX package's shapes, so either
package's consumer accounts the other's producers. ``lineage=False``
sends none of these stamps.

A publisher may compress large arrays (``compress_level``: zlib "ndz";
``compress_rle``: run-length "ndr") or, for a consumer on the same host,
write them into a shared-memory ring (``shm``,
:mod:`blendjax_torch.transport.shm`) and send only a descriptor. A message
that outgrows its ring slot goes on the wire codecs and is counted in
``shm_fallbacks``.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import zmq

from blendjax_torch import constants
from blendjax_torch.transport.shm import (
    REGISTRY_ENV,
    ShmCapacityError,
    ShmRing,
    resolve_message,
)
from blendjax_torch.transport.wire import (
    DEFAULT_COMPRESS_MIN_BYTES,
    WireCompressState,
    WireCounts,
    decode_message,
    encode_message,
)


class ReceiveTimeoutError(TimeoutError):
    """No message arrived within the timeout: treat the peer as failed."""


_context_lock = threading.Lock()
_context = None
_context_pid = None


def zmq_context() -> zmq.Context:
    """Process-wide ZMQ context (re-created after a fork)."""
    global _context, _context_pid
    with _context_lock:
        if _context is None or _context_pid != os.getpid():
            _context = zmq.Context()
            _context_pid = os.getpid()
        return _context


def term_context() -> None:
    """Terminate the process-wide context, blocking until closed sockets
    flushed their queues or their LINGER expired: call it at the end of a
    producer so a finite stream's tail is delivered."""
    global _context
    with _context_lock:
        ctx = _context
        _context = None
    if ctx is not None and _context_pid == os.getpid():
        ctx.term()


class DataPublisherSocket:
    """Producer end of the data stream: PUSH, bind side.

    ndarray payloads are handed to the socket by reference and sent after
    ``publish`` returns: a producer that reuses a buffer copies it first.

    ``codec`` is ``"tensor"`` or ``"pickle"``; ``compress_level``,
    ``compress_min_bytes``, ``compress_rle``, ``rle_cap`` and
    ``quantize_f16`` go to :func:`~blendjax_torch.transport.wire.encode_message`
    with one :class:`~blendjax_torch.transport.wire.WireCompressState` per
    publisher. ``shm`` is a :class:`~blendjax_torch.transport.shm.ShmRing`
    to write into, or ``True`` / a slot count to create one sized from
    the first payload (twice its bytes per slot); a ring that cannot be
    created raises. A ring slot waits at most ``shm_timeout_s`` for its
    reader before it is reclaimed (``shm_reclaims``). ``lineage``,
    ``telemetry_every`` and ``trace_every`` are the stamps of the module
    docstring (0 turns telemetry or traces off).
    """

    def __init__(self, bind_addr: str, btid: int | None = None,
                 send_hwm: int = constants.DEFAULT_SEND_HWM,
                 codec: str = "tensor", lingerms: int = 0,
                 compress_level: int = 0,
                 compress_min_bytes: int = DEFAULT_COMPRESS_MIN_BYTES,
                 compress_rle: bool = False, rle_cap: int | None = None,
                 quantize_f16=(), lineage: bool = True,
                 telemetry_every: int = 64, trace_every: int = 64,
                 shm=None, shm_timeout_s: float = 5.0):
        self.btid = btid
        self.codec = codec
        self.compress_level = int(compress_level)
        self.compress_min_bytes = int(compress_min_bytes)
        self.compress_rle = bool(compress_rle)
        self.rle_cap = int(rle_cap) if rle_cap else None
        self.quantize_f16 = tuple(quantize_f16)
        self._wire_state = (
            WireCompressState()
            if (self.compress_level > 0 or self.compress_rle) else None
        )
        self._shm_timeout_s = float(shm_timeout_s)
        self._shm_owned = False
        if isinstance(shm, ShmRing):
            self._shm_ring = shm
            self._shm_slots = shm.slots
        elif shm:
            self._shm_ring = None
            self._shm_slots = 4 if shm is True else int(shm)
            self._shm_owned = True
        else:
            self._shm_ring = None
            self._shm_slots = 0
        self.shm_fallbacks = 0
        self.lineage = bool(lineage)
        self.telemetry_every = int(telemetry_every) if lineage else 0
        self.trace_every = int(trace_every) if lineage else 0
        self._pid = os.getpid()
        self._seq = 0
        self._created_wall = time.time()
        self._tel_mark = (0, self._created_wall)  # (seq, wall) at last one
        self.sock = zmq_context().socket(zmq.PUSH)
        self.sock.setsockopt(zmq.SNDHWM, send_hwm)
        self.sock.setsockopt(zmq.IMMEDIATE, 1)
        self.sock.setsockopt(zmq.LINGER, lingerms)
        self.sock.bind(bind_addr)
        # wildcard ports resolve at bind time
        self.addr = self.sock.getsockopt_string(zmq.LAST_ENDPOINT)

    @property
    def shm_reclaims(self) -> int:
        """Ring slots reused before their reader acknowledged them."""
        return self._shm_ring.reclaims if self._shm_ring is not None else 0

    def _stamp(self, data: dict) -> dict:
        if not self.lineage:
            return data
        data["_seq"] = self._seq
        data["_pub_wall"] = time.time()
        data["_pub_mono"] = time.monotonic()
        if self.telemetry_every and self._seq % self.telemetry_every == 0:
            data["_telemetry"] = self._telemetry_snapshot()
        if self.trace_every and self._seq % self.trace_every == 0:
            # the trace context's shape, inlined: unique per (pid, seq)
            data["_trace"] = {
                "id": f"{self.btid}-{self._pid}-{self._seq}",
                "btid": self.btid,
                "pid": self._pid,
                "stages": [["publish", time.monotonic(), time.time()]],
            }
        self._seq += 1
        return data

    def _telemetry_snapshot(self) -> dict:
        """Msgpack-native snapshot of this process's metrics registry
        (the producer's ``producer.frame`` span, its counters) and its
        message rate since the last snapshot."""
        from blendjax_torch.utils.metrics import metrics

        now = time.time()
        last_seq, last_wall = self._tel_mark
        dt = max(now - last_wall, 1e-9)
        self._tel_mark = (self._seq, now)
        report = metrics.report()
        return {
            "seq": int(self._seq),
            "uptime_s": round(now - self._created_wall, 3),
            # messages/s since the previous snapshot (0.0 on the first)
            "mps": round((self._seq - last_seq) / dt, 3),
            "counters": {k: int(v) for k, v in report["counters"].items()},
            "spans": {
                k: {
                    "count": int(v["count"]),
                    "mean_ms": round(float(v["mean_ms"]), 3),
                    "p95_ms": round(float(v.get("p95_ms", 0.0)), 3),
                }
                for k, v in report["spans"].items()
            },
        }

    def _encode(self, data: dict) -> list:
        return encode_message(
            data, codec=self.codec, compress_level=self.compress_level,
            compress_min_bytes=self.compress_min_bytes,
            compress_rle=self.compress_rle, rle_cap=self.rle_cap,
            quantize_f16=self.quantize_f16, state=self._wire_state,
        )

    def _encode_shm(self, data: dict):
        """Write the message's arrays into the ring and encode the
        descriptor message; ``None`` when it has no array or outgrew the
        slot (counted in ``shm_fallbacks``): it then goes on the wire."""
        arrs = {k: v for k, v in data.items()
                if isinstance(v, np.ndarray) and v.ndim >= 1}
        if not arrs:
            return None
        ring = self._shm_ring
        if ring is None:
            # sized from the first payload, with headroom for jitter
            ring = ShmRing(
                slots=self._shm_slots,
                slot_bytes=sum(v.nbytes + 64 for v in arrs.values()) * 2,
                btid=self.btid,
            )
            self._shm_ring = ring
        try:
            desc = ring.write(arrs, timeout_s=self._shm_timeout_s)
        except ShmCapacityError:
            self.shm_fallbacks += 1
            return None
        small = {k: v for k, v in data.items() if k not in arrs}
        small["_shm"] = desc
        return self._encode(small)

    def publish(self, **kwargs) -> None:
        """Publish one message dict, stamped with ``btid`` and ``_seq``."""
        data = self._stamp({"btid": self.btid, **kwargs})
        if self._shm_slots:
            frames = self._encode_shm(data)
            if frames is not None:
                # the ring holds a copy: the descriptor frames are tiny
                self.sock.send_multipart(frames, copy=True)
                return
        self.sock.send_multipart(self._encode(data), copy=False)

    def close(self) -> None:
        self.sock.close()
        ring = self._shm_ring
        if ring is not None and self._shm_owned:
            ring.close()
            # under a registry its owner unlinks; standalone, we do
            if not os.environ.get(REGISTRY_ENV):
                ring.unlink()


class DataReceiverSocket:
    """Consumer end: PULL, connected to every producer address.

    ``recv`` returns the decoded message dict or raises
    :class:`ReceiveTimeoutError`. Receive and decode are also separate
    calls (:meth:`recv_frames`, :meth:`decode_frames`), so a stream with
    an inflate pool decodes one message while it receives the next.
    ``allow_pickle`` admits pickled messages and embedded pickles. The
    bytes decoded and shared-memory descriptors resolved are added to
    ``counts`` (a :class:`~blendjax_torch.transport.wire.WireCounts`,
    the receiver's own unless one is given).
    """

    def __init__(self, addresses, queue_size: int = constants.DEFAULT_QUEUE_SIZE,
                 timeoutms: int = constants.DEFAULT_TIMEOUTMS,
                 allow_pickle: bool = False, defer_rle: bool = False,
                 counts: WireCounts | None = None):
        if isinstance(addresses, str):
            addresses = [addresses]
        self.addresses = list(addresses)
        self.timeoutms = timeoutms
        self.allow_pickle = bool(allow_pickle)
        self.defer_rle = bool(defer_rle)
        self.counts = counts if counts is not None else WireCounts()
        self.sock = zmq_context().socket(zmq.PULL)
        self.sock.setsockopt(zmq.RCVHWM, queue_size)
        self.sock.setsockopt(zmq.LINGER, 0)
        for addr in self.addresses:
            self.sock.connect(addr)
        self.poller = zmq.Poller()
        self.poller.register(self.sock, zmq.POLLIN)

    def _poll_frames(self, timeoutms: int):
        """One raw multipart message's frame buffers, or ``None`` when
        nothing arrived within ``timeoutms``."""
        if self.sock not in dict(self.poller.poll(timeoutms)):
            return None
        return [f.buffer for f in self.sock.recv_multipart(copy=False)]

    def decode_frames(self, buffers, copy_arrays: bool = False) -> dict:
        """Decode raw frame buffers with this receiver's settings and
        resolve a shared-memory descriptor (a torn slot leaves the
        ``_shm_torn`` marker). Runs on the receiving thread or on an
        inflate pool's worker."""
        msg = decode_message(
            buffers, copy_arrays=copy_arrays, allow_pickle=self.allow_pickle,
            defer_rle=self.defer_rle, counts=self.counts,
        )
        if isinstance(msg, dict) and "_shm" in msg:
            msg = resolve_message(msg, self.counts)
        return msg

    def recv_frames(self, timeoutms: int | None = None):
        """Receive one message's raw frame buffers, without decoding."""
        t = self.timeoutms if timeoutms is None else timeoutms
        buffers = self._poll_frames(t)
        if buffers is None:
            raise ReceiveTimeoutError(
                f"no message within {t} ms from {self.addresses}"
            )
        return buffers

    def recv(self, timeoutms: int | None = None, copy_arrays: bool = False):
        return self.decode_frames(self.recv_frames(timeoutms), copy_arrays)

    def connect(self, addr: str) -> None:
        """Add a producer endpoint (on the thread that owns the socket)."""
        if addr in self.addresses:
            return
        self.sock.connect(addr)
        self.addresses.append(addr)

    def disconnect(self, addr: str) -> None:
        """Drop a producer endpoint (on the thread that owns the socket);
        messages still queued on its pipe are lost."""
        try:
            self.sock.disconnect(addr)
        except zmq.ZMQError:
            pass
        if addr in self.addresses:
            self.addresses.remove(addr)

    def close(self) -> None:
        self.sock.close()
