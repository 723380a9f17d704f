"""Socket patterns of the port (copied from ``blendjax/transport/channels.py``).

- The data stream: PUSH (bind, small SNDHWM, IMMEDIATE) -> PULL (connect
  to all producers, RCVHWM): backpressure through small queues, fair
  fan-in, at-most-once delivery. A poll timeout raises
  :class:`ReceiveTimeoutError`.
- Duplex control: PAIR (producer binds) <-> PAIR (consumer connects),
  each message stamped with the sender's ``btid`` and a random message
  id ``btmid`` (:class:`PairChannel`).
- Environment RPC: REQ (RELAXED + CORRELATE, send and receive timeouts)
  <-> REP (:class:`RpcClient`, :class:`RpcServer`).

Every receiver refuses pickled messages and embedded pickles unless it is
told ``allow_pickle=True`` (the JAX package's accept them unless told
otherwise); the frames on the wire are the JAX package's either way.

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
``shm_fallbacks`` and in the registry's ``wire.shm_fallbacks``.
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


class _Channel:
    """What the sockets share: the poller, receiving one message's frame
    buffers within a timeout, decoding them with the channel's pickle
    policy, closing, and use as a context manager."""

    sock: zmq.Socket
    allow_pickle: bool = False

    def _register_poller(self) -> None:
        self.poller = zmq.Poller()
        self.poller.register(self.sock, zmq.POLLIN)

    def _poll_frames(self, timeoutms: int):
        """One raw multipart message's frame buffers, or ``None`` when
        nothing arrived within ``timeoutms``."""
        if self.sock not in dict(self.poller.poll(timeoutms)):
            return None
        return [f.buffer for f in self.sock.recv_multipart(copy=False)]

    def _poll_recv(self, timeoutms: int):
        """One decoded message (arrays copied, so they outlive the
        frames), or ``None`` on timeout."""
        buffers = self._poll_frames(timeoutms)
        if buffers is None:
            return None
        return decode_message(buffers, copy_arrays=True,
                              allow_pickle=self.allow_pickle)

    def close(self) -> None:
        # queued messages stay for the IO thread to flush, bounded by the
        # socket's LINGER; call term_context() at the end of a process to
        # wait for that flush
        self.sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _SentTracker:
    """A ``zmq.MessageTracker`` stand-in for a publish through the
    shared-memory ring: the arrays were copied into the ring before the
    send, so the caller's buffers are free at once."""

    done = True

    def wait(self, timeout=None):
        return None


_DONE_TRACKER = _SentTracker()


class DataPublisherSocket(_Channel):
    """Producer end of the data stream: PUSH, bind side.

    With ``copy=False`` (the default) ndarray payloads are handed to the
    socket by reference and sent after ``publish`` returns: a producer
    that reuses a buffer passes ``copy=True``, or rotates a pool of
    buffers behind :meth:`publish_tracked`.

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
                 copy: bool = False, compress_level: int = 0,
                 compress_min_bytes: int = DEFAULT_COMPRESS_MIN_BYTES,
                 compress_rle: bool = False, rle_cap: int | None = None,
                 quantize_f16=(), lineage: bool = True,
                 telemetry_every: int = 64, trace_every: int = 64,
                 shm=None, shm_timeout_s: float = 5.0):
        self.btid = btid
        self.codec = codec
        self.copy = bool(copy)
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
            from blendjax_torch.utils.metrics import metrics

            self.shm_fallbacks += 1
            metrics.count("wire.shm_fallbacks")
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
        self.sock.send_multipart(self._encode(data), copy=self.copy)

    def publish_tracked(self, **kwargs):
        """Publish without copying and return a ``zmq.MessageTracker``:
        ``tracker.done`` turns True once the IO thread no longer holds the
        payload buffers, so a producer rotating a fixed pool of buffers
        can ``tracker.wait()`` before rendering into one again (PUSH keeps
        one queue per peer, so the send HWM alone does not bound the
        messages in flight). Through the shared-memory ring the arrays are
        copied before the send and the tracker is done at once."""
        data = self._stamp({"btid": self.btid, **kwargs})
        if self._shm_slots:
            frames = self._encode_shm(data)
            if frames is not None:
                self.sock.send_multipart(frames, copy=True)
                return _DONE_TRACKER
        return self.sock.send_multipart(self._encode(data), copy=False,
                                        track=True)

    def close(self) -> None:
        super().close()
        ring = self._shm_ring
        if ring is not None and self._shm_owned:
            ring.close()
            # under a registry its owner unlinks; standalone, we do
            if not os.environ.get(REGISTRY_ENV):
                ring.unlink()


class DataReceiverSocket(_Channel):
    """Consumer end: PULL, connected to every producer address.

    ``recv`` returns ``(message, raw_buffers)``, the decoded dict and the
    frame buffers it came from (so a recorder can keep the exact wire
    bytes), or raises :class:`ReceiveTimeoutError`. Receive and decode are
    also separate
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
        self._register_poller()

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
        """One message: ``(decoded dict, raw frame buffers)``."""
        buffers = self.recv_frames(timeoutms)
        return self.decode_frames(buffers, copy_arrays), buffers

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


class PairChannel(_Channel):
    """Duplex control channel, PAIR <-> PAIR: the producer binds
    (``bind=True``), the consumer connects. ``send`` stamps ``btid`` and a
    fresh random 4-byte message id ``btmid`` and returns the id; ``recv``
    returns ``None`` on timeout (``timeoutms=0`` polls)."""

    def __init__(self, addr: str, btid: int | None = None,
                 bind: bool = False, hwm: int = constants.DEFAULT_SEND_HWM,
                 lingerms: int = 0, codec: str = "tensor",
                 default_timeoutms: int = constants.DEFAULT_TIMEOUTMS,
                 allow_pickle: bool = False):
        self.btid = btid
        self.codec = codec
        self.default_timeoutms = default_timeoutms
        self.allow_pickle = bool(allow_pickle)
        self.sock = zmq_context().socket(zmq.PAIR)
        self.sock.setsockopt(zmq.SNDHWM, hwm)
        self.sock.setsockopt(zmq.RCVHWM, hwm)
        self.sock.setsockopt(zmq.LINGER, lingerms)
        if bind:
            self.sock.bind(addr)
            self.addr = self.sock.getsockopt_string(zmq.LAST_ENDPOINT)
        else:
            self.sock.connect(addr)
            self.addr = addr
        self._register_poller()

    def send(self, **kwargs) -> bytes:
        """Send one message (copied at send time: control messages are
        small); returns its ``btmid``."""
        btmid = os.urandom(4)
        data = {"btid": self.btid, "btmid": btmid, **kwargs}
        self.sock.send_multipart(encode_message(data, codec=self.codec),
                                 copy=True)
        return btmid

    def recv(self, timeoutms: int | None = None):
        """One message, or ``None`` if nothing arrives in time."""
        t = self.default_timeoutms if timeoutms is None else timeoutms
        return self._poll_recv(t)


class RpcClient(_Channel):
    """Blocking request/reply client: REQ with RELAXED and CORRELATE, so
    the socket recovers from a lost reply instead of wedging; a send or
    receive that waits ``timeoutms`` raises :class:`ReceiveTimeoutError`,
    so a dead environment fails fast."""

    def __init__(self, addr: str, timeoutms: int = constants.DEFAULT_TIMEOUTMS,
                 codec: str = "tensor", allow_pickle: bool = False):
        self.codec = codec
        self.timeoutms = timeoutms
        self.addr = addr
        self.allow_pickle = bool(allow_pickle)
        self.sock = zmq_context().socket(zmq.REQ)
        self.sock.setsockopt(zmq.REQ_RELAXED, 1)
        self.sock.setsockopt(zmq.REQ_CORRELATE, 1)
        self.sock.setsockopt(zmq.SNDTIMEO, timeoutms)
        self.sock.setsockopt(zmq.RCVTIMEO, timeoutms)
        self.sock.setsockopt(zmq.LINGER, 0)
        self.sock.connect(addr)

    def call(self, **kwargs) -> dict:
        """Send one request and return the decoded reply."""
        try:
            self.sock.send_multipart(
                encode_message(kwargs, codec=self.codec), copy=True
            )
            frames = self.sock.recv_multipart(copy=False)
        except zmq.error.Again as e:
            raise ReceiveTimeoutError(f"rpc to {self.addr} timed out") from e
        return decode_message([f.buffer for f in frames], copy_arrays=True,
                              allow_pickle=self.allow_pickle)


class RpcServer(_Channel):
    """Reply side of the RPC pattern: REP, bind. ``recv`` and ``reply``
    are separate calls, so the producer's request/reply state machine can
    interleave them with frame callbacks; ``recv(timeoutms=0)`` polls
    (the env's real-time mode)."""

    def __init__(self, bind_addr: str, codec: str = "tensor",
                 default_timeoutms: int = constants.DEFAULT_TIMEOUTMS,
                 allow_pickle: bool = False):
        self.codec = codec
        self.default_timeoutms = default_timeoutms
        self.allow_pickle = bool(allow_pickle)
        self.sock = zmq_context().socket(zmq.REP)
        self.sock.setsockopt(zmq.LINGER, 0)
        self.sock.bind(bind_addr)
        self.addr = self.sock.getsockopt_string(zmq.LAST_ENDPOINT)
        self._register_poller()

    def recv(self, timeoutms: int | None = None):
        """One request, or ``None`` on timeout."""
        t = self.default_timeoutms if timeoutms is None else timeoutms
        return self._poll_recv(t)

    def reply(self, **kwargs) -> None:
        self.sock.send_multipart(encode_message(kwargs, codec=self.codec),
                                 copy=True)
