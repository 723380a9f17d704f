"""Shared-memory ring transport for producers on the consumer's host,
copied from ``blendjax/transport/shm.py``.

A producer writes each message's arrays into a slot of a
``multiprocessing.shared_memory`` segment and sends only a descriptor
(segment name, slot, generation, field layout) over the socket; the
consumer copies the arrays out of the slot. The layout, the magic and the
protocol are the JAX package's, so either package reads the other's
segments.

Each slot is a seqlock:

* the writer sets the slot's generation to an odd value before it copies
  and to the next even value after; a reader that sees an odd generation,
  or one that changed across its copy, drops the slot as torn;
* the reader stores the generation it consumed in the slot's ``ack``; the
  writer reuses a slot once ``ack == gen``, or after ``timeout_s``, when it
  reclaims the slot (a reader killed with -9 never wedges the writer).

Both counters are aligned u64 stores; no lock spans the processes.

Lifecycle: a creator registers its segment in the directory named by
``$BLENDJAX_SHM_REGISTRY`` (the JAX package's variable, one marker file
``<btid>__<name>`` per segment) when it is set, and the launcher that set
it unlinks the segments (:func:`reap_registry`). Without a registry the
creating publisher unlinks on close. Attached handles are cached per
process (:func:`attach_ring`).

Counters: :attr:`ShmRing.reclaims` on the writer's ring (and the
registry's ``wire.shm_reclaims``); :func:`resolve_message` adds reads,
bytes and torn slots to the ``counts`` object it is given and to the
registry (``wire.shm_reads``, ``wire.shm_bytes``, ``wire.shm_torn``).
"""

from __future__ import annotations

import logging
import os
import re
import threading
import time
from multiprocessing import shared_memory

import numpy as np

from blendjax_torch.constants import LOGGER_NAME
from blendjax_torch.utils.metrics import metrics

logger = logging.getLogger(f"{LOGGER_NAME}.transport")

REGISTRY_ENV = "BLENDJAX_SHM_REGISTRY"

_MAGIC = b"BJXSHM1\0"
_HDR_BYTES = 24  # magic(8) + slots(u64) + slot_bytes(u64)
_ALIGN = 64

__all__ = [
    "REGISTRY_ENV",
    "ShmCapacityError",
    "ShmRing",
    "attach_ring",
    "detach_all",
    "reap_registry",
    "resolve_message",
    "unlink_segment",
]


class ShmCapacityError(ValueError):
    """The payload does not fit a slot; the publisher sends it on the wire
    codecs instead (and counts it in ``shm_fallbacks``)."""


def _align(n: int, a: int = _ALIGN) -> int:
    return (int(n) + a - 1) // a * a


def _untrack(shm: shared_memory.SharedMemory) -> None:
    """Take the handle off the resource tracker: cleanup is owned by the
    registry or the creator, and a tracked segment would be unlinked a
    second time at exit with a leak warning."""
    try:
        from multiprocessing import resource_tracker

        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:
        pass


def _unlink_quietly(shm: shared_memory.SharedMemory) -> None:
    """``unlink()`` unregisters the name from the tracker, which never had
    it (see :func:`_untrack`); register it just before so the tracker logs
    no ``KeyError``."""
    try:
        from multiprocessing import resource_tracker

        resource_tracker.register(shm._name, "shared_memory")
    except Exception:
        pass
    shm.unlink()


def _sanitize(btid: object) -> str:
    return re.sub(r"[^A-Za-z0-9_-]", "-", str(btid))


def _register(name: str, btid: object) -> None:
    reg = os.environ.get(REGISTRY_ENV)
    if not reg:
        return
    try:
        os.makedirs(reg, exist_ok=True)
        with open(os.path.join(reg, f"{_sanitize(btid)}__{name}"), "w"):
            pass
    except OSError:  # the registry went away: the creator cleans up
        logger.warning("could not register shm segment %s in %s", name, reg)


def _deregister(name: str) -> None:
    reg = os.environ.get(REGISTRY_ENV)
    if not reg:
        return
    try:
        for fn in os.listdir(reg):
            if fn.partition("__")[2] == name:
                try:
                    os.remove(os.path.join(reg, fn))
                except FileNotFoundError:
                    pass
    except OSError:
        pass


class ShmRing:
    """Fixed-slot shared-memory ring with a seqlock generation per slot.

    One process creates and writes the ring; readers attach. Layout
    (bytes)::

        0                magic  "BJXSHM1\\0"
        8                u64    slots
        16               u64    slot_bytes (aligned payload capacity)
        24               u64[slots]  gen   (odd = write in progress)
        24 + 8*slots     u64[slots]  ack   (last generation consumed)
        align64(...)     slots * slot_bytes payload
    """

    def __init__(self, slots: int = 4, slot_bytes: int = 0, *,
                 name: str | None = None, create: bool = True,
                 btid: object = None) -> None:
        self._closed = False
        self._unlinked = False
        self._cursor = 0
        self.reclaims = 0
        self._owner = bool(create)
        if create:
            slots = int(slots)
            if slots < 1:
                raise ValueError("ShmRing needs at least one slot")
            slot_bytes = _align(max(int(slot_bytes), _ALIGN))
            total = _align(_HDR_BYTES + 16 * slots) + slots * slot_bytes
            self._shm = shared_memory.SharedMemory(
                create=True, size=total, name=name,
            )
            buf = self._shm.buf
            buf[:8] = _MAGIC
            hdr = np.ndarray((2,), dtype=np.uint64, buffer=buf, offset=8)
            hdr[0] = slots
            hdr[1] = slot_bytes
            del hdr
            _register(self._shm.name,
                      btid if btid is not None else os.getpid())
        else:
            if not name:
                raise ValueError("attach requires a segment name")
            self._shm = shared_memory.SharedMemory(name=name)
            buf = self._shm.buf
            if bytes(buf[:8]) != _MAGIC:
                self._shm.close()
                raise ValueError(f"segment {name!r} is not a blendjax shm ring")
            hdr = np.ndarray((2,), dtype=np.uint64, buffer=buf, offset=8)
            slots, slot_bytes = int(hdr[0]), int(hdr[1])
            del hdr
        _untrack(self._shm)
        self.slots = slots
        self.slot_bytes = slot_bytes
        self._payload_off = _align(_HDR_BYTES + 16 * slots)
        self._gen = np.ndarray((slots,), dtype=np.uint64,
                               buffer=self._shm.buf, offset=_HDR_BYTES)
        self._ack = np.ndarray((slots,), dtype=np.uint64,
                               buffer=self._shm.buf,
                               offset=_HDR_BYTES + 8 * slots)

    @property
    def name(self) -> str:
        return self._shm.name

    @classmethod
    def attach(cls, name: str) -> "ShmRing":
        return cls(name=name, create=False)

    def _slot_view(self, slot: int, shape, dtype, off: int) -> np.ndarray:
        base = self._payload_off + slot * self.slot_bytes + off
        return np.ndarray(shape, dtype=dtype, buffer=self._shm.buf,
                          offset=base)

    # -- writer side ---------------------------------------------------------

    def write(self, fields: dict, *, timeout_s: float = 5.0) -> dict:
        """Copy ``fields`` into the next slot and return the descriptor.

        Raises :class:`ShmCapacityError` before the slot is touched when
        the payload cannot fit, so an oversized message never tears a
        generation. Waits (at most ``timeout_s``) while the slot's last
        generation is unacknowledged, then reclaims it."""
        layout = []
        off = 0
        for key, arr in fields.items():
            arr = np.ascontiguousarray(arr)
            layout.append((key, arr, off))
            off = _align(off + arr.nbytes, 16)
        if off > self.slot_bytes:
            raise ShmCapacityError(
                f"payload needs {off} bytes, slot holds {self.slot_bytes}"
            )
        slot = self._cursor
        self._cursor = (slot + 1) % self.slots
        gen = int(self._gen[slot])
        if gen and int(self._ack[slot]) != gen:
            deadline = time.monotonic() + timeout_s
            while int(self._ack[slot]) != gen:
                if time.monotonic() >= deadline:
                    # the reader is gone or far behind: the stale
                    # descriptor, if ever read, fails its generation check
                    self.reclaims += 1
                    metrics.count("wire.shm_reclaims")
                    break
                time.sleep(0.0005)
        self._gen[slot] = gen + 1  # odd: write in progress
        desc_fields = []
        for key, arr, f_off in layout:
            np.copyto(self._slot_view(slot, arr.shape, arr.dtype, f_off), arr)
            desc_fields.append([key, arr.dtype.str, list(arr.shape), f_off])
        self._gen[slot] = gen + 2  # even: stable
        return {"n": self.name, "s": slot, "g": gen + 2, "f": desc_fields}

    def begin_write(self, slot: int) -> None:
        """Mark ``slot`` write-in-progress (odd generation), as a writer
        killed mid-copy leaves it: any read of the slot is torn until
        :meth:`end_write`."""
        self._gen[slot] = int(self._gen[slot]) + 1

    def end_write(self, slot: int) -> int:
        self._gen[slot] = int(self._gen[slot]) + 1
        return int(self._gen[slot])

    # -- reader side ---------------------------------------------------------

    def read(self, desc: dict):
        """Copy the descriptor's fields out of the ring; ``None`` when the
        slot is torn (odd generation, a generation other than the
        descriptor's, or a change across the copy). A good read
        acknowledges the generation so the writer may reuse the slot."""
        slot = int(desc["s"])
        gen = int(desc["g"])
        if slot < 0 or slot >= self.slots:
            return None
        if int(self._gen[slot]) != gen or gen % 2:
            return None
        out = {}
        for key, dtype_str, shape, off in desc["f"]:
            out[key] = self._slot_view(
                slot, tuple(shape), np.dtype(dtype_str), off
            ).copy()
        if int(self._gen[slot]) != gen:
            return None  # overwritten mid-copy
        self._ack[slot] = gen
        return out

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._gen = None  # numpy views pin the mapping: drop them first
        self._ack = None
        try:
            self._shm.close()
        except BufferError:
            pass

    def unlink(self) -> None:
        """Remove the segment's name; idempotent (safe to race a reaper)."""
        if self._unlinked:
            return
        self._unlinked = True
        _deregister(self._shm.name)
        try:
            _unlink_quietly(self._shm)
        except FileNotFoundError:
            pass

    def __enter__(self) -> "ShmRing":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
        if self._owner:
            self.unlink()


# -- attach cache (consumer side) -------------------------------------------

_attach_lock = threading.Lock()
_attached: dict = {}
_attach_failed: set = set()


def attach_ring(name: str):
    """Attach to ``name`` once per process; ``None`` (logged once) when the
    segment no longer exists, and the caller treats the message as torn."""
    with _attach_lock:
        ring = _attached.get(name)
        if ring is not None:
            return ring
        if name in _attach_failed:
            return None
        try:
            ring = ShmRing.attach(name)
        except (FileNotFoundError, ValueError, OSError) as e:
            _attach_failed.add(name)
            logger.warning("cannot attach shm segment %s: %s", name, e)
            return None
        _attached[name] = ring
        return ring


def detach_all() -> None:
    """Close every cached attached handle."""
    with _attach_lock:
        rings = list(_attached.values())
        _attached.clear()
        _attach_failed.clear()
    for ring in rings:
        ring.close()


def resolve_message(msg: dict, counts=None) -> dict:
    """Replace a decoded message's ``_shm`` descriptor by the slot's
    arrays, in place. A torn slot or a vanished segment leaves the
    marker ``_shm_torn`` instead: the publish stamps rode the descriptor
    and arrived intact, so the stream still accounts them before it drops
    the payload. ``counts`` (e.g. a
    :class:`~blendjax_torch.transport.wire.WireCounts`) gets
    ``shm_reads``, ``shm_bytes`` and ``shm_torn`` added."""
    desc = msg.pop("_shm", None)
    if desc is None:
        return msg
    out = None
    ring = attach_ring(desc["n"])
    if ring is not None:
        try:
            out = ring.read(desc)
        except (IndexError, ValueError, TypeError):
            out = None
    if out is None:
        if counts is not None:
            counts.add(shm_torn=1)
        metrics.count("wire.shm_torn")
        msg["_shm_torn"] = True
        return msg
    nbytes = 0
    for key, arr in out.items():
        msg[key] = arr
        nbytes += arr.nbytes
    if counts is not None:
        counts.add(shm_reads=1, shm_bytes=nbytes)
    metrics.count("wire.shm_reads")
    metrics.count("wire.shm_bytes", nbytes)
    return msg


# -- registry reaping (launcher side) ---------------------------------------


def unlink_segment(name: str) -> bool:
    """Unlink a segment by name; ``True`` if it existed."""
    try:
        seg = shared_memory.SharedMemory(name=name)
    except OSError:
        return False
    _untrack(seg)
    seg.close()
    try:
        _unlink_quietly(seg)
    except FileNotFoundError:
        return False
    return True


def reap_registry(registry_dir: str, btid: object = None) -> int:
    """Unlink every segment registered under ``registry_dir`` (only
    ``btid``'s when given) and remove the markers, so a second pass is a
    no-op: each segment is unlinked exactly once."""
    reaped = 0
    try:
        entries = os.listdir(registry_dir)
    except OSError:
        return 0
    prefix = None if btid is None else f"{_sanitize(btid)}__"
    for fn in entries:
        if "__" not in fn:
            continue
        if prefix is not None and not fn.startswith(prefix):
            continue
        if unlink_segment(fn.partition("__")[2]):
            reaped += 1
        try:
            os.remove(os.path.join(registry_dir, fn))
        except OSError:
            pass
    return reaped
