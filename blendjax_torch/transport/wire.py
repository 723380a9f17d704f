"""Wire formats, copied from ``blendjax/transport/wire.py``.

Two codecs share one decode entry point:

- :class:`TensorCodec` ("bjx1"): one multipart message, a msgpack header
  frame prefixed with :data:`~blendjax_torch.constants.WIRE_MAGIC`, then
  one frame per ndarray. Array entries are ``"nd"`` (raw bytes), ``"ndz"``
  (zlib, only when it shrinks the frame) or ``"ndr"`` (the run-length
  tile-group codec of :mod:`blendjax_torch.ops.tiles`). msgpack-native
  values ride in the header (``"obj"``); anything else is an embedded
  pickle (``"pkl"``).
- :class:`PickleCodec`: one pickled dict per message, the reference
  producers' ``send_pyobj`` format.

Decode tells them apart by the leading bytes (``BJX1`` against the pickle
PROTO opcode). The byte layout is identical to the JAX package's, so
either side decodes the other's messages, and a :class:`WireCompressState`
makes the same frames from the same message sequence in both packages.

A receiver's decode (one given a :class:`WireCounts`) also counts
``wire.raw_bytes`` and ``wire.compressed_bytes`` and observes each
message's host inflate time in ``wire.inflate_ms`` in the metrics
registry; a skipped compression trial counts ``wire.compress_skips``.

Unpickling runs code chosen by the sender. The port's receivers therefore
refuse pickled messages and embedded ``"pkl"`` entries unless the caller
passes ``allow_pickle=True`` (the JAX package accepts them by default).
"""

from __future__ import annotations

import pickle
import threading
import time
import zlib

import msgpack
import numpy as np

from blendjax_torch.constants import WIRE_MAGIC
from blendjax_torch.utils.metrics import metrics

# Pickle protocol 4: readable by every Python >= 3.4.
PICKLE_PROTOCOL = 4

# Arrays below this size are not worth a zlib or run-length round trip.
DEFAULT_COMPRESS_MIN_BYTES = 16_384


class WireCompressState:
    """Per-publisher compression state: a reusable ``zlib.compressobj``
    per level, a bounded memo of keys whose trial compression recently
    lost (skipped for ``SKIP_FRAMES`` encodes), and sticky per-key
    run-length capacities that only grow, so a consumer's packed shapes
    stay stable. ``compress_skips`` counts the trials skipped."""

    SKIP_FRAMES = 64
    MEMO_LIMIT = 128

    def __init__(self):
        self._templates: dict = {}
        self._skip: dict = {}
        self._caps: dict = {}
        self.compress_skips = 0

    def compress(self, raw, level: int) -> bytes:
        template = self._templates.get(level)
        if template is None:
            template = self._templates[level] = zlib.compressobj(level)
        c = template.copy()
        return c.compress(raw) + c.flush()

    def should_try(self, kind: str, key) -> bool:
        left = self._skip.get((kind, key), 0)
        if left > 0:
            self._skip[(kind, key)] = left - 1
            self.compress_skips += 1
            metrics.count("wire.compress_skips")
            return False
        return True

    def lost(self, kind: str, key) -> None:
        if len(self._skip) >= self.MEMO_LIMIT:
            self._skip.clear()
        self._skip[(kind, key)] = self.SKIP_FRAMES

    def won(self, kind: str, key) -> None:
        self._skip.pop((kind, key), None)

    def rle_cap(self, key):
        return self._caps.get(key)

    def set_rle_cap(self, key, cap: int) -> None:
        if len(self._caps) >= self.MEMO_LIMIT:
            self._caps.clear()
        if cap > self._caps.get(key, 0):
            self._caps[key] = int(cap)


class WireCounts:
    """What a data-stream receiver counts, as plain attributes: decoded
    array bytes (``raw_bytes``) against the bytes that crossed the wire
    for them (``compressed_bytes``), and the shared-memory descriptors it
    resolved (``shm_reads``, ``shm_bytes``) or found torn (``shm_torn``).
    Decode-ahead jobs add from several threads, hence the lock."""

    FIELDS = ("raw_bytes", "compressed_bytes", "shm_reads", "shm_bytes",
              "shm_torn")

    def __init__(self):
        self._lock = threading.Lock()
        for name in self.FIELDS:
            setattr(self, name, 0)

    def add(self, **deltas) -> None:
        with self._lock:
            for name, n in deltas.items():
                setattr(self, name, getattr(self, name) + n)

    def as_dict(self) -> dict:
        return {name: getattr(self, name) for name in self.FIELDS}


def _np_scalar_to_py(value):
    return value.item() if isinstance(value, np.generic) else value


def _nbytes(buf) -> int:
    nb = getattr(buf, "nbytes", None)
    return len(buf) if nb is None else nb


def _declared_bytes(key, shape, dt: np.dtype) -> int:
    expected = dt.itemsize
    for dim in shape:
        expected *= int(dim)
    if expected <= 0:
        raise ValueError(
            f"compressed frame for {key!r} declares zero bytes "
            "(empty arrays never ship compressed)"
        )
    return expected


def _inflate_bounded(key, wire_buf, expected: int) -> bytes:
    """Inflate with allocation capped at the declared array size (no
    decompression bombs)."""
    dec = zlib.decompressobj()
    buf = dec.decompress(wire_buf, expected)
    if not dec.eof or dec.unconsumed_tail:
        raise ValueError(
            f"ndz frame for {key!r} does not decompress to the declared "
            f"{expected} bytes"
        )
    return buf


class TensorCodec:
    """Zero-copy multipart codec: msgpack header + raw ndarray frames."""

    name = "tensor"

    @staticmethod
    def encode(message: dict, compress_level: int = 0,
               compress_min_bytes: int = DEFAULT_COMPRESS_MIN_BYTES,
               compress_rle: bool = False, rle_cap: int | None = None,
               quantize_f16=(), state: WireCompressState | None = None,
               ) -> list:
        """``message`` -> list of frames. ``compress_rle`` tries the
        ``"ndr"`` kind first for uint8 arrays of at least
        ``compress_min_bytes`` (``rle_cap`` pins the per-row capacity,
        else ``state`` keeps it sticky per key); ``compress_level > 0``
        then tries zlib. Either ships only when it shrinks the frame.
        ``quantize_f16`` names float fields sent as float16 (lossy).
        ``state`` (a :class:`WireCompressState`) reuses the compressor
        and skips recent losers; ``None`` encodes statelessly."""
        entries = []
        buffers = []
        for key, value in message.items():
            if isinstance(value, np.ndarray) and value.dtype != object:
                arr = np.ascontiguousarray(value)
                if key in quantize_f16 and arr.dtype in (np.float32,
                                                         np.float64):
                    arr = arr.astype(np.float16)
                raw = arr.data if arr.size else b""
                if (
                    compress_rle
                    and arr.dtype == np.uint8
                    and arr.nbytes >= compress_min_bytes
                    and (state is None or state.should_try("r", key))
                ):
                    from blendjax_torch.ops.tiles import rle_encode_rows

                    cap = rle_cap if rle_cap else (
                        state.rle_cap(key) if state is not None else None
                    )
                    out = rle_encode_rows(arr, cap=cap)
                    if out is None and cap is not None and not rle_cap:
                        out = rle_encode_rows(arr)  # the sticky cap ratchets
                    if out is not None and out[0].nbytes < arr.nbytes:
                        buf, cap_eff, isz = out
                        if state is not None:
                            state.won("r", key)
                            if not rle_cap:
                                state.set_rle_cap(key, cap_eff)
                        entries.append(
                            ["ndr", key, list(arr.shape), arr.dtype.str,
                             len(buffers), int(cap_eff), int(isz)]
                        )
                        buffers.append(buf)
                        continue
                    if state is not None:
                        state.lost("r", key)
                if (
                    compress_level > 0
                    and arr.nbytes >= compress_min_bytes
                    and (state is None or state.should_try("z", key))
                ):
                    packed = (
                        state.compress(raw, compress_level)
                        if state is not None
                        else zlib.compress(raw, compress_level)
                    )
                    if len(packed) < arr.nbytes:
                        if state is not None:
                            state.won("z", key)
                        entries.append(
                            ["ndz", key, list(arr.shape), arr.dtype.str,
                             len(buffers)]
                        )
                        buffers.append(packed)
                        continue
                    if state is not None:
                        state.lost("z", key)
                entries.append(
                    ["nd", key, list(arr.shape), arr.dtype.str, len(buffers)]
                )
                buffers.append(raw)
            else:
                value = _np_scalar_to_py(value)
                try:
                    packed = msgpack.packb(value, use_bin_type=True)
                    entries.append(["obj", key, packed])
                except (TypeError, ValueError, OverflowError):
                    entries.append(
                        ["pkl", key,
                         pickle.dumps(value, protocol=PICKLE_PROTOCOL)]
                    )
        header = WIRE_MAGIC + msgpack.packb([1, entries], use_bin_type=True)
        return [header, *buffers]

    @staticmethod
    def decode(frames: list, copy_arrays: bool = False,
               allow_pickle: bool = False, defer_rle: bool = False,
               inflate_pool=None, counts: WireCounts | None = None) -> dict:
        """Decode one multipart message.

        ``defer_rle=True`` leaves the ``"ndr"`` entries of prebatched
        messages (``_prebatched`` in the header) packed: the dict then
        carries ``<key>__ndr`` (the packed buffer) and ``<key>__ndrspec``
        (``[shape, isz, cap]``) for the device-side expansion in the fused
        train step. ``copy_arrays`` makes every array writable.
        ``inflate_pool`` (a ``concurrent.futures`` executor) inflates a
        message's ``"ndz"`` entries in parallel; a decode job that already
        runs on that pool must leave it unset (it could deadlock the
        pool). ``counts`` (a :class:`WireCounts`) adds this message's
        decoded and wire bytes."""
        if bytes(frames[0][: len(WIRE_MAGIC)]) != WIRE_MAGIC:
            raise ValueError("not a tensor-codec message")
        version, entries = msgpack.unpackb(
            bytes(frames[0])[len(WIRE_MAGIC):], raw=False,
            strict_map_key=False,
        )
        if version != 1:
            raise ValueError(f"unsupported wire version {version}")
        if defer_rle:
            defer_rle = any(
                e[0] == "obj" and e[1] == "_prebatched"
                and bool(msgpack.unpackb(e[2], raw=False))
                for e in entries
            )
        inflated: dict = {}
        if inflate_pool is not None:
            for i, entry in enumerate(entries):
                if entry[0] == "ndz":
                    _, key, shape, dtype, idx = entry
                    inflated[i] = inflate_pool.submit(
                        _inflate_bounded, key, frames[1 + idx],
                        _declared_bytes(key, shape, np.dtype(dtype)),
                    )
        out = {}
        raw_bytes = wire_bytes = 0
        inflate_ms = 0.0
        for i, entry in enumerate(entries):
            kind, key = entry[0], entry[1]
            if kind == "nd":
                _, _, shape, dtype, idx = entry
                arr = np.frombuffer(
                    frames[1 + idx], dtype=np.dtype(dtype)
                ).reshape(shape)
                raw_bytes += arr.nbytes
                wire_bytes += arr.nbytes
                out[key] = arr.copy() if copy_arrays else arr
            elif kind == "ndz":
                _, _, shape, dtype, idx = entry
                dt = np.dtype(dtype)
                fut = inflated.get(i)
                t0 = time.perf_counter()
                buf = fut.result() if fut is not None else _inflate_bounded(
                    key, frames[1 + idx], _declared_bytes(key, shape, dt)
                )
                inflate_ms += (time.perf_counter() - t0) * 1e3
                arr = np.frombuffer(buf, dtype=dt).reshape(shape)
                raw_bytes += arr.nbytes
                wire_bytes += _nbytes(frames[1 + idx])
                out[key] = arr.copy() if copy_arrays else arr
            elif kind == "ndr":
                _, _, shape, dtype, idx, cap, isz = entry
                from blendjax_torch.ops.tiles import (
                    NDR_SUFFIX,
                    NDRSPEC_SUFFIX,
                    rle_expand_packed_np,
                    rle_packed_stride,
                )

                if np.dtype(dtype) != np.uint8:
                    raise ValueError(
                        f"ndr frame for {key!r} declares dtype {dtype!r} "
                        "(run-length frames are uint8-only)"
                    )
                expected = _declared_bytes(key, shape, np.dtype(dtype))
                wire_buf = frames[1 + idx]
                rows = int(shape[0]) if len(shape) >= 2 else 1
                nb = _nbytes(wire_buf)
                stride = rle_packed_stride(int(cap), int(isz))
                if rows <= 0 or nb != rows * stride:
                    raise ValueError(
                        f"ndr frame for {key!r} carries {nb} bytes, "
                        f"declared {rows} rows x {stride} (truncated or "
                        "padded stream)"
                    )
                buf = np.frombuffer(wire_buf, np.uint8).reshape(rows, stride)
                raw_bytes += expected
                wire_bytes += nb
                if defer_rle:
                    out[key + NDR_SUFFIX] = buf.copy() if copy_arrays else buf
                    out[key + NDRSPEC_SUFFIX] = [
                        [int(s) for s in shape], int(isz), int(cap),
                    ]
                else:
                    out[key] = rle_expand_packed_np(
                        buf, shape, int(isz), int(cap)
                    )
            elif kind == "obj":
                out[key] = msgpack.unpackb(
                    entry[2], raw=False, strict_map_key=False
                )
            elif kind == "pkl":
                if not allow_pickle:
                    raise ValueError(
                        f"refusing embedded pickle for key {key!r} "
                        "(allow_pickle=False)"
                    )
                out[key] = pickle.loads(entry[2])
            else:
                raise ValueError(f"unknown wire entry kind {kind!r}")
        if counts is not None and raw_bytes:
            # only the data stream (a receiver's counts) feeds the registry
            counts.add(raw_bytes=raw_bytes, compressed_bytes=wire_bytes)
            metrics.count("wire.raw_bytes", raw_bytes)
            metrics.count("wire.compressed_bytes", wire_bytes)
            if inflate_ms:
                metrics.observe("wire.inflate_ms", inflate_ms)
        return out


class PickleCodec:
    """The reference producers' single-frame pickle codec."""

    name = "pickle"

    @staticmethod
    def encode(message: dict) -> list:
        return [pickle.dumps(message, protocol=PICKLE_PROTOCOL)]

    @staticmethod
    def decode(frames: list, allow_pickle: bool = False) -> dict:
        if not allow_pickle:
            raise ValueError("refusing pickled message (allow_pickle=False)")
        return pickle.loads(bytes(frames[0]))


CODECS = {TensorCodec.name: TensorCodec, PickleCodec.name: PickleCodec}


def encode_message(message: dict, codec: str = "tensor",
                   compress_level: int = 0,
                   compress_min_bytes: int = DEFAULT_COMPRESS_MIN_BYTES,
                   compress_rle: bool = False, rle_cap: int | None = None,
                   quantize_f16=(),
                   state: WireCompressState | None = None) -> list:
    if codec == TensorCodec.name:
        return TensorCodec.encode(
            message, compress_level=compress_level,
            compress_min_bytes=compress_min_bytes,
            compress_rle=compress_rle, rle_cap=rle_cap,
            quantize_f16=quantize_f16, state=state,
        )
    return CODECS[codec].encode(message)


def decode_message(frames: list, copy_arrays: bool = False,
                   allow_pickle: bool = False, defer_rle: bool = False,
                   inflate_pool=None,
                   counts: WireCounts | None = None) -> dict:
    """Decode frames of either codec (told apart by their leading bytes).
    ``defer_rle``, ``inflate_pool`` and ``counts`` apply to tensor-codec
    messages (see :meth:`TensorCodec.decode`); pickled messages and
    embedded pickles need ``allow_pickle=True``."""
    if bytes(frames[0][: len(WIRE_MAGIC)]) == WIRE_MAGIC:
        return TensorCodec.decode(
            frames, copy_arrays=copy_arrays, allow_pickle=allow_pickle,
            defer_rle=defer_rle, inflate_pool=inflate_pool, counts=counts,
        )
    return PickleCodec.decode(frames, allow_pickle=allow_pickle)


def sizeof_frames(frames: list) -> int:
    """Total payload bytes of an encoded message."""
    total = 0
    for f in frames:
        if isinstance(f, (bytes, bytearray)):
            total += len(f)
        elif isinstance(f, memoryview):
            total += f.nbytes  # len() counts elements of a shaped view
        else:
            total += len(bytes(f))
    return total
