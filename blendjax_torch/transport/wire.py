"""Wire format: the tensor codec ("bjx1"), copied from ``blendjax/transport/wire.py``.

One multipart message: a msgpack header frame prefixed with
:data:`~blendjax_torch.constants.WIRE_MAGIC`, then one frame per ndarray.
Array entries are ``"nd"`` (raw bytes), ``"ndz"`` (zlib, only when it
shrinks the frame) or ``"ndr"`` (the run-length tile-group codec of
:mod:`blendjax_torch.ops.tiles`). msgpack-native values ride in the header
(``"obj"``). The byte layout is identical to the JAX package's, so either
side decodes the other's messages. The pickle codec and embedded pickle
entries are not part of this port yet: encoding a value msgpack cannot
carry raises, and a ``"pkl"`` entry is refused on decode.
"""

from __future__ import annotations

import zlib

import msgpack
import numpy as np

from blendjax_torch.constants import WIRE_MAGIC

# Arrays below this size are not worth a zlib or run-length round trip.
DEFAULT_COMPRESS_MIN_BYTES = 16_384


def _np_scalar_to_py(value):
    return value.item() if isinstance(value, np.generic) else value


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
               compress_rle: bool = False, rle_cap: int | None = None) -> list:
        """``message`` -> list of frames. ``compress_rle`` tries the
        ``"ndr"`` kind first for uint8 arrays of at least
        ``compress_min_bytes`` (``rle_cap`` pins the per-row capacity);
        ``compress_level > 0`` then tries zlib. Either ships only when it
        shrinks the frame."""
        entries = []
        buffers = []
        for key, value in message.items():
            if isinstance(value, np.ndarray) and value.dtype != object:
                arr = np.ascontiguousarray(value)
                raw = arr.data if arr.size else b""
                if (
                    compress_rle
                    and arr.dtype == np.uint8
                    and arr.nbytes >= compress_min_bytes
                ):
                    from blendjax_torch.ops.tiles import rle_encode_rows

                    out = rle_encode_rows(arr, cap=rle_cap)
                    if out is not None and out[0].nbytes < arr.nbytes:
                        buf, cap_eff, isz = out
                        entries.append(
                            ["ndr", key, list(arr.shape), arr.dtype.str,
                             len(buffers), int(cap_eff), int(isz)]
                        )
                        buffers.append(buf)
                        continue
                if compress_level > 0 and arr.nbytes >= compress_min_bytes:
                    packed = zlib.compress(raw, compress_level)
                    if len(packed) < arr.nbytes:
                        entries.append(
                            ["ndz", key, list(arr.shape), arr.dtype.str,
                             len(buffers)]
                        )
                        buffers.append(packed)
                        continue
                entries.append(
                    ["nd", key, list(arr.shape), arr.dtype.str, len(buffers)]
                )
                buffers.append(raw)
            else:
                packed = msgpack.packb(
                    _np_scalar_to_py(value), use_bin_type=True
                )
                entries.append(["obj", key, packed])
        header = WIRE_MAGIC + msgpack.packb([1, entries], use_bin_type=True)
        return [header, *buffers]

    @staticmethod
    def decode(frames: list, defer_rle: bool = False) -> dict:
        """Decode one multipart message. ``defer_rle=True`` leaves the
        ``"ndr"`` entries of prebatched messages (``_prebatched`` in the
        header) packed: the dict then carries ``<key>__ndr`` (the packed
        buffer) and ``<key>__ndrspec`` (``[shape, isz, cap]``) for the
        device-side expansion in the fused train step."""
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
        out = {}
        for entry in entries:
            kind, key = entry[0], entry[1]
            if kind == "nd":
                _, _, shape, dtype, idx = entry
                arr = np.frombuffer(
                    frames[1 + idx], dtype=np.dtype(dtype)
                ).reshape(shape)
                out[key] = arr  # read-only view of the frame
            elif kind == "ndz":
                _, _, shape, dtype, idx = entry
                dt = np.dtype(dtype)
                buf = _inflate_bounded(
                    key, frames[1 + idx], _declared_bytes(key, shape, dt)
                )
                out[key] = np.frombuffer(buf, dtype=dt).reshape(shape)
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
                _declared_bytes(key, shape, np.dtype(dtype))
                wire_buf = frames[1 + idx]
                rows = int(shape[0]) if len(shape) >= 2 else 1
                nb = getattr(wire_buf, "nbytes", None)
                if nb is None:
                    nb = len(wire_buf)
                stride = rle_packed_stride(int(cap), int(isz))
                if rows <= 0 or nb != rows * stride:
                    raise ValueError(
                        f"ndr frame for {key!r} carries {nb} bytes, "
                        f"declared {rows} rows x {stride} (truncated or "
                        "padded stream)"
                    )
                buf = np.frombuffer(wire_buf, np.uint8).reshape(rows, stride)
                if defer_rle:
                    out[key + NDR_SUFFIX] = buf
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
            else:
                raise ValueError(
                    f"wire entry kind {kind!r} for key {key!r} is not "
                    "supported by this codec"
                )
        return out


def encode_message(message: dict, **kwargs) -> list:
    return TensorCodec.encode(message, **kwargs)


def decode_message(frames: list, defer_rle: bool = False) -> dict:
    return TensorCodec.decode(frames, defer_rle=defer_rle)
