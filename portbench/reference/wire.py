"""Plain reader of recorded wire messages and the tile-delta decode.

Frozen NumPy copies of what the reference needs to turn the bytes that
crossed the socket into frames, written from the wire convention the
port documents (``blendjax_torch/docs/wire-protocol.md``) and imported by
nothing of the port:

- the ``.bjr`` container: ``b"BJXR1\\n"``, then per message ``u32
  nframes`` and per frame ``u64 size`` + bytes, then a footer of ``u64``
  offsets, ``u64 n``, ``u64 footer_start`` and ``b"BJXRIDX"``;
- the tensor codec: frame 0 is ``b"BJX1"`` + msgpack ``[1, entries]``;
  an ``"nd"`` entry ``[kind, key, shape, dtype, frame]`` is a raw array,
  an ``"obj"`` entry a msgpack value. Compressed kinds are refused: the
  benchmark's traffic is the raw wire;
- a tile-delta field ``image``: ``image__tileidx`` (B, K) int32 with the
  sentinel ``GH * GW``, ``image__tileshape`` ``[H, W, C, th, tw]`` (or
  ``[H, W, C, t]``), the changed tiles as raw ``image__tiles`` (B, K, th,
  tw, Ct) or palette indices ``image__tilepal{2,4,8}`` (first index in
  the high bits) with ``image__palette`` ((cap, C) shared or (B, cap, C)
  per frame), and the reference frame ``image__tileref`` on the first
  message of a stream and every ``ref_interval``-th after.
"""

from __future__ import annotations

import os
import struct

import msgpack
import numpy as np

MAGIC = b"BJXR1\n"
FOOTER_MAGIC = b"BJXRIDX"
WIRE_MAGIC = b"BJX1"


def read_recording(path: str, count: int | None = None) -> list:
    """The first ``count`` messages (all with ``None``) of a ``.bjr`` file,
    each as its list of frames (bytes)."""
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError(f"{path}: not a recording")
        f.seek(-(len(FOOTER_MAGIC) + 16), os.SEEK_END)
        tail = f.read()
        if tail[16:] != FOOTER_MAGIC:
            raise ValueError(f"{path}: no index footer")
        n, start = struct.unpack("<QQ", tail[:16])
        f.seek(start)
        offsets = struct.unpack(f"<{n}Q", f.read(8 * n))
        out = []
        for off in offsets[:count]:
            f.seek(off)
            (nframes,) = struct.unpack("<I", f.read(4))
            frames = []
            for _ in range(nframes):
                (size,) = struct.unpack("<Q", f.read(8))
                frames.append(f.read(size))
            out.append(frames)
        return out


def decode_frames(frames: list) -> dict:
    """One tensor-codec message -> ``{key: array or value}``."""
    head = bytes(frames[0])
    if head[:len(WIRE_MAGIC)] != WIRE_MAGIC:
        raise ValueError("not a tensor-codec message")
    version, entries = msgpack.unpackb(head[len(WIRE_MAGIC):], raw=False,
                                       strict_map_key=False)
    if version != 1:
        raise ValueError(f"wire version {version}")
    out = {}
    for entry in entries:
        kind, key = entry[0], entry[1]
        if kind == "nd":
            _, _, shape, dtype, idx = entry
            out[key] = np.frombuffer(frames[1 + idx],
                                     dtype=np.dtype(dtype)).reshape(shape)
        elif kind == "obj":
            out[key] = msgpack.unpackb(entry[2], raw=False,
                                       strict_map_key=False)
        else:
            raise ValueError(f"wire entry kind {kind!r} for {key!r}: the "
                             "reference reads the raw wire only")
    return out


def unpack_indices(packed: np.ndarray, bits: int) -> np.ndarray:
    """Palette indices packed along the last axis, first in the high bits."""
    if bits == 8:
        return packed
    per = 8 // bits
    shifts = np.arange(per - 1, -1, -1, dtype=np.uint8) * bits
    out = (packed[..., None] >> shifts) & ((1 << bits) - 1)
    return out.reshape(*packed.shape[:-1], packed.shape[-1] * per)


def changed_tiles(msg: dict, name: str, th: int, tw: int) -> np.ndarray:
    """The (B, K, th, tw, Ct) tiles a message carries for ``name``."""
    for bits in (2, 4, 8):
        key = f"{name}__tilepal{bits}"
        if key in msg:
            idx = unpack_indices(msg[key], bits)  # (B, K, th*tw)
            pal = msg[f"{name}__palette"]
            b, k = idx.shape[:2]
            if pal.ndim == 3:  # one palette per frame
                tiles = np.stack([pal[i][idx[i]] for i in range(b)])
            else:
                tiles = pal[idx]
            return tiles.reshape(b, k, th, tw, pal.shape[-1])
    return msg[f"{name}__tiles"]


def decode_tiles(msg: dict, ref: np.ndarray, name: str = "image") -> np.ndarray:
    """The (B, H, W, C) uint8 frames of a tile-delta message against its
    stream's reference frame ``ref`` (H, W, C): every frame starts as the
    reference, and each non-sentinel slot overwrites its tile (channels
    past a sliced tile's Ct keep the reference's)."""
    geom = [int(v) for v in msg[f"{name}__tileshape"]]
    h, w, c = geom[:3]
    th, tw = (geom[3], geom[4]) if len(geom) >= 5 else (geom[3], geom[3])
    gh, gw = h // th, w // tw
    n = gh * gw
    idx = msg[f"{name}__tileidx"]
    tiles = changed_tiles(msg, name, th, tw)
    b = idx.shape[0]
    ct = tiles.shape[-1]
    out = np.broadcast_to(ref, (b, h, w, c)).copy()
    grid = out.reshape(b, gh, th, gw, tw, c)
    for i in range(b):
        keep = idx[i] < n
        slots = idx[i][keep]
        grid[i, slots // gw, :, slots % gw, :, :ct] = tiles[i][keep]
    return out


class StreamFrames:
    """Frames of a stream's messages in order, each decoded against the
    reference frame its producer (``btid``) last sent."""

    def __init__(self, name: str = "image"):
        self.name = name
        self.refs: dict = {}

    def take_ref(self, msg: dict) -> None:
        """Keep the reference frame a message carries, if it carries one."""
        ref = msg.get(f"{self.name}__tileref")
        if ref is not None:
            self.refs[msg.get("btid")] = ref

    def __call__(self, msg: dict) -> tuple:
        """``(frames (B, H, W, C) uint8, xy (B, 8, 2) float32)``."""
        btid = msg.get("btid")
        self.take_ref(msg)
        if btid not in self.refs:
            raise ValueError(f"message of producer {btid!r} before its "
                             "reference frame")
        frames = decode_tiles(msg, self.refs[btid], self.name)
        return frames, np.asarray(msg["xy"], np.float32)
