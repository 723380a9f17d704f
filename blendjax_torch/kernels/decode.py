"""Tile-delta decode kernels K1 and K2: wrappers, plain twins, launch counts.

- :func:`decode_spatial` (K1, ``csrc/decode_spatial.cu``) replaces
  ``blendjax/ops/tiles.py:_pallas_decode_spatial``: full frames written in
  frame layout, one block per tile footprint.
- :func:`decode_scatter` (K2, ``csrc/decode_scatter.cu``) replaces
  ``blendjax/ops/tiles.py:_pallas_decode_scatter``: one launch that writes
  every slot once, the changed tile where an index names the slot, the
  reference tile elsewhere.

Each wrapper launches its CUDA kernel for CUDA tensors and adds one to its
``launches`` count (its ``work(...)`` declares the launch's bytes,
:func:`blendjax_torch.kernels.work.decode_work`); for CPU tensors it returns its plain PyTorch twin
(``*_plain``), which the CPU tests use and ``chip_smoke.py`` holds the
kernel against. Any other device, or mixed devices, raise: there is no
fallback from a failed launch.
"""

from __future__ import annotations

import ctypes
import math

import torch

from blendjax_torch.kernels.build import entry, load
from blendjax_torch.kernels.counting import count_launch
from blendjax_torch.kernels.work import decode_work
from blendjax_torch.ops.tiles import tile_grid


def _frames_from_blocks(blocks, gh, gw, th, tw, c):
    """(B, N, th, tw*C) footprints -> (B, H, W, C) frames."""
    b = blocks.shape[0]
    return blocks.reshape(b, gh, gw, th, tw, c).permute(
        0, 1, 3, 2, 4, 5
    ).reshape(b, gh * th, gw * tw, c)


def _valid_index(idx, n):
    """(idx in [0, n)) mask and the indices with invalid entries set to n."""
    valid = (idx >= 0) & (idx < n)
    return valid, torch.where(valid, idx, torch.full_like(idx, n)).long()


def decode_spatial_plain(ref_tiles, idx, tiles, shape):
    """Plain twin of K1: invert the tile->slot map, gather the covering
    tile or the reference block for every footprint."""
    h, w, c = (int(s) for s in shape)
    b, k = idx.shape
    th, tw = tiles.shape[2], tiles.shape[3]
    gh, gw = tile_grid((h, w, c), (th, tw))
    n = gh * gw
    _, safe = _valid_index(idx, n)
    inv = torch.full((b, n + 1), k, dtype=torch.int64, device=idx.device)
    inv.scatter_(
        1, safe,
        torch.arange(k, device=idx.device).expand(b, k).contiguous(),
    )
    inv = inv[:, :n]
    rows = torch.arange(b, device=idx.device)[:, None]
    chosen = tiles.reshape(b, k, th, tw * c)[rows, inv.clamp(max=k - 1)]
    ref_blocks = ref_tiles.reshape(1, n, th, tw * c)
    blocks = torch.where((inv < k)[..., None, None], chosen, ref_blocks)
    return _frames_from_blocks(blocks, gh, gw, th, tw, c)


def decode_scatter_plain(ref_tiles, idx, tiles):
    """Plain twin of K2: reference-broadcast slots with each changed tile
    written to its slot. Returns (B, N, th*tw*C)."""
    b, k = idx.shape
    n = ref_tiles.shape[0]
    ttc = ref_tiles[0].numel()
    slots = ref_tiles.reshape(1, n, ttc).expand(b, n, ttc).clone()
    valid, safe = _valid_index(idx, n)
    rows = torch.arange(b, device=idx.device)[:, None].expand(b, k)
    slots[rows[valid], safe[valid]] = tiles.reshape(b, k, ttc)[valid]
    return slots


def _check_inputs(ref_tiles, idx, tiles):
    if ref_tiles.dtype != torch.uint8 or tiles.dtype != torch.uint8:
        raise TypeError("ref_tiles and tiles must be uint8")
    if idx.dtype != torch.int32 or idx.dim() != 2:
        raise TypeError(f"idx must be (B, K) int32, got {idx.dtype} {tuple(idx.shape)}")
    if tiles.dim() != 5 or tuple(tiles.shape[:2]) != tuple(idx.shape):
        raise ValueError(
            f"tiles {tuple(tiles.shape)} must be (B, K, th, tw, C) with "
            f"(B, K) = {tuple(idx.shape)}"
        )
    if tuple(ref_tiles.shape[1:]) != tuple(tiles.shape[2:]):
        raise ValueError(
            f"ref_tiles {tuple(ref_tiles.shape)} and tiles "
            f"{tuple(tiles.shape)} disagree on (th, tw, C)"
        )
    devices = {t.device for t in (ref_tiles, idx, tiles)}
    if len(devices) != 1:
        raise ValueError(f"inputs span devices {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return "cpu"
    if device.type != "cuda":
        raise RuntimeError(f"no decode kernel for device {device}")
    for name, t in (("ref_tiles", ref_tiles), ("idx", idx), ("tiles", tiles)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the CUDA kernel")
    return "cuda"


def _aligned16(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _raise_on(lib, err_fn: str, code: int, what: str) -> None:
    if code:
        fn = getattr(lib, err_fn)
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what} launch failed: {fn(code).decode()}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def decode_spatial(ref_tiles, idx, tiles, shape):
    """K1: ``ref_tiles`` (N, th, tw, C) uint8, ``idx`` (B, K) int32 with
    sentinel N, ``tiles`` (B, K, th, tw, C) uint8 -> frames (B, H, W, C)
    uint8. Any tile geometry that divides the frame."""
    h, w, c = (int(s) for s in shape)
    th, tw = int(tiles.shape[2]), int(tiles.shape[3])
    gh, gw = tile_grid((h, w, c), (th, tw))
    if ref_tiles.shape[0] != gh * gw or int(tiles.shape[4]) != c:
        raise ValueError(
            f"ref_tiles {tuple(ref_tiles.shape)} / tiles "
            f"{tuple(tiles.shape)} do not tile a {h}x{w}x{c} frame"
        )
    if _check_inputs(ref_tiles, idx, tiles) == "cpu":
        return decode_spatial_plain(ref_tiles, idx, tiles, shape)
    b, k = idx.shape
    out = torch.empty((b, h, w, c), dtype=torch.uint8, device=idx.device)
    inv = torch.empty((b, gh * gw), dtype=torch.int32, device=idx.device)
    vec16 = (tw * c) % 16 == 0 and _aligned16(ref_tiles, tiles, out)
    lib = load("decode_spatial")
    fn = entry(lib, "bjt_decode_spatial",
               [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    code = fn(
        ref_tiles.data_ptr(), idx.data_ptr(), tiles.data_ptr(),
        out.data_ptr(), inv.data_ptr(), b, k, h, w, c, th, tw, int(vec16),
        _stream(idx.device),
    )
    _raise_on(lib, "bjt_decode_spatial_error", code, "decode_spatial")
    count_launch(decode_spatial, work=lambda: decode_spatial.work(
        ref_tiles, idx, tiles, shape))
    return out


decode_spatial.launches = 0
decode_spatial.work = lambda ref_tiles, idx, tiles, shape: decode_work(
    int(ref_tiles.shape[0]), ref_tiles[0].numel(), idx.numel(), idx.numel(),
    int(idx.shape[0]) * math.prod(int(s) for s in shape))


def decode_scatter(ref_tiles, idx, tiles):
    """K2: slots (B, N, th*tw*C) uint8: slot ``idx[b, k]`` of frame b holds
    tile k of frame b, every other slot its reference tile (sentinels and
    out-of-range indices write nothing). On the card this is one launch,
    which writes every slot once: no initialisation before it."""
    if _check_inputs(ref_tiles, idx, tiles) == "cpu":
        return decode_scatter_plain(ref_tiles, idx, tiles)
    b, k = idx.shape
    n = int(ref_tiles.shape[0])
    ttc = ref_tiles[0].numel()
    slots = torch.empty((b, n, ttc), dtype=torch.uint8, device=idx.device)
    vec16 = ttc % 16 == 0 and _aligned16(ref_tiles, tiles, slots)
    lib = load("decode_scatter")
    fn = entry(lib, "bjt_decode_scatter",
               [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    code = fn(
        ref_tiles.data_ptr(), idx.data_ptr(), tiles.data_ptr(),
        slots.data_ptr(), b, k, n, ttc, int(vec16), _stream(idx.device),
    )
    _raise_on(lib, "bjt_decode_scatter_error", code, "decode_scatter")
    count_launch(decode_scatter, work=lambda: decode_scatter.work(
        ref_tiles, idx, tiles))
    return slots


decode_scatter.launches = 0
decode_scatter.work = lambda ref_tiles, idx, tiles: decode_work(
    int(ref_tiles.shape[0]), ref_tiles[0].numel(), idx.numel(), idx.numel(),
    int(idx.shape[0]) * ref_tiles.numel())
