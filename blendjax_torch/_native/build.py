"""Build the producers' host C++ from the package's sources at first use.

Each ``<name>.cpp`` beside this file compiles with ``g++ -O3 -shared -fPIC
-std=c++17`` into ``build/blendjax_torch_native/lib<name>-<hash>.so`` at the
root of the checkout (``build/`` is listed in ``.gitignore``), and is
loaded with ``ctypes`` (:mod:`blendjax_torch.libbuild`: the name carries a
hash of the source, the compiler and the flags; a build renames a
temporary file into place). A failed build raises: the producer path has
no fallback that quietly runs the numpy twins. Nothing here runs at import
time.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

from blendjax_torch import libbuild

SRC = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "blendjax_torch_native"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_libs: dict = {}


def library_path(name: str) -> Path:
    return libbuild.library_path(SRC / f"{name}.cpp", BUILD_DIR,
                                 (CXX, *CXX_FLAGS))


def build(name: str) -> Path:
    """Compile ``<name>.cpp`` unless its library exists; returns its path.
    Raises ``RuntimeError`` with the compiler's output when the build
    fails or the compiler is missing."""
    so = library_path(name)
    libbuild.build({name: ((CXX, *CXX_FLAGS), SRC / f"{name}.cpp", so)})
    return so


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``<name>.cpp``, built if needed."""
    return libbuild.load(_libs, _lock, name,
                         lambda: ctypes.CDLL(str(build(name))))


_P = ctypes.c_void_p
_I = ctypes.c_int64


def tile_delta():
    """``bjt_tile_delta(img, ref, h, w, c, th, tw, ty0, ty1, tx0, tx1,
    idx_out, tiles_out) -> count``; buffers as ``ctypes.c_void_p``
    addresses (``ndarray.ctypes.data``)."""
    return libbuild.entry(load("tiledelta"), "bjt_tile_delta",
                          [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P],
                          _I)


def palettize():
    """``bjt_palettize(px, n, c, cap, palette_out, idx_out) -> count``, or
    -1 past ``cap`` colours."""
    return libbuild.entry(load("tiledelta"), "bjt_palettize",
                          [_P, _I, _I, _I, _P, _P], _I)


def tile_delta_palidx():
    """``bjt_tile_delta_palidx(img, ref, h, w, c, th, tw, ty0, ty1, tx0,
    tx1, idx_out, palidx_out, keys, vals, palette, pcount, cap) -> count``,
    or -1 past ``cap`` colours; ``keys`` (uint32[1024]), ``vals``
    (int16[1024]), ``palette`` (uint8[256*c]) and ``pcount`` (int64[1])
    are the caller's colour table, kept across calls."""
    return libbuild.entry(load("tiledelta"), "bjt_tile_delta_palidx",
                          [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                           _P, _P, _P, _P, _P, _P, _I], _I)


def render_frame():
    """``bjt_render_frame(verts, rgba, n, light, view, proj, clip_near,
    color, zbuf, h, w, bg, prev_rect, out_rect)``: one frame rendered in
    one call (``rasterizer.cpp``)."""
    return libbuild.entry(load("rasterizer"), "bjt_render_frame",
                          [_P, _P, _I, _P, _P, _P, ctypes.c_double, _P, _P, _I,
                           _I, _P, _P, _P], None)


def paths() -> dict:
    """The library of each source, built if needed (for a producer's
    start-up report)."""
    return {name: str(build(name)) for name in ("rasterizer", "tiledelta")}
