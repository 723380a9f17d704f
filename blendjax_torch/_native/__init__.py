"""The producers' host C++ fast paths (the port's own copies of
``blendjax/_native``'s rasterizer and tile-delta scan).

``rasterizer.cpp`` renders a cube-scene frame in one call and
``tiledelta.cpp`` holds the changed-tile scan, the batch palettizer and
the fused scan and per-frame palettizer.
:mod:`blendjax_torch._native.build` compiles them with g++ at first use
into ``build/`` and loads them with ``ctypes``; a failed build raises.
"""

from blendjax_torch._native.build import (
    palettize,
    render_frame,
    tile_delta,
    tile_delta_palidx,
)

__all__ = ["palettize", "render_frame", "tile_delta", "tile_delta_palidx"]
