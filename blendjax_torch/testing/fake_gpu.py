"""A ``gpu`` module stand-in for hermetic offscreen-render tests (the
port's own copy of ``blendjax/testing/fake_gpu.py``; numpy only, no
``torch``).

Implements the surface ``blendjax_torch.producer.offscreen`` uses (reference
``pkg_blender/blendtorch/btb/offscreen.py:49-99``): ``types.GPUOffScreen``
with ``bind()``, ``draw_view3d``, and ``texture_color.read()`` returning a
buffer-protocol-ish object with a settable ``dimensions`` attribute.

The draw is not a no-op: it clears to the viewport background and splats
one pixel per visible scene-mesh vertex, projected through the EXACT
view/projection matrices the caller passed — so a consumer test can
assert the readback against the port's analytic Camera, pinning the
whole matrix-plumbing + GL-origin + flip chain, not just array shapes.
Scanline order is GL-style bottom-up (row 0 = bottom), which is what
makes ``OffScreenRenderer``'s ``flipud`` observable.
"""

from __future__ import annotations

import contextlib
import hashlib
import types

import numpy as np

BACKGROUND = (60, 60, 60, 255)  # viewport-ish grey


def _object_color(name: str):
    """Stable, bright per-object splat color."""
    h = hashlib.sha256(name.encode()).digest()
    return (128 + h[0] // 2, 128 + h[1] // 2, 128 + h[2] // 2, 255)


class _Buffer:
    """What ``texture.read()`` yields: exposes ``dimensions`` (the caller
    sets it before converting) and converts via ``np.asarray``."""

    def __init__(self, flat: np.ndarray):
        self._flat = flat
        self.dimensions = int(flat.size)

    def __array__(self, dtype=None, copy=None):
        arr = self._flat[: int(self.dimensions)]
        return arr.astype(dtype) if dtype is not None else arr


class _Texture:
    def __init__(self, offscreen: "GPUOffScreen"):
        self._off = offscreen

    def read(self) -> _Buffer:
        assert self._off._bound, "texture read outside offscreen.bind()"
        return _Buffer(self._off._pixels.reshape(-1).copy())


class GPUOffScreen:
    def __init__(self, width: int, height: int):
        self.width = int(width)
        self.height = int(height)
        # GL-ordered scanlines: row 0 is the BOTTOM of the image
        self._pixels = np.empty((self.height, self.width, 4), np.uint8)
        self._pixels[:] = BACKGROUND
        self._bound = False
        self.texture_color = _Texture(self)
        self.last_draw: dict | None = None  # test introspection

    @contextlib.contextmanager
    def bind(self):
        self._bound = True
        try:
            yield self
        finally:
            self._bound = False

    def draw_view3d(self, scene, view_layer, view3d, region,
                    view_matrix, projection_matrix,
                    do_color_management: bool = False) -> None:
        assert self._bound, "draw_view3d outside offscreen.bind()"
        del view_layer, view3d, region, do_color_management
        v = np.asarray(view_matrix, dtype=np.float64)
        p = np.asarray(projection_matrix, dtype=np.float64)
        self.last_draw = {"view": v, "proj": p, "scene": scene}
        self._pixels[:] = BACKGROUND
        for obj in getattr(scene, "objects", []):
            mesh = getattr(obj, "data", None)
            verts = getattr(mesh, "vertices", None)
            if not verts:
                continue
            local = np.stack([vx.co for vx in verts])
            mw = np.asarray(obj.matrix_world)
            world = local @ mw[:3, :3].T + mw[:3, 3]
            hom = np.concatenate(
                [world, np.ones((len(world), 1))], axis=1
            )
            clip = hom @ (p @ v).T
            w = clip[:, 3]
            ok = w > 1e-9
            ndc = clip[ok, :3] / w[ok, None]
            inside = np.all(np.abs(ndc) <= 1.0, axis=1)
            color = _object_color(obj.name)
            for x, y in ndc[inside, :2]:
                px = min(int((x + 1.0) / 2.0 * self.width), self.width - 1)
                py = min(int((y + 1.0) / 2.0 * self.height), self.height - 1)
                self._pixels[py, px] = color  # GL: py counts from bottom

    def free(self) -> None:
        pass


def build(_bpy_mod) -> types.ModuleType:
    gpu = types.ModuleType("gpu")
    gpu.__doc__ = "blendjax fake gpu (see blendjax_torch.testing.fake_gpu)"
    gpu.types = types.SimpleNamespace(GPUOffScreen=GPUOffScreen)
    gpu._is_fake = True
    return gpu
