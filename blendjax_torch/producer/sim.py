"""Headless cube scene and its software rasterizer (copied from
``blendjax/producer/sim.py``): each frame renders in one call of the port's
host C++ (``blendjax_torch/_native/rasterizer.cpp``), or with
``native=False`` through the numpy twin.

:class:`CubeScene` is the benchmark scene: one cube, randomly rotated and
recoloured each frame, publishing ``image`` (H, W, 4) uint8 plus the
projected corner pixels ``xy`` (8, 2).
"""

from __future__ import annotations

import numpy as np

from blendjax_torch.producer.camera import Camera, cube_vertices

_CUBE_FACES = np.array(
    [  # quads as indices into cube_vertices' x-major corner order
        [0, 1, 3, 2],  # -x
        [4, 6, 7, 5],  # +x
        [0, 4, 5, 1],  # -y
        [2, 3, 7, 6],  # +y
        [0, 2, 6, 4],  # -z
        [1, 5, 7, 3],  # +z
    ]
)
# each quad (a, b, c, d) splits into triangles (a, b, c), (a, c, d)
_CUBE_TRI_IDX = np.array(
    [
        idx
        for quad in _CUBE_FACES
        for idx in ([quad[0], quad[1], quad[2]], [quad[0], quad[2], quad[3]])
    ]
)
_CUBE_TRI_FACE = np.repeat(np.arange(len(_CUBE_FACES)), 2)


def cube_triangles(center, half_extent: float, rotation=None):
    """World-space triangles (12, 3, 3) and the face of each (12,)."""
    verts = cube_vertices((0, 0, 0), half_extent)
    if rotation is not None:
        verts = verts @ np.asarray(rotation, np.float64).T
    verts = verts + np.asarray(center, np.float64)
    return verts[_CUBE_TRI_IDX], _CUBE_TRI_FACE.copy()


def rotation_xyz(rx: float, ry: float, rz: float) -> np.ndarray:
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    mx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    my = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    mz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return mz @ my @ mx


class Rasterizer:
    """Z-buffered flat-shaded triangle rasterizer with dirty-rect clears:
    re-rendering into the same buffer repaints only the union of the last
    drawn rect and the new geometry's bbox (the rest is background by
    induction). ``last_drawn`` is the drawn rect ``(y0, y1, x0, x1)``, the
    tile encoder's scan hint.

    ``native=True`` renders each frame in one call of ``bjt_render_frame``
    (projection, flat shading, near culling, the dirty-rect clear and a
    span-solved fill), built at construction; a failed build raises.
    ``native=False`` runs the numpy twin, which evaluates the barycentric
    weights per pixel: the two differ only at triangle-edge pixels, by
    rounding. The C++ path takes a camera of the rasterizer's shape and
    uint8 (N, 3|4) colours, one row per triangle, and raises otherwise."""

    def __init__(self, shape=(480, 640), background=(0, 0, 0, 255),
                 native: bool = True):
        self.shape = (int(shape[0]), int(shape[1]))
        self.background = np.ascontiguousarray(background, np.uint8)
        if self.background.shape != (4,):
            raise ValueError(f"background must be RGBA, got {background!r}")
        h, w = self.shape
        self._color = np.empty((h, w, 4), np.uint8)
        self._depth = np.empty((h, w), np.float32)
        light = np.array([0.4, -0.35, 0.85])
        self._light = light / np.linalg.norm(light)
        self._prev_target: np.ndarray | None = None
        self.last_drawn: tuple | None = None
        self.native = bool(native)
        if self.native:
            from blendjax_torch._native import render_frame

            self._render_frame = render_frame()
            self._rect_prev = np.empty(4, np.int64)
            self._rect_out = np.empty(4, np.int64)

    def render(self, camera: Camera, triangles, colors, out=None) -> np.ndarray:
        """Render world-space ``triangles`` (N, 3, 3) filled with
        ``colors`` (N, 3|4) uint8 into ``out`` (contiguous (H, W, 4)
        uint8) or an internal buffer (returned as a copy)."""
        h, w = self.shape
        target = self._color if out is None else out
        if out is not None and not (
            out.shape == (h, w, 4) and out.dtype == np.uint8
            and out.flags.c_contiguous
        ):
            raise ValueError(
                f"out must be contiguous ({h}, {w}, 4) uint8; got "
                f"{out.shape} {out.dtype}"
            )
        triangles = np.asarray(triangles, np.float64)
        if self.native:
            self._render_native(camera, triangles, colors, target)
            return target.copy() if out is None else target
        px = depth = colors_v = shade_v = bbox = None
        if triangles.size:
            colors = np.asarray(colors)
            if colors.shape[1] == 3:
                colors = np.concatenate(
                    [colors, np.full((len(colors), 1), 255, colors.dtype)],
                    axis=1,
                )
            px, depth = camera.world_to_pixel(
                triangles.reshape(-1, 3), return_depth=True
            )
            px = px.reshape(-1, 3, 2)
            depth = depth.reshape(-1, 3)
            e1 = triangles[:, 1] - triangles[:, 0]
            e2 = triangles[:, 2] - triangles[:, 0]
            n = np.cross(e1, e2)
            nn = np.linalg.norm(n, axis=1, keepdims=True)
            n = np.divide(n, nn, out=np.zeros_like(n), where=nn > 1e-12)
            shade = 0.35 + 0.65 * np.abs(n @ self._light)
            visible = ~np.any(depth <= camera.clip_near, axis=1)
            px, depth = px[visible], depth[visible]
            colors_v, shade_v = colors[visible], shade[visible]
            if len(px):
                y0 = max(int(np.floor(px[:, :, 1].min())), 0)
                y1 = min(int(np.ceil(px[:, :, 1].max())) + 1, h)
                x0 = max(int(np.floor(px[:, :, 0].min())), 0)
                x1 = min(int(np.ceil(px[:, :, 0].max())) + 1, w)
                bbox = (y0, y1, x0, x1) if y0 < y1 and x0 < x1 else None
        self._clear(target, bbox)
        if px is not None:
            for i in range(len(px)):
                self._fill(target, px[i], depth[i], colors_v[i], shade_v[i])
        self._prev_target = target
        self.last_drawn = bbox
        return target.copy() if out is None else target

    def _render_native(self, camera, triangles, colors, target) -> None:
        """One ``bjt_render_frame`` call: project, shade, cull, clear the
        dirty rect (the whole frame for a new target) and fill."""
        h, w = self.shape
        n = len(triangles)
        if triangles.ndim != 3 or triangles.shape[1:] != (3, 3):
            raise ValueError(
                f"triangles must be (N, 3, 3), got {triangles.shape}")
        if camera.shape != self.shape:
            raise ValueError(
                f"camera shape {camera.shape} != rasterizer shape {self.shape}"
            )
        colors = np.asarray(colors) if n else np.empty((0, 4), np.uint8)
        if not (colors.dtype == np.uint8 and colors.ndim == 2
                and colors.shape[1] in (3, 4) and len(colors) == n):
            raise ValueError(
                f"colors must be ({n}, 3|4) uint8, got {colors.shape} "
                f"{colors.dtype}"
            )
        if colors.shape[1] == 3:
            colors = np.concatenate(
                [colors, np.full((n, 1), 255, np.uint8)], axis=1
            )
        colors = np.ascontiguousarray(colors)
        tri = np.ascontiguousarray(triangles)
        if self._prev_target is not target:
            self._rect_prev[0] = -2  # a new target: clear all of it
        elif self.last_drawn is None:
            self._rect_prev[0] = -1  # nothing drawn: clear the new bbox
        else:
            self._rect_prev[:] = self.last_drawn
        self._render_frame(
            tri.ctypes.data, colors.ctypes.data, n, self._light.ctypes.data,
            camera._view.ctypes.data, camera._proj.ctypes.data,
            camera.clip_near, target.ctypes.data, self._depth.ctypes.data,
            h, w, self.background.ctypes.data, self._rect_prev.ctypes.data,
            self._rect_out.ctypes.data,
        )
        self._prev_target = target
        self.last_drawn = (None if self._rect_out[0] < 0
                           else tuple(int(v) for v in self._rect_out))

    def _clear(self, target, new_bbox) -> None:
        rect = None
        if self._prev_target is target:
            rects = [r for r in (self.last_drawn, new_bbox) if r]
            if not rects:
                return  # nothing was drawn and nothing will be
            rect = (
                min(r[0] for r in rects), max(r[1] for r in rects),
                min(r[2] for r in rects), max(r[3] for r in rects),
            )
        if rect is not None:
            y0, y1, x0, x1 = rect
            target[y0:y1, x0:x1] = self.background
            self._depth[y0:y1, x0:x1] = np.inf
        else:
            target[:] = self.background
            self._depth[:] = np.inf

    def _fill(self, target, tri_px, tri_depth, color, shade):
        h, w = self.shape
        xmin = max(int(np.floor(tri_px[:, 0].min())), 0)
        xmax = min(int(np.ceil(tri_px[:, 0].max())) + 1, w)
        ymin = max(int(np.floor(tri_px[:, 1].min())), 0)
        ymax = min(int(np.ceil(tri_px[:, 1].max())) + 1, h)
        if xmin >= xmax or ymin >= ymax:
            return
        gx, gy = np.meshgrid(
            np.arange(xmin, xmax) + 0.5, np.arange(ymin, ymax) + 0.5
        )
        (x0, y0), (x1, y1), (x2, y2) = tri_px
        area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
        if abs(area) < 1e-12:
            return
        w0 = ((x1 - gx) * (y2 - gy) - (x2 - gx) * (y1 - gy)) / area
        w1 = ((x2 - gx) * (y0 - gy) - (x0 - gx) * (y2 - gy)) / area
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not inside.any():
            return
        z = (w0 * tri_depth[0] + w1 * tri_depth[1] + w2 * tri_depth[2]).astype(
            np.float32
        )
        zbuf = self._depth[ymin:ymax, xmin:xmax]
        cbuf = target[ymin:ymax, xmin:xmax]
        closer = inside & (z < zbuf)
        if not closer.any():
            return
        zbuf[closer] = z[closer]
        shaded = np.array(
            [*(np.asarray(color[:3], np.float64) * shade), color[3]]
        ).astype(np.uint8)
        cbuf[closer] = shaded


class CubeScene:
    """The benchmark scene: a unit cube, randomly rotated and recoloured
    every frame (``step``), seen by a fixed camera. ``native`` picks the
    rasterizer's path (:class:`Rasterizer`)."""

    def __init__(self, shape=(480, 640), seed: int = 0,
                 half_extent: float = 1.0, native: bool = True):
        self.rng = np.random.default_rng(seed)
        self.camera = Camera.look_at(
            eye=(6.0, -6.0, 4.0), target=(0, 0, 0), shape=shape
        )
        self.raster = Rasterizer(shape=shape, native=native)
        self.half_extent = float(half_extent)
        self.rotation = np.eye(3)
        self.color = np.array([200, 80, 40], np.uint8)

    def step(self, frame: int) -> None:
        del frame
        self.rotation = rotation_xyz(*self.rng.uniform(0, 2 * np.pi, size=3))
        self.color = self.rng.integers(40, 255, size=3).astype(np.uint8)

    def corners_world(self) -> np.ndarray:
        return cube_vertices((0, 0, 0), self.half_extent) @ self.rotation.T

    def background_image(self) -> np.ndarray:
        """The scene with no geometry: the tile-delta reference frame."""
        return self.raster.render(
            self.camera, np.zeros((0, 3, 3)), np.zeros((0, 4), np.uint8)
        )

    def render(self, out=None) -> np.ndarray:
        tris, faces = cube_triangles((0, 0, 0), self.half_extent, self.rotation)
        tint = 1.0 - 0.08 * (faces % 3)  # per-face tint
        colors = np.clip(
            self.color.astype(np.float64)[None, :] * tint[:, None], 0, 255
        ).astype(np.uint8)
        return self.raster.render(self.camera, tris, colors, out=out)
