"""Headless simulation engine, a Blender stand-in (copied from
``blendjax/producer/sim.py``): a software rasterizer and small scenes,
each rendered in one call of the port's host C++
(``blendjax_torch/_native/rasterizer.cpp``), or with ``native=False``
through the numpy twin.

- :class:`CubeScene`: the benchmark scene, one cube randomly rotated and
  recoloured each frame, publishing ``image`` (H, W, 4) uint8 plus the
  projected corner pixels ``xy`` (8, 2).
- :class:`FallingCubesScene`: N cubes under gravity with a ground bounce.
- :class:`SupershapeScene`: a 2D superformula silhouette whose parameters
  arrive over the duplex channel.
- :class:`CartpoleScene`: cart and pole with a velocity-servo motor, the
  remote-controlled environment of the gym layer.

:class:`SimEngine` drives a scene from an
:class:`~blendjax_torch.producer.animation.AnimationController`.
"""

from __future__ import annotations

import numpy as np

from blendjax_torch.producer.animation import Engine
from blendjax_torch.producer.camera import Camera
from blendjax_torch.producer.utils import cube_vertices

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
        view, proj = camera._matrices()
        if self._prev_target is not target:
            self._rect_prev[0] = -2  # a new target: clear all of it
        elif self.last_drawn is None:
            self._rect_prev[0] = -1  # nothing drawn: clear the new bbox
        else:
            self._rect_prev[:] = self.last_drawn
        self._render_frame(
            tri.ctypes.data, colors.ctypes.data, n, self._light.ctypes.data,
            view.ctypes.data, proj.ctypes.data,
            camera.clip_near, target.ctypes.data, self._depth.ctypes.data,
            h, w, self.background.ctypes.data, self._rect_prev.ctypes.data,
            self._rect_out.ctypes.data,
        )
        self._prev_target = target
        self.last_drawn = (None if self._rect_out[0] < 0
                           else tuple(int(v) for v in self._rect_out))

    def invalidate(self) -> None:
        """Forget the dirty-rect state: the next render clears the whole
        target (after the background changed, or after the last target
        was written from outside)."""
        self._prev_target = None
        self.last_drawn = None

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


class SimScene:
    """Base: a camera, a rasterizer (``native`` picks its path) and the
    per-frame state, drawn from ``rng`` (seeded by ``seed``)."""

    def __init__(self, shape=(480, 640), seed: int = 0, camera: Camera = None,
                 native: bool = True):
        self.rng = np.random.default_rng(seed)
        self.camera = camera or Camera.look_at(
            eye=(6.0, -6.0, 4.0), target=(0, 0, 0), shape=shape
        )
        self.raster = Rasterizer(shape=shape, native=native)
        self.reset()

    def reset(self) -> None:
        """Rewind hook (``Engine.reset``, at every episode start)."""

    def reseed(self, seed: int) -> None:
        """Replace the episode RNG: where a remote ``reset(seed=)`` lands
        (``BaseEnv._env_seed``), so two seeded resets start identical
        episodes."""
        self.rng = np.random.default_rng(int(seed))

    def step(self, frame: int) -> None:
        """Advance the scene to ``frame``."""
        raise NotImplementedError

    def render(self) -> np.ndarray:
        raise NotImplementedError

    def background_image(self) -> np.ndarray:
        """The scene with no geometry: the tile-delta reference frame."""
        return self.raster.render(
            self.camera, np.zeros((0, 3, 3)), np.zeros((0, 4), np.uint8)
        )


class CubeScene(SimScene):
    """The benchmark scene: a cube, randomly rotated and recoloured every
    frame (``step``), seen by a fixed camera.

    The domain-randomization hooks (:mod:`blendjax_torch.scenario`):
    :meth:`apply_scenario` sets the cube's size, the label noise
    ``xy_jitter`` (pixels of Gaussian noise on the corner labels, the knob
    that makes a scenario irreducibly harder) and the background grey."""

    def __init__(self, shape=(480, 640), seed: int = 0,
                 half_extent: float = 1.0, native: bool = True):
        self.half_extent = float(half_extent)
        self.rotation = np.eye(3)
        self.color = np.array([200, 80, 40], np.uint8)
        self.xy_jitter = 0.0
        super().__init__(shape=shape, seed=seed, native=native)
        # what apply_scenario reverts unnamed known params to: a draw is a
        # complete description, never a delta on the previous draw
        self._scenario_defaults = {
            "half_extent": float(half_extent),
            "background": self.raster.background.copy(),
        }

    def reset(self) -> None:
        self.rotation = np.eye(3)

    def apply_scenario(self, params: dict) -> None:
        """Apply one sampled scenario-parameter dict (the
        :class:`~blendjax_torch.producer.scenario.ScenarioApplicator`
        hook). Known params: ``half_extent``, ``xy_jitter`` (clamped at
        0) and ``bg`` (background grey 0-255); others are ignored (a space
        may carry params for several kinds of scene). Known params the
        draw does not name go back to their defaults, so no scenario
        inherits the previous draw's noise."""
        self.half_extent = float(
            params.get("half_extent", self._scenario_defaults["half_extent"])
        )
        self.xy_jitter = max(0.0, float(params.get("xy_jitter", 0.0)))
        bg = params.get("bg")
        g = (
            self._scenario_defaults["background"] if bg is None
            else np.ascontiguousarray(
                [int(np.clip(float(bg), 0, 255))] * 3 + [255], np.uint8
            )
        )
        if not np.array_equal(g, self.raster.background):
            self.raster.background = g
            # dirty-rect clears assume a constant background
            self.raster.invalidate()

    def step(self, frame: int) -> None:
        del frame
        self.rotation = rotation_xyz(*self.rng.uniform(0, 2 * np.pi, size=3))
        self.color = self.rng.integers(40, 255, size=3).astype(np.uint8)

    def corners_world(self) -> np.ndarray:
        return cube_vertices((0, 0, 0), self.half_extent) @ self.rotation.T

    def render(self, out=None) -> np.ndarray:
        tris, faces = cube_triangles((0, 0, 0), self.half_extent, self.rotation)
        tint = 1.0 - 0.08 * (faces % 3)  # per-face tint
        colors = np.clip(
            self.color.astype(np.float64)[None, :] * tint[:, None], 0, 255
        ).astype(np.uint8)
        return self.raster.render(self.camera, tris, colors, out=out)

    def _label_xy(self) -> np.ndarray:
        """The corners' pixel coordinates (8, 2), with ``xy_jitter``
        pixels of Gaussian label noise when a scenario set it."""
        xy = self.camera.world_to_pixel(self.corners_world())
        if self.xy_jitter:
            xy = xy + self.rng.normal(0.0, self.xy_jitter, xy.shape)
        return xy

    def observation(self, frame: int) -> dict:
        return {"image": self.render(),
                "xy": self._label_xy().astype(np.float32), "frameid": frame}

    def observation_into(self, frame: int, buf: dict, i: int) -> None:
        """Write frame ``frame``'s observation into slot ``i`` of a batch
        buffer dict (``image`` (B, H, W, 4) uint8, ``xy`` (B, 8, 2)
        float32, ``frameid`` (B,) int64), rendering in place."""
        self.render(out=buf["image"][i])
        buf["xy"][i] = self._label_xy()
        buf["frameid"][i] = frame


class FallingCubesScene(SimScene):
    """N cubes under gravity with an inelastic ground bounce."""

    def __init__(self, shape=(480, 640), seed: int = 0, num_cubes: int = 8,
                 native: bool = True):
        self.num_cubes = num_cubes
        super().__init__(shape=shape, seed=seed, native=native)

    def reset(self) -> None:
        n = self.num_cubes
        self.pos = np.stack(
            [
                self.rng.uniform(-3, 3, n),
                self.rng.uniform(-3, 3, n),
                self.rng.uniform(4, 9, n),
            ],
            axis=1,
        )
        self.vel = np.zeros((n, 3))
        self.rot = self.rng.uniform(0, 2 * np.pi, (n, 3))
        self.rotvel = self.rng.uniform(-2, 2, (n, 3))
        self.colors = self.rng.integers(40, 255, (n, 3)).astype(np.uint8)
        self.half = 0.5

    def step(self, frame: int, dt: float = 1 / 25) -> None:
        g = np.array([0, 0, -9.81])
        self.vel += g * dt
        self.pos += self.vel * dt
        self.rot += self.rotvel * dt
        low = self.pos[:, 2] < self.half
        self.pos[low, 2] = self.half
        self.vel[low, 2] *= -0.5

    def render(self) -> np.ndarray:
        all_tris, all_cols = [], []
        for i in range(self.num_cubes):
            tris, _faces = cube_triangles(
                self.pos[i], self.half, rotation_xyz(*self.rot[i])
            )
            all_tris.append(tris)
            all_cols.append(np.repeat(self.colors[i][None], 12, axis=0))
        return self.raster.render(
            self.camera, np.concatenate(all_tris), np.concatenate(all_cols)
        )

    def observation(self, frame: int) -> dict:
        return {
            "image": self.render(),
            "xy": self.camera.world_to_pixel(self.pos).astype(np.float32),
            "frameid": frame,
        }


def supershape_radius(theta, m, n1, n2, n3, a=1.0, b=1.0):
    """The superformula (Gielis)."""
    t = np.abs(np.cos(m * theta / 4.0) / a) ** n2 + np.abs(
        np.sin(m * theta / 4.0) / b
    ) ** n3
    return t ** (-1.0 / n1)


class SupershapeScene(SimScene):
    """2D supershape silhouette; its parameters are set over the duplex
    channel (:meth:`set_params`)."""

    def __init__(self, shape=(256, 256), seed: int = 0, segments: int = 72,
                 native: bool = True):
        self.segments = segments
        self.params = np.array([6.0, 1.0, 1.0, 1.0])  # m, n1, n2, n3
        self.shape_id = -1
        cam = Camera.look_at(
            eye=(0, 0, 8.0), target=(0, 0, 0), up=(0, 1, 0), shape=shape
        )
        super().__init__(shape=shape, seed=seed, camera=cam, native=native)

    def set_params(self, params, shape_id: int) -> None:
        self.params = np.asarray(params, np.float64)
        self.shape_id = int(shape_id)

    def step(self, frame: int) -> None:
        pass  # the shape changes only through set_params

    def render(self) -> np.ndarray:
        theta = np.linspace(0, 2 * np.pi, self.segments, endpoint=False)
        r = supershape_radius(theta, *self.params)
        r = np.nan_to_num(r, nan=0.0, posinf=0.0) * 2.0
        pts = np.stack([r * np.cos(theta), r * np.sin(theta), np.zeros_like(r)], 1)
        center = np.zeros(3)
        tris = np.stack(
            [
                np.broadcast_to(center, (self.segments, 3)),
                pts,
                np.roll(pts, -1, axis=0),
            ],
            axis=1,
        )
        colors = np.repeat(
            np.array([[230, 230, 230]], np.uint8), self.segments, axis=0
        )
        return self.raster.render(self.camera, tris, colors)

    def observation(self, frame: int) -> dict:
        return {
            "image": self.render(),
            "shape_id": self.shape_id,
            "frameid": frame,
        }


class CartpoleScene(SimScene):
    """Cart and pole on a rail, the cart driven by a velocity-servo motor
    whose target velocity is the action."""

    GRAVITY = 9.81
    MASS_CART = 1.0
    MASS_POLE = 0.1
    POLE_LEN = 1.0  # half-length
    DT = 1 / 60

    def __init__(self, shape=(240, 320), seed: int = 0, native: bool = True):
        cam = Camera.look_at(
            eye=(0, -8.0, 1.0), target=(0, 0, 1.0), shape=shape
        )
        super().__init__(shape=shape, seed=seed, camera=cam, native=native)

    def reset(self) -> None:
        # x, x_dot, theta (rad from upright), theta_dot
        self.state = self.rng.uniform(-0.05, 0.05, size=4)
        self.motor_velocity = 0.0

    def apply_motor(self, velocity: float) -> None:
        self.motor_velocity = float(np.clip(velocity, -5.0, 5.0))

    def step(self, frame: int) -> None:
        x, x_dot, th, th_dot = self.state
        # the cart accelerates toward the commanded velocity; the pole
        # swings from the cart's acceleration and gravity
        x_acc = 20.0 * (self.motor_velocity - x_dot)
        th_acc = (
            self.GRAVITY * np.sin(th) - x_acc * np.cos(th)
        ) / self.POLE_LEN
        dt = self.DT
        x_dot += x_acc * dt
        x += x_dot * dt
        th_dot += th_acc * dt
        th += th_dot * dt
        self.state = np.array([x, x_dot, th, th_dot])

    def observation_vector(self) -> np.ndarray:
        return self.state.astype(np.float32)

    def render(self) -> np.ndarray:
        x, _, th, _ = self.state
        cart_c = np.array([x, 0.0, 0.5])
        cart_tris, _ = cube_triangles(cart_c, 0.3)
        tip = cart_c + np.array([np.sin(th), 0.0, np.cos(th)]) * (
            2 * self.POLE_LEN
        )
        mid = (cart_c + tip) / 2
        d = tip - cart_c
        zaxis = d / (np.linalg.norm(d) + 1e-9)
        xaxis = np.cross([0, 1, 0], zaxis)
        xaxis /= np.linalg.norm(xaxis) + 1e-9
        yaxis = np.cross(zaxis, xaxis)
        rot = np.stack([xaxis, yaxis, zaxis], axis=1)
        pole_tris, _ = cube_triangles((0, 0, 0), 1.0, rotation=None)
        scale = np.diag([0.05, 0.05, np.linalg.norm(d) / 2])
        pole_tris = pole_tris @ (rot @ scale).T + mid
        tris = np.concatenate([cart_tris, pole_tris])
        colors = np.concatenate(
            [
                np.repeat(np.array([[80, 80, 220]], np.uint8), 12, axis=0),
                np.repeat(np.array([[220, 180, 40]], np.uint8), 12, axis=0),
            ]
        )
        return self.raster.render(self.camera, tris, colors)


class SimEngine(Engine):
    """Drive a :class:`SimScene` from an AnimationController (the headless
    counterpart of Blender's frame clock)."""

    def __init__(self, scene: SimScene):
        self.scene = scene

    def frame_set(self, frame: int) -> None:
        self.scene.step(frame)

    def reset(self) -> None:
        self.scene.reset()
