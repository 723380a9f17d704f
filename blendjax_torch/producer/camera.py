"""Camera model: project scene geometry to pixel annotations (copied from
``blendjax/producer/camera.py``).

A standalone numpy pinhole or orthographic camera in Blender's
conventions (the camera looks down -Z, +Y is up), built from explicit
intrinsics and extrinsics, or from a Blender camera with
:meth:`Camera.from_bpy` (under ``bpy`` only). The parameters are plain
attributes a scene may change at any time: the view and projection
matrices are cached on their values (:meth:`Camera._matrices`), so a moved
camera projects with its new pose.
"""

from __future__ import annotations

import numpy as np

from blendjax_torch.producer.utils import dehom, hom, look_at_matrix


class Camera:
    """Pinhole or orthographic camera.

    ``position`` and ``rotation`` are the world-space origin and the 3x3
    world-from-camera rotation; ``shape`` is the image (height, width);
    ``focal_mm`` / ``sensor_mm`` are the Blender-style pinhole intrinsics
    (perspective only); ``ortho_scale`` is the world-units width of the
    view volume (orthographic only).
    """

    def __init__(
        self,
        position=(0.0, 0.0, 0.0),
        rotation=None,
        shape=(480, 640),
        focal_mm: float = 50.0,
        sensor_mm: float = 36.0,
        ortho_scale: float | None = None,
        clip_near: float = 0.1,
        clip_far: float = 100.0,
    ):
        self.position = np.asarray(position, np.float64)
        self.rotation = (
            np.eye(3) if rotation is None else np.asarray(rotation, np.float64)
        )
        self.shape = (int(shape[0]), int(shape[1]))
        self.focal_mm = float(focal_mm)
        self.sensor_mm = float(sensor_mm)
        self.ortho_scale = None if ortho_scale is None else float(ortho_scale)
        self.clip_near = float(clip_near)
        self.clip_far = float(clip_far)

    # -- constructors -------------------------------------------------------

    @classmethod
    def look_at(cls, eye, target, up=(0, 0, 1), **kwargs) -> "Camera":
        """Camera positioned at ``eye`` aimed at ``target``."""
        return cls(
            position=eye, rotation=look_at_matrix(eye, target, up), **kwargs
        )

    @classmethod
    def from_bpy(cls, bpy_camera=None, shape=None) -> "Camera":
        """Build from a Blender camera object (requires ``bpy``)."""
        from blendjax_torch.producer.bpy_engine import camera_from_bpy

        return camera_from_bpy(cls, bpy_camera, shape)

    # -- matrices -----------------------------------------------------------

    @property
    def view_matrix(self) -> np.ndarray:
        """4x4 camera-from-world."""
        m = np.eye(4)
        rt = np.asarray(self.rotation, np.float64).T
        m[:3, :3] = rt
        m[:3, 3] = -rt @ np.asarray(self.position, np.float64)
        return m

    @property
    def proj_matrix(self) -> np.ndarray:
        """4x4 OpenGL-style projection."""
        h, w = self.shape
        aspect = w / h
        n, f = self.clip_near, self.clip_far
        p = np.zeros((4, 4))
        if self.ortho_scale is not None:
            r = self.ortho_scale / 2.0
            t = r / aspect
            p[0, 0] = 1.0 / r
            p[1, 1] = 1.0 / t
            p[2, 2] = -2.0 / (f - n)
            p[2, 3] = -(f + n) / (f - n)
            p[3, 3] = 1.0
        else:
            sx = self.sensor_mm
            sy = self.sensor_mm / aspect
            p[0, 0] = 2.0 * self.focal_mm / sx
            p[1, 1] = 2.0 * self.focal_mm / sy
            p[2, 2] = -(f + n) / (f - n)
            p[2, 3] = -2.0 * f * n / (f - n)
            p[3, 2] = -1.0
        return p

    def _matrices(self):
        """(view, proj), cached on the values of the parameters (a dozen
        doubles: building the key costs far less than the matrices, which
        the rasterizer reads every frame)."""
        key = (
            np.asarray(self.position, np.float64).tobytes(),
            np.asarray(self.rotation, np.float64).tobytes(),
            self.shape,
            self.focal_mm, self.sensor_mm, self.ortho_scale,
            self.clip_near, self.clip_far,
        )
        if getattr(self, "_mat_key", None) != key:
            view = self.view_matrix
            proj = self.proj_matrix
            # the key goes last: a failed build must not leave a key whose
            # matrices were never stored
            self._view_cached = view
            self._proj_cached = proj
            self._mat_key = key
        return self._view_cached, self._proj_cached

    # -- projections --------------------------------------------------------

    def world_to_ndc(self, xyz_world) -> tuple[np.ndarray, np.ndarray]:
        """World points -> (NDC, linear depth along the view direction)."""
        xyz_world = np.atleast_2d(np.asarray(xyz_world, np.float64))
        view, proj = self._matrices()
        cam = hom(xyz_world) @ view.T
        depth = -cam[:, 2]
        ndc = dehom(cam @ proj.T)
        return ndc, depth

    def ndc_to_pixel(self, ndc, origin: str = "upper-left") -> np.ndarray:
        """NDC -> pixel coordinates, the origin upper-left or lower-left."""
        if origin not in ("upper-left", "lower-left"):
            raise ValueError(f"unknown origin {origin!r}")
        h, w = self.shape
        ndc = np.atleast_2d(np.asarray(ndc, np.float64))
        x = (ndc[:, 0] + 1.0) * 0.5 * w
        y01 = (ndc[:, 1] + 1.0) * 0.5
        y = (1.0 - y01) * h if origin == "upper-left" else y01 * h
        return np.stack([x, y], axis=1)

    def world_to_pixel(
        self, xyz_world, origin: str = "upper-left", return_depth: bool = False
    ):
        """World points -> pixel coordinates (and depth)."""
        ndc, depth = self.world_to_ndc(xyz_world)
        px = self.ndc_to_pixel(ndc, origin=origin)
        return (px, depth) if return_depth else px

    def bbox_world_to_pixel(self, xyz_world, origin: str = "upper-left"):
        """Axis-aligned pixel bbox ``(xmin, ymin, xmax, ymax)`` of points."""
        px = self.world_to_pixel(xyz_world, origin=origin)
        mins, maxs = px.min(axis=0), px.max(axis=0)
        return np.array([mins[0], mins[1], maxs[0], maxs[1]])
