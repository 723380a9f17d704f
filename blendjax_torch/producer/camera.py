"""Pinhole camera model (copied from ``blendjax/producer/camera.py`` and
the geometry helpers of ``blendjax/producer/utils.py``).

Blender conventions: the camera looks down -Z, +Y is up. Projects world
points to pixel coordinates for the cube scene's corner labels and for
the rasterizer.
"""

from __future__ import annotations

import numpy as np


def hom(x: np.ndarray, value: float = 1.0) -> np.ndarray:
    """Append a homogeneous coordinate."""
    x = np.asarray(x, dtype=np.float64)
    return np.concatenate(
        [x, np.full((*x.shape[:-1], 1), value, dtype=x.dtype)], axis=-1
    )


def dehom(x: np.ndarray) -> np.ndarray:
    """Divide out the homogeneous coordinate."""
    x = np.asarray(x, dtype=np.float64)
    return x[..., :-1] / x[..., -1:]


def look_at_matrix(eye, target, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """World-from-camera rotation whose -Z axis points from ``eye`` to
    ``target``."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    norm = np.linalg.norm(fwd)
    if norm <= 1e-12:
        raise ValueError("eye and target coincide")
    fwd = fwd / norm
    upv = np.asarray(up, np.float64)
    right = np.cross(fwd, upv)
    rnorm = np.linalg.norm(right)
    if rnorm < 1e-9:  # looking straight along up: pick any perpendicular
        upv = np.array([0.0, 1.0, 0.0]) if abs(fwd[2]) > 0.9 else np.array(
            [0.0, 0.0, 1.0]
        )
        right = np.cross(fwd, upv)
        rnorm = np.linalg.norm(right)
    right /= rnorm
    true_up = np.cross(right, fwd)
    return np.stack([right, true_up, -fwd], axis=1)


def cube_vertices(center, half_extent: float) -> np.ndarray:
    """The 8 corners of an axis-aligned cube, x-major order."""
    c = np.asarray(center, np.float64)
    h = float(half_extent)
    corners = np.array(
        [[sx, sy, sz] for sx in (-h, h) for sy in (-h, h) for sz in (-h, h)]
    )
    return c + corners


class Camera:
    """Pinhole camera from a world position, a 3x3 world-from-camera
    rotation, the image ``shape`` (height, width) and Blender-style
    ``focal_mm`` / ``sensor_mm`` intrinsics."""

    def __init__(self, position=(0.0, 0.0, 0.0), rotation=None,
                 shape=(480, 640), focal_mm: float = 50.0,
                 sensor_mm: float = 36.0, clip_near: float = 0.1,
                 clip_far: float = 100.0):
        self.position = np.asarray(position, np.float64)
        self.rotation = (
            np.eye(3) if rotation is None else np.asarray(rotation, np.float64)
        )
        self.shape = (int(shape[0]), int(shape[1]))
        self.focal_mm = float(focal_mm)
        self.sensor_mm = float(sensor_mm)
        self.clip_near = float(clip_near)
        self.clip_far = float(clip_far)
        self._view, self._proj = self._build_matrices()

    @classmethod
    def look_at(cls, eye, target, up=(0, 0, 1), **kwargs) -> "Camera":
        return cls(
            position=eye, rotation=look_at_matrix(eye, target, up), **kwargs
        )

    def _build_matrices(self):
        view = np.eye(4)
        rt = self.rotation.T
        view[:3, :3] = rt
        view[:3, 3] = -rt @ self.position
        h, w = self.shape
        aspect = w / h
        n, f = self.clip_near, self.clip_far
        proj = np.zeros((4, 4))
        proj[0, 0] = 2.0 * self.focal_mm / self.sensor_mm
        proj[1, 1] = 2.0 * self.focal_mm / (self.sensor_mm / aspect)
        proj[2, 2] = -(f + n) / (f - n)
        proj[2, 3] = -2.0 * f * n / (f - n)
        proj[3, 2] = -1.0
        return view, proj

    def world_to_ndc(self, xyz_world):
        """World points -> (NDC, linear depth along the view direction)."""
        xyz_world = np.atleast_2d(np.asarray(xyz_world, np.float64))
        cam = hom(xyz_world) @ self._view.T
        return dehom(cam @ self._proj.T), -cam[:, 2]

    def world_to_pixel(self, xyz_world, return_depth: bool = False):
        """World points -> pixel coordinates (origin upper-left)."""
        ndc, depth = self.world_to_ndc(xyz_world)
        h, w = self.shape
        x = (ndc[:, 0] + 1.0) * 0.5 * w
        y = (1.0 - (ndc[:, 1] + 1.0) * 0.5) * h
        px = np.stack([x, y], axis=1)
        return (px, depth) if return_depth else px
