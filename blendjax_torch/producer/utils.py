"""Geometry and domain-randomization helpers (copied from
``blendjax/producer/utils.py``): homogeneous coordinates, the look-at
rotation, cube corners and spherical sampling, in numpy. The scene queries
that need Blender's evaluated depsgraph live in
:mod:`blendjax_torch.producer.bpy_engine`.
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


def random_spherical_loc(
    radius_range=(6.0, 10.0),
    theta_range=(0.0, np.pi),
    phi_range=(0.0, 2 * np.pi),
    center=(0.0, 0.0, 0.0),
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Uniform random location in a spherical shell around ``center``
    (cos(theta) is drawn uniformly, so the points are uniform on the
    sphere segment)."""
    rng = rng or np.random.default_rng()
    r = rng.uniform(*radius_range)
    ct0, ct1 = np.cos(theta_range[0]), np.cos(theta_range[1])
    theta = np.arccos(rng.uniform(min(ct0, ct1), max(ct0, ct1)))
    phi = rng.uniform(*phi_range)
    return np.asarray(center, dtype=np.float64) + r * np.array(
        [np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)]
    )


def look_at_matrix(eye, target, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """World-from-camera rotation whose -Z axis points from ``eye`` to
    ``target`` (Blender's camera convention: -Z forward, +Y up)."""
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
    # columns: camera X (right), Y (up), Z (backward)
    return np.stack([right, true_up, -fwd], axis=1)


def cube_vertices(center, half_extent: float) -> np.ndarray:
    """The 8 corners of an axis-aligned cube, x-major order."""
    c = np.asarray(center, np.float64)
    h = float(half_extent)
    corners = np.array(
        [[sx, sy, sz] for sx in (-h, h) for sy in (-h, h) for sz in (-h, h)]
    )
    return c + corners
