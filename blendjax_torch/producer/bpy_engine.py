"""Blender integration: engine, camera import and scene queries (copied
from ``blendjax/producer/bpy_engine.py``). Importable only inside
Blender's Python (``import bpy`` must succeed).

:class:`BpyEngine` drives Blender's scene from the blocking
:class:`~blendjax_torch.producer.animation.AnimationController` loop (the
``--background`` strategy); :class:`BpyAnimationDriver` replays the same
signal lifecycle from Blender's own clock under the UI, through
``frame_change_pre`` and a ``SpaceView3D`` POST_PIXEL draw handler (so GPU
reads are legal in ``post_frame``).
"""

from __future__ import annotations

import numpy as np

try:
    import bpy  # noqa: F401
except ImportError as e:  # pragma: no cover - only runs outside Blender
    raise ImportError(
        "blendjax_torch.producer.bpy_engine requires Blender's embedded "
        "Python (bpy). For headless use, see blendjax_torch.producer.sim."
    ) from e

from blendjax_torch.producer.animation import Engine
from blendjax_torch.producer.utils import dehom, hom


class BpyEngine(Engine):
    """Drive Blender's scene from the blocking controller loop (background
    mode; offscreen rendering is unsupported there, reference
    ``animation.py:20-22``)."""

    def __init__(self, scene=None):
        self.scene = scene or bpy.context.scene

    def frame_set(self, frame: int) -> None:
        self.scene.frame_set(frame)

    def reset(self) -> None:
        start = self.scene.frame_start
        # Keep rigid-body point caches in sync with the replayed range
        # (reference ``setup_frame_range``, ``animation.py:108-134``).
        rb = getattr(self.scene, "rigidbody_world", None)
        if rb is not None and rb.point_cache is not None:
            rb.point_cache.frame_start = start
            rb.point_cache.frame_end = self.scene.frame_end
        self.scene.frame_set(start)


class BpyAnimationDriver:
    """Non-blocking playback under the Blender UI: hooks
    ``bpy.app.handlers.frame_change_pre`` for ``pre_frame`` and a
    ``SpaceView3D`` POST_PIXEL draw handler for GPU-safe ``post_frame``
    (reference ``animation.py:136-151``), emitting the same signal
    lifecycle as the blocking controller."""

    def __init__(self, controller, scene=None):
        self.controller = controller
        self.scene = scene or bpy.context.scene
        self._draw_handle = None
        self._pending_post = None

    def play(self, frame_range=(1, 250)) -> None:
        c = self.controller
        self.scene.frame_start, self.scene.frame_end = frame_range
        c.pre_play.invoke()
        c.pre_animation.invoke()
        bpy.app.handlers.frame_change_pre.append(self._on_frame_pre)
        space = find_first_view3d()
        self._draw_handle = space.draw_handler_add(
            self._on_draw, (), "WINDOW", "POST_PIXEL"
        )
        bpy.ops.screen.animation_play()

    def _on_frame_pre(self, scene, _=None):
        # Dedup guard: Blender can fire frame_change multiple times per
        # frame (reference ``skip_post_frame``, ``animation.py:56-65``).
        if self._pending_post == scene.frame_current:
            return
        self.controller.frameid = scene.frame_current
        self.controller.pre_frame.invoke(scene.frame_current)
        self._pending_post = scene.frame_current

    def _on_draw(self):
        if self._pending_post is None:
            return
        frame, self._pending_post = self._pending_post, None
        self.controller.post_frame.invoke(frame)
        if frame >= self.scene.frame_end:
            self.controller.post_animation.invoke()
            self.controller.episode += 1

    def cancel(self) -> None:
        bpy.ops.screen.animation_cancel(restore_frame=False)
        if self._on_frame_pre in bpy.app.handlers.frame_change_pre:
            bpy.app.handlers.frame_change_pre.remove(self._on_frame_pre)
        if self._draw_handle is not None:
            find_first_view3d().draw_handler_remove(self._draw_handle, "WINDOW")
            self._draw_handle = None
        self.controller.post_play.invoke()


# -- camera ----------------------------------------------------------------


def camera_from_bpy(cls, bpy_camera=None, shape=None):
    """Construct a :class:`blendjax_torch.producer.camera.Camera` from a Blender
    camera object (reference ``camera.py:8-82``: matrices from bpy,
    ``shape_from_bpy`` honoring resolution_percentage)."""
    cam_obj = bpy_camera or bpy.context.scene.camera
    cam = cam_obj.data
    render = bpy.context.scene.render
    if shape is None:
        scale = render.resolution_percentage / 100.0
        shape = (
            int(render.resolution_y * scale),
            int(render.resolution_x * scale),
        )
    mw = np.asarray(cam_obj.matrix_world)
    kwargs = dict(
        position=mw[:3, 3],
        rotation=mw[:3, :3],
        shape=shape,
        clip_near=cam.clip_start,
        clip_far=cam.clip_end,
    )
    if cam.type == "ORTHO":
        kwargs["ortho_scale"] = cam.ortho_scale
    else:
        kwargs["focal_mm"] = cam.lens
        kwargs["sensor_mm"] = cam.sensor_width
    return cls(**kwargs)


# -- scene queries (evaluated depsgraph) -----------------------------------


def find_first_view3d():
    """First VIEW_3D space in any open window (reference
    ``utils.py:6-28``); needed for draw handlers and offscreen renders."""
    for window in bpy.context.window_manager.windows:
        for area in window.screen.areas:
            if area.type == "VIEW_3D":
                for space in area.spaces:
                    if space.type == "VIEW_3D":
                        return space
    raise RuntimeError("no VIEW_3D space found (is Blender in --background?)")


def world_coordinates(*objs, depsgraph=None) -> np.ndarray:
    """Evaluated world-space vertex coordinates of objects (reference
    ``utils.py:30-109``: the evaluated depsgraph resolves modifiers and
    physics before reading geometry)."""
    dg = depsgraph or bpy.context.evaluated_depsgraph_get()
    out = []
    for obj in objs:
        ev = obj.evaluated_get(dg)
        mesh = ev.to_mesh()
        n = len(mesh.vertices)
        co = np.empty(n * 3, dtype=np.float64)
        mesh.vertices.foreach_get("co", co)
        mw = np.asarray(ev.matrix_world)
        out.append(dehom(hom(co.reshape(n, 3)) @ mw.T))
        ev.to_mesh_clear()
    return np.concatenate(out) if out else np.empty((0, 3))


def bbox_world_coordinates(obj, depsgraph=None) -> np.ndarray:
    """World-space bounding-box corners of an object (reference
    ``utils.py:84-109``)."""
    dg = depsgraph or bpy.context.evaluated_depsgraph_get()
    ev = obj.evaluated_get(dg)
    mw = np.asarray(ev.matrix_world)
    corners = np.array([list(c) for c in ev.bound_box])
    return dehom(hom(corners) @ mw.T)


def compute_object_visibility(
    obj, camera_obj, n_samples: int = 32, depsgraph=None, rng=None
) -> float:
    """Monte-Carlo visibility: fraction of random surface points whose ray
    to the camera is unobstructed (reference ``utils.py:158-179``)."""
    rng = rng or np.random.default_rng()
    dg = depsgraph or bpy.context.evaluated_depsgraph_get()
    pts = world_coordinates(obj, depsgraph=dg)
    if len(pts) == 0:
        return 0.0
    idx = rng.integers(0, len(pts), size=min(n_samples, len(pts)))
    cam_pos = np.asarray(camera_obj.matrix_world)[:3, 3]
    scene = bpy.context.scene
    visible = 0
    for p in pts[idx]:
        d = cam_pos - p
        dist = np.linalg.norm(d)
        if dist < 1e-9:
            continue
        d = d / dist
        origin = p + d * 1e-4
        hit, *_ = scene.ray_cast(dg, origin.tolist(), d.tolist(), distance=dist - 1e-3)
        if not hit:
            visible += 1
    return visible / len(idx)


def scene_stats() -> dict:
    """Counts of objects/meshes/materials in the scene (reference
    ``utils.py:181-192``)."""
    return {
        "num_objects": len(bpy.data.objects),
        "num_meshes": len(bpy.data.meshes),
        "num_materials": len(bpy.data.materials),
        "num_images": len(bpy.data.images),
    }
