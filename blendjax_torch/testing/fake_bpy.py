"""A faithful, minimal ``bpy`` stand-in for hermetic producer tests.

The port's own copy of ``blendjax/testing/fake_bpy.py``. It implements
the API surface used by the port's producer runtime
(``blendjax_torch.producer``: ``bpy_engine``, ``offscreen``,
``animation``, ``camera``) and its scene scripts
(``blendjax_torch/examples/*/*.blend.py``). It imports numpy and the
standard library only, never ``torch``, so it loads in Blender's Python.
Semantics are pinned to the **Blender 3.6 LTS** API; the
member-by-member conformance table (documented behavior -> fake
behavior -> known deviation) lives in ``docs/architecture.md``
"Fake-bpy conformance". Highlights:

- objects carry LOCAL mesh data; world placement lives in
  ``matrix_world`` composed from ``location`` + XYZ ``rotation_euler``,
- ``scene.frame_set`` fires ``frame_change_pre``/``frame_change_post``
  app handlers with ``(scene, depsgraph)``,
- ``ops.screen.animation_play`` drives the frame clock and the
  registered ``SpaceView3D`` draw handlers. Real Blender returns to its
  event loop; the stub plays SYNCHRONOUSLY until
  ``animation_cancel`` — the one documented deviation, chosen so the
  UI-mode code path (``BpyAnimationDriver``) is drivable from a plain
  test function,
- ``scene.ray_cast`` intersects world-space AABBs of scene meshes (an
  occluder between object and camera registers; the queried object's
  own box is skipped the way the 1e-4 surface offset does in Blender).

Use :func:`install` to register ``bpy``/``gpu`` into ``sys.modules``
(idempotent), :func:`reset` for a fresh scene between tests.
"""

from __future__ import annotations

import math
import sys
import types

import numpy as np

_MAX_PLAY_TICKS = 1_000_000  # hung-test guard for the synchronous clock


# -- math types -------------------------------------------------------------


class Matrix:
    """4x4 matrix with the slice of mathutils.Matrix blendjax touches:
    ``np.asarray(m)``, row iteration, ``inverted()``."""

    def __init__(self, values):
        self._m = np.asarray(values, dtype=np.float64).reshape(4, 4)

    def __array__(self, dtype=None, copy=None):
        return self._m.astype(dtype) if dtype is not None else self._m

    def __iter__(self):
        return iter(self._m.tolist())

    def __getitem__(self, i):
        return self._m.tolist()[i]

    def inverted(self) -> "Matrix":
        return Matrix(np.linalg.inv(self._m))

    @property
    def translation(self) -> np.ndarray:
        return self._m[:3, 3]

    def to_euler(self, order: str = "XYZ") -> Euler:
        """XYZ euler extraction for M = Rz @ Ry @ Rx (Blender's default
        order; scale assumed uniform-positive for the surface we fake)."""
        assert order == "XYZ", f"unsupported euler order {order!r}"
        r = self._m[:3, :3]
        # strip scale (columns are basis vectors times per-axis scale)
        norms = np.linalg.norm(r, axis=0)
        r = r / np.where(norms > 1e-12, norms, 1.0)
        y = math.asin(np.clip(-r[2, 0], -1.0, 1.0))
        x = math.atan2(r[2, 1], r[2, 2])
        z = math.atan2(r[1, 0], r[0, 0])
        return Euler((x, y, z))

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"Matrix({self._m.tolist()!r})"


class Euler(list):
    """Mutable XYZ euler triple (``obj.rotation_euler[2] = ...``)."""

    def __init__(self, xyz=(0.0, 0.0, 0.0)):
        super().__init__(float(v) for v in xyz)

    def to_matrix3(self) -> np.ndarray:
        x, y, z = self
        cx, sx = math.cos(x), math.sin(x)
        cy, sy = math.cos(y), math.sin(y)
        cz, sz = math.cos(z), math.sin(z)
        rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
        return rz @ ry @ rx  # Blender XYZ order: X applied first


# -- data-block types -------------------------------------------------------


class FakeVertex:
    __slots__ = ("co",)

    def __init__(self, co):
        self.co = np.asarray(co, dtype=np.float64)


class FakeVertices(list):
    def foreach_get(self, attr: str, flat) -> None:
        assert attr == "co", f"unsupported vertex attr {attr!r}"
        out = np.asarray(flat)
        out[:] = np.concatenate([v.co for v in self]) if self else out[:0]

    def foreach_set(self, attr: str, flat) -> None:
        assert attr == "co", f"unsupported vertex attr {attr!r}"
        co = np.asarray(flat, dtype=np.float64).reshape(len(self), 3)
        for v, c in zip(self, co):
            v.co = c.copy()


class FakeMesh:
    def __init__(self, name: str, verts=()):
        self.name = name
        self.vertices = FakeVertices(FakeVertex(v) for v in verts)
        self.polygons: list = []
        self.materials: list = []  # supports .append like bpy's slots

    def from_pydata(self, verts, edges, faces) -> None:
        """Geometry-from-arrays (used by procedural scene scripts, e.g.
        the supershape example)."""
        del edges
        # slice-assign: self.vertices' identity carries foreach_* support
        self.vertices[:] = (FakeVertex(v) for v in verts)
        self.polygons = [tuple(f) for f in faces]

    def update(self) -> None:  # recalc normals etc. — nothing cached here
        pass


class FakeMaterial:
    def __init__(self, name: str):
        self.name = name
        self.diffuse_color = (0.8, 0.8, 0.8, 1.0)


class FakeRigidBody:
    """``obj.rigid_body`` surface (``bpy.types.RigidBodyObject``)."""

    def __init__(self, type: str = "ACTIVE"):
        self.type = type
        self.mass = 1.0
        self.kinematic = False


class FakeRigidBodyConstraint:
    """``obj.rigid_body_constraint`` surface — the slider/motor and
    hinge parameters the cartpole rig drives."""

    def __init__(self, type: str):
        self.type = type
        self.object1 = None
        self.object2 = None
        self.enabled = True
        self.use_motor_lin = False
        self.motor_lin_max_impulse = 0.0
        self.motor_lin_target_velocity = 0.0
        # pinned at creation by the simulator (see _physics_step)
        self._pin = None
        self._hinge_arm = None
        self._prev_v = 0.0
        self._theta = None
        self._omega = 0.0


class FakeCameraData:
    """Mirrors ``bpy.types.Camera`` defaults (lens 50mm, 36mm sensor)."""

    def __init__(self, name: str):
        self.name = name
        self.type = "PERSP"
        self.lens = 50.0
        self.sensor_width = 36.0
        self.clip_start = 0.1
        self.clip_end = 1000.0
        self.ortho_scale = 6.0


class FakeObject:
    def __init__(self, name: str, data=None):
        self.name = name
        self.data = data
        self._location = np.zeros(3)
        self._rotation = Euler()
        self._scale = np.ones(3)
        self.rigid_body = None
        self.rigid_body_constraint = None
        self.active_material = None

    # location / rotation are assignable as tuples, mutable per-component
    @property
    def location(self):
        return self._location

    @location.setter
    def location(self, value):
        self._location = np.asarray(value, dtype=np.float64).copy()

    @property
    def rotation_euler(self):
        return self._rotation

    @rotation_euler.setter
    def rotation_euler(self, value):
        self._rotation = Euler(value)

    @property
    def scale(self):
        return self._scale

    @scale.setter
    def scale(self, value):
        self._scale = np.asarray(value, dtype=np.float64).copy()

    @property
    def matrix_world(self) -> Matrix:
        m = np.eye(4)
        m[:3, :3] = self._rotation.to_matrix3() @ np.diag(self._scale)
        m[:3, 3] = self._location
        return Matrix(m)

    # evaluated-depsgraph protocol: no modifiers/physics in the stub, so
    # the evaluated object IS the object (reference reads geometry through
    # this path, ``utils.py:30-109``)
    def evaluated_get(self, _depsgraph) -> "FakeObject":
        return self

    def to_mesh(self) -> FakeMesh:
        assert isinstance(self.data, FakeMesh), f"{self.name} has no mesh"
        return self.data

    def to_mesh_clear(self) -> None:
        pass

    @property
    def bound_box(self):
        """8 LOCAL-space corners (Blender convention: local, not world)."""
        verts = np.stack([v.co for v in self.to_mesh().vertices])
        lo, hi = verts.min(0), verts.max(0)
        return [
            [x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
            for z in (lo[2], hi[2])
        ]

    # camera-object protocol (offscreen.py:70-75)
    def calc_matrix_camera(self, _depsgraph, x: int = 1, y: int = 1) -> Matrix:
        cam = self.data
        aspect = y / x
        if cam.type == "ORTHO":
            half_w = cam.ortho_scale / 2.0
            half_h = half_w * aspect
            n, f = cam.clip_start, cam.clip_end
            m = np.diag([1.0 / half_w, 1.0 / half_h, -2.0 / (f - n), 1.0])
            m[2, 3] = -(f + n) / (f - n)
            return Matrix(m)
        n, f = cam.clip_start, cam.clip_end
        half_w = n * (cam.sensor_width / 2.0) / cam.lens
        half_h = half_w * aspect
        m = np.zeros((4, 4))
        m[0, 0] = n / half_w
        m[1, 1] = n / half_h
        m[2, 2] = -(f + n) / (f - n)
        m[2, 3] = -2.0 * f * n / (f - n)
        m[3, 2] = -1.0
        return Matrix(m)


class FakeCollection:
    """Name-keyed data-block collection (``bpy.data.objects`` et al.)."""

    def __init__(self, factory=None):
        self._items: list = []
        self._factory = factory

    def new(self, name: str, data=None):
        assert self._factory is not None, "collection is not creatable"
        item = self._factory(name) if data is None else self._factory(
            name, data
        )
        self._items.append(item)
        return item

    def _append(self, item):
        self._items.append(item)

    def __contains__(self, name: str) -> bool:
        return any(i.name == name for i in self._items)

    def __getitem__(self, name: str):
        for i in self._items:
            if i.name == name:
                return i
        raise KeyError(name)

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self):
        return iter(list(self._items))


# -- scene / context --------------------------------------------------------


class FakeRender:
    def __init__(self):
        self.resolution_x = 1920
        self.resolution_y = 1080
        self.resolution_percentage = 100
        self.fps = 24  # Blender default


class FakeSceneObjects:
    """``scene.collection.objects`` — linking makes an object part of the
    scene (drawn, ray-castable)."""

    def __init__(self, scene):
        self._scene = scene

    def link(self, obj: FakeObject) -> None:
        if obj not in self._scene.objects:
            self._scene.objects.append(obj)


class FakeSceneCollection:
    def __init__(self, scene):
        self.objects = FakeSceneObjects(scene)


class FakeScene:
    def __init__(self, bpy_mod):
        self._bpy = bpy_mod
        self.name = "Scene"
        self.frame_start = 1
        self.frame_end = 250
        self.frame_current = 1
        self.render = FakeRender()
        self.camera: FakeObject | None = None
        self.rigidbody_world = None  # set by ops.rigidbody.world_add
        self.objects: list[FakeObject] = []
        self.collection = FakeSceneCollection(self)
        self._phys_frame = 1
        self._vel: dict = {}  # id(obj) -> velocity (free ACTIVE bodies)

    def frame_set(self, frame: int) -> None:
        frame = int(frame)
        # frame_current updates BEFORE the pre handlers fire (handlers
        # read scene.frame_current — the UI driver's dedup relies on it)
        self.frame_current = frame
        dg = self._bpy.context.evaluated_depsgraph_get()
        for h in list(self._bpy.app.handlers.frame_change_pre):
            h(self, dg)
        rb = self.rigidbody_world
        if rb is not None and getattr(rb, "enabled", False):
            # Blender order: pre handlers, then the scene (physics)
            # evaluates for the new frame, then post handlers. Rewinds
            # restart the sim from the cached start state (velocities
            # zeroed; positions are whatever the script set).
            df = frame - self._phys_frame
            if df > 0:
                if df > 10_000:  # loud, not a silent truncation
                    raise RuntimeError(
                        f"fake physics: frame jump of {df} exceeds the "
                        "10k-step guard — seek in smaller increments"
                    )
                dt = 1.0 / self.render.fps
                for _ in range(df):
                    _physics_step(self, dt)
            elif df < 0:
                # Rewind restarts the sim from the cached start state
                # (velocities zeroed); df == 0 is a plain re-evaluation
                # (the common frame_set(frame_current) idiom) and keeps
                # all dynamic state, like real Blender.
                self._vel.clear()
                for obj in self.objects:
                    rc = obj.rigid_body_constraint
                    if rc is not None:
                        rc._prev_v = 0.0
                        rc._omega = 0.0
                        rc._theta = None
        self._phys_frame = frame
        for h in list(self._bpy.app.handlers.frame_change_post):
            h(self, dg)

    def ray_cast(self, _depsgraph, origin, direction,
                 distance: float = 1.70141e38):
        """Slab-method ray vs world AABB of every scene mesh. Boxes the
        origin sits inside are skipped (mirrors the surface-offset idiom
        rays cast FROM an object use, ``bpy_engine.py:204``)."""
        o = np.asarray(origin, dtype=np.float64)
        d = np.asarray(direction, dtype=np.float64)
        best_t, best_obj = None, None
        for obj in self.objects:
            if not isinstance(obj.data, FakeMesh):
                continue
            corners = np.asarray(obj.bound_box, dtype=np.float64)
            mw = np.asarray(obj.matrix_world)
            world = corners @ mw[:3, :3].T + mw[:3, 3]
            lo, hi = world.min(0), world.max(0)
            with np.errstate(divide="ignore", invalid="ignore"):
                t1 = (lo - o) / d
                t2 = (hi - o) / d
            tmin = np.nanmax(np.minimum(t1, t2))
            tmax = np.nanmin(np.maximum(t1, t2))
            if not np.isfinite(tmin) or tmax < tmin:
                continue
            if tmin <= 1e-9:  # origin inside/on the box: skip (see above)
                continue
            if tmin <= distance and (best_t is None or tmin < best_t):
                best_t, best_obj = tmin, obj
        if best_obj is None:
            return (False, None, None, -1, None, None)
        return (
            True, tuple(o + best_t * d), (0.0, 0.0, 1.0), 0, best_obj,
            best_obj.matrix_world,
        )


_GRAVITY = 9.81


def _half_extent_z(obj) -> float:
    if not isinstance(obj.data, FakeMesh) or not obj.data.vertices:
        return 0.0
    zs = np.array([v.co[2] for v in obj.data.vertices])
    return float((zs.max() - zs.min()) / 2.0 * obj._scale[2])


def _physics_step(scene, dt: float) -> None:
    """One fixed step of the miniature rigid-body world.

    Deliberately simple but honest dynamics (documented approximation,
    NOT Bullet): gravity + rest-on-passive-plane for free ACTIVE bodies
    (no body-body collision, no tumbling), a SLIDER constraint pinning
    its object to x-translation with a linear motor, and a HINGE
    modeled as a pendulum about y driven by gravity and the carrier's
    acceleration — the classic cart-pole linkage. Enough for the
    example physics scenes to exhibit their qualitative behavior
    (cubes fall and come to rest; an uninverted pole stays down; an
    inverted pole diverges and the cart responds to motor commands)."""
    objs = scene.objects
    plane_z = None
    for o in objs:
        if o.rigid_body is not None and o.rigid_body.type == "PASSIVE":
            top = o._location[2] + _half_extent_z(o)
            plane_z = top if plane_z is None else max(plane_z, top)

    constrained: set = set()
    sliders = []
    hinges = []
    for o in objs:
        rc = o.rigid_body_constraint
        if rc is None or not rc.enabled:
            continue
        if rc.type == "SLIDER" and rc.object2 is not None:
            sliders.append((o, rc))
            constrained.add(id(rc.object2))
        elif rc.type == "HINGE" and rc.object2 is not None:
            hinges.append((o, rc))
            constrained.add(id(rc.object2))

    # free ACTIVE bodies: gravity + rest on the highest passive plane
    for o in objs:
        rb = o.rigid_body
        if (
            rb is None or rb.type != "ACTIVE" or rb.kinematic
            or id(o) in constrained
        ):
            continue
        v = scene._vel.setdefault(id(o), np.zeros(3))
        v[2] -= _GRAVITY * dt
        o._location += v * dt
        if plane_z is not None:
            rest = plane_z + _half_extent_z(o)
            if o._location[2] < rest:
                o._location[2] = rest
                v[:] = 0.0  # land and rest (no bounce/tumble)

    # sliders: x-translation only, linear motor sets velocity
    for holder, rc in sliders:
        body = rc.object2
        if rc._pin is None:
            rc._pin = (float(body._location[1]), float(body._location[2]))
        v = rc.motor_lin_target_velocity if rc.use_motor_lin else rc._prev_v
        rc._accel = (v - rc._prev_v) / dt
        rc._prev_v = v
        body._location[0] += v * dt
        body._location[1], body._location[2] = rc._pin

    # hinges: pendulum about y at the holder's anchor on the carrier
    for holder, rc in hinges:
        pole, cart = rc.object2, rc.object1
        if rc._hinge_arm is None:
            anchor = holder._location.copy()
            rc._anchor_off = (
                anchor - (cart._location if cart is not None else 0.0)
            )
            arm = pole._location - anchor
            rc._hinge_arm = float(np.linalg.norm(arm)) or 1e-6
            rc._theta = float(pole._rotation[1])
        if rc._theta is None:
            rc._theta = float(pole._rotation[1])
        # carrier acceleration couples in through the pivot (the slider
        # constraint lives on its holder empty, keyed by object2)
        a_cart = 0.0
        if cart is not None:
            for _, src in sliders:
                if src.object2 is cart:
                    a_cart = getattr(src, "_accel", 0.0)
        L = rc._hinge_arm
        th = rc._theta
        rc._omega += (
            (_GRAVITY * math.sin(th) - a_cart * math.cos(th)) / L
        ) * dt
        rc._theta = th + rc._omega * dt
        pole._rotation[1] = rc._theta
        anchor = (
            cart._location + rc._anchor_off
            if cart is not None else rc._anchor_off
        )
        # in place: obj.location references must keep tracking the body
        pole._location[:] = anchor + np.array(
            [L * math.sin(rc._theta), 0.0, L * math.cos(rc._theta)]
        )


class FakeViewLayer:
    def __init__(self):
        self.objects = types.SimpleNamespace(active=None)

    def update(self) -> None:  # matrices recompute lazily; nothing cached
        pass


class FakeDepsgraph:
    pass


# -- UI graph (windows / areas / spaces / draw handlers) --------------------


class FakeShading:
    def __init__(self):
        self.type = "SOLID"


class FakeOverlay:
    def __init__(self):
        self.show_overlays = True


class FakeSpaceView3D:
    type = "VIEW_3D"

    def __init__(self):
        self.shading = FakeShading()
        self.overlay = FakeOverlay()
        self._draw_handlers: dict = {}
        self._next_handle = 0

    def draw_handler_add(self, cb, args, region_type: str, draw_type: str):
        assert region_type == "WINDOW" and draw_type == "POST_PIXEL", (
            "stub supports the POST_PIXEL/WINDOW handlers blendjax uses"
        )
        handle = self._next_handle
        self._next_handle += 1
        self._draw_handlers[handle] = (cb, tuple(args))
        return handle

    def draw_handler_remove(self, handle, region_type: str) -> None:
        assert region_type == "WINDOW"
        self._draw_handlers.pop(handle, None)

    def _invoke_draw(self) -> None:
        for cb, args in list(self._draw_handlers.values()):
            cb(*args)


class FakeArea:
    type = "VIEW_3D"

    def __init__(self):
        self.spaces = [FakeSpaceView3D()]


class FakeScreen:
    def __init__(self, with_view3d: bool):
        self.areas = [FakeArea()] if with_view3d else []
        self.is_animation_playing = False


class FakeWindow:
    def __init__(self, screen):
        self.screen = screen


class FakeWindowManager:
    def __init__(self, screen, with_windows: bool):
        self.windows = [FakeWindow(screen)] if with_windows else []


class FakeRegion:
    def __init__(self):
        self.width = 0
        self.height = 0


class FakeContext:
    def __init__(self, bpy_mod, background: bool):
        self.scene = FakeScene(bpy_mod)
        self.view_layer = FakeViewLayer()
        self.region = None if background else FakeRegion()
        self._depsgraph = FakeDepsgraph()
        # --background has no windows: find_first_view3d must fail there
        # exactly like real Blender (reference ``animation.py:20-22``).
        self.screen = FakeScreen(with_view3d=not background)
        self.window_manager = FakeWindowManager(
            self.screen, with_windows=not background
        )
        self.collection = self.scene.collection

    # context.active_object and view_layer.objects.active are the same
    # thing in Blender; keep one source of truth.
    @property
    def active_object(self):
        return self.view_layer.objects.active

    @active_object.setter
    def active_object(self, obj):
        self.view_layer.objects.active = obj

    def evaluated_depsgraph_get(self) -> FakeDepsgraph:
        return self._depsgraph


# -- operators --------------------------------------------------------------


class _MeshOps:
    def __init__(self, bpy_mod):
        self._bpy = bpy_mod

    def _add(self, base_name, verts, location):
        bpy = self._bpy
        name = base_name
        n = 1
        while name in bpy.data.objects:
            name, n = f"{base_name}.{n:03d}", n + 1
        mesh = FakeMesh(name, verts)
        bpy.data.meshes._append(mesh)
        obj = FakeObject(name, mesh)
        obj.location = location
        bpy.data.objects._append(obj)
        bpy.context.collection.objects.link(obj)
        bpy.context.active_object = obj
        return {"FINISHED"}

    def primitive_cube_add(self, size: float = 2.0,
                           location=(0.0, 0.0, 0.0), **_kw):
        h = size / 2.0
        verts = [
            (x, y, z) for x in (-h, h) for y in (-h, h) for z in (-h, h)
        ]
        return self._add("Cube", verts, location)

    def primitive_plane_add(self, size: float = 2.0,
                            location=(0.0, 0.0, 0.0), **_kw):
        h = size / 2.0
        verts = [(x, y, 0.0) for x in (-h, h) for y in (-h, h)]
        return self._add("Plane", verts, location)


class _RigidbodyOps:
    def __init__(self, bpy_mod):
        self._bpy = bpy_mod

    def world_add(self, **_kw):
        scene = self._bpy.context.scene
        scene.rigidbody_world = types.SimpleNamespace(
            enabled=True,
            point_cache=types.SimpleNamespace(
                frame_start=scene.frame_start, frame_end=scene.frame_end
            ),
        )
        return {"FINISHED"}

    def object_add(self, type: str = "ACTIVE", **_kw):
        obj = self._bpy.context.active_object
        assert obj is not None, "rigidbody.object_add needs an active object"
        obj.rigid_body = FakeRigidBody(type)
        return {"FINISHED"}

    def constraint_add(self, type: str = "FIXED", **_kw):
        obj = self._bpy.context.active_object
        assert obj is not None, (
            "rigidbody.constraint_add needs an active object"
        )
        obj.rigid_body_constraint = FakeRigidBodyConstraint(type)
        return {"FINISHED"}


class _ScreenOps:
    def __init__(self, bpy_mod):
        self._bpy = bpy_mod

    def animation_play(self, **_kw):
        """Synchronous playback clock (see module docstring): advance
        frames start..end, wrapping, firing frame handlers then draw
        handlers, until ``animation_cancel``."""
        bpy = self._bpy
        screen = bpy.context.screen
        scene = bpy.context.scene
        screen.is_animation_playing = True
        frame = scene.frame_start
        ticks = 0
        while screen.is_animation_playing:
            ticks += 1
            if ticks > _MAX_PLAY_TICKS:  # pragma: no cover - test guard
                raise RuntimeError(
                    "fake animation_play exceeded the tick guard — "
                    "nothing called animation_cancel"
                )
            scene.frame_set(frame)
            for window in bpy.context.window_manager.windows:
                for area in window.screen.areas:
                    for space in area.spaces:
                        if space.type == "VIEW_3D":
                            space._invoke_draw()
            frame = (
                frame + 1 if frame < scene.frame_end else scene.frame_start
            )
        return {"FINISHED"}

    def animation_cancel(self, restore_frame: bool = True):
        self._bpy.context.screen.is_animation_playing = False
        if restore_frame:
            scene = self._bpy.context.scene
            scene.frame_current = scene.frame_start
        return {"FINISHED"}


# -- module assembly --------------------------------------------------------


def _default_startup_scene(bpy) -> None:
    """Blender's stock startup scene: Cube at the origin, Camera at its
    default pose, a (mesh-less) Light — what a real ``blender`` launch
    opens when no ``.blend`` is given, and what reference-style scene
    scripts assume (e.g. ``bpy.data.objects["Cube"]``,
    ``examples/datagen/cube.blend.py``)."""
    bpy.ops.mesh.primitive_cube_add(size=2.0, location=(0.0, 0.0, 0.0))
    cam = bpy.data.objects.new("Camera", bpy.data.cameras.new("Camera"))
    bpy.context.collection.objects.link(cam)
    cam.location = (7.3589, -6.9258, 4.9583)  # Blender's default pose
    cam.rotation_euler = (1.1093, 0.0, 0.8149)
    bpy.context.scene.camera = cam
    light = bpy.data.objects.new("Light")
    light.location = (4.0762, 1.0055, 5.9039)
    bpy.context.collection.objects.link(light)
    # like real Blender's startup file, the Cube is the active object
    bpy.context.active_object = bpy.data.objects["Cube"]


def _build_bpy(background: bool, default_scene: bool) -> types.ModuleType:
    bpy = types.ModuleType("bpy")
    bpy.__doc__ = "blendjax fake bpy (see blendjax_torch.testing.fake_bpy)"

    app = types.SimpleNamespace(
        version=(3, 6, 5),
        background=background,
        handlers=types.SimpleNamespace(
            frame_change_pre=[], frame_change_post=[]
        ),
    )
    data = types.SimpleNamespace(
        objects=FakeCollection(FakeObject),
        meshes=FakeCollection(FakeMesh),
        materials=FakeCollection(FakeMaterial),
        images=FakeCollection(),
        cameras=FakeCollection(FakeCameraData),
    )
    bpy.app = app
    bpy.data = data
    bpy.context = FakeContext(bpy, background=background)
    bpy.ops = types.SimpleNamespace(
        mesh=_MeshOps(bpy), screen=_ScreenOps(bpy),
        rigidbody=_RigidbodyOps(bpy),
    )
    bpy.types = types.SimpleNamespace(
        Camera=FakeCameraData, Object=FakeObject, Mesh=FakeMesh,
        SpaceView3D=FakeSpaceView3D,
    )
    bpy._is_fake = True
    bpy._background = background
    bpy._default_scene = default_scene
    if default_scene:
        _default_startup_scene(bpy)
    return bpy


def install(background: bool = False,
            default_scene: bool = False) -> types.ModuleType:
    """Register fake ``bpy``/``gpu`` modules into ``sys.modules``
    (idempotent; refuses to shadow a real Blender runtime).
    ``default_scene=True`` opens Blender's stock startup scene the way a
    real launch without a ``.blend`` does (the fake ``blender`` CLI
    passes it); the in-process default stays an empty graph."""
    existing = sys.modules.get("bpy")
    if existing is not None and not getattr(existing, "_is_fake", False):
        raise RuntimeError(
            "a real bpy module is already loaded; the fake must not "
            "shadow it"
        )
    if existing is None:
        sys.modules["bpy"] = _build_bpy(background, default_scene)
        from blendjax_torch.testing import fake_gpu

        sys.modules["gpu"] = fake_gpu.build(sys.modules["bpy"])
    elif (
        existing._background != background
        or existing._default_scene != default_scene
    ):
        # Mutate the installed module in place (like reset): modules that
        # did ``import bpy`` hold a reference to the OBJECT, so rebinding
        # sys.modules would leave them on a stale scene graph.
        reset(background=background, default_scene=default_scene)
    return sys.modules["bpy"]


def reset(background: bool | None = None,
          default_scene: bool | None = None) -> types.ModuleType:
    """Fresh scene graph (new ``bpy.context``/``bpy.data``), keeping the
    installed module identity so prior ``import bpy`` references update."""
    bpy = sys.modules.get("bpy")
    assert bpy is not None and getattr(bpy, "_is_fake", False), (
        "fake bpy is not installed"
    )
    if background is None:
        background = bpy._background
    if default_scene is None:
        default_scene = bpy._default_scene
    fresh = _build_bpy(background, default_scene)
    for attr in ("app", "data", "context", "ops", "types",
                 "_background", "_default_scene"):
        setattr(bpy, attr, getattr(fresh, attr))
    # ops/context captured the fresh module; point them back at the live one
    for op_ns in vars(bpy.ops).values():
        if hasattr(op_ns, "_bpy"):
            op_ns._bpy = bpy
    bpy.context.scene._bpy = bpy
    return bpy
