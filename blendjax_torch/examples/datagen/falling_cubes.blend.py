"""Blender scene script: falling rigid-body cubes (real Blender).

The port of the JAX package's ``examples/datagen/falling_cubes.blend.py``
on ``blendjax_torch.producer`` (nothing here imports torch): random drop
poses per episode, publish image + per-cube pixel positions per frame. The
script BUILDS the scene (N rigid-body cubes + a passive ground plane), so
no binary asset ships.

Under ``--background`` annotations stream without images (offscreen
rendering needs the UI).
"""

import sys

import bpy
import numpy as np

from blendjax_torch.producer import AnimationController, DataPublisher, parse_launch_args
from blendjax_torch.producer.bpy_engine import (
    BpyAnimationDriver,
    BpyEngine,
    camera_from_bpy,
    world_coordinates,
)
from blendjax_torch.producer.camera import Camera

NUM_CUBES = 8


def build_scene(rng):
    bpy.ops.rigidbody.world_add()
    bpy.ops.mesh.primitive_plane_add(size=40)
    bpy.ops.rigidbody.object_add(type="PASSIVE")
    cubes = []
    for i in range(NUM_CUBES):
        bpy.ops.mesh.primitive_cube_add(size=1.0)
        c = bpy.context.active_object
        c.name = f"Cube{i:02d}"
        bpy.ops.rigidbody.object_add(type="ACTIVE")
        mat = bpy.data.materials.new(name=f"random{i}")
        mat.diffuse_color = (*rng.random(3), 1.0)
        c.data.materials.append(mat)
        c.active_material = mat
        cubes.append(c)
    return cubes


def main():
    args, _ = parse_launch_args(sys.argv)
    rng = np.random.default_rng(args.btseed)
    cubes = build_scene(rng)

    pub = DataPublisher(args.btsockets["DATA"], btid=args.btid)
    ctrl = AnimationController(BpyEngine())

    off = None
    if not bpy.app.background:
        from blendjax_torch.producer.offscreen import OffScreenRenderer

        off = OffScreenRenderer(mode="rgb")
        off.set_render_style(shading="RENDERED", overlays=False)

    def pre_animation():
        # new drop poses each episode
        xyz = rng.uniform((-3, -3, 6), (3, 3, 12.0), size=(len(cubes), 3))
        rot = rng.uniform(-np.pi, np.pi, size=(len(cubes), 3))
        for c, p, r in zip(cubes, xyz, rot):
            c.location = p
            c.rotation_euler = r

    def post_frame(frame):
        cam = camera_from_bpy(Camera)
        payload = dict(
            xy=cam.world_to_pixel(world_coordinates(*cubes)).astype(
                np.float32
            ),
            frameid=frame,
        )
        if off is not None:
            payload["image"] = off.render()
        pub.publish(**payload)

    ctrl.pre_animation.add(pre_animation)
    ctrl.post_frame.add(post_frame)
    if bpy.app.background:
        ctrl.play(frame_range=(0, 100), num_episodes=-1)
    else:
        BpyAnimationDriver(ctrl).play(frame_range=(0, 100))


main()
