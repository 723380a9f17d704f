"""Blender scene script: rotating-cube datagen (real Blender).

The port of the JAX package's ``examples/datagen/cube.blend.py`` on
``blendjax_torch.producer`` (nothing here imports torch, so it runs inside
Blender's Python): randomize the cube in ``pre_frame``, publish image +
projected-corner annotations in ``post_frame``. Runs against the stock
startup scene (the default Cube/Camera/Light): no .blend asset required.

Launch from the consumer side:

    from blendjax_torch.launcher import BlenderLauncher
    BlenderLauncher(script="blendjax_torch/examples/datagen/cube.blend.py",
                    num_instances=2, named_sockets=["DATA"])

Offscreen (Eevee) rendering needs the Blender UI; under ``--background``
this script streams annotations + frame ids only, which still exercises the
full transport and ingest path. The headless counterpart with images
everywhere is ``blendjax_torch/producer/cube.py`` (the sim engine).
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


def main():
    args, _ = parse_launch_args(sys.argv)
    rng = np.random.default_rng(args.btseed)
    cube = bpy.data.objects["Cube"]

    pub = DataPublisher(args.btsockets["DATA"], btid=args.btid)
    ctrl = AnimationController(BpyEngine())

    off = None
    if not bpy.app.background:
        from blendjax_torch.producer.offscreen import OffScreenRenderer

        off = OffScreenRenderer(mode="rgb")
        off.set_render_style(shading="RENDERED", overlays=False)

    def pre_frame(_frame):
        cube.rotation_euler = rng.uniform(0, np.pi, size=3)

    def post_frame(frame):
        cam = camera_from_bpy(Camera)  # re-read pose each frame
        payload = dict(
            xy=cam.world_to_pixel(world_coordinates(cube)).astype(
                np.float32
            ),
            frameid=frame,
        )
        if off is not None:
            payload["image"] = off.render()
        pub.publish(**payload)

    ctrl.pre_frame.add(pre_frame)
    ctrl.post_frame.add(post_frame)
    if bpy.app.background:
        ctrl.play(frame_range=(0, 100), num_episodes=-1)
    else:
        BpyAnimationDriver(ctrl).play(frame_range=(0, 100))


main()
