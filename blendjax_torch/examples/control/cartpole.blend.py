"""Blender scene script: physics cartpole served over the GYM RPC.

The port of the JAX package's ``examples/control/cartpole.blend.py`` on
``blendjax_torch.producer`` (nothing here imports torch): a cart driven by
a rigid-body motor constraint with a hinged pole on top; actions are motor
forces, observations are (cart x, pole x, pole angle), done when the pole
tips or the cart runs off. The script BUILDS the rig programmatically
(ground, cart on a slider+motor constraint, pole on a hinge), so no binary
asset ships.

Launch via ``blendjax_torch.env.launch_env`` or the Gymnasium adapter
(``blendjax_torch.env.gymnasium_adapter``); pair with
``blendjax_torch/examples/control/cartpole.py``.
"""

import sys

import bpy
import numpy as np

from blendjax_torch.producer import BaseEnv, RemoteControlledAgent, parse_launch_args
from blendjax_torch.producer.bpy_engine import BpyEngine


def _rigid(obj, kind="ACTIVE", mass=1.0):
    bpy.context.view_layer.objects.active = obj
    bpy.ops.rigidbody.object_add(type=kind)
    if kind == "ACTIVE":
        obj.rigid_body.mass = mass
    return obj


def _empty(name, location):
    e = bpy.data.objects.new(name, None)
    e.location = location
    bpy.context.collection.objects.link(e)
    return e


def build_rig():
    """Ground + cart (slider/motor constraint) + pole (hinge)."""
    bpy.ops.rigidbody.world_add()
    bpy.context.scene.rigidbody_world.enabled = True

    bpy.ops.mesh.primitive_plane_add(size=40)
    _rigid(bpy.context.active_object, "PASSIVE")

    bpy.ops.mesh.primitive_cube_add(size=1.0, location=(0, 0, 1.2))
    cart = bpy.context.active_object
    cart.name = "Cart"
    cart.scale = (0.8, 0.5, 0.2)
    _rigid(cart, mass=1.0)

    bpy.ops.mesh.primitive_cube_add(size=1.0, location=(0, 0, 2.2))
    pole = bpy.context.active_object
    pole.name = "Pole"
    pole.scale = (0.05, 0.05, 0.8)
    _rigid(pole, mass=0.1)

    # Slider+motor: constrains the cart to the x axis and drives it.
    motor = _empty("Motor", (0, 0, 1.2))
    bpy.context.view_layer.objects.active = motor
    bpy.ops.rigidbody.constraint_add(type="SLIDER")
    rc = motor.rigid_body_constraint
    rc.object1 = None  # world
    rc.object2 = cart
    rc.use_motor_lin = True
    rc.motor_lin_max_impulse = 50.0

    # Hinge: pole pivots about y at the cart's top.
    hinge = _empty("Hinge", (0, 0, 1.4))
    bpy.context.view_layer.objects.active = hinge
    bpy.ops.rigidbody.constraint_add(type="HINGE")
    hc = hinge.rigid_body_constraint
    hc.object1 = cart
    hc.object2 = pole
    return cart, pole, motor


class CartpoleEnv(BaseEnv):
    def __init__(self, agent):
        super().__init__(agent)
        self.cart, self.pole, motor = build_rig()
        self.motor = motor.rigid_body_constraint
        self.fps = bpy.context.scene.render.fps
        self.total_mass = (
            self.cart.rigid_body.mass + self.pole.rigid_body.mass
        )
        self.rng = np.random.default_rng()

    def _env_reset(self):
        self.motor.motor_lin_target_velocity = 0.0
        self.cart.location = (0.0, 0, 1.2)
        self.pole.rotation_euler[1] = self.rng.uniform(-0.6, 0.6)

    def _env_prepare_step(self, action):
        # v_(t+1) = v(t) + (f/m)*dt (constant acceleration between steps)
        self.motor.motor_lin_target_velocity += (
            float(action) / self.total_mass / self.fps
        )

    def _env_post_step(self):
        c = float(self.cart.matrix_world.translation[0])
        p = float(self.pole.matrix_world.translation[0])
        a = float(self.pole.matrix_world.to_euler("XYZ")[1])
        return dict(
            obs=(c, p, a),
            reward=0.0,
            done=bool(abs(a) > 0.6 or abs(c) > 4.0),
        )


def main():
    args, remainder = parse_launch_args(sys.argv)
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--render-every", default=None, type=int)
    ap.add_argument("--real-time", dest="realtime", action="store_true")
    ap.add_argument("--no-real-time", dest="realtime", action="store_false")
    ap.set_defaults(realtime=False)
    opts = ap.parse_args(remainder)

    agent = RemoteControlledAgent(
        args.btsockets["GYM"], real_time=opts.realtime
    )
    env = CartpoleEnv(agent)
    if not bpy.app.background and opts.render_every:
        env.attach_default_renderer(every_nth=opts.render_every)
    try:
        env.run(BpyEngine(), frame_range=(1, 10000))
    finally:
        agent.close()


main()
