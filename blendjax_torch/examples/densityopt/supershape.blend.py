"""Blender scene script: duplex-driven supershape mesh regeneration.

The port of the JAX package's ``examples/densityopt/supershape.blend.py``
on ``blendjax_torch.producer`` (nothing here imports torch): the consumer
pushes batches of supershape parameters over the CTRL duplex channel; each
frame the producer regenerates the mesh from the next parameter sample and
publishes a render tagged with the ``shape_id`` that produced it, the id
round-trip that lets the optimizer re-associate images with parameter
samples. The (public, Gielis 2003) superformula is implemented inline, so
nothing extra installs into Blender's Python.
"""

import sys

import bpy
import numpy as np

from blendjax_torch.producer import (
    AnimationController,
    DataPublisher,
    DuplexChannel,
    parse_launch_args,
)
from blendjax_torch.producer.bpy_engine import BpyAnimationDriver, BpyEngine

UV = (50, 50)


def supercoords(params, shape=UV):
    """Superformula surface coordinates (m, a, b, n1, n2, n3) x2."""

    def sf(m, a, b, n1, n2, n3, theta):
        t = np.abs(np.cos(m * theta / 4) / a) ** n2
        t = t + np.abs(np.sin(m * theta / 4) / b) ** n3
        return t ** (-1.0 / n1)

    p = np.asarray(params, np.float64).reshape(2, 6)
    nu, nv = shape
    theta = np.linspace(-np.pi, np.pi, nu)
    phi = np.linspace(-np.pi / 2, np.pi / 2, nv)
    r1 = sf(*p[0], theta)[:, None]
    r2 = sf(*p[1], phi)[None, :]
    x = r1 * np.cos(theta)[:, None] * r2 * np.cos(phi)[None, :]
    y = r1 * np.sin(theta)[:, None] * r2 * np.cos(phi)[None, :]
    # z varies only with phi; broadcast to the full grid so the three
    # coordinate arrays stack
    z = np.broadcast_to(r2 * np.sin(phi)[None, :], x.shape)
    return x, y, z


def make_mesh(shape=UV):
    nu, nv = shape
    mesh = bpy.data.meshes.new("supershape")
    verts = [(0.0, 0.0, 0.0)] * (nu * nv)
    faces = [
        (i * nv + j, i * nv + j + 1, (i + 1) * nv + j + 1, (i + 1) * nv + j)
        for i in range(nu - 1)
        for j in range(nv - 1)
    ]
    mesh.from_pydata(verts, [], faces)
    obj = bpy.data.objects.new("supershape", mesh)
    bpy.context.collection.objects.link(obj)
    return obj


def update_mesh(obj, x, y, z):
    co = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    obj.data.vertices.foreach_set("co", co.reshape(-1))
    obj.data.update()


def main():
    args, _ = parse_launch_args(sys.argv)
    obj = make_mesh()
    pub = DataPublisher(args.btsockets["DATA"], btid=args.btid)
    duplex = DuplexChannel(args.btsockets["CTRL"], btid=args.btid)
    ctrl = AnimationController(BpyEngine())

    pending = []  # (params, shape_id) queue fed by the duplex channel
    current = {"shape_id": None}

    off = None
    if not bpy.app.background:
        from blendjax_torch.producer.offscreen import OffScreenRenderer

        off = OffScreenRenderer(mode="rgb")
        off.set_render_style(shading="SOLID", overlays=False)

    def pre_frame(_frame):
        msg = duplex.recv(timeoutms=0)  # non-blocking poll each frame
        if msg is not None:
            pending.extend(
                zip(list(msg["shape_params"]), list(msg["shape_ids"]))
            )
        if pending:
            params, sid = pending.pop(0)
            update_mesh(obj, *supercoords(params))
            current["shape_id"] = sid
        else:
            current["shape_id"] = None

    def post_frame(_frame):
        if current["shape_id"] is None:
            return  # nothing new to report this frame
        payload = dict(shape_id=current["shape_id"])
        if off is not None:
            payload["image"] = off.render()
        pub.publish(**payload)

    ctrl.pre_frame.add(pre_frame)
    ctrl.post_frame.add(post_frame)
    if bpy.app.background:
        ctrl.play(frame_range=(0, 10000), num_episodes=-1)
    else:
        BpyAnimationDriver(ctrl).play(frame_range=(0, 10000))


main()
