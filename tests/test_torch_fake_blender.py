"""The port's Blender-facing surface on the CPU, without Blender.

- The port's ``BlenderLauncher`` runs port producer scripts (written into
  ``tmp_path``: the handshake, the duplex echo, the animation lifecycle
  over ``BpyEngine``, a remote env over ``BpyEngine`` and a bpy camera)
  through the port's fake Blender CLI
  (``blendjax_torch.testing.write_fake_blender``), with the port's
  consumers.
- ``bpy_engine`` and ``offscreen`` run in-process under the port's
  ``fake_bpy`` and give what the JAX package's modules give on the same
  fake scene.

Every receive has its own timeout.
"""

import math
import os
import sys

import numpy as np
import pytest

if sys.platform == "win32":  # pragma: no cover
    pytest.skip("the fake blender wrapper is a POSIX shell script",
                allow_module_level=True)

from blendjax_torch.testing import install_fake_bpy, reset_fake_bpy
from blendjax_torch.testing import write_fake_blender
from blendjax_torch.data.stream import RemoteStream
from blendjax_torch.launcher import BlenderLauncher, discover_blender

TIMEOUT = 60_000

SCRIPTS = {
    "launcher.blend.py": """\
import sys
from blendjax_torch.producer import DataPublisher, parse_launch_args
from blendjax_torch.transport import term_context

args, remainder = parse_launch_args(sys.argv)
pub = DataPublisher(args.btsockets["DATA"], btid=args.btid, lingerms=10000)
pub.publish(btseed=args.btseed, btsockets=list(args.btsockets),
            remainder=list(remainder))
pub.close()
term_context()
""",
    "duplex.blend.py": """\
import sys
from blendjax_torch.producer import DuplexChannel, parse_launch_args
from blendjax_torch.transport import term_context

args, _ = parse_launch_args(sys.argv)
duplex = DuplexChannel(args.btsockets["CTRL"], btid=args.btid, lingerms=5000)
msg = duplex.recv(timeoutms=60000)
duplex.send(echo=msg)
duplex.send(msg="end")
duplex.close()
term_context()
""",
    "anim.blend.py": """\
import sys
from blendjax_torch.producer import (
    AnimationController, DataPublisher, parse_launch_args)
from blendjax_torch.producer.bpy_engine import BpyEngine
from blendjax_torch.transport import term_context

args, _ = parse_launch_args(sys.argv)
pub = DataPublisher(args.btsockets["DATA"], btid=args.btid, lingerms=5000)
ctrl = AnimationController(BpyEngine())
seq = []
ctrl.pre_play.add(lambda: seq.append("pre_play"))
ctrl.pre_animation.add(lambda: seq.append("pre_animation"))
ctrl.pre_frame.add(lambda f: seq.append(f"pre_frame:{f}"))
ctrl.post_frame.add(lambda f: seq.append(f"post_frame:{f}"))
ctrl.post_animation.add(lambda: seq.append("post_animation"))


def post_play():
    seq.append("post_play")
    pub.publish(seq=seq)


ctrl.post_play.add(post_play)
ctrl.play(frame_range=(1, 3), num_episodes=2)
pub.close()
term_context()
""",
    "env.blend.py": """\
import sys
import bpy
from blendjax_torch.producer import (
    BaseEnv, RemoteControlledAgent, parse_launch_args)
from blendjax_torch.producer.bpy_engine import BpyEngine


class RotateEnv(BaseEnv):
    def __init__(self, agent, done_after):
        super().__init__(agent)
        if "Cube" not in bpy.data.objects:
            bpy.ops.mesh.primitive_cube_add()
            bpy.context.active_object.name = "Cube"
        self.cube = bpy.data.objects["Cube"]
        self.done_after = done_after

    def _env_reset(self):
        self.cube.rotation_euler[2] = 0.0

    def _env_prepare_step(self, action):
        self.cube.rotation_euler[2] = float(action)

    def _env_post_step(self):
        angle = float(self.cube.rotation_euler[2])
        return dict(obs=angle, reward=1.0 if abs(angle) > 0.5 else 0.0,
                    done=self.events.frameid > self.done_after)


args, remainder = parse_launch_args(sys.argv)
agent = RemoteControlledAgent(args.btsockets["GYM"])
env = RotateEnv(agent, done_after=int(remainder[remainder.index("--done-after") + 1]))
try:
    env.run(BpyEngine(), frame_range=(1, 10000))
finally:
    agent.close()
""",
    "cam.blend.py": """\
import math, sys
import bpy
from blendjax_torch.producer import DataPublisher, parse_launch_args
from blendjax_torch.producer.bpy_engine import world_coordinates
from blendjax_torch.producer.camera import Camera
from blendjax_torch.transport import term_context

args, _ = parse_launch_args(sys.argv)
bpy.ops.mesh.primitive_cube_add(size=2.0, location=(0.5, -0.25, 0.75))
cube = bpy.context.active_object


def add_cam(name, kind, **props):
    data = bpy.data.cameras.new(name)
    data.type = kind
    for k, v in props.items():
        setattr(data, k, v)
    cam = bpy.data.objects.new(name, data)
    bpy.context.collection.objects.link(cam)
    return cam


proj = add_cam("CamProj", "PERSP", lens=50.0, sensor_width=36.0,
               clip_start=0.1, clip_end=100.0)
proj.location = (8.0, -8.0, 6.0)
proj.rotation_euler = (math.radians(60.0), 0.0, math.radians(45.0))
ortho = add_cam("CamOrtho", "ORTHO", ortho_scale=12.0, clip_start=0.1,
                clip_end=100.0)
ortho.location = (0.0, 0.0, 10.0)
render = bpy.context.scene.render
render.resolution_x, render.resolution_y = 640, 480
render.resolution_percentage = 100
bpy.context.view_layer.update()
xyz = world_coordinates(cube)
pix_p, z_p = Camera.from_bpy(proj).world_to_pixel(xyz, return_depth=True)
pix_o, z_o = Camera.from_bpy(ortho).world_to_pixel(xyz, return_depth=True)
pub = DataPublisher(args.btsockets["DATA"], btid=args.btid, lingerms=5000)
pub.publish(xyz=xyz, proj_xy=pix_p, proj_z=z_p, ortho_xy=pix_o, ortho_z=z_o,
            proj_pose=[list(r) for r in proj.matrix_world],
            ortho_pose=[list(r) for r in ortho.matrix_world])
pub.close()
term_context()
""",
}


@pytest.fixture(scope="module")
def fake_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("fake-blender-bin"))
    write_fake_blender(d)
    return d


@pytest.fixture(scope="module")
def scripts(tmp_path_factory):
    d = tmp_path_factory.mktemp("port-scripts")
    for name, src in SCRIPTS.items():
        (d / name).write_text(src)
    return {name: str(d / name) for name in SCRIPTS}


def _launcher(fake_dir, script, **kwargs):
    return BlenderLauncher(script=script, background=True,
                           blend_path=[fake_dir], **kwargs)


def test_the_finder_discovers_the_fake_blender(fake_dir):
    info = discover_blender(additional_blender_paths=[fake_dir])
    assert info == {"path": os.path.join(fake_dir, "blender"), "major": 3,
                    "minor": 6, "codec": "tensor"}


def test_blender_launcher_handshake(fake_dir, scripts):
    with _launcher(fake_dir, scripts["launcher.blend.py"], num_instances=2,
                   named_sockets=["DATA"], seed=10,
                   instance_args=[["--x", "a"], ["--x", "b"]]) as ln:
        got = {m["btid"]: m for m in RemoteStream(
            ln.addresses["DATA"], timeoutms=TIMEOUT, max_items=2)}
    assert [got[i]["btseed"] for i in (0, 1)] == [10, 11]
    assert got[0]["remainder"] == ["--x", "a"]
    assert got[1]["remainder"] == ["--x", "b"]
    assert got[0]["btsockets"] == ["DATA"]


def test_blender_duplex_echo(fake_dir, scripts):
    from blendjax_torch.transport import PairChannel

    with _launcher(fake_dir, scripts["duplex.blend.py"], num_instances=1,
                   named_sockets=["CTRL"]) as ln:
        duplex = PairChannel(ln.addresses["CTRL"][0], btid=99)
        try:
            mid = duplex.send(hello=[1, 2, 3])
            echo = duplex.recv(timeoutms=TIMEOUT)
            end = duplex.recv(timeoutms=TIMEOUT)
        finally:
            duplex.close()
    assert echo["echo"] == {"btid": 99, "btmid": mid, "hello": [1, 2, 3]}
    assert echo["btid"] == 0 and end["msg"] == "end"


def test_blender_animation_lifecycle(fake_dir, scripts):
    with _launcher(fake_dir, scripts["anim.blend.py"], num_instances=1,
                   named_sockets=["DATA"]) as ln:
        (msg,) = list(RemoteStream(ln.addresses["DATA"], timeoutms=TIMEOUT,
                                   max_items=1))
    episode = (["pre_animation"] + [
        s for f in (1, 2, 3) for s in (f"pre_frame:{f}", f"post_frame:{f}")
    ] + ["post_animation"])
    assert msg["seq"] == ["pre_play"] + episode * 2 + ["post_play"]


def test_blender_remote_env(fake_dir, scripts):
    from blendjax_torch.env import RemoteEnv

    with _launcher(fake_dir, scripts["env.blend.py"], num_instances=1,
                   named_sockets=["GYM"],
                   instance_args=[["--done-after", "5"]]) as ln:
        env = RemoteEnv(ln.addresses["GYM"][0], timeoutms=TIMEOUT)
        try:
            for _ in range(2):
                obs, info = env.reset()
                assert obs == pytest.approx(0.0)
                done, steps = False, 0
                while not done:
                    obs, reward, done, info = env.step(0.6)
                    assert obs == pytest.approx(0.6)
                    assert reward == pytest.approx(1.0)
                    steps += 1
                    assert steps < 50
        finally:
            env.close()


def test_blender_camera_projection(fake_dir, scripts):
    from blendjax_torch.producer.camera import Camera

    with _launcher(fake_dir, scripts["cam.blend.py"], num_instances=1,
                   named_sockets=["DATA"]) as ln:
        (msg,) = list(RemoteStream(ln.addresses["DATA"], timeoutms=TIMEOUT,
                                   max_items=1))
    xyz = msg["xyz"]
    assert xyz.shape == (8, 3)
    for kind, extra in (("proj", dict(focal_mm=50.0, sensor_mm=36.0)),
                        ("ortho", dict(ortho_scale=12.0))):
        pose = np.asarray(msg[f"{kind}_pose"])
        cam = Camera(position=pose[:3, 3], rotation=pose[:3, :3],
                     shape=(480, 640), clip_near=0.1, clip_far=100.0, **extra)
        pix, z = cam.world_to_pixel(xyz, return_depth=True)
        np.testing.assert_allclose(pix, msg[f"{kind}_xy"], rtol=0, atol=1e-9)
        np.testing.assert_allclose(z, msg[f"{kind}_z"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(msg["ortho_z"], 10.0 - xyz[:, 2], atol=1e-9)


# -- bpy_engine and offscreen in-process, against the JAX package's -----------


@pytest.fixture()
def bpy():
    mod = install_fake_bpy(background=False)
    reset_fake_bpy()
    return mod


def _add_cube(bpy, size=2.0, location=(0, 0, 0), name=None):
    bpy.ops.mesh.primitive_cube_add(size=size, location=location)
    obj = bpy.context.active_object
    if name:
        obj.name = name
    return obj


def _add_camera(bpy, name="Cam", location=(0, 0, 10), rotation=(0, 0, 0),
                **props):
    data = bpy.data.cameras.new(name)
    for k, v in props.items():
        setattr(data, k, v)
    obj = bpy.data.objects.new(name, data)
    bpy.context.collection.objects.link(obj)
    obj.location = location
    obj.rotation_euler = rotation
    return obj


def test_scene_queries_match_the_reference(bpy):
    from blendjax.producer import bpy_engine as JB
    from blendjax_torch.producer import bpy_engine as TB

    cube = _add_cube(bpy, size=2.0, location=(0.5, -0.25, 0.75), name="T")
    cube.rotation_euler[2] = math.pi / 5
    cam = _add_camera(bpy, location=(0, 0, 10))
    np.testing.assert_array_equal(TB.world_coordinates(cube),
                                  JB.world_coordinates(cube))
    np.testing.assert_array_equal(TB.bbox_world_coordinates(cube),
                                  JB.bbox_world_coordinates(cube))
    assert TB.scene_stats() == JB.scene_stats()
    for blocked in (False, True):
        if blocked:
            _add_cube(bpy, size=1.0, location=(0.5, -0.25, 5), name="B")
        vis = [mod.compute_object_visibility(
            cube, cam, n_samples=16, rng=np.random.default_rng(0))
            for mod in (TB, JB)]
        assert vis[0] == vis[1]
        assert (vis[0] < 1.0) if blocked else (vis[0] == 1.0)


@pytest.mark.parametrize("kind", ["PERSP", "ORTHO"])
@pytest.mark.parametrize("percentage", [100, 50])
def test_camera_from_bpy_matches_the_reference(bpy, kind, percentage):
    from blendjax.producer.camera import Camera as JCamera
    from blendjax_torch.producer.camera import Camera

    render = bpy.context.scene.render
    render.resolution_x, render.resolution_y = 640, 480
    render.resolution_percentage = percentage
    cam_obj = _add_camera(
        bpy, location=(8.0, -8.0, 6.0),
        rotation=(math.radians(60), 0.0, math.radians(45)), type=kind,
        lens=35.0, sensor_width=32.0, ortho_scale=9.0, clip_start=0.2,
        clip_end=60.0,
    )
    bpy.context.scene.camera = cam_obj
    port, ref = Camera.from_bpy(), JCamera.from_bpy()
    assert port.shape == ref.shape == (480 * percentage // 100,
                                       640 * percentage // 100)
    assert (port.ortho_scale is None) == (kind == "PERSP")
    np.testing.assert_array_equal(port.view_matrix, ref.view_matrix)
    np.testing.assert_array_equal(port.proj_matrix, ref.proj_matrix)
    pts = np.random.default_rng(0).uniform(-2, 2, (16, 3))
    np.testing.assert_array_equal(port.world_to_pixel(pts),
                                  ref.world_to_pixel(pts))


def test_bpy_engine_reset_syncs_point_cache(bpy):
    from types import SimpleNamespace

    from blendjax_torch.producer.bpy_engine import BpyEngine

    scene = bpy.context.scene
    scene.frame_start, scene.frame_end = 3, 9
    scene.rigidbody_world = SimpleNamespace(
        point_cache=SimpleNamespace(frame_start=1, frame_end=250))
    eng = BpyEngine()
    eng.frame_set(7)
    assert scene.frame_current == 7
    eng.reset()
    assert scene.frame_current == 3
    assert (scene.rigidbody_world.point_cache.frame_start,
            scene.rigidbody_world.point_cache.frame_end) == (3, 9)


def _ui_lifecycle(producer, bpy):
    ctrl = producer.animation.AnimationController(producer.bpy_engine.BpyEngine())
    driver = producer.bpy_engine.BpyAnimationDriver(ctrl)
    seq = []
    ctrl.pre_play.add(lambda: seq.append("pre_play"))
    ctrl.pre_animation.add(lambda: seq.append("pre_animation"))
    ctrl.pre_frame.add(lambda f: seq.append(f"pre:{f}"))
    ctrl.post_frame.add(lambda f: seq.append(f"post:{f}"))

    def on_episode_end():
        seq.append("post_animation")
        if ctrl.episode >= 1:
            driver.cancel()

    ctrl.post_animation.add(on_episode_end)
    ctrl.post_play.add(lambda: seq.append("post_play"))
    driver.play(frame_range=(1, 3))  # synchronous under the fake clock
    assert not bpy.app.handlers.frame_change_pre
    return seq, ctrl.episode


def test_the_ui_animation_driver_matches_the_reference(bpy):
    import blendjax.producer.animation  # noqa: F401
    import blendjax.producer.bpy_engine  # noqa: F401
    import blendjax_torch.producer.animation  # noqa: F401
    import blendjax_torch.producer.bpy_engine  # noqa: F401
    from blendjax import producer as J
    from blendjax_torch import producer as T

    port = _ui_lifecycle(T, bpy)
    reset_fake_bpy()
    ref = _ui_lifecycle(J, bpy)
    assert port == ref and port[1] == 2


def test_find_first_view3d_background_raises():
    from blendjax_torch.producer.bpy_engine import find_first_view3d

    install_fake_bpy(background=False)
    reset_fake_bpy(background=True)
    with pytest.raises(RuntimeError, match="VIEW_3D"):
        find_first_view3d()
    reset_fake_bpy(background=False)
    assert find_first_view3d().type == "VIEW_3D"


@pytest.mark.parametrize("mode,origin", [("rgba", "upper-left"),
                                         ("rgb", "lower-left")])
def test_offscreen_renders_as_the_reference(bpy, mode, origin):
    from blendjax.producer.offscreen import OffScreenRenderer as JOff
    from blendjax_torch.producer.offscreen import OffScreenRenderer

    render = bpy.context.scene.render
    render.resolution_x, render.resolution_y = 160, 120
    _add_cube(bpy, size=2.0, location=(0, 0, 0))
    cam_obj = _add_camera(bpy, location=(0, -8, 0),
                          rotation=(math.pi / 2, 0, 0), lens=35.0,
                          clip_start=0.1, clip_end=100.0)
    bpy.context.scene.camera = cam_obj
    port = OffScreenRenderer(mode=mode, origin=origin).render()
    ref = JOff(mode=mode, origin=origin).render()
    assert port.shape == ref.shape == (120, 160, 4 if mode == "rgba" else 3)
    np.testing.assert_array_equal(port, ref)
    from blendjax_torch.testing.fake_gpu import BACKGROUND

    assert (port != np.array(BACKGROUND[:port.shape[-1]])).any()


def test_a_sim_env_without_blender_has_no_default_renderer(monkeypatch):
    """Outside Blender the offscreen import fails, so ``BaseEnv`` has no
    default renderer and asks for one."""
    monkeypatch.setitem(sys.modules, "bpy", None)  # import bpy fails
    monkeypatch.delitem(sys.modules, "blendjax_torch.producer.offscreen",
                        raising=False)
    from blendjax_torch.producer import BaseEnv

    env = BaseEnv(agent=None)
    assert env._default_renderer() is None
    with pytest.raises(ValueError, match="no renderer"):
        env.attach_default_renderer()
    env.attach_default_renderer(every_nth=0, renderer=lambda: None)
    assert env.render_every == 1
