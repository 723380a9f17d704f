"""The port's test tooling (``blendjax_torch.testing``) against the JAX
package's (``blendjax.testing``), on the CPU.

- The Blender doubles: the two ``fake_gpu`` draws of one scene through
  the same matrices read back the same bytes; both ``blender`` wrappers
  answer ``--version`` and ``discover_blender``; the doubles import with
  ``torch`` blocked.
- The equivalence scaffold: ``moe_per_token_reference`` against the JAX
  package's on the same numpy parameters (``TOL_LOSS``), and
  ``assert_sharded_matches_single_device`` over gloo at world size 2 for
  the ``data`` and ``data×fsdp`` layouts (``tests/torch_dist_ranks.py``).
- The donation audit: stable through in-place echo inserts and steps,
  unstable when a leaf is rebound, ``report()`` with the JAX package's
  keys, and the ``train.donation_reuse`` gauge.
"""

import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_dist_ranks as W
from blendjax_torch.testing import install_fake_bpy, reset_fake_bpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


# -- the Blender doubles -----------------------------------------------------------


def _scene():
    bpy = install_fake_bpy(background=False)
    reset_fake_bpy()
    for size, loc in ((2.0, (0.0, 0.0, 0.0)), (1.0, (1.5, -0.5, 1.0))):
        bpy.ops.mesh.primitive_cube_add(size=size, location=loc)
    return bpy


@pytest.mark.parametrize("shape", [(120, 160), (97, 131)])
def test_the_fake_gpu_draws_match_the_jax_packages(shape):
    """One fake scene, the same view and projection matrices: the port's
    ``GPUOffScreen`` and the JAX package's read back the same bytes, and
    the draw is not empty."""
    from blendjax.testing import fake_gpu as jax_gpu
    from blendjax_torch.producer.camera import Camera
    from blendjax_torch.testing import fake_gpu

    bpy = _scene()
    h, w = shape
    cam = Camera(position=np.array([0.0, -8.0, 2.0]),
                 rotation=np.array([[1.0, 0, 0], [0, 0, -1.0], [0, 1.0, 0]]),
                 shape=(h, w), clip_near=0.1, clip_far=100.0)
    reads = []
    for mod in (fake_gpu, jax_gpu):
        off = mod.GPUOffScreen(w, h)
        with off.bind():
            off.draw_view3d(bpy.context.scene, None, None, None,
                            cam.view_matrix, cam.proj_matrix)
            buf = off.texture_color.read()
            buf.dimensions = w * h * 4
            reads.append(np.asarray(buf, np.uint8).tobytes())
    assert reads[0] == reads[1]
    img = np.frombuffer(reads[0], np.uint8).reshape(h, w, 4)
    assert (img != np.array(fake_gpu.BACKGROUND, np.uint8)).any()


@pytest.mark.parametrize("package", ["blendjax_torch", "blendjax"])
def test_both_wrappers_answer_version_and_discovery(package, tmp_path):
    """The port's ``write_fake_blender`` and the JAX package's: ``--version``
    names Blender 3.6.5, and the port's ``discover_blender`` finds each
    (its zmq/msgpack smoke test runs under the wrapper). The port's
    wrapper runs ``python -m blendjax_torch.testing.fake_blender``."""
    import importlib

    from blendjax_torch.launcher import discover_blender

    write = importlib.import_module(f"{package}.testing").write_fake_blender
    path = write(str(tmp_path))
    out = subprocess.run([path, "--version"], capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0 and "Blender 3.6.5" in out.stdout
    info = discover_blender([str(tmp_path)])
    assert info is not None and (info["major"], info["minor"]) == (3, 6)
    assert info["path"] == path
    if package == "blendjax_torch":
        with open(path) as f:
            assert "-m blendjax_torch.testing.fake_blender" in f.read()


def test_the_doubles_import_with_torch_blocked():
    """In a fresh interpreter where ``import torch`` fails (Blender's
    Python), the port's doubles load, install a fake ``bpy``/``gpu``, run
    the CLI emulator and render through the port's offscreen renderer;
    neither torch nor the JAX package is loaded."""
    code = (
        "import sys\n"
        "sys.modules['torch'] = None\n"
        "from blendjax_torch.testing import install_fake_bpy\n"
        "from blendjax_torch.testing import write_fake_blender  # noqa\n"
        "from blendjax_torch.testing import fake_blender, fake_gpu\n"
        "bpy = install_fake_bpy(background=False, default_scene=True)\n"
        "assert fake_blender.main(['--version']) == 0\n"
        "from blendjax_torch.producer.offscreen import OffScreenRenderer\n"
        "bpy.context.scene.render.resolution_percentage = 10\n"
        "img = OffScreenRenderer(mode='rgb').render()\n"
        "print(img.shape)\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'blendjax') or (m == 'torch' and sys.modules[m])))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert lines[-2] == "(108, 192, 3)"
    assert lines[-1] == "[]"


# -- the equivalence scaffold --------------------------------------------------------


def _moe_params(seed=0, c=16, e=4, h=32):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=0.3):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {"router": {"kernel": n(c, e), "bias": n(e)},
            "expert_wi": n(e, c, h), "expert_bi": n(e, h),
            "expert_wo": n(e, h, c), "expert_bo": n(e, c)}


def test_moe_per_token_reference_matches_the_jax_packages():
    """The dense per-token MoE reference on the same numpy parameters and
    tokens: the port's (torch's tanh GELU) within ``TOL_LOSS`` of the JAX
    package's (``jax.nn.gelu``), and the port's ``MoEMLP`` as ``params``
    reads its own weights in the flax layout."""
    from blendjax.testing.equivalence import (
        moe_per_token_reference as jax_reference,
    )
    from blendjax_torch.models import MoEMLP
    from blendjax_torch.testing.equivalence import (
        TOL_LOSS,
        moe_per_token_reference,
    )

    params = _moe_params()
    x = np.random.default_rng(1).standard_normal((2, 8, 16)).astype(
        np.float32)
    want = np.asarray(jax_reference(params, x))
    got = moe_per_token_reference(params, x)
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=TOL_LOSS, atol=TOL_LOSS)

    m = MoEMLP(16, 4, mlp_ratio=2)
    with torch.no_grad():
        m.router.weight.copy_(torch.from_numpy(params["router"]["kernel"].T))
        m.router.bias.copy_(torch.from_numpy(params["router"]["bias"]))
        for k in ("expert_wi", "expert_bi", "expert_wo", "expert_bo"):
            getattr(m, k).copy_(torch.from_numpy(params[k]))
    np.testing.assert_array_equal(moe_per_token_reference(m, x), got)


def test_max_tree_diff_and_normalized_spec():
    from blendjax_torch.parallel import Sharding
    from blendjax_torch.testing.equivalence import (
        max_tree_diff,
        normalized_spec,
    )

    a = {"w": torch.ones(2, 3), "b": [np.zeros(3), torch.tensor(1.5)]}
    b = {"w": torch.ones(2, 3), "b": [np.full(3, -0.25), torch.tensor(1.0)]}
    assert max_tree_diff(a, a) == 0.0
    assert max_tree_diff(a, b) == 0.5
    with pytest.raises(ValueError, match="structure"):
        max_tree_diff(a, {"w": a["w"]})
    assert normalized_spec(Sharding(None, (None, ("data",), None))) == (
        None, "data")
    assert normalized_spec((("data", "fsdp"), None)) == (("data", "fsdp"),)


WORLD = 2
LAYOUTS = ["data", "data×fsdp", "data×tp"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = [(f"equivalence:{lay}", {"layout": lay}) for lay in LAYOUTS]
    return W.run_worlds({WORLD: cases},
                        str(tmp_path_factory.mktemp("equivalence")))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_sharded_matches_single_device_over_gloo(ranks, layout):
    """``assert_sharded_matches_single_device`` on each rank of a gloo group
    of 2: the layout's train state (split over ``fsdp`` on the second
    layout, gathered before the comparison; over ``tp`` on the third,
    computed with in place and its blocks gathered for the comparison)
    and the rank's rows of the batch give the single-device loss and
    gradients within the JAX package's relative bars (the scaffold
    asserts; this reads its differences against the reference's
    magnitudes)."""
    from blendjax_torch.testing.equivalence import TOL_GRAD, TOL_LOSS

    for per in (r[f"equivalence:{layout}"] for r in ranks[WORLD]):
        if "error" in per:
            pytest.fail(per["error"])
        assert per["fsdp"] == (layout == "data×fsdp")
        assert 0.0 <= per["loss_diff"] < TOL_LOSS * per["loss_scale"]
        assert 0.0 <= per["grad_diff"] < TOL_GRAD * per["grad_scale"]


# -- the donation audit ----------------------------------------------------------------


def _echo_setup():
    from blendjax_torch.data.echo import SampleReservoir
    from blendjax_torch.models import CubeRegressor
    from blendjax_torch.train import make_echo_fused_step, make_train_state

    res = SampleReservoir(8, augment=None, device="cpu")
    state = make_train_state(
        CubeRegressor(features=(4,), dtype=torch.float32).init_params(0),
        device="cpu")
    return res, state, make_echo_fused_step(res.draw)


def _batch(rng, b=4):
    return {"image": torch.from_numpy(
                rng.integers(0, 256, (b, 16, 16, 4), dtype=np.uint8)),
            "xy": torch.from_numpy(rng.random((b, 8, 2)).astype(np.float32))}


def test_the_audit_is_stable_through_in_place_echo_inserts_and_steps():
    """Four echo inserts, each followed by a fused draw-and-step on the CPU:
    the ring's fields and the state's parameters and AdamW moments keep
    their storage, snapshot after snapshot (the first taken after the
    first step, when the moments exist); the gauge reads 1.0."""
    from blendjax_torch.testing import DonationAudit
    from blendjax_torch.testing.donation import state_tree
    from blendjax_torch.utils.metrics import Metrics

    res, state, step = _echo_setup()
    rng = np.random.default_rng(0)
    audit = DonationAudit()
    for i in range(4):
        res.insert(_batch(rng))
        state, m = step(state, res.draw_token(rng.integers(0, res.size, 4)))
        assert math.isfinite(float(m["loss"]))
        ring = audit.snapshot("ring", res.device_buffers())
        audit.snapshot("state", state_tree(state))
    assert sorted(ring) == ["['image']", "['xy']"]
    for label in ("ring", "state"):
        assert audit.stable(label)
        audit.assert_stable(label)
    assert audit.report() == {
        label: {"snapshots": 4, "distinct_pointer_sets": 1, "stable": True}
        for label in ("ring", "state")}
    reg = Metrics()
    assert audit.publish(reg) == 1.0
    assert reg.report()["gauges"]["train.donation_reuse"] == 1.0


def test_the_audit_reads_a_rebound_leaf_as_moved():
    """A parameter rebound to a copy (what a non-in-place update does)
    reads unstable, is named by ``assert_stable``, and sets the gauge to
    0.0; a tree with no pointer at all reads unstable too."""
    from blendjax_torch.testing import DonationAudit
    from blendjax_torch.testing.donation import state_tree
    from blendjax_torch.utils.metrics import Metrics

    res, state, step = _echo_setup()
    rng = np.random.default_rng(1)
    res.insert(_batch(rng))
    state, _ = step(state, res.draw_token([0, 1, 2, 3]))
    audit = DonationAudit()
    audit.snapshot("state", state_tree(state))
    head = state.model.head
    head.weight = torch.nn.Parameter(head.weight.detach().clone())
    audit.snapshot("state", state_tree(state))
    assert not audit.stable("state")
    with pytest.raises(AssertionError, match=r"head\.weight"):
        audit.assert_stable("state")
    reg = Metrics()
    assert audit.publish(reg) == 0.0
    assert reg.report()["gauges"]["train.donation_reuse"] == 0.0
    blind = DonationAudit()
    for _ in range(2):
        blind.snapshot("numbers", {"a": 1.0, "b": [2, 3]})
    assert not blind.stable("numbers")
    with pytest.raises(AssertionError, match="unverifiable"):
        blind.assert_stable("numbers")


def test_the_audit_report_has_the_jax_packages_keys():
    """The same labelled snapshots through the JAX package's audit (JAX
    arrays on the CPU) and the port's (tensors): the same report, key for
    key; a sharded state reads one address per shard."""
    import jax.numpy as jnp

    from blendjax.testing.donation import DonationAudit as JaxAudit
    from blendjax_torch.testing import DonationAudit
    from blendjax_torch.testing.donation import tree_pointers

    ja, pa = JaxAudit(), DonationAudit()
    jt, pt = {"a": jnp.zeros(3), "b": jnp.ones(2)}, {
        "a": torch.zeros(3), "b": torch.ones(2)}
    for _ in range(3):
        ja.snapshot("tree", jt)
        pa.snapshot("tree", pt)
    ja.snapshot("one", jt)
    pa.snapshot("one", pt)
    assert pa.report() == ja.report()

    class Shards:
        shards = [torch.zeros(2), torch.zeros(3)]

    sh = Shards()
    ptrs = tree_pointers({"params": sh})
    assert ptrs["['params']"] == tuple(
        s.untyped_storage().data_ptr() for s in sh.shards)
