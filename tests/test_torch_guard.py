"""Guards of the port: no JAX imports, no silent fallback to the CPU or to
a kernel's plain twin, and the kernel-selection rule. The ``cuda``-marked
test holds the CUDA kernels against their twins on a card and skips here.
"""

import ast
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "blendjax")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """At most two torch threads: the suite runs six workers on eight
    cores beside timing-sensitive tests of the JAX package."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _port_files():
    files = [os.path.join(REPO, n) for n in ("chip_smoke.py", "kernel_ab.py")]
    for root, _dirs, names in os.walk(os.path.join(REPO, "blendjax_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def _forbidden_imports(path):
    """The modules of ``FORBIDDEN`` that ``path`` imports."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        bad += [m for m in mods if m.split(".")[0] in FORBIDDEN]
    return bad


def test_port_imports_nothing_of_jax_or_blendjax():
    files = _port_files()
    assert len(files) > 10
    for module in ("kernels/attention.py", "ops/attention.py",
                   "models/transformer.py", "weights.py"):
        assert os.path.join(REPO, "blendjax_torch", module) in files
    bad = []
    for path in files:
        for mod in _forbidden_imports(path):
            bad.append(f"{os.path.relpath(path, REPO)}: {mod}")
    assert not bad, bad


@pytest.mark.parametrize("module", [
    "ops/image.py", "kernels/image.py", "ops/augment.py", "data/ring.py",
    "data/echo.py", "train/steps.py", "train/aot.py", "train/driver.py",
    "train/precision.py", "precision.py", "data/pipeline.py",
])
def test_the_echo_slice_modules_are_scanned(module):
    """The echo slice's and the train layer's modules are in the scan
    above, and each imports nothing of JAX or of the JAX package."""
    path = os.path.join(REPO, "blendjax_torch", module)
    assert path in _port_files()
    assert _forbidden_imports(path) == []


@pytest.mark.parametrize("module", [
    "transport/wire.py", "transport/shm.py", "transport/channels.py",
    "transport/__init__.py", "data/stream.py", "data/batcher.py",
    "data/shard_ingest.py", "data/torch_compat.py", "data/__init__.py",
    "producer/cube.py",
])
def test_the_ingest_slice_modules_are_scanned(module):
    """The input side's modules are in the scan above, and each imports
    nothing of JAX or of the JAX package."""
    path = os.path.join(REPO, "blendjax_torch", module)
    assert path in _port_files()
    assert _forbidden_imports(path) == []


@pytest.mark.parametrize("module", [
    "checkpoint/__init__.py", "checkpoint/format.py", "checkpoint/session.py",
    "checkpoint/snapshot.py", "checkpoint/preempt.py", "obs/__init__.py",
    "obs/lineage.py", "data/replay.py", "train/checkpoint.py",
    "producer/tile_publisher.py", "ops/tiles.py", "_native/build.py",
])
def test_the_checkpoint_slice_modules_are_scanned(module):
    """The checkpoint, replay and palette-producer modules are in the scan
    above, and each imports nothing of JAX or of the JAX package."""
    path = os.path.join(REPO, "blendjax_torch", module)
    assert path in _port_files()
    assert _forbidden_imports(path) == []


@pytest.mark.parametrize("module", [
    "utils/__init__.py", "utils/metrics.py", "utils/tg.py",
    "utils/logging.py", "obs/trace.py", "obs/lineage.py", "obs/doctor.py",
    "obs/devledger.py", "obs/exporters.py", "obs/reporter.py",
    "obs/watchdog.py", "obs/__init__.py", "kernels/work.py",
])
def test_the_observability_slice_modules_are_scanned(module):
    """The metrics and observability modules are in the scan above, and
    each imports nothing of JAX or of the JAX package (not even the JAX
    package's stdlib-only ``blendjax/obs`` or its threadguard)."""
    path = os.path.join(REPO, "blendjax_torch", module)
    assert path in _port_files()
    assert _forbidden_imports(path) == []


CONTROL_MODULES = [
    "utils/ipaddr.py", "transport/channels.py", "launcher/__init__.py",
    "launcher/arguments.py", "launcher/launch_info.py", "launcher/finder.py",
    "launcher/launcher.py", "launcher/apps.py", "producer/__init__.py",
    "producer/signal.py", "producer/animation.py", "producer/utils.py",
    "producer/camera.py", "producer/sim.py", "producer/publisher.py",
    "producer/duplex.py", "producer/env.py", "producer/bpy_engine.py",
    "producer/offscreen.py", "producer/scripts/__init__.py",
    "producer/scripts/cartpole.py", "producer/cube.py", "env/__init__.py",
    "env/remote.py", "env/vector.py", "env/rendering.py",
    "env/gymnasium_adapter.py", "env/registry.py",
]


@pytest.mark.parametrize("module", CONTROL_MODULES)
def test_the_control_slice_modules_are_scanned(module):
    """The control channels, producer runtime, launcher and env modules
    are in the scan above, and each imports nothing of JAX or of the JAX
    package (not even ``blendjax.testing``, which only the tests use)."""
    path = os.path.join(REPO, "blendjax_torch", module)
    assert path in _port_files()
    assert _forbidden_imports(path) == []


MESH_MODULES = [
    "parallel/__init__.py", "parallel/mesh.py", "parallel/sharding.py",
    "parallel/collectives.py", "parallel/ulysses.py", "parallel/ring.py",
    "train/mesh_driver.py", "obs/fleetview.py",
]


@pytest.mark.parametrize("module", MESH_MODULES)
def test_the_multi_gpu_slice_modules_are_scanned(module):
    """The meshes, shardings, collectives, sequence parallelism, the mesh
    driver and the fleet view are in the scan above, and each imports
    nothing of JAX or of the JAX package."""
    path = os.path.join(REPO, "blendjax_torch", module)
    assert path in _port_files()
    assert _forbidden_imports(path) == []


MOE_RL_MODULES = [
    "models/moe.py", "models/policy.py", "models/transformer.py",
    "parallel/pipeline.py", "rl/__init__.py", "rl/replay.py", "rl/actor.py",
    "rl/steps.py", "rl/learner.py", "rl/doctor.py",
]


@pytest.mark.parametrize("module", MOE_RL_MODULES)
def test_the_moe_pipeline_and_rl_modules_are_scanned(module):
    """Mixture of experts, the policy networks, pipeline parallelism and
    the RL stack are in the scan above, and each imports nothing of JAX or
    of the JAX package."""
    path = os.path.join(REPO, "blendjax_torch", module)
    assert path in _port_files()
    assert _forbidden_imports(path) == []


SCENARIO_FLEET_MODULES = [
    "scenario/__init__.py", "scenario/space.py", "scenario/accounting.py",
    "scenario/service.py", "scenario/curriculum.py", "fleet/__init__.py",
    "fleet/admission.py", "fleet/controller.py", "fleet/synthetic.py",
    "producer/scenario.py", "train/score.py", "models/discriminator.py",
]


@pytest.mark.parametrize("module", SCENARIO_FLEET_MODULES)
def test_the_scoring_scenario_and_fleet_modules_are_scanned(module):
    """Scoring, the discriminator, the scenario subsystem and the fleet
    are in the scan above, and each imports nothing of JAX or of the JAX
    package."""
    path = os.path.join(REPO, "blendjax_torch", module)
    assert path in _port_files()
    assert _forbidden_imports(path) == []


EXAMPLE_MODULES = [
    "examples/__init__.py", "examples/datagen/__init__.py",
    "examples/datagen/minimal.py", "examples/datagen/train.py",
    "examples/datagen/train_transformer.py",
    "examples/datagen/cube_producer.py",
    "examples/datagen/falling_cubes_producer.py",
    "examples/datagen/cube.blend.py", "examples/datagen/falling_cubes.blend.py",
    "examples/control/__init__.py", "examples/control/cartpole.py",
    "examples/control/cartpole_producer.py",
    "examples/control/cartpole.blend.py",
    "examples/control/train_reinforce.py", "examples/control/train_dqn.py",
    "examples/densityopt/__init__.py", "examples/densityopt/densityopt.py",
    "examples/densityopt/supershape_producer.py",
    "examples/densityopt/supershape.blend.py",
    "testing/__init__.py", "testing/threadguard.py",
]
# the scripts that run inside a producer process or Blender's Python
TORCH_FREE_EXAMPLES = [m for m in EXAMPLE_MODULES
                       if m.endswith(("producer.py", ".blend.py"))]


@pytest.mark.parametrize("module", EXAMPLE_MODULES)
def test_the_examples_and_the_sanitizer_are_scanned(module):
    """The examples (their ``.blend.py`` scene scripts too, parsed as
    source: they are not importable names) and the threadguard sanitizer
    are in the scan above, and each imports nothing of JAX or of the JAX
    package."""
    path = os.path.join(REPO, "blendjax_torch", module)
    assert path in _port_files()
    assert _forbidden_imports(path) == []


@pytest.mark.parametrize("module", TORCH_FREE_EXAMPLES + [
    "testing/threadguard.py", "utils/tg.py"])
def test_producer_side_examples_import_no_torch(module):
    """Producer and Blender scripts run where torch is not installed, and
    the sanitizer is stdlib only: none of them imports torch (nor numpy,
    for the sanitizer)."""
    path = os.path.join(REPO, "blendjax_torch", module)
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add((node.module or "").split(".")[0])
    assert "torch" not in mods
    if module in ("testing/threadguard.py", "utils/tg.py"):
        assert mods <= {"__future__", "threading", "os", "blendjax_torch"}


def test_the_synthetic_producer_run_as_a_file_imports_no_jax(tmp_path):
    """``python blendjax_torch/fleet/synthetic.py`` (a launcher's way)
    imports neither torch nor anything of JAX or the JAX package
    (``-X importtime`` lists every module it loads), and publishes."""
    import subprocess
    import sys

    from blendjax_torch.transport import DataReceiverSocket

    addr = f"ipc://{tmp_path}/synthetic.sock"
    recv = DataReceiverSocket([addr], timeoutms=60_000)
    proc = subprocess.Popen(
        [sys.executable, "-X", "importtime",
         os.path.join(REPO, "blendjax_torch", "fleet", "synthetic.py"),
         "--bind", addr, "--btid", "7", "--frames", "4", "--batch", "4",
         "--shape", "16", "16"],
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=REPO))
    try:
        msg, _ = recv.recv()
        _out, err = proc.communicate(timeout=60)
    finally:
        recv.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    assert proc.returncode == 0, err[-2000:]
    assert msg["btid"] == "7" and msg["image"].shape == (4, 16, 16, 4)
    loaded = {line.rsplit("|", 1)[-1].strip() for line in err.splitlines()
              if line.startswith("import time:")}
    assert "blendjax_torch.fleet.synthetic" not in loaded  # run as __main__
    assert "blendjax_torch.producer.sim" in loaded
    bad = sorted(m for m in loaded
                 if m.split(".")[0] in FORBIDDEN + ("torch", "triton"))
    assert not bad, bad


def test_the_rank_helper_of_the_mesh_tests_imports_no_jax():
    """``spawn`` re-imports the rank bodies' module in every rank: it must
    import neither JAX nor the JAX package."""
    path = os.path.join(REPO, "tests", "torch_dist_ranks.py")
    assert _forbidden_imports(path) == []


TORCH_FREE = ("producer", "launcher", "transport", "env", "fleet")


def _torch_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods.append(node.module or "")
    return [m for m in mods if m.split(".")[0] in ("torch", "triton")]


@pytest.mark.parametrize("package", TORCH_FREE)
def test_the_host_side_packages_import_no_torch(package):
    """No module of ``producer/``, ``launcher/``, ``transport/``,
    ``env/`` or ``fleet/`` imports torch, at its top or inside a function:
    a producer
    process never pays for it, and a launcher's producers come up within
    its bind grace window."""
    root = os.path.join(REPO, "blendjax_torch", package)
    files = [os.path.join(d, n) for d, _s, names in os.walk(root)
             for n in names if n.endswith(".py")]
    assert files
    bad = {os.path.relpath(f, REPO): _torch_imports(f) for f in files}
    assert not {k: v for k, v in bad.items() if v}


def test_importing_the_host_side_loads_no_torch():
    """In a fresh interpreter, importing every host-side module (the cube
    producer, the cartpole script, the launcher, the channels and the env
    package with its Gymnasium registration) and running a producer's
    scene loads neither torch nor anything of JAX."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "import blendjax_torch.producer.cube, blendjax_torch.launcher.apps\n"
        "import blendjax_torch.producer.scripts.cartpole\n"
        "import blendjax_torch.env, blendjax_torch.transport\n"
        "from blendjax_torch.producer.sim import CubeScene, SimEngine\n"
        "from blendjax_torch.producer import AnimationController\n"
        "scene = CubeScene(shape=(32, 64), seed=0, native=False)\n"
        "ctrl = AnimationController(SimEngine(scene))\n"
        "ctrl.post_frame.add(lambda f: scene.render())\n"
        "ctrl.play(frame_range=(1, 3), num_episodes=1)\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'blendjax')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_train_state_snapshot_needs_no_pickle():
    """No checkpoint module, and not the driver or the weight mapping,
    imports pickle or calls torch.save / torch.load: the snapshot format
    is pickle-free, as the JAX package's is."""
    for module in ("checkpoint/format.py", "checkpoint/session.py",
                   "checkpoint/snapshot.py", "checkpoint/preempt.py",
                   "train/checkpoint.py", "train/driver.py", "weights.py",
                   "data/echo.py"):
        path = os.path.join(REPO, "blendjax_torch", module)
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import) else [node.module])
                assert not any(n and n.split(".")[0] in ("pickle", "dill")
                               for n in names), module
            if isinstance(node, ast.Attribute) and node.attr in ("save",
                                                                 "load"):
                assert getattr(node.value, "id", None) != "torch", module


def _no_shared_memory(monkeypatch):
    from blendjax_torch.transport import shm

    def refuse(*args, **kwargs):
        raise OSError(28, "No space left on device", "/dev/shm")

    monkeypatch.setattr(shm.shared_memory, "SharedMemory", refuse)


def test_a_shm_publisher_without_a_ring_raises_and_sends_nothing(monkeypatch):
    """A ring that cannot be created fails the publish; the message never
    goes on the wire instead."""
    from blendjax_torch.transport import (
        DataPublisherSocket,
        DataReceiverSocket,
        ReceiveTimeoutError,
    )

    _no_shared_memory(monkeypatch)
    pub = DataPublisherSocket("tcp://127.0.0.1:*", btid=0, shm=4)
    recv = DataReceiverSocket([pub.addr], timeoutms=300)
    try:
        with pytest.raises(OSError, match="No space"):
            pub.publish(image=np.zeros((8, 8, 4), np.uint8))
        assert pub.shm_fallbacks == 0
        with pytest.raises(ReceiveTimeoutError):
            recv.recv()
    finally:
        recv.close()
        pub.close()


def test_the_cube_producer_stops_when_its_ring_cannot_be_made(monkeypatch):
    from blendjax_torch.producer import cube

    _no_shared_memory(monkeypatch)
    with pytest.raises(OSError, match="No space"):
        cube.main(["--shape", "32", "64", "--batch", "2", "--frames", "2",
                   "--tile", "16", "32", "--tile-capacity", "4",
                   "--wire", "shm", "--no-native"])


def test_a_sharded_pipeline_without_a_gpu_raises(monkeypatch):
    from blendjax_torch.data import StreamDataPipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamDataPipeline(["tcp://127.0.0.1:1", "tcp://127.0.0.1:2"],
                           batch_size=2, ingest_workers=2)
    pipe = StreamDataPipeline(["tcp://127.0.0.1:1", "tcp://127.0.0.1:2"],
                              batch_size=2, ingest_workers=2, device="cpu")
    assert pipe.device == torch.device("cpu")


def _docstrings(tree):
    """The docstring nodes of a module and its classes and functions."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(first.value,
                                                          ast.Constant):
                out.add(id(first.value))
    return out


def test_no_port_source_includes_loads_or_builds_into_the_jax_native_dir():
    """No C++/CUDA source of the port includes a file outside its own
    directory, no Python module names ``blendjax/_native`` outside its
    docstrings, and the host C++ builds into ``build/`` and loads from
    there."""
    import re

    from blendjax_torch._native import build

    sources, bad = [], []
    for root, _dirs, names in os.walk(os.path.join(REPO, "blendjax_torch")):
        for n in names:
            path = os.path.join(root, n)
            rel = os.path.relpath(path, REPO)
            if n.endswith((".cpp", ".cu", ".cuh")):
                sources.append(rel)
                with open(path) as f:
                    for line in f:
                        m = re.match(r'\s*#\s*include\s*"([^"]+)"', line)
                        if m and ("/" in m.group(1) or ".." in m.group(1)):
                            bad.append(f"{rel}: {line.strip()}")
            elif n.endswith(".py"):
                with open(path) as f:
                    tree = ast.parse(f.read(), path)
                docs = _docstrings(tree)
                for node in ast.walk(tree):
                    if (isinstance(node, ast.Constant)
                            and isinstance(node.value, str)
                            and id(node) not in docs
                            and re.search(r"blendjax[/.]_native",
                                          node.value)):
                        bad.append(f"{rel}: {node.value!r}")
    assert "blendjax_torch/_native/rasterizer.cpp" in sources
    assert "blendjax_torch/_native/tiledelta.cpp" in sources
    assert not bad, bad
    assert str(build.SRC) == os.path.join(REPO, "blendjax_torch", "_native")
    assert str(build.BUILD_DIR) == os.path.join(REPO, "build",
                                                "blendjax_torch_native")
    for name in ("rasterizer", "tiledelta"):
        assert os.path.dirname(build.library_path(name)) == str(
            build.BUILD_DIR)
        assert os.path.dirname(build.load(name)._name) == str(build.BUILD_DIR)


@pytest.mark.parametrize("compiler", ["/nonexistent/g++", "false"],
                         ids=["missing", "failing"])
def test_the_producers_raise_when_the_cpp_fails_to_build(monkeypatch,
                                                         tmp_path, capsys,
                                                         compiler):
    """With a compiler that is missing or fails, every producer-side entry
    point on the C++ path raises; none runs its numpy twin instead. With
    ``native=False`` they run, and so does the cube producer with
    ``--no-native`` (a host without g++)."""
    from blendjax_torch._native import build
    from blendjax_torch.ops import tiles as T
    from blendjax_torch.producer import (
        CubeScene,
        Rasterizer,
        TileBatchPublisher,
        cube,
    )

    monkeypatch.setattr(build, "CXX", compiler)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(build, "_libs", {})
    ref = np.zeros((32, 64, 4), np.uint8)
    tiles = np.zeros((1, 2, 16, 32, 4), np.uint8)

    class Sink:
        def publish(self, **msg):
            raise AssertionError("nothing may be published")

    calls = [
        lambda native: Rasterizer((32, 64), native=native),
        lambda native: CubeScene((32, 64), native=native),
        lambda native: T.TileDeltaEncoder(ref, (16, 32), native=native),
        lambda native: T.palettize_tiles(tiles, native=native),
        lambda native: TileBatchPublisher(Sink(), ref, 2, (16, 32),
                                          native=native),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="_native/"):
            call(True)
        call(False)
    sent = []

    class Socket:  # the producer's PUSH socket, recording what it sends
        addr = "tcp://127.0.0.1:1"

        def __init__(self, *a, **kw):
            pass

        def publish(self, **msg):
            sent.append(msg)

        def close(self):
            pass

    monkeypatch.setattr(cube, "DataPublisherSocket", Socket)
    monkeypatch.setattr(cube, "term_context", lambda: None)
    args = ["--shape", "32", "64", "--frames", "2", "--encoding", "tile",
            "--batch", "8"]
    with pytest.raises(RuntimeError, match="_native/"):
        cube.main(args)
    assert not sent
    cube.main([*args, "--no-native"])
    assert len(sent) == 1 and list(sent[0]["frameid"]) == [1, 2]
    said = [ln for ln in capsys.readouterr().err.splitlines()
            if ln.startswith("blendjax_torch.producer.cube path")]
    assert len(said) == 1 and said[0].startswith(
        "blendjax_torch.producer.cube path numpy")
    assert not list((tmp_path / "native").glob("*"))  # no library, no temp


@pytest.mark.parametrize("compiler", ["/nonexistent/g++", "false"],
                         ids=["missing", "failing"])
def test_the_fused_palette_path_raises_when_its_cpp_fails_to_build(
        monkeypatch, tmp_path, compiler):
    """An encoder whose library goes away (a build that fails after it was
    made) raises from palidx_available and encode_palidx: neither answers
    "not available" and lets the publisher run the two-pass path
    quietly; the loader of the palidx entry raises too."""
    from blendjax_torch._native import build
    from blendjax_torch.ops import tiles as T

    ref = np.zeros((32, 64, 4), np.uint8)
    enc = T.TileDeltaEncoder(ref, (16, 32))  # built with the real g++
    monkeypatch.setattr(build, "CXX", compiler)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(build, "_libs", {})
    with pytest.raises(RuntimeError, match="_native/"):
        build.tile_delta_palidx()
    with pytest.raises(RuntimeError, match="_native/"):
        enc.palidx_available()
    with pytest.raises(RuntimeError, match="_native/"):
        enc.encode_palidx(ref)
    assert not list((tmp_path / "native").glob("*"))  # no library, no temp


def test_entry_points_without_a_gpu_raise(monkeypatch):
    from blendjax_torch.data import DeviceFeeder, StreamDataPipeline
    from blendjax_torch.device import resolve_device
    from blendjax_torch.models import CubeRegressor
    from blendjax_torch.train import make_train_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        StreamDataPipeline(["tcp://127.0.0.1:1"], batch_size=2)
    with pytest.raises(RuntimeError):
        make_train_state(CubeRegressor(features=(4,)))
    with pytest.raises(RuntimeError):
        DeviceFeeder()
    assert resolve_device("cpu") == torch.device("cpu")


def _case(tile=(16, 32)):
    rng = np.random.default_rng(0)
    n = (64 // tile[0]) * (128 // tile[1])
    ref = torch.from_numpy(rng.integers(0, 256, (n, *tile, 4), dtype=np.uint8))
    idx = torch.tensor([[0, 3, n], [n, n, n]], dtype=torch.int32)
    tiles = torch.from_numpy(
        rng.integers(0, 256, (2, 3, *tile, 4), dtype=np.uint8)
    )
    return ref, idx, tiles


class _FailingLib:
    """A kernel library whose launches report cudaErrorMemoryAllocation."""

    def __init__(self):
        self.bjt_decode_spatial = lambda *a: 2
        self.bjt_decode_scatter = lambda *a: 2
        self.bjt_decode_spatial_error = lambda code: b"out of memory"
        self.bjt_decode_scatter_error = lambda code: b"out of memory"


@pytest.mark.parametrize("kernel", ["decode_spatial", "decode_scatter"])
def test_a_cuda_request_never_falls_back_to_the_twin(monkeypatch, kernel):
    from blendjax_torch.kernels import decode

    ref, idx, tiles = _case()
    args = (ref, idx, tiles, (64, 128, 4)) if kernel == "decode_spatial" \
        else (ref, idx, tiles)
    wrapper = getattr(decode, kernel)
    before = wrapper.launches

    def twin(*a):
        raise AssertionError("the plain twin ran for a CUDA request")

    monkeypatch.setattr(decode, f"{kernel}_plain", twin)
    monkeypatch.setattr(decode, "_check_inputs", lambda *a: "cuda")
    monkeypatch.setattr(decode, "_stream", lambda device: 0)
    monkeypatch.setattr(decode, "load", lambda name: _FailingLib())
    with pytest.raises(RuntimeError, match="launch failed: out of memory"):
        wrapper(*args)

    def no_build(name):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(decode, "load", no_build)
    with pytest.raises(RuntimeError, match="nvcc"):
        wrapper(*args)
    assert wrapper.launches == before


class _FailingGammaLib:
    def __init__(self):
        self.bjt_gamma_normalize = lambda *a: 2
        self.bjt_gamma_normalize_error = lambda code: b"out of memory"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_cuda_gamma_request_never_falls_back(monkeypatch, dtype):
    from blendjax_torch.kernels import image as K

    x = torch.arange(256, dtype=torch.uint8).reshape(1, 4, 16, 4)
    before = K.gamma_normalize.launches

    def plain(*a, **kw):
        raise AssertionError("the plain version ran for a CUDA request")

    monkeypatch.setattr(K, "gamma_normalize_plain", plain)
    monkeypatch.setattr(K, "_check", lambda *a: "cuda")
    monkeypatch.setattr(K, "_stream", lambda device: 0)
    monkeypatch.setattr(K, "_sm_count", lambda index: 132)
    monkeypatch.setattr(K, "load", lambda name: _FailingGammaLib())
    with pytest.raises(RuntimeError, match="launch failed: out of memory"):
        K.gamma_normalize(x, 2.2, dtype)

    def no_build(name):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(K, "load", no_build)
    with pytest.raises(RuntimeError, match="nvcc"):
        K.gamma_normalize(x, 2.2, dtype)
    assert K.gamma_normalize.launches == before


def test_echo_entry_points_without_a_gpu_raise(monkeypatch):
    from blendjax_torch.data import (
        EchoingPipeline,
        SampleReservoir,
        StreamDataPipeline,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SampleReservoir(4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EchoingPipeline([{"image": np.zeros((2, 4, 4, 4), np.uint8)}],
                        batch_size=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamDataPipeline(["tcp://127.0.0.1:1"], batch_size=2,
                           emit_packed=False)
    # asked for the CPU, both run there
    assert SampleReservoir(4, device="cpu").device == torch.device("cpu")
    assert EchoingPipeline([], batch_size=2, device="cpu").device == \
        torch.device("cpu")


class _FailingFlashLib:
    def __init__(self):
        for name in ("bjt_flash_fwd", "bjt_flash_bwd_dkv", "bjt_flash_bwd_dq"):
            setattr(self, name, lambda *a: 2)
        self.bjt_flash_error = lambda code: b"out of memory"


def _attention_args(wrapper):
    from blendjax_torch.kernels import attention as K

    rng = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 8, 2, 8))
                                    .astype(np.float32)) for _ in range(4))
    if wrapper == "fwd":
        return (q, k, v)
    o, lse = K.flash_attention_fwd_plain(q, k, v)
    return (q, k, v, do, lse, K.attention_delta(o, do))


def _make_cuda_requests_fail(monkeypatch, K):
    """The wrappers see a CUDA request whose library reports a failure;
    the plain versions must not run."""
    def plain(*a, **kw):
        raise AssertionError("the plain version ran for a CUDA request")

    for name in ("fwd", "bwd_dkv", "bwd_dq"):
        monkeypatch.setattr(K, f"flash_attention_{name}_plain", plain)
    monkeypatch.setattr(K, "_check_inputs", lambda *a: "cuda")
    monkeypatch.setattr(K, "_stream", lambda device: 0)
    monkeypatch.setattr(K, "load", lambda name: _FailingFlashLib())


@pytest.mark.parametrize("wrapper", ["fwd", "bwd_dkv", "bwd_dq"])
def test_a_cuda_attention_request_never_falls_back(monkeypatch, wrapper):
    from blendjax_torch.kernels import attention as K

    args = _attention_args(wrapper)
    fn = getattr(K, f"flash_attention_{wrapper}")
    before = fn.launches
    _make_cuda_requests_fail(monkeypatch, K)
    with pytest.raises(RuntimeError, match="launch failed: out of memory"):
        fn(*args)

    def no_build(name):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(K, "load", no_build)
    with pytest.raises(RuntimeError, match="nvcc"):
        fn(*args)
    assert fn.launches == before


class _FailingSm90Lib:
    """The sm90 forward's library, whose launches report
    cudaErrorMemoryAllocation."""

    def __init__(self):
        self.bjt_flash_fwd_sm90 = lambda *a: 2
        self.bjt_flash_fwd_sm90_error = lambda code: b"out of memory"


@pytest.mark.parametrize("d,causal", [(64, False), (128, True)])
def test_a_failing_sm90_forward_raises(monkeypatch, d, causal):
    """An sm90-eligible request (bf16 views of one qkv buffer, head dim 64
    or 128) whose library fails raises: the simple entry point and the
    plain version never run, and nothing is counted."""
    from blendjax_torch.kernels import attention as K

    qkv = torch.zeros((2, 16, 3, 2, d), dtype=torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert K.fwd_variant(q, k, v) == "sm90"
    before = (K.flash_attention_fwd.launches,
              dict(K.flash_attention_fwd.launches_by_variant))
    _make_cuda_requests_fail(monkeypatch, K)  # the simple entry fails too
    libs = []

    def load(name):
        libs.append(name)
        if name != "flash_fwd_sm90":
            raise AssertionError(f"an sm90 request loaded {name}")
        return _FailingSm90Lib()

    monkeypatch.setattr(K, "load", load)
    with pytest.raises(RuntimeError,
                       match="bjt_flash_fwd_sm90 launch failed: out of memory"):
        K.flash_attention_fwd(q, k, v, causal)
    assert libs == ["flash_fwd_sm90"]

    def no_build(name):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(K, "load", no_build)
    with pytest.raises(RuntimeError, match="nvcc"):
        K.flash_attention_fwd(q, k, v, causal)
    assert (K.flash_attention_fwd.launches,
            K.flash_attention_fwd.launches_by_variant) == before


def test_a_negative_scale_never_reaches_the_sm90_forward(monkeypatch):
    """bf16 views the sm90 forward could address, with a scale <= 0: the
    request goes to the simple entry point (which fails here, and raises)
    and never loads the sm90 library."""
    from blendjax_torch.kernels import attention as K

    qkv = torch.zeros((2, 16, 3, 2, 128), dtype=torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    _make_cuda_requests_fail(monkeypatch, K)
    libs = []

    def load(name):
        libs.append(name)
        return _FailingFlashLib()

    monkeypatch.setattr(K, "load", load)
    for scale in (-0.125, 0.0):
        with pytest.raises(RuntimeError,
                           match="bjt_flash_fwd launch failed: out of memory"):
            K.flash_attention_fwd(q, k, v, False, scale)
    assert libs == ["flash_attention", "flash_attention"]


class _FailingSm90BwdLib:
    """The sm90 backward's library, whose launches report
    cudaErrorMemoryAllocation."""

    def __init__(self):
        self.bjt_flash_bwd_dkv_sm90 = lambda *a: 2
        self.bjt_flash_bwd_dq_sm90 = lambda *a: 2
        self.bjt_flash_bwd_sm90_error = lambda code: b"out of memory"


def _sm90_bwd_args(d, dtype=torch.bfloat16):
    """q, k, v as views of one (B, T, 3, H, D) buffer, do, and f32 lse/di:
    what the sm90 backward takes."""
    from blendjax_torch.kernels import attention as K

    qkv = torch.zeros((2, 16, 3, 2, d), dtype=dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = torch.zeros((2, 16, 2, d), dtype=dtype)
    lse = torch.zeros((2, 2, 16))
    assert K.bwd_variant(q, k, v, do) == (
        "sm90" if dtype == torch.bfloat16 else "simple")
    return q, k, v, do, lse, lse.clone()


@pytest.mark.parametrize("wrapper", ["bwd_dkv", "bwd_dq"])
@pytest.mark.parametrize("d,causal", [(64, False), (128, True)])
def test_a_failing_sm90_backward_raises(monkeypatch, wrapper, d, causal):
    """An sm90-eligible backward request whose library fails raises: the
    simple entry point and the plain version never run, and nothing is
    counted."""
    from blendjax_torch.kernels import attention as K

    args = _sm90_bwd_args(d)
    fn = getattr(K, f"flash_attention_{wrapper}")
    before = (fn.launches, dict(fn.launches_by_variant))
    _make_cuda_requests_fail(monkeypatch, K)  # the simple entry fails too
    libs = []

    def load(name):
        libs.append(name)
        if name != "flash_bwd_sm90":
            raise AssertionError(f"an sm90 request loaded {name}")
        return _FailingSm90BwdLib()

    monkeypatch.setattr(K, "load", load)
    with pytest.raises(RuntimeError, match=(
            f"bjt_flash_{wrapper}_sm90 launch failed: out of memory")):
        fn(*args, causal)
    assert libs == ["flash_bwd_sm90"]

    def no_build(name):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(K, "load", no_build)
    with pytest.raises(RuntimeError, match="nvcc"):
        fn(*args, causal)
    assert (fn.launches, fn.launches_by_variant) == before


class _RecordingFlashLib:
    """Every flash entry point succeeds and records its call."""

    def __init__(self):
        self.calls = []
        for name in ("bjt_flash_bwd_dkv", "bjt_flash_bwd_dq",
                     "bjt_flash_bwd_dkv_sm90", "bjt_flash_bwd_dq_sm90"):
            setattr(self, name,
                    lambda *a, _n=name: self.calls.append((_n, a)) or 0)


@pytest.mark.parametrize("dtype,variant", [(torch.bfloat16, "sm90"),
                                           (torch.float32, "simple")])
def test_backward_launches_count_by_variant(monkeypatch, dtype, variant):
    """Each backward launch adds one to its wrapper's count and to its
    variant's, and calls that variant's entry point once; a negative scale
    still takes sm90 and reaches the entry point as given."""
    from blendjax_torch.kernels import attention as K

    q, k, v, do, lse, di = _sm90_bwd_args(128, dtype)
    lib = _RecordingFlashLib()
    libs = []

    def load(name):
        libs.append(name)
        return lib

    _make_cuda_requests_fail(monkeypatch, K)
    monkeypatch.setattr(K, "load", load)
    wrappers = (K.flash_attention_bwd_dkv, K.flash_attention_bwd_dq)
    before = [(fn.launches, dict(fn.launches_by_variant)) for fn in wrappers]
    dk, dv = K.flash_attention_bwd_dkv(q, k, v, do, lse, di, True, -0.25)
    dq = K.flash_attention_bwd_dq(q, k, v, do, lse, di, True, -0.25)
    assert dk.shape == dv.shape == k.shape and dq.shape == q.shape
    assert dq.dtype == dk.dtype == dtype
    for fn, (launches, by_variant) in zip(wrappers, before):
        assert fn.launches == launches + 1
        other = "simple" if variant == "sm90" else "sm90"
        assert fn.launches_by_variant[variant] == by_variant[variant] + 1
        assert fn.launches_by_variant[other] == by_variant[other]
    suffix = "_sm90" if variant == "sm90" else ""
    assert [name for name, _ in lib.calls] == [
        f"bjt_flash_bwd_dkv{suffix}", f"bjt_flash_bwd_dq{suffix}"]
    assert libs == ["flash_bwd_sm90" if variant == "sm90"
                    else "flash_attention"] * 2
    for _, call in lib.calls:
        assert pytest.approx(-0.25) in [a for a in call if isinstance(a, float)]


def test_library_path_hashes_the_shared_headers(monkeypatch, tmp_path):
    """An edited csrc/*.cuh gives every library a new name, so a stale
    build is never loaded; so does an edited source, for its own library."""
    import shutil

    from blendjax_torch.kernels import build

    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    assert (csrc / "sm90.cuh").exists()
    names = ("flash_fwd_sm90", "flash_bwd_sm90", "decode_scatter")
    first = {n: build.library_path(n) for n in names}
    assert first == {n: build.library_path(n) for n in names}  # stable
    header = csrc / "sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    second = {n: build.library_path(n) for n in names}
    assert all(first[n] != second[n] for n in names)
    source = csrc / "flash_bwd_sm90.cu"
    source.write_text(source.read_text() + "\n// edited\n")
    third = {n: build.library_path(n) for n in names}
    assert third["flash_bwd_sm90"] != second["flash_bwd_sm90"]
    assert third["flash_fwd_sm90"] == second["flash_fwd_sm90"]


class _Entry:
    """A recording stand-in for a ctypes function: counts how often its
    signature is set and records each call."""

    def __init__(self, on_call):
        object.__setattr__(self, "signature_sets", 0)
        object.__setattr__(self, "calls", [])
        object.__setattr__(self, "on_call", on_call)

    def __setattr__(self, name, value):
        if name == "argtypes":
            object.__setattr__(self, "signature_sets", self.signature_sets + 1)
        object.__setattr__(self, name, value)

    def __call__(self, *args):
        self.calls.append(args)
        return self.on_call(*args)


def test_decode_scatter_is_one_launch_into_an_uninitialised_buffer(
        monkeypatch):
    """Each decode_scatter on the card is exactly one entry-point call, made
    on a slot buffer straight from torch.empty that nothing wrote first (no
    copy_ of the reference, no fill); the ctypes signature is set once
    across calls."""
    import ctypes

    from blendjax_torch.kernels import decode

    ref, idx, tiles = _case((16, 16))
    b, n, ttc = idx.shape[0], ref.shape[0], ref[0].numel()
    poison = 0xAB
    real_empty = torch.empty

    def empty(*shape, **kw):  # what an uninitialised allocation may hold
        return real_empty(*shape, **kw).fill_(poison)

    def no_copy(self, *a, **kw):
        raise AssertionError("a card decode_scatter ran copy_")

    seen = []

    def launch(ref_p, idx_p, tiles_p, slots_p, *rest):
        raw = (ctypes.c_uint8 * (b * n * ttc)).from_address(slots_p)
        seen.append((bytes(raw) == bytes([poison]) * (b * n * ttc), rest))
        return 0

    fn = _Entry(launch)

    class Lib:
        bjt_decode_scatter = fn

    lib = Lib()
    monkeypatch.setattr(decode, "_check_inputs", lambda *a: "cuda")
    monkeypatch.setattr(decode, "_stream", lambda device: 0)
    monkeypatch.setattr(decode, "load", lambda name: lib)
    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(torch.Tensor, "copy_", no_copy)
    before = decode.decode_scatter.launches
    for call in range(3):
        out = decode.decode_scatter(ref, idx, tiles)
        assert len(fn.calls) == call + 1
        assert fn.calls[-1][3] == out.data_ptr()
    assert decode.decode_scatter.launches == before + 3
    assert [untouched for untouched, _ in seen] == [True] * 3
    # (B, K, N, th*tw*C, vec16, stream)
    assert seen[0][1] == (b, idx.shape[1], n, ttc, 1, 0)
    assert fn.signature_sets == 1


def test_the_autograd_backward_never_falls_back(monkeypatch):
    """A forward on CPU tensors, then a backward that sees a CUDA request:
    it launches the backward kernels (here: fails loudly), never the
    plain backward."""
    from blendjax_torch.kernels import attention as K

    q, k, v = (t.requires_grad_() for t in _attention_args("fwd"))
    out = K.flash_attention(q, k, v)
    _make_cuda_requests_fail(monkeypatch, K)
    with pytest.raises(RuntimeError, match="bjt_flash_bwd_dkv launch failed"):
        out.sum().backward()


def test_streamformer_entry_points_without_a_gpu_raise(monkeypatch):
    from blendjax_torch.models import StreamFormer
    from blendjax_torch.train import make_train_state

    small = dict(patch=8, dim=32, depth=1, num_heads=4, image_shape=(16, 32))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_state(StreamFormer(**small, attn_backend="flash"))
    # asked for the CPU: the flash backend runs the kernels' plain versions
    state = make_train_state(
        StreamFormer(**small, attn_backend="flash").init_params(0),
        device="cpu")
    out = state.model(torch.zeros((1, 16, 32, 4), dtype=torch.uint8))
    assert out.shape == (1, 16) and torch.isfinite(out).all()


def test_kernel_wrappers_refuse_other_devices():
    from blendjax_torch.kernels import decode_scatter, decode_spatial

    ref, idx, tiles = (t.to("meta") for t in _case())
    with pytest.raises(RuntimeError, match="no decode kernel"):
        decode_spatial(ref, idx, tiles, (64, 128, 4))
    with pytest.raises(RuntimeError, match="no decode kernel"):
        decode_scatter(ref, idx, tiles)


@pytest.mark.parametrize("tile,kernel", [
    ((16, 32), "spatial"), ((8, 32), "spatial"), ((16, 10), "spatial"),
    ((16, 16), "scatter"), ((32, 32), "scatter"), ((5, 5), "scatter"),
])
def test_kernel_selection_rule(monkeypatch, tile, kernel):
    """Square tiles take K2, every other geometry K1; decode_tile_delta
    routes accordingly."""
    from blendjax_torch.kernels import decode
    from blendjax_torch.ops.tiles import decode_tile_delta, select_decode_kernel

    assert select_decode_kernel(*tile, 4) == kernel
    calls = []
    for name in ("decode_spatial", "decode_scatter"):
        real = getattr(decode, name)
        monkeypatch.setattr(
            decode, name,
            lambda *a, _n=name, _r=real: calls.append(_n) or _r(*a),
        )
    h, w = tile[0] * 2, tile[1] * 3
    n = 6
    ref = torch.zeros((n, *tile, 4), dtype=torch.uint8)
    idx = torch.tensor([[1, n]], dtype=torch.int32)
    tiles = torch.full((1, 2, *tile, 4), 7, dtype=torch.uint8)
    out = decode_tile_delta(ref, idx, tiles, (h, w, 4))
    assert calls == [f"decode_{kernel}"]
    assert int(out.sum()) == 7 * tile[0] * tile[1] * 4


def _cuda_state(monkeypatch):
    """A CPU train state that the capture code takes for a CUDA one."""
    from blendjax_torch.models import CubeRegressor
    from blendjax_torch.train import aot, make_train_state

    monkeypatch.setattr(aot, "state_device", lambda st: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: None)
    return make_train_state(CubeRegressor(features=(4,)).init_params(0),
                            device="cpu")


def _counting_step(calls):
    def step(state, batch):
        calls.append("eager")
        return state, {"loss": torch.zeros(())}

    return step


def test_a_cuda_step_set_never_gives_way_to_the_eager_step(monkeypatch):
    """A replay that fails raises out of AotStepSet; the eager step is not
    run in its place (the JAX set's quiet fallback is not ported)."""
    from blendjax_torch.train import aot

    class Failing:
        host_launches = 0

        def __call__(self, state, batch):
            raise RuntimeError("replay failed")

    calls = []
    batch = {"image": torch.zeros((2, 4, 4, 4), dtype=torch.uint8)}
    sig = aot._signature(batch)
    step_set = aot.AotStepSet(_counting_step(calls), {sig: Failing()}, 0.0)
    with pytest.raises(RuntimeError, match="replay failed"):
        step_set(_cuda_state(monkeypatch), batch)
    assert calls == [] and step_set.aot_fallbacks == 0


def test_a_failing_capture_never_gives_way_to_the_eager_step(monkeypatch):
    """A capture that fails, in the ladder build or on a new packed
    signature, raises; the eager step does not take over."""
    from blendjax_torch.train import aot

    def capture(*a, **k):
        raise RuntimeError("capture failed")

    state = _cuda_state(monkeypatch)
    monkeypatch.setattr(aot, "_capture", capture)
    calls = []
    batch = {"_packed": torch.zeros((1, 8), dtype=torch.uint8),
             "_spec": (("x", "|u1", (8,), 0, 8),)}
    with pytest.raises(RuntimeError, match="capture failed"):
        aot.CapturedStep(_counting_step(calls))(state, batch)
    example = {"image": torch.zeros((2, 4, 4, 4), dtype=torch.uint8)}
    with pytest.raises(RuntimeError, match="capture failed"):
        aot.build_aot_step(_counting_step(calls), state, example)
    assert calls == []


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [(16, 32), (16, 16), (16, 10), (5, 5)])
@pytest.mark.parametrize("bad", [None, "negative", "out of range"])
def test_kernels_match_twins_on_card(cuda_card, tile, bad):
    from blendjax_torch.kernels import (
        decode_scatter,
        decode_scatter_plain,
        decode_spatial,
        decode_spatial_plain,
    )

    h, w = tile[0] * 30, tile[1] * 20
    n = 600
    rng = np.random.default_rng(1)
    ref = torch.from_numpy(
        rng.integers(0, 256, (n, *tile, 4), dtype=np.uint8)).to(cuda_card)
    idx = np.full((8, 64), n, np.int32)  # K 64: more than one block's slots
    for i in range(7):  # the last row stays all sentinels
        idx[i, :50] = rng.choice(n, 50, replace=False)
    if bad == "negative":  # write nothing, like sentinels
        idx[:, 50:56] = [-1, -2, -600, -601, -(2**31), -7]
    elif bad == "out of range":
        idx[:, 50:55] = [n + 1, n + 16, 2 * n, 2**31 - 1, n + 600]
    idx = torch.from_numpy(idx).to(cuda_card)
    tiles = torch.from_numpy(
        rng.integers(0, 256, (8, 64, *tile, 4), dtype=np.uint8)).to(cuda_card)
    assert torch.equal(decode_spatial(ref, idx, tiles, (h, w, 4)),
                       decode_spatial_plain(ref, idx, tiles, (h, w, 4)))
    assert torch.equal(decode_scatter(ref, idx, tiles),
                       decode_scatter_plain(ref, idx, tiles))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4, 16, 4), (1, 37, 8, 4),
                                   (8, 480, 640, 4), (3, 5, 7, 1)])
@pytest.mark.parametrize("gamma", [2.2, 1.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "byte-offset-1"])
def test_gamma_kernel_matches_its_plain_version_on_card(cuda_card, shape,
                                                        gamma, dtype, offset):
    """Offset 1: a contiguous view whose first byte is not word-aligned,
    which takes the kernel's element path."""
    from blendjax_torch.kernels import gamma_normalize, gamma_normalize_plain
    from blendjax_torch.ops.image import uint8_gamma_normalize

    if shape == (1, 4, 16, 4):  # every uint8 value
        x = torch.arange(256, dtype=torch.uint8).reshape(shape)
    else:
        x = torch.from_numpy(np.random.default_rng(2).integers(
            0, 256, shape, dtype=np.uint8))
    buf = torch.empty(offset + x.numel(), dtype=torch.uint8, device=cuda_card)
    x = buf[offset:].view(shape).copy_(x)
    assert x.data_ptr() % 4 == offset
    before = gamma_normalize.launches
    got = uint8_gamma_normalize(x, gamma=gamma, dtype=dtype)
    want = gamma_normalize_plain(x, gamma, dtype)
    torch.cuda.synchronize()
    assert gamma_normalize.launches == before + 1
    # the same powf on the same f32 values: bit-exact
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_an_insert_queued_after_a_step_cannot_change_what_it_read(cuda_card):
    """A step that gathers ring slots, then an insert overwriting them,
    queued back to back on the card: the step trains on the old rows."""
    from blendjax_torch.data import SampleReservoir
    from blendjax_torch.train import make_echo_fused_step

    res = SampleReservoir(8, augment=None, device=cuda_card)
    rng = np.random.default_rng(0)
    old = {"image": rng.integers(0, 256, (8, 480, 640, 4), dtype=np.uint8),
           "xy": rng.random((8, 8, 2)).astype(np.float32)}
    new = {k: np.zeros_like(v) for k, v in old.items()}
    res.insert(old)
    seen = []

    def loss_fn(model, batch):
        seen.append(batch["image"].double().sum())  # queued, not read
        return (batch["image"].float().mean() * model.w).sum()

    class Tiny(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones((), device=cuda_card))

    from blendjax_torch.train import make_train_state

    state = make_train_state(Tiny(), device=cuda_card)
    step = make_echo_fused_step(res.draw, loss_fn)
    torch.cuda.synchronize()
    step(state, res.draw_token(np.arange(8)))
    res.insert(new)  # overwrites all 8 slots
    torch.cuda.synchronize()
    want = float(torch.from_numpy(old["image"]).double().sum())
    assert float(seen[0]) == want
