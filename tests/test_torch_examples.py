"""The port's examples (``blendjax_torch/examples``) on the CPU.

- The JAX package's fourteen example cases (``tests/test_examples.py``)
  run each port example's real ``main()`` in process with ``--device cpu``
  at the same tiny sizes, and assert the same printed contract. Live and
  random paths (echo, augment, the fleet, RL, densityopt) are held to that
  contract only: their data depends on producer timing or on a generator
  neither package shares.
- Recording parity: the JAX example records a stream and snapshots its
  state (64x64, ``--chunk 2`` for tile and pal, no augment); both packages
  then replay that recording for 21 steps from a copy of that snapshot,
  with f32 compute (both packages' ``CubeRegressor`` switched to f32 here)
  and TF32 off. The printed losses agree within rtol 1e-4 / atol 2e-5 (a
  printed loss has five decimals). The JAX package's raw batches on the
  CPU alias the buffers its assembler fills again (ROADMAP Queue C, C10),
  so its assembler is made to hand out copies for the raw case.
- The cube producer's encodings (raw per frame, raw batched, tile, pal)
  deliver, through the port's pipeline, the frames of the JAX package's
  cube producer with the same seed, byte for byte.
- The Blender scene scripts run under the JAX package's fake Blender with
  the port's launcher; the falling-cubes producer runs raw and tiled.
- Every example that places tensors raises without a card unless given
  ``--device cpu``.

Each case runs under a time limit of its own (``SIGALRM``), so a stuck
producer fails its case instead of hanging the suite.
"""

import functools
import importlib.util
import os
import re
import shutil
import signal
import subprocess
import sys
import typing

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "blendjax_torch", "examples")
JAX = os.path.join(ROOT, "examples")
CASE_LIMIT_S = 150


@pytest.fixture(autouse=True)
def _limit_and_fresh_registries():
    """A time limit per case, two torch threads, and the port's
    process-wide registry, lineage and tracer reset around each case (two
    runs in one process would otherwise read the second stream's numbering
    as a restart)."""
    from blendjax_torch.obs import lineage, tracer
    from blendjax_torch.utils.metrics import metrics

    def expired(signum, frame):
        raise TimeoutError(f"example case over its {CASE_LIMIT_S} s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(CASE_LIMIT_S)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    for reg in (metrics, lineage, tracer):
        reg.reset()
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
        torch.set_num_threads(threads)
        for reg in (metrics, lineage, tracer):
            reg.reset()


def load_example(relpath, root=PORT):
    path = os.path.join(root, relpath)
    tag = "port" if root == PORT else "jax"
    name = f"example_{tag}_" + relpath.replace(os.sep, "_").replace(
        "/", "_")[:-3]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_main(monkeypatch, relpath, *argv, root=PORT):
    """``main()`` of an example with its argv; the port's with
    ``--device cpu`` (and argv passed through ``sys.argv`` as a user
    would)."""
    mod = load_example(relpath, root)
    if root == PORT:
        argv = (*argv, "--device", "cpu")
    monkeypatch.setattr(sys, "argv", [os.path.join(root, relpath), *argv])
    return mod.main()


# -- the JAX package's fourteen cases, on the port ----------------------------


def test_minimal(monkeypatch, capsys):
    out = run_main(monkeypatch, "datagen/minimal.py")
    text = capsys.readouterr().out
    assert text.count("batch ") == 5 and "image(8, " in text
    assert "on cpu" in text and len(out["shapes"]) == 5


def test_datagen_train_raw(monkeypatch, capsys):
    out = run_main(
        monkeypatch, "datagen/train.py",
        "--steps", "3", "--instances", "1", "--batch", "8",
        "--shape", "64", "64",
    )
    text = capsys.readouterr().out
    assert "step 0: loss=" in text and "images/sec" in text
    assert out["images"] == 24 and np.isfinite(out["losses"]).all()


def test_datagen_train_tile_chunk_augment(monkeypatch, capsys):
    run_main(
        monkeypatch, "datagen/train.py",
        "--steps", "2", "--instances", "1", "--batch", "8",
        "--shape", "64", "64", "--encoding", "tile", "--chunk", "2",
        "--augment",
    )
    text = capsys.readouterr().out
    assert "step 0: loss=" in text and "images/sec" in text


def test_datagen_train_pal_chunk(monkeypatch, capsys):
    run_main(
        monkeypatch, "datagen/train.py",
        "--steps", "2", "--instances", "1", "--batch", "8",
        "--shape", "64", "64", "--encoding", "pal", "--chunk", "2",
    )
    text = capsys.readouterr().out
    assert "step 0: loss=" in text and "images/sec" in text


def test_datagen_train_echo(monkeypatch, capsys):
    run_main(
        monkeypatch, "datagen/train.py",
        "--steps", "6", "--instances", "1", "--batch", "8",
        "--shape", "64", "64", "--echo", "4", "--echo-capacity", "32",
    )
    text = capsys.readouterr().out
    assert "step 0: loss=" in text and "images/sec" in text
    assert "echo={" in text and "'fresh':" in text
    assert "doctor:" in text


def test_datagen_train_synthetic_fleet(monkeypatch, capsys):
    run_main(
        monkeypatch, "datagen/train.py",
        "--steps", "4", "--batch", "8", "--shape", "32", "32",
        "--synthetic-producers", "1", "--fleet", "1:2",
    )
    text = capsys.readouterr().out
    assert "step 0: loss=" in text and "images/sec" in text
    assert "doctor:" in text
    # the scale-event log prints beside the verdict at exit
    assert "fleet: instances=" in text and "(bounds 1:2)" in text


def test_datagen_train_checkpoint_then_resume(monkeypatch, capsys,
                                              tmp_path):
    ckpt = str(tmp_path / "snapshots")
    run_main(
        monkeypatch, "datagen/train.py",
        "--steps", "4", "--instances", "1", "--batch", "8",
        "--shape", "64", "64", "--checkpoint", ckpt,
        "--checkpoint-every", "2",
    )
    text = capsys.readouterr().out
    assert "checkpoints in" in text and "steps [2, 4]" in text
    run_main(
        monkeypatch, "datagen/train.py",
        "--steps", "2", "--instances", "1", "--batch", "8",
        "--shape", "64", "64", "--checkpoint", ckpt, "--resume",
    )
    text = capsys.readouterr().out
    assert "resumed from snapshot step 4" in text
    assert "images/sec" in text


def test_datagen_train_record_then_replay(monkeypatch, capsys, tmp_path):
    prefix = str(tmp_path / "rec")
    run_main(
        monkeypatch, "datagen/train.py",
        "--steps", "3", "--instances", "1", "--batch", "8",
        "--shape", "64", "64", "--record", prefix,
    )
    assert any(p.name.startswith("rec_") for p in tmp_path.iterdir())
    run_main(
        monkeypatch, "datagen/train.py",
        "--steps", "3", "--batch", "8", "--shape", "64", "64",
        "--replay", prefix,
    )
    text = capsys.readouterr().out
    assert text.count("images/sec") == 2


def test_train_transformer(monkeypatch, capsys):
    out = run_main(
        monkeypatch, "datagen/train_transformer.py",
        "--steps", "2", "--instances", "1", "--batch", "8",
        "--shape", "32", "32", "--patch", "8", "--dim", "32",
        "--depth", "1", "--heads", "2",
    )
    text = capsys.readouterr().out
    assert "step 0: loss=" in text and "images/sec" in text
    assert out["mesh"] == {"data": 1}
    # the example closes the world-1 group it opened
    assert not torch.distributed.is_initialized()


def test_cartpole_controller(capsys):
    pytest.importorskip("gymnasium")  # the example drives gymnasium.make
    mod = load_example("control/cartpole.py")
    mod.main(steps_total=40, argv=[])
    text = capsys.readouterr().out
    assert "final:" in text or "episode end" in text


def test_train_reinforce(monkeypatch, capsys):
    run_main(
        monkeypatch, "control/train_reinforce.py",
        "--iters", "2", "--horizon", "8", "--envs", "2",
    )
    text = capsys.readouterr().out
    assert "iter 0:" in text and "iter 1:" in text


def test_train_dqn(monkeypatch, capsys):
    run_main(
        monkeypatch, "control/train_dqn.py",
        "--steps", "24", "--envs", "2", "--batch", "8",
        "--capacity", "64",
    )
    text = capsys.readouterr().out
    assert "final:" in text and "mean_return=" in text


def test_train_dqn_checkpoint_then_resume(monkeypatch, capsys, tmp_path):
    """The RL resume path end to end at example scale: train with the
    session store armed, then resume and continue to a larger budget."""
    ckpt = str(tmp_path / "rl-ckpt")
    run_main(
        monkeypatch, "control/train_dqn.py",
        "--steps", "16", "--envs", "2", "--batch", "8",
        "--capacity", "64", "--checkpoint", ckpt, "--ckpt-every", "4",
    )
    capsys.readouterr()
    out = run_main(
        monkeypatch, "control/train_dqn.py",
        "--steps", "24", "--envs", "2", "--batch", "8",
        "--capacity", "64", "--checkpoint", ckpt, "--resume",
    )
    text = capsys.readouterr().out
    assert "resumed at step" in text and "final:" in text
    assert out["start"] == 16 and out["steps"] == 24


def test_densityopt(monkeypatch, capsys):
    run_main(
        monkeypatch, "densityopt/densityopt.py",
        "--iters", "2", "--samples", "2", "--instances", "1",
    )
    text = capsys.readouterr().out
    assert "iter 0:" in text and "mu=" in text


# -- every example that places tensors needs a card or --device cpu ------------


@pytest.mark.parametrize("relpath", [
    "datagen/minimal.py", "datagen/train.py", "datagen/train_transformer.py",
    "control/train_reinforce.py", "control/train_dqn.py",
    "densityopt/densityopt.py",
])
def test_an_example_raises_without_a_card(monkeypatch, relpath):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    mod = load_example(relpath)
    monkeypatch.setattr(sys, "argv", [relpath])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main()


# -- recording parity with the JAX example -------------------------------------


LOSS = re.compile(r"step (\d+): loss=([0-9.]+)")


def _f32_models(monkeypatch):
    """Both packages' ``CubeRegressor`` computing in f32, as the examples
    import it (the precision policy's default is bf16)."""
    import jax.numpy as jnp

    import blendjax.models as JM
    import blendjax_torch.models as PM

    class JaxF32(JM.CubeRegressor):
        dtype: typing.Any = jnp.float32

    class PortF32(PM.CubeRegressor):
        def __init__(self, *a, **kw):
            kw.setdefault("dtype", torch.float32)
            super().__init__(*a, **kw)

    monkeypatch.setattr(JM, "CubeRegressor", JaxF32)
    monkeypatch.setattr(PM, "CubeRegressor", PortF32)


def _jax_raw_batches_own_their_buffers(monkeypatch):
    import blendjax.data.batcher as JB

    def owned(fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            b = fn(*a, **kw)
            return None if b is None else {
                k: v.copy() if isinstance(v, np.ndarray) else v
                for k, v in b.items()}
        return wrapper

    monkeypatch.setattr(JB.BatchAssembler, "add",
                        owned(JB.BatchAssembler.add))
    monkeypatch.setattr(JB.BatchAssembler, "flush",
                        owned(JB.BatchAssembler.flush))


@pytest.mark.parametrize("encoding", ["tile", "raw", "pal"])
def test_replayed_losses_match_the_jax_example(monkeypatch, capsys, tmp_path,
                                               encoding):
    from blendjax.obs.lineage import lineage as jax_lineage

    extra = [] if encoding == "raw" else ["--encoding", encoding,
                                          "--chunk", "2"]
    prefix, ck0 = str(tmp_path / "rec"), str(tmp_path / "ck0")
    run_main(monkeypatch, "datagen/train.py", "--steps", "6",
             "--instances", "1", "--batch", "8", "--shape", "64", "64",
             "--record", prefix, "--checkpoint", ck0,
             "--checkpoint-every", "0", *extra, root=JAX)
    capsys.readouterr()
    _f32_models(monkeypatch)
    if encoding == "raw":
        _jax_raw_batches_own_their_buffers(monkeypatch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    losses = {}
    for who, root in (("jax", JAX), ("port", PORT)):
        jax_lineage.reset()
        ck = str(tmp_path / f"ck-{who}")
        shutil.copytree(ck0, ck)
        run_main(monkeypatch, "datagen/train.py", "--steps", "21",
                 "--batch", "8", "--shape", "64", "64", "--replay", prefix,
                 "--checkpoint", ck, "--resume", "--checkpoint-every", "0",
                 *extra, root=root)
        text = capsys.readouterr().out
        assert "resumed from snapshot step 6" in text, text
        losses[who] = LOSS.findall(text)
    assert [s for s, _ in losses["jax"]] == ["0", "10", "20"]
    assert [s for s, _ in losses["port"]] == ["0", "10", "20"]
    np.testing.assert_allclose(
        [float(v) for _, v in losses["port"]],
        [float(v) for _, v in losses["jax"]], rtol=1e-4, atol=2e-5)


# -- the cube producer's encodings against the JAX example's producer -----------


def _stream_frames(script, args, n_frames, seed=4):
    """The first ``n_frames`` frames one launched cube producer sends,
    through the port's pipeline on the CPU (batches of 4), in order. The
    feeder places two batches ahead: the producer must send two batches
    more than are read."""
    from blendjax_torch.data import StreamDataPipeline
    from blendjax_torch.launcher import PythonProducerLauncher
    from blendjax_torch.obs import lineage

    lineage.reset()
    with PythonProducerLauncher(script=script, num_instances=1,
                                named_sockets=["DATA"], seed=seed,
                                instance_args=[args]) as launcher:
        with StreamDataPipeline(launcher.addresses["DATA"], batch_size=4,
                                device="cpu", timeoutms=60_000) as pipe:
            got = {"image": [], "xy": [], "frameid": []}
            for batch in pipe:
                for k in got:
                    got[k].append(batch[k].numpy())
                if sum(len(f) for f in got["frameid"]) >= n_frames:
                    break
    return {k: np.concatenate(v)[:n_frames] for k, v in got.items()}


@pytest.mark.parametrize("encoding,batch", [
    ("raw", 1), ("raw", 4), ("tile", 4), ("pal", 4)])
def test_cube_producer_sends_the_jax_producers_frames(encoding, batch):
    args = ["--shape", "48", "64", "--frames", "12", "--batch", str(batch)]
    if encoding != "raw":
        args += ["--encoding", encoding]
    port = _stream_frames(os.path.join(PORT, "datagen", "cube_producer.py"),
                          args + ["--log", os.devnull], 8)
    ref = _stream_frames(os.path.join(JAX, "datagen", "cube_producer.py"),
                         args, 8)
    np.testing.assert_array_equal(port["frameid"], np.arange(1, 9))
    np.testing.assert_array_equal(port["frameid"], ref["frameid"])
    np.testing.assert_array_equal(port["image"], ref["image"])
    np.testing.assert_array_equal(port["xy"], ref["xy"])


def test_cube_producer_takes_every_flag_of_the_reference():
    from blendjax_torch.producer.cube import parse_args

    opts = parse_args([])
    assert (opts.encoding, opts.batch, opts.trace_every) == ("raw", 1, 64)
    opts = parse_args(["--encoding", "pal", "--batch", "8",
                       "--trace-every", "0", "--tile", "16",
                       "--tile-rgba", "--ref-interval", "0",
                       "--tile-capacity", "32", "--frames", "9"])
    assert (opts.encoding, opts.batch, opts.trace_every) == ("pal", 8, 0)
    for bad in (["--encoding", "tile"], ["--encoding", "pal"]):
        with pytest.raises(SystemExit):
            parse_args(bad)  # tile and pal need --batch > 1


@pytest.mark.parametrize("encoding", ["raw", "tile"])
def test_falling_cubes_producer_streams(encoding):
    from blendjax_torch.data import StreamDataPipeline
    from blendjax_torch.launcher import PythonProducerLauncher

    script = os.path.join(PORT, "datagen", "falling_cubes_producer.py")
    args = ["--shape", "64", "96", "--num-cubes", "3",
            "--episode-frames", "20", "--encoding", encoding,
            "--batch", "4"]
    with PythonProducerLauncher(script=script, num_instances=1,
                                named_sockets=["DATA"], seed=3,
                                instance_args=[args]) as launcher:
        with StreamDataPipeline(launcher.addresses["DATA"], batch_size=4,
                                device="cpu", timeoutms=60_000) as pipe:
            batch = next(iter(pipe))
    assert tuple(batch["image"].shape) == (4, 64, 96, 4)
    assert tuple(batch["xy"].shape) == (4, 3, 2)  # one point per cube
    assert torch.isfinite(batch["xy"]).all()


# -- the Blender scene scripts under the fake Blender ----------------------------


@pytest.fixture(scope="module")
def fake_dir(tmp_path_factory):
    if sys.platform == "win32":  # pragma: no cover
        pytest.skip("the fake blender wrapper is a POSIX shell script")
    from blendjax.testing import write_fake_blender

    d = str(tmp_path_factory.mktemp("fake-blender-bin"))
    write_fake_blender(d)
    return d


def _blender(fake_dir, relpath, background=True, **kw):
    from blendjax_torch.launcher import BlenderLauncher

    return BlenderLauncher(script=os.path.join(PORT, relpath),
                           background=background, blend_path=[fake_dir], **kw)


def _messages(launcher, n, socket="DATA"):
    from blendjax_torch.data import RemoteStream

    return list(RemoteStream(launcher.addresses[socket], timeoutms=60_000,
                             max_items=n))


def test_cube_scene_streams_annotations_in_the_background(fake_dir):
    with _blender(fake_dir, "datagen/cube.blend.py", num_instances=1,
                  named_sockets=["DATA"], seed=7) as launcher:
        msgs = _messages(launcher, 5)
    for m in msgs:
        assert m["xy"].shape == (8, 2) and m["xy"].dtype == np.float32
        assert np.isfinite(m["xy"]).all()
        assert "image" not in m  # offscreen needs the UI, as in Blender


def test_cube_scene_renders_frames_with_the_ui(fake_dir):
    from blendjax.testing.fake_gpu import BACKGROUND

    with _blender(fake_dir, "datagen/cube.blend.py", background=False,
                  num_instances=1, named_sockets=["DATA"],
                  seed=7) as launcher:
        msgs = _messages(launcher, 3)
    for m in msgs:
        img = m["image"]
        assert img.ndim == 3 and img.shape[-1] == 3  # mode="rgb"
        splats = np.argwhere((img != np.array(BACKGROUND[:3])).any(-1))
        assert len(splats) >= 1
        for y, x in splats:  # every splat sits near a published corner
            d = np.abs(m["xy"] - np.array([x, y])).max(axis=1)
            assert d.min() < 3.0, f"splat ({y},{x}) far from xy"


def test_supershape_scene_round_trips_shape_ids(fake_dir):
    from blendjax_torch.transport import PairChannel

    with _blender(fake_dir, "densityopt/supershape.blend.py",
                  num_instances=1, named_sockets=["DATA", "CTRL"],
                  seed=0) as launcher:
        duplex = PairChannel(launcher.addresses["CTRL"][0], btid=99,
                             bind=False)
        try:
            params = np.tile(np.array([7.0, 1, 1, 3, 3, 3], np.float64),
                             (2, 2, 1))
            duplex.send(shape_params=params, shape_ids=np.array([11, 22]))
            got = [int(m["shape_id"]) for m in _messages(launcher, 2)]
        finally:
            duplex.close()
    assert got == [11, 22]


def test_cartpole_scene_serves_the_gym_rpc(fake_dir):
    from blendjax_torch.env.remote import RemoteEnv

    with _blender(fake_dir, "control/cartpole.blend.py", num_instances=1,
                  named_sockets=["GYM"], seed=0) as launcher:
        env = RemoteEnv(launcher.addresses["GYM"][0], timeoutms=60_000)
        try:
            obs, _info = env.reset()
            cart_x, _pole_x, angle = obs
            assert abs(cart_x) < 1e-6 and abs(angle) <= 0.6
            done, steps = False, 0
            while not done and steps < 400:
                obs, _reward, done, _info = env.step(30.0)  # push right
                steps += 1
            assert done and 1 <= steps < 400
            cart_x, _, angle = obs
            assert cart_x > 0.0 or abs(angle) > 0.6
        finally:
            env.close()


def test_falling_cubes_scene_falls(fake_dir):
    with _blender(fake_dir, "datagen/falling_cubes.blend.py",
                  num_instances=1, named_sockets=["DATA"],
                  seed=3) as launcher:
        msgs = _messages(launcher, 12)
    by_frame = sorted(msgs, key=lambda m: int(m["frameid"]))
    for m in by_frame:
        assert m["xy"].shape == (8 * 8, 2)  # 8 cubes x 8 corners
        assert np.isfinite(m["xy"]).all()
    # falling cubes: the mean screen y (upper-left origin) increases
    assert by_frame[-1]["xy"][:, 1].mean() > by_frame[0]["xy"][:, 1].mean()


# -- the mesh path of train.py under torchrun -------------------------------------


def test_train_replays_on_a_two_rank_mesh_under_torchrun(tmp_path):
    """``torchrun --nproc_per_node 2`` on gloo: each rank builds the mesh
    ``{"data": 2}`` from the environment and trains its rows of every
    replayed global batch with the mesh step; both ranks print the same
    (global) losses."""
    from blendjax_torch.data import FileRecorder
    from blendjax_torch.transport import encode_message

    rng = np.random.default_rng(0)
    prefix = str(tmp_path / "rec")
    with FileRecorder(f"{prefix}_00.bjr") as rec:
        for i in range(32):
            rec.save(encode_message({
                "btid": 0, "_seq": i, "frameid": np.int64(i),
                "image": rng.integers(0, 256, (32, 32, 4), np.uint8),
                "xy": (rng.random((8, 2)) * 32).astype(np.float32)}))
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    logs = tmp_path / "logs"
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "--log_dir", str(logs), "--redirects",
         "3", "-m", "blendjax_torch.examples.datagen.train", "--device",
         "cpu", "--replay", prefix, "--steps", "11", "--batch", "8",
         "--shape", "32", "32"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert r.returncode == 0, (r.stdout + r.stderr)[-4000:]
    outs = sorted(str(p.read_text()) for p in logs.rglob("stdout.log"))
    assert len(outs) == 2, outs
    per_rank = [LOSS.findall(t) for t in outs]
    assert [s for s, _ in per_rank[0]] == ["0", "10"]
    assert per_rank[0] == per_rank[1]
    assert all("images/sec" in t for t in outs)
