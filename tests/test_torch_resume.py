"""Kill -9 and SIGTERM resume of a blendjax_torch training process, and
the echo pipeline's bitwise continuation, on the CPU.

The worker is this file run as a script (``python tests/test_torch_resume.py
DIR --steps N ...``; it imports torch and blendjax_torch only). It trains
a small CubeRegressor (float32, a seeded colour-jitter augmentation) on a
deterministic message stream through ``StreamDataPipeline`` and a
``TrainDriver.build(resume=..., checkpoint=SnapshotManager(DIR),
checkpoint_every=2)``, and writes its per-step losses to ``--out``:

- uninterrupted: the reference trajectory;
- killed: ``--pace`` slows it so the parent sees a committed snapshot and
  sends SIGKILL mid-run (no handler, no flush);
- ``--resume``: restores the newest snapshot before the step set is built,
  skips the messages the snapshot consumed, and trains to ``--steps``.

Acceptance: the resumed losses EQUAL the uninterrupted ones (``==`` on the
float lists: the same program on the same inputs). With ``--preempt`` a
:class:`PreemptionGuard` turns SIGTERM into a drain, a committed snapshot
and :class:`PreemptionRequested` (exit code 0), and the resume from it is
equal too. Every subprocess wait has a timeout.
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np

B = 4
HW = 16
SEED = 7
HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(HERE))


def _messages(n, skip=0):
    """The same message sequence every call: resuming regenerates it and
    skips the consumed prefix, as a replay fast-forwards."""
    rng = np.random.default_rng(SEED)
    for i in range(n):
        msg = {"_prebatched": True, "btid": 0,
               "image": rng.integers(0, 255, (B, HW, HW, 4), np.uint8),
               "xy": (rng.random((B, 8, 2)) * HW).astype(np.float32)}
        if i >= skip:
            yield msg


def worker(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("directory")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--ckpt-every", type=int, default=2)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--preempt", action="store_true")
    ap.add_argument("--pace", type=float, default=0.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from blendjax_torch.checkpoint import (
        PreemptionGuard,
        PreemptionRequested,
        SnapshotManager,
    )
    from blendjax_torch.data import StreamDataPipeline
    from blendjax_torch.models import CubeRegressor
    from blendjax_torch.ops.augment import color_jitter, make_augment
    from blendjax_torch.train import TrainDriver

    torch.set_num_threads(1)
    mgr = SnapshotManager(args.directory, keep=3)
    example = next(_messages(1))
    drv = TrainDriver.build(
        CubeRegressor(features=(8,), dtype=torch.float32),
        {k: torch.from_numpy(example[k]) for k in ("image", "xy")},
        rng=0, device="cpu", precision="f32", resume=args.resume,
        augment=make_augment(color_jitter), augment_rng=5,
        checkpoint=mgr, checkpoint_every=args.ckpt_every, inflight=2,
        sync_every=1,
    )
    if args.resume:
        assert drv.resumed_session is not None, "no snapshot to resume"
    guard = PreemptionGuard(drv) if args.preempt else None
    start = drv.steps
    preempted = None
    print(f"worker started at {start}", flush=True)
    try:
        with StreamDataPipeline(_messages(args.steps, skip=start),
                                batch_size=B, device="cpu") as pipe:
            for batch in pipe:
                drv.submit({k: batch[k] for k in ("image", "xy")})
                if args.pace:
                    time.sleep(args.pace)
        drv.finish()
    except PreemptionRequested as e:
        preempted = str(e)
    finally:
        if guard is not None:
            guard.uninstall()
    mgr.close()
    result = {"losses": drv.losses, "start": start, "steps": drv.steps,
              "checkpoints": drv.checkpoints, "preempted": preempted}
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(result, f)
    print("worker done", json.dumps({k: result[k] for k in (
        "start", "steps", "checkpoints", "preempted")}), flush=True)
    return 0


# -- the tests ------------------------------------------------------------------


def _env():
    return dict(os.environ, PYTHONPATH=REPO)


def _run(args, timeout=300):
    proc = subprocess.run([sys.executable, HERE, *args], env=_env(),
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=timeout, cwd=REPO)
    assert proc.returncode == 0, proc.stdout
    return proc.stdout


def _losses(path):
    with open(path) as f:
        return json.load(f)


def _wait_committed(directory, timeout=120):
    from blendjax_torch.checkpoint import committed_steps

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if committed_steps(directory):
            return True
        time.sleep(0.05)
    return False


def _interrupted(directory, steps, sig, extra=()):
    """A paced worker, sent ``sig`` after its first commit; returns its
    return code and output."""
    proc = subprocess.Popen(
        [sys.executable, HERE, directory, "--steps", str(steps),
         "--pace", "0.4", *extra],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, cwd=REPO)
    try:
        assert _wait_committed(directory), (
            "no committed snapshot before the timeout:\n"
            + proc.communicate(timeout=30)[0])
        os.kill(proc.pid, sig)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    return proc.returncode, out


def test_kill9_resume_single_device_trajectory_identical(tmp_path):
    steps = 10
    ref = tmp_path / "ref.json"
    _run([str(tmp_path / "ref"), "--steps", str(steps), "--out", str(ref)])
    kill_dir = str(tmp_path / "kill")
    rc, out = _interrupted(kill_dir, steps, signal.SIGKILL)
    assert rc == -signal.SIGKILL, f"not killed mid-run (rc={rc}):\n{out}"
    res = tmp_path / "res.json"
    out = _run([kill_dir, "--steps", str(steps), "--resume", "--out",
                str(res)])
    want, got = _losses(ref), _losses(res)
    assert 0 < got["start"] < steps, out
    assert len(want["losses"]) == len(got["losses"]) == steps
    assert got["losses"] == want["losses"]  # identical, not close


def test_sigterm_drains_snapshots_and_raises_preemption(tmp_path):
    """SIGTERM: the guard's flag makes the next submit drain the ring,
    commit a snapshot of the step reached and raise PreemptionRequested
    (the worker exits 0); the resume from that snapshot continues the
    uninterrupted trajectory exactly."""
    from blendjax_torch.checkpoint import committed_steps

    steps = 10
    ref = tmp_path / "ref.json"
    _run([str(tmp_path / "ref"), "--steps", str(steps), "--out", str(ref)])
    d = str(tmp_path / "term")
    out_file = tmp_path / "term.json"
    rc, out = _interrupted(d, steps, signal.SIGTERM,
                           ("--preempt", "--out", str(out_file)))
    assert rc == 0, out
    term = _losses(out_file)
    assert term["preempted"] and "snapshot committed" in term["preempted"]
    assert term["steps"] < steps
    assert committed_steps(d)[-1] == term["steps"]
    res = tmp_path / "res.json"
    _run([d, "--steps", str(steps), "--resume", "--out", str(res)])
    got = _losses(res)
    assert got["start"] == term["steps"]
    assert got["losses"] == _losses(ref)["losses"]


# -- the echo pipeline's state --------------------------------------------------


def _decoded_batches(n, seed=3):
    rng = np.random.default_rng(seed)
    for i in range(n):
        yield {"image": rng.integers(0, 255, (B, HW, HW, 4), np.uint8),
               "xy": (rng.random((B, 8, 2)) * HW).astype(np.float32),
               "frameid": np.arange(i * B, (i + 1) * B)}


def _echo(source, rng=1):
    from blendjax_torch.data import EchoingPipeline

    return EchoingPipeline(source, capacity=12, max_echo_factor=3,
                           batch_size=B, rng=rng, device="cpu",
                           min_fresh_fraction=0.25)


def _draw_key(d):
    return (d["image"].numpy().tobytes(), d["frameid"].numpy().tobytes())


def test_echo_state_dict_continues_bitwise():
    """An echo run snapshotted once its stream is fully inserted (through
    the session codec, as a snapshot writes it) and restored into a fresh
    pipeline of the same seed draws exactly what the uninterrupted run
    draws next: the same slots, the same augmentation (the draw counter
    and the host generator's PCG64 words travel), the same accounting."""
    from blendjax_torch.checkpoint import pack_session, unpack_session

    a = _echo(iter(list(_decoded_batches(4))), rng=5)
    it = iter(a)
    deadline = time.monotonic() + 30
    while not (a._inner_done and a._queue.empty()):
        next(it)
        assert time.monotonic() < deadline
    raw = a.state_dict()
    use = raw["use"].copy()
    doc = unpack_session(pack_session({"echo": raw}))["echo"]
    cont = [_draw_key(next(it)) for _ in range(3)]
    assert np.array_equal(raw["use"], use)  # a copy, not the live array
    b = _echo(iter(()), rng=5)
    b.load_state_dict(doc)
    itb = iter(b)
    resumed = [_draw_key(next(itb)) for _ in range(3)]
    assert resumed == cont
    assert (b.steps, b.fresh, b.echoed) == (a.steps, a.fresh, a.echoed)
    with pytest.raises(RuntimeError, match="before iteration"):
        b.load_state_dict(doc)  # iterating: the drain thread runs
    a.stop()
    b.stop()


def test_reservoir_state_dict_continues_bitwise():
    """A reservoir restored from its state_dict (ring, cursor, draw
    counter) samples and inserts exactly as the original goes on to."""
    from blendjax_torch.data import SampleReservoir, default_echo_augment
    from blendjax_torch.checkpoint import pack_session, unpack_session

    batches = list(_decoded_batches(4))
    a = SampleReservoir(8, augment=default_echo_augment(), rng=3,
                        device="cpu")
    for b in batches[:3]:
        a.insert({k: b[k] for k in ("image", "xy")})
    a.sample(np.array([0, 5, 2, 7]))
    doc = unpack_session(pack_session({"r": a.state_dict()}))["r"]
    b_ = SampleReservoir(8, augment=default_echo_augment(), rng=3,
                         device="cpu")
    b_.load_state_dict(doc)
    for res in (a, b_):
        res.insert({k: batches[3][k] for k in ("image", "xy")})
    for idx in ([1, 2, 3, 4], [7, 7, 0, 6]):
        x, y = a.sample(np.array(idx)), b_.sample(np.array(idx))
        for k in x:
            assert torch.equal(x[k], y[k]), k
    with pytest.raises(ValueError, match="capacity"):
        SampleReservoir(4, device="cpu").load_state_dict(doc)


import pytest  # noqa: E402  (the worker above runs without pytest)
import torch  # noqa: E402

if __name__ == "__main__":
    sys.exit(worker())
