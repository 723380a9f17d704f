"""``datagen/train.py``'s snapshots on a mesh of two ranks (CPU, gloo).

The ranks (``torch_dist_ranks.py``) run the port's example in process on
the mesh ``{"data": 2}``, with the model in f32 and TF32 off, over a
recording of 10 global batches that the replay loops: an uninterrupted run
of 30 steps with a snapshot every 10, then a resume from the step-10
snapshot for 20 steps, which meets the batches the uninterrupted run met
after it. Rank 0 alone writes; the session holds every rank's.

- The world-2 resume reproduces the uninterrupted run's losses bit for bit
  (same code, same batches, same state).
- The same snapshot resumed on one card gives those losses within rtol
  1e-5 (the mesh's gradient mean sums in another order).
- The JAX example resumes the port's world-2 snapshot on its 8-device CPU
  mesh (``tests/conftest.py``) to the same losses within the bars of
  ``test_replayed_losses_match_the_jax_example`` (rtol 1e-4, atol 2e-5),
  reading rank 0's components where a one-card session keeps them (its
  raw batches copied out of the assembler's pool, as there: Queue C,
  C10).
- A breach raised on rank 1 alone gives one snapshot, taken by both ranks
  at the same step; the harness's deadline fails the test if a rank hangs.
"""

import re
import shutil
import sys

import numpy as np
import pytest

import torch_dist_ranks as W
from test_torch_examples import (
    JAX,
    _f32_models,
    _jax_raw_batches_own_their_buffers,
    run_main,
)

LOSS = re.compile(r"step (\d+): loss=([0-9.]+)")
EVERY = 10


def write_frames(path, n, seed=0, hw=32):
    """``n`` raw per-frame messages (``btid`` 0) in one ``.bjr`` file."""
    from blendjax_torch.data import FileRecorder
    from blendjax_torch.transport import encode_message

    rng = np.random.default_rng(seed)
    with FileRecorder(path) as rec:
        for i in range(n):
            rec.save(encode_message({
                "btid": 0, "_seq": i, "frameid": np.int64(i),
                "image": rng.integers(0, 256, (hw, hw, 4), np.uint8),
                "xy": (rng.random((8, 2)) * hw).astype(np.float32)}))


@pytest.fixture(scope="module")
def flows(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh-ckpt")
    prefix = str(tmp / "rec")
    write_frames(f"{prefix}_00.bjr", EVERY * 8)
    base = ["--batch", "8", "--shape", "32", "32", "--replay", prefix]
    out = W.run_worlds({2: [
        ("checkpoint_flow", {"prefix": prefix, "tmp": str(tmp),
                             "every": EVERY}),
        ("example_breach", {"argv": base + [
            "--steps", "12", "--slo", "rate(ingest.items) >= 0",
            "--checkpoint", str(tmp / "ck-breach"),
            "--checkpoint-every", "0"]}),
    ]}, str(tmp / "ranks"), timeout=120)[2]
    for rank in out:
        for name, res in rank.items():
            assert "error" not in res, f"{name}: {res.get('error')}"
    return {"ranks": out, "prefix": prefix, "tmp": tmp}


def _global(res, steps, steps_from=0):
    """``{global step: loss}`` of a run of ``steps``: its printed steps
    (every 10th) and its last update, numbered from ``steps_from``."""
    out = {steps_from + 10 * i: v for i, v in enumerate(res["losses"])}
    out[steps_from + steps - 1] = res["last_loss"]
    return out


def test_a_two_rank_resume_continues_the_uninterrupted_run(flows):
    for rank in flows["ranks"]:
        full, resumed = (rank["checkpoint_flow"][k] for k in ("full",
                                                              "resumed"))
        assert "resumed from snapshot step 10 (saved by 2 ranks)" in (
            resumed["text"])
        want = _global(full, 30)
        got = _global(resumed, 20, steps_from=EVERY)
        assert sorted(got) == [10, 20, 29]
        assert {k: want[k] for k in got} == got  # bit for bit
    assert flows["ranks"][0]["checkpoint_flow"]["full"]["checkpoint"][
        "steps"] == [10, 20, 30]


def test_the_snapshot_keeps_every_ranks_session(flows):
    from blendjax_torch.checkpoint import (
        SnapshotManager,
        rank_session,
        restore_session,
    )
    from blendjax_torch.obs.lineage import FrameLineage

    first = flows["ranks"][0]["checkpoint_flow"]["first"]
    session = SnapshotManager(first, read_only=True).restore().session
    assert session["mesh"]["world_size"] == 2
    assert session["driver"]["steps"] == EVERY
    mine, world = rank_session(session, 1)
    assert world == 2 and mine["driver"] == session["driver"]
    assert "lineage" in mine and "mesh" not in mine
    # a rank the saved run did not have keeps the shared slices alone
    assert set(rank_session(session, 2)[0]) <= {"driver", "_version",
                                                "_wall_time"}
    # strict=False passes the extra key by, in both packages
    from blendjax.checkpoint import restore_session as jax_restore
    from blendjax.obs.lineage import FrameLineage as JaxLineage

    assert restore_session(session, lineage=FrameLineage()) == ["lineage"]
    assert jax_restore(session, lineage=JaxLineage()) == ["lineage"]


def test_the_two_rank_snapshot_resumes_on_one_card(flows, monkeypatch,
                                                   capsys, tmp_path):
    import torch

    base = flows["ranks"][0]["checkpoint_flow"]
    ck = str(tmp_path / "ck")
    shutil.copytree(base["first"], ck)
    _f32_models(monkeypatch)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    out = run_main(monkeypatch, "datagen/train.py", "--batch", "8",
                   "--shape", "32", "32", "--replay", flows["prefix"],
                   "--steps", "20", "--checkpoint", ck, "--resume",
                   "--checkpoint-every", "0")
    text = capsys.readouterr().out
    assert "resumed from snapshot step 10 (saved by 2 ranks)" in text
    got = _global(out, 20, steps_from=EVERY)
    want = _global(base["resumed"], 20, steps_from=EVERY)
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose([got[k] for k in sorted(got)],
                               [want[k] for k in sorted(want)], rtol=1e-5)


def test_the_jax_example_resumes_the_two_rank_snapshot(flows, monkeypatch,
                                                       capsys, tmp_path):
    from blendjax.obs.lineage import lineage as jax_lineage

    ck = str(tmp_path / "ck")
    shutil.copytree(flows["ranks"][0]["checkpoint_flow"]["first"], ck)
    _f32_models(monkeypatch)
    _jax_raw_batches_own_their_buffers(monkeypatch)
    jax_lineage.reset()
    run_main(monkeypatch, "datagen/train.py", "--batch", "8", "--shape",
             "32", "32", "--replay", flows["prefix"], "--steps", "11",
             "--checkpoint", ck, "--resume", "--checkpoint-every", "0",
             root=JAX)
    text = capsys.readouterr().out
    assert "resumed from snapshot step 10" in text, text
    jax = {EVERY + 10 * i: float(v)
           for i, (_s, v) in enumerate(LOSS.findall(text))}
    port = _global(flows["ranks"][0]["checkpoint_flow"]["resumed"], 20,
                   steps_from=EVERY)
    assert sorted(jax) == [10, 20]
    np.testing.assert_allclose([jax[k] for k in (10, 20)],
                               [port[k] for k in (10, 20)],
                               rtol=1e-4, atol=2e-5)


def test_a_breach_on_one_rank_snapshots_both_at_one_step(flows):
    from blendjax_torch.checkpoint import SnapshotManager

    r0, r1 = (r["example_breach"] for r in flows["ranks"])
    steps = r0["checkpoint"]["steps"]
    # the breach's snapshot, then the exit snapshot
    assert len(steps) == 2 and 1 <= steps[0] < 12 and steps[1] == 12
    assert r1["checkpoint"]["saves"] == 0  # rank 0 alone writes
    mgr = SnapshotManager(str(flows["tmp"] / "ck-breach"), read_only=True)
    session = mgr.restore(step=steps[0]).session
    assert session["driver"]["steps"] == steps[0]
    assert session["mesh"]["world_size"] == 2
    assert r0["last_loss"] == r1["last_loss"]


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
