"""``datagen/train.py --record`` / ``--replay`` and ``minimal.py`` on a mesh
of two ranks (CPU, gloo).

- Each rank of a live world-2 run (one cube producer of its own, raw 32x32
  frames) records its own stream under its rank-tagged prefix
  (``{prefix}.rank{r}-of-2``), so no two ranks write one file.
- A world-2 ``--replay`` gives each rank the rows it trained live: the
  losses equal the live run's bit for bit.
- On one card the same prefix assembles the global batches, rank 0's rows
  then rank 1's: bit-equal images and labels, and losses within rtol 1e-5
  of the world-2 replay's (f32, TF32 off; the mesh sums its gradient mean
  in another order).
- The fused path: a world-2 ``--encoding tile --inflight 1`` replay of
  rank-tagged tile recordings (each rank's packed groups hold its own
  rows, marked ``_local_rows``, which the mesh fused step decodes whole)
  trains the one-card replay's losses within rtol 1e-5.
- At world 3 the replay of a world-2 recording raises, naming 2.
- ``minimal.py`` under ``torchrun --nproc_per_node 2`` prints 4 rows of
  each global batch of 8 on each rank.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import torch_dist_ranks as W
from test_torch_examples import ROOT, _f32_models, run_main
from test_torch_mesh_examples import write_frames

ARGV = ["--batch", "8", "--shape", "32", "32", "--steps", "11"]
TILE = ["--batch", "8", "--shape", "32", "32", "--steps", "6", "--encoding",
        "tile", "--chunk", "2", "--inflight", "1", "--sync-every", "1"]


def write_tile_ranks(prefix):
    """Two ranks' tile recordings (4 rows a message, each rank its own
    labels), under their rank-tagged prefixes."""
    from blendjax_torch.data import FileRecorder
    from blendjax_torch.data.replay import rank_prefix
    from blendjax_torch.transport import encode_message

    for r in range(2):
        with FileRecorder(f"{rank_prefix(prefix, r, 2)}_00.bjr") as rec:
            for m in W.tile_messages(8, batch=4):
                m["xy"] = m["xy"] + 3.0 * r
                rec.save(encode_message(m))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from blendjax_torch.data.replay import rank_prefix

    tmp = tmp_path_factory.mktemp("mesh-record")
    prefix, other = str(tmp / "live"), str(tmp / "two")
    tiles = str(tmp / "tiles")
    for r in range(2):
        write_frames(f"{rank_prefix(other, r, 2)}_00.bjr", 16, seed=r)
    write_tile_ranks(tiles)
    out = W.run_worlds({
        2: [("example:live", {"argv": ARGV + ["--instances", "1",
                                              "--record", prefix]}),
            ("example:replay", {"argv": ARGV + ["--replay", prefix]}),
            ("recorded_rows", {"prefix": prefix}),
            ("example:tile", {"argv": TILE + ["--replay", tiles]})],
        3: [("replay_refusal", {"prefix": other})],
    }, str(tmp / "ranks"), timeout=120)
    for world in out.values():
        for rank in world:
            for name, res in rank.items():
                assert "error" not in res, f"{name}: {res.get('error')}"
    return {"two": out[2], "three": out[3], "prefix": prefix, "tmp": tmp,
            "tiles": tiles}


def test_each_rank_records_a_stream_of_its_own(runs):
    names = sorted(p.name for p in runs["tmp"].iterdir()
                   if p.name.startswith("live"))
    assert names == ["live.rank0-of-2_00.bjr", "live.rank1-of-2_00.bjr"]
    from blendjax_torch.data.replay import recorded_world

    assert recorded_world(runs["prefix"]) == 2


def test_a_two_rank_replay_reproduces_the_live_losses(runs):
    for rank in runs["two"]:
        live, replay = rank["example:live"], rank["example:replay"]
        assert len(live["losses"]) == 2 and np.isfinite(live["last_loss"])
        assert live["seq_gaps"] == 0
        assert (replay["losses"], replay["last_loss"]) == (
            live["losses"], live["last_loss"])  # bit for bit
    r0, r1 = (r["example:live"] for r in runs["two"])
    assert (r0["losses"], r0["last_loss"]) == (r1["losses"], r1["last_loss"])


def test_the_replayed_rows_are_the_live_ones_on_one_card(runs, monkeypatch,
                                                         capsys):
    from blendjax_torch.data import StreamDataPipeline

    ranks = [r["recorded_rows"] for r in runs["two"]]
    assert all(r["local"] and r["rank_batch"] == 4 for r in ranks)
    with StreamDataPipeline.from_recording(runs["prefix"], batch_size=8,
                                           device="cpu") as pipe:
        whole = [b for _, b in zip(range(4), pipe)]
    for i, b in enumerate(whole):
        for k in ("image", "xy"):
            joined = np.concatenate([r["rows"][i][k] for r in ranks])
            np.testing.assert_array_equal(b[k].numpy(), joined)
    import torch

    _f32_models(monkeypatch)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    out = run_main(monkeypatch, "datagen/train.py", *ARGV, "--replay",
                   runs["prefix"])
    capsys.readouterr()
    two = runs["two"][0]["example:replay"]
    np.testing.assert_allclose([*out["losses"], out["last_loss"]],
                               [*two["losses"], two["last_loss"]],
                               rtol=1e-5)


def test_a_two_rank_tile_replay_decodes_each_ranks_own_rows(runs,
                                                             monkeypatch,
                                                             capsys):
    import torch

    r0, r1 = (r["example:tile"] for r in runs["two"])
    assert r0["driver_losses"] == r1["driver_losses"]
    assert len(r0["driver_losses"]) == 6
    _f32_models(monkeypatch)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    out = run_main(monkeypatch, "datagen/train.py", *TILE, "--replay",
                   runs["tiles"])
    capsys.readouterr()
    np.testing.assert_allclose(out["driver"].losses, r0["driver_losses"],
                               rtol=1e-5)


def test_a_replay_at_another_world_size_names_the_recorded_one(runs):
    for rank in runs["three"]:
        msg = rank["replay_refusal"]["raised"]
        assert msg and "recorded on a mesh of 2 data ranks" in msg


def test_minimal_splits_each_batch_under_torchrun(tmp_path):
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    logs = tmp_path / "logs"
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "--log_dir", str(logs), "--redirects",
         "3", "-m", "blendjax_torch.examples.datagen.minimal", "--device",
         "cpu"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert r.returncode == 0, (r.stdout + r.stderr)[-4000:]
    outs = sorted(str(p.read_text()) for p in logs.rglob("stdout.log"))
    assert len(outs) == 2, outs
    for text in outs:
        assert text.count("batch ") == 5 and text.count("image(4, ") == 5


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
