"""Whole runs of the harness on the CPU at a tiny size: the harness's look
for a card skipped (``run.run(device="cpu")``), everything else as on the
card; and the same run with the timed path broken underneath, which has to
read ``correct`` false."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import run as R
from portbench.cell import ROOT
from portbench.tests.tiny import tiny_cell

SEED = 2 ** 31 + 11  # wider than 32 signed bits, as a run's seed may be
CELLS = ["vit_b16.live2", "cube_regressor.replay"]
REQUIRED = ("correct", "attempted", "failed", "metrics", "device")


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_the_result_line(workload, trace):
    cell = tiny_cell(workload)
    out = R.run(cell, SEED, 1.5, bool(trace), device="cpu")
    keys = list(out)
    assert keys[:5] == list(REQUIRED)
    assert keys[-1] == "checks"
    assert set(keys) == set(REQUIRED) | {"checks"} | (
        {"breakdown"} if trace else set())
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    wanted = cell.per_layer if trace else cell.end_to_end
    names = {m["name"] for m in wanted}
    assert set(out["metrics"]) <= names
    if not trace:  # every end-to-end metric of the cell, with its unit
        assert set(out["metrics"]) == names
        units = {m["name"]: m["unit"] for m in wanted}
        assert all(v["unit"] == units[k] for k, v in out["metrics"].items())
    for c in out["checks"].values():
        assert c["value"] < c["limit"]
    json.dumps(out, allow_nan=False)


def _faulty(monkeypatch, fault: str):
    """Break the port's fused step underneath the harness."""
    from blendjax_torch.ops import tiles
    from blendjax_torch.train import steps

    if fault == "state_unchanged":
        def no_update(state, batch, loss_fn, policy, accum_steps=1,
                      sharding=None):
            loss, _grads = steps._grads(state, batch, loss_fn, policy,
                                        accum_steps)
            return loss
        monkeypatch.setattr(steps, "_update", no_update)
        return
    decode = tiles.decode_packed_group

    def broken(group, *args, **kwargs):
        fields = decode(group, *args, **kwargs)
        if fault == "half_batch":  # the mean over the first half alone
            half = fields["image"].shape[1] // 2
            return {k: v[:, :half] for k, v in fields.items()}
        if fault == "later_updates_on_the_first_batch":  # K > 1 alone
            return {k: v[:1].expand_as(v).clone() for k, v in fields.items()}
        # the decode's answer altered where it is produced: inverted frames
        return {**fields, "image": 255 - fields["image"]}
    monkeypatch.setattr(tiles, "decode_packed_group", broken)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "frames_altered",
                                   "later_updates_on_the_first_batch"])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_step_reads_not_correct(workload, fault, monkeypatch):
    _faulty(monkeypatch, fault)
    out = R.run(tiny_cell(workload), SEED, 0.5, False, device="cpu")
    assert out["correct"] is False
    assert any(c["value"] is None or c["value"] > c["limit"]
               for c in out["checks"].values())


def test_without_a_card_the_command_prints_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "cube_regressor.replay", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""


NO_JAX = """
import sys
from portbench import run as R
from portbench.tests.tiny import tiny_cell
for workload in {cells!r}:
    R.run(tiny_cell(workload), 5, 0.5, True, device="cpu")
print(" ".join(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def test_a_run_loads_no_module_of_jax_or_the_jax_package():
    proc = subprocess.run(
        [sys.executable, "-c", NO_JAX.format(cells=CELLS)], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    tops = set(proc.stdout.split()[-1000:])
    assert "blendjax_torch" in tops and "portbench" in tops
    assert not tops & set(R.FORBIDDEN), tops & set(R.FORBIDDEN)
    assert R.forbidden_modules() == [] or "blendjax" in sys.modules


def test_the_card_runs_each_cell():
    """On the card: one short run of each cell through the command."""
    pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for workload in CELLS:
        proc = subprocess.run(
            [sys.executable, "-m", "portbench.run", "--workload", workload,
             "--seed", str(SEED), "--seconds", "3", "--trace", "0"],
            cwd=ROOT, capture_output=True, text=True, timeout=900)
        assert proc.returncode == 0, proc.stderr[-3000:]
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        assert out["correct"] is True, out["checks"]
        assert out["device"]["platform"] == "gpu"


test_the_card_runs_each_cell = pytest.mark.cuda(test_the_card_runs_each_cell)


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_and_a_half_batch_fail_the_cells_limits(workload):
    """The control (the reference with float8 products) and the reference
    on half of every batch, against the f32 reference, each fail one of the
    cell's limits; the readings at the cell's own size are in PERF.md."""
    from portbench import check, control

    cell = tiny_cell(workload)
    got = control.readings_for(cell, SEED, torch.device("cpu"))
    for kind in ("control", "half_batch"):
        correct, _checks = check.verdict(got[kind], cell.limits)
        assert correct is False, (kind, got[kind])


def test_without_the_program_the_command_prints_no_result(tmp_path):
    """A checkout that holds only ``BENCHMARK.json`` and ``portbench/``."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "cube_regressor.replay", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
