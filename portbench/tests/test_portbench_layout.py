"""The benchmark finds every part of a cell by name, and a new config, mix
or metric is a file of its own."""

from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from portbench.cell import ROOT, family_module, load_cell, metric_reader
from portbench.check import NAMES

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench(root=ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("workload", [w["name"] for w in _bench()["workloads"]])
def test_every_cell_finds_its_parts(workload):
    cell = load_cell(workload)
    assert cell.traffic["name"] == cell.workload["traffic"]
    assert cell.config["name"] == cell.workload["config"]
    assert cell.limits and set(cell.limits) <= set(NAMES)
    assert hasattr(family_module("reference", cell.config["family"]), "Model")
    assert callable(family_module("formulas", cell.config["family"])
                    .flops_per_image)
    for m in cell.end_to_end + cell.per_layer:
        assert callable(metric_reader(m["name"]))


def test_the_file_keeps_the_contract():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    cells = {w["name"]: w for w in bench["workloads"]}
    used = {w["config"] for w in cells.values()}
    assert used == {c["name"] for c in bench["configs"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        moves = e2e[m["moves"]]
        # every cell that reads the metric reports what it moves
        assert set(m.get("workloads", cells)) <= set(moves.get("workloads",
                                                               cells))
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in cells.values():
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
    assert len(json.dumps(bench)) < 64 * 1024


def test_a_new_cell_mix_and_metric_are_files_of_their_own(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = _bench()
    with open(root / "portbench" / "traffic" / "live2.json") as f:
        mix = json.load(f)
    (root / "portbench" / "traffic" / "live3.json").write_text(
        json.dumps({**mix, "name": "live3", "producers": 3}))
    (root / "portbench" / "limits" / "vit_b16.live3.json").write_text(
        json.dumps({n: 0.5 for n in NAMES}))
    (root / "portbench" / "metrics" / "calls.per_s.py").write_text(
        "def read(ctx):\n    return ctx['calls'] / ctx['seconds']\n")
    bench["workloads"].append({"name": "vit_b16.live3", "config": "vit_b16",
                               "traffic": "live3", "chips": 1, "why": "x"})
    bench["per_layer"].append({
        "name": "calls.per_s", "unit": "1/s", "better": "higher",
        "source": "host_clock", "layer": "graphs and driver",
        "moves": "train_img_s", "workloads": ["vit_b16.live3"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = load_cell("vit_b16.live3", root=str(root))
    assert cell.traffic["producers"] == 3
    assert cell.limits == {n: 0.5 for n in NAMES}
    assert "calls.per_s" in [m["name"] for m in cell.per_layer]
    read = metric_reader("calls.per_s", root=str(root))
    assert read({"calls": 10, "seconds": 2.0}) == 5.0
    # the cells already there are untouched by the new files
    assert "calls.per_s" not in [
        m["name"] for m in load_cell("vit_b16.live2", root=str(root)).per_layer]
