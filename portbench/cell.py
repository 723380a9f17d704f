"""Find a cell's parts by name.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration and traffic mix and lists the metrics. Everything else is a
file of its own, found by name:

- ``portbench/configs/<config>.json`` (the file the configuration's entry
  names): the model, its widths and precision, and its source;
- ``portbench/traffic/<traffic>.json``: the traffic mix;
- ``portbench/metrics/<metric>.py``: each metric's reader, ``read(ctx)``;
- ``portbench/limits/<workload>.json``: the cell's limits of the numbers
  that decide ``correct``;
- ``portbench/reference/<family>.py`` and ``portbench/formulas/<family>.py``:
  the plain reference and the FLOP count of the configuration's family.

A later cell, mix, configuration or metric is a new file and a new entry
in ``BENCHMARK.json``; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    limits: dict
    run_seconds: int

    @property
    def name(self) -> str:
        return self.workload["name"]


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, workload: str) -> bool:
    cells = metric.get("workloads")
    return cells is None or workload in cells


def load_cell(workload: str, root: str = ROOT) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its files; an
    unknown name or a missing file raises."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    work = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if work is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == work["config"])
    config = _load_json(os.path.join(root, entry["file"]))
    traffic = _load_json(os.path.join(root, "portbench", "traffic",
                                      f"{work['traffic']}.json"))
    limits = _load_json(os.path.join(root, "portbench", "limits",
                                     f"{workload}.json"))
    return Cell(
        workload=work, config=config, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
        limits=limits, run_seconds=int(bench["run_seconds"]),
    )


def metric_reader(name: str, root: str = ROOT):
    """``read(ctx)`` of ``portbench/metrics/<name>.py``."""
    path = os.path.join(root, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def family_module(kind: str, family: str):
    """``portbench.<kind>.<family>``: the reference or the FLOP count of a
    configuration's family."""
    return importlib.import_module(f"portbench.{kind}.{family}")
