"""Cells at a size a CPU test run holds: the real cell's files, with the
model's widths, the frames and the warm-up cut, and the f32 policy (the
CPU's bf16 convolutions are not the card's)."""

from __future__ import annotations

from portbench.cell import load_cell

VIT = {"patch": 16, "dim": 64, "depth": 1, "num_heads": 2, "mlp_ratio": 4,
       "in_channels": 4, "num_outputs": 16}
CNN = {"features": [8, 16], "hidden": 32, "num_points": 8, "in_channels": 4}


def tiny_cell(workload: str, root=None):
    cell = load_cell(workload) if root is None else load_cell(workload, root)
    if cell.config["family"] == "vit":
        cell.config["model"] = dict(VIT)
        cell.config["port"]["kwargs"] = {
            **{k: v for k, v in VIT.items() if k != "mlp_ratio"},
            "attn_backend": "flash"}
    else:
        cell.config["model"] = dict(CNN)
        cell.config["port"]["kwargs"] = dict(CNN)
    cell.config["precision"] = "f32"
    cell.traffic.update(shape=[64, 128], tile_capacity=16, warmup_calls=2)
    if "messages" in cell.traffic:
        cell.traffic["messages"] = 16
    return cell
