"""Model FLOPs of one image of the ViT family (``StreamFormer``), forward
and backward.

A frozen copy of ``chip_smoke.former_flops_per_image``: every dense layer
2 * fan_in * fan_out per token (patch embedding patch^2 * C_in * dim; per
block qkv 3 dim^2, proj dim^2, MLP 2 * mlp_ratio * dim^2), attention
4 * T^2 * dim per block (its two products), the head 2 * dim * outputs;
the backward counted as twice the forward (3x in all). Normalisation,
softmax, GELU and AdamW are not counted.
"""

from __future__ import annotations


def flops_per_image(model: dict, shape) -> float:
    """``model``: the configuration's ``model`` block; ``shape``: the
    frames' (H, W)."""
    patch, dim, depth = model["patch"], model["dim"], model["depth"]
    ratio = model.get("mlp_ratio", 4)
    grid = [-(-int(s) // patch) for s in shape]
    tokens = grid[0] * grid[1]
    dense = (patch ** 2 * model["in_channels"] * dim
             + depth * (4 + 2 * ratio) * dim * dim)
    fwd = (2 * tokens * dense + depth * 4 * tokens * tokens * dim
           + 2 * dim * model["num_outputs"])
    return 3.0 * fwd
