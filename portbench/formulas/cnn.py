"""Model FLOPs of one image of the CNN family (``CubeRegressor``), forward
and backward.

The rule of :mod:`.vit`: every convolution and dense layer 2 * fan_in *
fan_out per output position (a 3x3 convolution's fan_in is 9 * C_in; a
stride-2 'SAME' convolution halves each side, rounding up), the backward
counted as twice the forward (3x in all). GELU, the mean pool and AdamW
are not counted.
"""

from __future__ import annotations


def flops_per_image(model: dict, shape) -> float:
    """``model``: the configuration's ``model`` block; ``shape``: the
    frames' (H, W)."""
    h, w = (int(s) for s in shape)
    cin = model["in_channels"]
    fwd = 0
    for cout in model["features"]:
        h, w = -(-h // 2), -(-w // 2)
        fwd += h * w * 2 * 9 * cin * cout
        cin = cout
    fwd += 2 * cin * model["hidden"] + 2 * model["hidden"] * 2 * model["num_points"]
    return 3.0 * fwd
