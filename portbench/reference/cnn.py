"""Plain reference of the CNN family: the port's ``CubeRegressor``, the
cube-corner regressor of blendtorch's datagen example.

Strided 3x3 'SAME' convolutions (stride 2, each followed by tanh GELU),
a mean over the remaining positions, a dense hidden layer with tanh GELU
and a linear head to the corners' (x, y) pixels. Frames arrive as uint8
and are divided by 255. Parameter names are the port's, so one seeded
initialisation fills both.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.common import Products, same_pads


class Model(nn.Module):
    def __init__(self, model: dict, shape, products: Products):
        super().__init__()
        self.products = products
        self.num_points = model["num_points"]
        chans = (model["in_channels"], *model["features"])
        self.convs = nn.ModuleList(
            nn.Conv2d(cin, cout, 3, stride=2)
            for cin, cout in zip(chans[:-1], chans[1:]))
        self.dense = nn.Linear(chans[-1], model["hidden"])
        self.head = nn.Linear(model["hidden"], 2 * self.num_points)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) uint8 -> (B, num_points, 2) corner pixels."""
        p = self.products
        x = (frames.float() / 255.0).permute(0, 3, 1, 2)
        for conv in self.convs:
            top, bottom = same_pads(x.shape[2], 3, 2)
            left, right = same_pads(x.shape[3], 3, 2)
            x = F.gelu(p.conv(F.pad(x, (left, right, top, bottom)), conv, 2),
                       approximate="tanh")
        x = F.gelu(p.linear(x.mean(dim=(2, 3)), self.dense),
                   approximate="tanh")
        return self.head(x).reshape(-1, self.num_points, 2)  # f32 head
