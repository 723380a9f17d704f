"""Benchmark CNN: cube image -> 8 corner pixel coordinates (port of
``blendjax/models/cnn.py``).

Takes the streamed frames as they arrive, NHWC uint8 (B, H, W, 4), and
returns (B, 8, 2). Three behaviours of the flax original are kept on
purpose:

- flax's ``'SAME'`` padding for a stride-2 3x3 convolution pads
  ``(0, 1)`` on an even size (the extra row and column go at the end),
  so the input is padded with ``F.pad`` before a ``padding=0``
  convolution; torch's symmetric ``padding=1`` would shift every output;
- ``nn.gelu`` is the tanh approximation: ``F.gelu(approximate="tanh")``;
- each layer casts its input and its f32 parameters to the compute dtype
  (bf16 by default) and the head runs in f32.

Parameters are stored in torch layouts (OIHW convolutions, (out, in)
dense); :func:`blendjax_torch.weights.from_flax` converts the JAX
package's parameter tree.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from blendjax_torch.ops.image import maybe_normalize_uint8
from blendjax_torch.precision import default_compute_dtype


def same_pads(size: int, kernel: int, stride: int) -> tuple:
    """(before, after) padding of flax/XLA ``'SAME'`` along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def lecun_normal_(weight: torch.Tensor, gen: torch.Generator) -> None:
    """flax's default kernel initialisation into a torch-layout weight
    (out first): truncated at 2 sigma, variance 1/fan_in, with the
    truncated-normal std correction of ``jax.nn.initializers``."""
    fan_in = weight[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    w = torch.empty(weight.shape)
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)
    weight.copy_(w)


class CubeRegressor(nn.Module):
    def __init__(self, features=(32, 64, 128, 256), num_points: int = 8,
                 dtype=None, in_channels: int = 4, hidden: int = 256):
        super().__init__()
        self.features = tuple(features)
        self.num_points = int(num_points)
        # None -> the default policy's compute dtype (bf16)
        self.dtype = dtype
        chans = (in_channels, *self.features)
        self.convs = nn.ModuleList(
            nn.Conv2d(cin, cout, 3, stride=2, padding=0)
            for cin, cout in zip(chans[:-1], chans[1:])
        )
        self.dense = nn.Linear(self.features[-1], hidden)
        self.head = nn.Linear(hidden, self.num_points * 2)

    def init_params(self, seed: int = 0) -> "CubeRegressor":
        """flax's default initialisation, from an explicit generator:
        LeCun-normal kernels (truncated at 2 sigma, variance 1/fan_in)
        and zero biases."""
        gen = torch.Generator().manual_seed(int(seed))
        with torch.no_grad():
            for layer in (*self.convs, self.dense, self.head):
                lecun_normal_(layer.weight, gen)
                layer.bias.zero_()
        return self

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """``images``: (B, H, W, C) uint8 (or float in [0, 1])."""
        dtype = default_compute_dtype(self.dtype)
        x = maybe_normalize_uint8(images, dtype).permute(0, 3, 1, 2)
        for conv in self.convs:
            top, bottom = same_pads(x.shape[2], 3, 2)
            left, right = same_pads(x.shape[3], 3, 2)
            x = F.pad(x, (left, right, top, bottom))
            x = F.conv2d(
                x, conv.weight.to(dtype), conv.bias.to(dtype), stride=2
            )
            x = F.gelu(x, approximate="tanh")
        x = x.mean(dim=(2, 3))  # global average pool
        x = F.gelu(
            F.linear(x, self.dense.weight.to(dtype), self.dense.bias.to(dtype)),
            approximate="tanh",
        )
        # .float(): the parameters may be bf16 copies (the bf16-grads policy)
        out = F.linear(x.float(), self.head.weight.float(),
                       self.head.bias.float())
        return out.reshape(-1, self.num_points, 2)
