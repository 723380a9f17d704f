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

On a ``tp`` axis (a state sharded by :meth:`CubeRegressor.partition_rules`,
the JAX package's rules) each rank computes with its blocks in place, as
the JAX package's compiled step does (``blendjax_torch/docs/mesh-split.md``):
a convolution split on its output channels makes this rank's channels,
which the next convolution (and the pooled features) all-gathers; the
hidden ``Dense`` is column-split and the head row-split, its partial
products summed over ``tp``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from blendjax_torch.ops.image import maybe_normalize_uint8
from blendjax_torch.parallel.sharding import split_of
from blendjax_torch.parallel.tensor import (
    column_bias,
    enter,
    gather_columns,
    row_sum,
)
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


def _split_linear(x, have, layer: nn.Linear, dtype, res):
    """``layer`` on ``x`` in ``dtype`` with its weight whole or split over
    tp (``res``) by its outputs (column: returns this rank's outputs, and
    ``res``) or its inputs (row: this rank's inputs, the products summed
    over tp); ``have`` is the split ``x``'s columns come in (None: whole).
    Returns ``(y, the split y's columns come in)``."""
    if res is not None and res.flax_dim == 0:  # row-split
        if have is None:
            from blendjax_torch.parallel.collectives import scatter_to_axis

            x = scatter_to_axis(x, res.mesh, res.axis, dim=1)
        y = row_sum(F.linear(x.to(dtype), layer.weight.to(dtype)), res)
        return y + layer.bias.to(dtype), None
    x = enter(gather_columns(x, have), res)
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    column_bias(layer.bias, res).to(dtype)), res


class CubeRegressor(nn.Module):
    #: the kernels it computes with split over ``tp`` in place: the
    #: convolutions by output channels, the two Dense by either dim
    SPLIT_PARAMS = {"tp": {r"convs\.\d+\.weight": (3,),
                           "dense.weight": (0, 1), "head.weight": (0, 1)}}

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

    def partition_rules(self) -> tuple:
        """The JAX package's tensor-parallel layout of this parameter tree:
        the pooled MLP a Megatron pair (the hidden ``Dense_0`` column-split
        over ``tp``, the head ``Dense_1`` row-split); the convolutions take
        the generic defaults (output channels over ``tp`` when it divides
        them, ``fsdp`` on the largest free dim)."""
        from blendjax_torch.parallel.sharding import PartitionRule

        return (
            PartitionRule(r"^Dense_0/kernel$", ("tp",)),       # hidden
            PartitionRule(r"^Dense_1/kernel$", ("tp", None)),  # head, row
        )

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
        have = None  # the split whose channels x holds (None: all of them)
        for i, conv in enumerate(self.convs):
            res = split_of(self, f"convs.{i}.weight")
            x = enter(gather_columns(x, have, dim=1), res)
            top, bottom = same_pads(x.shape[2], 3, 2)
            left, right = same_pads(x.shape[3], 3, 2)
            x = F.pad(x, (left, right, top, bottom))
            x = F.conv2d(
                x, conv.weight.to(dtype),
                column_bias(conv.bias, res).to(dtype), stride=2
            )
            x = F.gelu(x, approximate="tanh")
            have = res
        x = gather_columns(x.mean(dim=(2, 3)), have)  # global average pool
        x, have = _split_linear(x, None, self.dense, dtype,
                                split_of(self, "dense.weight"))
        x = F.gelu(x, approximate="tanh")
        # .float(): the parameters may be bf16 copies (the bf16-grads policy)
        out, have = _split_linear(x.float(), have, self.head, torch.float32,
                                  split_of(self, "head.weight"))
        out = gather_columns(out, have)
        return out.reshape(-1, self.num_points, 2)
