"""Image discriminator for simulation-parameter optimisation (port of
``blendjax/models/discriminator.py``): stride-2 4x4 convolutions, each
with GroupNorm and leaky ReLU, a global mean pool and one logit.

Kept from the flax original:

- ``'SAME'`` padding of a 4x4 kernel at stride 2 pads (1, 1) on an even
  side and (1, 2) on an odd one, so the input is padded with ``F.pad``
  before a ``padding=0`` convolution (``padding=1`` is wrong on odd
  sizes);
- flax's GroupNorm epsilon (1e-6, not PyTorch's 1e-5), its statistics in
  f32 and its output in the compute dtype;
- each convolution casts its input and its f32 kernel to the compute
  dtype (the precision policy's, bf16 by default); the ``Dense`` head and
  its parameters stay f32.

The layer names follow flax's (``Conv_i``, ``GroupNorm_i``, ``Dense_0``)
through :func:`blendjax_torch.weights.discriminator_from_flax` and
:func:`blendjax_torch.weights.flax_params`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from blendjax_torch.models.cnn import lecun_normal_, same_pads
from blendjax_torch.ops.image import maybe_normalize_uint8
from blendjax_torch.precision import default_compute_dtype

GROUPS = 8
EPS = 1e-6  # flax GroupNorm's default


class Discriminator(nn.Module):
    """``images`` (B, H, W, C), uint8 or in [0, 1] -> (B,) f32 logits."""

    def __init__(self, features=(32, 64, 128, 256), dtype=None,
                 in_channels: int = 4):
        super().__init__()
        self.features = tuple(features)
        self.dtype = dtype  # None -> the default policy's compute dtype
        chans = (in_channels, *self.features)
        self.convs = nn.ModuleList(
            nn.Conv2d(cin, cout, 4, stride=2, padding=0, bias=False)
            for cin, cout in zip(chans[:-1], chans[1:])
        )
        self.norms = nn.ModuleList(
            nn.GroupNorm(GROUPS, f, eps=EPS) for f in self.features
        )
        self.head = nn.Linear(self.features[-1], 1)

    def init_params(self, seed: int = 0) -> "Discriminator":
        """flax's default initialisation from an explicit generator:
        LeCun-normal kernels, zero biases, unit GroupNorm scales."""
        gen = torch.Generator().manual_seed(int(seed))
        with torch.no_grad():
            for layer in (*self.convs, self.head):
                lecun_normal_(layer.weight, gen)
            self.head.bias.zero_()
            for norm in self.norms:
                norm.weight.fill_(1.0)
                norm.bias.zero_()
        return self

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        dtype = default_compute_dtype(self.dtype)
        x = maybe_normalize_uint8(images, dtype).permute(0, 3, 1, 2)
        for conv, norm in zip(self.convs, self.norms):
            top, bottom = same_pads(x.shape[2], 4, 2)
            left, right = same_pads(x.shape[3], 4, 2)
            x = F.pad(x, (left, right, top, bottom))
            x = F.conv2d(x, conv.weight.to(dtype), stride=2)
            x = F.group_norm(x.float(), GROUPS, norm.weight.float(),
                             norm.bias.float(), EPS).to(dtype)
            x = F.leaky_relu(x, 0.2)
        x = x.mean(dim=(2, 3))
        logit = F.linear(x.float(), self.head.weight.float(),
                         self.head.bias.float())
        return logit[:, 0]


__all__ = ["Discriminator"]
