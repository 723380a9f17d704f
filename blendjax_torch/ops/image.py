"""Image input casts (port of ``blendjax/ops/image.py``).

The gamma-normalize kernel of the JAX package (``_pallas_gamma_normalize``)
is not on this slice's path and is still to be ported.
"""

from __future__ import annotations

import torch


def normalize_uint8(x, dtype=None):
    """uint8 -> [0, 1] in the compute dtype (bf16 by default): the cast
    first, then a division by 255 in that dtype, as the JAX package does."""
    dtype = torch.bfloat16 if dtype is None else dtype
    return x.to(dtype) / 255.0  # a Python scalar keeps the tensor's dtype


def maybe_normalize_uint8(x, dtype=None):
    """Model-input canonicalisation: uint8 is scaled to [0, 1]; float input
    is assumed normalised and only cast."""
    if x.dtype == torch.uint8:
        return normalize_uint8(x, dtype)
    return x.to(torch.bfloat16 if dtype is None else dtype)
