"""Named precision policies (port of the ``f32`` and ``bf16-compute``
policies of ``blendjax/precision.py``).

Under ``bf16-compute`` (the default) a layer casts its input and its
parameters to bf16 for the convolution or matrix product, as flax does
for a module with ``dtype=bfloat16`` and ``param_dtype=float32``: the
master parameters, their gradients and the optimizer state stay f32, and
the model's head runs in f32. ``f32`` keeps everything in float32 (the
parity policy of the tests). The ``bf16-grads`` policy waits for the
multi-GPU slice, where gradient bytes cross devices.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    name: str
    compute_dtype: torch.dtype


F32 = PrecisionPolicy("f32", compute_dtype=torch.float32)
BF16_COMPUTE = PrecisionPolicy("bf16-compute", compute_dtype=torch.bfloat16)
DEFAULT_POLICY = BF16_COMPUTE


def default_compute_dtype(dtype=None) -> torch.dtype:
    """An explicit dtype wins; ``None`` takes the default policy's."""
    return dtype if dtype is not None else DEFAULT_POLICY.compute_dtype
