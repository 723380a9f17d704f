"""Image preprocessing ops (port of ``blendjax/ops/image.py``).

:func:`uint8_gamma_normalize` takes uint8 NHWC frames to gamma-corrected
[0, 1] values in one pass. On CUDA tensors it launches the hand-written
kernel K3 (:func:`blendjax_torch.kernels.image.gamma_normalize`, the port
of the Pallas ``_pallas_gamma_normalize``); on CPU tensors it runs the
kernel's plain version. The casts :func:`normalize_uint8` and
:func:`maybe_normalize_uint8` feed every model's input.
"""

from __future__ import annotations

import torch


def gamma_correct(x, gamma: float = 2.2):
    """Float image in [0, 1] -> gamma-corrected: ``clip(x, 0, 1) ** (1/gamma)``."""
    return torch.pow(torch.clamp(x, 0.0, 1.0), 1.0 / gamma)


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


def _flip_bits(gen: torch.Generator, b: int):
    """Per-sample flip decisions (B,) bool on ``gen``'s device, one fair
    coin each: the one draw shared by :func:`random_flip` and
    :func:`blendjax_torch.ops.augment.random_flip_with_points`, so both
    flip the same samples for the same generator state."""
    return torch.rand((b,), generator=gen, device=gen.device) < 0.5


def apply_flip(x, bits, axis: int = 2):
    """Flip the samples of ``x`` whose ``bits`` are set along ``axis``."""
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    return torch.where(bits.reshape(shape), torch.flip(x, dims=(axis,)), x)


def random_flip(gen: torch.Generator, x, axis: int = 2):
    """Batched random horizontal flip (augmentation; one bit per sample)."""
    return apply_flip(x, _flip_bits(gen, x.shape[0]), axis)


def uint8_gamma_normalize(x, gamma: float = 2.2, dtype=torch.float32,
                          use_kernel: bool | None = None):
    """uint8 NHWC -> ``(x * (1/255)) ** (1/gamma)`` in ``dtype`` (f32 or
    bf16), computed in f32.

    ``use_kernel=None`` picks by the tensor's device, as the JAX package
    picks the Pallas kernel on a TPU: a CUDA tensor launches K3, a CPU
    tensor runs the plain version. ``use_kernel=True`` on a CPU tensor
    raises; ``use_kernel=False`` runs the plain version anywhere. A CUDA
    request that fails to build or launch raises; it never falls back.
    """
    from blendjax_torch.kernels.image import (
        gamma_normalize,
        gamma_normalize_plain,
    )

    if use_kernel is None:
        use_kernel = x.is_cuda
    if not use_kernel:
        return gamma_normalize_plain(x, gamma, dtype)
    if not x.is_cuda:
        raise RuntimeError(
            f"use_kernel=True needs a CUDA tensor, got one on {x.device}"
        )
    return gamma_normalize(x, gamma, dtype)
