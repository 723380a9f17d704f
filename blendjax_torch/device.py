"""Device resolution shared by every entry point of the port."""

from __future__ import annotations


def resolve_device(device=None):
    """``None`` -> ``cuda`` (raises when no GPU is present: the port never
    carries on on the CPU unasked); anything else -> ``torch.device``."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port on the CPU explicitly"
            )
        return torch.device("cuda")
    return torch.device(device)
