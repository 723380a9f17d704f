"""Device resolution shared by every entry point of the port, and the
pinned host-to-device stager the captured steps and the RL reservoir
share."""

from __future__ import annotations

import collections


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


def device_flag(value: str):
    """An entry point's ``--device`` value: ``"cuda"`` (the default of
    every example) is :func:`resolve_device` of ``None``, so it raises when
    no GPU is present; any other value names its device (``"cpu"``)."""
    return resolve_device(None if value in (None, "cuda") else value)


class HostStager:
    """Host arrays -> device tensors through a ring of pinned buffers per
    shape and dtype, each reused once the copy that last read it is done,
    so a copy never waits for the queued steps."""

    SLOTS = 4

    def __init__(self):
        self._rings: dict = {}

    def copy(self, dst, arr) -> None:
        """Copy host array ``arr`` into tensor ``dst`` (asynchronously on
        the current CUDA stream when ``dst`` is on a card)."""
        import numpy as np
        import torch

        src = torch.from_numpy(np.ascontiguousarray(arr))
        if dst.device.type != "cuda":
            dst.copy_(src)
            return
        ring = self._rings.setdefault((src.shape, src.dtype),
                                      collections.deque())
        if len(ring) < self.SLOTS:
            entry = [torch.empty(src.shape, dtype=src.dtype).pin_memory(),
                     None]
        else:
            entry = ring.popleft()
            entry[1].synchronize()  # the copy out of it has finished
        ring.append(entry)
        entry[0].copy_(src)
        dst.copy_(entry[0], non_blocking=True)
        entry[1] = torch.cuda.Event()
        entry[1].record()
