"""Device ring internals of the echo reservoir (port of ``blendjax/data/ring.py``).

A ring keeps "the last ``capacity`` samples" on the card as one
preallocated tensor per field (leading dim ``capacity``). JAX updates it
through a donated jitted scatter; here the insert writes the rows in
place, so each field's storage (its ``data_ptr()``) is allocated once and
stays the same for the life of the run: the port's counterpart of the
JAX package's donation audit.

Rings are flat dicts of tensors (the echo reservoir's ``{image, xy,
...}``). Callers keep the host-side bookkeeping (cursor, size, per-slot
accounting); nothing here reads a device value back. Ring work is queued
on the caller's current CUDA stream, so an insert queued after a step
that gathered from the ring cannot overwrite the rows before the step
read them (stream order).

Sharded rings (``sharding=``) wait for the multi-GPU slice (ROADMAP
Queue A item 5) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch

MULTI_GPU = (
    "a sharded ring waits for the multi-GPU slice of the port "
    "(ROADMAP Queue A item 5)"
)


def _no_sharding(sharding) -> None:
    if sharding is not None:
        raise NotImplementedError(MULTI_GPU)


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


def ring_spec(fields: dict) -> dict:
    """``{key: (per-row shape, numpy dtype)}`` of one example batch, keyed
    as ``jax.tree_util.keystr`` keys a flat dict (``"['image']"``)."""
    return {
        f"[{k!r}]": (tuple(v.shape[1:]), _numpy_dtype(v.dtype))
        for k, v in fields.items()
    }


def allocate_ring(capacity: int, fields: dict | None = None, sharding=None,
                  initial: dict | None = None, device=None) -> dict:
    """Preallocate the ring (zeros shaped from ``fields``' rows, on
    ``device`` or the fields' own device), or place a restored snapshot
    ``initial`` (copied) directly, without a zeros pass first."""
    _no_sharding(sharding)
    if initial is not None:
        tensors = {k: torch.as_tensor(v) for k, v in initial.items()}
        return {k: t.to(device or t.device, copy=True)
                for k, t in tensors.items()}
    return {
        k: torch.zeros((int(capacity), *v.shape[1:]), dtype=v.dtype,
                       device=device or v.device)
        for k, v in fields.items()
    }


def ring_slot_update(capacity: int, buffers: dict, batch: dict,
                     cursor: int) -> dict:
    """Write ``batch``'s rows at ``(cursor + arange(B)) % capacity`` of
    every field, in place (at most two contiguous copies per field: the
    run up to the ring's end and the wrapped rest). ``B <= capacity`` and
    ``cursor`` is a host int. Returns ``buffers``."""
    cursor = int(cursor) % capacity
    for k, buf in buffers.items():
        rows = batch[k]
        b = int(rows.shape[0])
        if b > capacity:
            raise ValueError(f"{b} rows do not fit a ring of {capacity}")
        first = min(b, capacity - cursor)
        buf[cursor:cursor + first].copy_(rows[:first])
        if first < b:
            buf[:b - first].copy_(rows[first:])
    return buffers


def make_ring_insert(capacity: int, sharding=None):
    """``insert(buffers, batch, cursor) -> buffers``, updating in place."""
    _no_sharding(sharding)

    def insert(buffers, batch, cursor):
        return ring_slot_update(capacity, buffers, batch, cursor)

    return insert


def _index_tensor(idx, device) -> torch.Tensor:
    """Host indices (numpy or list) -> an int64 tensor on ``device``,
    through pinned memory on CUDA so the copy does not wait for the
    queued work. A CUDA graph cannot take host indices: the copy's pinned
    source would be freed while the graph still names it, so a captured
    draw is given a device tensor (the capture wrapper's static index
    buffer, :class:`blendjax_torch.train.aot.CapturedStep`)."""
    if isinstance(idx, torch.Tensor):
        return idx.to(device=device, dtype=torch.int64)
    t = torch.as_tensor(np.asarray(idx, np.int64))
    if torch.device(device).type == "cuda":
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "host draw indices inside a CUDA graph capture: stage them "
                "into a device buffer before the capture"
            )
        return t.pin_memory().to(device, non_blocking=True)
    return t


def ring_gather(buffers: dict, idx) -> dict:
    """Rows ``idx`` of every ring field (a copy: a later insert does not
    change what was gathered)."""
    dev = next(iter(buffers.values())).device
    rows = _index_tensor(idx, dev)
    return {k: v.index_select(0, rows) for k, v in buffers.items()}


__all__ = [
    "MULTI_GPU",
    "allocate_ring",
    "make_ring_insert",
    "ring_gather",
    "ring_slot_update",
    "ring_spec",
]
