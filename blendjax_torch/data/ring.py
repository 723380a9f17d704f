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

A sharded ring (``sharding=``, a
:class:`~blendjax_torch.parallel.Sharding` such as
:func:`~blendjax_torch.parallel.ring_sharding`) splits the capacity axis
over the batch axes, as the JAX package's: rank ``r`` of ``w`` holds the
global slots ``[r * C/w, (r + 1) * C/w)``. Slots and draw indices stay
global (the host bookkeeping is the one-card one); an insert all-gathers
the ranks' rows of the global batch and each rank writes the rows its
slots own. A gather works on the card alone, with static shapes: each
rank masks the draw to the slots it owns (``owned = (idx >= first) & (idx
< first + local)``), reads them (``idx - first``, clamped into its slice),
zeroes the rows it does not own, and one all-reduce over the batch axes
sums the ranks' rows as bytes (exactly one rank owns each row, so the sum
is that rank's bytes: bit for bit, whatever the dtype).
:func:`make_ring_gather` keeps the rows the batch sharding gives this
rank, the rows the feeder would place on it. The draw's indices are never
read on the host, so a step over a sharded ring captures into one CUDA
graph with its gather. A ring given a mesh sharding takes this gather
whatever its ways, an axis of one rank too: its all-reduce runs over one
rank, as the collectives of a graph captured at any size do.
"""

from __future__ import annotations

import numpy as np
import torch



def ring_ways(sharding) -> int:
    """How many ways ``sharding`` splits the capacity axis (1 for None)."""
    from blendjax_torch.parallel.sharding import (
        check_sharding,
        leading_shard_count,
    )

    return leading_shard_count(check_sharding(sharding))


def validate_ring_capacity(capacity: int, sharding) -> None:
    """Raise when ``capacity`` cannot split evenly over the sharded ring
    axis, or when the ring sharding puts a model axis on it."""
    from blendjax_torch.parallel.sharding import validate_batch_sharding

    ways = ring_ways(sharding)
    if sharding is not None:
        validate_batch_sharding(sharding, what="ring")
    if ways > 1 and capacity % ways:
        raise ValueError(
            f"capacity={capacity} must divide evenly over the {ways}-way "
            "sharded ring axis: every card holds an equal slice of the "
            "reservoir")


def _shard_range(capacity: int, sharding) -> tuple:
    """``(first global slot, slots)`` this rank holds."""
    from blendjax_torch.parallel.mesh import axes_index
    from blendjax_torch.parallel.sharding import leading_axes

    ways = ring_ways(sharding)
    if ways <= 1:
        return 0, int(capacity)
    local = int(capacity) // ways
    return axes_index(sharding.mesh, leading_axes(sharding)) * local, local


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
    ``initial`` (copied) directly, without a zeros pass first. A sharded
    ring holds this rank's ``capacity / ways`` slots; a restored
    ``initial`` is the whole ring, of which it keeps its slots."""
    validate_ring_capacity(capacity, sharding)
    first, local = _shard_range(capacity, sharding)
    if initial is not None:
        tensors = {k: torch.as_tensor(v) for k, v in initial.items()}
        return {k: t[first:first + local].to(device or t.device, copy=True)
                if int(t.shape[0]) == int(capacity) and local != capacity
                else t.to(device or t.device, copy=True)
                for k, t in tensors.items()}
    return {
        k: torch.zeros((local, *v.shape[1:]), dtype=v.dtype,
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
    """``insert(buffers, batch, cursor) -> buffers``, updating in place.
    With a sharding, ``batch`` holds this rank's rows of the global batch
    (the batch sharding's); the global batch's row ``j`` lands in global
    slot ``(cursor + j) % capacity`` on the rank that holds it."""
    validate_ring_capacity(capacity, sharding)
    if ring_ways(sharding) <= 1:
        def insert(buffers, batch, cursor):
            return ring_slot_update(capacity, buffers, batch, cursor)

        return insert
    from blendjax_torch.parallel.collectives import all_gather
    from blendjax_torch.parallel.sharding import leading_axes

    first, local = _shard_range(capacity, sharding)
    axes = leading_axes(sharding)

    def insert(buffers, batch, cursor):
        rows = {k: all_gather(v, sharding.mesh, axes, differentiable=False)
                for k, v in batch.items()}
        b = int(next(iter(rows.values())).shape[0])
        if b > capacity:
            raise ValueError(f"{b} rows do not fit a ring of {capacity}")
        slots = (int(cursor) + np.arange(b)) % capacity
        mine = np.flatnonzero((slots >= first) & (slots < first + local))
        if len(mine):
            dev = next(iter(buffers.values())).device
            src = _index_tensor(mine, dev)
            dst = _index_tensor(slots[mine] - first, dev)
            for k, buf in buffers.items():
                buf.index_copy_(0, dst, rows[k].index_select(0, src))
        return buffers

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


def _sharded_gather(buffers: dict, rows: torch.Tensor, sharding,
                    capacity: int) -> dict:
    """Every row of the draw ``rows`` (global slots, a device tensor) on
    every rank of a sharded ring: this rank's owned rows, the others
    zero, all fields in one uint8 all-reduce over the batch axes."""
    from blendjax_torch.parallel.collectives import all_reduce_sum
    from blendjax_torch.parallel.sharding import leading_axes

    first, local = _shard_range(capacity, sharding)
    owned = (rows >= first) & (rows < first + local)
    src = (rows - first).clamp(0, local - 1)
    n = int(rows.shape[0])
    parts = [v.index_select(0, src).reshape(n, -1).view(torch.uint8)
             for v in buffers.values()]
    summed = all_reduce_sum(
        torch.cat(parts, dim=1).masked_fill_(~owned[:, None], 0),
        sharding.mesh, leading_axes(sharding), differentiable=False)
    out, at = {}, 0
    for (k, v), part in zip(buffers.items(), parts):
        width = int(part.shape[1])
        out[k] = (summed[:, at:at + width].contiguous().view(v.dtype)
                  .reshape(n, *v.shape[1:]))
        at += width
    return out


def ring_gather(buffers: dict, idx, sharding=None, capacity=None) -> dict:
    """Rows ``idx`` of every ring field (a copy: a later insert does not
    change what was gathered). With a mesh sharding (and the ring's global
    ``capacity``), ``idx`` are global slots and every rank gets every row
    of the draw, computed on the card (the module's note): a device
    ``idx`` is never read on the host."""
    from blendjax_torch.parallel.sharding import leading_axes

    dev = next(iter(buffers.values())).device
    rows = _index_tensor(idx, dev)
    if not leading_axes(sharding):
        return {k: v.index_select(0, rows) for k, v in buffers.items()}
    return _sharded_gather(buffers, rows, sharding, capacity)


def make_ring_gather(capacity: int | None = None, sharding=None):
    """``gather(buffers, idx) -> batch``: rows ``idx`` (global slots) as
    the batch sharding places them, i.e. this rank's rows of the draw."""
    from blendjax_torch.parallel.sharding import local_rows

    def gather(buffers, idx):
        rows = ring_gather(buffers, idx, sharding=sharding, capacity=capacity)
        if sharding is None:
            return rows
        return {k: local_rows(v, sharding) for k, v in rows.items()}

    return gather


__all__ = [
    "allocate_ring",
    "make_ring_gather",
    "make_ring_insert",
    "ring_gather",
    "ring_slot_update",
    "ring_spec",
    "ring_ways",
    "validate_ring_capacity",
]
