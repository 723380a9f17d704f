"""Collectives over a named mesh axis (port of
``blendjax/parallel/collectives.py``).

The JAX package runs these inside ``shard_map`` over a global array; here
each rank passes its local shard and gets its local result, over the
process group of the named axis (or of several axes folded together, in
mesh order). All are differentiable through ``torch.autograd.Function``s
whose backward passes are the JAX package's transposes in its global view:

- :func:`all_reduce_sum` (``psum`` to a replicated result): backward is
  the identity, since every rank holds the same cotangent;
- :func:`all_reduce_mean`: the same, divided by the axis size;
- :func:`all_gather` (to a replicated result): backward takes this rank's
  slice of the cotangent;
- :func:`ring_permute`: backward permutes the cotangent the other way;
- :func:`all_to_all` (``lax.all_to_all(tiled=True)``): backward is the
  inverse all-to-all.

:func:`scatter_to_axis` is the pair of :func:`all_gather` (forward: this
rank's slice of a replicated tensor; backward: all-gather), the boundary
between a replicated region and a sharded one.

The two boundaries of a Megatron split over a model axis (``tp``,
``expert``), where every rank of the axis holds the same rows:
:func:`copy_to_axis` enters the split region (forward: the identity;
backward: the sum over the axis of the ranks' partial input gradients),
and :func:`all_reduce_sum` leaves it (forward: the sum of the ranks'
partial outputs; backward: the identity, every rank holding the same
output cotangent). These are the transposes the JAX package's GSPMD
jit compiles for the same layouts (``blendjax_torch/docs/mesh-split.md``).

On a gloo group (two ranks on one card, where NCCL refuses a second rank
of one device) gloo takes CUDA tensors for every collective but the
point-to-point pair of :func:`ring_permute`, which therefore runs on a
host copy there: the stage is explicit, never applies to an NCCL group,
and is counted by kind (:func:`staged_counts`).

Every collective adds its result bytes to a tally, per kind (the JAX
package's ledger kinds: ``all-reduce``, ``all-gather``,
``reduce-scatter``, ``collective-permute``, ``all-to-all``) and per mesh
axis (``"data"``, ``"data×fsdp"`` for a folded group): to the innermost
:func:`recording` context when one is open (a captured graph's tally,
:mod:`blendjax_torch.train.aot`), else to the process-wide counts
(:func:`collective_counts`). The device ledger publishes a step's tally
as ``device.collective.*_bytes`` (:mod:`blendjax_torch.obs.devledger`).
"""

from __future__ import annotations

import collections
import contextlib
import threading

import torch

from blendjax_torch.obs.devledger import COLLECTIVE_KINDS as KINDS
from blendjax_torch.parallel.mesh import _axes, axes_group, axes_size

_lock = threading.Lock()
_recorders: list = []

_staged: collections.Counter = collections.Counter()


def _empty_tally() -> dict:
    return {"ops": 0, "total_bytes": 0, "per_kind": {k: 0 for k in KINDS},
            "per_axis": {}}


_counts = _empty_tally()


def _add_tally(dst: dict, src: dict) -> None:
    """Add tally ``src`` into ``dst``."""
    dst["ops"] += src["ops"]
    dst["total_bytes"] += src["total_bytes"]
    for k, v in src["per_kind"].items():
        dst["per_kind"][k] = dst["per_kind"].get(k, 0) + v
    for k, v in src["per_axis"].items():
        dst["per_axis"][k] = dst["per_axis"].get(k, 0) + v


def _record(kind: str, axis_key: str, nbytes: int) -> None:
    with _lock:
        tally = _recorders[-1] if _recorders else _counts
        tally["ops"] += 1
        tally["total_bytes"] += nbytes
        tally["per_kind"][kind] += nbytes
        tally["per_axis"][axis_key] = tally["per_axis"].get(axis_key, 0) + nbytes


@contextlib.contextmanager
def recording():
    """Collect the collectives issued inside into the yielded tally
    ``{"ops", "total_bytes", "per_kind", "per_axis"}`` instead of the
    process-wide counts."""
    tally = _empty_tally()
    with _lock:
        _recorders.append(tally)
    try:
        yield tally
    finally:
        with _lock:
            _recorders.remove(tally)


def collective_counts() -> dict:
    """A copy of the process-wide tally (graph replays add their
    captured tallies to it)."""
    with _lock:
        out = _empty_tally()
        _add_tally(out, _counts)
        return out


def add_counts(tally: dict) -> None:
    with _lock:
        _add_tally(_counts, tally)


def tally_diff(after: dict, before: dict) -> dict:
    """``after - before`` of two tallies (of :func:`collective_counts`)."""
    return {
        "ops": after["ops"] - before["ops"],
        "total_bytes": after["total_bytes"] - before["total_bytes"],
        "per_kind": {k: v - before["per_kind"].get(k, 0)
                     for k, v in after["per_kind"].items()},
        "per_axis": {k: v - before["per_axis"].get(k, 0)
                     for k, v in after["per_axis"].items()
                     if v - before["per_axis"].get(k, 0)},
    }


def reset_collective_counts() -> None:
    with _lock:
        _counts.clear()
        _counts.update(_empty_tally())
        _staged.clear()


def staged_counts() -> dict:
    """``{kind: ops}`` that ran on a host copy on a gloo group since the
    last :func:`reset_collective_counts`."""
    with _lock:
        return dict(_staged)


def _host_stage(group, x) -> bool:
    """Whether a permute of ``x`` runs on a host copy: a CUDA tensor on a
    gloo group (never an NCCL group), counted."""
    if x.device.type != "cuda" or str(_dist().get_backend(group)) != "gloo":
        return False
    with _lock:
        _staged["collective-permute"] += 1
    return True


def _key(mesh, axes) -> str:
    return "×".join(_axes(axes, mesh))


def _nbytes(t) -> int:
    return int(t.numel()) * t.element_size()


def _dist():
    import torch.distributed as dist

    return dist


# -- raw collectives (no autograd) ----------------------------------------------


def _all_reduce(x, mesh, axes):
    out = x.clone()
    _dist().all_reduce(out, group=axes_group(mesh, axes))
    _record("all-reduce", _key(mesh, axes), _nbytes(out))
    return out


def _all_gather(x, mesh, axes, dim: int):
    n = axes_size(mesh, axes)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    _dist().all_gather(parts, x, group=axes_group(mesh, axes))
    out = torch.cat(parts, dim=dim)
    _record("all-gather", _key(mesh, axes), _nbytes(out))
    return out


def _my_slice(x, mesh, axes, dim: int):
    from blendjax_torch.parallel.mesh import axes_index

    n = axes_size(mesh, axes)
    size = x.shape[dim] // n
    return x.narrow(dim, axes_index(mesh, axes) * size, size)


def _permute(x, mesh, axes, shift: int):
    dist = _dist()
    group = axes_group(mesh, axes)
    n = axes_size(mesh, axes)
    x = x.contiguous()
    out = torch.empty_like(x)
    me = dist.get_group_rank(group, dist.get_rank())
    dst = dist.get_global_rank(group, (me + shift) % n)
    src = dist.get_global_rank(group, (me - shift) % n)
    if n == 1:
        out.copy_(x)
    else:
        host = _host_stage(group, x)
        send, recv = (x.cpu(), out.cpu()) if host else (x, out)
        ops = [dist.P2POp(dist.isend, send, dst, group=group),
               dist.P2POp(dist.irecv, recv, src, group=group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if host:
            out.copy_(recv)
    _record("collective-permute", _key(mesh, axes), _nbytes(out))
    return out


def _all_to_all(x, mesh, axes, split_dim: int, concat_dim: int):
    """``lax.all_to_all(tiled=True)``: split ``split_dim`` n ways, chunk
    ``j`` to rank ``j``; the received chunks concatenate along
    ``concat_dim`` in rank order."""
    n = axes_size(mesh, axes)
    chunks = x.chunk(n, dim=split_dim)
    send = torch.stack(chunks).contiguous()  # (n, *chunk)
    recv = torch.empty_like(send)
    _dist().all_to_all_single(recv, send, group=axes_group(mesh, axes))
    out = torch.cat(recv.unbind(0), dim=concat_dim)
    _record("all-to-all", _key(mesh, axes), _nbytes(out))
    return out


# -- autograd functions -----------------------------------------------------------


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, scale):
        out = _all_reduce(x, mesh, axes)
        ctx.scale = scale
        return out * scale if scale != 1.0 else out

    @staticmethod
    def backward(ctx, g):
        return (g * ctx.scale if ctx.scale != 1.0 else g), None, None, None


class _CopyToAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.args
        return _all_reduce(g.contiguous(), mesh, axes), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return _all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.args
        return _my_slice(g, mesh, axes, dim).contiguous(), None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return _my_slice(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.args
        return _all_gather(g, mesh, axes, dim), None, None, None


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, shift):
        ctx.args = (mesh, axes, shift)
        return _permute(x, mesh, axes, shift)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, shift = ctx.args
        return _permute(g, mesh, axes, -shift), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, split_dim, concat_dim):
        ctx.args = (mesh, axes, split_dim, concat_dim)
        return _all_to_all(x, mesh, axes, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, split_dim, concat_dim = ctx.args
        return (_all_to_all(g, mesh, axes, concat_dim, split_dim),
                None, None, None, None)


# -- the public collectives -------------------------------------------------------


def all_reduce_sum(x, mesh, axis="data", differentiable: bool = True):
    """Sum of every rank's ``x`` over ``axis`` (a name or a tuple of
    names), replicated."""
    if not differentiable:
        return _all_reduce(x, mesh, axis)
    return _AllReduceSum.apply(x, mesh, axis, 1.0)


def copy_to_axis(x, mesh, axis="tp"):
    """``x`` unchanged, entering a region split over ``axis`` whose ranks
    each compute a part from it (a column-split matmul, this rank's
    experts): the backward pass sums the ranks' input gradients over
    ``axis`` (one all-reduce), the transpose of the JAX package's
    replicated operand."""
    return _CopyToAxis.apply(x, mesh, axis)


def all_reduce_mean(x, mesh, axis="data"):
    return _AllReduceSum.apply(x, mesh, axis, 1.0 / axes_size(mesh, axis))


def all_gather(x, mesh, axis="data", dim: int = 0,
               differentiable: bool = True):
    """Every rank's shard concatenated along ``dim`` in rank order."""
    if not differentiable:
        return _all_gather(x, mesh, axis, dim)
    return _AllGather.apply(x, mesh, axis, dim)


def scatter_to_axis(x, mesh, axis="seq", dim: int = 1):
    """This rank's slice along ``dim`` of a tensor every rank of ``axis``
    holds whole (backward: all-gather)."""
    return _Scatter.apply(x, mesh, axis, dim)


def ring_permute(x, mesh, axis="seq", shift: int = 1):
    """Rank ``i``'s shard moves to rank ``i + shift`` of ``axis``."""
    return _Permute.apply(x, mesh, axis, shift)


def all_to_all(x, mesh, axis="seq", split_dim: int = 2, concat_dim: int = 1):
    return _AllToAll.apply(x, mesh, axis, split_dim, concat_dim)


def flat_all_reduce_mean(tensors, mesh, axes) -> tuple:
    """The mean over ``axes`` of every tensor of ``tensors``, through one
    all-reduce of their f32 concatenation (no gradient). With one rank it
    still runs, so a graph captured at world size 1 holds the collective
    it holds at any size."""
    tensors = list(tensors)
    flat = torch.cat([t.detach().float().reshape(-1) for t in tensors])
    flat = _all_reduce(flat, mesh, axes)
    n = axes_size(mesh, axes)
    if n != 1:
        flat = flat / n
    out, offset = [], 0
    for t in tensors:
        k = t.numel()
        out.append(flat[offset:offset + k].view(t.shape).to(t.dtype))
        offset += k
    return tuple(out)


__all__ = [
    "add_counts",
    "all_gather",
    "all_reduce_mean",
    "all_reduce_sum",
    "all_to_all",
    "collective_counts",
    "copy_to_axis",
    "flat_all_reduce_mean",
    "recording",
    "reset_collective_counts",
    "ring_permute",
    "scatter_to_axis",
    "staged_counts",
    "tally_diff",
]
