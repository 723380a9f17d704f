"""Device meshes on ``torch.distributed`` (port of ``blendjax/parallel/mesh.py``).

Axis vocabulary (the JAX package's):

- ``data``  - batch (DP): the streamed global batch is split here;
- ``fsdp``  - parameter and optimizer sharding (ZeRO style), folded into
  the batch's leading dim as extra DP (every card sees distinct rows);
- ``tp``    - tensor parallelism (``tensor`` is the legacy spelling);
- ``seq``   - sequence parallelism (ring and Ulysses attention).

One process per card. The JAX package drives N devices from one process;
the port runs one process per card, so its mesh path is the JAX package's
*multi-host* form even on one host: each rank holds its own rows of the
global batch (the rows ``make_array_from_process_local_data`` would place
on that rank's device), decodes them on its own card, and meets the other
ranks only in explicit collectives over a mesh axis's process group.

:func:`create_mesh` returns a ``torch.distributed.device_mesh.DeviceMesh``
through ``init_device_mesh`` over the ranks of the default process group
(``"cuda"`` unless ``devices="cpu"``); the caller initialises that group
(``init_process_group`` with its address, world size and rank). Axis
sizes resolve against the world size as in the JAX package, ``-1``
absorbing what the fixed axes leave.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class MeshSpec:
    """Requested axis sizes; a ``-1`` axis absorbs the remaining ranks."""

    axes: dict = field(default_factory=lambda: {"data": -1})

    def resolve(self, n_devices: int) -> dict:
        sizes = dict(self.axes)
        known = int(np.prod([s for s in sizes.values() if s != -1]))
        free = [k for k, s in sizes.items() if s == -1]
        if len(free) > 1:
            raise ValueError(f"at most one -1 axis, got {sizes}")
        if free:
            if n_devices % known:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {sizes}")
            sizes[free[0]] = n_devices // known
        total = int(np.prod(list(sizes.values())))
        if total != n_devices:
            raise ValueError(
                f"mesh {sizes} needs {total} devices, have {n_devices}")
        return sizes


def _device_type(devices) -> str:
    if devices is None:
        return "cuda"
    if isinstance(devices, str):
        return devices
    return getattr(devices, "type", str(devices))


def create_mesh(spec=None, devices=None):
    """Build a ``DeviceMesh`` over every rank of the default process group.

    >>> mesh = create_mesh({"data": -1})                    # pure DP
    >>> mesh = create_mesh({"data": -1, "tp": 2})           # DP x TP
    >>> mesh = create_mesh({"data": 1, "seq": 2})           # SP
    >>> mesh = create_mesh("data×fsdp", devices="cpu")      # a Layout name

    ``spec`` is a :class:`MeshSpec`, an axis dict, a
    :class:`~blendjax_torch.parallel.Layout` or a layout name; ``devices``
    the device type (``"cuda"`` by default, ``"cpu"`` for gloo)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if spec is None:
        spec = MeshSpec()
    elif isinstance(spec, str) or hasattr(spec, "mesh_axes"):
        from blendjax_torch.parallel.sharding import resolve_layout

        spec = MeshSpec(resolve_layout(spec).mesh_axes())
    elif isinstance(spec, dict):
        spec = MeshSpec(dict(spec))
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "create_mesh needs the default process group: call "
            "torch.distributed.init_process_group (address, world size and "
            "rank) first")
    sizes = spec.resolve(dist.get_world_size())
    return init_device_mesh(_device_type(devices), tuple(sizes.values()),
                            mesh_dim_names=tuple(sizes))


def init_group(device, store_dir: str | None = None,
               backend: str | None = None, rank: int = 0,
               world_size: int = 1) -> bool:
    """Open the default process group for an entry point (the examples),
    unless one is open already: under ``torchrun`` (``WORLD_SIZE`` > 1) from
    the environment (``env://``); else, given a ``store_dir``, a group of
    ``world_size`` ranks (this one ``rank``) through a ``FileStore`` there;
    else none. ``backend`` ``None`` is NCCL on a CUDA ``device`` (this
    rank's card, ``LOCAL_RANK``) and gloo on the CPU; an explicit
    ``"gloo"`` on a CUDA device opens gloo over the card's tensors (the
    form in which several ranks share one card, which NCCL refuses).
    Returns whether this call opened the group (its caller then destroys
    it); a failure raises, with no fallback to another backend."""
    import datetime
    import os

    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return False
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    if env_world <= 1 and store_dir is None:
        return False
    cuda = torch.device(device).type == "cuda"
    backend = backend or ("nccl" if cuda else "gloo")
    kw = {"timeout": datetime.timedelta(seconds=120)}
    if cuda:
        card = int(os.environ.get("LOCAL_RANK", "0")) if env_world > 1 else 0
        torch.cuda.set_device(card)
        if backend == "nccl":
            kw["device_id"] = torch.device("cuda", card)
    if env_world > 1:
        dist.init_process_group(backend, init_method="env://", **kw)
    else:
        dist.init_process_group(
            backend, store=dist.FileStore(
                os.path.join(store_dir, "group-store"), int(world_size)),
            rank=int(rank), world_size=int(world_size), **kw)
    return True


# -- mesh queries shared by the port's mesh path --------------------------------


def check_mesh(mesh):
    """``mesh`` unchanged when it is a ``DeviceMesh``; a ``TypeError``
    otherwise (a JAX mesh or a stand-in object fails here, by name)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(
            f"expected a torch DeviceMesh (blendjax_torch.parallel."
            f"create_mesh), got {type(mesh).__name__}")
    return mesh


def axis_names(mesh) -> tuple:
    return tuple(getattr(mesh, "mesh_dim_names", None) or ())


def mesh_shape(mesh) -> dict:
    """``{axis: size}`` in mesh order (the JAX mesh's ``shape``)."""
    if mesh is None:
        return {}
    return dict(zip(axis_names(mesh), (int(s) for s in mesh.mesh.shape)))


def _axes(axes, mesh=None) -> tuple:
    """``axes`` as a tuple; with ``mesh``, those on it, in mesh order (the
    order a group's ranks and a folded dim's rows follow)."""
    if axes is None:
        return ()
    out = (axes,) if isinstance(axes, str) else tuple(a for a in axes if a)
    if mesh is None:
        return out
    names = axis_names(mesh)
    return tuple(sorted((a for a in out if a in names), key=names.index))


def axes_size(mesh, axes) -> int:
    """Product of the sizes of ``axes`` present on ``mesh``."""
    shape = mesh_shape(mesh)
    return int(np.prod([shape[a] for a in _axes(axes) if a in shape],
                       dtype=np.int64))


def axes_index(mesh, axes) -> int:
    """This rank's row-major coordinate over ``axes`` (the order the JAX
    package's ``P(("data", "fsdp"))`` splits a dim in)."""
    shape = mesh_shape(mesh)
    coord = dict(zip(axis_names(mesh), mesh.get_coordinate() or ()))
    index = 0
    for a in _axes(axes, mesh):
        index = index * shape[a] + int(coord[a])
    return index


def axes_group(mesh, axes):
    """The process group over ``axes`` of ``mesh`` that holds this rank
    (one axis: the mesh's own group; several: one group per combination of
    the other axes, made on every rank in the same order and cached)."""
    import torch.distributed as dist

    names = _axes(axes, mesh)
    if not names:
        raise ValueError(f"no axis of {axes!r} is on mesh {mesh_shape(mesh)}")
    if len(names) == 1:
        return mesh.get_group(names[0])
    cache = mesh.__dict__.setdefault("_blendjax_groups", {})
    group = cache.get(names)
    if group is None:
        dims = [axis_names(mesh).index(a) for a in names]
        others = [d for d in range(mesh.mesh.ndim) if d not in dims]
        ranks = mesh.mesh.permute(*others, *dims).reshape(
            -1, int(np.prod([mesh.mesh.shape[d] for d in dims])))
        me = dist.get_rank()
        for row in ranks.tolist():  # every rank makes every group
            g = dist.new_group(row)
            if me in row:
                group = g
        cache[names] = group
    return group


class RankAgreement:
    """Host-side agreement of the ranks of ``mesh`` on a few integers per
    call (:meth:`gather`), over a gloo group of its own.

    The live pipeline (:class:`~blendjax_torch.data.StreamDataPipeline`)
    and the echo pipeline use it so that ranks fed by different streams
    (each data group's) take the same decisions: how many batches exist,
    how many fresh batches to insert before a draw. Its own group keeps
    these calls apart from the step's collectives, which may run on
    another thread. It moves no device memory and is not a device
    collective (never tallied). Constructing one is collective: every rank
    of the default group makes its agreements in the same order."""

    def __init__(self, mesh):
        import torch.distributed as dist

        self.ranks = [int(r) for r in check_mesh(mesh).mesh.flatten().tolist()]
        self.group = dist.new_group(self.ranks, backend="gloo")

    def gather_objects(self, obj) -> list:
        """Every rank's picklable ``obj``, in rank order (host objects: the
        echo ring's scenario stamps)."""
        import torch.distributed as dist

        out = [None] * len(self.ranks)
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def gather(self, values) -> np.ndarray:
        """Every rank's ``values`` (integers), as an int64 array of shape
        ``(ranks, len(values))`` in rank order."""
        import torch
        import torch.distributed as dist

        t = torch.as_tensor(np.asarray(values, np.int64).reshape(-1))
        out = [torch.empty_like(t) for _ in self.ranks]
        dist.all_gather(out, t, group=self.group)
        return torch.stack(out).numpy()


class ModelAxisGroup:
    """The ranks of ``mesh`` that share this rank's rows of a batch split
    over ``batch_axes`` (its model-axis group: the ranks along ``tp``,
    ``seq``, ``expert``, ``pipe``), with a gloo group of their own to
    hand host objects from the group's first rank, the :attr:`leader`, to
    the others (:meth:`share`). Constructing one is collective: every rank
    makes every group, in the same order."""

    def __init__(self, mesh, batch_axes):
        import torch.distributed as dist

        names = axis_names(check_mesh(mesh))
        keep = [names.index(a) for a in _axes(batch_axes, mesh)]
        model = [d for d in range(mesh.mesh.ndim) if d not in keep]
        width = int(np.prod([mesh.mesh.shape[d] for d in model],
                            dtype=np.int64))
        rows = mesh.mesh.permute(*keep, *model).reshape(-1, width).tolist()
        me = dist.get_rank()
        self.group = None
        for row in rows:  # every rank makes every group
            g = dist.new_group(row, backend="gloo")
            if me in row:
                self.ranks, self.group = [int(r) for r in row], g
        self.leader = self.ranks[0]
        self.is_leader = me == self.leader

    def share(self, obj=None):
        """The leader's ``obj`` on every rank of the group (the leader
        passes it, the others pass nothing)."""
        import torch.distributed as dist

        box = [obj]
        dist.broadcast_object_list(box, src=self.leader, group=self.group)
        return box[0]


__all__ = ["MeshSpec", "ModelAxisGroup", "RankAgreement", "axes_group",
           "check_mesh", "axes_index", "axes_size", "axis_names",
           "create_mesh", "mesh_shape"]
