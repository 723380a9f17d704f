"""Shardings, parameter partition rules and layouts (port of
``blendjax/parallel/sharding.py``).

Two vocabularies, the JAX package's:

- **Axes**: the named mesh dimensions (``data``/``fsdp``/``tp``/``seq``/
  ``expert``; ``tensor`` is the legacy spelling of ``tp``).
- **Layouts**: how a run maps onto those axes. A :class:`Layout` names the
  composition (``data``, ``data×fsdp``, ``data×tp``, ``data×fsdp×tp``); a
  model's :class:`PartitionRule` set puts heads, the MLP hidden dim and the
  output head on the tensor axis.

A :class:`Sharding` is the port's ``NamedSharding``: a mesh and a
partition spec (one entry per tensor dim: ``None``, an axis name or a
tuple of names), with the DTensor placements it means
(:attr:`Sharding.placements`: ``Shard(dim)`` or ``Replicate()`` per mesh
dim) and this rank's slice of a full tensor (:meth:`Sharding.local`).
Specs are computed on the flax view of a parameter (the JAX package's
shapes and paths, :mod:`blendjax_torch.weights`), so one regex matches on
both sides and the specs compare equal to the reference's.

The batch side never shards over model axes: data enters over ``data``
(``fsdp`` folded into the leading dim as extra DP); in the port's
one-process-per-card form a batch sharding says which rows a rank keeps
(:func:`leading_shard_count` ways, this rank's index along them).
:func:`validate_batch_sharding` refuses a model axis on a batch by name.

:func:`state_shardings` gives a train state's per-leaf shardings
(params and the AdamW moments, under the JAX package's leaf paths) as a
:class:`StateShardings`, which also carries the explicit collectives the
step issues where the JAX package's jit puts them: the gradient and loss
means over the batch axes. :class:`ShardedParams` holds a state sharded
over a model axis (``fsdp``/``tp``/``expert``): each rank keeps its shard
of every parameter and AdamW moment as a plain tensor and updates its
shard (AdamW is elementwise, so the update is the replicated one). A
``tp`` or ``expert`` split that the parameter's module computes with
(its ``SPLIT_PARAMS``) is resident: the module computes with this rank's
block in place (the Megatron split of the attention, the MLP, the
embedding and the head; each rank's experts), the way the JAX package's
GSPMD jit compiles those layouts (``blendjax_torch/docs/mesh-split.md``),
also on an axis of size 1, where its collectives run over one rank.
An ``fsdp`` split is gathered for the step (gather on use, ZeRO-3).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

from blendjax_torch.parallel.mesh import (
    axes_index,
    axes_size,
    axis_names,
    mesh_shape,
)

def tensor_axis(mesh):
    """The mesh's tensor-parallel axis name (``tp`` preferred, ``tensor``
    legacy), or None."""
    for ax in ("tp", "tensor"):
        if ax in axis_names(mesh):
            return ax
    return None


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(
        a for a in entry if a is not None)


class Sharding:
    """A mesh and a partition spec (the port's ``NamedSharding``)."""

    def __init__(self, mesh, spec=()):
        self.mesh = mesh
        spec = list(spec or ())
        while spec and spec[-1] is None:  # canonical: () == replicated
            spec.pop()
        self.spec = tuple(spec)

    def __eq__(self, other):
        return (isinstance(other, Sharding) and other.mesh is self.mesh
                and other.spec == self.spec)

    def __repr__(self):
        return f"Sharding({mesh_shape(self.mesh)}, {self.spec})"

    @property
    def placements(self) -> list:
        """One DTensor placement per mesh dim: ``Shard(d)`` where the spec
        puts that axis on tensor dim ``d``, else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for name in axis_names(self.mesh):
            dims = [d for d, e in enumerate(self.spec)
                    if name in _entry_axes(e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return out

    def local(self, t):
        """This rank's slice of the full tensor ``t`` (views, no copy)."""
        for d, entry in enumerate(self.spec):
            rows = rank_range(self.mesh, _entry_axes(entry), t.shape[d])
            if rows is not None:
                t = t.narrow(d, *rows)
        return t

    @property
    def sharded(self) -> bool:
        return any(axes_size(self.mesh, _entry_axes(e)) > 1
                   for e in self.spec)


def check_sharding(sharding):
    """``sharding`` unchanged when it is ``None`` or a :class:`Sharding`; a
    ``TypeError`` otherwise."""
    if sharding is not None and not isinstance(sharding, Sharding):
        raise TypeError(
            f"expected a blendjax_torch.parallel.Sharding, got "
            f"{type(sharding).__name__}")
    return sharding


def batch_sharding(mesh, axis: str = "data") -> Sharding:
    """The batch's leading dim over ``axis``, with ``fsdp`` folded in as
    extra data parallelism when the mesh has it."""
    names = [axis] if axis in axis_names(mesh) else []
    if "fsdp" in axis_names(mesh) and axis == "data":
        names.append("fsdp")
    return Sharding(mesh, (tuple(names),) if names else ())


def replicated(mesh) -> Sharding:
    return Sharding(mesh, ())


def ring_sharding(mesh, axis: str = "data") -> Sharding:
    """A device ring's capacity axis split like :func:`batch_sharding`."""
    return batch_sharding(mesh, axis=axis)


# -- per-model partition rules ------------------------------------------------


@dataclass(frozen=True)
class PartitionRule:
    """One explicit parameter-layout override: ``pattern`` is searched in
    the ``/``-joined flax path (``block0/MultiHeadAttention_0/qkv/kernel``);
    ``spec`` has one entry per *trailing* dim. An axis the mesh lacks, or
    whose size does not divide the dim, drops to ``None``."""

    pattern: str
    spec: tuple


#: Megatron-style transformer layout (the JAX package's rules verbatim)
DEFAULT_TP_RULES = (
    PartitionRule(r"qkv/kernel$", ("tp", None)),        # heads dim
    PartitionRule(r"proj/kernel$", ("tp", None)),       # attn out, row
    PartitionRule(r"block\d+/Dense_0/kernel$", ("tp",)),  # MLP hidden
    PartitionRule(r"block\d+/Dense_1/kernel$", ("tp", None)),  # MLP out
)


def _path_str(path: tuple) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                    for k in path)


def _mesh_axis(mesh, name, unit: bool = False):
    """A rule's axis on the mesh (``tp`` and ``tensor`` interchangeable);
    None when absent or, unless ``unit``, of size 1."""
    if name in ("tp", "tensor"):
        name = tensor_axis(mesh)
    shape = mesh_shape(mesh)
    if name is None or name not in shape:
        return None
    return name if unit or shape[name] > 1 else None


def param_sharding_rules(mesh, path: tuple, value, rules=(),
                         unit: bool = False) -> Sharding:
    """The layout of one parameter (given by its flax path and flax-view
    ``value`` or shape): the first matching rule, then the generic
    defaults (``expert_*`` on dim 0 over ``expert``; the last dim over
    ``tp``; the largest free divisible dim over ``fsdp``; small leaves
    replicated), as the JAX package's. ``unit`` keeps a model axis of
    size 1 where the rules put it (the split a module computes with at
    one rank, and the gather of an ``fsdp`` shard over one rank,
    :class:`ShardedParams`)."""
    shape = tuple(getattr(value, "shape", value if isinstance(
        value, tuple) else ()))
    sizes = mesh_shape(mesh)
    spec = [None] * len(shape)
    name = str(getattr(path[-1], "key", path[-1])) if path else ""
    matched = False
    if rules:
        pstr = _path_str(path)
        for rule in rules:
            if not re.search(rule.pattern, pstr):
                continue
            matched = True
            for i, ax in enumerate(reversed(rule.spec)):
                dim = len(shape) - 1 - i
                if dim < 0 or ax is None:
                    continue
                ax = _mesh_axis(mesh, ax, unit)
                if ax is not None and shape[dim] % sizes[ax] == 0:
                    spec[dim] = ax
            break
    if (not matched and "expert" in sizes and name.startswith("expert_")
            and shape and shape[0] % sizes["expert"] == 0):
        spec[0] = "expert"
    if len(shape) >= 2:
        tp = tensor_axis(mesh)
        if not matched and tp is not None:
            ways = sizes[tp]
            if (ways > 1 or unit) and shape[-1] % ways == 0:
                spec[-1] = tp
        fs = sizes.get("fsdp", 1)
        if "fsdp" in sizes and (fs > 1 or unit):
            for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
                if spec[i] is None and shape[i] % fs == 0:
                    spec[i] = "fsdp"
                    break
    return Sharding(mesh, spec)


def shard_params(mesh, params: dict, rules=()) -> dict:
    """``{flax path: full tensor (flax view)}`` -> ``{path: DTensor}``,
    each the rank's shard under :func:`param_sharding_rules` (taken
    locally from the full tensor every rank holds; no collective)."""
    from torch.distributed.tensor import DTensor

    out = {}
    for path, t in params.items():
        keys = tuple(path.split("/")) if isinstance(path, str) else path
        sh = param_sharding_rules(mesh, keys, t, rules=rules)
        out[path] = DTensor.from_local(sh.local(t).contiguous(), mesh,
                                       sh.placements, run_check=False)
    return out


# -- layouts ------------------------------------------------------------------


@dataclass(frozen=True)
class Layout:
    """How a run maps onto mesh axes: axis sizes and partition rules.
    ``data=-1`` absorbs the ranks the model axes leave; ``rules`` ``None``
    asks the model (``model.partition_rules()``)."""

    name: str = "data"
    data: int = -1
    fsdp: int = 1
    tp: int = 1
    seq: int = 1
    rules: tuple | None = field(default=None, compare=False)

    def mesh_axes(self) -> dict:
        """Axis sizes for :func:`create_mesh`, ``tp`` innermost."""
        axes = {"data": self.data}
        if self.fsdp != 1:
            axes["fsdp"] = self.fsdp
        if self.seq != 1:
            axes["seq"] = self.seq
        if self.tp != 1:
            axes["tp"] = self.tp
        return axes

    def create_mesh(self, devices=None):
        from blendjax_torch.parallel.mesh import create_mesh

        return create_mesh(self.mesh_axes(), devices=devices)


#: the canonical layout names
LAYOUTS = ("data", "data×fsdp", "data×tp", "data×fsdp×tp")

_AXIS_SIZE_RE = re.compile(r"^([a-z]+?)(\d+)?$")

#: a model axis named without a size splits 2 ways; ``data`` absorbs
_DEFAULT_WAYS = 2


def resolve_layout(layout) -> Layout:
    """A :class:`Layout`, ``None`` (pure data parallelism), an axis dict or
    a name (``"data×fsdp"``, ``"data2xfsdp4"``, ``"data4×tp2"``) ->
    :class:`Layout`, with the JAX package's parsing."""
    if layout is None:
        return Layout("data")
    if isinstance(layout, Layout):
        return layout
    if isinstance(layout, dict):
        sizes = dict(layout)
        name = "×".join(sizes) if sizes else "data"
        return Layout(
            name=name,
            data=int(sizes.pop("data", 1)),
            fsdp=int(sizes.pop("fsdp", 1)),
            tp=int(sizes.pop("tp", sizes.pop("tensor", 1))),
            seq=int(sizes.pop("seq", 1)),
        )
    text = str(layout).strip().lower().replace("×", "x")
    sizes: dict = {}
    for part in (p for p in re.split(r"[x_*\s+,]+", text) if p):
        m = _AXIS_SIZE_RE.match(part)
        axis = m.group(1) if m else part
        if axis == "tensor":
            axis = "tp"
        if m is None or axis not in ("data", "fsdp", "tp", "seq"):
            raise ValueError(
                f"unknown layout axis {part!r} in {layout!r}: compose from "
                "data/fsdp/tp/seq (optionally sized, e.g. 'data2xfsdp4'); "
                "canonical layouts: " + ", ".join(LAYOUTS))
        if m.group(2) is not None:
            sizes[axis] = int(m.group(2))
        else:
            sizes[axis] = -1 if axis == "data" else _DEFAULT_WAYS
    if "data" not in sizes:
        sizes["data"] = 1
    canonical = "×".join(
        ax for ax in ("data", "fsdp", "seq", "tp")
        if ax in sizes and (ax == "data" or sizes[ax] != 1))
    return Layout(
        name=canonical or "data",
        data=sizes.get("data", -1),
        fsdp=sizes.get("fsdp", 1),
        tp=sizes.get("tp", 1),
        seq=sizes.get("seq", 1),
    )


def resolve_rules(rules=None, layout=None, model=None) -> tuple:
    """Explicit ``rules`` win, then the layout's, then the model's
    ``partition_rules()``, then none."""
    if rules is not None:
        return tuple(rules)
    if layout is not None:
        lay = resolve_layout(layout)
        if lay.rules is not None:
            return tuple(lay.rules)
    pr = getattr(model, "partition_rules", None)
    if callable(pr):
        return tuple(pr())
    return ()


def mesh_chip_count(mesh) -> int:
    """Cards in the mesh: the product over every axis."""
    shape = mesh_shape(mesh)
    return int(np.prod(list(shape.values()))) if shape else 1


# -- the batch side -----------------------------------------------------------


def leading_shard_count(sharding) -> int:
    """How many ways ``sharding`` splits dim 0 (1 for ``None``)."""
    spec = getattr(sharding, "spec", None)
    mesh = getattr(sharding, "mesh", None)
    if not spec or mesh is None:
        return 1
    return axes_size(mesh, _entry_axes(spec[0]))


def leading_axes(sharding) -> tuple:
    """The mesh axes of ``sharding``'s dim 0 (``()`` when replicated)."""
    spec = getattr(sharding, "spec", None)
    return _entry_axes(spec[0]) if spec else ()


def rank_range(mesh, axes, size: int):
    """``(start, length)`` of this rank's share of a dim of ``size`` split
    over ``axes`` (a name or names; row-major in mesh order), or None when
    they do not split it. A size they do not divide raises: every rank
    takes an equal share."""
    ways = axes_size(mesh, axes) if mesh is not None else 1
    if ways <= 1:
        return None
    if size % ways:
        raise ValueError(
            f"a dim of {size} must divide evenly over the {ways}-way axes "
            f"{axes!r} of mesh {mesh_shape(mesh)}")
    share = size // ways
    return axes_index(mesh, axes) * share, share


def local_rows(x, sharding):
    """This rank's rows of a full-batch ``x`` (dim 0 split
    :func:`leading_shard_count` ways); the lead must divide."""
    rows = rank_range(getattr(sharding, "mesh", None),
                      leading_axes(sharding), int(x.shape[0]))
    return x if rows is None else x[rows[0]:rows[0] + rows[1]]


def validate_batch_sharding(sharding, data_axis: str = "data",
                            what: str = "batch"):
    """Build-time gate: data enters over ``data`` only (dim 0, with the
    ``fsdp`` fold); inner dims only over ``seq``. A model axis anywhere
    else raises with the axis named. Returns ``sharding``."""
    spec = getattr(sharding, "spec", None)
    if not spec:
        return sharding
    for dim, entry in enumerate(spec):
        names = _entry_axes(entry)
        if not names:
            continue
        if dim == 0:
            bad = [n for n in names if n not in (data_axis, "fsdp")]
            if not bad and "fsdp" in names and data_axis not in names:
                bad = ["fsdp"]  # fsdp folds WITH data, never alone
        else:
            bad = [n for n in names if n != "seq"]
        if bad:
            raise ValueError(
                f"{what} sharding {tuple(spec)!r} puts mesh axis {bad[0]!r} "
                f"on dim {dim}: data enters over {data_axis!r} (dim 0; fsdp "
                "folds in as extra DP) only. fsdp/tp partition parameters, "
                "not batches: use batch_sharding(mesh)/ring_sharding(mesh) "
                "for the batch side and Layout/partition rules for the state")
    return sharding


# -- the train state ----------------------------------------------------------


def _batch_axes(mesh, data_axis: str = "data") -> tuple:
    return leading_axes(batch_sharding(mesh, axis=data_axis))


class StateShardings(dict):
    """``{train-state leaf path: Sharding}`` (the JAX package's leaf paths,
    :func:`blendjax_torch.weights.train_state_leaves`), plus the explicit
    collectives a mesh step issues where the JAX package's jit puts them:
    :meth:`reduce_grads` (the mean over the batch axes) and
    :meth:`reduce_loss`."""

    def __init__(self, items=(), mesh=None, data_axis: str = "data"):
        super().__init__(items)
        self.mesh = mesh
        self.data_axis = data_axis
        self.batch_axes = _batch_axes(mesh, data_axis) if mesh else ()
        self.batch_ways = axes_size(mesh, self.batch_axes) if mesh else 1

    def reduce_grads(self, grads) -> tuple:
        """The gradients' mean over the batch axes: one flat all-reduce
        (a no-op off a mesh)."""
        if not self.batch_axes:
            return tuple(grads)
        from blendjax_torch.parallel.collectives import flat_all_reduce_mean

        return flat_all_reduce_mean(grads, self.mesh, self.batch_axes)

    def reduce_loss(self, loss):
        """The batch loss as the JAX package reports it: the mean of the
        ranks' losses (each a mean over as many rows)."""
        if not self.batch_axes:
            return loss
        from blendjax_torch.parallel.collectives import flat_all_reduce_mean

        return flat_all_reduce_mean([loss], self.mesh, self.batch_axes)[0]

    def row_weight(self, mask):
        """For a masked batch: ``ways x local real rows / global real
        rows``, the factor that makes the mean of the ranks' masked losses
        (and gradients) the global masked mean."""
        import torch

        from blendjax_torch.parallel.collectives import all_reduce_sum

        local = mask.float().sum().reshape(1)
        total = all_reduce_sum(local.clone(), self.mesh, self.batch_axes,
                               differentiable=False)
        return (self.batch_ways * local / total.clamp(min=1.0)).reshape(()) \
            .to(torch.float32)


def _leaf_path_keys(path: str) -> tuple:
    """``.opt_state[0].mu['block0']['qkv']['kernel']`` -> ("opt_state",
    "[0]", "mu", "block0", "qkv", "kernel"), the key strings the JAX
    package's ``tree_map_with_path`` joins."""
    out = []
    for tok in re.findall(r"\.(\w+)|\['([^']*)'\]|\[(\d+)\]", path):
        attr, key, idx = tok
        out.append(attr or key or f"[{idx}]")
    return tuple(out)


def state_shardings(state, mesh=None, rules=None, layout=None,
                    data_axis: str = "data") -> StateShardings:
    """The sharding of every leaf of a port ``TrainState`` under the JAX
    package's leaf paths.

    With ``rules`` or ``layout`` (and a mesh) the tree is derived from the
    leaf paths (``params/...``, ``opt_state/[0]/mu/...``,
    ``opt_state/[0]/nu/...``) through :func:`param_sharding_rules`, so
    the AdamW moments land on their parameters' layout, as the JAX
    package's does. With only ``mesh`` it reads the state's own layout
    (its :class:`ShardedParams`, else replicated)."""
    from blendjax_torch.weights import train_state_specs

    if layout is not None and rules is None:
        rules = resolve_rules(layout=layout)
    if mesh is None:
        shards = getattr(state, "shards", None)
        mesh = getattr(shards, "mesh", None)
        if mesh is None:
            return StateShardings(
                {p: None for p, _shape in train_state_specs(state)})
    out = StateShardings(mesh=mesh, data_axis=data_axis)
    shards = getattr(state, "shards", None)
    for path, shape in train_state_specs(state):
        if rules is not None:
            out[path] = param_sharding_rules(
                mesh, _leaf_path_keys(path), shape, rules=tuple(rules))
        elif shards is not None and path in shards.leaf_specs:
            out[path] = shards.leaf_specs[path]
        else:
            out[path] = replicated(mesh)
    return out


def state_resident_bytes(state) -> int:
    """Bytes one rank holds of a train state: every parameter and AdamW
    tensor at its local shard (a sharded state's module parameters are
    empty between steps, or share their resident shard's storage)."""
    import torch

    seen = set()
    total = 0

    def add(t):
        nonlocal total
        if not isinstance(t, torch.Tensor) or not t.numel():
            return
        key = (t.untyped_storage().data_ptr(), t.storage_offset())
        if key in seen:
            return
        seen.add(key)
        total += int(t.numel()) * t.element_size()

    for p in state.model.parameters():
        add(p)
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            add(p)
            for v in state.optimizer.state.get(p, {}).values():
                add(v)
    return total


def model_shardings(model, mesh, rules=(), unit: bool = False) -> list:
    """``(parameter, flax path, layout, Sharding of its flax view)`` of
    every parameter of ``model``, in ``model.parameters()`` order (the
    order its gradients come in); ``unit`` as in
    :func:`param_sharding_rules`."""
    from blendjax_torch.weights import flax_params

    names = {id(p): (path, layout) for path, p, layout in flax_params(model)}
    out = []
    for p in model.parameters():
        path, layout = names[id(p)]
        keys = _leaf_path_keys(".params" + path)[1:]
        out.append((p, path, layout, param_sharding_rules(
            mesh, keys, _flax_shape(p.shape, layout), rules, unit)))
    return out


def _kind(axis: str):
    """The split kind of a model axis a module can compute on in place:
    ``tp`` (its legacy spelling ``tensor`` too) or ``expert``."""
    return "tp" if axis in ("tp", "tensor") else (
        "expert" if axis == "expert" else None)


def resident_params(model) -> dict:
    """``{id(parameter): (module, name, {kind: flax dims})}``: the
    parameters whose split over a model axis their module can compute with
    in place, and on which flax dims, from each module's ``SPLIT_PARAMS``
    (``{kind: {regex of a parameter name relative to the module: flax
    dims}}``, kinds ``tp`` and ``expert``)."""
    out: dict = {}
    for _name, mod in model.named_modules():
        table = getattr(type(mod), "SPLIT_PARAMS", None)
        if not table:
            continue
        for rel, p in mod.named_parameters():
            kinds = {kind: dims for kind, names in table.items()
                     for pat, dims in names.items() if re.fullmatch(pat, rel)}
            if kinds:
                out[id(p)] = (mod, rel, kinds)
    return out


def _view_of(shape, layout) -> tuple:
    """``(view, flax dim -> view dim, torch dim -> its view dims)`` of a
    torch parameter of ``shape``: the view in which each flax dim is a dim
    of its own (a ``DenseGeneral`` kernel's (3, H, D) output unflattened),
    so a split of one flax dim is a narrow of one view dim."""
    shape = tuple(shape)
    if layout == "conv":  # flax (H, W, I, O) -> torch (O, I, H, W)
        return shape, {0: 2, 1: 3, 2: 1, 3: 0}, [(0,), (1,), (2,), (3,)]
    if layout == "dense":
        return shape, {0: 1, 1: 0}, [(0,), (1,)]
    if isinstance(layout, tuple) and layout[0] == "general":
        out = tuple(layout[1])  # torch (prod(out), C), flax (C, *out)
        k = len(out)
        return ((*out, shape[1]), {0: k, **{i + 1: i for i in range(k)}},
                [tuple(range(k)), (k,)])
    if isinstance(layout, tuple) and layout[0] == "reshape":
        view = tuple(layout[1])
        return (view, {i: i for i in range(len(view))},
                [tuple(range(len(view)))])
    return shape, {i: i for i in range(len(shape))}, [(i,) for i in
                                                      range(len(shape))]


class Resident:
    """A parameter's split over one model axis that its module computes
    with in place (the ranks of the axis never gather it): this rank's
    block of flax dim :attr:`flax_dim` (view dim :attr:`dim` of the
    parameter's unflattened view). The module reads it with
    :func:`split_of` (by name, so a ``functional_call`` that swaps the
    parameter tensors keeps it)."""

    def __init__(self, mesh, axis: str, shape, layout, flax_dim: int):
        self.mesh, self.axis, self.flax_dim = mesh, axis, int(flax_dim)
        self.shape = tuple(shape)
        self.view, where, groups = _view_of(shape, layout)
        self.dim = where[self.flax_dim]
        self.ways = axes_size(mesh, axis)
        self.index = axes_index(mesh, axis)
        self.size = self.view[self.dim] // self.ways
        self.local_view = tuple(self.size if i == self.dim else n
                                for i, n in enumerate(self.view))
        self.local_shape = tuple(int(np.prod([self.local_view[i] for i in g],
                                             dtype=np.int64)) for g in groups)

    def local(self, t):
        """This rank's block of the full tensor ``t`` (a copy)."""
        return (t.reshape(self.view).narrow(self.dim, self.index * self.size,
                                            self.size)
                .contiguous().reshape(self.local_shape))

    def full(self, local):
        """The full tensor from every rank's block (one all-gather)."""
        from blendjax_torch.parallel.collectives import all_gather

        return all_gather(local.reshape(self.local_view), self.mesh,
                          self.axis, dim=self.dim,
                          differentiable=False).reshape(self.shape)


def _resident_split(flax_spec, allowed: dict):
    """``(flax dim, axis)`` of the spec's one axis of a kind ``allowed``
    (``{kind: flax dims}``) on one of its dims, None when there is none,
    and the spec without it."""
    found, rest = None, []
    for d, entry in enumerate(flax_spec):
        keep = []
        for ax in _entry_axes(entry):
            if found is None and d in allowed.get(_kind(ax), ()):
                found = (d, ax)
            else:
                keep.append(ax)
        rest.append(tuple(keep) if len(keep) > 1 else
                    (keep[0] if keep else None))
    return found, tuple(rest)


def _gathers(sh: Sharding) -> bool:
    """Whether a shard of ``sh`` is gathered for a step: it is split over
    more than one rank, or over an ``fsdp`` axis of any size (at size 1
    the gather runs over one rank, as the split of a ``tp`` or ``expert``
    axis of size 1 runs)."""
    return sh.sharded or any("fsdp" in _entry_axes(e) for e in sh.spec)


def splits_state(model, mesh, rules=()) -> bool:
    """Whether ``model``'s train state on ``mesh`` under ``rules`` is a
    :class:`ShardedParams`: some parameter is split over more than one
    rank or over an ``fsdp`` axis, or its module computes with it split
    over a ``tp`` or ``expert`` axis of the mesh, of any size (at size 1
    the split, or the gather, runs with its collectives over one rank)."""
    can = resident_params(model)
    return any(_gathers(sh) or (id(p) in can and _resident_split(
        sh.spec, can[id(p)][2])[0] is not None)
        for p, _path, _layout, sh in model_shardings(model, mesh, rules,
                                                     unit=True))


def _drop_broken_groups(mesh, can: dict, found: dict) -> None:
    """A module's ``SPLIT_GROUPS`` (names it computes with split only all
    together, a Megatron pair) lose their resident splits, to gathered
    shards, unless every member has one. A module's ``check_split(found)``
    (``{name: (flax dim, axis, ways)}`` of its candidates) runs first and
    raises on a split it cannot compute."""
    by_mod: dict = {}
    for pid, (mod, rel, _kinds) in can.items():
        by_mod.setdefault(id(mod), (mod, {}))[1][rel] = pid
    for mod, names in by_mod.values():
        mine = {rel: (*found[pid], axes_size(mesh, found[pid][1]))
                for rel, pid in names.items() if found.get(pid) is not None}
        check = getattr(mod, "check_split", None)
        if check is not None:
            check(mine)
        for group in getattr(type(mod), "SPLIT_GROUPS", ()):
            if 0 < sum(n in mine for n in group) < len(group):
                for n in group:
                    found[names[n]] = None


class ShardedParams:
    """A train state split over model axes (``fsdp``/``tp``/``expert``):
    each rank keeps its shard of each parameter and AdamW moment as a plain
    tensor that an AdamW of its own updates (AdamW is elementwise: the
    shards need no DTensor). A shard is one of two kinds:

    - **resident**: a split over ``tp`` or ``expert`` that the parameter's
      module computes with in place (``SPLIT_PARAMS``; the Megatron split
      of :class:`~blendjax_torch.models.StreamFormer` and
      :class:`~blendjax_torch.models.CubeRegressor`, the experts of
      :class:`~blendjax_torch.models.MoEMLP`): the module's parameter IS
      this rank's block (:class:`Resident`, :func:`split_of`), never
      gathered; its gradient is this rank's block's;
    - **gathered**: an ``fsdp`` split, of any size (at size 1 the gather
      runs over one rank), and a model-axis split of a parameter no module
      computes with: :meth:`gather` all-gathers it into the module before
      a step (gather on use), :meth:`step` takes this rank's slice of the
      reduced gradient.

    :attr:`specs` are the full layouts (each parameter's flax-view spec on
    its torch dims); :meth:`full_leaves` and :meth:`load_full` give and
    take full values, so a snapshot reads the same in both packages.

    The AdamW (``optimizer_kwargs`` over ``optax.adamw``'s defaults; an RL
    state's Adam is ``weight_decay=0``) is capturable on a CUDA device: its
    step counts live on the card, so :mod:`blendjax_torch.train.aot`
    captures a whole step, the gathers included. Inside a capture the
    gathered tensors are the graph's own (its private pool): each replay
    writes the gather where the captured forward reads it.
    ``optimizer=False`` holds shards that no optimizer updates (an RL
    state's target network, updated on its shards in place)."""

    def __init__(self, model, mesh, rules=(), optimizer_kwargs=None,
                 optimizer: bool = True):
        import torch

        self.mesh = mesh
        self.model = model
        self.params: list = []   # module parameters, in model order
        self.shards: list = []   # this rank's shard of each
        self.specs: list = []    # Sharding of each on its torch dims
        self.leaf_specs: dict = {}  # leaf path -> Sharding (flax view)
        self.residents: list = []  # Resident or None, per parameter
        self.gathered: list = []  # Sharding of the gathered axes, per one
        self.gathers: list = []   # whether each is gathered for a step
        self.full_shapes: list = []
        can = resident_params(model)
        for mod, _rel, _kinds in can.values():
            mod._bjx_splits = {}
        layers = model_shardings(model, mesh, rules)
        # the layouts with the model axes of size 1 kept: a module computes
        # with its split over one rank as over several
        units = [sh.spec for *_rest, sh in model_shardings(model, mesh,
                                                           rules, unit=True)]
        found = {id(p): _resident_split(spec, can[id(p)][2])[0]
                 for (p, *_rest), spec in zip(layers, units) if id(p) in can}
        _drop_broken_groups(mesh, can, found)
        for (p, path, layout, flax_sh), unit_spec in zip(layers, units):
            for prefix in (".params", ".opt_state[0].mu",
                           ".opt_state[0].nu"):
                self.leaf_specs[prefix + path] = flax_sh
            self.specs.append(Sharding(mesh, _torch_spec(
                flax_sh.spec, p.ndim, layout)))
            owner = can.get(id(p))
            allowed = owner[2] if owner and found.get(id(p)) else {}
            where, rest = _resident_split(unit_spec, allowed)
            res = None if where is None else Resident(
                mesh, where[1], p.shape, layout, where[0])
            full = p.detach()
            local = full if res is None else res.local(full)
            gsh = Sharding(mesh, _torch_spec(rest, local.ndim, layout))
            shard = torch.nn.Parameter(gsh.local(local).clone())
            if res is not None:
                owner[0]._bjx_splits[owner[1]] = res
            self.params.append(p)
            self.full_shapes.append(tuple(p.shape))
            self.shards.append(shard)
            self.residents.append(res)
            self.gathered.append(gsh)
            self.gathers.append(_gathers(gsh))
        self.optimizer = None
        if optimizer:
            kw = dict(lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                      weight_decay=1e-4)
            kw.update(optimizer_kwargs or {})
            kw["foreach"] = False
            kw.pop("fused", None)
            kw["capturable"] = bool(self.shards) and all(
                t.device.type == "cuda" for t in self.shards)
            self.optimizer = torch.optim.AdamW(self.shards, **kw)
        self.release()

    def full_shape(self, p) -> tuple:
        """The full (unsplit) shape of module parameter ``p``."""
        for q, shape in zip(self.params, self.full_shapes):
            if q is p:
                return shape
        return tuple(p.shape)

    def release(self) -> None:
        """Point each module parameter at its shard: the shard itself when
        nothing of it is gathered, else an empty tensor until
        :meth:`gather`."""
        import torch

        for p, shard, gathers in zip(self.params, self.shards, self.gathers):
            if gathers:
                p.data = torch.empty(0, dtype=p.dtype, device=p.device)
            else:
                p.data = shard.data

    def gather(self) -> None:
        """All-gather every gathered shard into its module parameter (a
        resident one stays this rank's block)."""
        for p, shard, gsh, gathers in zip(self.params, self.shards,
                                          self.gathered, self.gathers):
            if gathers:
                p.data = gather_full(shard.detach(), gsh)

    def step(self, grads) -> None:
        """AdamW on the shards from this rank's slice of each (already
        reduced) gradient, then :meth:`release`."""
        for shard, g, gsh in zip(self.shards, grads, self.gathered):
            shard.grad = gsh.local(g).contiguous()
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.release()

    def full_params(self) -> list:
        """The full value of every parameter, in :attr:`params` order
        (all-gathers: every rank calls it)."""
        return [self._full(shard.detach(), i)
                for i, shard in enumerate(self.shards)]

    def load_params(self, values: list) -> None:
        """Write full parameter values (the order of :attr:`params`) into
        this rank's shards, in place."""
        import torch

        with torch.no_grad():
            for i, (shard, value) in enumerate(zip(self.shards, values)):
                shard.copy_(self._local(value, i))

    def _full(self, local, i):
        t = gather_full(local, self.gathered[i])
        res = self.residents[i]
        return t if res is None else res.full(t)

    def full_leaves(self) -> list:
        """``(parameter, full value, full exp_avg, full exp_avg_sq, step)``
        of every parameter (all-gathers: every rank calls it)."""
        import torch

        out = []
        for i, (p, shard) in enumerate(zip(self.params, self.shards)):
            entry = self.optimizer.state.get(shard, {})
            moments = []
            for name in ("exp_avg", "exp_avg_sq"):
                t = entry.get(name)
                local = t if t is not None else torch.zeros_like(shard)
                moments.append(self._full(local.detach(), i))
            step = entry.get("step")
            out.append((p, self._full(shard.detach(), i), *moments,
                        None if step is None else step))
        return out

    def _local(self, value, i):
        res = self.residents[i]
        return self.gathered[i].local(value if res is None
                                      else res.local(value))

    def load_full(self, values: list, count: int) -> None:
        """Write full values ``[(param, exp_avg, exp_avg_sq)]`` (the order
        of :attr:`params`) into this rank's shards, in place."""
        import torch

        on_card = bool(self.optimizer.param_groups[0].get("capturable"))
        with torch.no_grad():
            for i, (shard, (value, mu, nu)) in enumerate(zip(self.shards,
                                                              values)):
                shard.copy_(self._local(value, i))
                entry = self.optimizer.state[shard]
                if not entry:
                    # a capturable AdamW's count lives beside its shard
                    entry["step"] = torch.zeros(
                        (), dtype=torch.float32,
                        device=shard.device if on_card else "cpu")
                    entry["exp_avg"] = torch.zeros_like(shard)
                    entry["exp_avg_sq"] = torch.zeros_like(shard)
                entry["step"].fill_(count)
                entry["exp_avg"].copy_(self._local(mu, i))
                entry["exp_avg_sq"].copy_(self._local(nu, i))


def split_of(module, name: str):
    """The :class:`Resident` split of ``module``'s parameter ``name`` (a
    name relative to it, as in its ``SPLIT_PARAMS``); None when this rank
    holds the parameter whole."""
    return module.__dict__.get("_bjx_splits", {}).get(name)


def gather_full(local, sh: Sharding):
    """The full tensor from this rank's ``local`` shard of ``sh``: one
    all-gather per split dim (recorded as the collectives' all-gather
    bytes, on the dim's axes); a dim on an ``fsdp`` axis of size 1 too,
    over one rank."""
    from blendjax_torch.parallel.collectives import all_gather

    t = local
    for d in reversed(range(len(sh.spec))):
        axes = _entry_axes(sh.spec[d])
        if axes_size(sh.mesh, axes) > 1 or "fsdp" in axes:
            t = all_gather(t, sh.mesh, axes, dim=d, differentiable=False)
    return t


def _flax_shape(shape, layout) -> tuple:
    """The flax view's shape of a port parameter of ``shape`` (``layout``
    as in :func:`blendjax_torch.weights.flax_params`)."""
    shape = tuple(shape)
    if layout == "conv":
        o, i, h, w = shape
        return (h, w, i, o)
    if layout == "dense":
        return shape[::-1]
    if isinstance(layout, tuple) and layout[0] == "general":
        return (shape[1], *layout[1])
    if isinstance(layout, tuple) and layout[0] == "reshape":
        return tuple(layout[1])
    return shape


def _torch_spec(flax_spec: tuple, ndim: int, layout) -> tuple:
    """A flax-view spec moved onto the torch parameter's dims. Dims the
    torch layout flattens into one (a ``DenseGeneral`` kernel's (3, H, D)
    output) take the split on the flattened dim: the shard holds other
    elements than the flax shard, which an elementwise optimizer does not
    see."""
    flax_spec = tuple(flax_spec) + (None,) * 8
    if layout == "conv":  # flax (H, W, I, O) -> torch (O, I, H, W)
        where = {0: 2, 1: 3, 2: 1, 3: 0}
    elif layout == "dense":
        where = {0: 1, 1: 0}
    elif isinstance(layout, tuple) and layout[0] == "general":
        where = {0: 1, **{i: 0 for i in range(1, 1 + len(layout[1]))}}
    elif isinstance(layout, tuple) and layout[0] == "reshape":
        where = {i: 0 for i in range(len(layout[1]))}
    else:
        where = {i: i for i in range(ndim)}
    spec: list = [None] * ndim
    for fd, td in where.items():
        axes = _entry_axes(flax_spec[fd])
        if not axes:
            continue
        spec[td] = tuple(_entry_axes(spec[td])) + axes
    return tuple(s if s is None or len(s) > 1 else s[0] for s in spec)


__all__ = [
    "DEFAULT_TP_RULES",
    "LAYOUTS",
    "Layout",
    "PartitionRule",
    "ShardedParams",
    "Resident",
    "Sharding",
    "StateShardings",
    "batch_sharding",
    "check_sharding",
    "leading_axes",
    "leading_shard_count",
    "local_rows",
    "model_shardings",
    "splits_state",
    "rank_range",
    "mesh_chip_count",
    "param_sharding_rules",
    "replicated",
    "resolve_layout",
    "resolve_rules",
    "ring_sharding",
    "shard_params",
    "split_of",
    "state_resident_bytes",
    "state_shardings",
    "tensor_axis",
    "validate_batch_sharding",
]
