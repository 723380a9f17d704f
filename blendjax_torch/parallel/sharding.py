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
of every parameter and AdamW moment as a plain tensor, gathers the full
parameters for the step (gather on use) and updates its shard (ZeRO-3;
AdamW is elementwise, so the update is the replicated one). These axes
split the state only: ``tp`` has the rules' placements but no split of
the matmuls, and ``expert`` places a mixture of experts' ``expert_*``
weights on dim 0 with no all-to-all of the tokens to their experts' ranks,
so the ranks of a ``tp`` or ``expert`` group compute the same step
(ROADMAP item 5c).
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


def _mesh_axis(mesh, name):
    """A rule's axis on the mesh (``tp`` and ``tensor`` interchangeable);
    None when absent or of size 1."""
    if name in ("tp", "tensor"):
        name = tensor_axis(mesh)
    shape = mesh_shape(mesh)
    if name is None or name not in shape:
        return None
    return name if shape[name] > 1 else None


def param_sharding_rules(mesh, path: tuple, value, rules=()) -> Sharding:
    """The layout of one parameter (given by its flax path and flax-view
    ``value`` or shape): the first matching rule, then the generic
    defaults (``expert_*`` on dim 0 over ``expert``; the last dim over
    ``tp``; the largest free divisible dim over ``fsdp``; small leaves
    replicated), as the JAX package's."""
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
                ax = _mesh_axis(mesh, ax)
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
            if ways > 1 and shape[-1] % ways == 0:
                spec[-1] = tp
        fs = sizes.get("fsdp", 1)
        if fs > 1:
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
    empty between steps)."""
    import torch

    seen = set()
    total = 0

    def add(t):
        nonlocal total
        if not isinstance(t, torch.Tensor) or id(t) in seen:
            return
        seen.add(id(t))
        total += int(t.numel()) * t.element_size()

    for p in state.model.parameters():
        add(p)
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            add(p)
            for v in state.optimizer.state.get(p, {}).values():
                add(v)
    return total


def model_shardings(model, mesh, rules=()) -> list:
    """``(parameter, flax path, layout, Sharding of its flax view)`` of
    every parameter of ``model``, in ``model.parameters()`` order (the
    order its gradients come in)."""
    from blendjax_torch.weights import flax_params

    names = {id(p): (path, layout) for path, p, layout in flax_params(model)}
    out = []
    for p in model.parameters():
        path, layout = names[id(p)]
        keys = _leaf_path_keys(".params" + path)[1:]
        out.append((p, path, layout, param_sharding_rules(
            mesh, keys, _flax_shape(p.shape, layout), rules)))
    return out


class ShardedParams:
    """A train state split over a model axis (``fsdp``/``tp``): the
    module's parameters are empty between steps; each rank keeps its shard
    of each parameter, placed on the parameter's own dims from the spec of
    its flax view (:attr:`specs`), as a plain tensor that an AdamW of its
    own updates (AdamW is elementwise: the shards need no DTensor).

    :meth:`gather` all-gathers the full parameters into the module before a
    step; :meth:`step` takes this rank's slice of each (already reduced)
    gradient, updates the shards and empties the module again.

    Both model axes split the state, not the compute: ``fsdp`` also splits
    the batch (its ranks train on their own rows), while the ranks of a
    ``tp`` group train on the same rows with the same gathered parameters.
    ``tp`` is a state-only layout here, the rules' placements with no
    column or row split of the matmuls (ROADMAP item 5c)."""

    def __init__(self, model, mesh, rules=(), optimizer_kwargs=None):
        import torch

        self.mesh = mesh
        self.model = model
        self.params: list = []   # module parameters, in model order
        self.shards: list = []   # this rank's shard of each
        self.specs: list = []    # Sharding of each on its torch dims
        self.leaf_specs: dict = {}  # leaf path -> Sharding (flax view)
        for p, path, layout, flax_sh in model_shardings(model, mesh, rules):
            for prefix in (".params", ".opt_state[0].mu",
                           ".opt_state[0].nu"):
                self.leaf_specs[prefix + path] = flax_sh
            torch_sh = Sharding(mesh, _torch_spec(flax_sh.spec, p.ndim,
                                                  layout))
            shard = torch.nn.Parameter(torch_sh.local(p.detach()).clone())
            self.params.append(p)
            self.shards.append(shard)
            self.specs.append(torch_sh)
        kw = dict(lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
        kw.update(optimizer_kwargs or {})
        kw["foreach"] = False
        kw.pop("capturable", None)
        kw.pop("fused", None)
        self.optimizer = torch.optim.AdamW(self.shards, **kw)
        self.release()

    def release(self) -> None:
        """Empty the module's parameters (their shards hold the values)."""
        import torch

        for p in self.params:
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)

    def gather(self) -> None:
        """All-gather every parameter's full value into the module."""
        for p, shard, sh in zip(self.params, self.shards, self.specs):
            p.data = gather_full(shard.detach(), sh)

    def step(self, grads) -> None:
        """AdamW on the shards from this rank's slice of each full
        gradient, then :meth:`release`."""
        for shard, g, sh in zip(self.shards, grads, self.specs):
            shard.grad = sh.local(g).contiguous()
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.release()

    def full_leaves(self) -> list:
        """``(parameter, full value, full exp_avg, full exp_avg_sq, step)``
        of every parameter (all-gathers: every rank calls it)."""
        import torch

        out = []
        for p, shard, sh in zip(self.params, self.shards, self.specs):
            entry = self.optimizer.state.get(shard, {})
            moments = []
            for name in ("exp_avg", "exp_avg_sq"):
                t = entry.get(name)
                local = t if t is not None else torch.zeros_like(shard)
                moments.append(gather_full(local.detach(), sh))
            step = entry.get("step")
            out.append((p, gather_full(shard.detach(), sh), *moments,
                        None if step is None else step))
        return out

    def load_full(self, values: list, count: int) -> None:
        """Write full values ``[(param, exp_avg, exp_avg_sq)]`` (the order
        of :attr:`params`) into this rank's shards, in place."""
        import torch

        with torch.no_grad():
            for shard, sh, (value, mu, nu) in zip(self.shards, self.specs,
                                                   values):
                shard.copy_(sh.local(value))
                entry = self.optimizer.state[shard]
                if not entry:
                    entry["step"] = torch.zeros((), dtype=torch.float32)
                    entry["exp_avg"] = torch.zeros_like(shard)
                    entry["exp_avg_sq"] = torch.zeros_like(shard)
                entry["step"].fill_(count)
                entry["exp_avg"].copy_(sh.local(mu))
                entry["exp_avg_sq"].copy_(sh.local(nu))


def gather_full(local, sh: Sharding):
    """The full tensor from this rank's ``local`` shard of ``sh``: one
    all-gather per split dim (recorded as the collectives' all-gather
    bytes, on the dim's axes)."""
    from blendjax_torch.parallel.collectives import all_gather

    t = local
    for d in reversed(range(len(sh.spec))):
        axes = _entry_axes(sh.spec[d])
        if axes_size(sh.mesh, axes) > 1:
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
    "Sharding",
    "StateShardings",
    "batch_sharding",
    "check_sharding",
    "leading_axes",
    "leading_shard_count",
    "local_rows",
    "model_shardings",
    "rank_range",
    "mesh_chip_count",
    "param_sharding_rules",
    "replicated",
    "resolve_layout",
    "resolve_rules",
    "ring_sharding",
    "shard_params",
    "state_resident_bytes",
    "state_shardings",
    "tensor_axis",
    "validate_batch_sharding",
]
