"""Parameter and train-state conversion between the port and the JAX
package's flax trees: :func:`from_flax`, :func:`streamformer_from_flax`,
:func:`policy_from_flax` and :func:`discriminator_from_flax` for
parameters, :func:`train_state_leaves` and
:func:`load_train_state_leaves` for the whole train state under the leaf
paths of the JAX package's snapshots."""

from __future__ import annotations

import re

import numpy as np
import torch


def from_flax(params_np: dict) -> dict:
    """The JAX package's ``CubeRegressor`` parameter tree, given as numpy
    arrays (``{"Conv_0": {"kernel", "bias"}, ..., "Dense_1": ...}``) ->
    a ``state_dict`` of :class:`blendjax_torch.models.CubeRegressor`.

    Convolution kernels go from HWIO to OIHW, dense kernels from
    (in, out) to (out, in); ``Dense_0`` is the hidden layer, ``Dense_1``
    the head."""
    state = {}
    convs = sorted(
        (k for k in params_np if k.startswith("Conv_")),
        key=lambda k: int(k.split("_")[1]),
    )
    for i, name in enumerate(convs):
        kernel = np.asarray(params_np[name]["kernel"], np.float32)
        state[f"convs.{i}.weight"] = torch.from_numpy(
            np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))
        )
        state[f"convs.{i}.bias"] = torch.from_numpy(
            np.asarray(params_np[name]["bias"], np.float32).copy()
        )
    for flax_name, torch_name in (("Dense_0", "dense"), ("Dense_1", "head")):
        kernel = np.asarray(params_np[flax_name]["kernel"], np.float32)
        state[f"{torch_name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(kernel.T)
        )
        state[f"{torch_name}.bias"] = torch.from_numpy(
            np.asarray(params_np[flax_name]["bias"], np.float32).copy()
        )
    return state


def discriminator_from_flax(params_np: dict) -> dict:
    """The JAX package's ``Discriminator`` parameter tree (numpy:
    ``{"Conv_i": {"kernel"}, "GroupNorm_i": {"scale", "bias"},
    "Dense_0": {"kernel", "bias"}}``) -> a ``state_dict`` of
    :class:`blendjax_torch.models.Discriminator`: convolution kernels from
    HWIO to OIHW, the dense kernel transposed."""
    state = {}
    convs = sorted((k for k in params_np if k.startswith("Conv_")),
                   key=lambda k: int(k.split("_")[1]))
    for i, name in enumerate(convs):
        kernel = np.asarray(params_np[name]["kernel"], np.float32)
        state[f"convs.{i}.weight"] = _f32(kernel.transpose(3, 2, 0, 1))
        norm = params_np[f"GroupNorm_{i}"]
        state[f"norms.{i}.weight"] = _f32(norm["scale"])
        state[f"norms.{i}.bias"] = _f32(norm["bias"])
    _dense(state, "head", params_np["Dense_0"])
    return state


def _f32(a, shape=None):
    """A writable, contiguous f32 copy as a tensor."""
    a = np.array(a, np.float32)  # copies: a JAX buffer's view is read-only
    return torch.from_numpy(np.ascontiguousarray(
        a if shape is None else a.reshape(shape)
    ))


def _dense(state, prefix, tree):
    """A flax Dense / DenseGeneral over the last input axis: kernel
    (in, *out) -> weight (prod(out), in), bias (*out) -> (prod(out),)."""
    kernel = np.asarray(tree["kernel"], np.float32)
    state[f"{prefix}.weight"] = _f32(kernel.reshape(kernel.shape[0], -1).T)
    state[f"{prefix}.bias"] = _f32(tree["bias"], (-1,))


def _layer_norm(state, prefix, tree):
    state[f"{prefix}.weight"] = _f32(tree["scale"])
    state[f"{prefix}.bias"] = _f32(tree["bias"])


#: A MoE block's stacked expert weights, kept in the flax layout
MOE_LEAVES = ("expert_bi", "expert_bo", "expert_wi", "expert_wo")


def streamformer_from_flax(params_np: dict) -> dict:
    """The JAX package's ``StreamFormer`` parameter tree as numpy arrays
    (``patch_embed``, ``pos_embed``, ``block{i}/{LayerNorm_0,
    MultiHeadAttention_0/{qkv, proj}, LayerNorm_1, Dense_0, Dense_1}`` or,
    in a mixture-of-experts block, ``block{i}/MoEMLP_0/{router,
    expert_wi, expert_bi, expert_wo, expert_bo}`` in place of the two
    ``Dense``, a top-level ``LayerNorm_0`` and ``Dense_0``) -> a
    ``state_dict`` of :class:`blendjax_torch.models.StreamFormer`.

    The patch kernel goes from HWIO to OIHW; the qkv ``DenseGeneral``
    kernel (C, 3, H, D) flattens to (3*H*D, C) in (3, H, D) order, which is
    the order the model's reshape to (B, T, 3, H, D) reads back."""
    state = {}
    kernel = np.asarray(params_np["patch_embed"]["kernel"], np.float32)
    state["patch_embed.weight"] = _f32(kernel.transpose(3, 2, 0, 1))
    state["patch_embed.bias"] = _f32(params_np["patch_embed"]["bias"])
    state["pos_embed"] = _f32(params_np["pos_embed"])
    depth = sum(1 for k in params_np if k.startswith("block"))
    for i in range(depth):
        tree = params_np[f"block{i}"]
        pre = f"blocks.{i}"
        _layer_norm(state, f"{pre}.norm1", tree["LayerNorm_0"])
        _dense(state, f"{pre}.attn.qkv", tree["MultiHeadAttention_0"]["qkv"])
        _dense(state, f"{pre}.attn.proj", tree["MultiHeadAttention_0"]["proj"])
        _layer_norm(state, f"{pre}.norm2", tree["LayerNorm_1"])
        if "MoEMLP_0" in tree:
            moe = tree["MoEMLP_0"]
            _dense(state, f"{pre}.moe.router", moe["router"])
            for name in MOE_LEAVES:
                state[f"{pre}.moe.{name}"] = _f32(moe[name])
        else:
            _dense(state, f"{pre}.fc1", tree["Dense_0"])
            _dense(state, f"{pre}.fc2", tree["Dense_1"])
    _layer_norm(state, "norm", params_np["LayerNorm_0"])
    _dense(state, "head", params_np["Dense_0"])
    return state


# -- the whole train state under the JAX package's leaf paths -----------------


def _cube_params(model) -> list:
    """``(flax path, parameter, layout)`` of a ``CubeRegressor``, in the
    order of the flax tree (keys sorted): ``layout`` "conv" (OIHW here,
    HWIO there), "dense" ((out, in) here, (in, out) there) or ``None``."""
    out = []
    for i, conv in enumerate(model.convs):
        out += [(f"['Conv_{i}']['bias']", conv.bias, None),
                (f"['Conv_{i}']['kernel']", conv.weight, "conv")]
    for flax, layer in (("Dense_0", model.dense), ("Dense_1", model.head)):
        out += [(f"['{flax}']['bias']", layer.bias, None),
                (f"['{flax}']['kernel']", layer.weight, "dense")]
    return out


def _streamformer_params(model) -> list:
    """``(flax path, parameter, layout)`` of a ``StreamFormer``, in the
    order of the flax tree (keys sorted at every level, as flax flattens
    them): the reverse of :func:`streamformer_from_flax`. The qkv
    ``DenseGeneral`` kernel is ``("general", (3, H, D))`` ((3HD, C) here,
    (C, 3, H, D) there) and its bias ``("reshape", (3, H, D))``."""
    out = []

    def add(keys, p, layout=None):
        out.append((keys, p, layout))

    def dense(keys, layer):
        add(keys + ("bias",), layer.bias)
        add(keys + ("kernel",), layer.weight, "dense")

    def norm(keys, ln):
        add(keys + ("bias",), ln.bias)
        add(keys + ("scale",), ln.weight)

    dense(("Dense_0",), model.head)
    norm(("LayerNorm_0",), model.norm)
    for i, blk in enumerate(model.blocks):
        pre = (f"block{i}",)
        moe = getattr(blk, "moe", None)
        if moe is not None:
            dense(pre + ("MoEMLP_0", "router"), moe.router)
            for name in MOE_LEAVES:
                add(pre + ("MoEMLP_0", name), getattr(moe, name))
        else:
            dense(pre + ("Dense_0",), blk.fc1)
            dense(pre + ("Dense_1",), blk.fc2)
        norm(pre + ("LayerNorm_0",), blk.norm1)
        norm(pre + ("LayerNorm_1",), blk.norm2)
        attn = pre + ("MultiHeadAttention_0",)
        dense(attn + ("proj",), blk.attn.proj)
        h = blk.attn.num_heads
        d = blk.attn.proj.in_features // h
        add(attn + ("qkv", "bias"), blk.attn.qkv.bias, ("reshape", (3, h, d)))
        add(attn + ("qkv", "kernel"), blk.attn.qkv.weight,
            ("general", (3, h, d)))
    add(("patch_embed", "bias"), model.patch_embed.bias)
    add(("patch_embed", "kernel"), model.patch_embed.weight, "conv")
    add(("pos_embed",), model.pos_embed)
    out.sort(key=lambda e: e[0])
    return [("".join(f"['{k}']" for k in keys), p, layout)
            for keys, p, layout in out]


def _discriminator_params(model) -> list:
    """``(flax path, parameter, layout)`` of a ``Discriminator``: the
    reverse of :func:`discriminator_from_flax`, in the flax tree's order."""
    out = []
    for i, (conv, norm) in enumerate(zip(model.convs, model.norms)):
        out += [(f"['Conv_{i}']['kernel']", conv.weight, "conv"),
                (f"['GroupNorm_{i}']['bias']", norm.bias, None),
                (f"['GroupNorm_{i}']['scale']", norm.weight, None)]
    out += [("['Dense_0']['bias']", model.head.bias, None),
            ("['Dense_0']['kernel']", model.head.weight, "dense")]
    out.sort(key=lambda e: e[0])
    return out


def _policy_params(model) -> list:
    """``(flax path, parameter, layout)`` of a ``QNetwork`` or a
    ``PolicyValueNet``: its linear layers are flax's ``Dense_{i}`` in
    creation order (:meth:`flax_names`), a ``log_std`` stays as it is."""
    out = []
    for name, layer in model.flax_names():
        out += [(f"['{name}']['bias']", layer.bias, None),
                (f"['{name}']['kernel']", layer.weight, "dense")]
    if hasattr(model, "log_std"):
        out.append(("['log_std']", model.log_std, None))
    out.sort(key=lambda e: e[0])
    return out


def flax_params(model) -> list:
    """``(flax path, parameter, layout)`` of every parameter: the flax names
    of a ``CubeRegressor``, a ``StreamFormer``, a ``QNetwork``, a
    ``PolicyValueNet`` or a ``Discriminator``; any other model keeps its
    own parameter names, untransposed (a snapshot only this package
    reads)."""
    from blendjax_torch.models import (
        CubeRegressor,
        Discriminator,
        PolicyValueNet,
        QNetwork,
        StreamFormer,
    )

    if isinstance(model, CubeRegressor):
        return _cube_params(model)
    if isinstance(model, Discriminator):
        return _discriminator_params(model)
    if isinstance(model, StreamFormer):
        return _streamformer_params(model)
    if isinstance(model, (QNetwork, PolicyValueNet)):
        return _policy_params(model)
    return [(f"['{name}']", p, None) for name, p in model.named_parameters()]


def policy_from_flax(params_np: dict) -> dict:
    """A flax ``QNetwork`` / ``PolicyValueNet`` parameter tree (numpy:
    ``{"Dense_0": {"kernel", "bias"}, ..., "log_std"}``) -> a
    ``state_dict`` of the port's model of the same shape (kernels (in,
    out) -> weights (out, in))."""
    state = {}
    for name in sorted((k for k in params_np if k.startswith("Dense_")),
                       key=lambda k: int(k.split("_")[1])):
        _dense(state, f"dense.{name.split('_')[1]}", params_np[name])
    if "log_std" in params_np:
        state["log_std"] = _f32(params_np["log_std"])
    return state


def flax_tree(model) -> dict:
    """The flax parameter tree of ``model`` as nested dicts of host numpy
    arrays (kernels in flax's layouts), from one device-to-host copy of
    every parameter: what :func:`blendjax_torch.rl.np_mlp_forward`
    evaluates."""
    leaves = [(path, _to_flax(p.detach(), layout))
              for path, p, layout in flax_params(model)]
    flat = torch.cat([v.reshape(-1).float() for _, v in leaves]).cpu()
    out: dict = {}
    at = 0
    for path, v in leaves:
        n = v.numel()
        keys = re.findall(r"\['([^']*)'\]", path)
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = flat[at:at + n].reshape(v.shape).numpy()
        at += n
    return out


_params = flax_params


def _to_flax(t: torch.Tensor, layout):
    if layout == "conv":
        return t.permute(2, 3, 1, 0)
    if layout == "dense":
        return t.t()
    if isinstance(layout, tuple) and layout[0] == "general":
        return t.t().reshape(t.shape[1], *layout[1])
    if isinstance(layout, tuple) and layout[0] == "reshape":
        return t.reshape(layout[1])
    return t


def _from_flax(a: np.ndarray, layout) -> np.ndarray:
    if layout == "conv":
        return a.transpose(3, 2, 0, 1)
    if layout == "dense":
        return a.T
    if isinstance(layout, tuple) and layout[0] == "general":
        return a.reshape(a.shape[0], -1).T
    if isinstance(layout, tuple) and layout[0] == "reshape":
        return a.reshape(-1)
    return a


def _full_shape(state, p) -> tuple:
    """A parameter's full shape; a sharded state's module parameters are
    empty between steps or hold their block, so a sharded state's come
    from its shards' record."""
    shards = getattr(state, "shards", None)
    if shards is not None:
        return shards.full_shape(p)
    return tuple(p.shape)


def train_state_specs(state) -> list:
    """``(leaf path, flax-view shape)`` of every leaf of
    :func:`train_state_leaves`, in its order, without reading a value."""
    from blendjax_torch.parallel.sharding import _flax_shape

    shapes = [(path, _flax_shape(_full_shape(state, p), layout))
              for path, p, layout in flax_params(state.model)]
    out = [(".step", ())]
    out += [(".params" + path, shape) for path, shape in shapes]
    out.append((".opt_state[0].count", ()))
    for key in ("mu", "nu"):
        out += [(f".opt_state[0].{key}" + path, shape)
                for path, shape in shapes]
    target = getattr(state, "target", None)
    if target is not None:
        shards = getattr(state, "target_shards", None)
        out += [(".target_params" + path, _flax_shape(
            p.shape if shards is None else shards.full_shape(p), layout))
            for path, p, layout in flax_params(target)]
    return out


def _target_leaves(state, out: dict) -> dict:
    """An RL state's target network (:class:`blendjax_torch.rl.RLTrainState`)
    under ``.target_params``, as the flax ``RLTrainState`` holds it (a
    sharded target gathered to its full values)."""
    target = getattr(state, "target", None)
    if target is not None:
        shards = getattr(state, "target_shards", None)
        full = {} if shards is None else {
            id(p): v for p, v in zip(shards.params, shards.full_params())}
        for path, p, layout in flax_params(target):
            value = full.get(id(p), p.detach())
            out[".target_params" + path] = _to_flax(value, layout)
    return out


def train_state_leaves(state) -> dict:
    """A port ``TrainState`` -> ``{leaf path: tensor or array}`` under the
    paths the JAX package's snapshot writes for a flax ``TrainState`` with
    ``optax.adamw`` (or ``optax.adam``: the same first state):
    ``.step``, ``.params[...]``, ``.opt_state[0].count``
    (one int32 scalar; AdamW keeps one ``step`` per parameter, all equal),
    ``.opt_state[0].mu[...]`` (``exp_avg``) and ``.opt_state[0].nu[...]``
    (``exp_avg_sq``), kernels transposed to flax's layouts; an RL state's
    target network adds ``.target_params[...]``.

    ``CubeRegressor`` and ``StreamFormer`` take the flax names
    (:func:`flax_params`); another model keeps its own parameter names,
    untransposed: a snapshot the port restores and the JAX package does
    not. The tensors are views of the live state (the snapshot manager
    clones them); no value leaves the card here. An optimizer that has not
    stepped yet contributes zero moments and count 0, as optax's init.

    A state sharded over a model axis (``state.shards``, a
    :class:`~blendjax_torch.parallel.ShardedParams`) gathers to the same
    full leaves: every rank calls this (all-gathers), and every rank gets
    the leaves one card would hold."""
    if getattr(state, "shards", None) is not None:
        return _target_leaves(state, _sharded_leaves(state))
    model, opt = state.model, state.optimizer
    params = _params(model)
    out = {".step": np.asarray(state.step, np.int32)}
    for path, p, layout in params:
        out[".params" + path] = _to_flax(p.detach(), layout)
    first = opt.state.get(params[0][1]) if params else None
    if first and "step" in first:
        out[".opt_state[0].count"] = first["step"].detach().to(torch.int32)
    else:
        out[".opt_state[0].count"] = np.asarray(0, np.int32)
    for key, name in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        for path, p, layout in params:
            entry = opt.state.get(p)
            t = entry[name] if entry and name in entry else torch.zeros_like(p)
            out[f".opt_state[0].{key}" + path] = _to_flax(t.detach(), layout)
    return _target_leaves(state, out)


def load_train_state_leaves(state, leaves: dict) -> None:
    """Write snapshot ``leaves`` (path -> host array or scalar, as
    :meth:`~blendjax_torch.checkpoint.SnapshotManager.restore` returns
    them) into a port ``TrainState`` IN PLACE: every parameter, moment
    and step count is ``copy_``-ed into its existing tensor under
    ``no_grad``, so a CUDA graph captured over this state replays on the
    restored values (a new tensor would leave the graph on the old
    memory). AdamW entries that do not exist yet are made as AdamW makes
    them; the one optax ``count`` goes into every parameter's ``step``.
    A sharded state (``state.shards``) takes this rank's slice of each
    leaf into its shards."""
    _load_target(state, leaves)
    if getattr(state, "shards", None) is not None:
        return _load_sharded(state, leaves)
    model, opt = state.model, state.optimizer
    group = opt.param_groups[0]
    on_device = bool(group.get("capturable") or group.get("fused"))
    count = int(np.asarray(leaves[".opt_state[0].count"]))

    def put(dst: torch.Tensor, src) -> None:
        src = torch.from_numpy(np.ascontiguousarray(src)).to(dst.dtype)
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"snapshot leaf {tuple(src.shape)} does not fit "
                             f"{tuple(dst.shape)}")
        dst.copy_(src)

    with torch.no_grad():
        for path, p, layout in _params(model):
            put(p, _from_flax(leaves[".params" + path], layout))
            entry = opt.state[p]
            if not entry:
                entry["step"] = torch.zeros(
                    (), dtype=torch.float32,
                    device=p.device if on_device else "cpu")
                entry["exp_avg"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
                entry["exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
            entry["step"].fill_(count)
            put(entry["exp_avg"],
                _from_flax(leaves[".opt_state[0].mu" + path], layout))
            put(entry["exp_avg_sq"],
                _from_flax(leaves[".opt_state[0].nu" + path], layout))
    state.step = int(np.asarray(leaves[".step"]))


def _load_target(state, leaves: dict) -> None:
    target = getattr(state, "target", None)
    if target is None:
        return
    shards = getattr(state, "target_shards", None)
    values = {}
    with torch.no_grad():
        for path, p, layout in flax_params(target):
            src = torch.from_numpy(np.ascontiguousarray(
                _from_flax(np.asarray(leaves[".target_params" + path]),
                           layout)))
            shape = p.shape if shards is None else shards.full_shape(p)
            if tuple(src.shape) != tuple(shape):
                raise ValueError(f"snapshot leaf {tuple(src.shape)} does not "
                                 f"fit {tuple(shape)}")
            if shards is None:
                p.copy_(src.to(p.dtype))
            else:
                values[id(p)] = src.to(device=p.device, dtype=p.dtype)
    if shards is not None:
        shards.load_params([values[id(p)] for p in shards.params])


def _sharded_leaves(state) -> dict:
    full = {id(p): rest for p, *rest in state.shards.full_leaves()}
    params = [(path, layout, full[id(p)])
              for path, p, layout in _params(state.model)]
    out = {".step": np.asarray(state.step, np.int32)}
    for path, layout, (value, _mu, _nu, _step) in params:
        out[".params" + path] = _to_flax(value, layout)
    step = params[0][2][3] if params else None
    out[".opt_state[0].count"] = (np.asarray(0, np.int32) if step is None
                                  else step.detach().to(torch.int32))
    for key, i in (("mu", 1), ("nu", 2)):
        for path, layout, vals in params:
            out[f".opt_state[0].{key}" + path] = _to_flax(vals[i], layout)
    return out


def _load_sharded(state, leaves: dict) -> None:
    shards = state.shards
    layouts = {id(p): (path, layout)
               for path, p, layout in _params(state.model)}

    def full(prefix, p, like):
        path, layout = layouts[id(p)]
        a = np.ascontiguousarray(_from_flax(leaves[prefix + path], layout))
        return torch.from_numpy(a).to(device=like.device, dtype=like.dtype)

    values = []
    for p, shard in zip(shards.params, shards.shards):
        values.append(tuple(full(pre, p, shard) for pre in (
            ".params", ".opt_state[0].mu", ".opt_state[0].nu")))
    shards.load_full(values, int(np.asarray(leaves[".opt_state[0].count"])))
    state.step = int(np.asarray(leaves[".step"]))
