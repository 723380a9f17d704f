"""Parameter and train-state conversion between the port and the JAX
package's flax trees: :func:`from_flax` and :func:`streamformer_from_flax`
for parameters, :func:`train_state_leaves` and
:func:`load_train_state_leaves` for the whole train state under the leaf
paths of the JAX package's snapshots."""

from __future__ import annotations

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


def streamformer_from_flax(params_np: dict) -> dict:
    """The JAX package's ``StreamFormer`` parameter tree as numpy arrays
    (``patch_embed``, ``pos_embed``, ``block{i}/{LayerNorm_0,
    MultiHeadAttention_0/{qkv, proj}, LayerNorm_1, Dense_0, Dense_1}``,
    a top-level ``LayerNorm_0`` and ``Dense_0``) -> a ``state_dict`` of
    :class:`blendjax_torch.models.StreamFormer`.

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


def _params(model) -> list:
    """The flax-named parameters of a ``CubeRegressor``; any other model
    keeps its own parameter names, untransposed (a snapshot only this
    package reads)."""
    from blendjax_torch.models import CubeRegressor

    if isinstance(model, CubeRegressor):
        return _cube_params(model)
    return [(f"['{name}']", p, None) for name, p in model.named_parameters()]


def _to_flax(t: torch.Tensor, layout):
    if layout == "conv":
        return t.permute(2, 3, 1, 0)
    if layout == "dense":
        return t.t()
    return t


def _from_flax(a: np.ndarray, layout) -> np.ndarray:
    if layout == "conv":
        return a.transpose(3, 2, 0, 1)
    if layout == "dense":
        return a.T
    return a


def train_state_leaves(state) -> dict:
    """A port ``TrainState`` -> ``{leaf path: tensor or array}`` under the
    paths the JAX package's snapshot writes for a flax ``TrainState`` with
    ``optax.adamw``: ``.step``, ``.params[...]``, ``.opt_state[0].count``
    (one int32 scalar; AdamW keeps one ``step`` per parameter, all equal),
    ``.opt_state[0].mu[...]`` (``exp_avg``) and ``.opt_state[0].nu[...]``
    (``exp_avg_sq``), kernels transposed to flax's layouts.

    A model other than ``CubeRegressor`` keeps its own parameter names,
    untransposed: a snapshot the port restores and the JAX package does
    not. The tensors are views of the live state (the snapshot manager
    clones them); no value leaves the card here. An optimizer that has not
    stepped yet contributes zero moments and count 0, as optax's init."""
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
    return out


def load_train_state_leaves(state, leaves: dict) -> None:
    """Write snapshot ``leaves`` (path -> host array or scalar, as
    :meth:`~blendjax_torch.checkpoint.SnapshotManager.restore` returns
    them) into a port ``TrainState`` IN PLACE: every parameter, moment
    and step count is ``copy_``-ed into its existing tensor under
    ``no_grad``, so a CUDA graph captured over this state replays on the
    restored values (a new tensor would leave the graph on the old
    memory). AdamW entries that do not exist yet are made as AdamW makes
    them; the one optax ``count`` goes into every parameter's ``step``."""
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
