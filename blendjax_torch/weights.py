"""Parameter conversion from the JAX package's flax trees."""

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
