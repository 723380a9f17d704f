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
