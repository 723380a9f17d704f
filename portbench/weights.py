"""Weights from the seed, the same for the program and the reference.

One ``torch.randn`` call on the device, from a generator seeded with the
run's seed, fills every weight that is drawn; each leaf is then a slice of
it, scaled. The leaves are taken by name in sorted order, so a model whose
parameters carry the same names and shapes gets the same values.

The rule, by name: a bias is 0; a LayerNorm scale (``norm`` in its
module's name) is 1; ``pos_embed`` is normal with std 0.02; any other
weight is normal with variance 1 / fan_in (fan_in the product of its
dims after the first: torch keeps the output dim first).
"""

from __future__ import annotations

import math

import torch


def _rule(name: str, shape) -> tuple:
    if name.endswith("bias"):
        return "const", 0.0
    if name.endswith("weight") and "norm" in name.rsplit(".", 1)[0]:
        return "const", 1.0
    if name.endswith("pos_embed"):
        return "normal", 0.02
    fan_in = math.prod(shape[1:]) if len(shape) > 1 else shape[0]
    return "normal", math.sqrt(1.0 / fan_in)


def seeded_weights(shapes: dict, seed: int, device) -> dict:
    """``{name: float32 tensor}`` for ``shapes`` (``{name: shape}``)."""
    names = sorted(shapes)
    rules = {n: _rule(n, tuple(shapes[n])) for n in names}
    drawn = sum(math.prod(shapes[n]) for n in names
                if rules[n][0] == "normal")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(drawn, generator=gen, device=device,
                       dtype=torch.float32)
    out, at = {}, 0
    for n in names:
        kind, value = rules[n]
        shape = tuple(shapes[n])
        if kind == "const":
            out[n] = torch.full(shape, value, device=device)
        else:
            size = math.prod(shape)
            out[n] = flat[at:at + size].view(shape) * value
            at += size
    return out


@torch.no_grad()
def load_into(module: torch.nn.Module, seed: int) -> dict:
    """Fill ``module``'s parameters from the seed in place; returns the
    ``{name: shape}`` it filled."""
    params = dict(module.named_parameters())
    shapes = {n: tuple(p.shape) for n, p in params.items()}
    device = next(iter(params.values())).device
    values = seeded_weights(shapes, seed, device)
    for n, p in params.items():
        p.copy_(values[n])
    return shapes
