"""Named precision policies (port of ``blendjax/precision.py``).

- ``f32``: everything float32 (the parity policy of the tests).
- ``bf16-compute`` (the default): a layer casts its input and its
  parameters to bf16 for the convolution or matrix product, as flax does
  for a module with ``dtype=bfloat16`` and ``param_dtype=float32``: the
  master parameters, their gradients and the optimizer state stay f32,
  and the model's head runs in f32.
- ``bf16-grads``: ``bf16-compute``, and the step differentiates with
  respect to bf16 copies of every floating parameter (the f32 head, the
  biases and the norms included), so the backward pass carries bf16
  gradients; they are cast back to each master parameter's dtype before
  the optimizer. The losses, gradient accumulation over micro-batches and
  the matmul accumulators stay f32.

As in the JAX package the policy binds at two points: the model's
constructor owns the compute dtype (``Model(dtype=policy.compute_dtype)``),
the step builders own the gradient side (``precision=``).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """One named precision discipline.

    - ``compute_dtype``: activations and matmul inputs (the models'
      ``dtype``);
    - ``param_dtype``: the master parameters the optimizer updates;
    - ``grad_reduce_dtype``: the dtype gradients carry through the
      backward pass; ``None`` leaves them in ``param_dtype``;
    - ``accum_dtype``: micro-batch gradient accumulation and the loss.
    """

    name: str
    compute_dtype: torch.dtype
    param_dtype: torch.dtype = torch.float32
    grad_reduce_dtype: torch.dtype | None = None
    accum_dtype: torch.dtype = torch.float32

    def module_kwargs(self) -> dict:
        """Constructor kwargs for the port's models
        (``CubeRegressor(**policy.module_kwargs())``)."""
        return {"dtype": self.compute_dtype}


F32 = PrecisionPolicy("f32", compute_dtype=torch.float32)
BF16_COMPUTE = PrecisionPolicy("bf16-compute", compute_dtype=torch.bfloat16)
BF16_GRADS = PrecisionPolicy("bf16-grads", compute_dtype=torch.bfloat16,
                             grad_reduce_dtype=torch.bfloat16)

POLICIES: dict[str, PrecisionPolicy] = {
    p.name: p for p in (F32, BF16_COMPUTE, BF16_GRADS)
}

DEFAULT_POLICY = BF16_COMPUTE


def resolve_policy(policy) -> PrecisionPolicy:
    """``None`` -> the default policy; a name -> its entry in
    :data:`POLICIES`; a :class:`PrecisionPolicy` passes through. An
    unknown name raises ``ValueError``."""
    if policy is None:
        return DEFAULT_POLICY
    if isinstance(policy, PrecisionPolicy):
        return policy
    try:
        return POLICIES[policy]
    except KeyError:
        raise ValueError(
            f"unknown precision policy {policy!r}; known: {sorted(POLICIES)}"
        ) from None


def default_compute_dtype(dtype=None) -> torch.dtype:
    """An explicit dtype wins; ``None`` takes the default policy's."""
    return dtype if dtype is not None else DEFAULT_POLICY.compute_dtype


def cast_floating(tree, dtype):
    """Cast every floating tensor of a (nested) dict, list or tuple to
    ``dtype``; integer and bool tensors and other leaves pass through."""
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floating(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


class _Bound(torch.nn.Module):
    """``loss_fn(model, batch)`` as a module, so that
    :func:`torch.func.functional_call` can swap the model's parameters."""

    def __init__(self, model, loss_fn):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn

    def forward(self, batch):
        return self.loss_fn(self.model, batch)


def policy_value_and_grad(loss_fn, model, batch, policy: PrecisionPolicy,
                          has_aux: bool = False):
    """``(loss, grads)`` of ``loss_fn(model, batch)`` under ``policy``, the
    one gradient path every step builder shares; ``grads`` lines up with
    the model's parameters that require a gradient.

    ``has_aux`` mirrors ``jax.value_and_grad``: ``loss_fn`` returns
    ``(loss, aux)`` and so does the value side, ``((loss, aux), grads)``
    (the RL steps carry each row's TD error out of the loss this way).

    With ``grad_reduce_dtype`` unset this is the plain backward pass. With
    it set (``bf16-grads``) the loss is taken with every floating
    parameter replaced by a ``grad_reduce_dtype`` copy
    (:func:`torch.func.functional_call`), the gradients are taken with
    respect to those copies and cast back to each master parameter's
    dtype."""
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    params = [p for _, p in named]
    if policy.grad_reduce_dtype is None:
        value = loss_fn(model, batch)
        loss = value[0] if has_aux else value
        return value, torch.autograd.grad(loss, params)
    low = {f"model.{n}": p.detach().to(policy.grad_reduce_dtype)
           .requires_grad_() for n, p in named}
    value = torch.func.functional_call(_Bound(model, loss_fn), low, (batch,))
    loss = value[0] if has_aux else value
    grads = torch.autograd.grad(loss, list(low.values()))
    return value, tuple(g.to(p.dtype) for g, p in zip(grads, params))


__all__ = [
    "BF16_COMPUTE",
    "BF16_GRADS",
    "DEFAULT_POLICY",
    "F32",
    "POLICIES",
    "PrecisionPolicy",
    "cast_floating",
    "default_compute_dtype",
    "policy_value_and_grad",
    "resolve_policy",
]
