"""Numeric-equivalence scaffold for the port's sharded layouts (the port
of ``blendjax/testing/equivalence.py``).

One implementation of the contract "a sharded step reproduces the
single-device run of the identical model and batch", with the JAX
package's bars: the loss within ``TOL_LOSS`` and every gradient within
``TOL_GRAD``, both relative to the reference's magnitude (at least 1).
Collective and reduction reorders move the last float32 bits; wrong
sharding math is orders of magnitude away. The port's tests that quote
these bars take them from here.

Each rank of a mesh calls :func:`assert_sharded_matches_single_device`
with the same full batch: the single-device reference runs on the whole
batch in every rank, the sharded run on the rank's rows of the batch
sharding, its loss and gradients averaged over the batch axes as the
mesh step does. A state split over a model axis
(:class:`~blendjax_torch.parallel.ShardedParams`) is gathered before
anything is compared.
"""

from __future__ import annotations

import numpy as np

#: the JAX package's f32 bars (``blendjax/testing/equivalence.py:63-108``)
TOL_LOSS = 1e-5
TOL_GRAD = 1e-4


def normalized_spec(sharding) -> tuple:
    """A layout's partition spec as a plain comparable tuple: a
    :class:`~blendjax_torch.parallel.Sharding` (or a spec tuple) with
    one-axis tuple entries unfolded, so ``(None, ("data",))`` reads
    ``(None, "data")``, and trailing ``None`` entries dropped."""
    spec = [
        e[0] if isinstance(e, tuple) and len(e) == 1 else e
        for e in tuple(getattr(sharding, "spec", sharding) or ())
    ]
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def _leaves(tree, prefix: str = "") -> dict:
    """``{path: leaf}`` of nested dicts, lists and tuples (a state dict,
    a parameter list) down to tensors, arrays and numbers."""
    if isinstance(tree, dict):
        out: dict = {}
        for k in sorted(tree, key=str):
            out.update(_leaves(tree[k], f"{prefix}[{k!r}]"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}[{i}]"))
        return out
    return {prefix: tree}


def _numpy(leaf) -> np.ndarray:
    detach = getattr(leaf, "detach", None)
    if detach is not None:
        leaf = detach().float().cpu().numpy()
    return np.asarray(leaf, np.float64)


def max_tree_diff(a, b) -> float:
    """Max abs elementwise difference across two trees of equal structure
    (state dicts, nested dicts and lists of tensors or arrays)."""
    la, lb = _leaves(a), _leaves(b)
    if la.keys() != lb.keys():
        raise ValueError(
            f"trees differ in structure: {sorted(la.keys() ^ lb.keys())}")
    return max(
        (float(np.max(np.abs(_numpy(la[k]) - _numpy(lb[k])), initial=0.0))
         for k in la),
        default=0.0,
    )


def corner_loss(model, images, xy):
    """The corner regression loss: the mean squared error of the model's
    (B, 8, 2) points against ``xy``."""
    pred = model(images)
    return ((pred.reshape(-1, 8, 2).float() - xy) ** 2).mean()


def loss_and_grads(model, images, xy, reduce=None):
    """Corner-MSE loss value and gradients of ``model`` on one batch, the
    gradients keyed by the parameters' flax paths
    (:func:`blendjax_torch.weights.flax_params`) as float64 numpy arrays
    in the torch layout. ``reduce`` (a
    :class:`~blendjax_torch.parallel.StateShardings`) averages the loss
    and the gradients over its batch axes, as the mesh step does."""
    import torch

    from blendjax_torch.weights import flax_params

    device = next(model.parameters()).device
    images = torch.as_tensor(images).to(device)
    xy = torch.as_tensor(xy, dtype=torch.float32).to(device)
    model.zero_grad(set_to_none=True)
    loss = corner_loss(model, images, xy)
    loss.backward()
    named = flax_params(model)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for _path, p, _layout in named]
    loss = loss.detach()
    if reduce is not None:
        loss = reduce.reduce_loss(loss)
        grads = reduce.reduce_grads(grads)
    return float(loss), {
        path: _numpy(g) for (path, _p, _layout), g in zip(named, grads)}


def _params(model) -> dict:
    from blendjax_torch.weights import flax_params

    return {path: p for path, p, _layout in flax_params(model)}


def _full_params(state) -> dict:
    """The state's parameters whole: a sharded state's resident blocks
    gathered (a collective: every rank calls it)."""
    shards = getattr(state, "shards", None)
    if shards is None:
        return _params(state.model)
    from blendjax_torch.weights import flax_params

    full = {id(p): v for p, v, *_moments in shards.full_leaves()}
    return {path: full[id(p)] for path, p, _l in flax_params(state.model)}


def _full_grads(state, grads: dict) -> dict:
    """``grads`` (by flax path) whole: a resident block's gradient
    gathered from every rank of its axis."""
    import torch

    from blendjax_torch.weights import flax_params

    shards = getattr(state, "shards", None)
    if shards is None:
        return grads
    res = {id(p): r for p, r in zip(shards.params, shards.residents)}
    out = dict(grads)
    for path, p, _layout in flax_params(state.model):
        r = res.get(id(p))
        if r is not None:
            out[path] = _numpy(r.full(torch.as_tensor(grads[path]).float()))
    return out


def assert_sharded_matches_single_device(
    sharded_model,
    single_model,
    mesh,
    images,
    xy,
    rules=None,
    tol_loss: float = TOL_LOSS,
    tol_grad: float = TOL_GRAD,
    device="cpu",
):
    """Identical initial parameters -> assert the sharded model's loss and
    gradients match the single-device model's within RELATIVE bars.

    ``sharded_model`` becomes a train state on ``mesh`` under ``rules``
    (:func:`blendjax_torch.train.make_train_state`; the defaults of
    :func:`~blendjax_torch.parallel.param_sharding_rules` apply, so an
    ``fsdp`` axis splits the state); its rank takes its rows of the batch
    sharding. Returns ``(loss_diff, max_grad_diff)``."""
    import torch

    from blendjax_torch.parallel import batch_sharding, state_shardings
    from blendjax_torch.train import make_train_state

    single_model = single_model.to(device)
    state = make_train_state(sharded_model, mesh=mesh, rules=rules,
                             device=device)
    shards = getattr(state, "shards", None)
    if shards is not None:
        shards.gather()
    try:
        assert max_tree_diff(_params(single_model),
                             _full_params(state)) == 0.0, (
            "ref/sharded init diverged — models are not identical")
        ref_loss, ref_grads = loss_and_grads(single_model, images, xy)
        sh = batch_sharding(mesh)
        sh_loss, sh_grads = loss_and_grads(
            state.model, sh.local(torch.as_tensor(images)),
            sh.local(torch.as_tensor(xy)),
            reduce=state_shardings(state, mesh=mesh, rules=rules))
        sh_grads = _full_grads(state, sh_grads)
    finally:
        if shards is not None:
            shards.release()
    loss_diff = abs(sh_loss - ref_loss)
    assert loss_diff < tol_loss * max(1.0, abs(ref_loss)), (
        sh_loss, ref_loss)
    grad_diff = max_tree_diff(ref_grads, sh_grads)
    grad_scale = max(float(np.max(np.abs(g))) for g in ref_grads.values())
    assert grad_diff < tol_grad * max(1.0, grad_scale), (
        f"max grad diff {grad_diff} (grad scale {grad_scale})")
    return loss_diff, grad_diff


def moe_per_token_reference(params, x) -> np.ndarray:
    """Dense per-token reference for MoE top-1 routing with ample
    capacity: each token goes through its argmax expert's MLP alone,
    scaled by the gate probability (float32; no capacity drops).
    ``params``: the flax layout (``router`` ``kernel`` (C, E) and
    ``bias``; ``expert_wi`` (E, C, H), ``expert_bi``, ``expert_wo``,
    ``expert_bo``) as arrays or tensors, or a port ``MoEMLP``."""
    import torch
    import torch.nn.functional as F

    if isinstance(params, torch.nn.Module):
        m = params
        params = {
            "router": {"kernel": m.router.weight.T, "bias": m.router.bias},
            **{k: getattr(m, k) for k in (
                "expert_wi", "expert_bi", "expert_wo", "expert_bo")},
        }

    def arr(v):
        return _numpy(v).astype(np.float32)

    x = arr(x)
    c = x.shape[-1]
    tokens = x.reshape(-1, c)
    logits = tokens @ arr(params["router"]["kernel"]) + arr(
        params["router"]["bias"])
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    idx = probs.argmax(-1)
    gate = probs.max(-1)
    # each token's expert weights, then one batched pass
    w1 = arr(params["expert_wi"])[idx]   # (N, C, H)
    b1 = arr(params["expert_bi"])[idx]   # (N, H)
    w2 = arr(params["expert_wo"])[idx]   # (N, H, C)
    b2 = arr(params["expert_bo"])[idx]   # (N, C)
    hidden = np.einsum("nc,nch->nh", tokens, w1) + b1
    hidden = F.gelu(torch.from_numpy(hidden), approximate="tanh").numpy()
    out = np.einsum("nh,nhc->nc", hidden, w2) + b2
    out = gate[:, None] * out
    return out.reshape(x.shape)


__all__ = [
    "TOL_GRAD",
    "TOL_LOSS",
    "assert_sharded_matches_single_device",
    "corner_loss",
    "loss_and_grads",
    "max_tree_diff",
    "moe_per_token_reference",
    "normalized_spec",
]
