"""Mixture-of-experts MLP (port of ``blendjax/models/moe.py``).

Switch-Transformer top-1 routing with a static token capacity
``cap = max(1, int(capacity_factor * N / E))``: dispatch and combine are
one-hot einsums of static shape (N, E, cap), so a step that runs a MoE
block has no data-dependent shape and no host sync, and captures into one
CUDA graph. The router runs in f32; ``argmax`` takes the first of equal
maxima, as ``jnp.argmax`` does. A token past its expert's capacity gets a
zero dispatch row (dropped: its residual path passes it through).

The expert weights are stacked on a leading ``E`` dim (``expert_wi``
(E, C, H), ``expert_bi`` (E, H), ``expert_wo`` (E, H, C), ``expert_bo``
(E, C), all f32 and cast at use), the names the partition rules place on
the ``expert`` mesh axis (:func:`blendjax_torch.parallel.param_sharding_rules`).

The load-balancing loss (Switch eq. 4) is flax's ``sow`` in the JAX
package, a no-op unless the caller asks for the ``intermediates``
collection: the supervised steps never add it. Here every forward writes
its value into the module's ``aux_loss`` buffer in place (a captured graph
updates it on each replay); :func:`apply_with_aux` runs the model with the
differentiable value recorded and returns it weighted, as the reference's
``apply_with_aux`` does.

On a mesh whose batch axes split the tokens over ranks
(:func:`route_over_batch`, which the mesh step builders call), routing is
the global batch's, as it is under the JAX package's GSPMD jit: the
capacity counts every rank's tokens, a token's queue position counts the
tokens of the ranks before it (one all-gather of each rank's per-expert
counts), and the aux loss is the global one.

On an ``expert`` axis (a train state whose ``expert_*`` weights are split
on dim 0, :class:`~blendjax_torch.parallel.ShardedParams`) each rank holds
its ``E / ways`` experts and never gathers the others. The ranks of an
``expert`` group hold the same tokens (the batch is not split over
``expert``) and route them alike (the router is replicated); each runs
the expert einsums on its experts only (``dispatch[:, local]``,
``combine[:, local]``), and the outputs are summed over ``expert``: the
combine contracts the split expert dim, as in the JAX package's compiled
step (``blendjax_torch/docs/mesh-split.md``; no token travels to another
rank). The tokens and the gates enter the expert region through
:func:`~blendjax_torch.parallel.collectives.copy_to_axis`, so their
gradients sum over ``expert``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from blendjax_torch.parallel.sharding import split_of
from blendjax_torch.parallel.tensor import enter, row_sum
from blendjax_torch.precision import default_compute_dtype


class MoEMLP(nn.Module):
    """Drop-in replacement for a transformer MLP block: (B, T, C) in and
    out, each token routed top-1 to one of ``num_experts`` expert MLPs
    (``C -> C * mlp_ratio -> C``, tanh GELU)."""

    #: the expert weights it computes with split over ``expert`` in place
    #: (their expert dim), all four together
    SPLIT_PARAMS = {"expert": {n: (0,) for n in (
        "expert_wi", "expert_bi", "expert_wo", "expert_bo")}}
    SPLIT_GROUPS = (tuple(SPLIT_PARAMS["expert"]),)

    def __init__(self, dim: int, num_experts: int, mlp_ratio: int = 4,
                 capacity_factor: float = 1.25, dtype=None):
        super().__init__()
        if num_experts < 1:
            raise ValueError(f"num_experts must be >= 1, got {num_experts}")
        e, c, h = int(num_experts), int(dim), int(dim) * int(mlp_ratio)
        self.num_experts = e
        self.capacity_factor = float(capacity_factor)
        self.dtype = dtype
        self.router = nn.Linear(c, e)
        self.expert_wi = nn.Parameter(torch.zeros(e, c, h))
        self.expert_bi = nn.Parameter(torch.zeros(e, h))
        self.expert_wo = nn.Parameter(torch.zeros(e, h, c))
        self.expert_bo = nn.Parameter(torch.zeros(e, c))
        # the last forward's load-balancing loss, written in place
        self.register_buffer("aux_loss", torch.zeros(()), persistent=False)
        # the differentiable value, kept only while apply_with_aux records
        self._recording = False
        self._aux = None
        # (mesh, batch axes) when the tokens are split over ranks
        self._batch = None

    def capacity(self, tokens: int) -> int:
        return max(1, int(self.capacity_factor * tokens / self.num_experts))

    def route(self, tokens: torch.Tensor):
        """``(probs, expert_idx, gate, dispatch, aux)`` of (N, C) tokens:
        the f32 router's softmax, each token's expert (first of equal
        maxima), its gate, the (N, E, cap) one-hot dispatch tensor and the
        load-balancing loss, all over the global batch when the tokens are
        split over ranks (:func:`route_over_batch`)."""
        e = self.num_experts
        n = tokens.shape[0]
        logits = F.linear(tokens.float(), self.router.weight.float(),
                          self.router.bias.float())
        probs = torch.softmax(logits, dim=-1)
        expert_idx = torch.argmax(probs, dim=-1)
        gate = torch.amax(probs, dim=-1)
        onehot = F.one_hot(expert_idx, e).float()
        # each token's place in its expert's queue; -1 off its expert
        queue = torch.cumsum(onehot, dim=0)
        if self._batch is None:
            cap = self.capacity(n)
            frac = onehot.mean(dim=0)
            prob_mean = probs.mean(dim=0)
        else:
            queue, cap, frac, prob_mean = self._global_route(onehot, probs,
                                                             queue)
        pos = queue * onehot - 1.0
        keep = (pos >= 0) & (pos < cap)
        # jax.nn.one_hot gives a zero row for -1 and for >= cap, where
        # F.one_hot raises: clamp the index, then zero the dropped rows
        pos_oh = F.one_hot(pos.clamp(0, cap - 1).long(), cap).float()
        dispatch = onehot[..., None] * pos_oh * keep[..., None].float()
        aux = e * torch.sum(frac * prob_mean)
        return probs, expert_idx, gate, dispatch, aux

    def _global_route(self, onehot, probs, queue):
        """The global queue positions, capacity, routed fractions and mean
        probabilities from one all-gather of each rank's (2E,) vector of
        expert counts and probability sums."""
        from blendjax_torch.parallel.collectives import all_gather
        from blendjax_torch.parallel.mesh import axes_index, axes_size

        mesh, axes = self._batch
        e, n = self.num_experts, onehot.shape[0]
        ways = axes_size(mesh, axes)
        prob_sum = probs.sum(dim=0)
        every = all_gather(torch.cat([onehot.sum(dim=0), prob_sum.detach()])
                           [None], mesh, axes, differentiable=False)
        me = axes_index(mesh, axes)
        total = n * ways
        # the mesh step averages the ranks' gradients over the batch axes:
        # the gradient through this rank's probabilities is scaled by the
        # ways (the value is unchanged), so the mean is the global one
        prob_total = (every[:, e:].sum(dim=0)
                      + (ways * prob_sum - (ways * prob_sum).detach()))
        return (queue + every[:me, :e].sum(dim=0), self.capacity(total),
                every[:, :e].sum(dim=0) / total, prob_total / total)

    def forward(self, x):
        dtype = default_compute_dtype(self.dtype)
        b, t, c = x.shape
        tokens = x.reshape(b * t, c)
        _probs, _idx, gate, dispatch, aux = self.route(tokens)
        with torch.no_grad():
            self.aux_loss.copy_(aux.detach())
        if self._recording:
            self._aux = aux
        res = split_of(self, "expert_wi")
        xt = enter(tokens.to(dtype), res)
        if res is not None:  # this rank's experts
            first = res.index * res.size
            dispatch = dispatch[:, first:first + res.size]
            gate = enter(gate, res)
        xe = torch.einsum("nec,nd->ecd", dispatch.to(dtype), xt)
        he = F.gelu(
            torch.einsum("ecd,edh->ech", xe, self.expert_wi.to(dtype))
            + self.expert_bi[:, None].to(dtype), approximate="tanh")
        ye = (torch.einsum("ech,ehd->ecd", he, self.expert_wo.to(dtype))
              + self.expert_bo[:, None].to(dtype))
        combine = dispatch * gate[:, None, None]
        y = row_sum(torch.einsum("nec,ecd->nd", combine.to(dtype), ye), res)
        return y.reshape(b, t, c)


def _moe_modules(model) -> list:
    if isinstance(model, MoEMLP):
        return [model]
    return [m for m in model.modules() if isinstance(m, MoEMLP)]


def route_over_batch(model, mesh, axes) -> None:
    """Make every MoE block of ``model`` route over the global batch that
    ``axes`` of ``mesh`` split (this rank's tokens come after those of the
    ranks before it in ``axes``' order, as the rows of a batch sharded over
    them do); ``mesh=None`` or a single rank routes this rank's tokens
    alone."""
    from blendjax_torch.parallel.mesh import axes_size

    on = mesh is not None and axes and axes_size(mesh, axes) > 1
    for m in _moe_modules(model):
        m._batch = (mesh, tuple(axes)) if on else None


def collect_aux_loss(model) -> torch.Tensor:
    """The sum of every MoE block's load-balancing loss from the last
    forward: the differentiable values while :func:`apply_with_aux`
    records them, else the ``aux_loss`` buffers."""
    total = None
    for m in _moe_modules(model):
        v = m._aux if m._aux is not None else m.aux_loss
        total = v if total is None else total + v
    if total is None:
        return torch.zeros(())
    return total


def apply_with_aux(model, *args, aux_weight: float = 1e-2, **kwargs):
    """``model(*args, **kwargs)`` that also returns the weighted MoE
    load-balancing loss, differentiable: ``(out, aux_weight *
    collect_aux_loss(model))``. Add it to the task loss; without it top-1
    routing can collapse onto one expert."""
    mods = _moe_modules(model)
    for m in mods:
        m._recording, m._aux = True, None
    try:
        out = model(*args, **kwargs)
        aux = collect_aux_loss(model)
    finally:
        for m in mods:
            m._recording, m._aux = False, None
    return out, aux_weight * aux


__all__ = ["MoEMLP", "apply_with_aux", "collect_aux_loss", "route_over_batch"]
