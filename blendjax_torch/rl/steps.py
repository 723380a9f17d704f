"""RL learner steps: gather, loss, update, target and priority write-back in
one call (port of ``blendjax/rl/steps.py``).

A ``make_*_step`` builder returns ``step(state, token) -> (state,
{"loss"})`` over the token :meth:`TrajectoryReservoir.draw_token
<blendjax_torch.rl.replay.TrajectoryReservoir.draw_token>` yields: the
ring and the priority vector by reference, the host indices, importance
weights and write-back slots. The transition gather happens inside the
step, and each drawn row's new priority is written into the device vector
in place before it returns. On the card,
:class:`~blendjax_torch.train.CapturedStep` captures the step into one
CUDA graph: a learner step is then one replay (the host arrays are copied
into the graph's static inputs first), the port's form of the reference's
one dispatch per step. The JAX package computes these losses with einsums
and elementwise work outside any Pallas kernel; so do they here.

- :func:`make_dqn_step`: double DQN over ``{obs, action, reward, done,
  next_obs}`` with ``optax.huber_loss`` (delta 1), the importance-weighted
  mean, the Adam update, then the Polyak target ``(1 - tau) * t + tau *
  p`` (the target network lives in :class:`RLTrainState`), and
  ``prio[idx] = |td| + eps``.
- :func:`make_pg_step`: REINFORCE over transitions that carry a
  discounted return ``ret``, softmax over discrete actions with an entropy
  bonus; priorities become ``|ret - mean(ret)| + eps``.

A draw that repeats a slot writes it once, from the slot's last
occurrence (the token's ``_rl_write``), where XLA's scatter leaves the
winner undefined.

On a mesh (``state_sharding=``, :func:`mesh_rl_step_kwargs`) each rank
trains on its rows of the drawn batch (the sharded ring's gather), the
gradients and the loss are averaged over the batch axes in the step, and
the rows' TD errors are all-gathered so that every rank writes the whole
priority vector, which stays whole on every rank. The sharded gather
works on the card from the token's indices as a device tensor
(:mod:`blendjax_torch.data.ring`), so on an NCCL mesh of any size
:class:`~blendjax_torch.train.CapturedStep` captures the whole step: the
gather and its all-reduce, the weights' rows, the loss, the update, the
Polyak target and the priority write-back with its all-gather. Batch axes
of one rank take the same path (their collectives run over one rank).

Partition rules that split a parameter over a model axis (``fsdp``,
``tp``; :func:`make_rl_train_state` ``rules=`` / ``layout=``) shard the
state as the supervised path's (:class:`~blendjax_torch.parallel.ShardedParams`,
``state.shards``): each rank keeps its shard of every parameter and Adam
moment, gathers the online network on use and updates its shards. The
target network follows the online network's layout
(``state.target_shards``, shards that no optimizer updates): it is
gathered on use, and the Polyak update runs on the shards, elementwise
as on the whole tensors. On the card a step at one rank is captured
whole, gathers included.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from blendjax_torch.device import resolve_device
from blendjax_torch.precision import policy_value_and_grad, resolve_policy
from blendjax_torch.train.steps import TrainState


@dataclasses.dataclass
class RLTrainState(TrainState):
    """:class:`~blendjax_torch.train.TrainState` and the DQN target network
    (``target``, a copy of the model updated in place by the step), as the
    reference's ``RLTrainState`` holds ``target_params``. Its snapshot
    leaves add ``.target_params[...]``
    (:func:`blendjax_torch.weights.train_state_leaves`)."""

    target: torch.nn.Module | None = None
    # the target's shards when the state is split over a model axis
    target_shards: object = None


def make_rl_train_state(model, example_obs=None, optimizer=None,
                        learning_rate: float = 1e-3, rng=None, mesh=None,
                        target: bool = True, rules=None, layout=None,
                        device=None) -> RLTrainState:
    """``model`` (initialised from ``rng`` when given) on ``device``
    (``cuda`` unless ``"cpu"``) with Adam at ``optax.adam``'s defaults
    (betas (0.9, 0.999), eps 1e-8, no weight decay; capturable on the
    card) and, with ``target=True``, a target copy of it.

    ``example_obs`` is checked against the model's input width (the port's
    models fix it at construction). On a mesh, partition rules (``rules``,
    else ``layout``'s, else the model's) that split a parameter over a
    model axis (``fsdp``, of any size, or ``tp``) shard the state: the
    online network's parameters and Adam moments live as this rank's
    shards (``state.shards``, an AdamW at the same betas and eps with no
    weight decay, which is Adam) and the target network's as shards of
    the same layout (``state.target_shards``); pass ``learning_rate``,
    not ``optimizer``. Every rank must hold the same initial parameters
    (one seed)."""
    device = resolve_device(device)
    if rng is not None:
        model.init_params(int(rng))
    if example_obs is not None:
        width = getattr(next(iter(model.parameters()), None), "shape", None)
        obs = np.asarray(example_obs)
        if width is not None and len(width) == 2 and obs.shape[-1] != width[1]:
            raise ValueError(
                f"example_obs has width {obs.shape[-1]}; the model takes "
                f"{width[1]}")
    model = model.to(device)
    tgt = None
    if target:
        tgt = copy.deepcopy(model)
        tgt.requires_grad_(False)
    if mesh is not None:
        from blendjax_torch.parallel.sharding import (
            ShardedParams,
            resolve_rules,
            splits_state,
        )

        rules = resolve_rules(rules=rules, layout=layout, model=model)
        if splits_state(model, mesh, rules):
            if optimizer is not None:
                raise ValueError(
                    "an RL state sharded over a model axis makes its own "
                    "Adam over the shards; pass learning_rate, not "
                    "optimizer")
            shards = ShardedParams(model, mesh, rules=rules, optimizer_kwargs={
                "lr": learning_rate, "weight_decay": 0.0})
            target_shards = None
            if tgt is not None:
                target_shards = ShardedParams(tgt, mesh, rules=rules,
                                              optimizer=False)
                for t in target_shards.shards:
                    t.requires_grad_(False)
            return RLTrainState(model=model, optimizer=shards.optimizer,
                                shards=shards, target=tgt,
                                target_shards=target_shards)
    if optimizer is None:
        optimizer = torch.optim.Adam(
            model.parameters(), lr=learning_rate, betas=(0.9, 0.999),
            eps=1e-8, weight_decay=0.0,
            capturable=device.type == "cuda")
    return RLTrainState(model=model, optimizer=optimizer, target=tgt)


def mesh_rl_step_kwargs(state, mesh, data_axis: str = "data", rules=None,
                        layout=None) -> dict:
    """The mesh kwargs of either builder: ``state_sharding`` (the state's
    shardings, whose collectives average the gradients and the loss over
    the batch axes; ``rules`` / ``layout`` derive the leaves' layouts from
    partition rules, else a sharded state's own are read). A state split
    over a model axis gathers and updates its shards in the step.
    ``step = make_dqn_step(reservoir, **mesh_rl_step_kwargs(state,
    mesh))``."""
    from blendjax_torch.parallel.mesh import axis_names, mesh_shape
    from blendjax_torch.parallel.sharding import state_shardings

    if data_axis not in axis_names(mesh):
        raise ValueError(
            f"data_axis {data_axis!r} is not an axis of mesh "
            f"{mesh_shape(mesh)}")
    return {"state_sharding": state_shardings(
        state, mesh=mesh, rules=rules, layout=layout, data_axis=data_axis)}


def huber_loss(x, delta: float = 1.0):
    """``optax.huber_loss(x)`` elementwise, in the reference's operation
    order."""
    abs_x = x.abs()
    quadratic = torch.clamp(abs_x, max=delta)
    linear = abs_x - quadratic
    return 0.5 * quadratic ** 2 + delta * linear


def _device_array(v, device, dtype) -> torch.Tensor:
    """A token's host array on ``device`` (pinned and asynchronous on the
    card); a device tensor (a captured step's static input) passes."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype)
    t = torch.from_numpy(np.ascontiguousarray(v)).to(dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _apply(apply_fn):
    if apply_fn is None:
        return lambda model, obs: model(obs)
    return apply_fn


def _drawn(reservoir, token, state_sharding):
    """The token's rows (this rank's), weights (its rows) and write-back
    slots (the whole draw), on the device of the priorities."""
    prio = token["_rl_prio"]
    dev = prio.device
    rows = reservoir.draw(token["_rl_buffers"], token["_rl_idx"])
    weights = _device_array(token["_rl_weights"], dev, torch.float32)
    write = _device_array(token["_rl_write"], dev, torch.int64)
    if state_sharding is not None and state_sharding.batch_axes:
        from blendjax_torch.parallel.sharding import batch_sharding, local_rows

        weights = local_rows(weights, batch_sharding(
            state_sharding.mesh, axis=state_sharding.data_axis))
    return rows, weights, write, prio


def _gather(state, target: bool = False) -> None:
    """A sharded state's online network (and, with ``target``, its target
    network) gathered into the modules for this step."""
    if state.shards is not None:
        state.shards.gather()
        if target and state.target_shards is not None:
            state.target_shards.gather()


def _update(state, grads, loss, state_sharding):
    if state_sharding is not None:
        grads = state_sharding.reduce_grads(grads)
        loss = state_sharding.reduce_loss(loss)
    if state.shards is not None:
        state.shards.step(grads)
    else:
        state.optimizer.zero_grad(set_to_none=True)
        params = [p for p in state.model.parameters() if p.requires_grad]
        for p, g in zip(params, grads):
            p.grad = g
        state.optimizer.step()
    state.step += 1
    return loss


def _target_tensors(state) -> tuple:
    """``(target, online)`` tensors of the Polyak update: the shards of a
    sharded state (one layout: the update is elementwise), else the
    networks' parameters."""
    if state.shards is not None:
        return state.target_shards.shards, state.shards.shards
    return list(state.target.parameters()), list(state.model.parameters())


def _write_priorities(prio, write, per_row, eps, state_sharding) -> None:
    """``prio[write] = |per_row| + eps`` for the whole draw (a mesh rank's
    rows all-gathered first, over one rank too)."""
    if state_sharding is not None and state_sharding.batch_axes:
        from blendjax_torch.parallel.collectives import all_gather

        per_row = all_gather(per_row, state_sharding.mesh,
                             state_sharding.batch_axes, differentiable=False)
    with torch.no_grad():
        prio.index_put_((write,), per_row.abs() + eps)


def make_dqn_step(reservoir, apply_fn=None, gamma: float = 0.99,
                  tau: float = 0.01, double: bool = True,
                  priority_eps: float = 1e-3, precision=None,
                  state_sharding=None):
    """The DQN learner step over ``reservoir``'s tokens.

    ``apply_fn(model, obs) -> q`` (default ``model(obs)``); ``tau`` is the
    per-step Polyak coefficient of the target network (1.0: no target; 0:
    frozen); ``double=True`` picks the next action with the online network
    and evaluates it with the target (van Hasselt et al., 2016)."""
    policy = resolve_policy(precision)
    apply = _apply(apply_fn)

    def step(state, token):
        rows, weights, write, prio = _drawn(reservoir, token, state_sharding)
        _gather(state, target=True)
        obs = rows["obs"].float()
        act = rows["action"].long().reshape(-1)
        reward = rows["reward"].float().reshape(-1)
        done = rows["done"].float().reshape(-1)
        next_obs = rows["next_obs"].float()
        with torch.no_grad():
            q_next_t = apply(state.target, next_obs)
            if double:
                a_star = torch.argmax(apply(state.model, next_obs), dim=-1)
                next_v = q_next_t.gather(1, a_star[:, None])[:, 0]
            else:
                next_v = q_next_t.amax(dim=-1)
            target = reward + gamma * (1.0 - done) * next_v

        def loss_fn(model, _batch):
            q = apply(model, obs)
            qa = q.gather(1, act[:, None])[:, 0]
            td = qa - target
            return (weights * huber_loss(td)).mean(), td.detach()

        (loss, td), grads = policy_value_and_grad(loss_fn, state.model, None,
                                                  policy, has_aux=True)
        loss = _update(state, grads, loss.detach(), state_sharding)
        with torch.no_grad():
            tp, pp = _target_tensors(state)
            torch._foreach_mul_(tp, 1.0 - tau)
            torch._foreach_add_(tp, torch._foreach_mul(pp, tau))
        if state.target_shards is not None:
            state.target_shards.release()
        _write_priorities(prio, write, td, priority_eps, state_sharding)
        return state, {"loss": loss}

    def in_place(state, token):
        return [*_target_tensors(state)[0], token["_rl_prio"]]

    step.in_place = in_place
    return step


def make_pg_step(reservoir, apply_fn=None, entropy_coef: float = 0.01,
                 priority_eps: float = 1e-3, precision=None,
                 state_sharding=None):
    """The policy-gradient learner step: REINFORCE over transitions that
    carry a discounted return ``ret``; ``apply_fn(model, obs) -> logits``
    (a :class:`~blendjax_torch.models.QNetwork`-shaped head). Loss
    ``-(w * log pi(a|s) * adv).mean() - entropy_coef * entropy`` with
    ``adv = ret - mean(ret)`` (the whole draw's mean)."""
    policy = resolve_policy(precision)
    apply = _apply(apply_fn)

    def step(state, token):
        rows, weights, write, prio = _drawn(reservoir, token, state_sharding)
        _gather(state)
        obs = rows["obs"].float()
        act = rows["action"].long().reshape(-1)
        ret = rows["ret"].float().reshape(-1)
        mean = ret.mean()
        if state_sharding is not None:
            mean = state_sharding.reduce_loss(mean)
        adv = ret - mean

        def loss_fn(model, _batch):
            logits = apply(model, obs)
            logp = F.log_softmax(logits, dim=-1)
            lp_a = logp.gather(1, act[:, None])[:, 0]
            pg = -(weights * lp_a * adv).mean()
            entropy = -(torch.exp(logp) * logp).sum(dim=-1).mean()
            return pg - entropy_coef * entropy, adv

        (loss, adv), grads = policy_value_and_grad(loss_fn, state.model, None,
                                                   policy, has_aux=True)
        loss = _update(state, grads, loss.detach(), state_sharding)
        _write_priorities(prio, write, adv, priority_eps, state_sharding)
        return state, {"loss": loss}

    step.in_place = lambda state, token: [token["_rl_prio"]]
    return step


__all__ = [
    "RLTrainState",
    "huber_loss",
    "make_dqn_step",
    "make_pg_step",
    "make_rl_train_state",
    "mesh_rl_step_kwargs",
]
