"""Training steps (port of ``blendjax/train/steps.py``).

A step is ``step(state, batch) -> (state, {"loss": tensor})`` over a
:class:`TrainState` holding the model and its optimizer. The JAX package
jits each step; here a step runs eagerly, and on the card
:mod:`blendjax_torch.train.aot` captures it into one CUDA graph per batch
signature. The chunked form is a Python loop over the chunk axis in place
of ``lax.scan`` (the same K sequential updates).
:func:`make_fused_tile_step` decodes a packed chunk group with the CUDA
decode kernels and trains on it in the same call;
:func:`make_echo_fused_step` gathers and re-augments an echo draw from the
reservoir ring and trains on it in the same call.

Every builder's step carries two host hooks for graph capture:
``step.generators(state, batch)``, the random generators its
augmentation draws from (a graph registers them), and
``step.reseed(state, batch)``, which seeds them for that call on the host
as the eager step does before it draws (a graph replays only device
work). Update ``k`` of a call draws from slot ``k`` of the augmentation
(:class:`~blendjax_torch.ops.augment.SeededAugment`) with the seed
``fold_seed(augment_rng, state.step)`` of that update, the port's
``fold_in(base_rng, state.step)``. A step that updates tensors in place
beyond the model and its optimizer (an RL step's target network and
priority vector) lists them in a third hook, ``step.in_place(state,
batch)``, which a capture snapshots and restores around its warm-up. A
draw token names the entries a capture reads in place, never copying
them, under ``_by_reference``.

On a mesh (:mod:`blendjax_torch.train.mesh_driver`) each builder takes
``state_sharding=`` (:func:`blendjax_torch.parallel.state_shardings` of
the state): the step then issues the collectives the JAX package's jit
inserts, in the step, with no DDP hook: one all-reduce of the gradients'
mean over the batch axes per update, and of the loss, so the reported
loss is the global batch's. A masked (padded) batch weighs each rank's
loss by its share of the real rows first. A state sharded over a model
axis (``state.shards``, :class:`~blendjax_torch.parallel.ShardedParams`)
gathers its ``fsdp`` shards before the update (its ``tp`` and ``expert``
blocks stay in place, computed with by their modules) and updates its
shards after, with a capturable AdamW on the card: the gathers, the
gradient, the means over the batch axes and the shards' update issue no
host sync, so one graph captures them all.
"""

from __future__ import annotations

import dataclasses

import torch

from blendjax_torch.device import resolve_device
from blendjax_torch.ops.augment import SeededAugment, call_augment, fold_seed
from blendjax_torch.precision import policy_value_and_grad, resolve_policy


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    # a state split over a model axis: the parameters' and moments' shards
    shards: object = None


def make_train_state(model, optimizer=None, learning_rate: float = 1e-3,
                     device=None, capturable=None, mesh=None,
                     rules=None) -> TrainState:
    """Move ``model`` to ``device`` (``cuda`` unless ``device="cpu"``)
    and pair it with AdamW at ``optax.adamw``'s defaults: betas (0.9,
    0.999), eps 1e-8, weight decay 1e-4 (torch's own default is 0.01).

    ``capturable`` (``None``: ``True`` on a CUDA device) builds the AdamW
    that a CUDA graph can capture: its step count lives on the card.
    torch refuses it for CPU parameters, where it stays off.

    With ``mesh`` and partition ``rules`` that split some parameter over a
    model axis (``fsdp``/``tp``/``expert``; a ``tp`` or ``expert`` axis of
    size 1 too, when a module computes with the split), the state is
    sharded: its parameters and
    AdamW moments live as this rank's shards (:class:`~blendjax_torch.parallel.ShardedParams`,
    ``state.shards``) and ``state.optimizer`` updates those (capturable on
    a CUDA device, whatever ``capturable`` says). Every rank must hold the
    same initial parameters (one seed)."""
    device = resolve_device(device)
    model = model.to(device)
    if mesh is not None:
        from blendjax_torch.parallel.sharding import (
            ShardedParams,
            splits_state,
        )

        rules = tuple(rules or ())
        if splits_state(model, mesh, rules):
            if optimizer is not None:
                raise ValueError(
                    "a state sharded over a model axis makes its own AdamW "
                    "over the shards; pass learning_rate, not optimizer")
            shards = ShardedParams(model, mesh, rules=rules,
                                   optimizer_kwargs={"lr": learning_rate})
            return TrainState(model=model, optimizer=shards.optimizer,
                              shards=shards)
    if capturable is None:
        capturable = device.type == "cuda"
    if optimizer is None:
        optimizer = torch.optim.AdamW(
            model.parameters(), lr=learning_rate, betas=(0.9, 0.999),
            eps=1e-8, weight_decay=1e-4, capturable=bool(capturable),
        )
    return TrainState(model=model, optimizer=optimizer)


def state_device(state: TrainState) -> torch.device:
    return next(state.model.parameters()).device


def batch_images(batch) -> int:
    """Images this batch trains on: a draw token's index count, a
    packed group's K' x the per-batch lead of ``_spec`` (its ``xy``
    field's, else the largest), K x B of a (K, B, H, W, C) image, else
    the leading dim. Shape reads only."""
    idx = batch.get("_echo_idx")
    if idx is None:
        idx = batch.get("_rl_idx")
    if idx is not None:
        return int(len(idx))
    packed = batch.get("_packed")
    if packed is not None:
        spec = batch.get("_spec") or ()
        lead = next((s[0] for n, _d, s, *_r in spec if n == "xy"), None)
        if lead is None:
            lead = max((s[0] for _n, _d, s, *_r in spec if s), default=1)
        return int(packed.shape[0]) * int(lead)
    img = batch.get("image")
    if img is not None and getattr(img, "ndim", 0) >= 4:
        shp = img.shape
        return int(shp[0] * shp[1]) if img.ndim >= 5 else int(shp[0])
    return int(next((v.shape[0] for k, v in batch.items()
                     if not k.startswith("_")
                     and getattr(v, "ndim", 0) >= 1), 0))


def corner_loss(pred, xy, image_shape=None, mask=None):
    """MSE over predicted corner pixels, normalised to [0, 1] image
    coordinates. ``mask`` (B,) marks the valid rows of a bucket-padded
    batch: padded rows contribute nothing and the mean divides by the
    number of real rows."""
    xy = xy.float()
    if image_shape is not None:
        # divide by Python scalars: a (w, h) tensor built here would be a
        # host-to-device copy that waits for the queued steps
        h, w = image_shape
        pred = torch.stack([pred[..., 0] / w, pred[..., 1] / h], dim=-1)
        xy = torch.stack([xy[..., 0] / w, xy[..., 1] / h], dim=-1)
    err = (pred - xy) ** 2
    if mask is None:
        return err.mean()
    per = err.reshape(err.shape[0], -1).mean(dim=1)
    m = mask.float()
    return (per * m).sum() / m.sum().clamp(min=1.0)


def _default_loss(model, batch):
    """The one default loss of every step builder: corner regression,
    honouring the ``_mask`` of a padded batch."""
    return corner_loss(
        model(batch["image"]), batch["xy"],
        image_shape=tuple(batch["image"].shape[1:3]),
        mask=batch.get("_mask"),
    )


def _lead(batch) -> int:
    return next((v.shape[0] for v in batch.values()
                 if getattr(v, "ndim", 0) >= 1), 0)


def _grads(state, batch, loss_fn, policy, accum_steps: int):
    """``(loss, grads)``; ``accum_steps > 1`` splits every field whose
    leading dim is the batch's into that many micro-batches (other fields
    ride along with each), sums their f32 losses and gradients in order
    and divides by the count, as the JAX step's ``lax.scan`` does."""
    if accum_steps == 1:
        loss, grads = policy_value_and_grad(loss_fn, state.model, batch,
                                            policy)
        return loss.detach(), grads
    lead = _lead(batch)
    if lead % accum_steps:
        raise ValueError(
            f"batch leading dim {lead} not divisible by "
            f"accum_steps={accum_steps}"
        )
    micro = {k: v.reshape(accum_steps, lead // accum_steps, *v.shape[1:])
             for k, v in batch.items()
             if getattr(v, "ndim", 0) >= 1 and v.shape[0] == lead}
    side = {k: v for k, v in batch.items() if k not in micro}
    loss_sum = grad_sum = None
    for i in range(accum_steps):
        part = {**side, **{k: v[i] for k, v in micro.items()}}
        loss, grads = policy_value_and_grad(loss_fn, state.model, part,
                                            policy)
        loss = loss.detach()
        if grad_sum is None:  # 0 + x == x: the JAX scan's zeros start
            loss_sum, grad_sum = loss, list(grads)
        else:
            loss_sum = loss_sum + loss
            grad_sum = [a + g for a, g in zip(grad_sum, grads)]
    return (loss_sum / accum_steps,
            tuple(g / accum_steps for g in grad_sum))


def _weighted(loss_fn, weight):
    def weighted(model, batch):
        return loss_fn(model, batch) * weight

    return weighted


def _update(state: TrainState, batch: dict, loss_fn, policy,
            accum_steps: int = 1, sharding=None) -> torch.Tensor:
    """One optimizer update on ``batch``; returns its (detached) loss.
    ``sharding`` (a :class:`~blendjax_torch.parallel.sharding.StateShardings`)
    averages the gradients and the loss over the batch axes."""
    shards = state.shards
    if shards is not None:
        shards.gather()
    if (sharding is not None and sharding.batch_ways > 1
            and batch.get("_mask") is not None):
        loss_fn = _weighted(loss_fn, sharding.row_weight(batch["_mask"]))
    loss, grads = _grads(state, batch, loss_fn, policy, accum_steps)
    if sharding is not None:
        grads = sharding.reduce_grads(grads)
        loss = sharding.reduce_loss(loss)
    if shards is not None:
        shards.step(grads)
    else:
        state.optimizer.zero_grad(set_to_none=True)
        params = [p for p in state.model.parameters() if p.requires_grad]
        for p, g in zip(params, grads):
            p.grad = g
        state.optimizer.step()
    state.step += 1
    return loss


def _augmented(batch, augment, base: int, state, slot: int):
    if augment is None:
        return batch
    seed = fold_seed(base, state.step)
    return {**batch, "image": call_augment(augment, seed, batch["image"], slot)}


def _with_hooks(step, augment=None, base: int = 0, slots=lambda b: 1):
    """Attach ``step.generators`` and ``step.reseed`` for an augmentation
    whose update ``k`` of a call (``slots(batch)`` of them) draws from
    slot ``k`` with the seed of that update's step."""
    seeded = isinstance(augment, SeededAugment)

    def generators(state, batch):
        if not seeded:
            return []
        dev = state_device(state)
        return [g for k in range(slots(batch))
                for g in augment.generators(dev, k)]

    def reseed(state, batch):
        if seeded:
            dev = state_device(state)
            for k in range(slots(batch)):
                augment.seed(fold_seed(base, state.step + k), dev, k)

    step.generators = generators
    step.reseed = reseed
    return step


def make_supervised_step(loss_fn=None, accum_steps: int = 1, augment=None,
                         augment_rng=None, precision=None,
                         state_sharding=None):
    """``step(state, batch)``: one optimizer update on ``batch``.

    - ``accum_steps=N`` splits the batch's leading axis into N
      micro-batches and makes one update from their summed f32 gradients
      (a lead that N does not divide raises);
    - ``augment`` (``fn(seed, images) -> images``, e.g.
      :func:`blendjax_torch.ops.augment.make_augment`) transforms
      ``batch["image"]`` inside the step with the seed
      ``fold_seed(augment_rng, state.step)`` (``augment_rng`` defaults to
      0);
    - ``precision`` names a policy of :mod:`blendjax_torch.precision`
      (``None``: the default, bf16-compute);
    - ``state_sharding`` (a mesh run's state shardings) adds the mean of
      the gradients and the loss over the batch axes.
    """
    loss_fn = loss_fn or _default_loss
    policy = resolve_policy(precision)
    accum_steps = max(1, int(accum_steps))
    base = int(augment_rng or 0)

    def step(state, batch):
        batch = _augmented(batch, augment, base, state, 0)
        return state, {"loss": _update(state, batch, loss_fn, policy,
                                       accum_steps, state_sharding)}

    return _with_hooks(step, augment, base)


def make_chunked_supervised_step(loss_fn=None, augment=None, augment_rng=None,
                                 precision=None, state_sharding=None):
    """``step(state, superbatch)`` over (K, B, ...) fields: K sequential
    updates (the JAX package's ``lax.scan``); ``loss`` is the K-vector.
    ``augment``, ``augment_rng``, ``precision`` and ``state_sharding`` as
    in :func:`make_supervised_step`, update ``k`` augmenting in slot
    ``k``."""
    loss_fn = loss_fn or _default_loss
    policy = resolve_policy(precision)
    base = int(augment_rng or 0)

    def step(state, superbatch):
        losses = []
        for i in range(_lead(superbatch)):
            batch = _augmented({n: v[i] for n, v in superbatch.items()},
                               augment, base, state, i)
            losses.append(_update(state, batch, loss_fn, policy,
                                  sharding=state_sharding))
        return state, {"loss": torch.stack(losses)}

    return _with_hooks(step, augment, base, _lead)


def _chunk_of(batch) -> int:
    packed = batch.get("_packed")
    return int(packed.shape[0]) if packed is not None else _lead(
        _raw_fields(batch))


def _raw_fields(batch) -> dict:
    return {k: v for k, v in batch.items()
            if k != "_meta" and getattr(v, "ndim", 0) >= 1}


def make_fused_tile_step(loss_fn=None, augment=None, augment_rng=None,
                         precision=None, state_sharding=None,
                         superbatch_constraint=None):
    """``step(state, batch)`` over what ``StreamDataPipeline`` yields: a
    packed chunk group is decoded on the card (tile groups through the
    CUDA decode kernels, full-frame palette groups through the byte-LUT
    gather, deferred run-length buffers first) and trained with K
    updates in the same call; a batch without ``_packed`` (a lone raw
    batch) trains on its fields directly. ``augment``, ``augment_rng``,
    ``precision`` and ``state_sharding`` as in
    :func:`make_chunked_supervised_step`.

    ``superbatch_constraint`` (a batch :class:`~blendjax_torch.parallel.Sharding`
    or None) makes each rank decode (with K1/K2) and train on only its rows
    of every packed group, which travels whole. A raw batch arrives with
    this rank's rows already (the feeder's), and so does a packed group
    marked ``ops.tiles.LOCAL_ROWS_KEY`` (a mesh pipeline's group of this
    rank's own producers or recording), which is decoded whole."""
    from blendjax_torch.ops.tiles import LOCAL_ROWS_KEY, decode_packed_group
    from blendjax_torch.parallel.sharding import check_sharding, leading_axes

    chunked = make_chunked_supervised_step(loss_fn, augment, augment_rng,
                                           precision, state_sharding)
    mesh, axes = None, "data"
    if check_sharding(superbatch_constraint) is not None:
        mesh = superbatch_constraint.mesh
        axes = leading_axes(superbatch_constraint)

    def step(state, batch):
        rows_of = None if batch.get(LOCAL_ROWS_KEY) else mesh
        if "_packed" in batch:
            superbatch = decode_packed_group(batch, mesh=rows_of,
                                             data_axis=axes)
        else:
            superbatch = _raw_fields(batch)
        return chunked(state, superbatch)

    return _with_hooks(step, augment, int(augment_rng or 0), _chunk_of)


def make_echo_fused_step(reservoir_draw, loss_fn=None, precision=None,
                         state_sharding=None, buffer_sharding=None):
    """``step(state, batch)`` over what ``EchoingPipeline(emit_draws=True)``
    yields: a draw token (``_echo_buffers``, ``_echo_idx``, ``_echo_counter``)
    is gathered from the ring and augmented by ``reservoir_draw``
    (:meth:`blendjax_torch.data.echo.SampleReservoir.draw`), then the loss
    and the AdamW update run, all in this one call; the gathered batch
    exists only inside it. A batch without ``_echo_idx`` (a fresh decoded
    batch) trains through :func:`make_supervised_step` on its fields.

    When ``reservoir_draw`` is a reservoir's bound ``draw``, the step's
    host hooks check the token against the ring and seed the draw's
    generators from its counter (:meth:`SampleReservoir.seed_draw`).

    On a mesh: ``state_sharding`` as in :func:`make_supervised_step`;
    ``buffer_sharding`` is the ring's sharding the step was built for (a
    reservoir of another layout raises); a draw yields this rank's rows."""
    loss_fn = loss_fn or _default_loss
    policy = resolve_policy(precision)
    fallback = make_supervised_step(loss_fn, precision=precision,
                                    state_sharding=state_sharding)
    reservoir = getattr(reservoir_draw, "__self__", None)
    hooked = hasattr(reservoir, "seed_draw")
    if (buffer_sharding is not None
            and getattr(reservoir, "sharding", buffer_sharding)
            != buffer_sharding):
        raise ValueError(
            f"the reservoir ring is laid out as {reservoir.sharding!r}, not "
            f"the {buffer_sharding!r} this step was built for")

    def step(state, batch):
        idx = batch.get("_echo_idx")
        if idx is None:
            fields = {k: v for k, v in batch.items()
                      if not k.startswith("_") or k == "_mask"}
            return fallback(state, fields)
        drawn = reservoir_draw(batch["_echo_buffers"], idx,
                               batch["_echo_counter"])
        return state, {"loss": _update(state, drawn, loss_fn, policy,
                                       sharding=state_sharding)}

    def generators(state, batch):
        if hooked and "_echo_idx" in batch:
            return reservoir.draw_generators()
        return []

    def reseed(state, batch):
        if hooked and "_echo_idx" in batch:
            reservoir.check_token(batch["_echo_buffers"])
            reservoir.seed_draw(batch["_echo_counter"])

    step.generators = generators
    step.reseed = reseed
    return step


def make_eval_step():
    """``evaluate(state, batch) -> {"loss", "px_err"}`` without touching
    the state: the corner loss and the mean Euclidean corner error in
    pixels; with ``_mask`` only the real rows count (an eval pass sees
    every real example once)."""

    @torch.no_grad()
    def evaluate(state, batch):
        pred = state.model(batch["image"])
        mask = batch.get("_mask")
        err = torch.linalg.vector_norm(pred - batch["xy"].float(), dim=-1)
        if mask is None:
            px_err = err.mean()
        else:
            m = mask.float()
            px_err = ((err.reshape(err.shape[0], -1).mean(dim=1) * m).sum()
                      / m.sum().clamp(min=1.0))
        return {
            "loss": corner_loss(pred, batch["xy"],
                                image_shape=tuple(batch["image"].shape[1:3]),
                                mask=mask),
            "px_err": px_err,
        }

    return evaluate
