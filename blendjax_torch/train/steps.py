"""Training steps (port of ``blendjax/train/steps.py``).

A step is ``step(state, batch) -> (state, {"loss": tensor})`` over a
:class:`TrainState` holding the model and its optimizer. The JAX package
jits each step; here every step runs eagerly on the card, and the chunked
form is a Python loop over the chunk axis in place of ``lax.scan`` (same
K sequential updates). :func:`make_fused_tile_step` decodes a packed chunk
group with the CUDA decode kernels and trains on it in the same call;
:func:`make_echo_fused_step` gathers and re-augments an echo draw from the
reservoir ring and trains on it in the same call. Augmentation inside the
supervised steps and gradient accumulation wait for a later slice.
"""

from __future__ import annotations

import dataclasses

import torch

from blendjax_torch.device import resolve_device


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_train_state(model, optimizer=None, learning_rate: float = 1e-3,
                     device=None) -> TrainState:
    """Move ``model`` to ``device`` (``cuda`` unless ``device="cpu"``)
    and pair it with AdamW at ``optax.adamw``'s defaults: betas (0.9,
    0.999), eps 1e-8, weight decay 1e-4 (torch's own default is 0.01)."""
    model = model.to(resolve_device(device))
    if optimizer is None:
        optimizer = torch.optim.AdamW(
            model.parameters(), lr=learning_rate, betas=(0.9, 0.999),
            eps=1e-8, weight_decay=1e-4,
        )
    return TrainState(model=model, optimizer=optimizer)


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


def _update(state: TrainState, batch: dict, loss_fn) -> torch.Tensor:
    state.optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(state.model, batch)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return loss.detach()


def make_supervised_step(loss_fn=None):
    """``step(state, batch)``: one optimizer update on ``batch``."""
    loss_fn = loss_fn or _default_loss

    def step(state, batch):
        return state, {"loss": _update(state, batch, loss_fn)}

    return step


def make_chunked_supervised_step(loss_fn=None):
    """``step(state, superbatch)`` over (K, B, ...) fields: K sequential
    updates (the JAX package's ``lax.scan``); ``loss`` is the K-vector."""
    loss_fn = loss_fn or _default_loss

    def step(state, superbatch):
        k = next(v.shape[0] for v in superbatch.values()
                 if getattr(v, "ndim", 0) >= 1)
        losses = [
            _update(state, {n: v[i] for n, v in superbatch.items()}, loss_fn)
            for i in range(k)
        ]
        return state, {"loss": torch.stack(losses)}

    return step


def make_fused_tile_step(loss_fn=None):
    """``step(state, batch)`` over what ``StreamDataPipeline`` yields: a
    packed chunk group is decoded on the card (tile groups through the
    CUDA decode kernels, full-frame palette groups through the byte-LUT
    gather, deferred run-length buffers first) and trained with K
    updates in the same call; a batch without ``_packed`` (a lone raw
    batch) trains on its fields directly."""
    from blendjax_torch.ops.tiles import (
        decode_packed_pal_superbatch,
        decode_packed_superbatch,
    )

    chunked = make_chunked_supervised_step(loss_fn)

    def step(state, batch):
        if "_pal" in batch:
            superbatch = decode_packed_pal_superbatch(
                batch["_packed"], batch["_spec"], batch["_pal"],
                batch.get("_rle", ()),
            )
        elif "_packed" in batch:
            superbatch = decode_packed_superbatch(
                batch["_packed"], batch["_refs"], batch["_spec"],
                batch["_names"], batch["_geoms"], batch.get("_rle", ()),
            )
        else:
            superbatch = {
                k: v for k, v in batch.items()
                if k != "_meta" and getattr(v, "ndim", 0) >= 1
            }
        return chunked(state, superbatch)

    return step


def make_echo_fused_step(reservoir_draw, loss_fn=None):
    """``step(state, batch)`` over what ``EchoingPipeline(emit_draws=True)``
    yields: a draw token ``{"_echo_buffers", "_echo_idx", "_echo_counter"}``
    is gathered from the ring and augmented by ``reservoir_draw``
    (:meth:`blendjax_torch.data.echo.SampleReservoir.draw`), then the loss
    and the AdamW update run, all in this one call; the gathered batch
    exists only inside it. A batch without ``_echo_idx`` (a fresh decoded
    batch) trains through :func:`make_supervised_step` on its fields."""
    loss_fn = loss_fn or _default_loss
    fallback = make_supervised_step(loss_fn)

    def step(state, batch):
        idx = batch.get("_echo_idx")
        if idx is None:
            fields = {k: v for k, v in batch.items()
                      if not k.startswith("_") or k == "_mask"}
            return fallback(state, fields)
        drawn = reservoir_draw(batch["_echo_buffers"], idx,
                               batch["_echo_counter"])
        return state, {"loss": _update(state, drawn, loss_fn)}

    return step
