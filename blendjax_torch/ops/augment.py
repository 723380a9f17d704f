"""Batched data augmentation on the card (port of ``blendjax/ops/augment.py``).

Every op is split in two:

- a **draw** from an explicit ``torch.Generator`` (crop offsets, flip
  bits, brightness/contrast factors, cutout centres: a few numbers per
  sample, made on the generator's device), and
- a deterministic **apply** that takes those draws.

The composed op ``op(gen, images)`` (or ``op(gen, images, points)`` for
the paired forms that move pixel-space labels with the image) draws and
applies. JAX's threefry keys cannot be reproduced in torch, so the tests
hold each apply against the JAX op given the JAX op's own draws.

:func:`make_batch_augment` and :func:`make_augment` compose ops under an
integer ``seed`` (the port's counterpart of a JAX key): op ``i`` draws
from a generator seeded with ``fold_seed(seed, i)``, as the JAX package
folds the key with ``i``. The composed :class:`SeededAugment` keeps its
generators, so a CUDA graph can register them and have them re-seeded
on the host before each replay. Images are NHWC, uint8 or float in
[0, 1].

Row-local application (a draw sharded over a mesh): the standard ops'
draws depend only on the generator and the draw's row count, so
``augment(seed, x, rows=(start, total))`` draws the random numbers of a
draw of ``total`` rows, the one-card draw's, keeps those of rows ``start
: start + len(x)`` and applies them to ``x`` alone. Each rank's rows then
equal its rows of the one-card draw bit for bit, for 1/ways of the apply's
work (:attr:`SeededAugment.row_local` says whether every op can; a uint8
colour jitter takes its per-sample mean from an exact integer sum, so no
reduction order depends on the row count).
"""

from __future__ import annotations

import functools
import inspect

import torch

from blendjax_torch.ops.image import _flip_bits, apply_flip, random_flip

_MASK64 = (1 << 64) - 1


def fold_seed(seed: int, *data: int) -> int:
    """Mix integers into a seed (splitmix64 per value): the port's
    ``jax.random.fold_in``. Returns a non-negative 63-bit int."""
    x = int(seed) & _MASK64
    for d in data:
        x = (x ^ (int(d) & _MASK64)) + 0x9E3779B97F4A7C15 & _MASK64
        x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & _MASK64
        x = (x ^ (x >> 27)) * 0x94D049BB133111EB & _MASK64
        x ^= x >> 31
    return x & ((1 << 63) - 1)


def seeded_generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` (draws happen where the images are)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


# -- draws ------------------------------------------------------------------


def crop_offsets(gen: torch.Generator, b: int, pad: int):
    """(B, 2) int64 per-sample ``(oy, ox)`` in ``[0, 2 * pad]``: the one
    draw shared by the paired and unpaired crops."""
    return torch.randint(0, 2 * pad + 1, (b, 2), generator=gen,
                         device=gen.device)


def jitter_factors(gen: torch.Generator, b: int, brightness: float = 0.2,
                   contrast: float = 0.2):
    """Per-sample f32 ``(bright, contr)``, each (B,): ``bright`` uniform in
    ``[-brightness, brightness)``, ``contr`` 1 + uniform in
    ``[-contrast, contrast)``."""
    u = torch.rand((2, b), generator=gen, device=gen.device)
    bright = -brightness + 2.0 * brightness * u[0]
    contr = 1.0 + (-contrast + 2.0 * contrast * u[1])
    return bright, contr


def cutout_centres(gen: torch.Generator, b: int, h: int, w: int):
    """(B, 2) int64 per-sample ``(cy, cx)``, ``cy`` in ``[0, h)``, ``cx``
    in ``[0, w)``."""
    cy = torch.randint(0, h, (b,), generator=gen, device=gen.device)
    cx = torch.randint(0, w, (b,), generator=gen, device=gen.device)
    return torch.stack([cy, cx], dim=-1)


# -- applies ----------------------------------------------------------------


def apply_crop(images, offsets, pad: int):
    """Edge-pad by ``pad`` and crop each sample back to H x W at its
    ``(oy, ox)``; padding and crop are one gather (row ``r`` reads source
    row ``clamp(r + oy - pad, 0, H - 1)``), so no padded copy is made."""
    b, h, w, _ = images.shape
    dev = images.device
    offsets = offsets.to(dev)
    rows = (torch.arange(h, device=dev)[None] + offsets[:, :1] - pad).clamp(0, h - 1)
    cols = (torch.arange(w, device=dev)[None] + offsets[:, 1:] - pad).clamp(0, w - 1)
    bi = torch.arange(b, device=dev)[:, None, None]
    return images[bi, rows[:, :, None], cols[:, None, :]]


def shift_points(points, offsets, pad: int):
    """Move (B, P, 2) ``(x, y)`` pixel points with the crop at ``offsets``."""
    offsets = offsets.to(points.device)
    shift = torch.stack([pad - offsets[:, 1], pad - offsets[:, 0]], dim=-1)
    return points + shift[:, None, :].to(points.dtype)


def apply_color_jitter(images, bright, contr):
    """``clip((x - mean) * contr + mean + bright, 0, 1)`` per sample, the
    mean per channel over H and W, all in f32. uint8 input is scaled by
    1/255 first and rounded back with ``torch.round`` (half to even, as
    ``jnp.round``); float input stays float."""
    is_int = not images.dtype.is_floating_point
    x = images.to(torch.float32)
    if is_int:
        x = x / 255.0
        # the exact mean of the scaled pixels, rounded once: an integer sum
        # has no reduction order, so a sample's mean never depends on how
        # many samples the call holds
        total = images.sum(dim=(1, 2), keepdim=True, dtype=torch.int64)
        mean = (total.to(torch.float64)
                / (255.0 * images.shape[1] * images.shape[2])).float()
    else:
        mean = x.mean(dim=(1, 2), keepdim=True)
    shape = (images.shape[0],) + (1,) * (images.ndim - 1)
    x = torch.clamp(
        (x - mean) * contr.to(x.device).reshape(shape) + mean
        + bright.to(x.device).reshape(shape), 0.0, 1.0,
    )
    if is_int:
        return torch.round(x * 255.0).to(images.dtype)
    return x.to(images.dtype)


def apply_cutout(images, centres, size: int = 16, fill: int = 0):
    """Fill a ``size`` square around each sample's ``(cy, cx)`` (clipped
    at the frame edge)."""
    _, h, w, _ = images.shape
    dev = images.device
    centres = centres.to(dev)
    cy = centres[:, 0, None, None]
    cx = centres[:, 1, None, None]
    ys = torch.arange(h, device=dev)[None, :, None]
    xs = torch.arange(w, device=dev)[None, None, :]
    half = size // 2
    mask = (ys >= cy - half) & (ys < cy + half) & (xs >= cx - half) & (xs < cx + half)
    return images.masked_fill(mask[..., None], fill)


def apply_flip_with_points(images, points, bits, axis: int = 2):
    """Flip the samples whose ``bits`` are set along ``axis`` and mirror
    their (B, P, 2) ``(x, y)`` points: ``axis=2`` mirrors x, ``axis=1`` y."""
    size = images.shape[axis]
    coord = 0 if axis == 2 else 1
    bits = bits.to(images.device)
    mirrored = points.clone()
    mirrored[..., coord] = (size - 1) - points[..., coord]
    return (apply_flip(images, bits, axis),
            torch.where(bits.reshape(-1, 1, 1), mirrored, points))


# -- ops: draw, then apply --------------------------------------------------


def random_crop(gen, images, pad: int = 4):
    """Pad-and-crop (the CIFAR recipe), a random offset per sample."""
    return apply_crop(images, crop_offsets(gen, images.shape[0], pad), pad)


def color_jitter(gen, images, brightness: float = 0.2, contrast: float = 0.2):
    """Per-sample brightness/contrast jitter (uint8 in, uint8 out)."""
    bright, contr = jitter_factors(gen, images.shape[0], brightness, contrast)
    return apply_color_jitter(images, bright, contr)


def random_cutout(gen, images, size: int = 16, fill: int = 0):
    """Per-sample square cutout at a random location."""
    b, h, w, _ = images.shape
    return apply_cutout(images, cutout_centres(gen, b, h, w), size, fill)


def random_flip_with_points(gen, images, points, axis: int = 2):
    """Per-sample flip of ``images`` with the matching mirror of their
    pixel-space ``points``; the flip bits are :func:`random_flip`'s draw.
    Returns ``(images, points)``."""
    bits = _flip_bits(gen, images.shape[0])
    return apply_flip_with_points(images, points, bits, axis)


def random_crop_with_points(gen, images, points, pad: int = 4):
    """Paired pad-and-crop: ``points`` shift by each sample's crop
    offset (they may leave the frame). Returns ``(images, points)``."""
    offsets = crop_offsets(gen, images.shape[0], pad)
    return apply_crop(images, offsets, pad), shift_points(points, offsets, pad)


# -- draw/apply splits of the composed ops (row-local application) ---------


def _flip_draw(gen, b, shape, axis: int = 2):
    return _flip_bits(gen, b)


_SPLITS = {
    # op: (draw(gen, rows, image shape, **kw), apply(images, [points,]
    # draws, **kw))
    random_crop: (lambda gen, b, shape, pad=4: crop_offsets(gen, b, pad),
                  lambda x, d, pad=4: apply_crop(x, d, pad)),
    color_jitter: (lambda gen, b, shape, brightness=0.2, contrast=0.2:
                   jitter_factors(gen, b, brightness, contrast),
                   lambda x, d, brightness=0.2, contrast=0.2:
                   apply_color_jitter(x, *d)),
    random_cutout: (lambda gen, b, shape, size=16, fill=0:
                    cutout_centres(gen, b, shape[1], shape[2]),
                    lambda x, d, size=16, fill=0:
                    apply_cutout(x, d, size, fill)),
    random_flip: (_flip_draw,
                  lambda x, d, axis=2: apply_flip(x, d, axis)),
    random_flip_with_points: (
        _flip_draw,
        lambda x, p, d, axis=2: apply_flip_with_points(x, p, d, axis)),
    random_crop_with_points: (
        lambda gen, b, shape, pad=4: crop_offsets(gen, b, pad),
        lambda x, p, d, pad=4: (apply_crop(x, d, pad),
                                shift_points(p, d, pad))),
}


def op_split(op):
    """``(draw, apply)`` of a standard op (keywords of a
    ``functools.partial`` bound): ``draw(gen, rows, image_shape)`` makes
    its random numbers for ``rows`` samples, ``apply(images, [points,]
    draws)`` applies them; None for any other op."""
    kw: dict = {}
    fn = op
    while isinstance(fn, functools.partial):
        if fn.args:
            return None
        kw = {**fn.keywords, **kw}
        fn = fn.func
    entry = _SPLITS.get(fn)
    if entry is None:
        return None
    draw, apply = entry
    return (functools.partial(draw, **kw), functools.partial(apply, **kw))


def _rows_of(draws, start: int, n: int):
    """Rows ``start : start + n`` of an op's draws (a tensor or a tuple)."""
    if isinstance(draws, tuple):
        return tuple(d[start:start + n] for d in draws)
    return draws[start:start + n]


def _local_draws(op, gen, images, rows):
    """The draws of ``images``' rows of a draw of ``rows = (start,
    total)`` rows."""
    start, total = rows
    draw, apply = op_split(op)
    d = draw(gen, total, (total, *images.shape[1:]))
    return apply, _rows_of(d, start, images.shape[0])


def _n_required(op) -> int:
    empty = inspect.Parameter.empty
    positional = (inspect.Parameter.POSITIONAL_ONLY,
                  inspect.Parameter.POSITIONAL_OR_KEYWORD)
    return sum(1 for p in inspect.signature(op).parameters.values()
               if p.default is empty and p.kind in positional)


class SeededAugment:
    """Ops composed under an integer seed: op ``i`` draws from a generator
    seeded with ``fold_seed(seed, i)``, as the JAX package folds the key
    with ``i``.

    The generators live as long as this object, one per op for each
    device and ``slot`` (the chunked steps give each update of a chunk its
    own slot), so a CUDA graph can register them
    (``CUDAGraph.register_generator_state``). A call seeds them on the
    host and then draws; while the current stream is being captured it
    only draws, and :meth:`seed` runs on the host before each replay
    instead: PyTorch reads a registered generator's seed and offset afresh
    at every replay. A generator seeded again gives the draws of a new
    generator with that seed, so reuse changes no number."""

    def __init__(self, ops, apply, image_key: str | None = None):
        self.ops = tuple(ops)
        self._apply = apply  # (generators, x, rows) -> x
        # None: x is the images; else x is a batch dict holding them there
        self.image_key = image_key
        self._gens: dict = {}

    @property
    def row_local(self) -> bool:
        """Whether every op splits into a draw and an apply, so a call
        with ``rows=`` applies to the given rows alone."""
        return all(op_split(op) is not None for op in self.ops)

    def generators(self, device, slot: int = 0) -> list:
        """The generators op by op for ``device`` and ``slot``."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        gens = self._gens.get((device, slot))
        if gens is None:
            gens = self._gens[(device, slot)] = [
                torch.Generator(device=device) for _ in self.ops]
        return gens

    def seed(self, seed: int, device, slot: int = 0) -> None:
        for i, gen in enumerate(self.generators(device, slot)):
            gen.manual_seed(fold_seed(seed, i))

    def __call__(self, seed, x, slot: int = 0, rows=None):
        """Augment ``x`` with the draws of ``seed``; ``rows=(start,
        total)`` says ``x`` holds rows ``start : start + len(x)`` of a draw
        of ``total`` rows, which are drawn whole and applied to ``x`` alone
        (:attr:`row_local` ops only)."""
        images = x if self.image_key is None else x.get(self.image_key)
        if images is None:  # a batch without the image field
            return x
        if rows is not None and not self.row_local:
            raise ValueError(
                "rows= needs ops that split into a draw and an apply (the "
                "standard ops of blendjax_torch.ops.augment)")
        device = images.device
        if not (device.type == "cuda"
                and torch.cuda.is_current_stream_capturing()):
            self.seed(seed, device, slot)
        return self._apply(self.generators(device, slot), x, rows)


def host_seeded(augment) -> bool:
    """Whether ``augment`` is a plain ``fn(seed, x)``: neither None nor a
    :class:`SeededAugment`. It takes its seed as a host integer, which a
    CUDA graph would freeze at its capture, so its calls run eagerly."""
    return augment is not None and not isinstance(augment, SeededAugment)


def call_augment(augment, seed: int, x, slot: int = 0):
    """``augment(seed, x)``, in ``slot`` when ``augment`` is a
    :class:`SeededAugment` (any other ``fn(seed, x)`` has no slots)."""
    if isinstance(augment, SeededAugment):
        return augment(seed, x, slot=slot)
    return augment(seed, x)


def make_batch_augment(*ops, image_key: str = "image",
                       points_key: str | None = None) -> SeededAugment:
    """Lift image ops to batch dicts: ``augment(seed, batch) -> batch``.

    An op with two required parameters, ``op(gen, images)``, transforms
    ``batch[image_key]`` alone; one with three, ``op(gen, images,
    points)``, transforms the image and ``batch[points_key]`` together and
    needs ``points_key``. Op ``i`` draws from ``fold_seed(seed, i)`` on
    the images' device. Other fields pass through; a batch without
    ``image_key`` is returned unchanged."""
    paired = tuple(_n_required(op) >= 3 for op in ops)
    if any(paired) and points_key is None:
        raise ValueError(
            "paired ops (gen, images, points) need points_key= to name "
            "the label field they co-transform"
        )

    def apply(gens, batch, rows=None):
        images = batch[image_key]
        points = batch.get(points_key) if points_key is not None else None
        if points is None and any(paired):
            raise KeyError(
                f"paired augmentation needs batch[{points_key!r}], which "
                f"is missing (batch fields: {sorted(batch)})"
            )
        for gen, op, pair in zip(gens, ops, paired):
            if rows is not None:
                fn, d = _local_draws(op, gen, images, rows)
                if pair:
                    images, points = fn(images, points, d)
                else:
                    images = fn(images, d)
            elif pair:
                images, points = op(gen, images, points)
            else:
                images = op(gen, images)
        out = dict(batch)
        out[image_key] = images
        if points is not None:
            out[points_key] = points
        return out

    return SeededAugment(ops, apply, image_key=image_key)


def make_augment(*ops) -> SeededAugment:
    """Compose ops into one ``augment(seed, images)``; op ``i`` draws from
    ``fold_seed(seed, i)``."""

    def apply(gens, images, rows=None):
        for gen, op in zip(gens, ops):
            if rows is not None:
                fn, d = _local_draws(op, gen, images, rows)
                images = fn(images, d)
            else:
                images = op(gen, images)
        return images

    return SeededAugment(ops, apply)


__all__ = [
    "apply_color_jitter",
    "apply_crop",
    "apply_cutout",
    "apply_flip_with_points",
    "color_jitter",
    "crop_offsets",
    "cutout_centres",
    "fold_seed",
    "host_seeded",
    "jitter_factors",
    "make_augment",
    "make_batch_augment",
    "op_split",
    "random_crop",
    "random_crop_with_points",
    "random_cutout",
    "random_flip",
    "random_flip_with_points",
    "SeededAugment",
    "call_augment",
    "seeded_generator",
    "shift_points",
]
