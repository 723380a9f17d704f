"""The boundaries of a Megatron split inside a module (tensor and expert
parallelism over one model axis, ``blendjax_torch/docs/mesh-split.md``).

A module whose parameter is split in place (a
:class:`~blendjax_torch.parallel.sharding.Resident`, read with
:func:`~blendjax_torch.parallel.sharding.split_of`) computes its part of a
layer from the replicated activations every rank of the axis holds:

- a column-split layer takes its input through :func:`enter` (backward:
  the sum of the ranks' partial input gradients) and its replicated bias
  through :func:`column_bias` (this rank's slice; backward: the gradient
  slices gathered into the full bias's);
- its split output becomes the replicated activation again through
  :func:`gather_columns` (an all-gather; backward: this rank's slice), or
  feeds a row-split layer whose partial products :func:`row_sum` sums
  over the axis (backward: the identity).
"""

from __future__ import annotations


def enter(x, res):
    """``x`` entering a layer split as ``res`` (no collective forward; the
    backward sums the ranks' input gradients), unchanged when ``x`` needs
    no gradient or ``res`` is None."""
    if res is None or not x.requires_grad:
        return x
    from blendjax_torch.parallel.collectives import copy_to_axis

    return copy_to_axis(x, res.mesh, res.axis)


def column_bias(bias, res, split=None, dim: int = 0):
    """The bias of a layer column-split as ``res``: this rank's slice of
    a replicated ``bias`` (along ``dim``), or the bias itself when it is
    split as well (``split``, its own :class:`Resident`)."""
    if res is None or split is not None:
        return bias
    from blendjax_torch.parallel.collectives import scatter_to_axis

    return scatter_to_axis(bias, res.mesh, res.axis, dim=dim)


def gather_columns(x, res, dim: int = -1):
    """The full activation from every rank's columns (``dim``) of ``x``."""
    if res is None:
        return x
    from blendjax_torch.parallel.collectives import all_gather

    return all_gather(x, res.mesh, res.axis, dim=dim % x.ndim)


def row_sum(x, res):
    """The sum over ``res``'s axis of a row-split layer's partial output."""
    if res is None:
        return x
    from blendjax_torch.parallel.collectives import all_reduce_sum

    return all_reduce_sum(x, res.mesh, res.axis)


__all__ = ["column_bias", "enter", "gather_columns", "row_sum"]
