"""Runtime donation audit: prove the hot path's device buffers are
REUSED in place, never silently copied (the port of
``blendjax/testing/donation.py``).

The port keeps the JAX package's three in-place contracts without
donation arguments, by writing into tensors it allocated once:

- the echo reservoir's ring (``blendjax_torch.data.echo.SampleReservoir``)
  and the RL ring (``blendjax_torch.rl.replay.TrajectoryReservoir``) are
  allocated once, and every insert writes its rows into them in place;
- the fused draw reads the ring where it lies (no copy of the ring);
- the train step's optimizer updates the parameters and its moments in
  place, so the state is one copy for the whole run.

:class:`DonationAudit` takes labelled snapshots of the buffer identity of
every leaf of a tree (a state dict, a dict of ring tensors, a list of
parameters, a :class:`~blendjax_torch.parallel.ShardedParams`) and
asserts it did not change; the chip run publishes the verdict as the
``train.donation_reuse`` gauge (:meth:`DonationAudit.publish`).

A leaf's identity is the address of its storage
(``untyped_storage().data_ptr()``), host metadata only: reading it never
syncs the card. A leaf that exposes none reads ``None``, and a label whose
every leaf is ``None`` reads UNSTABLE, never reused.

An address alone does not prove identity: a caching allocator (a CUDA
graph's private pool above all) can hand a freed block's address to a new
tensor. The audit proves reuse only together with the caller's own check
that the audited objects are the same objects across the run (the rings'
and the state's tensors are never rebound): an unchanged address of the
same tensor object is the in-place write; a changed one is a copy.
"""

from __future__ import annotations


def _storage_pointer(t):
    try:
        return int(t.untyped_storage().data_ptr())
    except Exception:
        return None


def _leaf_pointer(leaf):
    """One leaf's buffer identity: the storage address of a tensor, a
    tuple of the shards' addresses for a sharded state (one per rank
    shard this process holds), ``None`` when neither is exposed."""
    shards = getattr(leaf, "shards", None)
    if isinstance(shards, (list, tuple)) and shards:
        ptrs = tuple(_storage_pointer(s) for s in shards)
        return None if None in ptrs else ptrs
    if hasattr(leaf, "untyped_storage"):
        return _storage_pointer(leaf)
    return None


def _flatten(tree, prefix: str = ""):
    """``(path, leaf)`` of nested dicts, lists and tuples; a module by its
    state dict (parameters, buffers), an optimizer by its per-parameter
    state (moments, step counts) and a sharded state as one leaf."""
    import torch

    if isinstance(tree, torch.nn.Module):
        tree = dict(tree.state_dict(keep_vars=True))
    elif isinstance(tree, torch.optim.Optimizer):
        tree = [dict(tree.state.get(p, {}))
                for group in tree.param_groups for p in group["params"]]
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _flatten(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def state_tree(state) -> dict:
    """The tensors a train state updates in place: its parameters (the
    rank's shards of a state split over a model axis, one leaf of their
    addresses in a fixed order, stable across a captured graph's replays
    as across eager steps), its optimizer's per-parameter state and, for
    an RL state, its target network (its shards, when split). The
    optimizer's moments appear at its first step: snapshot after it."""
    shards = getattr(state, "shards", None)
    tree = {"params": state.model if shards is None else shards,
            "optimizer": state.optimizer}
    target = getattr(state, "target", None)
    if target is not None:
        target_shards = getattr(state, "target_shards", None)
        tree["target"] = target if target_shards is None else target_shards
    return tree


def tree_pointers(tree) -> dict:
    """``{leaf path: buffer identity}`` for every leaf of ``tree``
    (:func:`_leaf_pointer`; ``None`` where none is exposed). Host
    metadata only: reading it never syncs the card."""
    return {path: _leaf_pointer(leaf) for path, leaf in _flatten(tree)}


def pointers_stable(before: dict, after: dict) -> bool:
    """True when every leaf whose pointer is known on BOTH sides kept it.
    Requires at least one leaf actually compared: a tree with no pointer
    at all is NOT evidence of reuse and reads unstable."""
    keys = set(before) & set(after)
    compared = [
        k for k in keys
        if before[k] is not None and after[k] is not None
    ]
    if not compared:
        return False  # nothing auditable is not evidence of reuse
    return all(before[k] == after[k] for k in compared)


class DonationAudit:
    """Labelled pointer snapshots across a run.

    >>> audit = DonationAudit()
    >>> audit.snapshot("ring", reservoir._buffers)
    >>> ...  # inserts, fused draws and steps
    >>> audit.snapshot("ring", reservoir._buffers)
    >>> audit.stable("ring")
    True

    ``report()`` summarizes every label (snapshot count, distinct pointer
    sets, stability verdict), with the JAX package's keys.
    ``assert_stable()`` raises with the offending leaves named."""

    def __init__(self) -> None:
        self._snaps: dict[str, list[dict]] = {}

    def snapshot(self, label: str, tree) -> dict:
        ptrs = tree_pointers(tree)
        self._snaps.setdefault(label, []).append(ptrs)
        return ptrs

    def stable(self, label: str) -> bool:
        snaps = self._snaps.get(label, [])
        if len(snaps) < 2:
            return False  # one snapshot proves nothing
        return all(
            pointers_stable(snaps[0], later) for later in snaps[1:]
        )

    def all_stable(self) -> bool:
        """Every label stable (and at least one label)."""
        return bool(self._snaps) and all(
            self.stable(label) for label in self._snaps)

    def assert_stable(self, label: str) -> None:
        snaps = self._snaps.get(label, [])
        if len(snaps) < 2:
            raise AssertionError(
                f"donation audit {label!r}: need >= 2 snapshots, "
                f"have {len(snaps)}"
            )
        first = snaps[0]
        for i, later in enumerate(snaps[1:], start=1):
            compared = [
                k for k in set(first) & set(later)
                if first[k] is not None and later[k] is not None
            ]
            if not compared:
                raise AssertionError(
                    f"donation audit {label!r}: no leaf exposed a "
                    f"buffer pointer between snapshot 0 and {i} — "
                    "reuse is unverifiable, which is not evidence of "
                    "reuse"
                )
            moved = sorted(
                k for k in compared if first[k] != later[k]
            )
            if moved:
                raise AssertionError(
                    f"donation audit {label!r}: buffers moved between "
                    f"snapshot 0 and {i} (copied, not reused): {moved}"
                )

    def report(self) -> dict:
        out: dict = {}
        for label, snaps in self._snaps.items():
            distinct = len({
                tuple(sorted(s.items())) for s in snaps
            })
            out[label] = {
                "snapshots": len(snaps),
                "distinct_pointer_sets": distinct,
                "stable": self.stable(label),
            }
        return out

    def publish(self, registry=None) -> float:
        """Set the ``train.donation_reuse`` gauge: 1.0 when every label is
        stable, else 0.0 (``registry`` defaults to the process-wide
        :data:`blendjax_torch.utils.metrics.metrics`). Returns the value."""
        if registry is None:
            from blendjax_torch.utils.metrics import metrics as registry
        value = 1.0 if self.all_stable() else 0.0
        registry.gauge("train.donation_reuse", value)
        return value


__all__ = ["DonationAudit", "pointers_stable", "state_tree", "tree_pointers"]
