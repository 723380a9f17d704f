"""MeshTrainDriver: the live pipeline as one data-parallel program on a
mesh of cards (port of ``blendjax/train/mesh_driver.py``).

One process per card (:mod:`blendjax_torch.parallel.mesh`): every rank
builds the same driver over its own ``StreamDataPipeline(mesh=...)``, which
keeps its rows of each global batch, and runs the same steps on them. The
JAX package's jit puts the collectives in the step; here the step issues
them itself (:func:`~blendjax_torch.train.steps.make_supervised_step` with
``state_sharding=``): one all-reduce of the gradients' mean over the batch
axes per update and one of the loss, no DDP reducer hooks, so a step
captures into one CUDA graph with its collectives (the data layout).

- :func:`make_mesh_supervised_step` / :func:`make_mesh_fused_step` /
  :func:`make_mesh_echo_fused_step` build the single-card step bodies with
  the state's shardings threaded through (one step body: one-card and mesh
  runs cannot train different math); the fused step decodes each rank's
  rows of the packed group on its card with K1 or K2.
- :class:`MeshTrainDriver` keeps the dispatch ring of
  :class:`~blendjax_torch.train.driver.TrainDriver`; its images count the
  global batch, so ``images/s`` and MFU read the whole mesh, and the MFU
  peak is ``peak_flops_per_chip`` times the cards of the mesh.

Layouts: ``data`` (replicated state), ``data×seq`` (a sequence-parallel
model: Ulysses' all-to-alls or the ring's permutes inside its
attention), ``data×fsdp``, ``data×tp`` and ``data×expert`` (the state
split over the model axis, :class:`~blendjax_torch.parallel.ShardedParams`)
all capture one graph per plan signature with ``build(aot=True)``, one
replay per step call, as on one card; every axis's communicator is made
before any capture (:func:`warm_up_groups` at build, then the capture's
own eager warm-up steps). The echo step over a sharded ring captures the
same way (:func:`make_mesh_echo_fused_step`). On ``tp`` and ``expert`` the work splits as
the JAX package's compiled step splits it
(``blendjax_torch/docs/mesh-split.md``): the ranks of a ``tp`` group train
on the same rows, each with its block of the split kernels (its heads of
attention, its slice of the MLP, the embedding and the head), and sum the
row-split outputs over ``tp``; the ranks of an ``expert`` group route the
same tokens and each runs its experts, the outputs summed over
``expert``. Those blocks stay on their rank (never gathered); their
gradients are averaged over the batch axes like every other. ``fsdp``
gathers its shards on use (an axis of size 1 too, over one rank): in a
graph the gathered parameters are tensors of the graph's own pool, which
each replay refills before the captured forward reads them.
"""

from __future__ import annotations

# bjx: driver-hot-path (BJX106, BJX108, BJX109, BJX112, BJX114, BJX116
# and BJX125 hold here exactly as in driver.py)
# bjx: mesh-hot-path (BJX111: no per-device placement loops, no host
# materialization of gathered tensors in the dispatch loop)

import time

from blendjax_torch.train.driver import TrainDriver


def _check_axis(mesh, data_axis: str) -> None:
    from blendjax_torch.parallel.mesh import axis_names, mesh_shape

    if data_axis not in axis_names(mesh):
        # a typo'd batch axis would otherwise train unsplit: every rank the
        # same rows, 1x throughput at N cards, no error
        raise ValueError(
            f"data_axis {data_axis!r} is not an axis of mesh "
            f"{mesh_shape(mesh)}")


def _state_shardings(state, mesh, data_axis: str = "data"):
    """The state's shardings; a mixture of experts in the model routes
    over the global batch those batch axes split (as under GSPMD)."""
    from blendjax_torch.models.moe import route_over_batch
    from blendjax_torch.parallel.sharding import state_shardings

    sharding = state_shardings(state, mesh=mesh, data_axis=data_axis)
    route_over_batch(state.model, mesh, sharding.batch_axes)
    return sharding


def make_mesh_supervised_step(state, mesh, loss_fn=None, augment=None,
                              augment_rng=None, precision=None,
                              accum_steps: int = 1, data_axis: str = "data"):
    """:func:`~blendjax_torch.train.make_supervised_step` with the state's
    shardings: the gradient and loss means over the batch axes happen in
    the step. Batches arrive with this rank's rows (the feeder's)."""
    from blendjax_torch.train.steps import make_supervised_step

    _check_axis(mesh, data_axis)
    return make_supervised_step(
        loss_fn=loss_fn, accum_steps=accum_steps, augment=augment,
        augment_rng=augment_rng, precision=precision,
        state_sharding=_state_shardings(state, mesh, data_axis))


def make_mesh_fused_step(state, mesh, loss_fn=None, augment=None,
                         augment_rng=None, precision=None,
                         data_axis: str = "data"):
    """:func:`~blendjax_torch.train.make_fused_tile_step` on a mesh: the
    packed group travels whole to every rank, and each decodes only its
    rows (``superbatch_constraint`` = the batch sharding over
    ``data_axis``, K1 or K2 on its card) before the updates, whose
    gradient means run in the step."""
    from blendjax_torch.parallel.sharding import batch_sharding
    from blendjax_torch.train.steps import make_fused_tile_step

    _check_axis(mesh, data_axis)
    return make_fused_tile_step(
        loss_fn=loss_fn, augment=augment, augment_rng=augment_rng,
        precision=precision,
        state_sharding=_state_shardings(state, mesh, data_axis),
        superbatch_constraint=batch_sharding(mesh, axis=data_axis))


def make_mesh_echo_fused_step(state, mesh, reservoir, loss_fn=None,
                              precision=None, data_axis: str = "data"):
    """:func:`~blendjax_torch.train.make_echo_fused_step` on a mesh:
    ``reservoir`` (the ``EchoingPipeline(mesh=..., emit_draws=True)``'s)
    must be sharded over the batch axes; each rank draws its rows of every
    global draw. The draw's gather runs on the card from the token's
    indices as a device tensor, so a
    :class:`~blendjax_torch.train.CapturedStep` of this step holds the
    gather with its all-reduce, the augmentation, the update and the loss
    mean in one graph."""
    from blendjax_torch.train.steps import make_echo_fused_step

    _check_axis(mesh, data_axis)
    ring = getattr(reservoir, "sharding", None)
    if ring is None:
        raise ValueError(
            "the reservoir ring is not mesh-sharded: construct the "
            "EchoingPipeline (or SampleReservoir) with mesh=/sharding= so "
            "echo capacity shards over the data axis")
    return make_echo_fused_step(
        reservoir.draw, loss_fn=loss_fn, precision=precision,
        state_sharding=_state_shardings(state, mesh, data_axis),
        buffer_sharding=ring)


def warm_up_groups(mesh, axes) -> None:
    """One all-reduce on the group of each of ``axes`` (and of the folded
    batch axes): a communicator is made at its first use, which must not
    happen inside a graph capture. An NCCL group's all-to-all uses the
    communicator this makes."""
    import torch

    from blendjax_torch.parallel.collectives import _all_reduce, recording
    from blendjax_torch.parallel.mesh import axes_group, axis_names

    dev = "cuda" if mesh.device_type == "cuda" else "cpu"
    with recording():
        for ax in axes:
            if all(a in axis_names(mesh) for a in ((ax,) if isinstance(
                    ax, str) else ax)):
                axes_group(mesh, ax)
                _all_reduce(torch.zeros(1, device=dev), mesh, ax)


class MeshTrainDriver(TrainDriver):
    """:class:`~blendjax_torch.train.driver.TrainDriver` on a mesh. Every
    rank runs one, in step with the others (each ``submit`` issues the same
    collectives on every rank).

    - ``images_retired`` and the image rate count the global batch (this
      rank's rows times the batch axes' size);
    - the MFU peak is ``peak_flops_per_chip`` (or a pre-scaled
      ``peak_flops``) times :attr:`chips`, the cards of the mesh;
    - :attr:`stats` adds ``chips``, ``processes``, ``layout`` and
      ``data_axis_size``;
    - :meth:`fleet_snapshots` / :meth:`fleet_report` gather every rank's
      observability snapshot (:mod:`blendjax_torch.obs.fleetview`);
    - with ``checkpoint=`` on a mesh of several ranks, a snapshot is one
      step of every rank: a request that one rank raises (a thread's
      :meth:`request_checkpoint`, a SIGTERM through its
      :class:`~blendjax_torch.checkpoint.PreemptionGuard`) is agreed
      through ``requests`` (a
      :class:`~blendjax_torch.parallel.mesh.StepAgreement`; one of its own
      unless given, which a pipeline's per-batch agreement can carry) and
      honoured by every rank at the same step; each snapshot gathers every
      rank's session (:func:`~blendjax_torch.checkpoint.gather_session`) and
      rank 0 alone writes the state and the gathered session.

    ``mesh=None`` is one card without a process group: the base driver's
    work with no collective (one chip, layout ``"single"``).
    """

    def __init__(self, step, state, mesh, *, data_axis: str = "data",
                 inflight: int = 4, sync_every: int = 32,
                 pad_partial: bool = True, buckets=None,
                 flops_per_image: float | None = None,
                 peak_flops_per_chip: float | None = None,
                 peak_flops: float | None = None, checkpoint=None,
                 checkpoint_every: int = 0, session_state=None, place=None,
                 layout: str | None = None, requests=None):
        from blendjax_torch.parallel.sharding import (
            batch_sharding,
            leading_shard_count,
            mesh_chip_count,
        )

        self.mesh = mesh
        self.data_axis = data_axis
        if mesh is None:
            self.chips = self.batch_ways = 1
            self.layout = layout or "single"
        else:
            _check_axis(mesh, data_axis)
            self.chips = mesh_chip_count(mesh)
            self.batch_ways = leading_shard_count(
                batch_sharding(mesh, axis=data_axis))
            self.layout = layout or "×".join(mesh.mesh_dim_names)
        # the first step call's collectives, and the images it trained on
        self.collective_tally = None
        self.collective_images = 0
        if peak_flops is None and peak_flops_per_chip:
            peak_flops = float(peak_flops_per_chip) * self.chips
        super().__init__(
            step, state, inflight=inflight, sync_every=sync_every,
            pad_partial=pad_partial, buckets=buckets,
            flops_per_image=flops_per_image, peak_flops=peak_flops,
            checkpoint=checkpoint, checkpoint_every=checkpoint_every,
            session_state=session_state, place=place)
        if peak_flops is None and self.peak_flops:
            # the one-card default from the card's name, times the cards
            self.peak_flops *= self.chips
        if (requests is None and checkpoint is not None and mesh is not None
                and int(mesh.mesh.numel()) > 1):
            from blendjax_torch.parallel.mesh import StepAgreement

            requests = StepAgreement(mesh)
        self.requests = requests

    # -- snapshots agreed across the ranks --------------------------------------

    def request_checkpoint(self) -> None:
        """Thread-safe: snapshot at a step boundary, the same one on every
        rank of the mesh."""
        if self.requests is None:
            return super().request_checkpoint()
        self.requests.request("checkpoint")

    def _preempt_due(self) -> bool:
        if self.requests is None:
            return super()._preempt_due()
        if self.preempt is not None and self.preempt.requested:
            self.requests.request("preempt")
        self.requests.boundary()
        return self.requests.take("preempt")

    def _checkpoint_requested(self) -> bool:
        if self.requests is None:
            return super()._checkpoint_requested()
        return self.requests.take("checkpoint")

    def _dispatch_checkpoint(self) -> None:
        """Every rank's session gathered at this step; rank 0 writes."""
        if self.requests is None:
            return super()._dispatch_checkpoint()
        from blendjax_torch.checkpoint import gather_session
        from blendjax_torch.weights import train_state_leaves

        session = {}
        if callable(self.session_state):
            session = dict(self.session_state() or {})
        session.setdefault("driver", self.state_dict())
        # every rank takes the leaves: a split state gathers them
        leaves = train_state_leaves(self.state)
        merged = gather_session(session, self.requests)
        if merged is not None:
            self.checkpoint.save_async(self.steps, leaves, session=merged)
        self.checkpoints += 1

    def _batch_images(self, batch) -> int:
        from blendjax_torch.train.steps import batch_images

        return batch_images(batch) * self.batch_ways

    def submit(self, batch, post: bool = True) -> None:
        """As :meth:`TrainDriver.submit`; the first call's collectives (an
        eager step's, or the graph capture's) go to the device ledger."""
        if self.mesh is None or self.collective_tally is not None:
            return super().submit(batch, post=post)
        from blendjax_torch.obs.devledger import ledger
        from blendjax_torch.parallel.collectives import (
            add_counts,
            collective_counts,
            recording,
            tally_diff,
        )

        before = collective_counts()
        with recording() as eager:
            super().submit(batch, post=post)
        add_counts(eager)
        # an eager step's collectives, or those a replayed graph added
        self.collective_tally = tally_diff(collective_counts(), before)
        self.collective_images = self._batch_images(batch)
        ledger.register_collectives(
            f"{self.layout}.step", self.collective_tally, mesh=self.mesh,
            batch_images=self.collective_images)

    @classmethod
    def build(cls, model, mesh=None, example_batch=None, loss_fn=None,
              fused: bool = False, optimizer=None,
              learning_rate: float = 1e-3, rng=None, augment=None,
              augment_rng=None, precision=None, aot: bool = False,
              aot_cache_dir: str | None = None, aot_batch=None,
              layout=None, rules=None, device=None, **driver_kwargs):
        """Model -> mesh driver: ``model.init_params(rng)`` (one seed on
        every rank), the train state on ``device`` (``cuda`` unless
        ``"cpu"``) sharded by the layout's partition rules
        (:func:`~blendjax_torch.parallel.resolve_rules`: explicit
        ``rules``, the layout's, the model's ``partition_rules()``), the
        mesh step (``fused=True`` for packed tile streams) and the driver.

        ``layout`` (a :class:`~blendjax_torch.parallel.Layout`, a name such
        as ``"data2xfsdp2"`` or an axis dict) names the mesh and the rules
        in one spelling; with ``mesh=None`` the mesh is created from it.
        ``example_batch`` (one batch's images, or a batch dict) is for the
        caller's shapes; ``aot_batch`` (a full batch dict, this rank's
        rows) is validated against the batch layout.

        ``aot=True`` captures the step, on every layout: the fused step
        per packed plan signature at first sight
        (:class:`~blendjax_torch.train.CapturedStep`), the supervised step
        for every bucket-ladder shape of ``aot_batch``
        (:func:`~blendjax_torch.train.build_aot_step`, its manifest keyed
        on the model, the mesh, the layout and its rules). On a state
        split over a model axis (fsdp, tp, expert) the graph holds the
        whole split step: the fsdp gathers, the split kernels' sums, the
        gradient mean and the shards' update; on a ``seq`` axis it holds
        the sequence split and gather and Ulysses' all-to-alls or the
        ring's permutes. A capture or replay that fails raises; the fused
        step on a gloo group runs eagerly (``eager_calls``).
        """
        from blendjax_torch.parallel.sharding import (
            resolve_layout,
            resolve_rules,
            state_shardings,
            validate_batch_sharding,
        )
        from blendjax_torch.train.steps import make_train_state

        t0 = time.monotonic()
        data_axis = driver_kwargs.get("data_axis", "data")
        if mesh is None:
            if layout is None:
                raise ValueError(
                    "MeshTrainDriver.build needs a mesh or a layout: pass "
                    "mesh=create_mesh(...) or layout='data×fsdp'")
            mesh = resolve_layout(layout).create_mesh(
                devices="cpu" if str(device) == "cpu" else None)
        _check_axis(mesh, data_axis)
        rules = resolve_rules(rules=rules, layout=layout, model=model)
        for k, v in (aot_batch or {}).items():
            sh = getattr(v, "sharding", None)
            if sh is not None:
                validate_batch_sharding(sh, data_axis=data_axis,
                                        what=f"aot_batch[{k!r}]")
        if rng is not None:
            model.init_params(int(rng))
        state = make_train_state(model, optimizer=optimizer,
                                 learning_rate=learning_rate, device=device,
                                 mesh=mesh, rules=rules)
        axes = [ax for ax in (data_axis, "fsdp", "tp", "tensor", "seq",
                              "expert")
                if ax in (getattr(mesh, "mesh_dim_names", None) or ())]
        sharding = state_shardings(state, mesh=mesh, data_axis=data_axis)
        if sharding.batch_axes:
            axes.append(sharding.batch_axes)
        warm_up_groups(mesh, axes)
        if fused:
            step = make_mesh_fused_step(
                state, mesh, loss_fn=loss_fn, augment=augment,
                augment_rng=augment_rng, precision=precision,
                data_axis=data_axis)
            if aot:
                from blendjax_torch.train.aot import CapturedStep

                step = CapturedStep(step, mesh=mesh)
        else:
            step = make_mesh_supervised_step(
                state, mesh, loss_fn=loss_fn, augment=augment,
                augment_rng=augment_rng, precision=precision,
                data_axis=data_axis)
            if aot:
                if not isinstance(aot_batch, dict):
                    raise TypeError(
                        "aot=True for the supervised step needs aot_batch, "
                        "a full batch dict of this rank's rows")
                from blendjax_torch.train.aot import build_aot_step, cache_key

                buckets = driver_kwargs.get("buckets")
                step = build_aot_step(
                    step, state, aot_batch, buckets=buckets,
                    cache_dir=aot_cache_dir,
                    key=cache_key(model=model, precision=precision,
                                  mesh=mesh, buckets=buckets, layout=layout,
                                  rules=rules) if aot_cache_dir else None,
                    ledger_name=f"{type(model).__name__}.mesh_supervised_step")
        drv = cls(step, state, mesh, layout=(
            resolve_layout(layout).name if layout is not None else None),
            **driver_kwargs)
        drv._t_created = t0
        drv.startup_ms = (time.monotonic() - t0) * 1e3
        return drv

    def batch_sharding(self):
        """The layout live batches arrive in (what
        ``StreamDataPipeline(mesh=...)`` keeps per rank)."""
        from blendjax_torch.parallel.sharding import batch_sharding

        return batch_sharding(self.mesh, axis=self.data_axis)

    # -- fleet observability ----------------------------------------------------

    def fleet_snapshots(self, prefetch: int | None = None) -> list:
        """Every rank's observability snapshot, rank-tagged (a collective:
        every rank calls it)."""
        from blendjax_torch.obs.fleetview import gather_fleet_snapshots

        return gather_fleet_snapshots(driver=self.stats, prefetch=prefetch)

    def fleet_report(self, prefetch: int | None = None) -> dict:
        from blendjax_torch.obs.fleetview import fleet_report

        return fleet_report(self.fleet_snapshots(prefetch=prefetch))

    @property
    def stats(self) -> dict:
        import torch.distributed as dist

        s = TrainDriver.stats.fget(self)
        s["chips"] = self.chips
        s["data_axis_size"] = self.batch_ways
        s["layout"] = self.layout
        s["processes"] = (dist.get_world_size() if dist.is_initialized()
                          else 1)
        return s


__all__ = [
    "MeshTrainDriver",
    "make_mesh_echo_fused_step",
    "make_mesh_fused_step",
    "make_mesh_supervised_step",
    "warm_up_groups",
]
