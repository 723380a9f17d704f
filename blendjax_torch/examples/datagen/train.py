"""Supervised training on a live cube stream: the port of the JAX package's
``examples/datagen/train.py``.

Launches N cube producers (swap in ``BlenderLauncher`` and a ``.blend.py``
scene for real Blender), streams image + corner batches onto the card and
trains :class:`~blendjax_torch.models.CubeRegressor`. On the card every
step call is one CUDA graph replay (:class:`~blendjax_torch.train.CapturedStep`,
captured the first time each batch signature is seen), the port's
counterpart of the reference's jitted step, on a mesh too (the step's
collectives inside the graph); ``--device cpu`` runs the same steps
eagerly with the kernels' plain versions.

One process per card: with no process group the example trains on one card.
Under ``torchrun`` with a world size above 1 it opens the group from the
environment (NCCL on the card, gloo with ``--device cpu``), builds the mesh
``{"data": -1}`` over its ranks and trains with the mesh steps, each rank
taking its rows of every global batch from producers of its own. Every flag
runs there, under the rules across ranks of
``blendjax_torch/docs/mesh-examples.md``: rank 0 writes one snapshot with
every rank's session, and any rank's request snapshots every rank at the
same step; each rank records its own stream; the curriculum sums its
evidence over the ranks; the fleet controllers take one decision per tick.

Run: ``python -m blendjax_torch.examples.datagen.train --steps 50`` (add
``--record PREFIX`` / ``--replay PREFIX`` for the record and replay flows).
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--instances", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--shape", nargs=2, type=int, default=[128, 128])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument(
        "--device", default="cuda",
        help="'cuda' (the default; raises without a card) or 'cpu' (the "
        "kernels' plain versions, eager steps)",
    )
    ap.add_argument("--record", default=None, help="record stream to PREFIX")
    ap.add_argument("--replay", default=None,
                    help="replay from PREFIX (no producers)")
    ap.add_argument(
        "--allow-pickle", action="store_true",
        help="trust pickle-bearing recordings (legacy .btr) on --replay "
        "(the port refuses pickles unless asked)",
    )
    ap.add_argument(
        "--encoding", choices=["raw", "tile", "pal"], default="raw",
        help="'tile' streams only changed tiles (decoded on the card); "
        "'pal' palette-compresses whole frames (the lossless non-sparse "
        "codec, no reference frame)",
    )
    ap.add_argument(
        "--chunk", type=int, default=1,
        help="coalesce K tile/pal batches into one transfer + one "
        "step call of K updates (needs --encoding tile or pal)",
    )
    ap.add_argument(
        "--inflight", type=int, default=0,
        help="async overlap driver: fuse the decode into the captured "
        "train step (one graph replay per step) and keep up to N step "
        "calls in flight via blendjax_torch.train.TrainDriver (needs "
        "--encoding tile or pal). 0 = classic decode-then-step loop",
    )
    ap.add_argument(
        "--sync-every", type=int, default=16,
        help="driver loss-fetch cadence (steps) when --inflight > 0",
    )
    ap.add_argument(
        "--echo", type=int, default=0, metavar="FACTOR",
        help="data echoing for producer-bound runs: hold decoded samples "
        "in a reservoir on the card and draw train batches at the STEP "
        "rate, re-augmented per draw, each sample reused at most FACTOR "
        "times (0 = off). Incompatible with --chunk > 1 (the reservoir "
        "echoes per-batch decoded samples); photometric re-augmentation "
        "only, since this task's labels are pixel coordinates",
    )
    ap.add_argument(
        "--echo-capacity", type=int, default=256,
        help="reservoir size in samples when --echo > 0",
    )
    ap.add_argument(
        "--echo-warm-start", default=None, metavar="PATH",
        help="pre-fill the reservoir from a .bjr recording before live "
        "frames arrive (step 0 never blocks on the first render)",
    )
    ap.add_argument(
        "--metrics-port", type=int, default=None,
        help="serve Prometheus text at http://127.0.0.1:PORT/metrics "
        "while training (0 picks a free port; blendjax_torch.obs."
        "exporters) and log a stall-doctor verdict every 10s "
        "(StatsReporter)",
    )
    ap.add_argument(
        "--trace-export", default=None, metavar="PATH",
        help="record pipeline span events and write a Chrome/Perfetto "
        "trace JSON to PATH at exit; completed distributed frame traces "
        "are merged in as producer/consumer lanes with flow arrows",
    )
    ap.add_argument(
        "--trace-every", type=int, default=64, metavar="N",
        help="producers stamp every Nth message with a sampled "
        "distributed-trace context; each pipeline stage appends its "
        "timestamp and the driver completes the record at step "
        "retirement. 0 disables stamping",
    )
    ap.add_argument(
        "--slo", action="append", default=None, metavar="RULE",
        help="declarative SLO rule, repeatable, e.g. "
        "'rate(ingest.items) >= 50', 'p95(wire.e2e_staleness_s) <= 0.5 "
        "@ 30', 'rate(wire.seq_gaps) == 0', 'doctor != wire-bound'; "
        "evaluated every reporter tick (10s); breaches log, flip "
        "/healthz to 503 (with --metrics-port), and trigger the flight "
        "recorder (with --flight-dir)",
    )
    ap.add_argument(
        "--flight-dir", default=None, metavar="DIR",
        help="on a sustained SLO breach, dump a bounded diagnostic "
        "bundle here: recent metrics snapshots + doctor verdicts, the "
        "lineage report, span events + frame traces as one Chrome "
        "trace, and the breaching rule states (needs --slo)",
    )
    ap.add_argument(
        "--checkpoint", default=None, metavar="DIR",
        help="async snapshots (blendjax_torch.checkpoint, the JAX "
        "package's format): every --checkpoint-every steps the train "
        "state + session (driver counters, lineage positions, "
        "echo/scenario state when active) go to a background writer; a "
        "kill -9 resumes from the last committed step. SIGTERM drains "
        "the ring and snapshots before exit; with --slo, a breach also "
        "requests a snapshot at the next step",
    )
    ap.add_argument(
        "--checkpoint-every", type=int, default=50, metavar="STEPS",
        help="snapshot cadence in train steps (0 = only the exit/"
        "preemption snapshot)",
    )
    ap.add_argument(
        "--resume", action="store_true",
        help="restore the latest committed snapshot from --checkpoint "
        "before training (a snapshot of either package)",
    )
    ap.add_argument(
        "--fleet", default=None, metavar="MIN:MAX",
        help="elastic producer autoscaling (blendjax_torch.fleet): start "
        "MIN producers and let a FleetController grow/shrink the fleet "
        "between MIN and MAX on live stall-doctor verdicts: up on "
        "producer-bound/echo-saturated, down on step-bound/idle, crashed "
        "instances respawned in place; with --slo, a breaching watchdog "
        "blocks scale-down. The scale-event log prints beside the doctor "
        "verdict at exit",
    )
    ap.add_argument(
        "--synthetic-producers", type=int, default=0, metavar="N",
        help="replace the cube producers with N Blender-free synthetic "
        "producers (blendjax_torch.fleet.synthetic: the host C++ "
        "rasterizer, raw frames only), the high-rate tier that reaches "
        "step-bound and scale-down regimes Blender cannot. Composes with "
        "--fleet (MIN wins as the start count)",
    )
    ap.add_argument(
        "--scenarios", default=None, metavar="SPEC",
        help="closed-loop domain randomization (blendjax_torch.scenario): "
        "publish a scenario space over a per-producer duplex channel and "
        "account every train row to the scenario that rendered it. SPEC "
        "uses the space grammar, e.g. 'easy:half_extent=u(0.8,1.2) / "
        "hard:half_extent=u(0.8,1.2),xy_jitter=g(6,0.5)'. Needs "
        "--synthetic-producers (the synthetic tier consumes the duplex "
        "channel; Blender scenes wire their own ScenarioApplicator)",
    )
    ap.add_argument(
        "--curriculum", action="store_true",
        help="adapt the scenario space from per-scenario training "
        "loss: mixture weights move toward high-loss scenarios "
        "(bandit) and gaussian params update by REINFORCE, "
        "re-published on a cadence (needs --scenarios; incompatible "
        "with --inflight: the curriculum reads the loss every step)",
    )
    ap.add_argument(
        "--curriculum-every", type=int, default=50, metavar="STEPS",
        help="curriculum update cadence in train steps",
    )
    ap.add_argument(
        "--augment", action="store_true",
        help="color jitter on the card inside the step "
        "(blendjax_torch.ops.augment; per-step seeds). Only photometric "
        "ops: this task supervises pixel-space corner coordinates, which "
        "geometric ops (flip/crop) would invalidate without a matching "
        "label transform.",
    )
    return ap


def data_mesh(device):
    """The mesh ``{"data": -1}`` of a run under ``torchrun`` with more than
    one rank (the group opened from the environment) or in a group the
    caller opened, else None; and whether this call opened the group (its
    caller then destroys it)."""
    import torch.distributed as dist

    from blendjax_torch.parallel import create_mesh
    from blendjax_torch.parallel.mesh import init_group

    opened = init_group(device)
    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return None, opened
    return create_mesh({"data": -1},
                       devices="cpu" if device.type == "cpu" else None), opened


def main(argv=None) -> dict:
    ap = build_parser()
    args = ap.parse_args(argv)

    fleet_bounds = None
    if args.fleet:
        try:
            lo, hi = (int(v) for v in args.fleet.split(":"))
        except ValueError:
            ap.error("--fleet expects MIN:MAX, e.g. --fleet 1:4")
        if not 1 <= lo <= hi:
            ap.error("--fleet needs 1 <= MIN <= MAX")
        if args.replay:
            ap.error("--fleet scales live producers; drop --replay")
        fleet_bounds = (lo, hi)
    if args.synthetic_producers and args.encoding != "raw":
        ap.error(
            "--synthetic-producers publishes raw frames: use "
            "--encoding raw"
        )
    if args.scenarios and not args.synthetic_producers:
        ap.error(
            "--scenarios needs --synthetic-producers (the synthetic "
            "tier consumes the scenario duplex channel; Blender scenes "
            "wire a ScenarioApplicator in their producer script)"
        )
    if args.scenarios and args.replay:
        ap.error("--scenarios publishes to live producers; drop --replay")
    if args.curriculum and not args.scenarios:
        ap.error("--curriculum needs a --scenarios space to adapt")
    if args.curriculum and args.inflight > 0:
        ap.error(
            "--curriculum reads the loss every step: drop --inflight"
        )
    if args.resume and not args.checkpoint:
        ap.error("--resume needs a --checkpoint directory")
    if args.flight_dir and not args.slo:
        ap.error("--flight-dir needs at least one --slo rule to breach")

    from blendjax_torch.device import device_flag

    device = device_flag(args.device)
    mesh, opened = data_mesh(device)
    try:
        return _train(ap, args, fleet_bounds, device, mesh)
    finally:
        if opened:
            import torch.distributed as dist

            dist.destroy_process_group()


def _train(ap, args, fleet_bounds, device, mesh) -> dict:
    """The body of :func:`main` on ``device`` (and ``mesh``, under
    ``torchrun``), once its flags are checked."""
    import torch

    from blendjax_torch.data import StreamDataPipeline
    from blendjax_torch.launcher import PythonProducerLauncher
    from blendjax_torch.models import CubeRegressor
    from blendjax_torch.train import (
        CapturedStep,
        make_chunked_supervised_step,
        make_supervised_step,
        make_train_state,
    )
    from blendjax_torch.train.steps import batch_images

    # On a mesh: the agreement at step boundaries (snapshot requests, the
    # gathered sessions and scenario ledgers), this rank, and the rows of
    # each global batch that this rank's producers send.
    agree = None
    rank, world = 0, 1
    if mesh is not None:
        from blendjax_torch.parallel.mesh import StepAgreement

        agree = StepAgreement(mesh)
        rank, world = agree.rank, len(agree.ranks)
        if args.batch % world:
            ap.error(f"--batch {args.batch} does not split over the "
                     f"{world} ranks of the mesh")
    rank_batch = args.batch // world

    # Observability: a live Prometheus scrape target + periodic doctor
    # verdicts, SLO watchdog + flight recorder, and/or a Chrome trace of
    # the pipeline spans, torn down in the finally below.
    exporter = reporter = None
    # Checkpoint plumbing shared across modes: ckpt_refs carries the live
    # driver (for the breach arm) or the direct loop's breach flag;
    # ckpt_session is the restored session, applied per component as
    # each one is constructed.
    ckpt_refs: dict = {}
    scenario_ctx: dict = {}
    result: dict = {"losses": [], "device": str(device), "rank": rank,
                    "world": world}

    def _ckpt_on_breach():
        # the reporter's thread: it only raises a request (on a mesh the
        # ranks agree on it at a step boundary)
        drv = ckpt_refs.get("driver")
        if drv is not None:
            drv.request_checkpoint()
        elif agree is not None:
            agree.request("checkpoint")
        else:
            ckpt_refs["breach"] = True
        return {"mode": "driver" if drv is not None else "direct"}

    if args.metrics_port is not None or args.slo:
        from blendjax_torch.obs import StatsReporter, start_http_exporter

        reporter = StatsReporter(
            interval_s=10.0, slos=args.slo, flight_dir=args.flight_dir,
            checkpoint_on_breach=(
                _ckpt_on_breach if args.checkpoint else None
            ),
        ).start()
        if args.metrics_port is not None:
            # /healthz serves 200/503 from the reporter's SLO state
            exporter = start_http_exporter(
                port=args.metrics_port, health=reporter.health
            )
            print(
                f"metrics: http://127.0.0.1:{exporter.port}/metrics  "
                f"health: http://127.0.0.1:{exporter.port}/healthz"
            )
    if args.trace_export:
        from blendjax_torch.utils.metrics import metrics as _metrics

        _metrics.enable_span_events()

    h, w = args.shape
    model = CubeRegressor().init_params(0)
    state = make_train_state(model, device=device, mesh=mesh)
    ckpt_mgr = None
    ckpt_session: dict = {}
    if args.checkpoint:
        from blendjax_torch.checkpoint import (
            SnapshotManager,
            rank_session,
            restore_session,
        )
        from blendjax_torch.weights import (
            load_train_state_leaves,
            train_state_leaves,
        )

        # on a mesh rank 0 alone writes (the others restore)
        ckpt_mgr = SnapshotManager(args.checkpoint, read_only=rank != 0)
        if args.resume:
            restored = ckpt_mgr.restore(train_state_leaves(state))
            if restored is None:
                print(f"no snapshot in {args.checkpoint}: starting fresh")
            else:
                load_train_state_leaves(state, restored.state)
                ckpt_session, saved_world = rank_session(restored.session,
                                                         rank)
                from blendjax_torch.obs.lineage import lineage

                restore_session(ckpt_session, lineage=lineage)
                print(f"resumed from snapshot step {restored.step}"
                      + (f" (saved by {saved_world} ranks)"
                         if saved_world > 1 or mesh is not None else ""))
                if rank >= saved_world:
                    print(f"rank {rank}: the snapshot holds no session of "
                          "this rank; its lineage, echo, scenario and fleet "
                          "state start fresh")

    def _session_state() -> dict:
        from blendjax_torch.checkpoint import collect_session
        from blendjax_torch.obs.lineage import lineage

        comps = {"lineage": lineage}
        if "accounting" in scenario_ctx:
            comps["scenario"] = scenario_ctx["accounting"]
        if "curriculum" in scenario_ctx:
            comps["curriculum"] = scenario_ctx["curriculum"]
        if ckpt_refs.get("echo") is not None:
            comps["echo"] = ckpt_refs["echo"]
        if ckpt_refs.get("fleet") is not None:
            comps["fleet"] = ckpt_refs["fleet"]
        return collect_session(**comps)

    def _direct_session(steps_done: int) -> dict:
        # the direct loop has no TrainDriver to stamp its counters: record
        # the step position itself, so a resumed run continues the same
        # numbering (snapshot names, cadence) the driver mode gets
        session = _session_state()
        session["driver"] = {"steps": int(steps_done)}
        return session

    def _save(steps_done: int, session: dict) -> None:
        from blendjax_torch.weights import train_state_leaves

        leaves = train_state_leaves(state)
        if agree is not None:  # every rank's session; rank 0 writes
            from blendjax_torch.checkpoint import gather_session

            session = gather_session(session, agree)
            if session is None:
                return
        ckpt_mgr.save_async(steps_done, leaves, session)

    augment = None
    if args.augment:
        # Label-safe augmentation only: the corner labels live in pixel
        # space, so flips/crops would need the xy labels co-transformed.
        from blendjax_torch.ops.augment import color_jitter, make_augment

        augment = make_augment(color_jitter)
    chunk = args.chunk if args.encoding in ("tile", "pal") else 1
    echo_mode = args.echo > 0
    if echo_mode and chunk > 1:
        ap.error("--echo needs a per-batch decoded pipeline: drop --chunk")
    use_fused = (
        args.inflight > 0 and args.encoding in ("tile", "pal")
        and not echo_mode
    )
    driver = None
    drv_kwargs = dict(inflight=args.inflight, sync_every=args.sync_every,
                      checkpoint=ckpt_mgr,
                      checkpoint_every=args.checkpoint_every,
                      session_state=_session_state)

    def make_driver(step):
        if mesh is None:
            from blendjax_torch.train import TrainDriver

            return TrainDriver(step, state, **drv_kwargs)
        from blendjax_torch.train import MeshTrainDriver

        return MeshTrainDriver(step, state, mesh, requests=agree,
                               **drv_kwargs)

    if mesh is not None:
        from blendjax_torch.train import (
            make_mesh_fused_step,
            make_mesh_supervised_step,
        )
    if echo_mode:
        # Data echoing: the reservoir feeds a supervised step on the drawn
        # batches (the per-draw re-augmentation lives in the reservoir's
        # gather, so --augment's in-step jitter is not also applied);
        # --inflight > 0 additionally keeps step calls in flight.
        step = (make_supervised_step() if mesh is None
                else make_mesh_supervised_step(state, mesh))
        if args.inflight > 0:
            driver = make_driver(CapturedStep(step, mesh=mesh))
    elif use_fused:
        # Fused decode + async overlap: exactly one graph replay per step,
        # up to --inflight of them outstanding, loss fetched every
        # --sync-every steps.
        from blendjax_torch.train import make_fused_tile_step

        step = (make_fused_tile_step(augment=augment) if mesh is None
                else make_mesh_fused_step(state, mesh, augment=augment))
        driver = make_driver(CapturedStep(step, mesh=mesh))
    elif chunk > 1:
        # K sequential updates per step call; augmentation seeds fold the
        # step counter, so this trains identically to chunk=1 with
        # --augment. On a mesh the fused step trains the decoded
        # superbatch (its non-packed branch).
        step = (make_chunked_supervised_step(augment=augment) if mesh is None
                else make_mesh_fused_step(state, mesh, augment=augment))
    else:
        step = (make_supervised_step(augment=augment) if mesh is None
                else make_mesh_supervised_step(state, mesh, augment=augment))
    if driver is None:
        # the direct loop: one CUDA graph per batch signature on the card,
        # on a mesh too, its collectives inside (eager on the CPU and over
        # gloo); a mesh's communicators exist before the first capture
        if mesh is not None:
            from blendjax_torch.parallel.mesh import mesh_shape
            from blendjax_torch.train.mesh_driver import warm_up_groups

            warm_up_groups(mesh, list(mesh_shape(mesh)))
        step = CapturedStep(step, mesh=mesh)
    result["step"] = driver.step if driver is not None else step
    result["driver"] = driver

    if driver is not None:
        ckpt_refs["driver"] = driver
        if ckpt_session.get("driver"):
            driver.load_state_dict(ckpt_session["driver"])
    guard = None
    if ckpt_mgr is not None:
        from blendjax_torch.checkpoint import PreemptionGuard

        # SIGTERM -> drain + snapshot + clean exit; with no driver the
        # direct loop polls the flag itself
        guard = PreemptionGuard(driver) if driver is not None else (
            PreemptionGuard()
        )

    def wrap_echo(pipe):
        if not echo_mode:
            return pipe
        from blendjax_torch.data import EchoingPipeline

        echo = EchoingPipeline(
            pipe, capacity=args.echo_capacity,
            max_echo_factor=args.echo,
            warm_start=args.echo_warm_start,
            warm_start_allow_pickle=args.allow_pickle,
            mesh=mesh, device=device, requests=agree,
        )
        ckpt_refs["echo"] = echo
        if ckpt_session.get("echo"):
            echo.load_state_dict(ckpt_session["echo"])
            print("resumed echo reservoir "
                  f"(fill={echo.stats['reservoir_fill']})")
        return echo

    def run_steps(batches):
        nonlocal state
        from blendjax_torch.checkpoint import PreemptionRequested

        t0, n = time.perf_counter(), 0
        preempted = False
        start_step = (ckpt_session.get("driver") or {}).get("steps", 0)
        try:
            n = _run_steps_inner(batches, start_step)
        except PreemptionRequested as e:
            preempted = True
            print(f"preempted cleanly: {e}")
        if driver is not None and not preempted:
            state, final = driver.finish()
            if final is not None:  # None = zero batches submitted
                result["last_loss"] = final
                print(f"final loss={final:.5f}  driver={driver.stats}")
        if ckpt_mgr is not None and not preempted:
            # exit snapshot: the run's last word (close() in the outer
            # finally flushes it)
            if driver is not None:
                steps_done = driver.steps
                session = _session_state()
                session["driver"] = driver.state_dict()
            else:
                steps_done = start_step + ckpt_refs.get("steps", 0)
                session = _direct_session(steps_done)
            _save(steps_done, session)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        result.update(images=n, seconds=dt, img_s=n / dt if dt else 0.0,
                      preempted=preempted)
        if driver is not None:
            result["losses"] = list(driver.losses)
        print(f"{n / dt:.1f} images/sec ({n} images in {dt:.1f}s)")

    def _run_steps_inner(batches, start_step):
        nonlocal state
        from blendjax_torch.checkpoint import PreemptionRequested

        n = 0
        for i, batch in enumerate(batches):
            if i >= args.steps:
                break
            if driver is not None:
                if scenario_ctx:
                    # rows only (no per-step loss fetch in driver mode),
                    # accounted BEFORE submit: the driver strips the host
                    # scenario sidecar off the batch it hands to the step
                    scenario_ctx["accounting"].account_batch(batch)
                driver.submit(batch)
            else:
                if agree is not None and ckpt_mgr is not None:
                    agree.boundary()  # the requests every rank honours now
                fields = {"image": batch["image"], "xy": batch["xy"]}
                if "_mask" in batch:  # bucket-padded tail: loss-masked
                    fields["_mask"] = batch["_mask"]
                state, metrics = step(state, fields)
                if scenario_ctx:
                    loss_val = None
                    cur = scenario_ctx.get("curriculum")
                    if cur is not None:
                        loss = metrics["loss"].reshape(-1)[-1]
                        loss_val = float(loss)  # the curriculum's evidence
                    scenario_ctx["accounting"].account_batch(
                        batch, loss=loss_val
                    )
                    if cur is not None:
                        report = cur.step(1)
                        if report:
                            print(
                                f"curriculum v{report['version']}: "
                                f"weights={report['weights']}"
                            )
                if i % 10 == 0:
                    loss = float(metrics["loss"].reshape(-1)[-1])
                    result["losses"].append(loss)
                    print(f"step {i}: loss={loss:.5f}")
                if ckpt_mgr is not None:
                    # direct-loop twin of the driver cadence: async
                    # snapshot every N steps, on breach request, and a
                    # drain-free SIGTERM flush (no ring to drain here)
                    ckpt_refs["steps"] = i + 1
                    done = start_step + i + 1
                    if agree is not None:
                        if guard is not None and guard.requested:
                            agree.request("preempt")
                        breach = agree.take("checkpoint")
                        preempt = agree.take("preempt")
                    else:
                        breach = ckpt_refs.pop("breach", None)
                        preempt = guard is not None and guard.requested
                    if breach or (args.checkpoint_every
                                  and (i + 1) % args.checkpoint_every == 0):
                        _save(done, _direct_session(done))
                    if preempt:
                        _save(done, _direct_session(done))
                        ckpt_mgr.wait()
                        err = ckpt_mgr.last_error
                        raise PreemptionRequested(
                            f"snapshot FAILED at step {done} "
                            f"({err!r}): resuming from the last "
                            "committed step" if err is not None
                            else f"snapshot committed at step {done}"
                        )
            n += batch_images(batch)
        if driver is None and n:
            # the last update's loss (one fetch, after the loop)
            result["last_loss"] = float(metrics["loss"].reshape(-1)[-1])
        return n

    try:
        if args.replay:
            # Replays through the same ingest -> decode path as live
            # traffic (tile-delta recordings included), looping like
            # epochs.
            pipe = StreamDataPipeline.from_recording(
                args.replay, batch_size=args.batch, loop=True, chunk=chunk,
                emit_packed=use_fused, allow_pickle=args.allow_pickle,
                device=device, mesh=mesh,
                requests=None if echo_mode else agree,
            )
            with wrap_echo(pipe) as source:
                run_steps(iter(source))
            return result

        if args.synthetic_producers:
            from blendjax_torch.fleet import SYNTHETIC_PRODUCER

            script = SYNTHETIC_PRODUCER
            producer_args = [
                "--shape", str(h), str(w), "--batch", str(rank_batch),
                "--trace-every", str(args.trace_every),
            ]
            start_n = args.synthetic_producers
        else:
            script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "cube_producer.py")
            producer_args = ["--shape", str(h), str(w),
                             "--trace-every", str(args.trace_every)]
            if args.encoding in ("tile", "pal"):
                producer_args += [
                    "--batch", str(rank_batch),
                    "--encoding", args.encoding,
                ]
            start_n = args.instances
        if fleet_bounds:
            start_n = fleet_bounds[0]
        named_sockets = ["DATA"]
        if args.scenarios:
            named_sockets = ["DATA", "CTRL"]
            producer_args = producer_args + ["--scenario-wait", "15"]
        seed = 0 if mesh is None else 1000 * mesh.get_rank()
        with PythonProducerLauncher(
            script=script,
            num_instances=start_n,
            named_sockets=named_sockets,
            seed=seed,
            instance_args=[producer_args] * start_n,
        ) as launcher:
            pipe = StreamDataPipeline(
                launcher.addresses["DATA"],
                batch_size=args.batch,
                chunk=chunk,
                emit_packed=use_fused,
                record_path_prefix=args.record,
                device=device,
                mesh=mesh,
                requests=None if echo_mode else agree,
            )
            svc = None
            if args.scenarios:
                from blendjax_torch.scenario import (
                    ScenarioCurriculum,
                    ScenarioService,
                    ScenarioSpace,
                    accounting,
                )

                space = ScenarioSpace.parse(args.scenarios)
                svc = ScenarioService(space)
                for i, addr in enumerate(launcher.addresses["CTRL"]):
                    svc.attach(i, addr)
                if not svc.wait_acked(timeout=15):
                    print(
                        "warning: not every producer acked the scenario "
                        f"space yet: {svc.state()}"
                    )
                scenario_ctx["accounting"] = accounting
                scenario_ctx["service"] = svc
                if args.curriculum:
                    scenario_ctx["curriculum"] = ScenarioCurriculum(
                        space, service=svc,
                        every_steps=args.curriculum_every,
                        agreement=agree,
                    )
                if ckpt_session:
                    from blendjax_torch.checkpoint import restore_session

                    # a restored curriculum re-publishes its space (and
                    # version) through the freshly attached service
                    restore_session(
                        ckpt_session, scenario=accounting,
                        curriculum=scenario_ctx.get("curriculum"),
                    )
            ctrl = None
            if fleet_bounds:
                from blendjax_torch.fleet import FleetController, FleetPolicy

                # the controller's own thread runs the blocking launcher
                # lifecycle; the pipeline applies the connect/disconnect
                # ops from its socket-owning thread; on a mesh the ranks'
                # controllers agree per tick on a gloo group of their own
                fleet_agreement = None
                if mesh is not None:
                    from blendjax_torch.parallel.mesh import RankAgreement

                    fleet_agreement = RankAgreement(mesh)
                ctrl = FleetController(
                    launcher, connector=pipe,
                    policy=FleetPolicy(
                        min_instances=fleet_bounds[0],
                        max_instances=fleet_bounds[1],
                    ),
                    diagnose=lambda: pipe.doctor(driver),
                    health=(
                        (lambda: reporter.healthy)
                        if reporter is not None else None
                    ),
                    instance_args=producer_args,
                    # elastic scenario membership: a scaled-up producer
                    # receives the current space before its data address
                    # joins the fan-in
                    scenario_service=svc,
                    agreement=fleet_agreement,
                ).start()
                ckpt_refs["fleet"] = ctrl
                if ckpt_session.get("fleet"):
                    # reconnect the snapshot's fleet: grow back to the
                    # saved count, re-admit remote members
                    ctrl.load_state_dict(ckpt_session["fleet"])
                if reporter is not None:
                    reporter.fleet = ctrl  # fleet state per JSONL tick
            try:
                with wrap_echo(pipe) as source:
                    run_steps(iter(source))
                    result["seq_gaps"] = pipe.seq_gaps
                    if echo_mode:
                        result["echo"] = source.stats
                        print(f"echo={source.stats}")
                    if scenario_ctx:
                        rep = _scenario_report(scenario_ctx["accounting"],
                                               agree)
                        result["scenarios"] = rep
                        print(
                            f"scenario space v{rep['space_version']}: "
                            + ", ".join(
                                f"{sid}: {s['rows']} rows "
                                f"({s['fresh']} fresh/{s['echoed']} "
                                f"echoed, loss p50 "
                                f"{s['loss']['p50']:.4f})"
                                for sid, s in rep["scenarios"].items()
                            )
                        )
                        if "curriculum" in scenario_ctx:
                            wts = scenario_ctx["curriculum"].space.weights()
                            result["curriculum_weights"] = wts
                            print(
                                "curriculum weights: "
                                + ", ".join(
                                    f"{k}={v:.3f}" for k, v in wts.items()
                                )
                            )
                    print(source.doctor(driver).render())
                    if ctrl is not None:
                        if mesh is not None:
                            # the ranks stop together (an agreed tick), so
                            # each prints the count they all hold
                            ctrl.stop()
                        st = ctrl.state()
                        result["fleet"] = st
                        print(
                            f"fleet: instances={st['instances']} "
                            f"(bounds {st['min']}:{st['max']}), "
                            f"ticks={st['ticks']}, "
                            f"last verdict={st['verdict']}"
                        )
                        for ev in ctrl.scale_events():
                            detail = {
                                k: v for k, v in ev.items()
                                if k not in ("t", "action")
                            }
                            print(f"  fleet {ev['action']}: {detail}")
            finally:
                if ctrl is not None:
                    ctrl.stop()
                if svc is not None:
                    svc.stop()
        return result
    finally:
        if guard is not None:
            guard.uninstall()
        if ckpt_mgr is not None:
            ckpt_mgr.close()  # flushes the exit snapshot
            if agree is not None and sys.exc_info()[0] is None:
                # every rank returns once rank 0's writes have landed
                agree.gather_objects(None)
            result["checkpoint"] = {
                "steps": ckpt_mgr.steps(), "saves": ckpt_mgr.saves,
                "bytes": ckpt_mgr.bytes, "save_ms": list(ckpt_mgr.save_ms)}
            print(
                f"checkpoints in {args.checkpoint}: "
                f"steps {ckpt_mgr.steps()}"
            )
        if reporter is not None:
            reporter.stop()  # final tick logs the closing verdict
        if exporter is not None:
            exporter.close()
        if args.trace_export:
            from blendjax_torch.obs import write_chrome_trace

            n = write_chrome_trace(args.trace_export)
            print(f"wrote {n} span events to {args.trace_export}")


def _scenario_report(ledger, agree) -> dict:
    """The scenario ledger's report: this rank's, or on a mesh the sum over
    every rank's (the same on every rank)."""
    if agree is None:
        return ledger.report()
    from blendjax_torch.scenario import ScenarioAccounting
    from blendjax_torch.scenario.accounting import merge_ledgers

    merged = ScenarioAccounting()
    merged.load_state_dict(merge_ledgers(
        agree.gather_objects(ledger.state_dict())))
    return merged.report()


if __name__ == "__main__":
    main()
