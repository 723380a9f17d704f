#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --startup 5   # only the start-up probe
    python3 chip_smoke.py --two-rank-phase  # the build, the two-rank
                                            # leg and 5k's two-rank sub-leg

Phases (any failure exits non-zero):

1. device: the card's name and power limit (``nvidia-smi``); no CUDA
   device -> exit 1 before anything else; the host's ``os.cpu_count()``,
   ``len(os.sched_getaffinity(0))`` and the free bytes of ``/dev/shm``;
2. build: compile every kernel source in ``blendjax_torch/kernels/csrc``
   (one ``nvcc`` per source, started together), print the build time and
   ``-Xptxas -v``'s registers and spills, and count the ``HGMMA`` (wgmma)
   and ``UTMALDG`` (TMA load) instructions in the SASS of the built sm90
   forward and sm90 backward (``cuobjdump -sass``); any count 0 fails;
3. kernels: the decode kernels K1/K2 against their plain twins,
   bit-exact (``torch.equal``), at the main path's shapes and at the edge
   cases (``Ct < C``, ``K == 0``, a row of sentinels, byte-wide
   geometries, K2 with negative indices and indices past N); after the
   slice legs (run before them, they slowed the producer-bound flagship
   leg), the flash-attention kernels K4a-c against their plain versions
   at the StreamFormer slice's shape (B 8, T 768, H 4, D 128, bf16),
   causal, Tq 256 != Tkv 768, a ragged T of 700, D 64 and f32 (forward
   max |diff| <= 2e-2 bf16 / 1e-4 f32 with TF32 off, lse within 1e-3;
   gradients max |diff| <= 2e-2 / 1e-4 of max |plain|); every bf16 case
   must take the sm90 variant of all three kernels, the f32 case the
   simple one; two calls of each backward kernel at the slice's shape must
   give bit-identical dk, dv and dq. Then each kernel's median card time,
   at the slice's shape and at the long one (4, 3072, 4, 128), over windows
   of back-to-back
   launches queued behind a sleep kernel (``time_ms``), with the min and
   max window and the host's enqueue time per call, its plain version's
   time, a one-call PyTorch yardstick where one exists (``index_copy_``,
   beside the two-call ``copy_`` + ``index_copy_`` that computes K2's
   whole function; ``scaled_dot_product_attention`` forward, and its
   autograd backward for K4b+K4c together), and its bound: the larger of
   bytes / memory rate and FLOPs / 989 TFLOP/s (bf16 dense);
4. slice: two cube producers (480x640 RGBA, (16, 32) tiles, capacity
   160, batch 8) -> ``StreamDataPipeline(emit_packed=True, chunk=4)`` ->
   ``CapturedStep(make_fused_tile_step())`` (one CUDA graph per packed
   plan, captured the first time it is seen) -> ``TrainDriver(inflight=2)``,
   in three legs:
   flagship (full-width ``CubeRegressor()``, bf16-compute), square
   (16x16 tiles, capacity 288) and streamformer (``StreamFormer(patch=20,
   dim=512, depth=8, num_heads=4, num_outputs=16, attn_backend="flash")``
   with the bench's corner loss). Before its producers start, each leg
   captures every plan signature its stream makes (``CapturedStep.prepare``
   on groups of K' = 1..4 2-bit and 4-bit messages made here: the
   producers' per-frame palettes pick each message's index width, and a
   change of width splits a chunk group), so no capture lands in a
   measured window. Launch counts are zeroed just before
   each leg and read just after: flagship must launch K1, square K2,
   streamformer K1 and each of K4a-c exactly depth x updates times (the
   updates: the groups' sizes summed),
   every K4a-c launch through the sm90 variant, launches counted through
   the graph replays (each replay adds what its graph captured); losses
   must be finite with zero sequence gaps, one step call and one graph
   replay per chunk group and no fallback. Each leg times its step alone
   on its last chunk group eagerly and through the graph in the same run,
   profiles one call of each (kernels and host launches per call, device
   busy share from the profiler, or from CUDA events when the profiler
   records no graph kernel) and prints its graphs' capture ms and
   private-pool bytes. Every producer must report on stderr that it runs the host
   C++ path (render, tile scan and palettizer of ``blendjax_torch/_native``);
   each leg prints the producers' own frames/s (render and encode, the
   publish left out) beside live img/s and step-alone img/s. The streamformer
   leg also times the same model with ``attn_backend="xla"`` (for
   information) and holds one update of flash
   against one of xla from copies of the same state (bf16 bars: rel 1e-2
   before the update, 5e-2 after it);
5. echo leg (after the three legs above): two cube producers (the
   flagship stream) -> ``StreamDataPipeline(chunk=1, emit_packed=False)``
   (every batch decoded on the card by K1) -> ``EchoingPipeline(capacity=
   256, max_echo_factor=4, emit_draws=True)`` ->
   ``CapturedStep(make_echo_fused_step)`` on full-width ``CubeRegressor()``
   -> ``TrainDriver(inflight=2)``, 128 warm-up and 1024 measured steps
   (the drain thread's CPU seconds over the window printed). Each decoded fresh batch also goes
   through ``uint8_gamma_normalize`` on the card (K3). It fails unless
   fresh + echoed == steps x batch exactly, echoed > 0, no sample is drawn
   more than 4 times, seq_gaps == 0, losses are finite, one step call per
   driver step, a donation audit (``blendjax_torch.testing.DonationAudit``)
   of the state and the ring that reads stable over the window, and K1 and
   K3 each
   launched once per decoded fresh batch (on the drain thread, outside the
   step's graph, through the replays of the decoded form's graphs:
   ``CapturedDispatch``, one replay per decoded batch and no eager
   decode), one graph replay per step and no fallback; it prints
   live img/s into the step, the fresh frame rate and the unique fraction,
   and the step alone eager and through its graph;
5b. graphs: each step builder of the slice (fused tile with K1, fused
   tile with K2, the streamformer fused step with K1 and K4a-c, echo) runs
   4 steps eagerly and 4 through ``CapturedStep`` from one state on the
   legs' last recorded chunk groups (draw tokens for echo), cuDNN
   deterministic: losses and every parameter must be bit-equal, and the
   launches counted through replays equal the eager ones. Then the same
   over a plain ``fn(seed, images)`` augmentation (a shift drawn by a
   generator of its own): the fused tile step (K1) under ``CapturedStep``,
   ``TrainDriver.build(augment=fn, aot=True)`` on decoded flagship
   batches and the echo step over a reservoir with a plain ``augment``,
   each bit-equal with its eager twin with every call eager
   (``eager_calls`` == calls, no replay, nothing captured) and K1
   launched on the fused one, beside the fused step over a
   ``SeededAugment`` that must replay one graph per call; it prints the
   counts and the fused step's ms per update, the plain ``fn`` eager
   against the same step forced through a capture (timing only) and the
   seeded step captured. Then the
   dispatches the JAX package jits outside a step, eager against
   ``CapturedDispatch``: the decoded form's decode of the legs' recorded
   groups (tile K1, tile K2, and full-frame palette groups of the
   flagship's frames) and the echo reservoir's ``sample`` (default
   augmentation), 4 calls each from the same inputs and draw counters:
   bit-equal, one replay per call, launches through replays equal to the
   eager ones; the held-batch gate (8 decoded and 8 drawn batches held
   across 8 later calls that replay the same graphs, then each equal to
   its eager twin); and card time (``time_ms``) and host launches per
   call (the profiler's launch API calls), eager and captured, of the
   decode of a K' = 4 flagship group (32 x 480 x 640 x 4) and of a draw
   of 32 rows, beside the card time of the copy of the outputs each
   captured call makes. Then
   ``TrainDriver.build(aot=True)`` on a decoded flagship group as a batch
   of 32 captures one graph per ladder signature before step 0; two full
   steps and a ragged tail of 20 rows (a masked bucket of 32) must be
   bit-equal with the eager step, with no fallback; it prints
   ``startup_ms``, ``time_to_first_step_ms``, capture ms per signature and
   pool bytes;
5c. input side (after the legs above), each run at the flagship's width
   through one shared ``CapturedStep(make_fused_tile_step())`` on a fresh
   full-width ``CubeRegressor()`` and ``TrainDriver(inflight=2)``, 64
   warm-up and 320 measured steps: four cube producers into
   ``StreamDataPipeline(ingest_workers=1)`` and ``(ingest_workers=2)`` in
   the order 1, 2, 2, 1 (the A/B), one run of two shards without the
   inflate pool (for information), then two producers with ``--wire shm``
   and two with ``--wire ndz`` (``inflate_workers=2``), each through two
   shards. Every run fails unless seq_gaps == reorders == restarts == 0,
   one step call and one replay per driver step, no graph captured in the
   measured
   window, K1 launched, and (sharded) every shard took items; the shm run
   also unless its shm reads equal the messages received with no torn
   slot, fallback or reclaim, the ndz run unless the inflate pool decoded.
   Each prints live img/s, the producers' own frames/s, each shard's
   messages, items and batches, and the graph step alone. A producer that
   dies (a ring that cannot be made) fails the phase with its log. Then
   the equality leg: 40 recorded flagship messages through a port
   publisher on the raw wire, over a shared-memory ring, and as ndz
   through an inflate pool; the packed groups, their decode on the card
   and the f32 losses of the captured steps over those groups (the
   stream's sizes: a change of index width closes a group early) from one
   seeded state must be identical on all three routes;
5d. palette producer, replay and resume (after 5c): every producer of
   every leg must report the fused per-frame palette path (``fused`` in its
   stats line; these are ``--tile-rgba`` streams), and the flagship leg
   prints each producer's message bytes per 8 frames and own frames/s
   beside its live img/s, and holds the frames of its first two chunk
   groups, decoded on the card, against the scenes rendered again on the
   host, bit for bit. The flagship leg also records its first
   ``REPLAY["record"]`` messages (``record_path_prefix``); the replay leg
   runs ``StreamDataPipeline.from_recording(..., emit_packed=True, chunk=4,
   loop=True)`` into a fresh captured flagship step from the same initial
   weights, with no producer, and fails unless its first
   ``REPLAY["compare"]`` packed groups equal the live leg's bit for bit and
   their losses agree (bit for bit, or else within bf16 rel 1e-2, printed),
   K1 launched and one replay per step; it prints replay img/s beside the
   graph step alone. The resume phase, under deterministic algorithms
   (cuDNN deterministic; ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` is set when
   the script starts), builds drivers with ``TrainDriver.build(rng=0)``
   (captured ladder) on 2N decoded replay batches: Y trains 2N steps; A
   trains N with ``checkpoint_every``; B, ``build(resume=True)`` from A's
   newest snapshot, trains N..2N; C, built and stepped, is restored in
   place and replays step N. B's and C's losses and B's final parameters
   must equal Y's bit for bit; it prints the snapshot's bytes, the
   writer's ms per snapshot, ms per step with and without snapshots and
   B's time to first step;
5f. launched, gym and duplex legs (after 5d): the flagship configuration
   started by the port's launcher (``PythonProducerLauncher(script=
   <producer/cube.py>, named_sockets=["DATA"], seed=0, proto="ipc",
   respawn=True)``) into ``StreamDataPipeline(launcher=..., ingest_workers
   =2, timeoutms=5000)`` and a fresh captured full-width CubeRegressor
   step, 64 warm-up and 192 measured steps: it fails unless the window has
   no gap, reorder or restart, btids 0 and 1 arrived with the handshake's
   seeds 0 and 1 (their stats lines, and their first groups' frames equal
   to those seeds' renders), one replay per step and K1 launched; it
   prints live img/s, the producers' own frames/s and the doctor's
   verdict. Then producer 1 is SIGKILLed: the launcher respawns it
   through the stream's timeout hook, and the run fails unless the
   stream counts exactly one restart, for btid 1, and 64 more steps
   train; then a second fleet with ``respawn=False`` and the same kill,
   which must raise the launcher's dead-producer error within the
   receive timeout + 5 s. After each fleet no producer process, ipc or
   registry directory and no new ``/dev/shm`` segment may be left. The
   gym leg starts the port's cartpole script under the launcher
   (``GYM`` socket) and drives it with ``RemoteEnv`` as ``bench.py``'s
   ``measure_rl_hz`` does (100 warm-up steps, 3 s of ``step(0.0)``,
   steps/s and round trip p50/p99), and fails unless two
   ``reset(seed=7)`` runs under one action sequence give bit-identical
   observations over 200 steps. The duplex leg launches a producer
   (written into the leg's directory) that echoes each ``CTRL`` message
   through ``DuplexChannel`` on ``SimEngine`` frames, sends 1000
   ``PairChannel`` messages (round trip p50/p99), and fails unless every
   ``btmid`` comes back from btid 0. The fake-Blender leg: the port's
   ``BlenderLauncher`` starts ``examples/datagen/cube.blend.py`` through a
   wrapper of the port's ``write_fake_blender`` with the UI on (offscreen
   frames of the stock 1920x1080 scene), and 4 captured steps of
   ``train.py``'s direct loop train on its frames in batches of 2; it
   fails unless at least 8 messages arrived, the losses are finite and no
   process, directory or segment is left;
6. K3 (gamma normalize) against its plain version over all 256 uint8
   values, at (1, 37, 8, 4) and at that shape from byte offset 1 (the
   element path), gamma 2.2 and 1.0, f32 and bf16 (bit-exact, so within
   the bars f32 max |diff| <= 1e-6 and bf16 one bf16 ulp), and on a
   decoded batch of the echo leg's stream, where it is timed beside its
   bytes bound over ``L2_ROUNDS`` copies of the batch in turn (from HBM)
   and, for information, on that one batch (L2-resident) and beside
   PyTorch's ``fill_`` of the output alone (the same rotation);
7. reference: one recorded chunk group decoded on the card against the
   CPU twins (bit-exact); the f32 CubeRegressor forward and the f32
   full-width StreamFormer forward (through the simple f32 flash forward,
   which f32 always takes) on the card against the CPU (TF32 off, rtol
   1e-4).

Donation audits (``blendjax_torch.testing.DonationAudit``): the flagship
leg (the state over its window), the echo leg (the state and the ring),
the resume phase (C's state across its in-place restore and a step) and
both RL legs each snapshot their buffers' storage addresses at the
window's start and end, set the ``train.donation_reuse`` gauge, print the
audit's report on their line and fail unless every label is stable.

Sync census (:class:`SyncCensus`): the flagship leg's, the echo leg's and
the prioritized RL leg's steady windows (after their captures and
warm-up) run under ``torch.cuda.set_sync_debug_mode("warn")``, with the
warnings caught process-wide (the drain and actor threads too). Each
reported sync is attributed to the innermost frame in
``blendjax_torch/`` and looked up in the port's analyzer (the findings of
BJX102, 106, 108, 111 and 115 on the tree, inline-suppressed ones
included): each leg prints its syncs per step and every site with its
count and verdict, ``flagged``, ``sanctioned`` (``CENSUS_SANCTIONED``,
each with the rule sentence that allows it) or ``outside`` (no hot
module), beside the driver's ``train.host_blocks`` and the feeder's
``feed.throttle_blocks`` (``Event.synchronize()``, which the detector
does not see); a hot module's site that is neither flagged nor
sanctioned fails the run.

Observability (the metrics registry and ``blendjax_torch.obs``): every
live leg zeroes the process-wide registry, frame lineage and trace
collector before its producers start (each leg's producers number from 0
under the same btids) and fails unless its streams counted no gap, no
reorder and no restart; each leg prints the stall doctor's verdict. The
flagship leg runs with the publishers' default stamps (lineage, telemetry
and a sampled frame trace every 64 messages), a ``StatsReporter`` ticking
every second into a JSONL file, span events on and the Prometheus exporter
on a free localhost port, scraped once mid-window, and prints one
``stages`` JSON line (spans with p50/p95/p99, the ``tiles.``, ``ingest.``,
``wire.``, ``train.``, ``feed.`` and ``device.`` counters and gauges,
per-producer lineage, the frame traces' transitions and the verdict); it
fails unless every span's histogram counts sum to its span count, the
lineage received exactly the stream's messages, every producer completed
a frame trace through publish, recv, batch, step_dispatch and step_retire
in monotonic order, the Chrome trace holds a frame_trace lane, the scrape
parses and carries ``blendjax_train_dispatches_total``, and the JSONL file
has one line per reporter tick. The streamformer and replay legs print
their ``stages`` lines too. The streamformer leg's full-group graph, in the
device ledger, must count within 2% of the executed-work FLOPs per image
(``former_executed_flops_per_image``), and the leg prints its eager step's
device time by kernel group (through the guarded ``trace``) beside the
graph replay's event time. Phase 5e (after the AOT phase): the AOT
ladder's cost-model FLOPs per image within 10% of ``measure_model_flops``;
no retrace on the prewarmed legs, then exactly one for an unprepared
signature fed twice, attributed to it; the HBM gauges after a reporter
tick, printed beside the allocator's figures and the ladder's pool bytes.

Phase 5g (after the launched, gym and duplex legs), the mesh path on
``torch.distributed``: an NCCL process group of world size 1 on the card
(``FileStore`` in the run's temp directory; a failed init ends the run).
The mesh flagship leg: ``MeshTrainDriver.build(CubeRegressor(),
create_mesh({"data": -1}), fused=True, aot=True)`` live from the flagship
stream through ``StreamDataPipeline(mesh=)``, 32 + 96 steps: one graph
replay per step call, K1 launched, the data axis and world size and its
img/s beside the single-card flagship's printed; the first step call's
``device.collective.all_reduce_bytes`` must equal the gradient and loss
bytes its updates reduce; on the replay leg's recording (deterministic
algorithms) its losses must be bit-equal to the single-card
``TrainDriver``'s. The sequence-parallel legs: the full-width
StreamFormer with ``use_ring=True, sp_mode="ulysses"`` on ``{"data": 1,
"seq": 1}``, flash attention, eager, 2 + 16 chunk groups of the
recording: every K4a, K4b and K4c launch inside ``ulysses_attention``
(each depth x updates times, as many as Ulysses' flash calls), losses
within K4's bar of the non-mesh step's; then ``sp_mode="ring"`` on the
same groups, held at the bf16 bar of ``tests/test_torch_parallel.py``
and at the tighter bar of a one-block ring (world size 1: no hop). Each
of Ulysses, ring and the non-mesh step runs again captured
(``MeshTrainDriver.build(fused=True, aot=True)``; ``CapturedStep`` for
the non-mesh step), every plan signature prepared before the run, all
six runs cuDNN deterministic: one graph replay per step call and no eager
call, the losses bit-equal to the same mode's eager run, K1 and K4a-c
launches counted through the replays equal to the eager run's (for
Ulysses, equal to its flash calls, counted per replay too), the
collectives by kind and axis equal, each Ulysses graph holding its
all-to-alls; img/s and host ms per step call printed captured against
eager for each. Then one all-to-all and attention through Ulysses
against local attention, timed. The echo mesh leg: full-width
``CubeRegressor()``'s echo fused step over a ring of 64 seeded frames
sharded on ``{"data": 1}`` (the device-side gather, its all-reduce over
one rank), 8 draws eagerly and through ``CapturedStep(step,
mesh=mesh)``: one replay per step call, no eager call, losses and
parameters bit-equal, collectives equal, the donation audit of the state
and the ring 1.0. Phase 5h's pipeline leg runs on the same group before
it is destroyed: ``pipeline_apply`` over ``create_mesh({"pipe": 1})`` with one
full-width StreamFormer ``Block`` (flash) as the stage through
``torch.func.functional_call``, 4 microbatches of (8, 768, 512) bf16: the
output and the input gradient must be bit-equal to the block called on
each microbatch, and each of K4a-c launched once per microbatch inside it.

Phase 5g's two-rank leg (after the NCCL group is destroyed): two
processes on the one card (``--two-rank RANK DIR``, each
``torch.cuda.set_device(0)``), one gloo group over the card's tensors
(``init_group(backend="gloo")``; NCCL refuses two ranks of one device).
A probe beside them (a pair of processes per collective kind) reads
which collectives gloo refuses on CUDA tensors: of the port's kinds it
must refuse the permute alone, the one the port stages through the host.
The ranks run (a) the full-width StreamFormer on
``{"data": 1, "tp": 2}`` (2 heads of 128 per rank: K4a-c on each rank's
heads), fed live by the flagship's 2 producers (rank 0 ingests, records
and broadcasts each host batch; both decode with K1) for 6 chunk groups,
(b) the MoE StreamFormer on ``{"data": 1, "expert": 2}`` on 3 groups of
(a)'s recording, (c) ``CubeRegressor()``'s echo on ``{"data": 2}`` from
one synthetic scenario producer per rank, the default paired
augmentation applied to each rank's rows, (d) one ``ring_permute`` of a
CUDA tensor and its backward (staged twice, both right). This process
then runs (a) and (b) on one rank from the recording, and (e) the same
two models split over a ``tp``, an ``fsdp`` (the dense model) and an
``expert`` axis of size 1 on an NCCL group of world size 1 (the split's
collectives, and the fsdp gathers, as NCCL calls over one rank), each
eagerly and with ``aot=True``: each update's loss of (a), (b) and (e)
within 1e-4 of the one-rank loss (``TWO_RANK["loss_rel"]``), K1 and
depth x updates of each of K4a-c launched on each rank, each rank's state
below a replicated rank's, (e)'s sums over its axis in the tally; in (e)
one graph replay per step call and no eager call, the captured losses
bit-equal to the eager run's (cuDNN deterministic), the launches and the
collectives by kind and axis equal, an all-gather inside the fsdp graph
and the donation audit 1.0, printing each layout's ms per update eager
and captured, the graphs' pool bytes and the resident bytes beside the
data layout's; (c) exact per-scenario
accounting and the same slot stamps on both ranks, the apply on half
the rows, and checked draws' rows bit-equal to the one-card draw's. It
prints per rank the launches, the collectives by kind and axis, the
gloo stages, the resident bytes and the wall seconds. ``python3
chip_smoke.py --two-rank-phase`` runs the build, this leg and phase 5k's
two-rank sub-leg alone.

Phase 5h (after the mesh phase), mixture of experts and remat: the MoE
leg runs ``StreamFormer(**FORMER, num_experts=4, moe_every=2)`` (MoE in
blocks 0, 2, 4, 6) live on the flagship stream through its captured fused
step, the streamformer leg's 2 + 16 step calls: one replay per step call,
K1 launched and K4a-c depth x updates times, finite losses, each MoE
block's aux loss read once after the window, and 4 recorded groups eager
against captured bit for bit; its img/s and step alone are printed beside
the dense leg's. The remat leg runs the dense model with ``remat=True``
and ``False`` through captured steps on the streamformer leg's recorded
groups from its initial state: losses and parameters bit-equal, K4a
launched twice as often under remat and K4b/K4c as often; it prints the
peak ``max_memory_allocated`` of one eager step call of each and both
graphs' step alone.

Phase 5i, RL (``bench.py``'s live RL leg): two of the port's cartpole
producers under ``BatchedRemoteEnv`` -> ``ActorPool(HostQPolicy(3,
eps_steps=1500))`` -> ``TrajectoryReservoir(512)`` -> ``RLTrainDriver``
with ``CapturedStep(make_dqn_step)``, ``QNetwork((32, 32))``, batch 32,
``min_fill`` 64, ``sync_every`` 8, 300 learner steps, a uniform and a
prioritized leg: one graph replay per learner step, a donation audit of
the ring, priorities, parameters, target and Adam moments stable across
the window, fresh +
replayed == draws x batch, env steps == transitions inserted, the best
leg's mean return (the later half of its episodes, the actors run on to
8 ended episodes) >= 15; learner steps/s, ``rl.sample_waits`` and the RL
doctor's verdict printed. The resume leg snapshots every 4 steps, stops
after the first commit, restores it into a fresh stack and continues to
48 steps from the snapshot's step, inserts and env steps. The PG leg: 4
``make_pg_step`` graph replays bit-equal to the eager steps. The split
DQN leg: the state split over ``{"data": 1, "fsdp": 1}`` (NCCL, world
size 1; the online and target networks gathered over one rank in the
step), 16 steps on scripted transitions eagerly and through
``CapturedStep``, bit-equal (losses, shards, priorities), one replay per
step, the donation audit 1.0, the losses within 1e-5 of the replicated
captured run's; then the replicated state over a reservoir sharded on
``{"data": 1}`` (the ring's gather on the card, its all-reduce over one
rank), eagerly and through ``CapturedStep(step, mesh=mesh)``: bit-equal
(losses, parameters, target, priorities), one replay per step and no
eager call, the collectives equal by kind and axis, the donation audit
1.0, the losses within 1e-5 of the replicated run's; each run's ms per
step printed.

Phase 5j (after 5i), scoring, the scenario loop and the elastic fleet
(``bench.py``'s ``measure_live_scenario`` and ``measure_live_fleet``,
and densityopt's critic). The scenario and fleet paths stream raw frames,
so the phase launches none of K1-K4c. The scoring leg: ``GaussianSimParams``
on the card samples 32 supershape parameter pairs with a CUDA generator,
``SupershapeScene`` renders them (256x256x4), ``DeviceFeeder`` places the
producer's batch (``image``, and ``shape_id`` and ``frameid``, both (B,)
int64) three times behind a sleep on its copy stream, every field intact,
and the full-width ``Discriminator()`` (bf16 compute) runs forward and
backward eagerly: finite logits and gradients, the logits within
``DISC_REL`` of the plain path's f32 run on the CPU with the same weights,
there and on 8 frames at 250x250 (odd sides from the second layer on, where
SAME padding is uneven), and one REINFORCE update from the per-sample
losses moves ``mu``; it prints ms per forward+backward (``time_ms``). The scenario legs: 2 ``synthetic_fleet(scenario=True)``
producers (32x32, batch 4, 60 frames/s) get the space
``easy:half_extent=u(0.8,1.2) / hard:half_extent=u(0.8,1.2),xy_jitter=16``
from a ``ScenarioService`` -> ``StreamDataPipeline(batch_size=8)`` ->
``EchoingPipeline(capacity=64, max_echo_factor=4, emit_draws=True)`` ->
the captured echo-fused step on ``CubeRegressor()``, each step's loss
attributed to its rows' scenarios; ``fixed`` freezes the curriculum,
``curriculum`` adapts every 10 steps (``min_rows=4``). Each fails unless
fresh + echoed == steps x batch over the declared ids, >= 2 ids seen, no
gap, reorder or restart, one graph replay per step call, finite losses,
and (curriculum) space version >= 2 with the weight moved toward
``hard``; over 160 steps (the bench's 40, lengthened so the frames queued
during the first step's capture drain), it prints img/s over the replays
after the first step (the first frames and the graph's capture, timed
apart) and the settled img/s over the last half of the steps. The fleet legs: producers capped at 40
frames/s (32x32, batch 4), a fixed fleet of 2 against one autoscaled from
1 (``FleetPolicy(up_after=2, cooldown_s=2.0)``, at most 4), the
``FleetController`` ticking on ``pipe.doctor()`` every 0.5 s from the
main thread for 10 s (the bench's 12, cut), the pipeline placing on the
card: the autoscaled
leg must scale up, neither may count a gap, and no process, directory or
shared-memory segment may be left; each prints the instance trajectory,
the verdict runs and the settled img/s (second half), and the phase the
settled ratio.

Phase 5k (last, after phase 7), the port's examples
(``blendjax_torch/examples``), each ``main(argv)`` loaded by path and run
in this process with its standard output captured and the launch counts
zeroed just before and read just after; none may leave a child process
(nor, for the control legs, a ``/dev/shm`` segment or temp entry). It
runs last because the examples capture signatures nobody prepared, which
the device ledger counts as retraces. ``datagen/train.py`` at 480x640,
batch 8, ``--encoding tile --chunk 4 --inflight 2 --steps 64``,
recording and snapshotting: one graph replay per step call, K1 launched
inside the captured fused step at least once per call, finite losses, the
printed img/s. Then 3 chunk groups of that recording replayed from the
step-64 snapshot on the card and with ``--device cpu``: the first and
last updates' losses within ``EX_REPLAY_REL`` of each other (both
bf16-compute). Then ``--encoding pal --chunk 4 --inflight 2``, raw and
``--echo 4``, 16 steps each, one replay per step call. Every leg prints
its captured signatures, each capture's ms and where a later signature
differs from the first.
Its two-rank sub-leg (``mesh_examples_leg``, the datagen examples on
``{"data": 2}``, rules in ``blendjax_torch/docs/mesh-examples.md``): two
processes on the card, each opening a gloo group of both
(``init_group(backend="gloo")``) and calling ``train.main(argv)`` run
after run, in f32 (TF32 off) under deterministic algorithms; a gloo mesh
steps eagerly (no capture). The tile runs are 480x640, batch 8, chunk 4,
``--inflight 1 --sync-every 1`` (every step's loss): live from one cube
producer per rank for 16 steps with ``--record`` and ``--checkpoint
--checkpoint-every 8`` (snapshots 8 and 16); each rank cuts its
recording to the messages of the first 8 steps; ``--replay`` of the cut
recording for 16 steps (its first 8 losses must equal the live run's and
the next 8 loop it); ``--resume`` from the step-8 snapshot with that
replay for 8 steps (equal to the replay's second 8); K1 launched on every
rank of each. Then ``--synthetic-producers 1 --scenarios ... --curriculum
--curriculum-every 4`` for 16 steps (the rows summed over the ranks =
16 x 8; one report, version and weights on both) and ``--fleet 1:2`` for
300 steps (one instance count within the bounds, as many ticks on both).
This process then replays the cut recording and resumes the step-8
snapshot on one card: within ``MESH_EX_REL`` of the two ranks' losses.
No process, directory or shared-memory segment may be left. It prints per
rank and run the wall seconds, img/s and K1 launches, and rank 0's
snapshot bytes and writer ms.
``datagen/train_transformer.py`` at StreamFormer's full width (patch 20,
dim 512, depth 8, 4 heads, 16 steps, on a mesh ``{"data": 1}`` over an
NCCL group of world size 1 it opens and closes): 16 replays, K4a-c each
depth x steps times, all sm90. ``control/train_dqn.py --steps 300``
(300 replays, a mean return printed), ``control/train_reinforce.py`` and
``densityopt/densityopt.py`` (3 iterations each, ``mu`` printed, finite).

The last lines of standard output are the kernels JSON object and the
device JSON object ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SHAPE = (480, 640)
BATCH = 8
CHUNK = 4
# Windows of a few seconds: the captured steps run at ~5000 img/s alone,
# so a leg is producer-bound live, and the frames the producers queued
# while the first step was captured (0.1-1.6 s) are drained by the
# warm-up steps, not counted in the window (96 flagship steps lasted 1.8 s
# and 24 square steps 0.4 s, both read above the producers' own rate)
FLAGSHIP = {"tile": (16, 32), "capacity": 160, "steps": 192, "warmup": 64}
SQUARE = {"tile": (16,), "capacity": 288, "steps": 96, "warmup": 32}
STREAMFORMER = {"tile": (16, 32), "capacity": 160, "steps": 16, "warmup": 2}
# bench.py:measure_live_echo at one echo factor
# (1024 measured steps after 128 warm-up steps, not the bench's 24: at
# ~3000 img/s into the step 384 steps lasted 0.9-1.0 s and read a fresh
# rate above the producers' own, the backlog of the step's capture)
ECHO = {"tile": (16, 32), "capacity": 160, "steps": 1024, "warmup": 128,
        "reservoir": 256, "max_echo_factor": 4}
# the input side (phase 5c): the flagship stream and step; the A/B runs
# alternate one ingest thread and two shards, four producers each (128
# steps after 32 of warm-up lasted ~1 s at ~4000 img/s: windows that short
# read the backlog of the first capture, so they are longer)
INGEST = {"tile": (16, 32), "capacity": 160, "steps": 320, "warmup": 64,
          "order": (1, 2, 2, 1)}
# captured steps the equality leg runs on each route's groups
EQUALITY_STEPS = 10
# the replay leg: the flagship live leg records its first messages
# (``record``, 48 chunk groups), keeps its first ``compare`` groups and
# their losses, and the recording replays in a loop into a fresh captured
# flagship step from the same initial weights
REPLAY = {"record": 48 * CHUNK, "compare": 24, "steps": 384, "warmup": 64}
# the resume phase: drivers built with TrainDriver.build (captured ladder)
# on decoded replay batches; A trains ``steps`` with a snapshot every
# ``every``, B resumes from A's newest and trains as many again; then
# step time without and with snapshots, ``window`` steps each, in the
# order plain, snapshots, snapshots, plain (a 32-step window lasted 55 ms,
# shorter than one snapshot write)
RESUME = {"steps": 32, "every": 8, "window": 512}
# bench.py:1080-1082, with the flash backend named explicitly
FORMER = {"patch": 20, "dim": 512, "depth": 8, "num_heads": 4,
          "num_outputs": 16}
# the long-sequence shape of bench.py:1146 (960x1280 frames -> 3072 tokens)
LONG_ATTN = (4, 3072)
# the mesh phase (phase 5g), NCCL at world size 1 on the card: the live
# flagship leg through MeshTrainDriver (fewer steps than the single-card
# flagship leg: it proves the path, the flagship leg measures the rate),
# then the sequence-parallel legs of the full-width StreamFormer on the
# flagship recording, eager and captured (every K4 launch counted through
# Ulysses, per replay in the captured run)
MESH_FLAGSHIP = {"tile": (16, 32), "capacity": 160, "steps": 96, "warmup": 32}
MESH_SP = {"steps": 16, "warmup": 2}
# phase 5g's echo step over a ring sharded on {"data": 1}: the ring's
# frames (seeded) and the draws of each run, eager and captured
ECHO_MESH = {"capacity": 64, "steps": 8}
# phase 5h: the streamformer leg's configuration with Switch MoE MLPs in
# blocks 0, 2, 4, 6 (4 experts) on the flagship stream through the
# captured fused step (its step budget), the dense model under remat on
# the streamformer leg's recorded groups, and one full-width Block per
# pipeline stage (M microbatches of the flagship's token count)
MOE_FORMER = {**FORMER, "num_experts": 4, "moe_every": 2}
PIPE = {"microbatches": 4, "rows": 8}
# phase 5i: the reference's live RL leg (bench.py:3504-3600): 2 cartpole
# producers, reservoir 512, QNetwork (32, 32) x 3 actions, Adam 1e-3,
# gamma 0.98, batch 32, min_fill 64, sync_every 8, inflight 2,
# HostQPolicy(3, eps_steps=1500), actions [-2, 0, 2], 300 learner steps
RL = {"envs": 2, "capacity": 512, "hidden": (32, 32), "lr": 1e-3,
      "gamma": 0.98, "batch": 32, "min_fill": 64, "sync_every": 8,
      "inflight": 2, "eps_steps": 1500, "steps": 300, "warmup": 3}
RL_ACTIONS = (-2.0, 0.0, 2.0)
# bench.py:196: well below a random policy's return on this cartpole
RL_RETURN_FLOOR = 15.0
# the learner outruns the actors (1-2 episodes ended in a 300-step window
# on an H100, PERF.md): after the window the actors run on with the
# last policy until this many episodes have ended, or for at most
# RL_EPISODE_WAIT_S, so the return gate reads more than one episode
RL_EPISODES = 8
RL_EPISODE_WAIT_S = 30.0
# the resume leg: a snapshot every 4 learner steps, stopped after the first
# commit, continued to this step budget in a fresh stack
RL_RESUME = {"every": 4, "budget": 48}
PG_STEPS = 4
# the split DQN state: a replicated run, and one split over {"data": 1,
# "fsdp": 1} eager and captured, this many steps each on scripted
# transitions; the split runs' losses within the port's RL loss bar
# (tests/test_torch_rl.py TOL_LOSS, relative) of the replicated run's
RL_MESH = {"steps": 16, "loss_rel": 1e-5}
# K4's existing bar (the streamformer leg's flash against xla loss bar)
K4_LOSS_REL = 1e-2
# ring attention's losses against the flash kernels' in bf16: the bar
# tests/test_torch_parallel.py states (BF16_LOSS_REL) for a ring of 2 hops
BF16_LOSS_REL = 2e-2
# at world size 1 the ring runs one block with no hop (exact attention
# with an f32 softmax), so the card holds it to a bar set from its
# readings: rel 3.3e-6 to 5.2e-6 on an H100 (PERF.md); the multi-hop
# streaming correction and the P2P path are shown by the gloo tests only
RING_ONE_BLOCK_REL = 1e-4
# steps of each step builder run eagerly and through its graph from one
# state in the graph-parity phase
PARITY_STEPS = 4
# Phase 5j (bench.py's measure_live_scenario and measure_live_fleet, and
# densityopt's critic). Scoring: the full-width Discriminator on a batch of
# SupershapeScene frames at its default shape, and on a few at an odd size
# (250 -> 125 -> 63: SAME padding pads unevenly there); the card's bf16
# logits against the plain path's f32 ones on the CPU, within DISC_REL of
# the largest (at least 1): about 3x the gap read on an H100 (5.0e-3)
DISC = {"batch": 32, "shape": (256, 256), "odd_batch": 8,
        "odd_shape": (250, 250), "mu": (6.0, 1.0), "log_sigma": (-0.7, -1.6),
        "reps": 5, "windows": 5, "placements": 3}
DISC_REL = 1.5e-2
# Scenario: 2 rate-capped synthetic producers at 32x32 (xy_jitter is half
# the side: the curriculum gate is calibrated to it), the bench's spec;
# 160 steps (the bench's 40, lengthened: the frames queued while the first
# step captures its graph drain within ~40 steps, and the second half of
# the window reads the settled rate)
SCENARIO = {"producers": 2, "shape": (32, 32), "batch": 4, "rate": 60.0,
            "train_batch": 8, "capacity": 64, "max_echo_factor": 4,
            "every_steps": 10, "min_rows": 4, "min_steps": 160,
            "time_cap": 20.0,
            "spec": "easy:half_extent=u(0.8,1.2) / "
                    "hard:half_extent=u(0.8,1.2),xy_jitter=16"}
# Fleet: a fixed fleet of 2 producers capped at 40 frames/s against an
# autoscaled one from 1 (at most 4), the controller ticking every 0.5 s;
# 10 s per leg (the bench's 12, cut to keep the phase near a minute)
FLEET = {"shape": (32, 32), "batch": 4, "rate": 40.0, "max": 4,
         "time_cap": 10.0, "tick_s": 0.5}
# Device-memory rates for the bytes bound (NVIDIA data sheets); an
# unlisted H100 name takes the SXM part's 3.35 TB/s.
HBM_BYTES_PER_S = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12),
                   ("H200", 4.8e12), ("H100", 3.35e12))
PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense tensor cores


def log(msg: str) -> None:
    print(f"chip_smoke: {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def hbm_rate(name: str) -> float:
    for key, rate in HBM_BYTES_PER_S:
        if key in name:
            return rate
    return 3.35e12


# clock rate for torch.cuda._sleep's cycle count: above the H100's boost
# clock, so a sleep lasts at least as long as asked
SLEEP_HZ = 2.0e9


def time_ms(fn, reps: int = 20, windows: int = 15) -> dict:
    """Per-call device time (CUDA events) of ``windows`` windows of
    ``reps`` back-to-back calls, after a warm-up: ``{"ms": median,
    "min_ms", "max_ms"}`` over the windows, so a reading shows its own
    spread, and ``host_ms``, the host's time to enqueue one call. Each
    window starts behind a sleep kernel that outlasts the host's enqueue
    of its calls, so the card runs them back to back and the events time
    the card, not the host (a call that synchronises inside is timed with
    its host part all the same)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    cycles = int(max(2.0 * host * reps, 1e-4) * SLEEP_HZ)
    samples = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    samples.sort()
    return {"ms": samples[len(samples) // 2], "min_ms": samples[0],
            "max_ms": samples[-1], "host_ms": host * 1e3}


# inputs a rotating timing cycles through: at the echo batch, 6 x (9.8 MB in
# + 39.3 MB f32 out) is about six times the H100's 50 MB L2
L2_ROUNDS = 6


def rotating(fn, inputs):
    """A call of ``fn`` on each of ``inputs`` in turn, whose result is kept
    until that input comes round again, so a call finds neither its input
    nor its output block in L2 when the rounds together outgrow it (a
    repeated call on one input reads it from L2 and is handed back the
    output block it just wrote)."""
    ring = [None] * len(inputs)
    turn = [0]

    def call():
        i = turn[0] % len(inputs)
        turn[0] += 1
        ring[i] = fn(inputs[i])

    return call


def spread(t: dict) -> str:
    return f"{t['ms']:.4f} ms [{t['min_ms']:.4f}-{t['max_ms']:.4f}]"


def sass_counts(name: str, opcodes) -> dict:
    """How many instructions of each SASS opcode the built library of
    kernel source ``name`` holds (``cuobjdump -sass``)."""
    import re
    import shutil

    from blendjax_torch.kernels.build import library_path, nvcc_path

    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", text)) for op in opcodes}


# -- phase 3: kernels -----------------------------------------------------------


def make_case(b, k, h, w, c, th, tw, seed, ct=None, sentinel_row=False,
              device="cuda"):
    """Random reference tiles, distinct changed indices per row (between
    60% of K and K of them, the rest sentinels), random tiles."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    n = (h // th) * (w // tw)
    ref_tiles = rng.integers(0, 256, (n, th, tw, c), dtype=np.uint8)
    idx = np.full((b, k), n, np.int32)
    for i in range(b):
        kk = int(rng.integers(int(0.6 * k), k + 1)) if k else 0
        if sentinel_row and i == b - 1:
            kk = 0
        idx[i, :kk] = rng.choice(n, size=min(kk, n), replace=False)
    tiles = rng.integers(0, 256, (b, k, th, tw, ct or c), dtype=np.uint8)
    tiles[idx == n] = 0
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return to(ref_tiles), to(idx), to(tiles)


def kernel_phase(bw: float) -> dict:
    """Bit-exact checks and timings; returns per-kernel measurements."""
    import torch

    from blendjax_torch.kernels import (
        decode_scatter,
        decode_scatter_plain,
        decode_spatial,
        decode_spatial_plain,
    )
    from blendjax_torch.kernels.work import decode_work
    from blendjax_torch.ops.tiles import decode_tile_delta

    h, w = SHAPE
    b = BATCH * CHUNK
    # edge cases through the dispatching decode, card vs CPU twins
    cases = [
        ("K1 (16,32)x4 Ct<C", (b, 160, h, w, 4, 16, 32), {"ct": 3}),
        ("K1 (16,32)x4 sentinel row", (b, 160, h, w, 4, 16, 32),
         {"sentinel_row": True}),
        ("K1 K==0", (b, 0, h, w, 4, 16, 32), {}),
        ("K1 byte-wide (16,10)x4", (4, 96, h, w, 4, 16, 10), {}),
        ("K2 16x16x4 Ct<C", (b, 288, h, w, 4, 16, 16), {"ct": 3}),
        ("K2 16x16x4 sentinel row", (b, 288, h, w, 4, 16, 16),
         {"sentinel_row": True}),
        ("K2 K==0", (b, 0, h, w, 4, 16, 16), {}),
        ("K2 byte-wide 5x5x4", (4, 400, h, w, 4, 5, 5), {}),
    ]
    for i, (label, (cb, ck, ch, cw, cc, th, tw), kw) in enumerate(cases):
        ref, idx, tiles = make_case(cb, ck, ch, cw, cc, th, tw, 100 + i, **kw)
        got = decode_tile_delta(ref, idx, tiles, (ch, cw, cc))
        want = decode_tile_delta(ref.cpu(), idx.cpu(), tiles.cpu(),
                                 (ch, cw, cc))
        torch.cuda.synchronize()
        if not torch.equal(got.cpu(), want):
            fail(f"kernel edge case {label}: card result != plain twin")
        log(f"kernel check {label}: bit-exact")
    # K2 on indices outside [0, N) (each writes nothing), and on rows whose
    # K spans many of the kernel's 16-slot runs, wrapper against plain twin
    ref, idx, tiles = make_case(b, 288, h, w, 4, 16, 16, seed=120)
    n = ref.shape[0]
    bad = {"negative indices": [-1, -2, -n, -(2**31)],
           "indices past N": [n + 1, 2 * n, 2**31 - 1]}
    for label, values in bad.items():
        cut = idx.clone()
        cut[:, -len(values):] = torch.tensor(values, dtype=torch.int32,
                                             device=idx.device)
        got = decode_scatter(ref, cut, tiles)
        want = decode_scatter_plain(ref.cpu(), cut.cpu(), tiles.cpu())
        torch.cuda.synchronize()
        if not torch.equal(got.cpu(), want):
            fail(f"K2 with {label}: card result != plain twin")
        log(f"kernel check K2 16x16x4 with {label} (K 288 over 75 slot "
            "runs of 16): bit-exact")

    out = {}
    # K1 at the flagship shapes
    ref, idx, tiles = make_case(b, 160, h, w, 4, 16, 32, seed=1)
    got = decode_spatial(ref, idx, tiles, (h, w, 4))
    want = decode_spatial_plain(ref, idx, tiles, (h, w, 4))
    if not torch.equal(got, want):
        fail("decode_spatial != decode_spatial_plain at the main-path shapes")
    n = ref.shape[0]
    valid = int(((idx >= 0) & (idx < n)).sum())
    ttc = ref[0].numel()
    _f, moved = decode_work(n, ttc, idx.numel(), valid, got.numel())
    out["decode_spatial"] = {
        "max_abs_err": int((got.int() - want.int()).abs().max()),
        **time_ms(lambda: decode_spatial(ref, idx, tiles, (h, w, 4))),
        "plain_ms": time_ms(
            lambda: decode_spatial_plain(ref, idx, tiles, (h, w, 4)), reps=5
        )["ms"],
        "bound_ms": moved / bw * 1e3, "bound_by": "bytes",
        "library_ms": None,
        "shapes": f"B={b} K=160 (16,32)x4 at {h}x{w}, {valid} changed tiles",
    }
    # K2 at the square-tile shapes
    ref, idx, tiles = make_case(b, 288, h, w, 4, 16, 16, seed=2)
    got = decode_scatter(ref, idx, tiles)
    want = decode_scatter_plain(ref, idx, tiles)
    if not torch.equal(got, want):
        fail("decode_scatter != decode_scatter_plain at the main-path shapes")
    n = ref.shape[0]
    ttc = ref[0].numel()
    ok = (idx >= 0) & (idx < n)
    valid = int(ok.sum())
    _f, moved = decode_work(n, ttc, idx.numel(), valid, got.numel())
    flat_idx = (
        torch.arange(b, device=idx.device)[:, None] * n + idx.long()
    )[ok]
    changed = tiles.reshape(b, -1, ttc)[ok]
    slots = want.clone().reshape(b * n, ttc)
    base = ref.reshape(1, n, ttc).expand(b, n, ttc)

    def two_calls():  # the same function as K2, in two PyTorch calls
        fresh = torch.empty((b, n, ttc), dtype=torch.uint8, device=idx.device)
        fresh.copy_(base)
        return fresh.view(b * n, ttc).index_copy_(0, flat_idx, changed)

    if not torch.equal(two_calls().view(b, n, ttc), want):
        fail("the two-call K2 yardstick != decode_scatter_plain")
    two = time_ms(two_calls)
    out["decode_scatter"] = {
        "max_abs_err": int((got.int() - want.int()).abs().max()),
        **time_ms(lambda: decode_scatter(ref, idx, tiles)),
        "plain_ms": time_ms(
            lambda: decode_scatter_plain(ref, idx, tiles), reps=5
        )["ms"],
        "bound_ms": moved / bw * 1e3, "bound_by": "bytes",
        # one call writing the changed tiles into already initialised slots
        "library_ms": time_ms(
            lambda: slots.index_copy_(0, flat_idx, changed)
        )["ms"],
        "library_call": "Tensor.index_copy_ of the changed tiles into "
                        "initialised slots (the slot initialisation, half "
                        "of K2's function, excluded)",
        "two_call_ms": two["ms"], "two_call_spread": spread(two),
        "shapes": f"B={b} K=288 16x16x4 at {h}x{w}, {valid} changed tiles",
    }
    torch.cuda.synchronize()
    for name, m in out.items():
        log(
            f"kernel {name}: bit-exact vs plain twin; {m['shapes']}; "
            f"kernel {spread(m)} (median [min-max window], card time behind "
            f"a sleep), host enqueue {m['host_ms']:.4f} ms per call; bound "
            f"{m['bound_ms']:.4f} ms (bytes / {bw / 1e12:.2f} TB/s), plain "
            f"twin {m['plain_ms']:.4f} ms (no yardstick), library "
            f"{m['library_ms'] if m['library_ms'] is None else round(m['library_ms'], 4)} ms"
        )
    m = out["decode_scatter"]
    log(f"kernel decode_scatter yardsticks: {m['library_call']}: "
        f"{m['library_ms']:.4f} ms; the same function as K2 in two calls "
        f"(copy_ of the broadcast reference into torch.empty slots, then "
        f"index_copy_ of the changed tiles): {m['two_call_spread']}; K2 "
        f"(one launch writing every slot once): {spread(m)}")
    return out


# -- phase 3b: flash-attention kernels ------------------------------------------

# (label, B, Tq, Tk, H, D, dtype name, causal)
ATTN_CASES = [
    ("slice", 8, 768, 768, 4, 128, "bf16", False),
    ("causal", 8, 768, 768, 4, 128, "bf16", True),
    ("Tq 256 != Tkv 768", 8, 256, 768, 4, 128, "bf16", False),
    ("ragged T 700, causal", 8, 700, 700, 4, 128, "bf16", True),
    ("D 64", 8, 768, 768, 8, 64, "bf16", False),
    ("f32", 2, 768, 768, 4, 128, "f32", False),
]
ATTN_OUTPUTS = {"flash_attention_fwd": ("o",),
                "flash_attention_bwd_dkv": ("dk", "dv"),
                "flash_attention_bwd_dq": ("dq",)}


def attn_inputs(b, tq, tk, h, d, dtype, seed):
    """q, k, v as the (B, T, H, D) views of one (B, T, 3, H, D) buffer, as
    the model's qkv projection makes them, and do; N(0, 1)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, max(tq, tk), 3, h, d), generator=gen,
                      device="cuda").to(dtype)
    do = torch.randn((b, tq, h, d), generator=gen, device="cuda").to(dtype)
    return qkv[:, :tq, 0], qkv[:, :tk, 1], qkv[:, :tk, 2], do


def bound(flops: float, moved: float, bw: float) -> tuple:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, moved / bw
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def attention_phase(bw: float) -> dict:
    """K4a-c against their plain versions at every case, the backward's
    determinism, then timings at the slice's shape and the long-sequence
    shape."""
    import torch
    import torch.nn.functional as F

    from blendjax_torch.kernels import attention as K
    from blendjax_torch.kernels.work import attention_work

    torch.backends.cuda.matmul.allow_tf32 = False
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    wrappers = {"flash_attention_fwd": K.flash_attention_fwd,
                "flash_attention_bwd_dkv": K.flash_attention_bwd_dkv,
                "flash_attention_bwd_dq": K.flash_attention_bwd_dq}
    errs = {}
    for i, (label, b, tq, tk, h, d, dt, causal) in enumerate(ATTN_CASES):
        q, k, v, do = attn_inputs(b, tq, tk, h, d, dtypes[dt], 200 + i)
        want_variant = ("sm90" if dt == "bf16" and d in K.SM90_HEAD_DIMS
                        else "simple")
        before = {name: fn.launches_by_variant[want_variant]
                  for name, fn in wrappers.items()}
        o, lse = K.flash_attention_fwd(q, k, v, causal)
        o_ref, lse_ref = K.flash_attention_fwd_plain(q, k, v, causal)
        di = K.attention_delta(o, do)
        got = {
            "flash_attention_fwd": (o,),
            "flash_attention_bwd_dkv": K.flash_attention_bwd_dkv(
                q, k, v, do, lse, di, causal),
            "flash_attention_bwd_dq": (K.flash_attention_bwd_dq(
                q, k, v, do, lse, di, causal),),
        }
        for name, fn in wrappers.items():
            if fn.launches_by_variant[want_variant] != before[name] + 1:
                fail(f"{name} {label}: did not run the {want_variant} variant")
        want = {
            "flash_attention_fwd": (o_ref,),
            "flash_attention_bwd_dkv": K.flash_attention_bwd_dkv_plain(
                q, k, v, do, lse, di, causal),
            "flash_attention_bwd_dq": (K.flash_attention_bwd_dq_plain(
                q, k, v, do, lse, di, causal),),
        }
        torch.cuda.synchronize()
        bar = 2e-2 if dt == "bf16" else 1e-4
        lse_err = float((lse - lse_ref).abs().max())
        if not lse_err <= 1e-3:
            fail(f"flash fwd {label}: lse differs from plain by {lse_err}")
        notes = []
        for name in got:
            for out_name, g, w in zip(ATTN_OUTPUTS[name], got[name], want[name]):
                err = float((g.float() - w.float()).abs().max())
                top = float(w.float().abs().max())
                # the forward's bar is absolute (N(0, 1) inputs), the
                # gradients' relative to the largest plain value
                limit = bar if name == "flash_attention_fwd" else bar * top
                if not (math.isfinite(err) and err <= limit):
                    fail(f"{name} {label}: {out_name} max |diff| {err} > {limit}")
                if label == "slice":
                    errs[name] = max(errs.get(name, 0.0), err)
                notes.append(f"{out_name} {err:.3g}/{limit:.3g}")
        log(f"kernel check flash {label} (B={b} Tq={tq} Tk={tk} H={h} D={d} "
            f"{dt}{' causal' if causal else ''}; variant {want_variant} for "
            f"all three): max |diff| / bar: {', '.join(notes)}; lse "
            f"{lse_err:.3g}")
        if label == "slice":
            # no atomics: a second call gives the same bits
            again = (*K.flash_attention_bwd_dkv(q, k, v, do, lse, di, causal),
                     K.flash_attention_bwd_dq(q, k, v, do, lse, di, causal))
            first = (*got["flash_attention_bwd_dkv"],
                     *got["flash_attention_bwd_dq"])
            for out_name, x, y in zip(("dk", "dv", "dq"), first, again):
                if not torch.equal(x, y):
                    fail(f"flash backward {label}: two calls gave different "
                         f"{out_name}")
            log(f"kernel check flash {label}: two calls of each backward "
                "kernel give bit-identical dk, dv and dq")

    out = {}
    for shape_name, (b, t) in (("slice", (8, 768)), ("long", LONG_ATTN)):
        h, d = 4, 128
        q, k, v, do = attn_inputs(b, t, t, h, d, torch.bfloat16, 300)
        o, lse = K.flash_attention_fwd(q, k, v)
        di = K.attention_delta(o, do)
        bwd = (q, k, v, do, lse, di)
        timed = {
            "flash_attention_fwd": (
                lambda: K.flash_attention_fwd(q, k, v),
                lambda: K.flash_attention_fwd_plain(q, k, v)),
            "flash_attention_bwd_dkv": (
                lambda: K.flash_attention_bwd_dkv(*bwd),
                lambda: K.flash_attention_bwd_dkv_plain(*bwd)),
            "flash_attention_bwd_dq": (
                lambda: K.flash_attention_bwd_dq(*bwd),
                lambda: K.flash_attention_bwd_dq_plain(*bwd)),
        }
        # the yardstick: one PyTorch call in its own (B, H, T, D) layout
        qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, k, v))
        doh = do.transpose(1, 2).contiguous()
        with torch.no_grad():
            sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
        oh = F.scaled_dot_product_attention(qh, kh, vh)
        sdpa_bwd = time_ms(lambda: torch.autograd.grad(
            oh, (qh, kh, vh), doh, retain_graph=True))
        # the formula each wrapper declares per launch (and the ledger sums)
        work = attention_work(b, t, t, h, d, 2)
        times = {}
        for name, (kernel, plain) in timed.items():
            kt = times[name] = time_ms(kernel)
            pt = time_ms(plain, reps=3, windows=5)
            flops, moved = work[name]
            bms, by = bound(flops, moved, bw)
            lib = sdpa_fwd if name == "flash_attention_fwd" else sdpa_bwd
            log(f"kernel {name} [{shape_name} B={b} T={t} H={h} D={d} bf16]: "
                f"{spread(kt)}, {flops / kt['ms'] / 1e9:.1f} TFLOP/s = "
                f"{flops / kt['ms'] * 1e3 / PEAK_BF16_FLOPS:.1%} of 989 "
                f"TFLOP/s; wrapper host time {kt['host_ms']:.4f} ms per call; "
                f"bound {bms:.4f} ms ({by}: {flops / 1e9:.2f} GFLOP, "
                f"{moved / 1e6:.2f} MB); plain {pt['ms']:.4f} ms; SDPA "
                f"{'forward' if lib is sdpa_fwd else 'autograd backward (K4b+K4c together)'} "
                f"{spread(lib)}")
            m = {**kt, "plain_ms": pt["ms"], "bound_ms": bms, "bound_by": by,
                 "library_ms": lib["ms"]}
            if shape_name == "slice":
                out[name] = {"max_abs_err": errs[name], **m}
            else:
                out[name]["long"] = {"shape": [b, t, h, d], **m}
        bwd_ms = (times["flash_attention_bwd_dkv"]["ms"]
                  + times["flash_attention_bwd_dq"]["ms"])
        log(f"kernel flash backward [{shape_name}]: K4b + K4c {bwd_ms:.4f} ms "
            f"against SDPA's autograd backward {sdpa_bwd['ms']:.4f} ms "
            f"({bwd_ms / sdpa_bwd['ms']:.2f}x)")
        del qh, kh, vh, oh
    torch.cuda.synchronize()
    return out


# -- phase 4: the slice ---------------------------------------------------------


def start_producers(tmp: str, tile, capacity: int, count: int = 2,
                    wire: str = "raw"):
    """``count`` cube producers on the flagship stream, publishing on
    ``wire``; returns their processes, addresses and stderr log files.
    Their shared-memory rings (``--wire shm``) are registered in the
    leg's directory, for :func:`reap_segments` after they stop."""
    from blendjax_torch.transport import REGISTRY_ENV

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    )
    procs = []
    # a fresh directory per leg: an address file left by an earlier leg's
    # (stopped) producers must never be read as this leg's
    leg_dir = tempfile.mkdtemp(dir=tmp)
    env[REGISTRY_ENV] = os.path.join(leg_dir, "shm")
    for i in range(count):
        addr_file = os.path.join(leg_dir, f"producer{i}.addr")
        log_file = os.path.join(leg_dir, f"producer{i}.log")
        cmd = [
            sys.executable, "-m", "blendjax_torch.producer.cube",
            "--addr-file", addr_file, "--btid", str(i), "--seed", str(i),
            "--shape", str(SHAPE[0]), str(SHAPE[1]), "--batch", str(BATCH),
            "--encoding", "tile", "--tile", *map(str, tile), "--tile-rgba",
            "--tile-capacity", str(capacity), "--wire", wire,
        ]
        with open(log_file, "w") as log:
            proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stderr=log)
        procs.append((proc, addr_file, log_file))
    addrs = []
    deadline = time.monotonic() + 120
    for proc, addr_file, log_file in procs:
        while not os.path.exists(addr_file):
            if proc.poll() is not None:
                with open(log_file) as f:
                    print(f.read(), file=sys.stderr)
                fail(f"producer exited with {proc.returncode} before binding")
            if time.monotonic() > deadline:
                fail("producer did not bind within 120 s")
            time.sleep(0.05)
        with open(addr_file) as f:
            addrs.append(f.read().strip())
    return [p for p, _, _ in procs], addrs, [log for _, _, log in procs]


def stop_producers(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def reap_segments(logs) -> int:
    """Unlink the shared-memory rings the (stopped) producers of a leg
    registered; returns how many there were."""
    from blendjax_torch.transport import reap_registry

    return reap_registry(os.path.join(os.path.dirname(logs[0]), "shm"))


def producer_watch(label: str, procs, logs):
    """A stream ``on_timeout`` hook: a producer that died (its shared-
    memory ring could not be made, say) fails the leg with the end of its
    log; with every producer alive the timeout is raised."""
    def on_timeout():
        for proc, log in zip(procs, logs):
            if proc.poll() is not None:
                with open(log) as f:
                    tail = f.read()[-2000:]
                fail(f"{label}: producer {log} exited with "
                     f"{proc.returncode}:\n{tail}")
        return False

    return on_timeout


PRODUCER_LINE = "blendjax_torch.producer.cube "


def producer_report(label: str, logs) -> dict:
    """Each stopped producer's path (its start-up line) and its last stats
    line; fails unless every producer ran the host C++ path and, on these
    full-RGBA (``--tile-rgba``) streams, the fused per-frame palette path
    (``fused``). Returns the per-producer stats and the sum of their own
    rates (``own_frames_s``: frames over the time spent rendering and
    encoding)."""
    stats = []
    for log in logs:
        with open(log) as f:
            lines = [ln[len(PRODUCER_LINE):].strip() for ln in f
                     if ln.startswith(PRODUCER_LINE)]
        paths = [ln for ln in lines if ln.startswith("path ")]
        if len(paths) != 1 or not paths[0].startswith("path native"):
            fail(f"{label}: producer {log} reported {paths}, not one "
                 "'path native' line (the host C++ path)")
        last = [ln for ln in lines if ln.startswith("stats ")][-1:]
        stats += [json.loads(ln[len("stats "):]) for ln in last]
        if last and stats[-1].get("fused") is not True:
            fail(f"{label}: producer {log} did not take the fused per-frame "
                 f"palette path on --tile-rgba: {stats[-1]}")
    out = {"path": "native", "producers": stats}
    if len(stats) == len(logs):
        out["own_frames_s"] = sum(s["own_frames_s"] for s in stats)
    return out


def producer_text(rep: dict) -> str:
    if "own_frames_s" not in rep:
        return "producers: path native, frames/s not measured (no stats line)"
    each = ", ".join(
        f"{s['own_frames_s']:.1f} ({s['render_ms']:.3f} ms render + "
        f"{s['encode_ms']:.3f} ms encode per frame; publish "
        f"{s['publish_ms']:.3f} ms)" for s in rep["producers"])
    sizes = ", ".join(
        f"{s['msg_bytes'] * 8 / s['frames_per_msg'] / 1e3:.1f} kB"
        for s in rep["producers"])
    return (f"producers: path native, fused per-frame palettes, "
            f"{rep['own_frames_s']:.1f} frames/s of their own (render + "
            f"encode) summed over {len(rep['producers'])}; each {each}; "
            f"message bytes per 8 frames (arrays, the reference left out) "
            f"{sizes}")


KERNEL_GROUPS = (  # substring of a CUDA kernel's name -> its group
    ("flash_", "flash attention (K4a-c)"),
    ("decode_", "decode (K1/K2)"), ("build_inverse", "decode (K1/K2)"),
    ("copy_footprints", "decode (K1/K2)"), ("scatter_tiles", "decode (K1/K2)"),
    ("convol", "convolution"), ("conv2d", "convolution"),
    ("conv_", "convolution"), ("cudnn", "convolution"),
    ("fprop", "convolution"), ("dgrad", "convolution"),
    ("wgrad", "convolution"),
    ("gemm", "matrix products"), ("xmma", "matrix products"),
    ("nvjet", "matrix products"),
    ("cutlass", "matrix products"), ("sm90_", "matrix products"),
    ("adam", "optimizer"), ("foreach", "optimizer"),
)


def profile_step(step, state, batch, graph: bool = False) -> dict:
    """One step call under ``torch.profiler``, through the port's guarded
    ``blendjax_torch.utils.metrics.trace`` (one profiler per process): the
    wall time, the device time summed over every CUDA kernel (its busy
    share of the wall) and that time by kernel group (``KERNEL_GROUPS``;
    the hand-written kernels show under their CUDA names), largest first.
    For a graph replay (``graph=True``) whose kernels the profiler does
    not record, the device time is read from CUDA events around a second
    call instead (``source``: "profiler" or "events"; events time the
    stream from the replay's first kernel to its last, gaps included)."""
    import torch
    from torch.autograd import DeviceType

    from blendjax_torch.utils.metrics import trace

    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as logdir, trace(logdir) as prof:
        if prof is None:
            fail("profile_step: another profiler trace is open")
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups, kernels, busy = {}, 0, 0.0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        ms = ev.self_device_time_total / 1e3
        name = ev.key.lower()
        group = next((g for key, g in KERNEL_GROUPS if key in name),
                     "elementwise, reductions, copies")
        groups[group] = groups.get(group, 0.0) + ms
        kernels += ev.count
        busy += ms
    source = "profiler"
    if kernels == 0:
        if not graph:
            fail("the profiler recorded no CUDA kernel in a step call")
        source = "events"
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        step(state, batch)
        end.record()
        end.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        busy = start.elapsed_time(end)
    return {"wall_ms": wall_ms, "device_ms": busy, "kernels": kernels,
            "busy": busy / wall_ms, "source": source,
            "groups": dict(sorted(groups.items(), key=lambda kv: -kv[1]))}


def alone_ms(fn, reps: int) -> float:
    """Host wall ms per call of ``reps`` calls of ``fn`` between two
    synchronisations: a step's own rate, host and card together."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def graph_report(label: str, graph_step) -> dict:
    """What the captured step holds: signatures, capture ms each, the
    bytes of each graph's private pool, its replays and fallbacks."""
    from blendjax_torch.train.aot import pool_bytes

    graphs = [graph_step._graphs[s] for s in graph_step.signatures]
    rep = {
        "signatures": len(graphs),
        "capture_ms": [round(ms, 1) for ms in graph_step.capture_ms.values()],
        "pool_bytes": [pool_bytes(g) for g in graphs if g is not None],
        "graph_replays": graph_step.graph_replays,
        "aot_fallbacks": graph_step.aot_fallbacks,
        "host_launches": graph_step.host_launches,
    }
    log(f"{label} graphs: {rep['signatures']} signature(s), capture "
        f"{rep['capture_ms']} ms, private pools "
        f"{[round(b / 2**20, 1) for b in rep['pool_bytes']]} MiB, "
        f"{rep['graph_replays']} replays, {rep['aot_fallbacks']} fallbacks, "
        f"{rep['host_launches']} host launches per step call (input copies, "
        "generator seeds, the replay, the loss clone)")
    return rep


def step_report(label: str, step, graph_step, state, batch, images: int,
                reps: int) -> dict:
    """Eager and graph step alone in the same run on the same batch, with
    one profiled call of each."""
    eager_ms = alone_ms(lambda: step(state, batch), reps)
    graph_ms = alone_ms(lambda: graph_step(state, batch), 4 * reps)
    eager = profile_step(step, state, batch)
    graph = profile_step(graph_step, state, batch, graph=True)
    out = {"eager_ms": eager_ms, "graph_ms": graph_ms,
           "eager_img_s": images / eager_ms * 1e3,
           "graph_img_s": images / graph_ms * 1e3,
           "profile": eager, "graph_profile": graph,
           "graphs": graph_report(label, graph_step)}
    log(f"{label} step alone: eager {eager_ms:.3f} ms "
        f"({out['eager_img_s']:.1f} img/s), graph {graph_ms:.3f} ms "
        f"({out['graph_img_s']:.1f} img/s), {eager_ms / graph_ms:.2f}x; "
        f"kernels per step call: eager {eager['kernels']} host launches, "
        f"graph {graph['kernels'] or 'not recorded by the profiler'} kernels "
        f"from {out['graphs']['host_launches']} host launches; device busy "
        f"eager {eager['device_ms']:.2f} of {eager['wall_ms']:.2f} ms "
        f"({eager['busy']:.1%}, profiler), graph {graph['device_ms']:.2f} of "
        f"{graph['wall_ms']:.2f} ms ({graph['busy']:.1%}, {graph['source']})")
    return out


def plan_groups(tile, capacity: int) -> list:
    """Packed groups of every plan signature a cube stream of this
    geometry makes on the fused per-frame palette path: K' = 1..CHUNK
    groups of 2-bit messages and of 4-bit ones (a batch whose frames hold
    5-16 colours; no cube frame has shown more than 16). The per-frame
    form picks each message's index width, and a width change splits a
    chunk group as a non-tile message does, so a live stream reaches all
    of these signatures, some of them rarely."""
    import numpy as np

    from blendjax_torch.data import StreamDataPipeline
    from blendjax_torch.ops.tiles import TILEPAL_SUFFIXES, TILEREF_SUFFIX
    from blendjax_torch.producer import CubeScene, TileBatchPublisher

    scene = CubeScene(shape=SHAPE, seed=0)
    cap = _Capture()
    tile = tile[0] if len(tile) == 1 else tuple(tile)  # as the producer reads it
    tiles = TileBatchPublisher(cap, scene.background_image(), BATCH,
                               tile=tile, alpha_slice=False, capacity=capacity)
    by_bits = {2: [], 4: []}
    framebuf = np.empty((*SHAPE, 4), np.uint8)
    frame = 1
    while min(len(v) for v in by_bits.values()) < CHUNK:
        if frame > 400 * BATCH:
            fail(f"plan groups: {[len(v) for v in by_bits.values()]} "
                 "messages of 2 and 4 bits in 400 batches")
        scene.step(frame)
        scene.render(out=framebuf)
        tiles.add(framebuf, hint=scene.raster.last_drawn,
                  xy=scene.camera.world_to_pixel(
                      scene.corners_world()).astype(np.float32),
                  frameid=np.int64(frame))
        frame += 1
        while cap.msgs:
            msg = cap.msgs.pop(0)
            for bits in by_bits:
                if "image" + TILEPAL_SUFFIXES[bits] in msg:
                    by_bits[bits].append(msg)
    ref = scene.background_image()
    groups = []
    for msgs in by_bits.values():
        for k in range(1, CHUNK + 1):
            part = [dict(m) for m in msgs[:k]]
            part[0]["image" + TILEREF_SUFFIX] = ref
            groups += list(StreamDataPipeline(iter(part), batch_size=BATCH,
                                              chunk=k, emit_packed=True))
    return groups


def prewarm(graph_step, state, leg: dict) -> None:
    """Capture every plan signature of the leg's stream before its window
    (``CapturedStep.prepare``: the state is left as it was)."""
    t0 = time.perf_counter()
    for group in plan_groups(leg["tile"], leg["capacity"]):
        graph_step.prepare(state, group)
    log(f"prewarm: {len(graph_step.signatures)} plan signatures captured in "
        f"{time.perf_counter() - t0:.2f} s")


class _FirstLosses:
    """A step wrapper that keeps the loss tensors of its first ``keep``
    calls (read after the run, so nothing here waits for the card)."""

    def __init__(self, step, keep: int):
        self.inner, self.keep, self.seen = step, keep, []
        # the driver's retrace audit and cost model read the captured step
        self._cache_size = step._cache_size
        self.signature_of = step.signature_of
        self.ledger_entries = step.ledger_entries

    def __call__(self, state, batch):
        state, m = self.inner(state, batch)
        if len(self.seen) < self.keep:
            self.seen.append(m["loss"])
        return state, m

    def values(self) -> list:
        """Every kept loss as floats, the chunk's updates in order."""
        return [x for v in self.seen for x in v.float().reshape(-1).tolist()]


def fresh_registry() -> None:
    """Zero the port's process-wide metrics, frame lineage and trace
    collector before a leg starts its producers: each leg's producers
    number from 0 again under the btids of the last leg's, which the
    lineage (kept per btid, as the JAX package's) would read as restarts,
    and each leg's stages and verdict read its own window."""
    from blendjax_torch.obs import lineage, tracer
    from blendjax_torch.utils.metrics import metrics

    metrics.reset()
    lineage.reset()
    tracer.reset()


def audit_verdict(label: str, audit) -> float:
    """Publish a leg's donation audit as the ``train.donation_reuse``
    gauge, print its report on the leg's line, and fail unless every
    audited label kept its buffers."""
    value = audit.publish()
    report = audit.report()
    log(f"{label}: train.donation_reuse {value} {json.dumps(report)}")
    if value != 1.0:
        moved = sorted(k for k, v in report.items() if not v["stable"])
        fail(f"{label}: the donation audit reads unstable for {moved}")
    return value


# -- the sync census: torch's own sync reports against the analyzer -----------

#: the rules whose findings (suppressed ones included) make a reported
#: sync site "flagged"
CENSUS_RULES = ("BJX102", "BJX106", "BJX108", "BJX111", "BJX115")
#: unflagged sync sites of hot modules that a rule allows by design, by
#: qualified name: (the rule, the sentence of its docstring that allows it)
CENSUS_SANCTIONED = {
    "blendjax_torch.train.driver.TrainDriver._sync_oldest": (
        "BJX106", "The sanctioned pattern is completion tracking: retire "
        "finished entries with non-blocking ``event.query()`` polls, block "
        "only on the entry dispatched ``inflight`` iterations back, and "
        "fetch losses at ``sync_every`` boundaries"),
    "blendjax_torch.rl.replay.TrajectoryReservoir._refresh_priorities": (
        "BJX115", "The sanctioned cadence-bounded syncs (the learner's "
        "policy snapshot copy, the reservoir's priority-mirror refresh) "
        "live in learner/replay modules, outside this rule's scope."),
}
#: waits torch's detector does not report (``cudaEventSynchronize``): each
#: leg prints the counters that count them instead
CENSUS_UNSEEN = ("Event.synchronize(): the driver's ring wait "
                 "(train.host_blocks) and the feeder's throttle wait "
                 "(feed.throttle_blocks)")
SYNC_WARNING = "synchronizing CUDA operation"


@functools.cache
def census_index(root: str = ROOT) -> tuple:
    """``({(relpath, line): [rule, ...]}, hot relpaths)`` of the port's
    tree: every finding of :data:`CENSUS_RULES`, inline-suppressed ones
    included (a justified suppression is a flagged site), and the modules
    any hot-path marker opts in."""
    from blendjax_torch.analysis.core import all_rules, parse_paths
    from blendjax_torch.analysis.rules import markers

    modules, errors = parse_paths([os.path.join(root, "blendjax_torch")],
                                  root=root)
    if errors:
        fail(f"census: the analyzer cannot parse {errors[0].render()}")
    rules = all_rules()
    found: dict = {}
    for m in modules:
        for rid in CENSUS_RULES:
            for f in rules[rid].check(m):
                found.setdefault((f.path, f.line), []).append(rid)
    hot = {m.relpath for m in modules
           if markers._is_hot(m) or markers._is_driver_hot(m)
           or markers._is_mesh_hot(m) or markers._is_actor_hot(m)}
    return found, hot


def census_site(frames, root: str = ROOT) -> tuple:
    """``(relpath, line, qualified name)`` of the innermost frame of
    ``frames`` (``(filename, line, co_qualname)``, innermost first) that
    lies in ``blendjax_torch/``; else of the innermost frame outside
    Python's ``warnings`` module."""
    outer = None
    for filename, line, qual in frames:
        rel = os.path.relpath(filename, root)
        if rel.startswith("blendjax_torch" + os.sep):
            mod = rel[:-3].replace(os.sep, ".")
            return rel.replace(os.sep, "/"), line, f"{mod}.{qual}"
        if outer is None and os.path.basename(filename) != "warnings.py":
            outer = (rel.replace(os.sep, "/"), line, qual)
    return outer or ("<unknown>", 0, "<unknown>")


def census_verdicts(sites, found: dict, hot: set) -> list:
    """One row per reported site: ``flagged`` (a finding, or a justified
    suppression, of :data:`CENSUS_RULES` on its line), ``sanctioned``
    (listed in :data:`CENSUS_SANCTIONED`), ``outside`` (no hot module) or
    ``unflagged`` (a hot module's sync no rule knows: the run fails)."""
    rows = []
    for (rel, line, qual), n in sorted(sites.items()):
        rules = found.get((rel, line))
        if rules:
            verdict, why = "flagged", "+".join(sorted(set(rules)))
        elif qual in CENSUS_SANCTIONED:
            verdict, why = "sanctioned", CENSUS_SANCTIONED[qual][0]
        elif rel not in hot:
            verdict, why = "outside", ""
        else:
            verdict, why = "unflagged", ""
        rows.append({"site": f"{rel}:{line}", "qual": qual, "count": n,
                     "verdict": verdict, "rule": why})
    return rows


class SyncCensus:
    """torch's sync debug mode (``"warn"``) over a leg's steady window,
    with the warnings caught process-wide (Python 3.12's
    ``catch_warnings`` swaps the module's global hook, so the drain and
    actor threads report here too); each reported sync is attributed
    by :func:`census_site` on the reporting thread's own stack.
    ``card=False`` catches the warnings without switching torch's mode
    (the CPU tests of the bookkeeping)."""

    def __init__(self, label: str, card: bool = True):
        import collections
        import threading

        self.label = label
        self.card = card
        self.sites = collections.Counter()
        self._lock = threading.Lock()
        self.active = False

    def _hook(self, message, category, filename, lineno, file=None,
              line=None):
        if SYNC_WARNING not in str(message):
            return self._show(message, category, filename, lineno, file,
                              line)
        frames = []
        f = sys._getframe(1)
        while f is not None:
            frames.append((f.f_code.co_filename, f.f_lineno,
                           f.f_code.co_qualname))
            f = f.f_back
        site = census_site(frames)
        with self._lock:
            self.sites[site] += 1

    def __enter__(self) -> "SyncCensus":
        import warnings

        import torch

        self._cm = warnings.catch_warnings()
        self._cm.__enter__()
        warnings.filterwarnings("always", message=f".*{SYNC_WARNING}")
        self._show = warnings.showwarning
        warnings.showwarning = self._hook
        if self.card:
            torch.cuda.set_sync_debug_mode("warn")
        self.active = True
        return self

    def __exit__(self, *exc) -> None:
        import torch

        if self.card:
            torch.cuda.set_sync_debug_mode("default")
        self._cm.__exit__(*exc)
        self.active = False

    def report(self, steps: int, host_blocks: int) -> dict:
        """Print the leg's census line; ``unflagged`` lists the sites that
        fail the run at its end (:func:`census_gate`)."""
        from blendjax_torch.utils.metrics import metrics

        found, hot = census_index()
        rows = census_verdicts(self.sites, found, hot)
        total = sum(self.sites.values())
        throttle = metrics.counter_value("feed.throttle_blocks")
        out = {"syncs": total, "steps": steps,
               "per_step": total / steps if steps else None,
               "host_blocks": host_blocks, "throttle_blocks": throttle,
               "sites": rows, "label": self.label,
               "unflagged": [r for r in rows if r["verdict"] == "unflagged"]}
        log(f"census {self.label}: {total} reported syncs in {steps} steps "
            f"({out['per_step']:.3f} per step); unseen by the detector: "
            f"{CENSUS_UNSEEN}: train.host_blocks {host_blocks}, "
            f"feed.throttle_blocks {throttle}; sites {json.dumps(rows)}")
        return out


def census_gate(*reports) -> None:
    """Fail on a hot-module site that no rule flags or sanctions, after
    every phase has run and printed."""
    bad = [f"census {r['label']}: {r['unflagged']}" for r in reports
           if r["unflagged"]]
    if bad:
        fail("sync sites in hot modules that no rule flags or sanctions: "
             + "; ".join(bad))


STAGE_PREFIXES = ("tiles.", "pal.", "rle.", "ingest.", "wire.", "train.",
                  "feed.", "decode.", "device.", "echo.", "trace.")
# the sampled trace's stages on the fused path, in order (the place stamp
# lands on the placed buffer, whose traces ride the group's plan: the
# fused path has no "place" and no "decode" stamp, as in the JAX package)
FUSED_STAGES = ("publish", "recv", "batch", "step_dispatch", "step_retire")


def stages_line(label: str, pipe, drv, full: bool = True) -> dict:
    """The counterpart of ``bench.py``'s stage breakdown: every span with
    its count, total and p50/p95/p99, the counters and gauges of the
    pipeline's families, per-producer lineage, the completed frame traces'
    per-transition percentiles and the doctor's verdict, printed as one
    ``stages`` JSON line (``full=False``: the verdict line only)."""
    from blendjax_torch.obs import lineage, tracer
    from blendjax_torch.utils.metrics import metrics

    rep = metrics.report()
    verdict = pipe.doctor(drv)
    out = {
        "leg": label,
        "spans": {k: {"count": v["count"], "total_s": round(v["total_s"], 6),
                      **{q: round(v[q], 4) for q in ("p50_ms", "p95_ms",
                                                      "p99_ms") if q in v}}
                  for k, v in sorted(rep["spans"].items())},
        "counters": {k: v for k, v in sorted(rep["counters"].items())
                     if k.startswith(STAGE_PREFIXES)},
        "gauges": {k: v for k, v in sorted(rep["gauges"].items())
                   if k.startswith(STAGE_PREFIXES)},
        "lineage": {btid: {
            "received": e["received"], "seq_gaps": e["seq_gaps"],
            "seq_reorders": e["seq_reorders"], "restarts": e["restarts"],
            "e2e_staleness_ms": e["e2e_staleness_ms"],
            "telemetry_age_s": e.get("telemetry_age_s"),
            "producer_frame_ms": (e.get("telemetry", {}).get("spans", {})
                                  .get("producer.frame")),
        } for btid, e in sorted(lineage.report().items())},
        "traces": tracer.report(),
        "doctor": verdict.render(),
    }
    if full:
        print(f"chip_smoke: stages {json.dumps(out)}", flush=True)
    else:
        log(f"{label} {verdict.render()}")
    return {"stages": out, "verdict": verdict, "report": rep}


class ObsLeg:
    """The observability surface around one live leg: span events on (for
    the Chrome trace), a ``StatsReporter`` ticking every
    ``interval_s`` into a JSONL file, and the Prometheus exporter on a
    free localhost port, scraped once mid-window (:meth:`scrape`)."""

    def __init__(self, directory: str, interval_s: float = 1.0):
        from blendjax_torch.obs import StatsReporter, start_http_exporter
        from blendjax_torch.utils.metrics import metrics

        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.jsonl = os.path.join(directory, "stats.jsonl")
        metrics.enable_span_events()
        self.reporter = StatsReporter(interval_s=interval_s,
                                      jsonl_path=self.jsonl)
        self.ticks = 0
        tick = self.reporter.tick

        def counted_tick():
            self.ticks += 1
            return tick()

        self.reporter.tick = counted_tick
        self.reporter.start()
        self.server = start_http_exporter(port=0)
        self.scraped = None

    def scrape(self) -> None:
        """One ``GET /metrics`` (the first call only)."""
        import urllib.request

        if self.scraped is None:
            url = f"http://127.0.0.1:{self.server.port}/metrics"
            with urllib.request.urlopen(url, timeout=10) as r:
                self.scraped = r.read().decode()

    def finish(self) -> dict:
        """Stop the reporter (its closing tick included) and the exporter,
        write the Chrome trace; returns the paths and the tick count."""
        from blendjax_torch.obs import write_chrome_trace
        from blendjax_torch.utils.metrics import metrics

        self.reporter.stop()
        self.server.close()
        chrome = os.path.join(self.dir, "trace.json")
        events = write_chrome_trace(chrome)
        metrics.disable_span_events()
        return {"jsonl": self.jsonl, "chrome": chrome, "events": events,
                "ticks": self.ticks, "scrape": self.scraped}


def obs_gates(label: str, leg: dict, producers: int) -> None:
    """The flagship leg's exact observability gates (see ``main``)."""
    import re

    rep = leg["obs"]["report"]
    checks = []
    for name, span in rep["spans"].items():
        h = rep["histograms"].get(name, {}).get("count")
        checks.append((h == span["count"],
                       f"span {name}: {span['count']} spans, histogram {h}"))
    lin = leg["obs"]["stages"]["lineage"]
    received = sum(e["received"] for e in lin.values())
    checks.append((received == leg["messages"],
                   f"lineage received {received} != stream messages "
                   f"{leg['messages']}"))
    bad = {b: e for b, e in lin.items()
           if e["seq_gaps"] or e["seq_reorders"] or e["restarts"]}
    checks.append((not bad and len(lin) == producers,
                   f"lineage gaps/reorders/restarts or producers: {lin}"))
    per = {}
    for tr in leg["obs"]["traces"]:
        names = [s[0] for s in tr["stages"]]
        mono = [float(s[1]) for s in tr["stages"]]
        if tuple(names) == FUSED_STAGES and mono == sorted(mono):
            per[tr["btid"]] = per.get(tr["btid"], 0) + 1
    checks.append((len(per) == producers,
                   f"complete frame traces per producer {per} (stages "
                   f"{FUSED_STAGES} in monotonic order)"))
    files = leg["obs"]["files"]
    with open(files["chrome"]) as f:
        chrome = json.load(f)["traceEvents"]
    checks.append((any(e.get("cat") == "frame_trace" for e in chrome),
                   "the Chrome trace has no frame_trace lane"))
    scrape = files["scrape"] or ""
    sample = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? "
                        r"[-+]?[0-9.]+([eE][-+]?[0-9]+)?$|^[a-zA-Z_:].* "
                        r"[-+]?(inf|Inf|nan|NaN)$")
    unparsed = [ln for ln in scrape.splitlines()
                if ln and not ln.startswith("# TYPE ") and not sample.match(ln)]
    checks.append((scrape and not unparsed
                   and re.search(r"^blendjax_train_dispatches_total \d+$",
                                 scrape, re.M),
                   f"Prometheus scrape: {len(scrape)} bytes, unparsed "
                   f"{unparsed[:3]}"))
    with open(files["jsonl"]) as f:
        lines = [json.loads(ln) for ln in f if ln.strip()]
    checks.append((len(lines) == files["ticks"] > 0,
                   f"{len(lines)} JSONL lines for {files['ticks']} ticks"))
    for ok, what in checks:
        if not ok:
            fail(f"{label}: {what}")
    log(f"{label} observability gates held: {len(rep['spans'])} spans' "
        f"histograms sum to their counts; lineage received {received} == "
        f"stream messages; no gap, reorder or restart; complete frame traces "
        f"per producer {per}; Chrome trace {files['events']} events with "
        f"frame_trace lanes; Prometheus scrape {len(scrape)} bytes parsed; "
        f"{len(lines)} JSONL lines for {files['ticks']} reporter ticks")


def run_leg(label: str, leg: dict, state, tmp: str, loss_fn=None,
            producers: int = 2, wire: str = "raw", ingest_workers: int = 1,
            inflate_workers: int = 2, graph_step=None,
            alone: bool = True, record: str | None = None,
            keep_first: int = 0, obs: str | None = None,
            stages: bool = False, mesh=None, driver=None,
            audit: bool = False, census: bool = False) -> dict:
    """One producer leg through the captured fused step (one CUDA graph per
    packed plan); keeps the last ``PARITY_STEPS`` chunk groups for the
    graph-parity phase. ``producers`` cube producers publish on ``wire``
    into ``StreamDataPipeline(emit_packed=True, ingest_workers=...,
    inflate_workers=...)``. A ``graph_step`` (with its ``state``) may be
    shared between legs, so only the first captures. ``alone=False`` times
    only the graph step alone on the last group (no eager run, no profile).
    ``record`` tees the first ``REPLAY["record"]`` messages received to
    ``{record}_00.bjr``; ``keep_first`` keeps copies of the first groups
    and their loss tensors (``first``). The registry, lineage and traces
    start from zero for the leg (:func:`fresh_registry`); its stages and
    verdict are printed (the whole ``stages`` line with ``stages`` or
    ``obs``). ``obs`` (a directory) adds the reporter, the exporter and the
    Chrome trace (:class:`ObsLeg`). ``mesh`` gives the pipeline a mesh and
    ``driver`` (a ``MeshTrainDriver`` over ``graph_step`` and ``state``)
    runs the leg in place of a new ``TrainDriver``. ``audit`` snapshots
    the state's buffers (parameters, AdamW moments and counts) at the
    window's start and end and fails unless the graph replays updated them
    in place (:func:`audit_verdict`). ``census`` runs the window under
    :class:`SyncCensus` and prints its sites."""
    import collections

    import torch

    from blendjax_torch.data import StreamDataPipeline
    from blendjax_torch.kernels import (
        launch_counts,
        reset_launch_counts,
        variant_counts,
    )
    from blendjax_torch.train import (
        CapturedStep,
        TrainDriver,
        make_fused_tile_step,
    )

    from blendjax_torch.testing.donation import DonationAudit, state_tree

    if graph_step is None:
        graph_step = CapturedStep(make_fused_tile_step(loss_fn))
    if not graph_step.signatures:
        prewarm(graph_step, state, leg)
    fresh_registry()
    audits = DonationAudit() if audit else None
    watch = ObsLeg(obs) if obs else None
    procs, addrs, logs = start_producers(tmp, leg["tile"], leg["capacity"],
                                         count=producers, wire=wire)
    rec = ({"record_path_prefix": record,
            "record_max_messages": REPLAY["record"]} if record else {})
    pipe = StreamDataPipeline(
        addrs, batch_size=BATCH, chunk=CHUNK, emit_packed=True,
        timeoutms=60_000, ingest_workers=ingest_workers,
        inflate_workers=inflate_workers,
        on_timeout=producer_watch(label, procs, logs), mesh=mesh, **rec,
    )
    step = graph_step.step
    replays0 = graph_step.graph_replays
    tap = _FirstLosses(graph_step, keep_first)
    if driver is not None:
        driver.step = tap
        drv = driver
    else:
        drv = TrainDriver(tap, state, inflight=2, sync_every=4)
    total = leg["warmup"] + leg["steps"]
    images = 0
    updates = 0  # optimizer updates submitted: the chunk sizes summed
    short = 0  # step calls on a group of fewer than CHUNK batches
    recorded = collections.deque(maxlen=PARITY_STEPS)
    first = []
    t0 = None
    syncs = SyncCensus(label) if census else None
    try:
        reset_launch_counts()
        for batch in pipe:
            drv.submit(batch)
            if len(first) < keep_first:
                first.append({**batch, "_packed": batch["_packed"].clone()})
            k = int(batch["_packed"].shape[0])
            updates += k
            short += k < CHUNK
            recorded.append(batch)
            if drv.steps == leg["warmup"]:
                drv.drain()
                t0 = time.perf_counter()
                window0 = (graph_step.aot_fallbacks,
                           len(graph_step.signatures))
                if audits is not None:
                    audits.snapshot("train.state", state_tree(state))
                if syncs is not None:
                    syncs.__enter__()
            elif drv.steps > leg["warmup"]:
                images += k * BATCH
                if watch is not None and drv.steps == total - leg["steps"] // 2:
                    watch.scrape()
            if drv.steps >= total:
                break
        if syncs is not None:
            syncs.__exit__(None, None, None)
        drv.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        variants = variant_counts()
        if audits is not None:
            audits.snapshot("train.state", state_tree(state))
    finally:
        if syncs is not None and syncs.active:
            syncs.__exit__(None, None, None)
        pipe.stop()
        stop_producers(procs)
        segments = reap_segments(logs)
    census_rep = (syncs.report(leg["steps"], drv.host_blocks)
                  if syncs is not None else None)
    gaps, reorders, restarts = pipe.seq_gaps, pipe.reorders, pipe.restarts
    if audits is not None:
        audit_verdict(label, audits)
    from blendjax_torch.obs import tracer

    files = watch.finish() if watch is not None else None
    obs_rep = stages_line(label, pipe, drv, full=bool(obs or stages))
    obs_rep["files"] = files
    obs_rep["traces"] = tracer.records()
    shards = pipe.shard_stats()
    producers_rep = producer_report(label, logs)
    losses = drv.losses  # drain() appended the final loss
    if not all(math.isfinite(v) for v in losses):
        fail(f"{label}: non-finite loss in {losses}")
    if gaps or reorders or restarts:
        fail(f"{label}: {gaps} sequence gaps, {reorders} reorders, "
             f"{restarts} restarts")
    if graph_step.aot_fallbacks != window0[0] or graph_step.aot_fallbacks:
        fail(f"{label}: {graph_step.aot_fallbacks} aot fallbacks")
    if graph_step.graph_replays - replays0 != drv.steps:
        fail(f"{label}: {graph_step.graph_replays - replays0} graph replays "
             f"for {drv.steps} steps")
    last = recorded[-1]
    group_images = int(last["_packed"].shape[0]) * BATCH
    if alone:
        from blendjax_torch.ops.tiles import decode_packed_superbatch

        decode_ms = time_ms(lambda: decode_packed_superbatch(
            last["_packed"], last["_refs"], last["_spec"], last["_names"],
            last["_geoms"], last["_rle"],
        ), reps=5, windows=5)["ms"]
        # step alone on the last chunk group, eager and through its graph
        alone_rep = step_report(f"slice {label}", step, graph_step, state,
                                last, group_images, reps=5)
    else:
        graph_ms = alone_ms(lambda: graph_step(state, last), 20)
        decode_ms = None
        alone_rep = {"eager_ms": None, "eager_img_s": None, "profile": None,
                     "graph_ms": graph_ms,
                     "graph_img_s": group_images / graph_ms * 1e3}
    return {
        "profile": alone_rep["profile"], "alone": alone_rep,
        "img_s": images / wall, "wall_s": wall, "images": images,
        "steps": drv.steps, "updates": updates, "losses": losses,
        "short_groups": short, "seq_gaps": gaps, "restarts": restarts,
        "reorders": reorders, "messages": pipe.messages, "obs": obs_rep,
        "verdict": obs_rep["verdict"].render(),
        "graph_step": graph_step,
        "launches": counts, "variants": variants,
        "driver": drv.stats, "captures_in_window": (
            len(graph_step.signatures) - window0[1]),
        "dispatch_per_step": drv.dispatches / drv.steps,
        "step_alone_ms": alone_rep["eager_ms"],
        "step_alone_img_s": alone_rep["eager_img_s"],
        "graph_alone_ms": alone_rep["graph_ms"],
        "graph_alone_img_s": alone_rep["graph_img_s"],
        "decode_ms": decode_ms, "last": last, "step": step,
        "recorded": list(recorded), "first": first,
        "first_losses": tap.values(),
        "producers": producers_rep,
        "shards": shards, "segments": segments, "wire": wire,
        "ingest_workers": ingest_workers, "census": census_rep,
    }


# -- phase 4b: the streamformer leg ----------------------------------------------


def former_loss(model, batch):
    """The bench's StreamFormer loss (``bench.py:1084-1089``)."""
    from blendjax_torch.train import corner_loss

    return corner_loss(model(batch["image"]).reshape(-1, 8, 2), batch["xy"],
                       image_shape=tuple(batch["image"].shape[1:3]))


def former_flops_per_image(cfg: dict, tokens: int, in_ch: int = 4) -> float:
    """Model FLOPs of one image, forward and backward (3x the forward):
    every dense layer 2 * fan_in * fan_out per token (patch embedding
    patch^2 * C_in * dim; per block qkv 3 dim^2, proj dim^2, MLP 8 dim^2),
    attention 4 * T^2 * dim per block (the two products), the head
    2 * dim * outputs; normalisation, softmax and AdamW not counted."""
    c = cfg["dim"]
    dense = cfg["patch"] ** 2 * in_ch * c + cfg["depth"] * 12 * c * c
    fwd = (2 * tokens * dense + cfg["depth"] * 4 * tokens * tokens * c
           + 2 * c * cfg["num_outputs"])
    return 3.0 * fwd


def former_executed_flops_per_image(cfg: dict, tokens: int,
                                    in_ch: int = 4) -> float:
    """The FLOPs one image's update executes (what the device ledger
    counts): every dense layer's forward, input gradient and weight
    gradient (3x its forward), but the patch embedding's input (the
    frames) needs no gradient (2x); and per block the attention kernels'
    own work, 4 (forward) + 8 (dK/dV, which recomputes q k^T) + 6 (dQ,
    which recomputes it again) x T^2 x dim, against the 3 x 4 of
    :func:`former_flops_per_image`."""
    c = cfg["dim"]
    embed = 2 * tokens * cfg["patch"] ** 2 * in_ch * c
    dense = 2 * tokens * cfg["depth"] * 12 * c * c + 2 * c * cfg["num_outputs"]
    attention = cfg["depth"] * 18 * tokens * tokens * c
    return 2.0 * embed + 3.0 * dense + attention


def set_attn_backend(model, backend: str) -> None:
    from blendjax_torch.models import MultiHeadAttention

    for mod in model.modules():
        if isinstance(mod, MultiHeadAttention):
            mod.attn_backend = backend


def streamformer_leg(tmp: str, card: str) -> dict:
    import torch

    from blendjax_torch.models import StreamFormer
    from blendjax_torch.ops.tiles import decode_packed_superbatch
    from blendjax_torch.train import make_supervised_step, make_train_state

    model = StreamFormer(**FORMER, attn_backend="flash",
                         image_shape=SHAPE).init_params(0)
    state = make_train_state(model)
    fresh = copy.deepcopy(state)  # the state every comparison starts from
    leg = run_leg("streamformer leg", STREAMFORMER, state, tmp, former_loss,
                  stages=True)
    counts, depth = leg["launches"], FORMER["depth"]
    if counts["decode_spatial"] <= 0:
        fail("streamformer leg never launched decode_spatial (K1)")
    # every update of every chunk group (a group of K' < CHUNK batches
    # makes K' updates) runs each kernel once per block
    want = depth * leg["updates"]
    for name in ("flash_attention_fwd", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq"):
        if counts[name] != want:
            fail(f"streamformer leg: {name} launched {counts[name]} times, "
                 f"not depth x updates = {want}")
    for name in ("flash_attention_fwd", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq"):
        variants = leg["variants"][name]
        if variants != {"sm90": want, "simple": 0}:
            fail(f"streamformer leg: {name} variants {variants}, not all "
                 f"{want} launches through sm90")
    flops = former_flops_per_image(FORMER, model.tokens)
    leg["flops_per_image"] = flops
    # the device ledger's count of the full group's graph against the
    # executed-work count (the kernels' declared work is in it)
    executed = former_executed_flops_per_image(FORMER, model.tokens)
    full = [e for e in leg["graph_step"].ledger_entries
            if e["batch_images"] == CHUNK * BATCH]
    if not full or not isinstance(full[0]["flops"], float):
        fail(f"streamformer leg: no ledger entry of a full group: "
             f"{[e['batch_images'] for e in leg['graph_step'].ledger_entries]}")
    ledger_fpi = full[0]["flops"] / full[0]["batch_images"]
    if abs(ledger_fpi / executed - 1.0) > 0.02:
        fail(f"streamformer leg: ledger {ledger_fpi:.6g} FLOPs per image vs "
             f"the executed-work count {executed:.6g} (bar 2%)")
    leg["ledger"] = {"flops_per_image": ledger_fpi, "executed": executed,
                     "kernel_flops_per_image": full[0]["kernel_flops"]
                     / full[0]["batch_images"],
                     "mfu": leg["obs"]["report"]["gauges"].get("train.mfu"),
                     "mfu_source": leg["driver"]["mfu_source"]}

    # for information: the same step with the xla backend on the same group
    xla = copy.deepcopy(fresh)
    set_attn_backend(xla.model, "xla")
    last = leg["last"]
    torch.cuda.synchronize()
    s0 = time.perf_counter()
    for _ in range(3):
        leg["step"](xla, last)
    torch.cuda.synchronize()
    leg["xla_step_alone_ms"] = (time.perf_counter() - s0) / 3 * 1e3

    # one update from copies of the same state, flash against xla
    group = decode_packed_superbatch(
        last["_packed"], last["_refs"], last["_spec"], last["_names"],
        last["_geoms"], last["_rle"],
    )
    one = {"image": group["image"][0], "xy": group["xy"][0]}
    update = make_supervised_step(former_loss)
    pair = {}
    for backend in ("flash", "xla"):
        st = copy.deepcopy(fresh)
        set_attn_backend(st.model, backend)
        _, m = update(st, one)
        with torch.no_grad():
            after = former_loss(st.model, one)
        pair[backend] = (float(m["loss"]), float(after))
    for i, (what, rel) in enumerate((("before", 1e-2), ("after", 5e-2))):
        f, x = pair["flash"][i], pair["xla"][i]
        if not (math.isfinite(f) and abs(f - x) <= rel * abs(x)):
            fail(f"streamformer flash vs xla loss {what} one update: "
                 f"{f} vs {x} (rel bar {rel})")
    leg["flash_vs_xla"] = pair
    leg["fresh"] = fresh
    log(f"slice streamformer: flash vs xla loss before one update "
        f"{pair['flash'][0]:.6f} / {pair['xla'][0]:.6f} (rel bar 1e-2), "
        f"after {pair['flash'][1]:.6f} / {pair['xla'][1]:.6f} (rel bar "
        f"5e-2); xla step alone {leg['xla_step_alone_ms']:.2f} ms/chunk "
        f"group on {card} (information only)")
    return leg


# -- phase 5: the echo leg -------------------------------------------------------


class GammaTap:
    """The decoded pipeline, with every fresh batch's frames also taken
    through ``uint8_gamma_normalize`` on the card (K3) as it arrives."""

    def __init__(self, pipe):
        self.pipe = pipe
        self.batch_size = pipe.batch_size
        self.tiles = pipe.tiles
        self.device = pipe.device
        self.batches = 0
        self.last = None  # (decoded frames, their gamma-normalised f32)

    def __iter__(self):
        from blendjax_torch.ops.image import uint8_gamma_normalize

        for batch in self.pipe:
            self.last = (batch["image"], uint8_gamma_normalize(batch["image"]))
            self.batches += 1
            yield batch

    def stop(self) -> None:
        self.pipe.stop()


def echo_leg(tmp: str) -> dict:
    import numpy as np
    import torch

    from blendjax_torch.data import EchoingPipeline, StreamDataPipeline
    from blendjax_torch.kernels import launch_counts, reset_launch_counts
    from blendjax_torch.models import CubeRegressor
    from blendjax_torch.testing.donation import DonationAudit, state_tree
    from blendjax_torch.train import (
        CapturedStep,
        TrainDriver,
        make_echo_fused_step,
        make_train_state,
    )

    state = make_train_state(CubeRegressor().init_params(0))
    fresh_registry()
    audit = DonationAudit()
    procs, addrs, logs = start_producers(tmp, ECHO["tile"], ECHO["capacity"])
    pipe = StreamDataPipeline(addrs, batch_size=BATCH, chunk=1,
                              emit_packed=False, timeoutms=60_000)
    tap = GammaTap(pipe)
    echo = EchoingPipeline(tap, capacity=ECHO["reservoir"],
                           max_echo_factor=ECHO["max_echo_factor"],
                           emit_draws=True)
    echo_step = make_echo_fused_step(echo.reservoir.draw)
    graph_step = CapturedStep(echo_step)
    calls = [0]

    def step(st, batch):
        calls[0] += 1
        return graph_step(st, batch)

    drv = TrainDriver(step, state, inflight=2, sync_every=4)
    total = ECHO["warmup"] + ECHO["steps"]
    syncs = SyncCensus("echo leg")
    try:
        reset_launch_counts()
        for token in echo:
            drv.submit(token)
            if drv.steps == ECHO["warmup"]:
                drv.drain()
                t0 = time.perf_counter()
                s0 = dict(echo.stats)
                audit.snapshot("echo.state", state_tree(state))
                audit.snapshot("echo.reservoir",
                               echo.reservoir.device_buffers())
                sigs0 = len(graph_step.signatures)
                syncs.__enter__()
            if drv.steps >= total:
                break
        syncs.__exit__(None, None, None)
        if drv.steps < total:
            fail(f"echo leg: the stream ended after {drv.steps} steps")
        drv.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s1 = dict(echo.stats)
        audit.snapshot("echo.state", state_tree(state))
        audit.snapshot("echo.reservoir", echo.reservoir.device_buffers())
        echo.stop()  # joins the drain thread: no decode runs after this
        counts = launch_counts()
        gaps = pipe.seq_gaps + pipe.reorders + pipe.restarts
    finally:
        if syncs.active:
            syncs.__exit__(None, None, None)
        echo.stop()
        stop_producers(procs)
    census = syncs.report(ECHO["steps"], drv.host_blocks)
    verdict = stages_line("echo leg", echo, drv, full=False)["verdict"]
    producers = producer_report("echo leg", logs)
    losses = drv.losses
    decoded = tap.batches
    decodes = pipe.tiles.dispatch
    checks = [
        (s1["fresh"] + s1["echoed"] == drv.steps * BATCH,
         f"fresh {s1['fresh']} + echoed {s1['echoed']} != steps "
         f"{drv.steps} x batch {BATCH}"),
        (s1["echoed"] > 0, "nothing was echoed"),
        (s1["max_uses"] <= ECHO["max_echo_factor"],
         f"a sample was drawn {s1['max_uses']} times"),
        (gaps == 0, f"{gaps} sequence gaps, reorders and restarts"),
        (all(math.isfinite(v) for v in losses), f"non-finite loss in {losses}"),
        (calls[0] == drv.steps == drv.dispatches,
         f"{calls[0]} step calls for {drv.steps} driver steps"),
        (decoded > 0 and counts["decode_spatial"] == decoded,
         f"K1 launched {counts['decode_spatial']} times for {decoded} "
         "decoded fresh batches"),
        (counts["gamma_normalize"] == decoded,
         f"K3 launched {counts['gamma_normalize']} times for {decoded} "
         "decoded fresh batches"),
        (graph_step.aot_fallbacks == 0
         and graph_step.graph_replays == drv.steps,
         f"{graph_step.graph_replays} graph replays and "
         f"{graph_step.aot_fallbacks} fallbacks for {drv.steps} steps"),
        (decodes.graph_replays == decoded and decodes.eager_calls == 0,
         f"{decodes.graph_replays} decode replays and {decodes.eager_calls} "
         f"eager decodes for {decoded} decoded fresh batches"),
    ]
    for ok, what in checks:
        if not ok:
            fail(f"echo leg: {what}")
    audit_verdict("echo leg", audit)
    fresh = s1["fresh"] - s0["fresh"]
    drawn = fresh + s1["echoed"] - s0["echoed"]
    drain_busy = s1["drain_busy_s"] - s0["drain_busy_s"]
    # the echo step alone on one draw token, eager and through its graph
    token = echo.reservoir.draw_token(
        np.arange(BATCH) % max(echo.reservoir.size, 1))
    alone = step_report("slice echo", echo_step, graph_step, state, token,
                        BATCH, reps=5)
    rng = np.random.default_rng(0)
    tokens = [echo.reservoir.draw_token(
        rng.integers(0, echo.reservoir.size, BATCH))
        for _ in range(PARITY_STEPS)]
    return {
        "img_s": ECHO["steps"] * BATCH / wall, "wall_s": wall,
        "fresh_img_s": (s1["inserted"] - s0["inserted"]) / wall,
        "unique_fraction": fresh / drawn if drawn else None,
        "drain_busy_s": drain_busy,
        "stats": s1, "driver": drv.stats, "steps": drv.steps,
        "decoded_batches": decoded, "launches": counts, "seq_gaps": gaps,
        "losses": losses, "dispatch_per_step": drv.dispatches / drv.steps,
        "step_alone_ms": alone["eager_ms"],
        "step_alone_img_s": alone["eager_img_s"],
        "graph_alone_ms": alone["graph_ms"],
        "graph_alone_img_s": alone["graph_img_s"],
        "captures_in_window": len(graph_step.signatures) - sigs0,
        "decode_graphs": len(decodes.signatures),
        "decode_replays": decodes.graph_replays,
        "alone": alone, "profile": alone["profile"],
        "gamma_last": tap.last, "producers": producers,
        "reservoir": echo.reservoir, "tokens": tokens,
        "verdict": verdict.render(), "census": census,
    }


# -- phase 5c: the input side -----------------------------------------------------


def host_report() -> dict:
    """The host's cores and the free bytes of ``/dev/shm`` (where the
    shared-memory rings live)."""
    out = {"cpu_count": os.cpu_count(),
           "affinity": len(os.sched_getaffinity(0))}
    try:
        st = os.statvfs("/dev/shm")
        out["dev_shm_free"] = st.f_bavail * st.f_frsize
        out["dev_shm_total"] = st.f_blocks * st.f_frsize
    except OSError:
        out["dev_shm_free"] = out["dev_shm_total"] = None
    return out


def shard_text(shards) -> str:
    return "; ".join(
        f"shard {i} ({len(s['addresses'])} producer(s)): {s['messages']} "
        f"messages, {s['items']} items, {s['batches']} batches"
        for i, s in enumerate(shards))


def ingest_gates(label: str, leg: dict, workers: int) -> None:
    checks = [
        (leg["captures_in_window"] == 0,
         f"{leg['captures_in_window']} graphs captured in the window"),
        (leg["dispatch_per_step"] == 1.0,
         f"{leg['dispatch_per_step']} step calls per driver step"),
        (leg["launches"]["decode_spatial"] > 0, "K1 never launched"),
        (len(leg["shards"]) == workers, f"{len(leg['shards'])} shards for "
         f"{workers} ingest worker(s)"),
        (all(s["items"] > 0 for s in leg["shards"]),
         f"a shard took no item: {shard_text(leg['shards'])}"),
    ]
    for ok, what in checks:
        if not ok:
            fail(f"{label}: {what}")


def ingest_phase(tmp: str, card: str, flagship: dict) -> dict:
    """The input side at the flagship's width: four producers through one
    ingest thread and through two shards (in the order of
    ``INGEST["order"]``), then two shared-memory producers and two zlib
    ("ndz") producers through two shards with a shared inflate pool. Every
    run trains the full-width CubeRegressor through one shared captured
    step (captured in the first run's warm-up) with
    ``TrainDriver(inflight=2)``."""
    from blendjax_torch.models import CubeRegressor
    from blendjax_torch.train import (
        CapturedStep,
        make_fused_tile_step,
        make_train_state,
    )

    state = make_train_state(CubeRegressor().init_params(0))
    graph_step = CapturedStep(make_fused_tile_step())
    runs = []
    for i, workers in enumerate(INGEST["order"]):
        label = f"ingest A/B run {i + 1}, {workers} ingest worker(s)"
        leg = run_leg(label, INGEST, state, tmp, producers=4,
                      ingest_workers=workers, graph_step=graph_step,
                      alone=False)
        ingest_gates(label, leg, workers)
        log(f"{label}: live {leg['img_s']:.1f} img/s over {leg['images']} "
            f"images ({leg['wall_s']:.2f} s) on {card}; "
            f"{producer_text(leg['producers'])}; {shard_text(leg['shards'])};"
            f" step alone through the graph {leg['graph_alone_ms']:.3f} ms "
            f"({leg['graph_alone_img_s']:.1f} img/s); step calls on groups "
            f"below K={CHUNK}: {leg['short_groups']}; launches "
            f"{leg['launches']}; seq_gaps {leg['seq_gaps']}, restarts "
            f"{leg['restarts']}; driver {leg['driver']}")
        runs.append(leg)
    # for information: two shards with every decode inline on its shard's
    # thread, which separates the pool's hand-offs from the sharding
    label = "ingest run 5, 2 ingest workers, no inflate pool (information)"
    inline = run_leg(label, INGEST, state, tmp, producers=4, ingest_workers=2,
                     inflate_workers=0, graph_step=graph_step, alone=False)
    ingest_gates(label, inline, 2)
    log(f"{label}: live {inline['img_s']:.1f} img/s on {card}; "
        f"{producer_text(inline['producers'])}; "
        f"{shard_text(inline['shards'])}; pool decodes "
        f"{sum(s['pool_decodes'] for s in inline['shards'])}")

    label = "shm leg (2 producers, --wire shm, 2 ingest workers)"
    shm = run_leg(label, INGEST, state, tmp, producers=2, wire="shm",
                  ingest_workers=2, graph_step=graph_step, alone=False)
    ingest_gates(label, shm, 2)
    reads = sum(s["shm_reads"] for s in shm["shards"])
    received = sum(s["received"] for s in shm["shards"])
    torn = sum(s["shm_torn"] for s in shm["shards"])
    fallbacks = sum(p["shm_fallbacks"] for p in shm["producers"]["producers"])
    reclaims = sum(p["shm_reclaims"] for p in shm["producers"]["producers"])
    if not (reads == received > 0 and torn == fallbacks == reclaims == 0):
        fail(f"{label}: shm_reads {reads} for {received} messages, shm_torn "
             f"{torn}, shm_fallbacks {fallbacks}, shm_reclaims {reclaims}")
    if shm["segments"] != 2:
        fail(f"{label}: {shm['segments']} rings registered, not 2")
    log(f"{label}: live {shm['img_s']:.1f} img/s (the raw-wire flagship leg "
        f"of this run: {flagship['img_s']:.1f} img/s) on {card}; "
        f"shm_reads {reads} of {received} messages "
        f"({sum(s['shm_bytes'] for s in shm['shards'])} bytes), shm_torn "
        f"{torn}, shm_fallbacks {fallbacks}, shm_reclaims {reclaims}; "
        f"{producer_text(shm['producers'])}; {shard_text(shm['shards'])}; "
        f"step alone through the graph {shm['graph_alone_ms']:.3f} ms")

    label = "ndz leg (2 producers, --wire ndz, 2 ingest workers, 2 inflate)"
    ndz = run_leg(label, INGEST, state, tmp, producers=2, wire="ndz",
                  ingest_workers=2, inflate_workers=2, graph_step=graph_step,
                  alone=False)
    ingest_gates(label, ndz, 2)
    pool = sum(s["pool_decodes"] for s in ndz["shards"])
    raw = sum(s["raw_bytes"] for s in ndz["shards"])
    wire = sum(s["compressed_bytes"] for s in ndz["shards"])
    if pool <= 0:
        fail(f"{label}: no message was decoded on the inflate pool")
    log(f"{label}: live {ndz['img_s']:.1f} img/s on {card}; pool_decodes "
        f"{pool}; decoded {raw} bytes from {wire} on the wire "
        f"({raw / max(wire, 1):.2f}x); {producer_text(ndz['producers'])} "
        f"(publish, which compresses, left out); "
        f"{shard_text(ndz['shards'])}; step alone through the graph "
        f"{ndz['graph_alone_ms']:.3f} ms")
    k1 = sum(leg["launches"]["decode_spatial"]
             for leg in (*runs, inline, shm, ndz))
    return {"runs": runs, "inline": inline, "shm": shm, "ndz": ndz,
            "k1_launches": k1}


class _Capture:
    """A publisher stand-in that keeps the messages."""

    def __init__(self):
        self.msgs = []

    def publish(self, **msg):
        self.msgs.append(msg)


def recorded_messages(n: int) -> list:
    """``n`` flagship-stream messages of one cube producer (seed 0, as the
    cube producer makes them), kept in memory."""
    import numpy as np

    from blendjax_torch.producer import CubeScene, TileBatchPublisher

    scene = CubeScene(shape=SHAPE, seed=0)
    cap = _Capture()
    tiles = TileBatchPublisher(
        cap, scene.background_image(), BATCH, tile=FLAGSHIP["tile"],
        alpha_slice=False, ref_interval=64, capacity=FLAGSHIP["capacity"],
    )
    framebuf = np.empty((*SHAPE, 4), np.uint8)
    frame = 1
    while len(cap.msgs) < n:
        scene.step(frame)
        scene.render(out=framebuf)
        tiles.add(framebuf, hint=scene.raster.last_drawn,
                  xy=scene.camera.world_to_pixel(
                      scene.corners_world()).astype(np.float32),
                  frameid=np.int64(frame))
        frame += 1
    return cap.msgs


def equality_leg(card: str) -> dict:
    """The same recorded messages through three routes: a port publisher
    on the raw wire, the same publisher over a shared-memory ring, and
    zlib ("ndz") decoded on an inflate pool. The packed chunk groups, their
    decode on the card and a step of the captured fused step per group
    from one seeded state (cuDNN deterministic) must be identical on all
    three."""
    import concurrent.futures
    import threading

    import numpy as np
    import torch

    from blendjax_torch.data import RemoteStream, StreamDataPipeline
    from blendjax_torch.models import CubeRegressor
    from blendjax_torch.ops.tiles import decode_packed_superbatch
    from blendjax_torch.train import (
        CapturedStep,
        make_fused_tile_step,
        make_train_state,
    )
    from blendjax_torch.transport import DataPublisherSocket, detach_all

    steps = EQUALITY_STEPS
    msgs = recorded_messages(steps * CHUNK)
    routes = {"raw": {}, "shm": {"shm": 4},
              "ndz": {"compress_level": 6, "compress_min_bytes": 1024}}
    got = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name, kw in routes.items():
            pub = DataPublisherSocket("tcp://127.0.0.1:*", btid=0,
                                      send_hwm=2, **kw)
            stream = RemoteStream([pub.addr], timeoutms=60_000,
                                  defer_rle=True, max_items=len(msgs))
            pool = None
            if name == "ndz":
                pool = concurrent.futures.ThreadPoolExecutor(2)
                stream.set_inflate_pool(pool)
            feeder = threading.Thread(
                target=lambda: [pub.publish(**m) for m in msgs], daemon=True)
            feeder.start()
            pipe = StreamDataPipeline(stream, batch_size=BATCH, chunk=CHUNK,
                                      emit_packed=True, place_in_driver=True)
            try:
                groups = list(pipe)
            finally:
                pipe.stop()
                feeder.join(timeout=30)
                if pool is not None:
                    pool.shutdown()
                detach_all()
                pub.close()
            # a change of palette index width between messages closes a
            # group early, so the sizes are the stream's, the same on
            # every route
            sizes = [int(g["_packed"].shape[0]) for g in groups]
            if sum(sizes) != len(msgs):
                fail(f"equality leg, {name}: groups of {sizes} batches for "
                     f"{len(msgs)} messages")
            decoded = [decode_packed_superbatch(
                torch.from_numpy(g["_packed"]).to(pipe.device), g["_refs"],
                g["_spec"],
                g["_names"], g["_geoms"], g["_rle"])["image"] for g in groups]
            state = make_train_state(CubeRegressor().init_params(0))
            graph_step = CapturedStep(make_fused_tile_step())
            losses = []
            for g in groups:
                state, m = graph_step(state, pipe.feeder.place(g))
                losses.append(m["loss"].float().reshape(-1))
            got[name] = {
                "groups": groups, "decoded": decoded,
                "losses": torch.cat(losses).cpu().tolist(),
                "replays": graph_step.graph_replays,
                "counts": stream.counts.as_dict(),
                "pool_decodes": stream.pool_decodes,
                "messages": stream.messages,
            }
            del graph_step, state
    finally:
        torch.backends.cudnn.deterministic = deterministic
    raw = got["raw"]
    for name in ("shm", "ndz"):
        other = got[name]
        if len(other["groups"]) != len(raw["groups"]):
            fail(f"equality leg: {len(raw['groups'])} groups on raw, "
                 f"{len(other['groups'])} on {name}")
        for i, (a, b) in enumerate(zip(raw["groups"], other["groups"])):
            same = (np.array_equal(a["_packed"], b["_packed"])
                    and a["_spec"] == b["_spec"] and a["_rle"] == b["_rle"]
                    and a["_geoms"] == b["_geoms"]
                    and all(torch.equal(a["_refs"][k], b["_refs"][k])
                            for k in a["_refs"]))
            if not same:
                fail(f"equality leg: packed group {i} differs, raw vs {name}")
            if not torch.equal(raw["decoded"][i], other["decoded"][i]):
                fail(f"equality leg: decoded group {i} differs, raw vs {name}")
        if other["losses"] != raw["losses"]:
            fail(f"equality leg: f32 losses differ, raw {raw['losses']} vs "
                 f"{name} {other['losses']}")
    checks = [
        (got["shm"]["counts"]["shm_reads"] == len(msgs),
         f"shm route: {got['shm']['counts']['shm_reads']} shm reads for "
         f"{len(msgs)} messages"),
        (got["ndz"]["pool_decodes"] == len(msgs),
         f"ndz route: {got['ndz']['pool_decodes']} pool decodes"),
        (got["ndz"]["counts"]["compressed_bytes"]
         < got["ndz"]["counts"]["raw_bytes"], "ndz route: nothing compressed"),
        (all(r["replays"] == len(r["groups"]) for r in got.values()),
         "a route did not replay its graph once per step"),
        (all(math.isfinite(v) for v in raw["losses"]), "non-finite loss"),
    ]
    for ok, what in checks:
        if not ok:
            fail(f"equality leg: {what}")
    log(f"equality leg on {card}: {len(msgs)} messages through raw, shm and "
        f"ndz (inflate pool): {len(raw['groups'])} packed groups (of "
        f"{[int(g['_packed'].shape[0]) for g in raw['groups']]} batches) and "
        f"their decode on the card identical; {len(raw['losses'])} f32 "
        f"losses of {len(raw['groups'])} "
        f"captured steps identical (first {raw['losses'][0]:.6f}, last "
        f"{raw['losses'][-1]:.6f}); ndz decoded "
        f"{got['ndz']['counts']['raw_bytes']} bytes from "
        f"{got['ndz']['counts']['compressed_bytes']} on the wire")
    return {"messages": len(msgs), "losses": raw["losses"]}


# -- phase 5d: the palette producer, replay and resume ----------------------------


def renders_match(label: str, groups) -> int:
    """Decode packed groups on the card and hold every frame against the
    frame its producer rendered (the same scene, seeded with the
    producer's btid, rendered here on the host C++ path), bit for bit;
    returns the frames checked (at least 8, else the run fails)."""
    import numpy as np

    from blendjax_torch.ops.tiles import decode_packed_superbatch
    from blendjax_torch.producer import CubeScene

    want: dict = {}  # (btid, frameid) -> decoded frame on the host
    for g in groups:
        fields = decode_packed_superbatch(g["_packed"], g["_refs"],
                                          g["_spec"], g["_names"],
                                          g["_geoms"], g["_rle"])
        images = fields["image"].cpu().numpy()
        frameids = fields["frameid"].cpu().numpy()
        for k, rest in enumerate(g["_meta"]):
            for b in range(images.shape[1]):
                want[(int(rest["btid"]), int(frameids[k, b]))] = images[k, b]
    checked = 0
    buf = np.empty((*SHAPE, 4), np.uint8)
    for btid in sorted({b for b, _ in want}):
        scene = CubeScene(shape=SHAPE, seed=btid)  # the producer's seed
        last = max(f for b, f in want if b == btid)
        for f in range(1, last + 1):
            scene.step(f)
            scene.render(out=buf)
            got = want.get((btid, f))
            if got is not None:
                if not np.array_equal(got, buf):
                    fail(f"{label}: producer {btid} frame {f} decoded "
                         "on the card differs from its render")
                checked += 1
    if checked < 8:
        fail(f"{label}: only {checked} frames checked")
    return checked


def palette_phase(leg: dict, card: str) -> dict:
    """The flagship leg's producers took the fused per-frame palette path
    (``producer_report`` failed the leg otherwise): print each one's
    message bytes per 8 frames and its own frames/s beside the leg's live
    img/s, and hold the frames of the leg's first two chunk groups,
    decoded on the card, against the frames the producers rendered (the
    same scenes rendered here on the host C++ path), bit for bit."""
    rep = leg["producers"]
    per8 = [s["msg_bytes"] * 8 / s["frames_per_msg"] for s in rep["producers"]]
    checked = renders_match("palette phase", leg["first"][:2])
    log(f"palette producer on {card}: every producer on the fused per-frame "
        f"palette path; message bytes per 8 frames "
        f"{[round(b, 1) for b in per8]} (arrays, the reference image left "
        f"out); producers' own frames/s "
        f"{[round(s['own_frames_s'], 1) for s in rep['producers']]}; leg "
        f"live {leg['img_s']:.1f} img/s; {checked} decoded frames equal the "
        "producers' renders bit for bit")
    return {"msg_bytes_per_8": per8, "checked": checked,
            "own_frames_s": [s["own_frames_s"] for s in rep["producers"]]}


def replay_leg(prefix: str, live: dict, card: str) -> dict:
    """The flagship live leg's recording, replayed in a loop through
    ``StreamDataPipeline.from_recording(..., emit_packed=True, chunk=4,
    loop=True)`` into a fresh ``CapturedStep(make_fused_tile_step())`` on
    a full-width CubeRegressor from the live leg's initial weights
    (``init_params(0)``), with no producer running. Fails unless the
    replay's first ``REPLAY["compare"]`` packed groups equal the live
    leg's bit for bit and the losses of those steps agree (bit for bit, or
    else within bf16 rel 1e-2), with K1 launched, one replay per step and
    no fallback. Prints replay img/s beside the graph step alone."""
    import torch

    from blendjax_torch.data import StreamDataPipeline
    from blendjax_torch.kernels import launch_counts, reset_launch_counts
    from blendjax_torch.models import CubeRegressor
    from blendjax_torch.train import (
        CapturedStep,
        TrainDriver,
        make_fused_tile_step,
        make_train_state,
    )

    state = make_train_state(CubeRegressor().init_params(0))
    graph_step = CapturedStep(make_fused_tile_step())
    prewarm(graph_step, state, FLAGSHIP)
    compare = min(REPLAY["compare"], len(live["first"]))
    tap = _FirstLosses(graph_step, compare)
    drv = TrainDriver(tap, state, inflight=2, sync_every=4)
    pipe = StreamDataPipeline.from_recording(prefix, batch_size=BATCH,
                                             emit_packed=True, chunk=CHUNK,
                                             loop=True)
    fresh_registry()
    images = 0
    total = REPLAY["warmup"] + REPLAY["steps"]
    reset_launch_counts()
    try:
        for i, batch in enumerate(pipe):
            drv.submit(batch)
            if i < compare:
                want = live["first"][i]
                if (batch["_spec"] != want["_spec"]
                        or not torch.equal(batch["_packed"], want["_packed"])):
                    fail(f"replay leg: packed group {i} differs from the live "
                         "leg's")
            if drv.steps == REPLAY["warmup"]:
                drv.drain()
                t0 = time.perf_counter()
                replays0 = graph_step.graph_replays
            elif drv.steps > REPLAY["warmup"]:
                images += int(batch["_packed"].shape[0]) * BATCH
            if drv.steps >= total:
                break
        drv.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        pipe.stop()
    as_float = tap.values()
    live_f = live["first_losses"][:len(as_float)]
    if not all(math.isfinite(v) for v in as_float):
        fail(f"replay leg: non-finite loss in {as_float}")
    bitwise = as_float == live_f
    rel = max(abs(a - b) / max(abs(b), 1e-12)
              for a, b in zip(as_float, live_f))
    if not bitwise and rel > 1e-2:
        fail(f"replay leg: losses differ from the live leg's beyond rel 1e-2 "
             f"(max rel {rel:.3e}): {as_float} vs {live_f}")
    if graph_step.graph_replays - replays0 != drv.steps - REPLAY["warmup"]:
        fail("replay leg: not one graph replay per step")
    if graph_step.aot_fallbacks or counts["decode_spatial"] <= 0:
        fail(f"replay leg: {graph_step.aot_fallbacks} fallbacks, launches "
             f"{counts}")
    obs = stages_line("replay leg", pipe, drv)
    last = batch
    graph_ms = alone_ms(lambda: graph_step(state, last), 20)
    alone_img_s = int(last["_packed"].shape[0]) * BATCH / graph_ms * 1e3
    out = {"img_s": images / wall, "wall_s": wall, "steps": drv.steps,
           "verdict": obs["verdict"].render(),
           "graph_alone_img_s": alone_img_s, "bitwise": bitwise,
           "max_rel": rel, "compared": compare, "launches": counts,
           "losses": as_float}
    log(f"replay leg on {card}: {out['img_s']:.1f} img/s over "
        f"{REPLAY['steps']} steps ({wall:.2f} s) from the recording, no "
        f"producer; graph step alone {alone_img_s:.1f} img/s "
        f"({out['img_s'] / alone_img_s:.2f} of it); first {compare} packed "
        f"groups bit-identical to the live leg's; their losses "
        + ("bit-identical" if bitwise else f"within rel {rel:.3e} (bar 1e-2)")
        + f"; launches {counts}")
    return out


def _deterministic(on: bool) -> None:
    import torch

    torch.use_deterministic_algorithms(on)
    torch.backends.cudnn.deterministic = on


def _submit_all(drv, batches) -> list:
    """Submit each batch; returns each step's loss tensor (read later)."""
    out = []
    for b in batches:
        drv.submit(b)
        out.append(drv._pending[-1][0] if drv._pending else drv.losses[-1])
    return out


def resume_phase(prefix: str, tmp: str, card: str) -> dict:
    """Checkpoint, resume and in-place restore through captured graphs, on
    the flagship replay's batches decoded on the card (K1), full-width
    CubeRegressor, ``TrainDriver.build(rng=0)`` (one graph per ladder
    signature), under deterministic algorithms (cuDNN deterministic,
    ``CUBLAS_WORKSPACE_CONFIG`` set at start):

    - Y trains 2N steps uninterrupted (the yardstick);
    - A trains N steps with ``checkpoint_every``, snapshots written by the
      manager's thread;
    - B is ``build(resume=True)`` from A's newest snapshot and trains
      steps N..2N: its losses and final parameters must equal Y's;
    - C, built and captured, trains 2 steps, is restored in place from the
      same snapshot (``load_train_state_leaves``) and replays step N: its
      loss must equal B's, and a donation audit of its state (parameters,
      AdamW moments and counts) before the restore, after it and after
      the step must read stable.

    Then two more drivers time ``RESUME["window"]`` steps each, without
    and with ``checkpoint_every`` (order plain, snapshots, snapshots,
    plain). Prints the snapshot's bytes, the writer's ms per snapshot, the
    snapshots skipped under backpressure, ms per step with and without
    snapshots, and B's time to its first step."""
    import torch

    from blendjax_torch.checkpoint import SnapshotManager
    from blendjax_torch.data import StreamDataPipeline
    from blendjax_torch.models import CubeRegressor
    from blendjax_torch.testing.donation import DonationAudit, state_tree
    from blendjax_torch.train import TrainDriver
    from blendjax_torch.weights import (
        load_train_state_leaves,
        train_state_leaves,
    )

    n, every = RESUME["steps"], RESUME["every"]
    pipe = StreamDataPipeline.from_recording(prefix, batch_size=BATCH,
                                             loop=True)
    batches = []
    try:
        for b in pipe:
            batches.append({"image": b["image"], "xy": b["xy"]})
            if len(batches) == 2 * n:
                break
    finally:
        pipe.stop()
    torch.cuda.synchronize()

    def build(**kw):
        return TrainDriver.build(CubeRegressor(), batches[0], rng=0,
                                 inflight=2, sync_every=0, **kw)

    def timed(drv, part):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = _submit_all(drv, part)
        drv.drain()
        return losses, (time.perf_counter() - t0) / len(part) * 1e3

    _deterministic(True)
    try:
        y = build()
        y_losses, _ = timed(y, batches[:n])
        y_more, _ = timed(y, batches[n:])
        mgr = SnapshotManager(os.path.join(tmp, "resume-ckpt"), keep=2)
        a = build(checkpoint=mgr, checkpoint_every=every)
        a_losses, _ = timed(a, batches[:n])
        mgr.wait()
        if mgr.last_error is not None or mgr.steps()[-1] != n:
            fail(f"resume phase: snapshots {mgr.steps()}, error "
                 f"{mgr.last_error!r}")
        if not a.dispatches == a.steps == n:
            fail("resume phase: checkpointing changed the step calls")
        b = build(checkpoint=SnapshotManager(mgr.directory), resume=True)
        if b.steps != n or b.state.step != n:
            fail(f"resume phase: B resumed at {b.steps}/{b.state.step}")
        b_losses = _submit_all(b, batches[n:])
        b.drain()
        ttfs = b.time_to_first_step_ms
        c = build()
        _submit_all(c, batches[:2])
        c.drain()
        restored = mgr.restore(train_state_leaves(c.state))
        audit = DonationAudit()
        audit.snapshot("resume.state", state_tree(c.state))
        load_train_state_leaves(c.state, restored.state)
        c.load_state_dict(restored.session["driver"])
        audit.snapshot("resume.state", state_tree(c.state))
        c_loss = _submit_all(c, batches[n:n + 1])[0]
        c.drain()
        torch.cuda.synchronize()
        audit.snapshot("resume.state", state_tree(c.state))
        audit_verdict("resume phase (C restored in place, then a step)",
                      audit)
        yv = [float(v) for v in y_losses + y_more]
        av = [float(v) for v in a_losses]
        bv = [float(v) for v in b_losses]
        if av != yv[:n]:
            fail(f"resume phase: A's losses {av} differ from Y's {yv[:n]}")
        if bv != yv[n:]:
            fail(f"resume phase: B's losses {bv} differ from the "
                 f"uninterrupted run's {yv[n:]}")
        if float(c_loss) != bv[0]:
            fail(f"resume phase: C's replay after the in-place restore gave "
                 f"{float(c_loss)}, B's first step {bv[0]}")
        for pb, py in zip(b.state.model.parameters(),
                          y.state.model.parameters()):
            if not torch.equal(pb, py):
                fail("resume phase: B's final parameters differ from Y's")
        for d in (y, a, b, c):
            if d.step.aot_fallbacks:
                fail("resume phase: a step fell back to the eager step")
        with open(os.path.join(mgr.directory, f"step-{n:08d}",
                               "manifest.json")) as f:
            nbytes = json.load(f)["bytes"]
    finally:
        _deterministic(False)
    mgr.close()
    # step time without and with snapshots, in turns
    timing = SnapshotManager(os.path.join(tmp, "resume-timing"), keep=2)
    drivers = {"plain": build(),
               "snapshots": build(checkpoint=timing, checkpoint_every=every)}
    window = [batches[i % len(batches)] for i in range(RESUME["window"])]
    ms = {"plain": [], "snapshots": []}
    for side in ("plain", "snapshots", "snapshots", "plain"):
        ms[side].append(timed(drivers[side], window)[1])
    timing.wait()
    if timing.last_error is not None:
        fail(f"resume phase: snapshot write failed: {timing.last_error!r}")
    out = {"snapshot_bytes": nbytes, "save_ms": list(timing.save_ms),
           "saves": timing.saves, "skipped": timing.skipped,
           "handed": drivers["snapshots"].checkpoints,
           "ms_per_step": ms, "b_ttfs_ms": ttfs,
           "b_startup_ms": b.startup_ms, "losses": yv}
    timing.close()
    writes = sorted(timing.save_ms)
    log(f"resume on {card}: {n} + {n} steps of batch {BATCH} through "
        f"captured graphs, deterministic algorithms: B (build(resume=True) "
        f"from A's step-{n} snapshot) and C (restored in place) equal the "
        f"uninterrupted run's losses bit for bit ({yv[0]:.6f} ... "
        f"{yv[-1]:.6f}) and B its final parameters; snapshot {nbytes} bytes; "
        f"B's time to first step {ttfs:.1f} ms (startup {b.startup_ms:.1f} "
        f"ms); over windows of {RESUME['window']} steps (order plain, "
        f"snapshots, snapshots, plain) ms per step without snapshots "
        f"{[round(v, 4) for v in ms['plain']]}, with checkpoint_every="
        f"{every} {[round(v, 4) for v in ms['snapshots']]}; "
        f"{out['handed']} snapshots handed to the writer, {timing.saves} "
        f"written, {timing.skipped} replaced while pending; writer ms per "
        f"snapshot off the dispatch thread: median "
        f"{writes[len(writes) // 2]:.2f}, min {writes[0]:.2f}, max "
        f"{writes[-1]:.2f}")
    return out


# -- phase 5f: the launched, gym and duplex legs ---------------------------------

CUBE_SCRIPT = os.path.join(ROOT, "blendjax_torch", "producer", "cube.py")
CARTPOLE_SCRIPT = os.path.join(ROOT, "blendjax_torch", "producer", "scripts",
                               "cartpole.py")
# the flagship configuration, started by the port's launcher; a receive
# that waits `timeoutms` asks the launcher (respawn, or its error)
LAUNCHED = {"tile": (16, 32), "capacity": 160, "steps": 192, "warmup": 64,
            "after": 64, "timeoutms": 5000, "before_kill": 16}
GYM = {"warmup": 100, "seconds": 3.0, "steps": 200, "seed": 7}
# the fake-Blender leg: the example cube scene under the port's Blender
# double, one instance with the UI on (the offscreen path renders its
# stock 1920x1080 scene), batches of 2 frames into 4 captured steps
BLENDER = {"batch": 2, "steps": 4}
DUPLEX = {"messages": 1000}

# The duplex leg's producer (written into the leg's directory): a CTRL
# socket on SimEngine frames that sends every message back, and stops on
# {"stop": True}.
DUPLEX_SCRIPT = '''\
import sys

from blendjax_torch.producer import (
    AnimationController, DuplexChannel, parse_launch_args)
from blendjax_torch.producer.sim import CubeScene, SimEngine
from blendjax_torch.transport import term_context

args, _ = parse_launch_args(sys.argv)
duplex = DuplexChannel(args.btsockets["CTRL"], btid=args.btid, lingerms=5000)
ctrl = AnimationController(SimEngine(
    CubeScene(shape=(48, 64), seed=args.btseed, native=False)))


def echo(frame):
    msg = duplex.recv(timeoutms=100)
    if msg is None:
        return
    duplex.send(echo=msg)
    if msg.get("stop"):
        ctrl.cancel()


ctrl.post_frame.add(echo)
try:
    ctrl.play(frame_range=(1, 1000), num_episodes=-1)
finally:
    duplex.close()
    term_context()
'''


def percentiles_ms(seconds) -> dict:
    import numpy as np

    ms = np.asarray(seconds) * 1e3
    return {"p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "max_ms": float(ms.max())}


def fleet_gone(label: str, pids, dirs, shm_before: set) -> None:
    """No producer process of the leg is left, its ipc and shared-memory
    registry directories are gone, and /dev/shm holds no segment it did
    not hold before the leg."""
    alive = []
    for pid in pids:
        try:
            os.kill(pid, 0)
            alive.append(pid)
        except ProcessLookupError:
            pass
    left = [d for d in dirs if d and os.path.exists(d)]
    shm_new = sorted(set(os.listdir("/dev/shm")) - shm_before)
    if alive or left or shm_new:
        fail(f"{label}: left behind processes {alive}, directories {left}, "
             f"shared-memory segments {shm_new}")


def launched_args(logs) -> list:
    return [["--shape", str(SHAPE[0]), str(SHAPE[1]), "--batch", str(BATCH),
             "--encoding", "tile", "--tile", *map(str, LAUNCHED["tile"]),
             "--tile-rgba", "--tile-capacity", str(LAUNCHED["capacity"]),
             "--log", log] for log in logs]


def launched_leg(tmp: str, card: str) -> dict:
    """The flagship configuration started by the port's launcher
    (``PythonProducerLauncher(script=<producer/cube.py>, seed=0,
    proto="ipc", respawn=True)``) into ``StreamDataPipeline(launcher=...,
    ingest_workers=2)`` and a fresh captured full-width CubeRegressor
    step: 64 warm-up and 192 measured steps, gated as the flagship (no
    gap, reorder or restart; the handshake's btids 0 and 1 with seeds 0
    and 1, the first groups' frames equal to those seeds' renders). Then
    producer 1 is SIGKILLed: its shard's receive timeout asks the
    launcher, which respawns it; the stream must count exactly one
    restart, for btid 1, and training goes on for ``LAUNCHED["after"]``
    steps. Then a second fleet with ``respawn=False``: the same kill must
    raise the launcher's dead-producer error through the pipeline within
    the timeout budget. After each fleet no producer process, ipc or
    registry directory or shared-memory segment of the leg is left."""
    import shutil
    import signal

    import torch

    from blendjax_torch.data import StreamDataPipeline
    from blendjax_torch.kernels import launch_counts, reset_launch_counts
    from blendjax_torch.launcher import PythonProducerLauncher
    from blendjax_torch.models import CubeRegressor
    from blendjax_torch.obs import lineage
    from blendjax_torch.train import (
        CapturedStep,
        TrainDriver,
        make_fused_tile_step,
        make_train_state,
    )

    label = "launched leg"
    state = make_train_state(CubeRegressor().init_params(0))
    graph_step = CapturedStep(make_fused_tile_step())
    prewarm(graph_step, state, LAUNCHED)
    timeout_s = LAUNCHED["timeoutms"] / 1e3
    leg_dir = tempfile.mkdtemp(dir=tmp)
    logs = [os.path.join(leg_dir, f"producer{i}.log") for i in range(2)]
    shm_before = set(os.listdir("/dev/shm"))
    fresh_registry()
    # the launcher spawns from the main thread: its producers carry the
    # parent-death signal (a respawn from an ingest thread does not)
    launcher = PythonProducerLauncher(
        script=CUBE_SCRIPT, num_instances=2, named_sockets=["DATA"], seed=0,
        proto="ipc", respawn=True, instance_args=launched_args(logs))
    with launcher:
        pids = list(launcher.launch_info.processes)
        dirs = [launcher._ipc_dir, launcher._shm_registry]
        commands = list(launcher.launch_info.commands)
        pipe = StreamDataPipeline(
            launcher.addresses["DATA"], batch_size=BATCH, chunk=CHUNK,
            emit_packed=True, timeoutms=LAUNCHED["timeoutms"],
            ingest_workers=2, launcher=launcher)
        drv = TrainDriver(graph_step, state, inflight=2, sync_every=4)
        total = LAUNCHED["warmup"] + LAUNCHED["steps"]
        replays0 = graph_step.graph_replays
        images, first = 0, []
        it = iter(pipe)
        try:
            reset_launch_counts()
            for batch in it:
                drv.submit(batch)
                if len(first) < 2:
                    first.append({**batch,
                                  "_packed": batch["_packed"].clone()})
                if drv.steps == LAUNCHED["warmup"]:
                    drv.drain()
                    t0 = time.perf_counter()
                elif drv.steps > LAUNCHED["warmup"]:
                    images += int(batch["_packed"].shape[0]) * BATCH
                if drv.steps >= total:
                    break
            drv.drain()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            window = {"gaps": pipe.seq_gaps, "reorders": pipe.reorders,
                      "restarts": pipe.restarts}
            verdict = stages_line(label, pipe, drv, full=False)["verdict"]
            received = {b: e["received"] for b, e in lineage.report().items()}
            # the producers' own rates over the window (a respawn appends
            # a second life to the log)
            for log_file in logs:
                shutil.copy(log_file, log_file + ".window")
            victim = launcher.processes[1]
            os.kill(victim.pid, signal.SIGKILL)
            victim.wait(timeout=30)
            t_kill = time.perf_counter()
            steps_at_kill = drv.steps
            deadline = time.monotonic() + 4 * timeout_s + 60
            restart_s = None
            for batch in it:
                drv.submit(batch)
                if restart_s is None and pipe.restarts:
                    restart_s = time.perf_counter() - t_kill
                    steps_at_restart = drv.steps
                if restart_s is not None and (
                        drv.steps >= steps_at_restart + LAUNCHED["after"]):
                    break
                if time.monotonic() > deadline:
                    fail(f"{label}: no restart counted "
                         f"{4 * timeout_s + 60:.0f} s after the kill")
            drv.drain()
            torch.cuda.synchronize()
            counts = launch_counts()
            respawned = launcher.processes[1].pid
            pids.append(respawned)
            alive_after = launcher.poll_processes()
        finally:
            pipe.stop()
    fleet_gone(label, pids, dirs, shm_before)
    lin = lineage.report()
    rep = producer_report(label, [f + ".window" for f in logs])
    stats = {s["btid"]: s for s in rep["producers"]}
    checked = renders_match(label, first)
    checks = [
        (window == {"gaps": 0, "reorders": 0, "restarts": 0},
         f"window gaps/reorders/restarts {window}"),
        (sorted(received) == ["0", "1"] and min(received.values()) > 0,
         f"btids received {received}, not 0 and 1"),
        ({b: s["seed"] for b, s in stats.items()} == {0: 0, 1: 1},
         f"handshake seeds {[(s['btid'], s['seed']) for s in stats.values()]}"
         " not btid i -> seed i"),
        (all(f"-btid {i} -btseed {i} " in c for i, c in enumerate(commands)),
         f"launch commands {commands}"),
        (pipe.restarts == 1 and lin["1"]["restarts"] == 1
         and lin["0"]["restarts"] == 0,
         f"restarts {pipe.restarts}, per btid "
         f"{ {b: e['restarts'] for b, e in lin.items()} }, not one for btid 1"),
        (pipe.seq_gaps == 0 and pipe.reorders == 0,
         f"after the respawn: {pipe.seq_gaps} gaps, {pipe.reorders} reorders"),
        (respawned != victim.pid and alive_after == [None, None],
         f"producer 1 pid {victim.pid} -> {respawned}, alive {alive_after}"),
        (all(math.isfinite(v) for v in drv.losses),
         f"non-finite loss in {drv.losses[-8:]}"),
        (graph_step.graph_replays - replays0 == drv.steps
         and graph_step.aot_fallbacks == 0,
         f"{graph_step.graph_replays - replays0} replays for {drv.steps} "
         f"steps, {graph_step.aot_fallbacks} fallbacks"),
        (counts["decode_spatial"] > 0, f"K1 never launched: {counts}"),
    ]
    for ok, what in checks:
        if not ok:
            fail(f"{label}: {what}")
    img_s = images / wall
    own = rep.get("own_frames_s", 0.0)
    log(f"{label} on {card}: live {img_s:.1f} img/s over {images} images "
        f"({wall:.2f} s), producers' own {own:.1f} frames/s summed (live "
        f"{img_s / own:.3f} of it); {producer_text(rep)}; {verdict.render()};"
        f" btids 0 and 1 with handshake seeds 0 and 1, {checked} decoded "
        f"frames equal those seeds' renders; window gaps/reorders/restarts "
        f"{window}; SIGKILL of producer 1 after step {steps_at_kill}: "
        f"respawned (pid {victim.pid} -> {respawned}) and one restart "
        f"counted {restart_s:.2f} s after the kill (receive timeout "
        f"{timeout_s:.1f} s), {LAUNCHED['after']} more steps trained, final "
        f"loss {drv.losses[-1]:.5f}; K1 launches {counts['decode_spatial']}")

    # the same kill with respawn=False: the launcher's error, not a hang
    logs2 = [os.path.join(leg_dir, f"fail{i}.log") for i in range(2)]
    fresh_registry()
    launcher = PythonProducerLauncher(
        script=CUBE_SCRIPT, num_instances=2, named_sockets=["DATA"], seed=0,
        proto="ipc", respawn=False, instance_args=launched_args(logs2))
    error = None
    with launcher:
        pids = list(launcher.launch_info.processes)
        dirs = [launcher._ipc_dir, launcher._shm_registry]
        pipe = StreamDataPipeline(
            launcher.addresses["DATA"], batch_size=BATCH, chunk=CHUNK,
            emit_packed=True, timeoutms=LAUNCHED["timeoutms"],
            ingest_workers=2, launcher=launcher)
        drv = TrainDriver(graph_step, state, inflight=2, sync_every=4)
        it = iter(pipe)
        try:
            reset_launch_counts()
            for batch in it:
                drv.submit(batch)
                if drv.steps >= LAUNCHED["before_kill"] and min(
                        s.received for s in pipe.shards) > 0:
                    break
            victim = launcher.processes[1]
            os.kill(victim.pid, signal.SIGKILL)
            victim.wait(timeout=30)
            t_kill = time.perf_counter()
            try:
                for batch in it:
                    drv.submit(batch)
                    if time.perf_counter() - t_kill > 4 * timeout_s + 60:
                        fail(f"{label}: no error {4 * timeout_s + 60:.0f} s "
                             "after the kill with respawn=False")
            except RuntimeError as e:
                error = e
            raise_s = time.perf_counter() - t_kill
            drv.drain()
            torch.cuda.synchronize()
            counts2 = launch_counts()
        finally:
            pipe.stop()
    fleet_gone(label + " (respawn=False)", pids, dirs, shm_before)
    if error is None or "producer instances died" not in str(error) or (
            "1: -9" not in str(error)):
        fail(f"{label}: respawn=False ended with {error!r}, not the "
             "launcher's dead-producer error for producer 1")
    if raise_s > timeout_s + 5:
        fail(f"{label}: the launcher's error came {raise_s:.2f} s after the "
             f"kill, past the {timeout_s:.1f} s receive timeout + 5 s")
    log(f"{label} with respawn=False on {card}: SIGKILL of producer 1 after "
        f"{drv.steps} steps raised {error!r} {raise_s:.2f} s after the kill "
        f"(receive timeout {timeout_s:.1f} s); K1 launches "
        f"{counts2['decode_spatial']}; no process, directory or segment "
        "left by either fleet")
    return {"img_s": img_s, "own_frames_s": own, "wall_s": wall,
            "images": images, "restart_s": restart_s, "raise_s": raise_s,
            "verdict": verdict.render(),
            "launches": {k: counts[k] + counts2[k] for k in counts}}


def fake_blender_leg(tmp: str, card: str) -> dict:
    """The port's ``BlenderLauncher`` starts the example scene script
    ``blendjax_torch/examples/datagen/cube.blend.py`` through a ``blender``
    wrapper written by the port's ``write_fake_blender`` (``python -m
    blendjax_torch.testing.fake_blender``), with the UI on, so the scene
    publishes offscreen-rendered RGB frames beside its corners. The frames
    go through ``StreamDataPipeline(batch_size=BLENDER["batch"])`` onto the
    card and train ``BLENDER["steps"]`` steps of ``train.py``'s direct loop
    (``CapturedStep(make_supervised_step())`` on a full-width
    ``CubeRegressor(in_channels=3)``). Fails unless it received at least
    ``steps x batch`` messages, every loss is finite, and no process,
    directory or ``/dev/shm`` segment is left."""
    import torch

    from blendjax_torch.data import StreamDataPipeline
    from blendjax_torch.launcher import BlenderLauncher
    from blendjax_torch.models import CubeRegressor
    from blendjax_torch.testing import write_fake_blender
    from blendjax_torch.train import (
        CapturedStep,
        make_supervised_step,
        make_train_state,
    )

    label = "fake-blender leg"
    t0 = time.perf_counter()
    bindir = os.path.join(tmp, "fake-blender-bin")
    write_fake_blender(bindir)
    shm_before = set(os.listdir("/dev/shm"))
    kids0 = live_children()
    state = make_train_state(CubeRegressor(in_channels=3).init_params(0))
    step = CapturedStep(make_supervised_step())
    losses, shapes = [], set()
    launcher = BlenderLauncher(
        script=os.path.join(EXAMPLES_DIR, "datagen", "cube.blend.py"),
        num_instances=1, named_sockets=["DATA"], seed=0, background=False,
        blend_path=[bindir])
    with launcher:
        pids = list(launcher.launch_info.processes)
        dirs = [launcher._ipc_dir, launcher._shm_registry]
        pipe = StreamDataPipeline(launcher.addresses["DATA"],
                                  batch_size=BLENDER["batch"],
                                  timeoutms=60_000)
        try:
            for batch in pipe:
                shapes.add(tuple(batch["image"].shape))
                state, m = step(state, {"image": batch["image"],
                                        "xy": batch["xy"]})
                losses.append(m["loss"].reshape(-1)[-1])
                if len(losses) >= BLENDER["steps"]:
                    break
            torch.cuda.synchronize()
            messages = pipe.messages
        finally:
            pipe.stop()
    deadline = time.monotonic() + 10
    while live_children() - kids0 and time.monotonic() < deadline:
        time.sleep(0.1)
    kids = sorted(live_children() - kids0)
    fleet_gone(label, pids, dirs, shm_before)
    values = [float(v) for v in losses]
    wall = time.perf_counter() - t0
    if len(values) < BLENDER["steps"] or not all(
            math.isfinite(v) for v in values):
        fail(f"{label}: losses {values} over {BLENDER['steps']} steps")
    if messages < BLENDER["steps"] * BLENDER["batch"]:
        fail(f"{label}: {messages} messages for {BLENDER['steps']} steps of "
             f"{BLENDER['batch']}")
    if kids:
        fail(f"{label}: left behind child processes {kids}")
    log(f"{label} on {card}: cube.blend.py under the port's fake Blender "
        f"(UI on), {messages} messages received, frames {sorted(shapes)}, "
        f"{len(values)} captured steps trained (losses "
        f"{[round(v, 5) for v in values]}); {wall:.2f} s in all; left over: "
        "0 processes, 0 directories, 0 segments")
    return {"messages": messages, "steps": len(values), "losses": values,
            "wall_s": wall, "shapes": sorted(shapes)}


def gym_leg(tmp: str, card: str) -> dict:
    """The port's cartpole script started by ``PythonProducerLauncher(
    named_sockets=["GYM"], proto="ipc")`` and driven by the port's
    ``RemoteEnv`` as ``bench.py``'s ``measure_rl_hz`` drives the JAX
    package's: 100 warm-up steps, then ``GYM["seconds"]`` of ``step(0.0)``
    with a reset at ``done``; prints steps/s and the round trip's
    percentiles. Gate: two ``reset(seed=7)`` runs under one fixed action
    sequence (a reset at ``done``) give bit-identical observations over
    200 steps."""
    import numpy as np

    from blendjax_torch.env import RemoteEnv
    from blendjax_torch.launcher import PythonProducerLauncher

    label = "gym leg"
    shm_before = set(os.listdir("/dev/shm"))
    launcher = PythonProducerLauncher(
        script=CARTPOLE_SCRIPT, num_instances=1, named_sockets=["GYM"],
        seed=0, proto="ipc")
    actions = np.random.default_rng(0).uniform(-4, 4, GYM["steps"])
    with launcher:
        pids = list(launcher.launch_info.processes)
        dirs = [launcher._ipc_dir, launcher._shm_registry]
        env = RemoteEnv(launcher.addresses["GYM"][0], timeoutms=30_000)
        try:
            env.reset()
            for _ in range(GYM["warmup"]):
                if env.step(0.0)[2]:
                    env.reset()
            rtt, resets = [], 0
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < GYM["seconds"]:
                t1 = time.perf_counter()
                done = env.step(0.0)[2]
                rtt.append(time.perf_counter() - t1)
                if done:
                    env.reset()
                    resets += 1
            dt = time.perf_counter() - t0
            runs = []
            for _ in range(2):
                obs, _ = env.reset(seed=GYM["seed"])
                run = [obs]
                for a in actions:
                    obs, _, done, _ = env.step(float(a))
                    run.append(obs)
                    if done:
                        run.append(env.reset()[0])
                runs.append(np.stack(run))
        finally:
            env.close()
    fleet_gone(label, pids, dirs, shm_before)
    if not (runs[0].shape == runs[1].shape and np.array_equal(*runs)):
        fail(f"{label}: two reset(seed={GYM['seed']}) runs under one action "
             f"sequence differ: shapes {runs[0].shape} {runs[1].shape}")
    episodes = len(runs[0]) - GYM["steps"] - 1
    pct = percentiles_ms(rtt)
    steps_s = len(rtt) / dt
    log(f"{label} on {card}: {steps_s:.1f} steps/s ({len(rtt)} steps of "
        f"step(0.0) in {dt:.2f} s, {resets} resets), round trip p50 "
        f"{pct['p50_ms']:.4f} ms, p99 {pct['p99_ms']:.4f} ms, max "
        f"{pct['max_ms']:.4f} ms; two reset(seed={GYM['seed']}) runs of "
        f"{GYM['steps']} steps ({episodes} episode ends each) bit-identical")
    return {"steps_s": steps_s, "steps": len(rtt), **pct}


def duplex_leg(tmp: str, card: str) -> dict:
    """One producer with a ``CTRL`` socket (``DUPLEX_SCRIPT``, written into
    the leg's directory) that sends every message back through
    ``DuplexChannel`` on ``SimEngine`` frames; the consumer's
    ``PairChannel`` sends ``DUPLEX["messages"]`` timed messages one at a
    time, after one that waits for the producer to start.
    Gate: every ``btmid`` comes back, from btid 0 (the handshake's), with
    the consumer's btid and payload. Prints the round trip's
    percentiles."""
    from blendjax_torch.launcher import PythonProducerLauncher
    from blendjax_torch.transport import PairChannel

    label = "duplex leg"
    leg_dir = tempfile.mkdtemp(dir=tmp)
    script = os.path.join(leg_dir, "duplex_echo.py")
    with open(script, "w") as f:
        f.write(DUPLEX_SCRIPT)
    shm_before = set(os.listdir("/dev/shm"))
    launcher = PythonProducerLauncher(
        script=script, num_instances=1, named_sockets=["CTRL"], seed=0,
        proto="ipc")
    rtt, bad = [], []
    with launcher:
        pids = list(launcher.launch_info.processes)
        dirs = [launcher._ipc_dir, launcher._shm_registry]
        duplex = PairChannel(launcher.addresses["CTRL"][0], btid=77)
        try:
            # message 0 waits for the producer to start: not timed
            for i in range(DUPLEX["messages"] + 2):
                stop = i == DUPLEX["messages"] + 1
                t0 = time.perf_counter()
                mid = duplex.send(i=i, stop=stop)
                rep = duplex.recv(timeoutms=30_000)
                if 0 < i and not stop:
                    rtt.append(time.perf_counter() - t0)
                if rep is None:
                    fail(f"{label}: message {i} not answered within 30 s")
                echo = rep.get("echo", {})
                if not (rep["btid"] == 0 and echo.get("btmid") == mid
                        and echo.get("btid") == 77 and echo.get("i") == i):
                    bad.append((i, rep))
            code = launcher.processes[0].wait(timeout=30)
        finally:
            duplex.close()
    fleet_gone(label, pids, dirs, shm_before)
    if bad or code != 0:
        fail(f"{label}: {len(bad)} echoes wrong (first {bad[:2]}), producer "
             f"exit code {code}")
    pct = percentiles_ms(rtt)
    log(f"{label} on {card}: {len(rtt)} messages, every btmid back from "
        f"btid 0; round trip p50 {pct['p50_ms']:.4f} ms, p99 "
        f"{pct['p99_ms']:.4f} ms, max {pct['max_ms']:.4f} ms")
    return {"messages": len(rtt), **pct}


# -- phase 5b: graph parity and the supervised AOT set ---------------------------


# -- phase 5g: the mesh phase ----------------------------------------------------


def init_mesh_group(tmp: str) -> None:
    """The NCCL process group of world size 1 on card 0, through a
    ``FileStore`` in the run's temp directory. A failure raises: there is
    no fallback to another backend."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp, "nccl-store"), 1),
        rank=0, world_size=1, timeout=datetime.timedelta(seconds=120),
        device_id=torch.device("cuda", 0))


def recorded_losses(prefix: str, n: int, mesh=None) -> dict:
    """The first ``n`` chunk groups of the flagship recording through a
    captured fused step from ``CubeRegressor().init_params(0)``: a
    single-card ``TrainDriver`` or, with ``mesh``, ``MeshTrainDriver.build``
    (each prewarmed); returns the per-update losses, the launches and the
    replays."""
    import torch

    from blendjax_torch.data import StreamDataPipeline
    from blendjax_torch.kernels import launch_counts, reset_launch_counts
    from blendjax_torch.models import CubeRegressor
    from blendjax_torch.train import (
        CapturedStep,
        MeshTrainDriver,
        TrainDriver,
        make_fused_tile_step,
        make_train_state,
    )

    if mesh is None:
        state = make_train_state(CubeRegressor().init_params(0))
        graph_step = CapturedStep(make_fused_tile_step())
        drv = TrainDriver(graph_step, state, inflight=2, sync_every=4)
    else:
        drv = MeshTrainDriver.build(CubeRegressor(), mesh, rng=0, fused=True,
                                    aot=True, inflight=2, sync_every=4)
        graph_step, state = drv.step, drv.state
    prewarm(graph_step, state, FLAGSHIP)
    tap = _FirstLosses(graph_step, n)
    drv.step = tap
    pipe = StreamDataPipeline.from_recording(prefix, batch_size=BATCH,
                                             emit_packed=True, chunk=CHUNK,
                                             mesh=mesh)
    reset_launch_counts()
    replays0 = graph_step.graph_replays
    try:
        for i, batch in enumerate(pipe):
            drv.submit(batch)
            if i + 1 >= n:
                break
        drv.drain()
        torch.cuda.synchronize()
    finally:
        pipe.stop()
    return {"losses": tap.values(), "launches": launch_counts(),
            "replays": graph_step.graph_replays - replays0,
            "steps": drv.steps}


def mesh_flagship_leg(tmp: str, prefix: str, mesh, flagship: dict,
                      card: str) -> dict:
    """Phase 5g leg 1: ``MeshTrainDriver.build(CubeRegressor(), mesh,
    fused=True, aot=True)`` on ``create_mesh({"data": -1})`` (NCCL, world
    size 1), live from the flagship stream through
    ``StreamDataPipeline(mesh=)``; one graph replay per step call and K1
    launched. On the replay leg's recording, its losses must be bit-equal
    to the single-card ``TrainDriver``'s (both captured, deterministic
    algorithms). The first step call's all-reduce bytes, which the device
    ledger publishes, must be the gradient and loss bytes its updates
    reduce."""
    import torch.distributed as dist

    from blendjax_torch.models import CubeRegressor
    from blendjax_torch.parallel.mesh import mesh_shape
    from blendjax_torch.train import MeshTrainDriver

    drv = MeshTrainDriver.build(CubeRegressor(), mesh, rng=0, fused=True,
                                aot=True, inflight=2, sync_every=4)
    leg = run_leg("mesh flagship leg", MESH_FLAGSHIP, drv.state, tmp,
                  graph_step=drv.step, mesh=mesh, driver=drv, alone=False,
                  stages=True)
    if leg["launches"]["decode_spatial"] <= 0:
        fail("mesh flagship leg never launched decode_spatial (K1)")
    if leg["dispatch_per_step"] != 1.0:
        fail(f"mesh flagship leg: {leg['dispatch_per_step']} step calls per "
             "chunk group")
    # the collective ledger gate
    params = sum(p.numel() for p in drv.state.model.parameters())
    updates = drv.collective_images // BATCH
    want = updates * (params + 1) * 4  # f32 gradients and the loss
    tally = drv.collective_tally
    gauge = leg["obs"]["report"]["gauges"].get(
        "device.collective.all_reduce_bytes")
    if tally["per_kind"]["all-reduce"] != want or gauge != want:
        fail(f"mesh flagship leg: all-reduce bytes {tally['per_kind']} "
             f"(gauge {gauge}) for {updates} updates of {params} f32 "
             f"parameters and the loss: want {want}")
    # bit-equality with the single-card driver on the recording
    n = REPLAY["compare"]
    _deterministic(True)
    try:
        one = recorded_losses(prefix, n)
        mesh_run = recorded_losses(prefix, n, mesh)
    finally:
        _deterministic(False)
    if mesh_run["losses"] != one["losses"] or not one["losses"]:
        diff = max(abs(a - b) for a, b in zip(mesh_run["losses"],
                                              one["losses"]))
        fail(f"mesh flagship leg: losses on the recording differ from the "
             f"single-card TrainDriver's (max |diff| {diff:.3e})")
    if mesh_run["replays"] != mesh_run["steps"]:
        fail("mesh flagship leg: not one graph replay per step on the "
             "recording")
    shape = mesh_shape(mesh)
    out = {**leg, "data_axis": shape["data"],
           "world": dist.get_world_size(), "tally": tally,
           "replay_launches": mesh_run["launches"],
           "compared": len(one["losses"])}
    log(f"mesh flagship leg on {card}: data axis {shape['data']}, world size "
        f"{out['world']} (NCCL); live {leg['img_s']:.1f} img/s beside the "
        f"single-card flagship's {flagship['img_s']:.1f} img/s; "
        f"{producer_text(leg['producers'])}; verdict {leg['verdict']}; "
        f"{leg['steps']} steps, one graph replay per step call; launches "
        f"{leg['launches']}; first step call's collectives {tally} "
        f"({updates} updates x ({params} parameters + the loss) x 4 bytes "
        f"all-reduced); on the recording the first {len(one['losses'])} "
        f"updates' losses bit-equal to the single-card TrainDriver's; stats "
        f"{ {k: drv.stats[k] for k in ('chips', 'processes', 'layout', 'data_axis_size')} }")
    return out


def first_groups(prefix: str, n: int) -> list:
    """Copies of the recording's first ``n`` packed chunk groups."""
    from blendjax_torch.data import StreamDataPipeline

    pipe = StreamDataPipeline.from_recording(prefix, batch_size=BATCH,
                                             emit_packed=True, chunk=CHUNK)
    out = []
    try:
        for batch in pipe:
            out.append({**batch, "_packed": batch["_packed"].clone()})
            if len(out) >= n:
                break
    finally:
        pipe.stop()
    return out


def sp_phase(prefix: str, card: str) -> dict:
    """Phase 5g leg 2: the full-width StreamFormer with ``use_ring=True``,
    ``sp_mode="ulysses"`` on ``create_mesh({"data": 1, "seq": 1})``, flash
    attention, through ``MeshTrainDriver.build(fused=True)`` on the
    recording's first ``warmup + steps`` chunk groups, eagerly and with
    ``aot=True`` (every plan signature captured before the run), cuDNN
    deterministic: every K4a, K4b and K4c launch is Ulysses' (each kernel
    depth x updates times, as many as Ulysses' flash calls, counted
    through the replays in the captured run), and the per-update losses
    match the non-mesh step's on the same groups within K4's bar. Then the
    same groups with ``sp_mode="ring"``: its largest loss difference, held
    at the bf16 bar and at the one-block bar (``RING_ONE_BLOCK_REL``).
    Each captured run against its eager run (:func:`sp_capture_gates`):
    one replay per step call, no eager call, the losses bit-equal, K1 and
    K4a-c launches and the collectives by kind and axis equal, the
    Ulysses graph holding its all-to-alls. Logs img/s and the host ms per
    step call of each run, captured, eager and the non-mesh step's."""
    import torch

    from blendjax_torch.kernels import (
        launch_counts,
        reset_launch_counts,
        variant_counts,
    )
    from blendjax_torch.models import StreamFormer
    from blendjax_torch.parallel import create_mesh, ulysses
    from blendjax_torch.parallel.collectives import (
        collective_counts,
        reset_collective_counts,
        tally_diff,
    )
    from blendjax_torch.train import (
        CapturedStep,
        MeshTrainDriver,
        TrainDriver,
        make_fused_tile_step,
        make_train_state,
    )

    mesh = create_mesh({"data": 1, "seq": 1})
    groups = first_groups(prefix, MESH_SP["warmup"] + MESH_SP["steps"])
    base = StreamFormer(**FORMER, attn_backend="flash",
                        image_shape=SHAPE).init_params(0)
    weights = {k: v.clone() for k, v in base.state_dict().items()}

    def run(label, model, mesh_run, aot=False):
        model.load_state_dict(weights)
        if mesh_run:
            drv = MeshTrainDriver.build(model, mesh, fused=True,
                                        loss_fn=former_loss, inflight=2,
                                        sync_every=4, aot=aot)
        else:
            step = make_fused_tile_step(former_loss)
            drv = TrainDriver(CapturedStep(step) if aot else step,
                              make_train_state(model), inflight=2,
                              sync_every=4)
        inner = drv.step
        if aot:  # the captures are not the run's
            for g in groups:
                inner.prepare(drv.state, g)
        seen, host = [], {"s": 0.0, "calls": 0, "on": False}

        def tap(state, batch):
            t = time.perf_counter()
            state, m = inner(state, batch)
            if host["on"]:
                host["s"] += time.perf_counter() - t
                host["calls"] += 1
            seen.append(m["loss"])
            return state, m

        drv.step = tap
        updates = 0
        reset_launch_counts()
        ulysses.reset_counts()
        reset_collective_counts()
        before = collective_counts()
        for i, g in enumerate(groups):
            if i == MESH_SP["warmup"]:
                drv.drain()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                images = 0
                host["on"] = True
            drv.submit(g)
            updates += int(g["_packed"].shape[0])
            if i >= MESH_SP["warmup"]:
                images += int(g["_packed"].shape[0]) * BATCH
        drv.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses = [x for v in seen for x in v.float().reshape(-1).tolist()]
        if not all(math.isfinite(v) for v in losses):
            fail(f"{label}: non-finite loss in {losses}")
        graphs = [g for g in getattr(inner, "_graphs", {}).values() if g]
        return {"losses": losses, "launches": launch_counts(),
                "variants": variant_counts(), "updates": updates,
                "ulysses_flash_calls": ulysses.flash_calls,
                "img_s": images / wall, "wall_s": wall,
                "host_ms": host["s"] * 1e3 / max(host["calls"], 1),
                "calls": len(groups),
                "tally": tally_diff(collective_counts(), before),
                "replays": getattr(inner, "graph_replays", 0),
                "eager_calls": getattr(inner, "eager_calls", 0),
                "graph_collectives": [g.collectives for g in graphs]}

    def sp_model(mode):
        return StreamFormer(**FORMER, attn_backend="flash", image_shape=SHAPE,
                            use_ring=True, sp_mode=mode, mesh=mesh)

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        uly = run("ulysses leg", sp_model("ulysses"), True)
        uly_aot = run("captured ulysses leg", sp_model("ulysses"), True,
                      aot=True)
        plain = run("non-mesh streamformer", StreamFormer(
            **FORMER, attn_backend="flash", image_shape=SHAPE), False)
        plain_aot = run("captured non-mesh streamformer", StreamFormer(
            **FORMER, attn_backend="flash", image_shape=SHAPE), False,
            aot=True)
        ring = run("ring leg", sp_model("ring"), True)
        ring_aot = run("captured ring leg", sp_model("ring"), True, aot=True)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    want = FORMER["depth"] * uly["updates"]
    counts = uly["launches"]
    for name in ("flash_attention_fwd", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq"):
        if counts[name] != want or uly["ulysses_flash_calls"] != want:
            fail(f"ulysses leg: {name} launched {counts[name]} times and "
                 f"Ulysses ran {uly['ulysses_flash_calls']} flash calls, not "
                 f"depth x updates = {want}")
    if ring["launches"]["flash_attention_fwd"]:
        fail(f"ring leg launched the flash kernels: {ring['launches']}")
    if counts["decode_spatial"] <= 0:
        fail("ulysses leg never launched decode_spatial (K1)")
    sp_capture_gates("ulysses", uly_aot, uly, want)
    sp_capture_gates("ring", ring_aot, ring, 0)
    sp_capture_gates("non-mesh", plain_aot, plain, want)

    def rel(a, b):
        return max(abs(x - y) / max(abs(y), 1e-12) for x, y in zip(a, b))

    u_rel = rel(uly["losses"], plain["losses"])
    r_rel = rel(ring["losses"], plain["losses"])
    # where the Ulysses step's time goes: one all-to-all, and attention
    # forward and backward through Ulysses and locally, at the leg's shape
    from blendjax_torch.ops.attention import local_attention
    from blendjax_torch.parallel import all_to_all, ulysses_attention

    heads = FORMER["num_heads"]
    shape = (BATCH, base.tokens, heads, FORMER["dim"] // heads)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(shape, device="cuda", dtype=torch.bfloat16,
                               generator=gen) for _ in range(4))
    q, k, v = (t.requires_grad_() for t in (q, k, v))

    def through(attend):
        def call():
            attend().backward(do)
        return call

    a2a = time_ms(lambda: all_to_all(q.detach(), mesh, "seq", 2, 1),
                  reps=10, windows=5)
    via = time_ms(through(lambda: ulysses_attention(
        q, k, v, mesh, backend="flash")), reps=5, windows=5)
    local = time_ms(through(lambda: local_attention(
        q, k, v, backend="flash")), reps=5, windows=5)
    if not u_rel <= K4_LOSS_REL:
        fail(f"ulysses leg: per-update losses differ from the non-mesh "
             f"step's by rel {u_rel:.3e} (bar {K4_LOSS_REL})")
    if not r_rel <= min(BF16_LOSS_REL, RING_ONE_BLOCK_REL):
        fail(f"ring leg: per-update losses differ from the non-mesh step's "
             f"by rel {r_rel:.3e} (one-block bar {RING_ONE_BLOCK_REL}, bf16 "
             f"bar {BF16_LOSS_REL})")
    log(f"sequence-parallel legs on {card}: StreamFormer {FORMER} on "
        f"{ {'data': 1, 'seq': 1} } (NCCL), {uly['updates']} updates each, "
        f"cuDNN deterministic; ulysses: K4a/K4b/K4c launches "
        f"{[counts[k] for k in ('flash_attention_fwd', 'flash_attention_bwd_dkv', 'flash_attention_bwd_dq')]}"
        f" = Ulysses' flash calls {uly['ulysses_flash_calls']} = depth x "
        f"updates {want}, variants {uly['variants']}; "
        f"{uly['img_s']:.1f} img/s eager over {MESH_SP['steps']} steps "
        f"beside the non-mesh step's {plain['img_s']:.1f}; largest per-update "
        f"loss difference against the non-mesh step: ulysses rel {u_rel:.3e} "
        f"(bar {K4_LOSS_REL}), ring rel {r_rel:.3e} (one-block bar "
        f"{RING_ONE_BLOCK_REL}, bf16 bar {BF16_LOSS_REL}, ring "
        f"{ring['img_s']:.1f} img/s)")
    runs = {"ulysses": (uly, uly_aot), "ring": (ring, ring_aot),
            "non-mesh": (plain, plain_aot)}
    log(f"sequence-parallel legs captured on {card}: img/s over "
        f"{MESH_SP['steps']} step calls (host ms per step call), captured "
        "against eager: " + "; ".join(
            f"{name} {g['img_s']:.1f} ({g['host_ms']:.3f}) against "
            f"{e['img_s']:.1f} ({e['host_ms']:.3f})"
            for name, (e, g) in runs.items())
        + f"; the captured runs one replay per step call and no eager call, "
        f"losses bit-equal to their eager runs', launches and collectives "
        f"equal (ulysses {uly_aot['tally']['per_kind']} by axis "
        f"{uly_aot['tally']['per_axis']}; ring {ring_aot['tally']['per_kind']}"
        f" by axis {ring_aot['tally']['per_axis']}); captured Ulysses' flash "
        f"calls through the replays {uly_aot['ulysses_flash_calls']}")
    log(f"ulysses at {shape} bf16 on {card}: one all-to-all (NCCL, one "
        f"rank) {a2a['ms']:.4f} ms on the card ({a2a['min_ms']:.4f}-"
        f"{a2a['max_ms']:.4f}), {a2a['host_ms']:.4f} ms of host per call; "
        f"attention forward and backward through ulysses_attention "
        f"{via['ms']:.4f} ms (host {via['host_ms']:.4f}) against "
        f"local_attention's {local['ms']:.4f} ms (host "
        f"{local['host_ms']:.4f})")
    return {"ulysses": uly, "ulysses_aot": uly_aot, "plain": plain,
            "plain_aot": plain_aot, "ring": ring, "ring_aot": ring_aot,
            "ulysses_rel": u_rel, "ring_rel": r_rel,
            "a2a": a2a, "via_ulysses": via, "local": local}


def sp_capture_gates(name: str, graph: dict, eager: dict,
                     flash: int) -> None:
    """A captured sequence-parallel (or non-mesh) run against its eager
    run on the same groups: one graph replay per step call and no eager
    call, the losses bit-equal, K1 and each of K4a-c launched as often
    (``flash`` times each, counted through the replays, and as many
    Ulysses flash calls when the run is Ulysses'), the collectives by kind
    and axis equal, and the Ulysses graphs holding their all-to-alls."""
    kernels = ("decode_spatial", "flash_attention_fwd",
               "flash_attention_bwd_dkv", "flash_attention_bwd_dq")
    problems = []
    if graph["replays"] != graph["calls"] or graph["eager_calls"]:
        problems.append(f"{graph['replays']} replays and "
                        f"{graph['eager_calls']} eager calls for "
                        f"{graph['calls']} step calls")
    if graph["losses"] != eager["losses"] or not graph["losses"]:
        problems.append(f"losses {graph['losses']} against eager "
                        f"{eager['losses']}")
    counts = {k: (graph["launches"][k], eager["launches"][k])
              for k in kernels}
    if (any(g != e for g, e in counts.values()) or counts[kernels[0]][0] <= 0
            or any(counts[k][0] != flash for k in kernels[1:])):
        problems.append(f"launches (graph, eager) {counts}, want {flash} "
                        "of each flash kernel")
    if graph["ulysses_flash_calls"] != eager["ulysses_flash_calls"] or (
            name == "ulysses" and graph["ulysses_flash_calls"] != flash):
        problems.append(f"Ulysses' flash calls {graph['ulysses_flash_calls']}"
                        f" against eager {eager['ulysses_flash_calls']}")
    if (graph["tally"]["per_kind"] != eager["tally"]["per_kind"]
            or graph["tally"]["per_axis"] != eager["tally"]["per_axis"]):
        problems.append(f"collectives {graph['tally']} against eager "
                        f"{eager['tally']}")
    if name == "ulysses" and not all(
            c["per_kind"]["all-to-all"] > 0
            for c in graph["graph_collectives"]):
        problems.append("a Ulysses graph without its all-to-alls: "
                        f"{graph['graph_collectives']}")
    if problems:
        fail(f"captured {name} leg: " + "; ".join(problems))


def echo_mesh_leg(card: str) -> dict:
    """Phase 5g leg 3: the echo fused step of full-width ``CubeRegressor()``
    over a ring sharded on ``create_mesh({"data": 1})`` (the gather on the
    card from the token's device indices, its all-reduce over one rank),
    with the echo leg's default augmentation, eagerly and through
    ``CapturedStep(step, mesh=mesh)``, from one model on twin reservoirs
    filled with the same seeded frames, ``ECHO_MESH["steps"]`` draws each,
    cuDNN deterministic: the captured run one replay per step call and no
    eager call, its losses and parameters bit-equal to the eager run's,
    the collectives by kind and axis equal (the gather's all-reduce
    inside the graph), the donation audit of the state and the ring 1.0
    on both. Logs each run's ms per step after the first (the
    capture's)."""
    import numpy as np
    import torch

    from blendjax_torch.data import SampleReservoir
    from blendjax_torch.data.echo import default_echo_augment
    from blendjax_torch.models import CubeRegressor
    from blendjax_torch.parallel import create_mesh, ring_sharding
    from blendjax_torch.parallel.collectives import (
        collective_counts,
        tally_diff,
    )
    from blendjax_torch.testing.donation import DonationAudit, state_tree
    from blendjax_torch.train import (
        CapturedStep,
        make_mesh_echo_fused_step,
        make_train_state,
    )

    mesh = create_mesh({"data": 1})
    cap = ECHO_MESH["capacity"]
    rng = np.random.default_rng(4)
    frames = torch.from_numpy(rng.integers(0, 256, (cap, *SHAPE, 4),
                                           np.uint8)).cuda()
    xy = torch.from_numpy((rng.random((cap, 8, 2)) * SHAPE[::-1])
                          .astype(np.float32)).cuda()
    draws = [rng.integers(0, cap, BATCH) for _ in range(ECHO_MESH["steps"])]
    runs = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name in ("eager", "captured"):
            res = SampleReservoir(cap, augment=default_echo_augment(
                points_key="xy"), rng=3, sharding=ring_sharding(mesh))
            for i in range(0, cap, BATCH):
                res.insert({"image": frames[i:i + BATCH],
                            "xy": xy[i:i + BATCH]})
            state = make_train_state(CubeRegressor().init_params(0),
                                     mesh=mesh)
            step = make_mesh_echo_fused_step(state, mesh, res)
            if name == "captured":
                step = CapturedStep(step, mesh=mesh)
            audit = DonationAudit()
            losses, before = [], collective_counts()
            for i, idx in enumerate(draws):
                losses.append(step(state, res.draw_token(idx))[1]["loss"])
                if i == 0:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    audit.snapshot(name, {**state_tree(state),
                                          **res.device_buffers()})
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / (len(draws) - 1)
            audit.snapshot(name, {**state_tree(state),
                                  **res.device_buffers()})
            runs[name] = {"losses": torch.stack(losses), "state": state,
                          "step": step, "ms": ms, "audit": audit,
                          "tally": tally_diff(collective_counts(), before)}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    eager, graph = runs["eager"], runs["captured"]
    kinds = [(r["tally"]["per_kind"], r["tally"]["per_axis"])
             for r in (eager, graph)]
    same = (torch.equal(eager["losses"], graph["losses"])
            and all(torch.equal(p, q) for p, q in zip(
                eager["state"].model.parameters(),
                graph["state"].model.parameters())))
    problems = []
    if not same:
        problems.append(f"losses {graph['losses'].tolist()} against eager "
                        f"{eager['losses'].tolist()} (or the parameters)")
    if graph["step"].graph_replays != len(draws) or graph["step"].eager_calls:
        problems.append(f"{graph['step'].graph_replays} replays and "
                        f"{graph['step'].eager_calls} eager calls for "
                        f"{len(draws)} step calls")
    if kinds[0] != kinds[1] or kinds[1][0]["all-reduce"] <= 0 or not all(
            g.collectives["per_kind"]["all-reduce"] > 0
            for g in graph["step"]._graphs.values()):
        problems.append(f"collectives (eager, graph) {kinds}")
    if not math.isfinite(float(graph["losses"][-1])):
        problems.append("a non-finite loss")
    if problems:
        fail("echo mesh leg on a sharded ring: " + "; ".join(problems))
    for name in runs:
        audit_verdict(f"echo mesh leg ({name})", runs[name]["audit"])
    log(f"echo mesh leg on {card}: CubeRegressor() echo fused step over a "
        f"ring of {cap} frames sharded on {{'data': 1}} (NCCL at one rank), "
        f"{len(draws)} draws of {BATCH}, eager and one graph replay each, "
        f"no eager call, bit-equal (losses, parameters), collectives equal "
        f"{kinds[1][0]} by axis {kinds[1][1]}; ms per step after the first: "
        f"eager {eager['ms']:.3f}, captured {graph['ms']:.3f}; losses "
        f"{[round(x, 6) for x in graph['losses'].tolist()]}")
    return {k: {"ms": v["ms"], "losses": v["losses"].tolist()}
            for k, v in runs.items()}


def mesh_phase(tmp: str, prefix: str, flagship: dict, card: str) -> dict:
    """Phase 5g: the NCCL group, the mesh flagship leg, the
    sequence-parallel legs, the echo step over a sharded ring; the group
    is destroyed after."""
    import torch.distributed as dist

    from blendjax_torch.parallel import create_mesh

    init_mesh_group(tmp)
    try:
        mesh = create_mesh({"data": -1})
        out = {"flagship": mesh_flagship_leg(tmp, prefix, mesh, flagship,
                                             card),
               "sp": sp_phase(prefix, card),
               "echo": echo_mesh_leg(card)}
        # phase 5h's pipeline leg, on this group
        out["pipeline"] = pipeline_leg(card)
        return out
    finally:
        dist.destroy_process_group()


# -- phase 5g, two ranks on one card: the split of the work --------------------

# two processes on the one card, a gloo group over its tensors (NCCL
# refuses two ranks of one device): (a) the full-width StreamFormer on
# {"data": 1, "tp": 2} fed live by the flagship's 2 producers for
# ``groups`` chunk groups (recorded), (b) the MoE StreamFormer on
# {"data": 1, "expert": 2} on the first ``moe_groups`` of that recording,
# (c) the echo of the flagship model on {"data": 2}, stamped batches from
# one synthetic scenario producer per rank, ``echo_steps`` draws. The
# losses of (a) and (b) against a one-rank run of the same recording on
# the same card, update by update, within ``loss_rel`` of the one-rank
# loss: bf16 compute, the row-split products summed in another order than
# the whole product. Readings on one H100 80GB HBM3 at 700.00 W: largest
# gaps 5.524e-06 to 1.127e-05 (tp, 18-20 updates) and 6.6e-07 to 1.8e-06
# (expert, 11-12); a copy_to_axis with an identity backward read 2.168e-03
TWO_RANK = {"groups": 6, "moe_groups": 3, "echo_steps": 48,
            "echo_capacity": 64, "echo_factor": 4, "echo_batch": 8,
            "checked_draws": 4, "loss_rel": 1e-4, "deadline_s": 300.0}
# the collective kinds the port issues; the gloo probe reads which of them
# gloo refuses on CUDA tensors (those must be the ones the port stages)
PORT_KINDS = ("all-reduce", "all-gather", "all-to-all", "collective-permute")


def _probe_op(kind: str) -> None:
    """One raw collective of ``kind`` on CUDA tensors over the default
    group (two ranks, the same call on both)."""
    import torch
    import torch.distributed as dist

    peer = 1 - dist.get_rank()
    x = torch.ones(4, device="cuda")
    if kind == "all-reduce":
        dist.all_reduce(x.clone())
    elif kind == "all-gather":
        dist.all_gather([torch.empty_like(x) for _ in range(2)], x)
    elif kind == "all-to-all":
        dist.all_to_all_single(torch.empty_like(x), x)
    elif kind == "reduce-scatter":
        dist.reduce_scatter_tensor(torch.empty(2, device="cuda"), x)
    else:  # collective-permute: the P2P pair ring_permute issues
        y = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, peer),
               dist.P2POp(dist.irecv, y, peer)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    torch.cuda.synchronize()


PROBE_KINDS = PORT_KINDS + ("reduce-scatter",)


def gloo_probe_child(kind: str, rank: int, wdir: str) -> None:
    """One rank of the probe of ``kind``: a gloo group of two of its own
    (so a crash takes down this probe only); writes ``accepted`` or
    ``refused: <reason>`` to ``wdir``."""
    import torch

    from blendjax_torch.parallel.mesh import init_group

    torch.cuda.set_device(0)
    init_group("cuda", store_dir=wdir, backend="gloo", rank=rank,
               world_size=2)
    try:
        _probe_op(kind)
        verdict = "accepted"
    except (RuntimeError, ValueError, NotImplementedError) as e:
        verdict = "refused: " + (str(e).strip().splitlines() or [""])[0][:160]
    with open(os.path.join(wdir, f"rank{rank}.txt"), "w") as f:
        f.write(verdict)


def start_gloo_probe(tmp: str) -> dict:
    """Start the probe of which raw collectives a gloo group of two ranks
    takes on CUDA tensors: every kind at once, each in a pair of
    processes of its own (:func:`gloo_probe_child`); collect the verdicts
    with :func:`gloo_probe_verdicts`."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    runs = {}
    for kind in PROBE_KINDS:
        wdir = tempfile.mkdtemp(dir=tmp)
        runs[kind] = (wdir, [subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
             "--gloo-probe", kind, str(r), wdir], cwd=ROOT, env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
            for r in range(2)])
    return runs


def gloo_probe_verdicts(runs: dict, timeout: float = 120.0) -> dict:
    """Each probed kind's verdict: ``accepted``, ``refused: <reason>``, or
    the two ranks' differing verdicts and exit codes (a rank that died
    writes none)."""
    deadline = time.monotonic() + timeout
    out = {}
    for kind, (wdir, procs) in runs.items():
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        verdicts = []
        for r in range(2):
            path = os.path.join(wdir, f"rank{r}.txt")
            verdicts.append(open(path).read() if os.path.exists(path)
                            else None)
        codes = [p.returncode for p in procs]
        if verdicts[0] == verdicts[1] and verdicts[0] and codes == [0, 0]:
            out[kind] = verdicts[0]
        else:
            out[kind] = f"failed: verdicts {verdicts}, exit codes {codes}"
    return out


def _replicated_bytes(model) -> int:
    """A replicated rank's train state: parameters and two AdamW moments,
    f32."""
    return 3 * 4 * sum(int(p.numel()) for p in model.parameters())


def _split_run(label: str, model, mesh, batches, aot: bool = False) -> dict:
    """``MeshTrainDriver.build(model, mesh, fused=True, aot=aot)`` over
    ``batches``: the per-update losses, this rank's launches, the
    collectives by kind and axis, the gloo stages, the resident bytes
    beside a replicated rank's, the donation audit of the state between
    the first step call and the end, the wall seconds and the ms per
    update after the first step call. With ``aot`` (an NCCL group: gloo
    runs the step eagerly) every plan signature of ``batches`` is captured
    before the run (``CapturedStep.prepare``, as the legs' prewarm: a
    signature first seen mid-run is a retrace to the device ledger), and
    the result adds the graph replays and eager calls, each graph's
    collectives, the capture ms and the bytes of the graphs' private
    pools."""
    import torch

    from blendjax_torch.kernels import launch_counts, reset_launch_counts
    from blendjax_torch.parallel import state_resident_bytes
    from blendjax_torch.parallel.collectives import (
        collective_counts,
        reset_collective_counts,
        staged_counts,
        tally_diff,
    )
    from blendjax_torch.testing.donation import DonationAudit, state_tree
    from blendjax_torch.train import MeshTrainDriver
    from blendjax_torch.train.aot import pool_bytes

    replicated = _replicated_bytes(model)
    drv = MeshTrainDriver.build(model, mesh, fused=True, loss_fn=former_loss,
                                inflight=2, sync_every=4, aot=aot)
    captured = drv.step
    if aot:
        batches = list(batches)
        for batch in batches:
            captured.prepare(drv.state, batch)
    kept = _tap_losses(drv)
    reset_launch_counts()
    reset_collective_counts()
    before = collective_counts()
    audit = DonationAudit()
    t0 = time.perf_counter()
    t1, groups = t0, 0
    for batch in batches:
        drv.submit(batch)
        groups += 1
        if groups == 1:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            audit.snapshot(label, state_tree(drv.state))
    drv.finish()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    audit.snapshot(label, state_tree(drv.state))
    losses = _update_losses(kept)
    timed = len(losses) - (kept[0].numel() if kept else 0)
    out = {"label": label, "groups": groups, "losses": losses,
           "launches": launch_counts(), "wall_s": t2 - t0,
           "ms_per_update": (t2 - t1) * 1e3 / max(timed, 1),
           "tally": tally_diff(collective_counts(), before),
           "staged": staged_counts(),
           "resident": state_resident_bytes(drv.state),
           "replicated": replicated, "audit": audit.report(),
           "donation_reuse": 1.0 if audit.all_stable() else 0.0}
    if aot:
        graphs = list(captured._graphs.values())
        segments = torch.cuda.memory_snapshot() if graphs else []
        out.update(replays=captured.graph_replays,
                   eager_calls=captured.eager_calls,
                   graph_collectives=[g.collectives for g in graphs],
                   pool_bytes=sum(pool_bytes(g, segments) for g in graphs),
                   capture_ms=sum(captured.capture_ms.values()),
                   graphs=len(graphs))
    return out


def _tap_losses(drv) -> list:
    """Keep the loss tensor of every step call ``drv`` makes (read after
    the run); returns the list they go to."""
    kept, inner = [], drv.step

    def step(state, batch):
        state, m = inner(state, batch)
        kept.append(m["loss"])
        return state, m

    drv.step = step
    return kept


def _update_losses(kept) -> list:
    """Every update's loss of the kept K-vectors, in order."""
    return [x for v in kept for x in v.float().reshape(-1).tolist()]


def _first(pipe, n: int):
    """The first ``n`` batches of ``pipe``, then stop it."""
    try:
        for i, batch in enumerate(pipe):
            yield batch
            if i + 1 >= n:
                break
    finally:
        pipe.stop()


def two_rank_tp(rank: int, wdir: str, prefix: str) -> dict:
    """Sub-leg (a): the StreamFormer on {"data": 1, "tp": 2}, live; rank 0
    (the tp group's leader) starts the producers, records what it
    receives and broadcasts each host batch to rank 1."""
    import torch.distributed as dist

    from blendjax_torch.data import StreamDataPipeline
    from blendjax_torch.models import StreamFormer
    from blendjax_torch.parallel import create_mesh

    mesh = create_mesh({"data": 1, "tp": 2}, devices="cuda")
    model = StreamFormer(**FORMER, attn_backend="flash",
                         image_shape=SHAPE).init_params(0)
    procs, box, logs = [], [None], []
    if rank == 0:
        procs, box[0], logs = start_producers(wdir, FLAGSHIP["tile"],
                                              FLAGSHIP["capacity"])
    dist.broadcast_object_list(box, src=0)
    try:
        pipe = StreamDataPipeline(
            box[0], batch_size=BATCH, chunk=CHUNK, emit_packed=True,
            mesh=mesh, timeoutms=60_000,
            record_path_prefix=prefix)
        out = _split_run("tp", model, mesh,
                         _first(pipe, TWO_RANK["groups"]))
        out["messages"] = pipe.messages
    finally:
        stop_producers(procs)
        if logs:
            reap_segments(logs)
    return out


def two_rank_moe(prefix: str) -> dict:
    """Sub-leg (b): the MoE StreamFormer on {"data": 1, "expert": 2} over
    the first chunk groups of (a)'s recording, which both ranks read."""
    from blendjax_torch.data import StreamDataPipeline
    from blendjax_torch.models import StreamFormer
    from blendjax_torch.parallel import create_mesh

    mesh = create_mesh({"data": 1, "expert": 2}, devices="cuda")
    model = StreamFormer(**MOE_FORMER, attn_backend="flash",
                         image_shape=SHAPE).init_params(0)
    pipe = StreamDataPipeline.from_recording(
        prefix, batch_size=BATCH, emit_packed=True, chunk=CHUNK, mesh=mesh)
    return _split_run("moe", model, mesh,
                      _first(pipe, TWO_RANK["moe_groups"]))


def two_rank_echo(rank: int) -> dict:
    """Sub-leg (c): the flagship model's echo on {"data": 2}: each rank's
    synthetic scenario producer feeds its rows, the ring is sharded over
    the two ranks, the default paired augmentation applies to each rank's
    rows alone. Returns the accounting, the slots' stamps, the rows each
    apply ran on and, for ``checked_draws`` draws after the run, whether
    this rank's rows equal its rows of the one-card draw of the same
    counter (the whole draw gathered and augmented, then cut)."""
    import numpy as np
    import torch

    import blendjax_torch.data.echo as echo_mod
    from blendjax_torch.data import EchoingPipeline, StreamDataPipeline
    from blendjax_torch.data.ring import ring_gather
    from blendjax_torch.fleet import synthetic_fleet
    from blendjax_torch.models import CubeRegressor
    from blendjax_torch.ops.augment import fold_seed
    from blendjax_torch.parallel import create_mesh
    from blendjax_torch.parallel.collectives import (
        collective_counts,
        reset_collective_counts,
        staged_counts,
        tally_diff,
    )
    from blendjax_torch.parallel.sharding import local_rows
    from blendjax_torch.scenario import (
        ScenarioAccounting,
        ScenarioService,
        ScenarioSpace,
    )
    from blendjax_torch.train import MeshTrainDriver

    cfg = SCENARIO
    mesh = create_mesh({"data": 2}, devices="cuda")
    led = ScenarioAccounting()
    echo_mod.scenario_accounting = led
    space = ScenarioSpace.parse(cfg["spec"])
    svc = ScenarioService(space)
    drv = MeshTrainDriver.build(CubeRegressor(), mesh, rng=0, inflight=2,
                                sync_every=4)
    kept = _tap_losses(drv)
    applied = []
    reset_collective_counts()
    before = collective_counts()
    t0 = time.perf_counter()
    with synthetic_fleet(1, shape=cfg["shape"], batch=cfg["batch"],
                         rate=cfg["rate"], scenario=True, seed=rank,
                         bind_grace_s=0.5) as launcher:
        svc.attach(0, launcher.addresses["CTRL"][0])
        if not svc.wait_acked(timeout=15):
            fail(f"two-rank echo leg, rank {rank}: the producer never "
                 "acknowledged the scenario space")
        pipe = StreamDataPipeline(launcher.addresses["DATA"],
                                  batch_size=TWO_RANK["echo_batch"],
                                  mesh=mesh, timeoutms=30_000)
        echo = EchoingPipeline(pipe, capacity=TWO_RANK["echo_capacity"],
                               max_echo_factor=TWO_RANK["echo_factor"],
                               points_key="xy", mesh=mesh, rng=5)
        res = echo.reservoir
        aug = res.augment
        inner = aug._apply

        def spy(gens, batch, rows=None):
            applied.append(int(batch["image"].shape[0]))
            return inner(gens, batch, rows)

        aug._apply = spy
        with echo:
            for batch in echo:
                drv.submit(batch)
                if echo.steps >= TWO_RANK["echo_steps"]:
                    break
        drv.finish()
        run_applied = list(applied)  # the run's applies, not the check's
        # the rows of a few draws against the one-card draw of the counter
        equal = []
        rng = np.random.default_rng(100)  # the same draws on both ranks
        for i in range(TWO_RANK["checked_draws"]):
            idx = rng.integers(0, res.size, TWO_RANK["echo_batch"])
            counter = 10_000 + i
            got = res._draw_body(res._buffers, idx, counter)
            whole = aug(fold_seed(res._seed, counter), ring_gather(
                res._buffers, idx, sharding=res.sharding,
                capacity=res.capacity))
            equal.append(all(torch.equal(got[k], local_rows(whole[k],
                                                             res.sharding))
                             for k in ("image", "xy")))
    torch.cuda.synchronize()
    return {"steps": echo.steps, "fresh": echo.fresh, "echoed": echo.echoed,
            "inserted": echo.inserted, "totals": led.totals(),
            "slots": list(echo._slot_scen), "applied": run_applied,
            "equal": equal, "losses_finite": bool(np.isfinite(
                _update_losses(kept)).all()),
            "tally": tally_diff(collective_counts(), before),
            "staged": staged_counts(), "wall_s": time.perf_counter() - t0,
            "row_local": aug.row_local}


def two_rank_permute(rank: int) -> dict:
    """Sub-leg (d): one ``ring_permute`` of a CUDA tensor over the two
    ranks and its backward. gloo refuses the point-to-point pair on CUDA
    tensors, so both run on a host copy (two stages); the forward must
    bring the other rank's tensor and the backward send each gradient
    back to its sender."""
    import torch

    from blendjax_torch.parallel import create_mesh
    from blendjax_torch.parallel.collectives import (
        reset_collective_counts,
        ring_permute,
        staged_counts,
    )

    mesh = create_mesh({"data": 2}, devices="cuda")
    reset_collective_counts()
    x = (torch.arange(4, dtype=torch.float32, device="cuda")
         + 10 * rank).requires_grad_()
    y = ring_permute(x, mesh, "data")
    (y * (rank + 1)).sum().backward()
    other = 1 - rank
    return {"forward": torch.equal(y.detach().cpu(),
                                   torch.arange(4.0) + 10 * other),
            "backward": torch.equal(x.grad.cpu(),
                                    torch.full((4,), float(other + 1))),
            "on_card": y.is_cuda and x.grad.is_cuda,
            "staged": staged_counts()}


def two_rank_child(rank: int, wdir: str) -> None:
    """One rank of the two-rank leg: the gloo group of both ranks on the
    card (``init_group(backend="gloo")``) and sub-legs (a)-(d);
    its results pickled to ``wdir``. A failure writes its traceback there
    and exits non-zero."""
    import pickle
    import traceback

    import torch
    import torch.distributed as dist

    from blendjax_torch.parallel.mesh import init_group

    out: dict = {}
    try:
        torch.cuda.set_device(0)
        init_group("cuda", store_dir=wdir, backend="gloo", rank=rank,
                   world_size=2)
        prefix = os.path.join(wdir, "tp-rec")
        for name, fn in (("tp", lambda: two_rank_tp(rank, wdir, prefix)),
                         ("moe", lambda: two_rank_moe(prefix)),
                         ("echo", lambda: two_rank_echo(rank)),
                         ("permute", lambda: two_rank_permute(rank))):
            out[name] = fn()
            dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        out["error"] = traceback.format_exc()
    with open(os.path.join(wdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    sys.exit(1 if "error" in out else 0)


def two_rank_alone() -> None:
    """``python3 chip_smoke.py --two-rank-phase``: the build, the two-rank
    leg and phase 5k's two-rank sub-leg alone (a quick proof of the split
    and of the datagen examples on a mesh of two ranks, on the card)."""
    import torch

    from blendjax_torch.kernels.build import build

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    card = f"{torch.cuda.get_device_name(0)}, power limit " \
        f"{smi.split(',')[-1].strip()}"
    t0 = time.perf_counter()
    build()
    log(f"build in {time.perf_counter() - t0:.2f} s")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        two_rank_phase(tmp, card)
        log(f"two-rank leg in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        mesh_examples_leg(tmp, card)
        log(f"phase 5k's two-rank sub-leg (the datagen examples) in "
            f"{time.perf_counter() - t0:.1f} s")


def one_rank_losses(cfg: dict, prefix: str, groups: int) -> list:
    """A one-rank run of the recording's first ``groups`` chunk groups on
    this card: ``make_fused_tile_step`` eager, from the same seed."""
    import torch

    from blendjax_torch.data import StreamDataPipeline
    from blendjax_torch.models import StreamFormer
    from blendjax_torch.train import (
        TrainDriver,
        make_fused_tile_step,
        make_train_state,
    )

    state = make_train_state(StreamFormer(**cfg, attn_backend="flash",
                                          image_shape=SHAPE).init_params(0))
    drv = TrainDriver(make_fused_tile_step(former_loss), state, inflight=2,
                      sync_every=4)
    kept = _tap_losses(drv)
    pipe = StreamDataPipeline.from_recording(prefix, batch_size=BATCH,
                                             emit_packed=True, chunk=CHUNK)
    for batch in _first(pipe, groups):
        drv.submit(batch)
    drv.finish()
    torch.cuda.synchronize()
    return _update_losses(kept)


def _loss_gap(got: list, want: list) -> float:
    if len(got) != len(want) or not want:
        return math.inf
    return max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(got, want))


#: sub-leg (e)'s runs: (leg, model, mesh axes, recorded groups); each runs
#: eagerly and captured (``{leg}_aot``)
UNIT_SPLITS = (
    ("tp", FORMER, {"data": 1, "tp": 1}, TWO_RANK["groups"]),
    ("fsdp", FORMER, {"data": 1, "fsdp": 1}, TWO_RANK["groups"]),
    ("moe", MOE_FORMER, {"data": 1, "expert": 1}, TWO_RANK["moe_groups"]),
)


def nccl_unit_split(tmp: str, prefix: str) -> dict:
    """Sub-leg (e), in this process after the ranks: an NCCL group of
    world size 1 on the card, (a)'s StreamFormer on ``{"data": 1, "tp":
    1}`` and on ``{"data": 1, "fsdp": 1}`` and (b)'s MoE StreamFormer on
    ``{"data": 1, "expert": 1}`` over the same recorded groups (read
    before each run): the split at one rank, each of its collectives an
    NCCL call over one rank, each run eagerly and with ``aot=True`` (one
    CUDA graph per plan signature, the split step whole inside it), cuDNN
    deterministic so that the two are bit-equal. Returns each run's :func:`_split_run` (``{leg}`` and
    ``{leg}_aot``) and the group's backend."""
    import torch
    import torch.distributed as dist

    from blendjax_torch.data import StreamDataPipeline
    from blendjax_torch.models import StreamFormer
    from blendjax_torch.parallel import create_mesh
    from blendjax_torch.parallel.mesh import init_group

    init_group("cuda", store_dir=tempfile.mkdtemp(dir=tmp))
    torch.backends.cudnn.deterministic = True
    try:
        out = {"backend": str(dist.get_backend())}
        for leg, cfg, axes, groups in UNIT_SPLITS:
            for aot in (False, True):
                mesh = create_mesh(axes, devices="cuda")
                model = StreamFormer(**cfg, attn_backend="flash",
                                     image_shape=SHAPE).init_params(0)
                pipe = StreamDataPipeline.from_recording(
                    prefix, batch_size=BATCH, emit_packed=True, chunk=CHUNK,
                    mesh=mesh)
                # read ahead: the ms per update are the step's, not the
                # recording's read
                out[leg + ("_aot" if aot else "")] = _split_run(
                    leg, model, mesh, list(_first(pipe, groups)), aot=aot)
    finally:
        torch.backends.cudnn.deterministic = False
        dist.destroy_process_group()
    return out


def unit_capture_gates(unit: dict, refs: dict, card: str) -> None:
    """Sub-leg (e)'s captured runs against their eager runs: one graph
    replay per step call and no eager call, the losses bit-equal, the
    launches of K1 and K4a-c and the collectives by kind and axis equal,
    an all-gather inside the fsdp graph, the donation audit 1.0 on both;
    the fsdp run's losses within ``TWO_RANK["loss_rel"]`` of the one-rank
    run's. Logs each layout's ms per update, eager and captured, the
    graphs' pool bytes and the resident state bytes beside the data
    layout's."""
    kernels = ("decode_spatial", "flash_attention_fwd",
               "flash_attention_bwd_dkv", "flash_attention_bwd_dq")
    gap = _loss_gap(unit["fsdp"]["losses"], refs["tp"])
    if not math.isfinite(gap) or gap > TWO_RANK["loss_rel"]:
        fail(f"sub-leg (e) fsdp: losses {unit['fsdp']['losses']} against "
             f"the one-rank run's {refs['tp']} (largest rel gap {gap:.3e}, "
             f"bar {TWO_RANK['loss_rel']})")
    for leg, _cfg, axes, _groups in UNIT_SPLITS:
        eager, graph = unit[leg], unit[leg + "_aot"]
        problems = []
        if graph["replays"] != graph["groups"] or graph["eager_calls"]:
            problems.append(f"{graph['replays']} replays and "
                            f"{graph['eager_calls']} eager calls for "
                            f"{graph['groups']} step calls")
        if graph["losses"] != eager["losses"] or not graph["losses"]:
            problems.append(f"losses {graph['losses']} against eager "
                            f"{eager['losses']}")
        counts = {k: (graph["launches"][k], eager["launches"][k])
                  for k in kernels}
        if any(g != e or g <= 0 for g, e in counts.values()):
            problems.append(f"launches (graph, eager) {counts}")
        if (graph["tally"]["per_kind"] != eager["tally"]["per_kind"]
                or graph["tally"]["per_axis"] != eager["tally"]["per_axis"]):
            problems.append(f"collectives {graph['tally']} against eager "
                            f"{eager['tally']}")
        if leg == "fsdp" and not any(
                (c or {}).get("per_kind", {}).get("all-gather", 0) > 0
                for c in graph["graph_collectives"]):
            problems.append("no all-gather inside the fsdp graph: "
                            f"{graph['graph_collectives']}")
        if graph["donation_reuse"] != 1.0 or eager["donation_reuse"] != 1.0:
            problems.append(f"donation audit {graph['audit']} / eager "
                            f"{eager['audit']}")
        if problems:
            fail(f"sub-leg (e) {leg} on {axes}, captured: "
                 + "; ".join(problems))
        log(f"sub-leg (e) {leg} on {axes} on {card}, NCCL at one rank: "
            f"{graph['groups']} step calls, {len(graph['losses'])} updates; "
            f"ms per update eager {eager['ms_per_update']:.3f}, captured "
            f"{graph['ms_per_update']:.3f} (after the first call; "
            f"{graph['graphs']} plan signatures captured before the run in "
            f"{graph['capture_ms']:.0f} ms); one replay per step call, "
            f"losses bit-equal, launches equal "
            f"{ {k: g for k, (g, _e) in counts.items()} }, collectives "
            f"equal {graph['tally']['per_kind']} by axis "
            f"{graph['tally']['per_axis']}; graph pool {graph['pool_bytes']} "
            f"bytes; resident {graph['resident']} bytes against the data "
            f"layout's {graph['replicated']}; train.donation_reuse 1.0 "
            "(both runs)")


def two_rank_phase(tmp: str, card: str) -> dict:
    """Phase 5g's two-rank leg: two processes on the one card (each its
    own rank, ``torch.cuda.set_device(0)``), a gloo group over the card's
    tensors, with the gloo probe beside them. Each rank runs sub-legs (a)
    tp, (b) expert, (c) echo (:data:`TWO_RANK`) and (d) one permute; this
    process then runs the one-rank references of (a) and (b) on the
    recording and (e) :func:`nccl_unit_split`, and fails unless every
    sub-leg holds its bar: losses within ``loss_rel``, K1 and each of K4a-c
    launched on each rank (K4a-c depth x updates times), no split kernel
    gathered (each rank's state below a replicated rank's), gloo refusing
    of the port's kinds only the permute on CUDA tensors, which (d) alone
    stages, forward and backward right; in (c) exact per-scenario
    accounting on both ranks, the same slot stamps, the apply on each
    rank's rows alone and the checked draws' rows equal to the one-card
    draw's; in (e) the sums over the axis of one rank in the tally."""
    import pickle

    t0 = time.perf_counter()
    probing = start_gloo_probe(tmp)  # beside the ranks
    wdir = tempfile.mkdtemp(dir=tmp)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    logs = [open(os.path.join(wdir, f"rank{r}.log"), "w") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--two-rank",
         str(r), wdir], cwd=ROOT, env=env, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(2)]
    deadline = time.monotonic() + TWO_RANK["deadline_s"]
    for p in procs:
        try:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
    alive = [p for p in procs if p.poll() is None]
    for p in alive:
        p.kill()
        p.wait()
    for f in logs:
        f.close()
    results = []
    for r in range(2):
        path = os.path.join(wdir, f"rank{r}.pkl")
        res = None
        if os.path.exists(path):
            with open(path, "rb") as f:
                res = pickle.load(f)
        results.append(res)
    bad = [r for r, res in enumerate(results)
           if alive or res is None or "error" in res]
    if bad:
        for _wdir, pair in probing.values():
            for p in pair:
                p.kill()
                p.wait()
        for r in range(2):
            with open(os.path.join(wdir, f"rank{r}.log")) as f:
                print(f"-- rank {r} (exit {procs[r].returncode}):\n"
                      + f.read()[-6000:], file=sys.stderr)
        res = results[bad[0]]
        fail(f"two-rank leg: rank {bad[0]} "
             + ("did not finish in time" if alive else "failed")
             + (f": {res['error']}" if res and "error" in res else ""))
    ranks_s = time.perf_counter() - t0
    probe = gloo_probe_verdicts(probing)
    refused = {k for k, v in probe.items() if v != "accepted"}
    # the port stages the permute alone: gloo must take its other kinds
    # on CUDA tensors, and only (d)'s permute, forward and backward, ran
    # on a host copy
    if refused & set(PORT_KINDS) != {"collective-permute"}:
        fail(f"two-rank leg: the port stages only collective-permute on a "
             f"gloo group, but the probe reads {probe}")
    for r, res in enumerate(results):
        perm = res["permute"]
        staged = {leg: res[leg]["staged"] for leg in ("tp", "moe", "echo")
                  if res[leg]["staged"]}
        if (staged or perm["staged"] != {"collective-permute": 2}
                or not (perm["forward"] and perm["backward"]
                        and perm["on_card"])):
            fail(f"two-rank permute, rank {r}: {perm}; stages in the other "
                 f"sub-legs {staged}")
    t1 = time.perf_counter()
    prefix = os.path.join(wdir, "tp-rec")
    refs = {"tp": one_rank_losses(FORMER, prefix, TWO_RANK["groups"]),
            "moe": one_rank_losses(MOE_FORMER, prefix, TWO_RANK["moe_groups"])}
    refs_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    unit = nccl_unit_split(tmp, prefix)
    unit_s = time.perf_counter() - t1
    unit_capture_gates(unit, refs, card)
    out = {"probe": probe, "ranks": results, "wall_s": ranks_s,
           "refs_s": refs_s, "unit": unit, "unit_s": unit_s, "launches": {}}
    runs = list(enumerate(results)) + [("nccl", unit)]
    for leg, cfg in (("tp", FORMER), ("moe", MOE_FORMER)):
        for r, res in runs:
            got = res[leg]
            gap = _loss_gap(got["losses"], refs[leg])
            updates = len(got["losses"])
            counts = got["launches"]
            if not math.isfinite(gap) or gap > TWO_RANK["loss_rel"]:
                fail(f"two-rank {leg} leg, rank {r}: losses {got['losses']} "
                     f"against the one-rank run's {refs[leg]} (largest rel "
                     f"gap {gap:.3e}, bar {TWO_RANK['loss_rel']})")
            if counts["decode_spatial"] <= 0:
                fail(f"two-rank {leg} leg, rank {r}: K1 never launched")
            for name in ("flash_attention_fwd", "flash_attention_bwd_dkv",
                         "flash_attention_bwd_dq"):
                if counts[name] != cfg["depth"] * updates:
                    fail(f"two-rank {leg} leg, rank {r}: {name} launched "
                         f"{counts[name]} times, not depth x updates = "
                         f"{cfg['depth'] * updates}")
            axis = "tp" if leg == "tp" else "expert"
            if r == "nccl":
                if (unit["backend"] != "nccl" or got["staged"]
                        or not got["tally"]["per_axis"].get(axis)):
                    fail(f"two-rank {leg} leg at one rank: backend "
                         f"{unit['backend']}, stages {got['staged']}, "
                         f"collectives by axis {got['tally']['per_axis']} "
                         f"(none over {axis})")
            elif got["resident"] >= got["replicated"]:
                fail(f"two-rank {leg} leg, rank {r}: {got['resident']} "
                     f"resident bytes, not below a replicated rank's "
                     f"{got['replicated']}")
            for name, n in counts.items():
                out["launches"][name] = out["launches"].get(name, 0) + n
            where = ("one rank, NCCL" if r == "nccl" else f"rank {r}")
            log(f"two-rank {leg} leg on {card}, {where}: {got['groups']} "
                f"chunk groups, {updates} updates in {got['wall_s']:.2f} s; "
                f"losses against the one-rank run's: largest rel gap "
                f"{gap:.3e} (bar {TWO_RANK['loss_rel']}); launches "
                f"{ {k: v for k, v in counts.items() if v} }; collectives "
                f"{got['tally']['per_kind']} by axis "
                f"{got['tally']['per_axis']}; gloo host stages "
                f"{got['staged']}; resident {got['resident']} bytes against "
                f"{got['replicated']} replicated")
    echoes = [r["echo"] for r in results]
    batch = TWO_RANK["echo_batch"]
    for r, e in enumerate(echoes):
        drawn = sum(f + x for f, x in e["totals"].values())
        problems = []
        if drawn != e["steps"] * batch or e["fresh"] + e["echoed"] != drawn:
            problems.append(f"accounting {e['totals']} for {e['steps']} "
                            f"steps of {batch}")
        if sum(f for f, _ in e["totals"].values()) != e["fresh"]:
            problems.append("per-scenario fresh != fresh")
        if e["totals"] != echoes[0]["totals"] or e["slots"] != echoes[0]["slots"]:
            problems.append("totals or slot stamps differ between the ranks")
        if not all(n == batch // 2 for n in e["applied"]) or not e["applied"]:
            problems.append(f"applied to rows {sorted(set(e['applied']))}")
        if not (e["equal"] and all(e["equal"])):
            problems.append(f"rows against the one-card draw {e['equal']}")
        if not e["losses_finite"] or not e["row_local"]:
            problems.append("losses not finite or augmentation not row-local")
        if len(e["totals"]) < 2:
            problems.append(f"scenarios seen {sorted(e['totals'])}")
        if problems:
            fail(f"two-rank echo leg, rank {r}: " + "; ".join(problems))
        log(f"two-rank echo leg on {card}, rank {r}: {e['steps']} draws of "
            f"{batch} rows in {e['wall_s']:.2f} s, fresh {e['fresh']} + "
            f"echoed {e['echoed']}, per scenario {e['totals']} (both ranks "
            f"alike, slot stamps alike); the apply ran on "
            f"{sorted(set(e['applied']))} rows per draw; "
            f"{len(e['equal'])} checked draws bit-equal to the one-card "
            f"draw's rows; collectives {e['tally']['per_kind']}; gloo host "
            f"stages {e['staged']}")
    log(f"two-rank leg on {card}: gloo probe on CUDA tensors {probe}; "
        f"the port stages collective-permute alone through the host: "
        f"(d)'s permute on each rank, forward and backward, right; ranks "
        f"{ranks_s:.1f} s, one-rank references {refs_s:.1f} s, the split at "
        f"one rank over NCCL {unit_s:.1f} s; two ranks "
        "share one card and gloo crosses the host, so no figure here is a "
        "scaling figure")
    return out


# -- phase 5h: mixture of experts, remat and the pipeline ----------------------


def moe_values(model) -> list:
    """Each MoE block's load-balancing loss from its last forward (the
    ``aux_loss`` buffers the captured graph writes in place): one
    device-to-host read."""
    import torch

    from blendjax_torch.models import MoEMLP

    mods = [m for m in model.modules() if isinstance(m, MoEMLP)]
    return torch.stack([m.aux_loss for m in mods]).tolist()


def moe_leg(tmp: str, dense: dict, card: str) -> dict:
    """The MoE StreamFormer (``MOE_FORMER``) live on the flagship stream
    through ``CapturedStep(make_fused_tile_step)``, the streamformer leg's
    2 + 16 step calls: one replay per step call, K1 and each of K4a-c
    launched (K4a-c depth x updates times), finite losses; the aux losses
    read once after the window; then the graph against the eager step on
    the leg's recorded groups from one state, bit for bit."""
    import torch

    from blendjax_torch.models import StreamFormer
    from blendjax_torch.train import make_fused_tile_step, make_train_state

    model = StreamFormer(**MOE_FORMER, attn_backend="flash",
                         image_shape=SHAPE).init_params(0)
    state = make_train_state(model)
    fresh = copy.deepcopy(state)
    leg = run_leg("moe streamformer leg", STREAMFORMER, state, tmp,
                  former_loss, alone=False)
    counts, want = leg["launches"], MOE_FORMER["depth"] * leg["updates"]
    if counts["decode_spatial"] <= 0:
        fail("moe streamformer leg never launched decode_spatial (K1)")
    for name in ("flash_attention_fwd", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq"):
        if counts[name] != want:
            fail(f"moe streamformer leg: {name} launched {counts[name]} "
                 f"times, not depth x updates = {want}")
    aux = moe_values(state.model)
    if not all(math.isfinite(a) for a in aux):
        fail(f"moe streamformer leg: aux losses {aux}")
    torch.backends.cudnn.deterministic = True
    try:
        parity = eager_against_graph(
            "moe streamformer K1 + K4a-c", lambda: make_fused_tile_step(
                former_loss), lambda: copy.deepcopy(fresh), leg["recorded"])
    finally:
        torch.backends.cudnn.deterministic = False
    log(f"phase 5h moe leg on {card}: {leg['img_s']:.1f} img/s live beside "
        f"the dense streamformer leg's {dense['img_s']:.1f} (same run, "
        f"{leg['images']} images, {leg['wall_s']:.2f} s); graph step alone "
        f"{leg['graph_alone_ms']:.2f} ms per chunk group "
        f"({leg['graph_alone_img_s']:.1f} img/s) beside the dense "
        f"{dense['graph_alone_ms']:.2f} ms; one graph replay for each of "
        f"{leg['steps']} step calls; launches {dict((k, v) for k, v in counts.items() if v)};"
        f" aux loss per MoE block after the window {[round(a, 4) for a in aux]}"
        f" (1.0 when balanced); {parity['steps']} recorded groups bit-equal "
        f"eager against captured; final loss {leg['losses'][-1]:.5f}")
    leg["aux"] = aux
    return leg


def remat_leg(sf: dict, card: str) -> dict:
    """The dense streamformer model with ``remat=True`` against
    ``remat=False``, both through ``CapturedStep(make_fused_tile_step)``
    from the leg's initial state on its recorded groups (cuDNN
    deterministic): losses and parameters bit-equal, K4a launched twice
    as often under remat (its forward runs again in the backward), K4b/K4c
    as often; the peak ``max_memory_allocated`` of one eager step call of
    each and each graph's step alone."""
    import torch

    from blendjax_torch.kernels import launch_counts, reset_launch_counts
    from blendjax_torch.train import CapturedStep, make_fused_tile_step

    groups = sf["recorded"]
    out = {}
    torch.backends.cudnn.deterministic = True
    try:
        for remat in (False, True):
            st = copy.deepcopy(sf["fresh"])
            st.model.remat = remat
            eager = copy.deepcopy(st)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            make_fused_tile_step(former_loss)(eager, dict(groups[-1]))
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            del eager
            graph = CapturedStep(make_fused_tile_step(former_loss))
            for g in groups:
                graph.prepare(st, g)
            reset_launch_counts()
            losses = [graph(st, dict(g))[1]["loss"] for g in groups]
            torch.cuda.synchronize()
            out[remat] = {"losses": losses, "state": st,
                          "counts": launch_counts(), "peak": peak,
                          "graph": graph, "replays": graph.graph_replays}
    finally:
        torch.backends.cudnn.deterministic = False
    a, b = out[False], out[True]
    for i, (x, y) in enumerate(zip(a["losses"], b["losses"])):
        if not torch.equal(x, y):
            fail(f"remat leg: group {i} loss {y.tolist()} != remat=False "
                 f"{x.tolist()}")
    for (name, p), q in zip(a["state"].model.named_parameters(),
                            b["state"].model.parameters()):
        if not torch.equal(p, q):
            fail(f"remat leg: parameter {name} differs from remat=False")
    fwd = "flash_attention_fwd"
    if b["counts"][fwd] != 2 * a["counts"][fwd] or a["counts"][fwd] <= 0:
        fail(f"remat leg: K4a launched {b['counts'][fwd]} times under remat, "
             f"not twice the {a['counts'][fwd]} without")
    for name in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
        if b["counts"][name] != a["counts"][name]:
            fail(f"remat leg: {name} {b['counts'][name]} under remat, "
                 f"{a['counts'][name]} without")
    if b["replays"] != len(groups):
        fail(f"remat leg: {b['replays']} replays for {len(groups)} groups")
    for leg in (a, b):  # the step alone, after the comparisons
        leg["ms"] = alone_ms(lambda: leg["graph"](leg["state"],
                                                  dict(groups[-1])), 5)
    log(f"phase 5h remat leg on {card}: {len(groups)} recorded groups "
        f"through the captured step with remat=True bit-equal to "
        f"remat=False (losses and all parameters); K4a launches "
        f"{b['counts'][fwd]} against {a['counts'][fwd]} (x2), K4b/K4c "
        f"{b['counts']['flash_attention_bwd_dkv']}/"
        f"{b['counts']['flash_attention_bwd_dq']}; peak max_memory_allocated "
        f"of one eager step call {b['peak'] / 2**20:.1f} MiB against "
        f"{a['peak'] / 2**20:.1f} MiB; graph step alone {b['ms']:.2f} ms "
        f"against {a['ms']:.2f} ms per chunk group")
    return {"launches": b["counts"], "dense_launches": a["counts"],
            "peak_bytes": b["peak"], "dense_peak_bytes": a["peak"],
            "ms": b["ms"], "dense_ms": a["ms"]}


def pipeline_leg(card: str) -> dict:
    """``pipeline_apply`` over ``create_mesh({"pipe": 1})`` (the mesh
    phase's NCCL group): one full-width StreamFormer ``Block`` (flash) as
    the stage through ``torch.func.functional_call`` over the stacked
    block parameters, ``PIPE["microbatches"]`` microbatches of
    (``PIPE["rows"]``, tokens, dim) bf16. The output and the input
    gradient must be bit-equal to the block called on each microbatch,
    and each of K4a-c launched once per microbatch inside the pipeline."""
    import torch

    from blendjax_torch.kernels import launch_counts, reset_launch_counts
    from blendjax_torch.models import StreamFormer
    from blendjax_torch.parallel import (
        create_mesh,
        pipeline_apply,
        stack_stage_params,
    )

    former = StreamFormer(**FORMER, attn_backend="flash",
                          image_shape=SHAPE).init_params(0)
    block = former.blocks[0].cuda()
    m, rows = PIPE["microbatches"], PIPE["rows"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((m, rows, former.tokens, FORMER["dim"]), generator=gen,
                    device="cuda").to(torch.bfloat16)
    g = torch.randn(x.shape, generator=gen, device="cuda").to(torch.bfloat16)
    mesh = create_mesh({"pipe": 1})

    def stage_fn(params, v):
        return torch.func.functional_call(block, params, (v,))

    torch.backends.cudnn.deterministic = True
    try:
        xa = x.clone().requires_grad_()
        stacked = stack_stage_params([dict(block.named_parameters())])
        reset_launch_counts()
        y = pipeline_apply(stage_fn, stacked, xa, mesh, axis="pipe")
        y.backward(g)
        torch.cuda.synchronize()
        counts = launch_counts()
        block.zero_grad()
        xb = x.clone().requires_grad_()
        ref = torch.stack([block(xb[i]) for i in range(m)])
        ref.backward(g)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = False
    if not torch.equal(y, ref):
        fail(f"pipeline leg: output differs from the block, max |diff| "
             f"{(y.float() - ref.float()).abs().max().item()}")
    if not torch.equal(xa.grad, xb.grad):
        fail("pipeline leg: input gradient differs from the block's, max "
             f"|diff| {(xa.grad.float() - xb.grad.float()).abs().max().item()}")
    for name in ("flash_attention_fwd", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq"):
        if counts[name] != m:
            fail(f"pipeline leg: {name} launched {counts[name]} times inside "
                 f"the pipeline, not once per microbatch ({m})")
    xt = x.clone().requires_grad_()
    ms = alone_ms(lambda: pipeline_apply(stage_fn, stacked, xt, mesh,
                                         axis="pipe").backward(g), 3)
    log(f"phase 5h pipeline leg on {card}: pipeline_apply over pipe=1 (NCCL)"
        f", {m} microbatches of {tuple(x.shape[1:])} bf16 through one "
        f"full-width Block: output and input gradient bit-equal to the block "
        f"per microbatch; K4a-c launches inside {counts['flash_attention_fwd']}"
        f"/{counts['flash_attention_bwd_dkv']}/{counts['flash_attention_bwd_dq']}"
        f"; forward and backward {ms:.2f} ms (information)")
    return {"launches": counts, "ms": ms}


# -- phase 5i: the RL actor-learner stack --------------------------------------


def rl_stack(venv, prioritized: bool, checkpoint=None, every: int = 0):
    """Reservoir, captured DQN step, actor pool and learner driver of the
    reference's live RL leg (``RL``)."""
    import numpy as np

    from blendjax_torch.models import QNetwork
    from blendjax_torch.rl import (
        ActorPool,
        HostQPolicy,
        RLTrainDriver,
        TrajectoryReservoir,
        make_dqn_step,
        make_rl_train_state,
    )
    from blendjax_torch.train import CapturedStep

    res = TrajectoryReservoir(RL["capacity"], rng=0, prioritized=prioritized)
    state = make_rl_train_state(
        QNetwork(hidden=RL["hidden"], n_actions=3).init_params(0),
        learning_rate=RL["lr"])
    step = CapturedStep(make_dqn_step(res, gamma=RL["gamma"]))
    pool = ActorPool(venv, res, HostQPolicy(3, eps_steps=RL["eps_steps"],
                                            seed=0),
                     action_map=np.array(RL_ACTIONS, np.float32))
    drv = RLTrainDriver(step, state, res, actors=pool, batch_size=RL["batch"],
                        min_fill=RL["min_fill"], sync_every=RL["sync_every"],
                        inflight=RL["inflight"], checkpoint=checkpoint,
                        checkpoint_every=every)
    return res, step, pool, drv


def rl_leg(venv, prioritized: bool, card: str, census: bool = False) -> dict:
    """One learner leg: warm-up steps (the capture), then the window to
    ``RL["steps"]``: one graph replay per learner step, no buffer moved,
    ``fresh + replayed == draws x batch``, the actors' env steps equal to
    the transitions inserted (read after they stop). The actors then run
    on to ``RL_EPISODES`` ended episodes (at most ``RL_EPISODE_WAIT_S``)
    for the mean return of the later half of the leg's episodes.
    ``census`` runs the window under :class:`SyncCensus`."""
    import numpy as np

    from blendjax_torch.rl import diagnose_rl
    from blendjax_torch.testing.donation import DonationAudit, state_tree
    from blendjax_torch.utils.metrics import metrics

    label = f"rl {'prioritized' if prioritized else 'uniform'} leg"
    res, step, pool, drv = rl_stack(venv, prioritized)
    audit = DonationAudit()
    with pool:
        for _ in range(RL["warmup"]):
            drv.train_step()
        drv.drain()
        # after the warm-up: the AdamW moments exist from the first step
        audit.snapshot("rl.ring", res.device_buffers())
        audit.snapshot("rl.state", state_tree(drv.state))
        metrics.reset()
        replays0, steps0 = step.graph_replays, drv.steps
        fresh0, replayed0, draws0 = res.fresh, res.replayed, res.stats["draws"]
        t0 = time.perf_counter()
        syncs = SyncCensus(label) if census else None
        if syncs is not None:
            with syncs:
                while drv.steps < RL["steps"]:
                    drv.train_step()
        while drv.steps < RL["steps"]:
            drv.train_step()
        final = drv.drain()
        dt = time.perf_counter() - t0
        audit.snapshot("rl.ring", res.device_buffers())
        audit.snapshot("rl.state", state_tree(drv.state))
        verdict = diagnose_rl(metrics.report())
        window_episodes = pool.episodes
        deadline = time.monotonic() + RL_EPISODE_WAIT_S
        while pool.episodes < RL_EPISODES and time.monotonic() < deadline:
            pool.check()
            time.sleep(0.02)
    window = drv.steps - steps0
    census_rep = (syncs.report(window, drv.host_blocks)
                  if syncs is not None else None)
    drawn = (res.fresh - fresh0) + (res.replayed - replayed0)
    if step.graph_replays - replays0 != window or drv.dispatches != drv.steps:
        fail(f"{label}: {step.graph_replays - replays0} graph replays and "
             f"{drv.dispatches} step calls for {window} / {drv.steps} steps")
    audit_verdict(label, audit)
    if drawn != window * RL["batch"] or res.stats["draws"] - draws0 != window:
        fail(f"{label}: fresh + replayed {drawn} != {window} x {RL['batch']}")
    if pool.env_steps != res.inserts:
        fail(f"{label}: env steps {pool.env_steps} != transitions inserted "
             f"{res.inserts}")
    if not math.isfinite(final):
        fail(f"{label}: final loss {final}")
    returns = [r for _, r in pool.episode_returns]
    half = len(returns) // 2
    recent = returns[half:] if half else returns
    mean_return = float(np.mean(recent)) if recent else 0.0
    out = {"steps_s": window / dt, "seconds": dt, "window": window,
           "mean_return": mean_return, "episodes": pool.episodes,
           "window_episodes": window_episodes,
           "env_steps": pool.env_steps, "sample_waits": drv.sample_waits,
           "replay_ratio": res.stats["replay_ratio"],
           "policy_syncs": pool.policy_version, "final_loss": final,
           "verdict": verdict.render(), "census": census_rep}
    log(f"phase 5i {label} on {card}: {out['steps_s']:.1f} learner steps/s "
        f"({window} steps in {dt:.3f} s, one graph replay each; buffers "
        f"unmoved); fresh + replayed = {drawn} = {window} x {RL['batch']}; "
        f"env steps {pool.env_steps} = transitions inserted {res.inserts}; "
        f"episodes ended {window_episodes} by the window's end, "
        f"{pool.episodes} in all; mean return of the later half "
        f"{mean_return:.2f}; rl.sample_waits {drv.sample_waits}; replay "
        f"ratio {res.stats['replay_ratio']}; policy syncs "
        f"{pool.policy_version}; final loss {final:.5f}; {verdict.render()}")
    return out


def rl_resume_leg(tmp: str, venv, card: str) -> dict:
    """A snapshot every ``RL_RESUME["every"]`` learner steps, stopped after
    the first committed snapshot; a fresh stack restores it (train state
    in place before its capture, then the session) and continues to
    ``RL_RESUME["budget"]`` steps. It must start where the snapshot ended:
    the snapshot's step count, its reservoir's inserts and its actors' env
    steps."""
    from blendjax_torch.checkpoint import SnapshotManager, committed_steps
    from blendjax_torch.weights import (
        load_train_state_leaves,
        train_state_leaves,
    )

    directory = os.path.join(tmp, "rl-ckpt")
    mgr = SnapshotManager(directory)
    try:
        res, _step, pool, drv = rl_stack(venv, True, checkpoint=mgr,
                                         every=RL_RESUME["every"])
        with pool:
            while not committed_steps(directory):
                if drv.steps >= RL_RESUME["budget"]:
                    fail("rl resume leg: no snapshot committed within the "
                         "budget")
                drv.train_step()
        drv.drain()
        mgr.wait()
        first = committed_steps(directory)[0]
        res2, step2, pool2, drv2 = rl_stack(venv, True)
        r = mgr.restore(train_state_leaves(drv2.state), step=first)
        load_train_state_leaves(drv2.state, r.state)
        names = drv2.restore_session(r.session)
        start = (drv2.steps, res2.inserts, pool2.env_steps)
        saved = r.session["replay"]
        if (sorted(names) != ["actor", "driver", "replay"] or start[0] != first
                or start[1] != int(saved["inserts"])
                or start[2] != int(r.session["actor"]["env_steps"])):
            fail(f"rl resume leg: restored {names} at (steps, inserts, env "
                 f"steps) {start}, the snapshot of step {first} holds "
                 f"{saved['inserts']} inserts")
        with pool2:
            while drv2.steps < RL_RESUME["budget"]:
                drv2.train_step()
        final = drv2.drain()
        if (drv2.steps != RL_RESUME["budget"] or not math.isfinite(final)
                or step2.graph_replays != RL_RESUME["budget"] - first):
            fail(f"rl resume leg: {drv2.steps} steps, {step2.graph_replays} "
                 f"replays after the restore at {first}, final loss {final}")
    finally:
        mgr.close()
    log(f"phase 5i rl resume leg on {card}: first snapshot committed at step "
        f"{first} (killed there, {drv.steps} steps submitted); a fresh stack "
        f"restored it at steps {start[0]}, inserts {start[1]}, env steps "
        f"{start[2]} and continued to {drv2.steps} steps "
        f"({step2.graph_replays} replays); final loss {final:.5f}")
    return {"snapshot_step": first, "final_loss": final}


def pg_leg(card: str) -> dict:
    """``make_pg_step`` on scripted transitions carrying ``ret``:
    ``PG_STEPS`` eager steps and as many graph replays from twin
    reservoirs and states, losses, parameters and priorities bit-equal."""
    import numpy as np
    import torch

    from blendjax_torch.models import QNetwork
    from blendjax_torch.rl import (
        TrajectoryReservoir,
        make_pg_step,
        make_rl_train_state,
    )
    from blendjax_torch.train import CapturedStep

    rng = np.random.default_rng(0)
    n = RL["capacity"] // 4
    rows = {"obs": rng.normal(size=(n, 4)).astype(np.float32),
            "action": rng.integers(0, 3, n).astype(np.int32),
            "reward": rng.normal(size=n).astype(np.float32),
            "done": rng.random(n) < 0.05,
            "next_obs": rng.normal(size=(n, 4)).astype(np.float32),
            "ret": rng.normal(size=n).astype(np.float32)}
    model = QNetwork(hidden=RL["hidden"]).init_params(1)
    out = []
    for captured in (False, True):
        res = TrajectoryReservoir(RL["capacity"], rng=2, prioritized=True)
        res.insert(rows)
        state = make_rl_train_state(copy.deepcopy(model), target=False)
        step = make_pg_step(res)
        if captured:
            step = CapturedStep(step)
        losses = [step(state, res.draw_token(*res.compose(RL["batch"])))[1]
                  ["loss"] for _ in range(PG_STEPS)]
        torch.cuda.synchronize()
        out.append((losses, state, res, step))
    (la, a, ra, _), (lb, b, rb, graph) = out
    same = (all(torch.equal(x, y) for x, y in zip(la, lb))
            and all(torch.equal(p, q) for p, q in zip(
                a.model.parameters(), b.model.parameters()))
            and torch.equal(ra._priorities, rb._priorities))
    if not same or graph.graph_replays != PG_STEPS:
        fail(f"pg leg: {graph.graph_replays} replays; eager losses "
             f"{[x.item() for x in la]} graph {[y.item() for y in lb]}")
    log(f"phase 5i pg leg on {card}: {PG_STEPS} make_pg_step graph replays "
        f"bit-equal to the eager steps (losses, parameters, priorities); "
        f"losses {[round(x.item(), 6) for x in lb]}")
    return {"losses": [x.item() for x in lb]}


def dqn_mesh_leg(tmp: str, card: str) -> dict:
    """The DQN state split over ``{"data": 1, "fsdp": 1}`` (an NCCL group
    of world size 1: the online and the target network gathered over one
    rank inside the step) on scripted transitions, eager and through
    ``CapturedStep``, beside the replicated state captured, from one model
    and twin reservoirs, ``RL_MESH["steps"]`` steps each: the split
    captured run one replay per step and its losses, priorities and
    shards bit-equal to the split eager run's, its donation audit 1.0,
    and both split runs' losses within ``RL_MESH["loss_rel"]`` of the
    replicated run's. Then the replicated state on ``{"data": 1}`` over a
    reservoir sharded on that mesh (the ring's gather on the card, its
    all-reduce over one rank), eager and through ``CapturedStep(step,
    mesh=mesh)``: the captured run one replay per step and no eager call,
    its losses, parameters, target and priorities bit-equal to the eager
    run's, the collectives by kind and axis equal, the donation audit 1.0
    on both, the losses within ``RL_MESH["loss_rel"]`` of the replicated
    run's. Logs each run's ms per step after the first (the
    capture's)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from blendjax_torch.models import QNetwork
    from blendjax_torch.parallel import create_mesh
    from blendjax_torch.parallel.collectives import (
        collective_counts,
        tally_diff,
    )
    from blendjax_torch.parallel.mesh import init_group
    from blendjax_torch.rl import (
        TrajectoryReservoir,
        make_dqn_step,
        make_rl_train_state,
        mesh_rl_step_kwargs,
    )
    from blendjax_torch.testing.donation import DonationAudit, state_tree
    from blendjax_torch.train import CapturedStep

    rng = np.random.default_rng(0)
    n = RL["capacity"] // 4
    rows = {"obs": rng.normal(size=(n, 4)).astype(np.float32),
            "action": rng.integers(0, 3, n).astype(np.int32),
            "reward": rng.normal(size=n).astype(np.float32),
            "done": rng.random(n) < 0.05,
            "next_obs": rng.normal(size=(n, 4)).astype(np.float32)}
    model = QNetwork(hidden=RL["hidden"], n_actions=3).init_params(1)
    init_group("cuda", store_dir=tempfile.mkdtemp(dir=tmp))
    runs = {}
    try:
        meshes = {"fsdp": create_mesh({"data": 1, "fsdp": 1}, devices="cuda"),
                  "ring": create_mesh({"data": 1}, devices="cuda")}
        for name, layout, captured in (("replicated", None, True),
                                       ("fsdp", "fsdp", False),
                                       ("fsdp_aot", "fsdp", True),
                                       ("ring", "ring", False),
                                       ("ring_aot", "ring", True)):
            mesh = meshes.get(layout)
            res = TrajectoryReservoir(
                RL["capacity"], rng=2, prioritized=True,
                mesh=mesh if layout == "ring" else None)
            res.insert(rows)
            state = make_rl_train_state(copy.deepcopy(model),
                                        learning_rate=RL["lr"], mesh=mesh)
            kw = mesh_rl_step_kwargs(state, mesh) if mesh else {}
            step = make_dqn_step(res, gamma=RL["gamma"], **kw)
            if captured:
                step = CapturedStep(step, mesh=mesh)
            audit = DonationAudit()
            losses = []
            before = collective_counts()
            for i in range(RL_MESH["steps"]):
                token = res.draw_token(*res.compose(RL["batch"]))
                losses.append(step(state, token)[1]["loss"])
                if i == 0:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    audit.snapshot(name, state_tree(state))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / (RL_MESH["steps"] - 1)
            audit.snapshot(name, state_tree(state))
            runs[name] = {"losses": losses, "state": state, "res": res,
                          "step": step, "ms": ms, "audit": audit,
                          "tally": tally_diff(collective_counts(), before)}
    finally:
        dist.destroy_process_group()
    ref, eager, graph = (runs[k] for k in ("replicated", "fsdp", "fsdp_aot"))
    if graph["state"].shards is None or eager["state"].shards is None:
        fail("dqn mesh leg: the fsdp rules did not split the RL state")
    same = (all(torch.equal(x, y) for x, y in zip(eager["losses"],
                                                   graph["losses"]))
            and all(torch.equal(p, q) for p, q in zip(
                eager["state"].shards.shards, graph["state"].shards.shards))
            and all(torch.equal(p, q) for p, q in zip(
                eager["state"].target_shards.shards,
                graph["state"].target_shards.shards))
            and torch.equal(eager["res"]._priorities,
                            graph["res"]._priorities))
    if not same or graph["step"].graph_replays != RL_MESH["steps"] \
            or graph["step"].eager_calls:
        fail(f"dqn mesh leg: {graph['step'].graph_replays} replays, "
             f"{graph['step'].eager_calls} eager calls; eager losses "
             f"{[x.item() for x in eager['losses']]} graph "
             f"{[y.item() for y in graph['losses']]}")
    ring_eager, ring_graph = runs["ring"], runs["ring_aot"]
    ring_same = (
        all(torch.equal(x, y) for x, y in zip(ring_eager["losses"],
                                               ring_graph["losses"]))
        and all(torch.equal(p, q) for p, q in zip(
            ring_eager["state"].model.parameters(),
            ring_graph["state"].model.parameters()))
        and all(torch.equal(p, q) for p, q in zip(
            ring_eager["state"].target.parameters(),
            ring_graph["state"].target.parameters()))
        and torch.equal(ring_eager["res"]._priorities,
                        ring_graph["res"]._priorities))
    kinds = [(r["tally"]["per_kind"], r["tally"]["per_axis"])
             for r in (ring_eager, ring_graph)]
    if (not ring_same or ring_graph["step"].graph_replays != RL_MESH["steps"]
            or ring_graph["step"].eager_calls or kinds[0] != kinds[1]
            or kinds[1][0]["all-reduce"] <= 0
            or ring_eager["res"].ways != 1
            or ring_eager["res"].sharding is None):
        fail(f"dqn mesh leg on a sharded ring: "
             f"{ring_graph['step'].graph_replays} replays, "
             f"{ring_graph['step'].eager_calls} eager calls; collectives "
             f"(eager, graph) {kinds}; eager losses "
             f"{[x.item() for x in ring_eager['losses']]} graph "
             f"{[y.item() for y in ring_graph['losses']]}")
    want = [x.item() for x in ref["losses"]]
    gaps = {k: _loss_gap([x.item() for x in runs[k]["losses"]], want)
            for k in ("fsdp", "fsdp_aot", "ring", "ring_aot")}
    if not all(math.isfinite(g) and g <= RL_MESH["loss_rel"]
               for g in gaps.values()):
        fail(f"dqn mesh leg: split losses against the replicated run's: "
             f"largest rel gaps {gaps} (bar {RL_MESH['loss_rel']})")
    for name in ("fsdp", "fsdp_aot", "ring", "ring_aot"):
        audit_verdict(f"phase 5i dqn mesh leg ({name})", runs[name]["audit"])
    log(f"phase 5i dqn mesh leg on {card}: {RL_MESH['steps']} make_dqn_step "
        f"steps on {{'data': 1, 'fsdp': 1}} (NCCL at one rank), eager and "
        f"one graph replay each, bit-equal (losses, online and target "
        f"shards, priorities); against the replicated captured run's "
        f"losses: largest rel gaps {gaps} (bar {RL_MESH['loss_rel']}); ms "
        f"per step after the first: replicated captured {ref['ms']:.3f}, "
        f"split eager {eager['ms']:.3f}, split captured {graph['ms']:.3f}")
    log(f"phase 5i dqn sharded-ring leg on {card}: {RL_MESH['steps']} "
        f"make_dqn_step steps over a reservoir sharded on {{'data': 1}} "
        f"(NCCL at one rank: the gather's all-reduce on the card), eager and "
        f"one graph replay each, no eager call, bit-equal (losses, "
        f"parameters, target, priorities), collectives equal "
        f"{kinds[1][0]} by axis {kinds[1][1]}; ms per step after the first: "
        f"eager {ring_eager['ms']:.3f}, captured {ring_graph['ms']:.3f}")
    return {k: {"ms": v["ms"], "losses": [x.item() for x in v["losses"]]}
            for k, v in runs.items()}


def rl_phase(tmp: str, card: str) -> dict:
    """Phase 5i: two of the port's cartpole producers under
    ``BatchedRemoteEnv``, a uniform and a prioritized learner leg, the
    resume leg, the policy-gradient leg, then the DQN state split over
    an fsdp axis of one rank, eager and captured. The best leg's mean
    return must reach ``RL_RETURN_FLOOR``."""
    from blendjax_torch.env import BatchedRemoteEnv

    with BatchedRemoteEnv(CARTPOLE_SCRIPT, num_envs=RL["envs"], seed=0,
                          timeoutms=30_000) as venv:
        legs = {"uniform": rl_leg(venv, False, card),
                "prioritized": rl_leg(venv, True, card, census=True)}
        resume = rl_resume_leg(tmp, venv, card)
    best = max(leg["mean_return"] for leg in legs.values())
    if best < RL_RETURN_FLOOR:
        fail(f"rl phase: best mean return {best:.2f} < {RL_RETURN_FLOOR}")
    pg = pg_leg(card)
    split = dqn_mesh_leg(tmp, card)
    return {**legs, "resume": resume, "pg": pg, "split": split,
            "best_return": best}


# -- phase 5j: scoring, the scenario loop and the elastic fleet ------------------


def supershape_frames(thetas, shape=None) -> "np.ndarray":
    """One SupershapeScene frame (RGBA, its default 256x256 unless
    ``shape``) per row of ``thetas`` (m, n1); n2 = n3 = 1, n1 kept >= 0.2
    so every radius is finite."""
    import numpy as np

    from blendjax_torch.producer.sim import SupershapeScene

    shape = tuple(shape or DISC["shape"])
    scene = SupershapeScene(shape=shape, seed=0)
    out = np.empty((len(thetas), *shape, 4), np.uint8)
    for i, (m, n1) in enumerate(thetas):
        scene.set_params([m, max(float(n1), 0.2), 1.0, 1.0], shape_id=i)
        out[i] = scene.render()
    return out


def placed_supershape_batches(frames, label: str) -> dict:
    """The supershape producer's batch (``image``, ``shape_id`` and
    ``frameid``, the last two both (B,) int64) placed ``placements`` times
    by the port's ``DeviceFeeder``, each placement's copies queued behind
    a sleep on its side stream; every field must arrive with its own
    values (``shape_id`` is how densityopt matches frames to draws).
    Returns the last placement."""
    import numpy as np
    import torch

    from blendjax_torch.data.pipeline import DeviceFeeder

    n = len(frames)
    feeder = DeviceFeeder(device="cuda")
    hosts, outs = [], []
    for i in range(DISC["placements"]):
        host = {"image": frames,
                "shape_id": np.arange(n, dtype=np.int64),
                "frameid": np.arange(n, dtype=np.int64) + 1000 * (i + 1)}
        with torch.cuda.stream(feeder._copy_stream):
            torch.cuda._sleep(int(0.02 * SLEEP_HZ))
        hosts.append(host)
        outs.append(feeder.place(host))
    torch.cuda.synchronize()
    for i, (host, out) in enumerate(zip(hosts, outs)):
        for k, v in host.items():
            if not np.array_equal(out[k].cpu().numpy(), v):
                fail(f"{label}: placement {i} delivered another field's "
                     f"values as {k!r}")
    return outs[-1]


def disc_gap(disc, x, frames) -> tuple:
    """The card's logits for ``x`` against the plain path's f32 run on
    the CPU with the same weights: (card logits, max abs gap, bar)."""
    import torch

    from blendjax_torch.models import Discriminator

    logits = disc(x)
    ref = Discriminator(dtype=torch.float32)
    ref.load_state_dict({k: v.cpu() for k, v in disc.state_dict().items()})
    with torch.no_grad():
        want = ref(torch.from_numpy(frames))
    err = float((logits.detach().float().cpu() - want).abs().max())
    return logits, err, DISC_REL * max(1.0, float(want.abs().max()))


def scoring_leg(card: str) -> dict:
    """densityopt's consumer on the card: ``GaussianSimParams`` samples
    supershape parameters with a CUDA generator, the host renders them,
    ``DeviceFeeder`` places the producer's batch, the full-width
    ``Discriminator()`` (bf16 compute) scores the frames forward and
    backward, and one REINFORCE update moves the sampling distribution.
    Gates: every placed field intact, finite logits and gradients, the
    card's logits within ``DISC_REL`` of the plain path's on the CPU (f32,
    same weights) at the default size and at an odd one, ``mu`` moved and
    finite. Launches no K kernel."""
    import torch
    import torch.nn.functional as F

    from blendjax_torch.models import Discriminator
    from blendjax_torch.train.score import GaussianSimParams

    label = "scoring leg"
    sim = GaussianSimParams(DISC["mu"], DISC["log_sigma"],
                            learning_rate=0.05)
    gen = torch.Generator(device=sim.device).manual_seed(0)
    theta = sim.sample(gen, DISC["batch"])
    frames = supershape_frames(theta.cpu().numpy())
    distinct = len({f.tobytes() for f in frames})
    disc = Discriminator().init_params(0).cuda()
    x = placed_supershape_batches(frames, label)["image"]
    odd = supershape_frames(theta[:DISC["odd_batch"]].cpu().numpy(),
                            DISC["odd_shape"])
    with torch.no_grad():
        _, odd_err, odd_bar = disc_gap(disc, torch.from_numpy(odd).cuda(),
                                       odd)
    logits, err, bar = disc_gap(disc, x, frames)
    losses = F.binary_cross_entropy_with_logits(
        logits, torch.ones_like(logits), reduction="none")
    losses.mean().backward()
    grads = [p.grad for p in disc.parameters()]
    mu0 = sim.mu.clone()
    mean_loss = sim.update(theta, losses.detach())
    checks = [
        (distinct > 1, f"{distinct} distinct frames for {DISC['batch']} draws"),
        (bool(torch.isfinite(logits).all()), "non-finite logits"),
        (all(g is not None and bool(torch.isfinite(g).all()) for g in grads),
         "a missing or non-finite gradient"),
        (err <= bar, f"logits {err:.3e} off the CPU's (bar {bar:.3e})"),
        (odd_err <= odd_bar, f"logits at {DISC['odd_shape']} {odd_err:.3e} "
         f"off the CPU's (bar {odd_bar:.3e})"),
        (bool(torch.isfinite(sim.mu).all())
         and not torch.equal(sim.mu, mu0), f"mu {mu0} -> {sim.mu}"),
        (math.isfinite(mean_loss), f"mean loss {mean_loss}"),
    ]
    for ok, what in checks:
        if not ok:
            fail(f"{label}: {what}")

    def fwd_bwd():
        disc.zero_grad(set_to_none=True)
        out = disc(x)
        F.binary_cross_entropy_with_logits(
            out, torch.ones_like(out)).backward()

    t = time_ms(fwd_bwd, reps=DISC["reps"], windows=DISC["windows"])
    log(f"{label} on {card}: Discriminator() features "
        f"{disc.features}, bf16 compute, {DISC['batch']} SupershapeScene "
        f"frames {DISC['shape'][0]}x{DISC['shape'][1]}x4 ({distinct} "
        f"distinct), placed {DISC['placements']} times with every field "
        f"intact; forward+backward {spread(t)} per call (host "
        f"{t['host_ms']:.3f} ms); logits max |card - CPU f32| {err:.3e} "
        f"(bar {bar:.3e}), at {DISC['odd_shape'][0]}x{DISC['odd_shape'][1]} "
        f"({DISC['odd_batch']} frames) {odd_err:.3e} (bar {odd_bar:.3e}); "
        f"mean loss {mean_loss:.5f}; mu {mu0.tolist()} -> {sim.mu.tolist()}")
    return {"time_ms": t["ms"], "time": t, "max_abs_err": err, "bar": bar,
            "odd_max_abs_err": odd_err, "odd_bar": odd_bar,
            "mean_loss": mean_loss, "mu": sim.mu.tolist()}


def scenario_leg(adaptive: bool, card: str) -> dict:
    """One leg of ``bench.py:measure_live_scenario`` on the port: 2
    synthetic producers render the 2-scenario space the service publishes,
    ``StreamDataPipeline`` -> ``EchoingPipeline(emit_draws=True)`` -> the
    captured echo-fused step on a fresh full-width ``CubeRegressor()``,
    each step's loss attributed to its rows' scenarios; the curriculum is
    frozen (``fixed``) or republishes adapted weights (``curriculum``)."""
    import numpy as np
    import torch

    from blendjax_torch.data import EchoingPipeline, StreamDataPipeline
    from blendjax_torch.fleet import synthetic_fleet
    from blendjax_torch.models import CubeRegressor
    from blendjax_torch.scenario import (
        ScenarioCurriculum,
        ScenarioService,
        ScenarioSpace,
        accounting,
    )
    from blendjax_torch.train import (
        CapturedStep,
        make_echo_fused_step,
        make_train_state,
    )
    from blendjax_torch.utils.metrics import metrics

    cfg = SCENARIO
    label = f"scenario leg ({'curriculum' if adaptive else 'fixed'})"
    fresh_registry()
    accounting.reset()
    space = ScenarioSpace.parse(cfg["spec"])
    w0 = space.weights()
    svc = ScenarioService(space)
    shm_before = set(os.listdir("/dev/shm"))
    state = make_train_state(CubeRegressor().init_params(0))
    steps, losses, stamps = 0, [], []
    try:
        with synthetic_fleet(cfg["producers"], shape=cfg["shape"],
                             batch=cfg["batch"], rate=cfg["rate"],
                             scenario=True, bind_grace_s=0.5) as launcher:
            pids = [p.pid for p in launcher.processes]
            dirs = [launcher._ipc_dir, launcher._shm_registry]
            for i, addr in enumerate(launcher.addresses["CTRL"]):
                svc.attach(i, addr)
            acked = svc.wait_acked(timeout=15)
            pipe = StreamDataPipeline(launcher.addresses["DATA"],
                                      batch_size=cfg["train_batch"],
                                      timeoutms=30_000)
            echo = EchoingPipeline(pipe, capacity=cfg["capacity"],
                                   max_echo_factor=cfg["max_echo_factor"],
                                   emit_draws=True)
            graph_step = CapturedStep(
                make_echo_fused_step(echo.reservoir.draw))
            curriculum = ScenarioCurriculum(
                space, service=svc, every_steps=cfg["every_steps"],
                min_rows=cfg["min_rows"], adapt_params=False,
                frozen=not adaptive)

            def one_step(token):
                nonlocal state, steps
                with metrics.span("train.dispatch"):
                    state, m = graph_step(state, token)
                # the curriculum's evidence: one loss fetch per step
                loss = float(m["loss"])
                losses.append(loss)
                accounting.account_batch(token, loss=loss)
                curriculum.step(1)
                steps += 1
                stamps.append(time.perf_counter())

            with echo:
                it = iter(echo)
                # the first step (the producers' first frames, the graph's
                # capture) is accounted and gated but not timed
                t_first = time.perf_counter()
                one_step(next(it))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                first_s = t0 - t_first
                while True:
                    one_step(next(it))
                    dt = time.perf_counter() - t0
                    if steps >= cfg["min_steps"] and (
                            not adaptive or curriculum.updates >= 1):
                        break
                    if dt > cfg["time_cap"]:
                        break
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            gaps = pipe.seq_gaps + pipe.reorders + pipe.restarts
            pids = sorted(set(pids) | {p.pid for p in launcher.processes})
    finally:
        svc.stop()
    fleet_gone(label, pids, dirs, shm_before)
    report = metrics.report()
    ledger = accounting.report()
    totals = accounting.totals()
    declared_rows = sum(f + e for sid, (f, e) in totals.items()
                        if sid in space.names)
    wf = space.weights()
    half = steps // 2  # the settled rate: the last half of the steps
    out = {
        "steps": steps, "seconds": dt, "first_step_s": first_s,
        # the replays after the first step
        "img_s": (steps - 1) * cfg["train_batch"] / max(dt, 1e-9),
        "settled_img_s": (steps - 1 - half) * cfg["train_batch"]
        / max(stamps[-1] - stamps[half], 1e-9),
        "acked_before_start": acked, "space_version": space.version,
        "curriculum_updates": curriculum.updates,
        "weights_initial": w0, "weights_final": wf,
        "weight_shifted": wf["hard"] > w0["hard"] + 0.02,
        "distinct_ids": len(totals),
        "per_scenario": {
            sid: {"fresh": f, "echoed": e,
                  "loss_p50": ledger["scenarios"].get(sid, {}).get(
                      "loss", {}).get("p50"),
                  "versions": ledger["scenarios"].get(sid, {}).get(
                      "versions", {})}
            for sid, (f, e) in sorted(totals.items())},
        "accounting_exact": declared_rows == steps * cfg["train_batch"],
        "dispatch_per_step": report["spans"].get(
            "train.dispatch", {}).get("count", 0) / max(steps, 1),
        "graph_replays": graph_step.graph_replays,
        "aot_fallbacks": graph_step.aot_fallbacks,
        "seq_gaps": gaps,
        "scenario_counters": {k: int(v) for k, v in
                              report["counters"].items()
                              if k.startswith("scenario.")},
        "echo_saturated_waits": int(report["counters"].get(
            "echo.saturated_waits", 0)),
        "finite": all(math.isfinite(v) for v in losses),
    }
    checks = [
        (acked, "the producers never acked the space"),
        (out["accounting_exact"], f"fresh + echoed over the declared ids "
         f"{declared_rows} != steps {steps} x batch {cfg['train_batch']}"),
        (out["distinct_ids"] >= 2, f"ids seen {sorted(totals)}"),
        (gaps == 0, f"{gaps} sequence gaps, reorders and restarts"),
        (out["finite"], "a non-finite loss"),
        (graph_step.graph_replays == steps
         and graph_step.aot_fallbacks == 0
         and out["dispatch_per_step"] == 1.0,
         f"{graph_step.graph_replays} replays and "
         f"{graph_step.aot_fallbacks} fallbacks for {steps} step calls"),
    ]
    if adaptive:
        checks += [
            (space.version >= 2, f"space version {space.version}"),
            (out["weight_shifted"], f"weights {w0} -> {wf}: no shift "
             "toward hard"),
        ]
    for ok, what in checks:
        if not ok:
            fail(f"{label}: {what}")
    log(f"{label} on {card}: {out['img_s']:.1f} img/s into the step over "
        f"{steps - 1} replays ({dt:.2f} s) after a first step (frames, "
        f"capture) of {first_s:.2f} s, settled {out['settled_img_s']:.1f} "
        f"img/s (last half); per scenario {out['per_scenario']}; "
        f"space version {space.version}, weights "
        f"{ {k: round(v, 4) for k, v in wf.items()} } (from "
        f"{ {k: round(v, 4) for k, v in w0.items()} }); graph replays "
        f"{graph_step.graph_replays}; seq_gaps {gaps}; counters "
        f"{out['scenario_counters']}; saturated waits "
        f"{out['echo_saturated_waits']}")
    return out


def compress_runs(seq) -> list:
    """``[kind, count]`` runs of a verdict sequence."""
    runs: list = []
    for kind in seq:
        if runs and runs[-1][0] == kind:
            runs[-1][1] += 1
        else:
            runs.append([kind, 1])
    return runs


def fleet_leg(autoscale: bool, card: str) -> dict:
    """One leg of ``bench.py:measure_live_fleet`` on the port: rate-capped
    synthetic producers (2 fixed, or 1 autoscaled up to ``FLEET["max"]``)
    into ``StreamDataPipeline`` placing on the card, the
    ``FleetController`` ticking from this thread on ``pipe.doctor()``."""
    from blendjax_torch.data import StreamDataPipeline
    from blendjax_torch.fleet import (
        FleetController,
        FleetPolicy,
        synthetic_fleet,
    )
    from blendjax_torch.utils.metrics import metrics

    cfg = FLEET
    label = f"fleet leg ({'autoscaled' if autoscale else 'fixed 2'})"
    n_start = 1 if autoscale else 2
    args = ["--shape", str(cfg["shape"][0]), str(cfg["shape"][1]),
            "--batch", str(cfg["batch"]), "--rate", str(cfg["rate"])]
    fresh_registry()
    shm_before = set(os.listdir("/dev/shm"))
    trajectory, verdicts = [], []
    with synthetic_fleet(n_start, shape=cfg["shape"], batch=cfg["batch"],
                         rate=cfg["rate"], bind_grace_s=0.5) as launcher:
        dirs = [launcher._ipc_dir, launcher._shm_registry]
        pipe = StreamDataPipeline(launcher.addresses["DATA"],
                                  batch_size=2 * cfg["batch"],
                                  timeoutms=30_000)
        ctrl = FleetController(
            launcher, connector=pipe, diagnose=lambda: pipe.doctor(),
            instance_args=args,
            policy=FleetPolicy(min_instances=n_start,
                               max_instances=(cfg["max"] if autoscale
                                              else n_start),
                               up_after=2, cooldown_s=2.0))
        with pipe:
            it = iter(pipe)
            first = next(it)  # producers up, first batch on the card
            device = first["image"].device
            t0 = time.perf_counter()
            n = n_half = 0
            last_tick = 0.0
            while True:
                n += int(next(it)["image"].shape[0])
                now = time.perf_counter() - t0
                if not n_half and now >= cfg["time_cap"] / 2:
                    n_half = n
                if now - last_tick >= cfg["tick_s"]:
                    last_tick = now
                    d = ctrl.tick()
                    verdicts.append(d["verdict"])
                    trajectory.append((round(now, 1), d["instances"]))
                if now >= cfg["time_cap"]:
                    break
            dt = time.perf_counter() - t0
            instances = ctrl.state()["instances"]
            gaps = pipe.seq_gaps + pipe.reorders + pipe.restarts
        pids = [p.pid for p in launcher.processes]
    fleet_gone(label, pids, dirs, shm_before)
    counters = metrics.report()["counters"]
    settled = ((n - n_half) / (dt - cfg["time_cap"] / 2) if n_half
               else n / dt)
    out = {
        "img_s": n / dt, "settled_img_s": settled, "frames": n,
        "seconds": dt, "instances_final": instances,
        "trajectory": trajectory, "verdicts": compress_runs(verdicts),
        "scale_events": [e["action"] for e in ctrl.scale_events()],
        "scale_ups": sum(e["action"] == "scale_up"
                         for e in ctrl.scale_events()),
        "seq_gaps": gaps, "device": str(device),
        "fleet_counters": {k: int(v) for k, v in counters.items()
                           if k.startswith("fleet.")},
    }
    if gaps:
        fail(f"{label}: {gaps} sequence gaps, reorders and restarts")
    if device.type != "cuda":
        fail(f"{label}: the pipeline placed on {device}")
    log(f"{label} on {card}: {out['img_s']:.1f} img/s over {dt:.2f} s, "
        f"settled {settled:.1f} img/s (second half); instances "
        f"{instances}; trajectory (s, instances) {trajectory}; verdicts "
        f"{out['verdicts']}; scale events {out['scale_events']}; counters "
        f"{out['fleet_counters']}; seq_gaps {gaps}")
    return out


def phase_5j(card: str) -> dict:
    """Phase 5j: the scoring leg, the scenario legs (fixed, then
    curriculum) and the fleet legs (fixed 2, then autoscaled). The
    scenario and fleet paths stream raw frames, so the phase launches no K
    kernel (none of K1-K4c is on them)."""
    t0 = time.perf_counter()
    marks = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        marks[name] = round(time.perf_counter() - t, 1)
        return out

    scoring = timed("scoring", scoring_leg, card)
    scenario = {"fixed": timed("scenario fixed", scenario_leg, False, card),
                "curriculum": timed("scenario curriculum", scenario_leg,
                                    True, card)}
    fleet = {"fixed2": timed("fleet fixed 2", fleet_leg, False, card),
             "autoscaled": timed("fleet autoscaled", fleet_leg, True, card)}
    if fleet["autoscaled"]["scale_ups"] < 1:
        fail("fleet leg: the autoscaled fleet never scaled up (verdicts "
             f"{fleet['autoscaled']['verdicts']})")
    ratio = (fleet["autoscaled"]["settled_img_s"]
             / max(fleet["fixed2"]["settled_img_s"], 1e-9))
    wall = time.perf_counter() - t0
    log(f"phase 5j on {card}: discriminator forward+backward "
        f"{scoring['time_ms']:.3f} ms; scenario img/s (settled) fixed "
        f"{scenario['fixed']['img_s']:.1f} "
        f"({scenario['fixed']['settled_img_s']:.1f}), curriculum "
        f"{scenario['curriculum']['img_s']:.1f} "
        f"({scenario['curriculum']['settled_img_s']:.1f}) (hard weight "
        f"{scenario['curriculum']['weights_final']['hard']:.4f}); fleet "
        f"settled img/s fixed 2 {fleet['fixed2']['settled_img_s']:.1f}, "
        f"autoscaled {fleet['autoscaled']['settled_img_s']:.1f} (ratio "
        f"{ratio:.3f}, {fleet['autoscaled']['scale_ups']} scale-ups); "
        f"{wall:.1f} s, by leg {marks}")
    return {"scoring": scoring, "scenario": scenario, "fleet": fleet,
            "fleet_ratio": ratio, "seconds": wall}


# -- phase 5k: the examples on the card --------------------------------------------

EXAMPLES_DIR = os.path.join(ROOT, "blendjax_torch", "examples")
EX_SHAPE = ["--shape", str(SHAPE[0]), str(SHAPE[1])]
# train.py's tile leg at the flagship's full width and its replay:
# chunk groups of CHUNK replayed from the tile leg's exit snapshot, on the
# card and with --device cpu
EX_TILE = ["--batch", str(BATCH), "--encoding", "tile", "--chunk",
           str(CHUNK), "--inflight", "2", "--steps", "64"]
EX_REPLAY_STEPS = 3
# the replays' losses, card against CPU, both under the example's default
# precision policy (bf16-compute; the two backends round bf16 products and
# sum in different orders): relative bar over <= 12 AdamW updates, ~10x
# the two sound runs' readings on an H100 (7.766e-05 and 1.109e-04)
EX_REPLAY_REL = 1e-3
EX_SHORT = 16  # steps of the pal, raw and echo legs
EX_FORMER = ["--patch", "20", "--dim", "512", "--depth", "8", "--heads",
             "4", "--steps", "16"]
EX_DQN_STEPS = 300
EX_ITERS = 3  # train_reinforce and densityopt iterations


def load_example(relpath: str):
    """A port example's module, loaded by path (as its tests load it)."""
    import importlib.util

    path = os.path.join(EXAMPLES_DIR, relpath)
    name = "example_" + relpath.replace("/", "_")[:-3]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def live_children() -> set:
    """PIDs of this process's children that are not zombies."""
    me, out = os.getpid(), set()
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == me and fields[0] != "Z":
            out.add(int(d))
    return out


def run_example(label: str, relpath: str, argv: list,
                files: bool = False) -> dict:
    """``main(argv)`` of one port example in this process, its standard
    output captured (returned as ``text``) beside the dict it returns, the
    launch counts zeroed just before and read just after, and no child
    process left behind (with ``files``, no new ``/dev/shm`` segment or
    temp entry either)."""
    import contextlib
    import io

    from blendjax_torch.kernels import (
        launch_counts,
        reset_launch_counts,
        variant_counts,
    )

    fresh_registry()
    mod = load_example(relpath)
    shm0 = set(os.listdir("/dev/shm"))
    tmp0 = set(os.listdir(tempfile.gettempdir()))
    kids0 = live_children()
    buf = io.StringIO()
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            out = dict(mod.main(argv) or {})
    except BaseException as e:  # noqa: BLE001 - any end but a return fails
        print(buf.getvalue(), file=sys.stderr, flush=True)
        fail(f"{label}: {relpath} {' '.join(argv)} raised {e!r}")
    out.update(text=buf.getvalue(), wall_s=time.perf_counter() - t0,
               launches=launch_counts(), variants=variant_counts())
    deadline = time.monotonic() + 10
    while live_children() - kids0 and time.monotonic() < deadline:
        time.sleep(0.1)
    kids = sorted(live_children() - kids0)
    shm = sorted(set(os.listdir("/dev/shm")) - shm0) if files else []
    tmp = (sorted(set(os.listdir(tempfile.gettempdir())) - tmp0) if files
           else [])
    if kids or shm or tmp:
        fail(f"{label}: left behind child processes {kids}, shared-memory "
             f"segments {shm}, temp entries {tmp}")
    return out


def example_lines(text: str, *keys) -> str:
    return " | ".join(ln.strip() for ln in text.splitlines()
                      if any(k in ln for k in keys))


def capture_summary(step) -> str:
    """The signatures a leg's captured step met and what each capture took
    (a capture after the first stalls the run mid-way); for each signature
    after the first, the entries in which it differs from the first."""
    sigs, ms = step.signatures, step.capture_ms
    text = (f"{len(sigs)} captured signatures (capture "
            + ", ".join(f"{ms[g]:.0f}" for g in sigs) + " ms)")
    first = {e[0]: e[1:] for e in sigs[0]} if sigs else {}
    for n, sig in enumerate(sigs[1:], 2):
        this = {e[0]: e[1:] for e in sig}
        diff = {k: (first.get(k), this.get(k)) for k in sorted({*first, *this})
                if first.get(k) != this.get(k)}
        text += f"; signature {n} differs from the first in {diff}"
    return text


def graph_gates(label: str, out: dict, steps: int) -> None:
    """One graph replay per step call, no fallback, finite losses and the
    printed rate."""
    step = out["step"]
    if step.graph_replays != steps or step.aot_fallbacks:
        fail(f"{label}: {step.graph_replays} graph replays for {steps} step "
             f"calls, {step.aot_fallbacks} fallbacks")
    losses = [*out["losses"], out.get("last_loss", 0.0)]
    if not out["losses"] or not all(math.isfinite(v) for v in losses):
        fail(f"{label}: losses {losses}")
    if "images/sec" not in out["text"]:
        fail(f"{label}: no images/sec line printed")


def example_train_legs(tmp: str, card: str) -> dict:
    """``datagen/train.py`` on the card: the full-width tile leg (K1 inside
    the captured fused step, recording and snapshotting), its replay on the
    card and with ``--device cpu``, then pal, raw and echo."""
    import shutil

    prefix = os.path.join(tmp, "ex-rec")
    ckpt = os.path.join(tmp, "ex-ckpt")
    label = "phase 5k train.py tile"
    tile = run_example(label, "datagen/train.py", EX_SHAPE + EX_TILE + [
        "--record", prefix, "--checkpoint", ckpt, "--checkpoint-every", "0"])
    drv = tile["driver"]
    graph_gates(label, tile, drv.dispatches)
    k1 = tile["launches"]["decode_spatial"]
    if drv.steps != 64 or k1 < drv.dispatches:
        fail(f"{label}: {drv.steps} steps, K1 launched {k1} times for "
             f"{drv.dispatches} step calls (one per call inside the graph)")
    log(f"{label} on {card}: {tile['img_s']:.1f} img/s live over "
        f"{tile['images']} images, {drv.steps} step calls = "
        f"{tile['step'].graph_replays} graph replays over "
        f"{capture_summary(tile['step'])}, K1 {k1} launches, final loss {tile['last_loss']:.5f}, seq_gaps "
        f"{tile['seq_gaps']}; {tile['wall_s']:.1f} s; printed: "
        + example_lines(tile["text"], "images/sec", "checkpoints in"))

    replay = {}
    for dev in ("cuda", "cpu"):
        ck = os.path.join(tmp, f"ex-ckpt-{dev}")
        shutil.copytree(ckpt, ck)
        label = f"phase 5k train.py replay ({dev})"
        argv = EX_SHAPE + ["--batch", str(BATCH), "--encoding", "tile",
                           "--chunk", str(CHUNK), "--steps",
                           str(EX_REPLAY_STEPS), "--replay", prefix,
                           "--checkpoint", ck, "--resume",
                           "--checkpoint-every", "0", "--device", dev]
        out = run_example(label, "datagen/train.py", argv)
        if "resumed from snapshot step 64" not in out["text"]:
            fail(f"{label}: did not resume from the tile leg's snapshot: "
                 + example_lines(out["text"], "resumed", "snapshot"))
        if dev == "cuda":
            graph_gates(label, out, EX_REPLAY_STEPS)
            if out["launches"]["decode_spatial"] <= 0:
                fail(f"{label}: K1 never launched")
        replay[dev] = out
    got = [replay["cuda"]["losses"][0], replay["cuda"]["last_loss"]]
    want = [replay["cpu"]["losses"][0], replay["cpu"]["last_loss"]]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    if not rel <= EX_REPLAY_REL:
        fail(f"phase 5k replay: card losses {got} against the CPU's {want} "
             f"(rel {rel:.3e} > {EX_REPLAY_REL})")
    log(f"phase 5k train.py replay of {EX_REPLAY_STEPS} chunk groups from "
        f"the tile leg's step-64 snapshot: card {got} ({replay['cuda']['wall_s']:.1f} s), "
        f"CPU {want} ({replay['cpu']['wall_s']:.1f} s), first and last "
        f"update's losses within rel {rel:.3e} (bar {EX_REPLAY_REL}, "
        f"bf16-compute); card {capture_summary(replay['cuda']['step'])}, K1 "
        f"{replay['cuda']['launches']['decode_spatial']} launches in the "
        f"pipeline's decode, on {card}")

    legs = {"tile": tile, "replay": replay["cuda"]}
    for name, extra in (
            ("pal", ["--encoding", "pal", "--chunk", str(CHUNK),
                     "--inflight", "2"]),
            ("raw", []),
            ("echo", ["--echo", "4"])):
        label = f"phase 5k train.py {name}"
        out = run_example(label, "datagen/train.py", EX_SHAPE + [
            "--batch", str(BATCH), "--steps", str(EX_SHORT), *extra])
        drv = out["driver"]
        graph_gates(label, out, drv.dispatches if drv else EX_SHORT)
        if name == "echo" and out["echo"]["steps"] < EX_SHORT:
            fail(f"{label}: echo stats {out['echo']}")
        log(f"{label} on {card}: {out['img_s']:.1f} img/s over "
            f"{out['images']} images, {out['step'].graph_replays} graph "
            f"replays over {capture_summary(out['step'])}, last loss {out['last_loss']:.5f}, seq_gaps "
            f"{out['seq_gaps']}; {out['wall_s']:.1f} s"
            + (f"; echo {out['echo']}" if name == "echo" else ""))
        legs[name] = out
    return legs


def example_former_leg(card: str) -> dict:
    """``datagen/train_transformer.py`` at StreamFormer's full width: K4a-c
    through their sm90 variants inside the captured step, depth x steps
    launches each."""
    label = "phase 5k train_transformer.py"
    out = run_example(label, "datagen/train_transformer.py",
                      EX_SHAPE + EX_FORMER)
    steps = int(EX_FORMER[EX_FORMER.index("--steps") + 1])
    depth = int(EX_FORMER[EX_FORMER.index("--depth") + 1])
    graph_gates(label, out, steps)
    want = depth * steps
    for name in ("flash_attention_fwd", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq"):
        if (out["launches"][name] != want
                or out["variants"][name] != {"sm90": want, "simple": 0}):
            fail(f"{label}: {name} launched {out['launches'][name]} times "
                 f"({out['variants'][name]}), not {want} through sm90")
    log(f"{label} on {card}: {out['img_s']:.1f} img/s over mesh "
        f"{out['mesh']}, {out['step'].graph_replays} graph replays over "
        f"{capture_summary(out['step'])}, K4a-c "
        f"{want} sm90 launches each, losses {out['losses']}; "
        f"{out['wall_s']:.1f} s")
    return out


def example_control_legs(card: str) -> dict:
    """``control/train_dqn.py``, ``control/train_reinforce.py`` and
    ``densityopt/densityopt.py`` on the card: each ends normally and prints
    its figures."""
    label = "phase 5k train_dqn.py"
    dqn = run_example(label, "control/train_dqn.py",
                      ["--steps", str(EX_DQN_STEPS)], files=True)
    if (dqn["steps"] != EX_DQN_STEPS or "final:" not in dqn["text"]
            or "mean_return=" not in dqn["text"]
            or dqn["step"].graph_replays != EX_DQN_STEPS
            or not math.isfinite(dqn["loss"])):
        fail(f"{label}: {dqn['steps']} steps, {dqn['step'].graph_replays} "
             f"replays, loss {dqn['loss']}: "
             + example_lines(dqn["text"], "final"))
    label = "phase 5k train_reinforce.py"
    pg = run_example(label, "control/train_reinforce.py",
                     ["--iters", str(EX_ITERS)], files=True)
    if (len(pg["history"]) != EX_ITERS
            or not all(math.isfinite(v) for h in pg["history"] for v in h)):
        fail(f"{label}: {pg['history']}")
    label = "phase 5k densityopt.py"
    dens = run_example(label, "densityopt/densityopt.py",
                       ["--iters", str(EX_ITERS)], files=True)
    mus = [h["mu"] for h in dens["history"]]
    if len(mus) != EX_ITERS or not all(math.isfinite(m) for m in mus):
        fail(f"{label}: mu {mus}")
    log(f"phase 5k control on {card}: train_dqn {EX_DQN_STEPS} learner steps "
        f"({dqn['step'].graph_replays} graph replays) in {dqn['wall_s']:.1f} "
        f"s: " + example_lines(dqn["text"], "final:")
        + f"; train_reinforce {EX_ITERS} iterations in {pg['wall_s']:.1f} s: "
        + example_lines(pg["text"], f"iter {EX_ITERS - 1}:")
        + f"; densityopt {EX_ITERS} iterations in {dens['wall_s']:.1f} s: "
        + example_lines(dens["text"], f"iter {EX_ITERS - 1}:"))
    return {"dqn": dqn, "reinforce": pg, "densityopt": dens}


# phase 5k's two-rank sub-leg: datagen/train.py on {"data": 2}, two
# processes on the one card over gloo (NCCL refuses two ranks of one
# device), each calling the example's main in its own group. The tile runs
# sync every loss (inflight 1): each step's loss is then the same entry of
# the driver's list in every run.
MESH_EX = {"steps": 16, "every": 8, "scenario_steps": 16,
           "fleet_steps": 300, "deadline_s": 420}
MESH_EX_TILE = EX_SHAPE + ["--batch", str(BATCH), "--encoding", "tile",
                           "--chunk", str(CHUNK), "--inflight", "1",
                           "--sync-every", "1"]
MESH_EX_SPACE = ("easy:half_extent=u(0.8,1.2) / "
                 "hard:half_extent=u(0.8,1.2),xy_jitter=g(6,0.5)")
# one card against two ranks: the ranks' gradient mean sums in another
# order, and cuDNN picks its algorithms per batch shape (4 rows on a rank,
# 8 on one card). The sub-leg computes in f32 with TF32 off (the
# flagship's widths, the f32 policy): bit for bit within one world size,
# and across world sizes the two-rank leg's card bar (TWO_RANK["loss_rel"];
# the CPU tests hold 1e-5, and an H100 read 1.209e-05 over 8 steps)
MESH_EX_REL = 1e-4
def mesh_example_runs(wdir: str) -> list:
    """The ranks' runs of ``datagen/train.py``, in order (``None`` argv:
    the step between two runs that :func:`mesh_example_child` names)."""
    rec, cut = os.path.join(wdir, "rec"), os.path.join(wdir, "rec-cut")
    ckpt, first = os.path.join(wdir, "ckpt"), os.path.join(wdir, "ckpt-8")
    steps, every = str(MESH_EX["steps"]), MESH_EX["every"]
    synth = EX_SHAPE + ["--batch", str(BATCH), "--synthetic-producers", "1"]
    return [
        ("live", MESH_EX_TILE + ["--instances", "1", "--steps", steps,
                                 "--record", rec, "--checkpoint", ckpt,
                                 "--checkpoint-every", str(every)]),
        ("cut", None),
        ("replay", MESH_EX_TILE + ["--steps", steps, "--replay", cut]),
        ("resume", MESH_EX_TILE + ["--steps", str(every), "--replay", cut,
                                   "--checkpoint", first, "--resume",
                                   "--checkpoint-every", "0"]),
        ("scenarios", synth + ["--steps", str(MESH_EX["scenario_steps"]),
                               "--scenarios", MESH_EX_SPACE, "--curriculum",
                               "--curriculum-every", "4"]),
        ("fleet", synth + ["--steps", str(MESH_EX["fleet_steps"]),
                           "--fleet", "1:2"]),
    ]


@contextlib.contextmanager
def f32_cube():
    """``CubeRegressor`` computing in f32 as the examples import it, TF32
    off, for the duration."""
    import torch

    import blendjax_torch.models as PM

    base = PM.CubeRegressor

    class F32Cube(base):
        def __init__(self, *a, **kw):
            kw.setdefault("dtype", torch.float32)
            super().__init__(*a, **kw)

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    PM.CubeRegressor = F32Cube
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        PM.CubeRegressor = base
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def cut_recording(src: str, dst: str, n: int) -> None:
    """The first ``n`` messages of recording ``src`` as ``dst``."""
    from blendjax_torch.data import FileReader, FileRecorder

    reader = FileReader(src)
    with FileRecorder(dst) as rec:
        for i in range(n):
            rec.save(reader.frames(i))
    reader.close()


def rank_example(argv: list) -> dict:
    """One run of ``datagen/train.py`` on this rank: its printed text, the
    plain values of what it returns, its wall time and the launch counts
    zeroed just before and read just after."""
    import contextlib
    import io

    from blendjax_torch.kernels import launch_counts, reset_launch_counts
    from blendjax_torch.scenario import accounting

    fresh_registry()
    accounting.reset()
    mod = load_example("datagen/train.py")
    buf = io.StringIO()
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = dict(mod.main(argv) or {})
    wall = time.perf_counter() - t0
    keep = {k: out[k] for k in ("losses", "last_loss", "img_s", "images",
                                "seq_gaps", "checkpoint", "scenarios",
                                "curriculum_weights", "fleet") if k in out}
    drv = out.get("driver")
    if drv is not None:
        keep.update(driver_losses=list(drv.losses), steps=drv.steps,
                    eager_calls=getattr(drv.step, "eager_calls", None),
                    images_retired=drv.images_retired)
    return {**keep, "text": buf.getvalue(), "wall_s": wall,
            "launches": launch_counts()}


def _cut_and_copy(rank: int, wdir: str, every: int) -> int:
    """Between the live run and the replay: this rank keeps the messages
    of the live run's first ``every`` steps (a replay of them loops with
    that period), and rank 0 copies the step-``every`` snapshot alone.
    Returns the messages kept."""
    import shutil

    from blendjax_torch.checkpoint import SnapshotManager
    from blendjax_torch.data.replay import rank_prefix

    done = SnapshotManager(os.path.join(wdir, "ckpt"),
                           read_only=True).restore(step=every)
    # each update took one message of BATCH / 2 rows on each rank
    messages = done.session["driver"]["images_retired"] // BATCH
    cut_recording(
        rank_prefix(os.path.join(wdir, "rec"), rank, 2) + "_00.bjr",
        rank_prefix(os.path.join(wdir, "rec-cut"), rank, 2) + "_00.bjr",
        messages)
    if rank == 0:
        shutil.copytree(os.path.join(wdir, "ckpt", f"step-{every:08d}"),
                        os.path.join(wdir, "ckpt-8", f"step-{every:08d}"))
    return messages


def mesh_example_child(rank: int, wdir: str) -> None:
    """One rank of phase 5k's two-rank sub-leg: the gloo group of both
    ranks on the card, then :func:`mesh_example_runs` one after another,
    in f32 (:func:`f32_cube`) under deterministic algorithms (the
    same-world gates are bit for bit); results pickled to ``wdir``."""
    import pickle
    import traceback

    import torch
    import torch.distributed as dist

    from blendjax_torch.parallel.mesh import init_group

    out: dict = {}
    try:
        torch.cuda.set_device(0)
        init_group("cuda", store_dir=wdir, backend="gloo", rank=rank,
                   world_size=2)
        _deterministic(True)
        every = MESH_EX["every"]
        with f32_cube():
            for name, argv in mesh_example_runs(wdir):
                if argv is None:
                    out["cut_messages"] = _cut_and_copy(rank, wdir, every)
                else:
                    out[name] = rank_example(argv)
                dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        out["error"] = traceback.format_exc()
    with open(os.path.join(wdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    sys.exit(1 if "error" in out else 0)


def _mark_holders(mark: str) -> list:
    """PIDs of live processes whose environment holds ``mark``."""
    found = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/environ", "rb") as f:
                env = f.read()
            with open(f"/proc/{d}/stat") as f:
                zombie = f.read().rsplit(")", 1)[1].split()[0] == "Z"
        except OSError:
            continue
        if mark.encode() in env and not zombie:
            found.append(int(d))
    return found


def _rel_gap(got: list, want: list) -> float:
    if len(got) != len(want) or not got:
        return math.inf
    return max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(got, want))


def mesh_examples_leg(tmp: str, card: str) -> dict:
    """Phase 5k's two-rank sub-leg: ``datagen/train.py`` at 480x640 on
    ``{"data": 2}``, two processes on the card over gloo
    (:func:`mesh_example_child`), then the one-card runs of the same
    recording and snapshot here. Gates: K1 launched on every rank of the
    tile runs; the rank-tagged recordings; the replay of the cut
    recording equal to the live losses and the resume from the step-8
    snapshot equal to the replay's second period, bit for bit; the
    one-card replay and resume within ``MESH_EX_REL``; the scenario rows
    summed over the ranks equal to steps x batch, one space version and
    one set of weights; one instance count within the bounds; no process,
    directory or shared-memory segment left."""
    import pickle
    import shutil

    wdir = tempfile.mkdtemp(dir=tmp)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    # the ranks and their producers keep their temporary files here: it
    # must be empty at the end, and a process whose environment names it
    # is one of theirs
    mark = os.path.join(wdir, "tmp")
    os.makedirs(mark)
    env["TMPDIR"] = mark
    env.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    shm0 = set(os.listdir("/dev/shm"))
    tmp0 = set(os.listdir(tempfile.gettempdir()))
    t0 = time.perf_counter()
    logs = [open(os.path.join(wdir, f"rank{r}.log"), "w") for r in range(2)]
    code = ("import sys, chip_smoke as cs; "
            "cs.mesh_example_child(int(sys.argv[1]), sys.argv[2])")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), wdir], cwd=ROOT, env=env,
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(2)]
    deadline = time.monotonic() + MESH_EX["deadline_s"]
    for p in procs:
        try:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
    alive = [p for p in procs if p.poll() is None]
    for p in alive:
        p.kill()
        p.wait()
    for f in logs:
        f.close()
    ranks_s = time.perf_counter() - t0
    results = []
    for r in range(2):
        path = os.path.join(wdir, f"rank{r}.pkl")
        res = None
        if os.path.exists(path):
            with open(path, "rb") as f:
                res = pickle.load(f)
        results.append(res)
    bad = [r for r, res in enumerate(results)
           if alive or res is None or "error" in res]
    if bad:
        for r in range(2):
            with open(os.path.join(wdir, f"rank{r}.log")) as f:
                print(f"-- rank {r} (exit {procs[r].returncode}):\n"
                      + f.read()[-6000:], file=sys.stderr)
        res = results[bad[0]]
        fail(f"phase 5k mesh examples: rank {bad[0]} "
             + ("did not finish in time" if alive else "failed")
             + (f": {res['error']}" if res and "error" in res else ""))
    label = "phase 5k mesh examples"
    launches = {"decode_spatial": 0}
    calls = {name: int(argv[argv.index("--steps") + 1])
             for name, argv in mesh_example_runs(wdir) if argv}
    for r, res in enumerate(results):
        for run in ("live", "replay", "resume"):
            k1 = res[run]["launches"]["decode_spatial"]
            if k1 <= 0 or res[run]["eager_calls"] != calls[run]:
                fail(f"{label}, rank {r}, {run}: K1 launched {k1} times, "
                     f"{res[run]['eager_calls']} eager step calls for "
                     f"{calls[run]} steps")
        for run, out in res.items():
            if isinstance(out, dict) and "launches" in out:
                launches["decode_spatial"] += out["launches"][
                    "decode_spatial"]
    rec = sorted(n for n in os.listdir(wdir) if n.startswith("rec."))
    if rec != ["rec.rank0-of-2_00.bjr", "rec.rank1-of-2_00.bjr"]:
        fail(f"{label}: the live run's recordings are {rec}")
    every = MESH_EX["every"]
    for r, res in enumerate(results):
        live = res["live"]["driver_losses"]
        replay = res["replay"]["driver_losses"]
        # a resumed driver's list starts with the snapshot's loss tail
        resume = res["resume"]["driver_losses"][-every:]
        if replay[:every] != live[:every]:
            fail(f"{label}, rank {r}: the replay's losses {replay[:every]} "
                 f"are not the live run's {live[:every]}")
        if resume != replay[every:2 * every]:
            fail(f"{label}, rank {r}: the resumed losses {resume} are not "
                 f"the replay's second period {replay[every:2 * every]}")
        if res["live"]["checkpoint"]["steps"][-2:] != [every,
                                                       MESH_EX["steps"]]:
            fail(f"{label}, rank {r}: snapshots "
                 f"{res['live']['checkpoint']['steps']}")
    if results[0]["live"]["driver_losses"] != results[1]["live"][
            "driver_losses"]:
        fail(f"{label}: the ranks' live losses differ")
    # the one-card runs of the same recording and snapshot, here
    _deterministic(True)
    try:
        with f32_cube():
            cut = os.path.join(wdir, "rec-cut")
            one_replay = run_example(
                f"{label}, one card replay", "datagen/train.py",
                MESH_EX_TILE + ["--steps", str(every), "--replay", cut])
            ck = os.path.join(wdir, "ckpt-one")
            shutil.copytree(os.path.join(wdir, "ckpt", f"step-{every:08d}"),
                            os.path.join(ck, f"step-{every:08d}"))
            one_resume = run_example(
                f"{label}, one card resume", "datagen/train.py",
                MESH_EX_TILE + ["--steps", str(every), "--replay", cut,
                                "--checkpoint", ck, "--resume",
                                "--checkpoint-every", "0"])
    finally:
        _deterministic(False)
    for one in (one_replay, one_resume):
        launches["decode_spatial"] += one["launches"]["decode_spatial"]
    gaps = {
        "replay": _rel_gap(list(one_replay["driver"].losses),
                           results[0]["live"]["driver_losses"][:every]),
        "resume": _rel_gap(list(one_resume["driver"].losses)[-every:],
                           results[0]["resume"]["driver_losses"][-every:]),
    }
    if not all(g <= MESH_EX_REL for g in gaps.values()):
        fail(f"{label}: one card against two ranks, largest rel gaps {gaps} "
             f"(bar {MESH_EX_REL})")
    if "(saved by 2 ranks)" not in one_resume["text"]:
        fail(f"{label}: the one-card resume printed "
             + example_lines(one_resume["text"], "resumed"))
    scen = [res["scenarios"]["scenarios"] for res in results]
    rows = sum(s["rows"] for s in scen[0]["scenarios"].values())
    want_rows = MESH_EX["scenario_steps"] * BATCH
    if (scen[0] != scen[1] or rows != want_rows
            or results[0]["scenarios"]["curriculum_weights"]
            != results[1]["scenarios"]["curriculum_weights"]):
        fail(f"{label}: scenario reports {scen}, rows {rows} (want "
             f"{want_rows}), weights "
             f"{[res['scenarios']['curriculum_weights'] for res in results]}")
    fleets = [res["fleet"]["fleet"] for res in results]
    if (fleets[0]["instances"] != fleets[1]["instances"]
            or not 1 <= fleets[0]["instances"] <= 2
            or fleets[0]["ticks"] != fleets[1]["ticks"]):
        fail(f"{label}: fleet states {fleets}")
    deadline = time.monotonic() + 10
    while _mark_holders(mark) and time.monotonic() < deadline:
        time.sleep(0.2)
    left = _mark_holders(mark)
    shm = sorted(set(os.listdir("/dev/shm")) - shm0)
    # torch makes its own per-user cache directory at the first use of
    # some of its modules (torchinductor_<user>): not this leg's
    tmps = sorted(n for n in (set(os.listdir(tempfile.gettempdir())) - tmp0)
                  | set(os.listdir(mark))
                  if not n.startswith("torchinductor_"))
    if left or shm or tmps:
        fail(f"{label}: left behind processes {left}, shared-memory "
             f"segments {shm}, temp entries {tmps}")
    shutil.rmtree(wdir)
    r0 = results[0]
    ck = r0["live"]["checkpoint"]
    for r, res in enumerate(results):
        log(f"{label} on {card}, rank {r}: "
            + "; ".join(f"{run} {res[run]['wall_s']:.1f} s, "
                        f"{res[run]['img_s']:.1f} img/s on this rank, K1 "
                        f"{res[run]['launches']['decode_spatial']}"
                        for run in ("live", "replay", "resume",
                                    "scenarios", "fleet"))
            + f"; cut at {res['cut_messages']} messages")
    log(f"{label} on {card}: two ranks {ranks_s:.1f} s; live losses "
        f"{r0['live']['driver_losses'][:3]}...; replay == live and resume == "
        f"replay's second period, bit for bit, on both ranks; one card "
        f"against two ranks: rel gaps {gaps} (bar {MESH_EX_REL}); snapshots "
        f"{ck['steps']}, {ck['bytes']} bytes in {len(ck['save_ms'])} "
        f"writes ({', '.join(f'{ms:.1f}' for ms in ck['save_ms'])} ms); "
        f"scenario rows {rows} = {MESH_EX['scenario_steps']} x {BATCH}, "
        f"space v{scen[0]['space_version']}, weights "
        f"{r0['scenarios']['curriculum_weights']} on both ranks; fleet "
        f"{fleets[0]['instances']} instances on both ranks after "
        f"{fleets[0]['ticks']} agreed ticks (last verdict "
        f"{fleets[0]['verdict']}); K1 launches {launches['decode_spatial']}")
    return {"ranks": results, "launches": launches, "wall_s": ranks_s,
            "gaps": gaps}


def phase_5k(tmp: str, card: str) -> dict:
    """Phase 5k: the port's examples run in this process, each ``main()``
    loaded by path with its argv (see the module docstring)."""
    t0 = time.perf_counter()
    legs = example_train_legs(tmp, card)
    t1 = time.perf_counter()
    mesh = mesh_examples_leg(tmp, card)
    t2 = time.perf_counter()
    former = example_former_leg(card)
    t3 = time.perf_counter()
    control = example_control_legs(card)
    wall = time.perf_counter() - t0
    launches = {"decode_spatial": sum(
        leg["launches"]["decode_spatial"] for leg in legs.values())
        + mesh["launches"]["decode_spatial"]}
    for name in ("flash_attention_fwd", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq"):
        launches[name] = former["launches"][name]
    log(f"phase 5k (the examples) in {wall:.1f} s: train.py legs "
        f"{t1 - t0:.1f} s, the two-rank sub-leg {t2 - t1:.1f} s, "
        f"train_transformer.py {t3 - t2:.1f} s, control and densityopt "
        f"{wall - (t3 - t0):.1f} s; launches {launches}")
    return {"legs": legs, "mesh": mesh, "former": former,
            "control": control, "launches": launches, "seconds": wall}


def eager_against_graph(label: str, make_step, make_state, batches) -> dict:
    """``make_step()`` run ``len(batches)`` times eagerly on one state and
    through ``CapturedStep(make_step())`` on another made the same way:
    losses and every parameter must be bit-equal, and the launches counted
    through the wrapper must equal the eager launches. Returns the
    wrapper, its state and its launches beside the losses."""
    import torch

    from blendjax_torch.kernels import launch_counts, reset_launch_counts
    from blendjax_torch.train import CapturedStep

    a, b = make_state(), make_state()
    reset_launch_counts()
    eager = make_step()
    la = [eager(a, dict(x))[1]["loss"] for x in batches]
    eager_counts = launch_counts()
    reset_launch_counts()
    graph = CapturedStep(make_step())
    lb = [graph(b, dict(x))[1]["loss"] for x in batches]
    graph_counts = launch_counts()
    torch.cuda.synchronize()
    for i, (x, y) in enumerate(zip(la, lb)):
        if not torch.equal(x, y):
            fail(f"graph parity {label}: step {i} loss eager {x.tolist()} != "
                 f"graph {y.tolist()}")
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        if not torch.equal(p, q):
            fail(f"graph parity {label}: parameter {name} differs after "
                 f"{len(batches)} steps")
    if a.step != b.step or eager_counts != graph_counts:
        fail(f"graph parity {label}: steps {a.step} / {b.step}, launches "
             f"eager {eager_counts} / graph {graph_counts}")
    n = sum(1 for _ in a.model.parameters())
    log(f"graph parity {label}: {len(batches)} steps eager and through "
        f"{len(graph.signatures)} captured graph(s) from one state: losses "
        f"and all {n} parameters bit-equal; launches counted through "
        f"the wrapper equal the eager launches {dict((k, v) for k, v in graph_counts.items() if v)}")
    return {"steps": len(batches),
            "losses": [float(x.reshape(-1)[-1]) for x in la],
            "wrapped": graph, "state": b, "launches": graph_counts,
            "calls": len(batches), "updates": b.step}


def graph_parity_phase(legs: dict, echo: dict) -> dict:
    """Each step builder of the slice, eager against captured, from one
    snapshot (cuDNN deterministic for the phase, so that two eager runs
    are bit-equal too)."""
    import torch

    from blendjax_torch.models import CubeRegressor
    from blendjax_torch.train import (
        make_echo_fused_step,
        make_fused_tile_step,
        make_train_state,
    )

    torch.backends.cudnn.deterministic = True
    try:
        cube = make_train_state(CubeRegressor().init_params(3))
        out = {}
        for label, leg in (("fused tile K1", "flagship"),
                           ("fused tile K2", "square")):
            out[label] = eager_against_graph(
                label, make_fused_tile_step, lambda: copy.deepcopy(cube),
                legs[leg]["recorded"])
        sf = legs["streamformer"]
        out["streamformer K4a-c"] = eager_against_graph(
            "streamformer K1 + K4a-c",
            lambda: make_fused_tile_step(former_loss),
            lambda: copy.deepcopy(sf["fresh"]), sf["recorded"])
        draw = echo["reservoir"].draw
        out["echo"] = eager_against_graph(
            "echo", lambda: make_echo_fused_step(draw),
            lambda: copy.deepcopy(cube), echo["tokens"])
    finally:
        torch.backends.cudnn.deterministic = False
    return out


def shift_augment(seed: int, images):
    """A plain ``fn(seed, images)`` (no ``SeededAugment``): a brightness
    shift of 1-63 drawn by a generator of its own, seeded from ``seed`` on
    the images' card. A capture could neither register that generator nor
    follow the seed, so every captured wrapper runs a step over it
    eagerly."""
    import torch

    gen = torch.Generator(device=images.device).manual_seed(int(seed))
    shift = torch.randint(1, 64, (), generator=gen, device=images.device)
    return images + shift.to(images.dtype)


def host_shift(seed: int, images):
    """The same shift taken from the seed on the host (``seed % 63 + 1``):
    capturable, but a graph would replay its capture's shift at every
    call. Used only to time the step a capture would give."""
    return images + (int(seed) % 63 + 1)


def plain_augment_phase(legs: dict, card: str) -> dict:
    """Captured steps over a plain ``fn(seed, images)`` augmentation
    (:func:`shift_augment`), each from one snapshot against the same step
    run eagerly (cuDNN deterministic): the fused tile step on the
    flagship's recorded groups under ``CapturedStep`` (K1),
    ``TrainDriver.build(augment=fn, aot=True)`` on decoded flagship
    batches, and the echo step over a reservoir whose ``augment`` is
    plain. Each must give the eager step's losses bit for bit, with every
    call eager (``eager_calls`` == calls, no replay); the fused leg must
    launch K1. Beside them the fused step over a ``SeededAugment``
    (``make_augment(color_jitter)``) must still replay one graph per
    call. Then ms per update of the fused step over the plain ``fn``
    eagerly, against the same step with :func:`host_shift` forced through
    a capture (what a capture would cost, with the wrong augmentation)
    and the seeded step's replays."""
    import numpy as np
    import torch

    from blendjax_torch.data import SampleReservoir
    from blendjax_torch.models import CubeRegressor
    from blendjax_torch.ops import augment as A
    from blendjax_torch.ops.tiles import decode_packed_superbatch
    from blendjax_torch.train import (
        CapturedStep,
        TrainDriver,
        make_echo_fused_step,
        make_fused_tile_step,
        make_supervised_step,
        make_train_state,
    )

    groups = legs["flagship"]["recorded"]
    out = {}
    torch.backends.cudnn.deterministic = True
    try:
        cube = make_train_state(CubeRegressor().init_params(5))

        def fresh():
            return copy.deepcopy(cube)

        out["fused"] = eager_against_graph(
            "plain augment fused tile K1",
            lambda: make_fused_tile_step(augment=shift_augment),
            fresh, groups)
        out["seeded"] = eager_against_graph(
            "SeededAugment fused tile K1",
            lambda: make_fused_tile_step(augment=A.make_augment(A.color_jitter)),
            fresh, groups)
        full = [g for g in (*groups, *legs["flagship"]["first"])
                if int(g["_packed"].shape[0]) == CHUNK]
        decoded = []
        for g in full[:PARITY_STEPS]:
            fields = decode_packed_superbatch(
                g["_packed"], g["_refs"], g["_spec"], g["_names"],
                g["_geoms"], g["_rle"])
            decoded.append({k: fields[k].flatten(0, 1) for k in ("image", "xy")})
        batches = [decoded[i % len(decoded)] for i in range(PARITY_STEPS)]
        # the entry point a user calls: TrainDriver.build over the plain fn
        model = CubeRegressor().init_params(5)
        ref = make_train_state(copy.deepcopy(model))
        drv = TrainDriver.build(model, batches[0], augment=shift_augment,
                                aot=True, inflight=2, sync_every=0)
        eager = make_supervised_step(augment=shift_augment)
        for i, batch in enumerate(batches):
            drv.submit(batch)
            got = drv.drain()
            want = float(eager(ref, batch)[1]["loss"])
            if got != want:
                fail(f"plain augment aot: update {i} loss {got} != eager "
                     f"{want}")
        for p, q in zip(drv.state.model.parameters(), ref.model.parameters()):
            if not torch.equal(p, q):
                fail("plain augment aot: parameters differ from the eager "
                     "step's")
        out["aot"] = {"wrapped": drv.step, "calls": len(batches),
                      "updates": drv.state.step, "launches": {}}
        res = SampleReservoir(
            2 * len(decoded[0]["image"]), device="cuda",
            augment=lambda seed, b: {**b, "image": shift_augment(
                seed, b["image"])})
        for batch in batches[:2]:
            res.insert(batch)
        rng = np.random.default_rng(0)
        tokens = [res.draw_token(rng.integers(0, res.capacity,
                                              len(batches[0]["image"])))
                  for _ in range(PARITY_STEPS)]
        out["echo"] = eager_against_graph(
            "plain augment echo", lambda: make_echo_fused_step(res.draw),
            fresh, tokens)
    finally:
        torch.backends.cudnn.deterministic = False
    for label in ("fused", "aot", "echo"):
        leg = out[label]
        w = leg["wrapped"]
        if w.eager_calls != leg["calls"] or w.graph_replays:
            fail(f"plain augment {label}: {w.eager_calls} eager calls and "
                 f"{w.graph_replays} replays for {leg['calls']} calls")
        if getattr(w, "aot_fallbacks", 0) or any(
                g is not None for g in getattr(w, "_graphs", {}).values()):
            fail(f"plain augment {label}: a graph was captured or a call "
                 f"fell back ({w.aot_fallbacks} fallbacks)")
    if out["fused"]["launches"].get("decode_spatial", 0) <= 0:
        fail("plain augment fused: K1 (decode_spatial) never launched")
    seeded = out["seeded"]["wrapped"]
    if (seeded.graph_replays != len(groups) or seeded.eager_calls
            or not seeded.signatures):
        fail(f"plain augment: the SeededAugment step made "
             f"{seeded.graph_replays} replays and {seeded.eager_calls} eager "
             f"calls for {len(groups)} calls")

    counts = {label: {"calls": out[label]["calls"],
                      "updates": out[label]["updates"],
                      "eager_calls": out[label]["wrapped"].eager_calls,
                      "graph_replays": out[label]["wrapped"].graph_replays,
                      "k1": out[label]["launches"].get("decode_spatial", 0)}
              for label in ("fused", "aot", "echo", "seeded")}

    # ms per update on the last recorded group: the plain fn eagerly (the
    # wrapper's route), the same step forced through a capture, the seeded
    # step's replays
    group = groups[-1]
    k = int(group["_packed"].shape[0])
    reps = 16
    forced = make_fused_tile_step(augment=host_shift)
    forced.capturable = lambda state, batch: True  # timing only
    forced_graph = CapturedStep(forced)
    forced_state = copy.deepcopy(cube)
    forced_graph.prepare(forced_state, group)
    plain_state = out["fused"]["state"]
    seeded_state = out["seeded"]["state"]
    plain = out["fused"]["wrapped"]
    ms = {}
    for _ in range(2):  # alternating, the second round kept
        ms["eager"] = alone_ms(lambda: plain(plain_state, dict(group)),
                               reps) / k
        ms["forced_capture"] = alone_ms(
            lambda: forced_graph(forced_state, dict(group)), reps) / k
        ms["seeded_capture"] = alone_ms(
            lambda: seeded(seeded_state, dict(group)), reps) / k
    log(f"plain augment: fn(seed, images) steps eager under the captured "
        f"wrappers, bit-equal with their eager twins: {json.dumps(counts)}; "
        f"ms per update of the fused K1 step (K'={k}, {reps} calls, host "
        f"and card) on {card}: plain fn eager {ms['eager']:.3f}, the same "
        f"step forced through a capture {ms['forced_capture']:.3f} (a "
        f"frozen seed: timing only), SeededAugment captured "
        f"{ms['seeded_capture']:.3f}")
    return {"counts": counts, "ms_per_update": ms, "k": k}


#: the dispatch phase: calls held against their eager twins, calls made
#: after them (replaying the same graphs), the timed draw's rows
DISPATCH = {"parity": 4, "held": 8, "later": 8, "draw_batch": 32}
#: the host's CUDA API calls that queue work on the card, as the profiler
#: names them
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
               "cudaGraphLaunch")


def launches_per_call(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler`` (the guarded trace):
    the host's launch API calls (``LAUNCH_APIS``), in all and by name."""
    import torch

    from blendjax_torch.utils.metrics import trace

    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as logdir, trace(logdir) as prof:
        if prof is None:
            fail("launches_per_call: another profiler trace is open")
        fn()
        torch.cuda.synchronize()
    api = {}
    for ev in prof.key_averages():
        if ev.key in LAUNCH_APIS:
            api[ev.key] = api.get(ev.key, 0) + ev.count
    return {"host": sum(api.values()), "by_api": api}


def same_outputs(label: str, got: list, want: list) -> None:
    """Every tensor of every call's output equal to its eager twin's."""
    import torch

    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        if set(g) != set(w):
            fail(f"{label}: call {i} fields {sorted(g)} != eager {sorted(w)}")
        for k, v in w.items():
            if not torch.equal(g[k], v):
                fail(f"{label}: call {i} field {k} differs from its eager "
                     "twin")


def dispatch_pairs(label: str, dispatch, calls: list) -> dict:
    """``calls`` (``(eager, captured)`` pairs of thunks on the same inputs)
    run eagerly, then through ``dispatch``'s graphs: bit-equal outputs,
    one replay per call, no eager call, and the launches counted through
    the replays equal to the eager launches."""
    from blendjax_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    want = [eager() for eager, _ in calls]
    eager_counts = launch_counts()
    reset_launch_counts()
    replays0, eager0 = dispatch.graph_replays, dispatch.eager_calls
    got = [captured() for _, captured in calls]
    counts = launch_counts()
    same_outputs(label, got, want)
    replays = dispatch.graph_replays - replays0
    if replays != len(calls) or dispatch.eager_calls != eager0:
        fail(f"{label}: {replays} replays and "
             f"{dispatch.eager_calls - eager0} eager calls for {len(calls)} "
             "calls")
    if counts != eager_counts:
        fail(f"{label}: launches through replays {counts} != eager "
             f"{eager_counts}")
    log(f"dispatch parity {label}: {len(calls)} calls eager and through "
        f"{len(dispatch.signatures)} captured graph(s): every output bit-equal"
        f", launches through replays equal the eager launches "
        f"{dict((k, v) for k, v in counts.items() if v)}")
    return {"launches": counts}


def palette_groups(groups: list, card: str) -> list:
    """Full-frame palette groups (the cube producer's ``--encoding pal``)
    of the frames the packed tile ``groups`` decode to, one message per
    batch, packed on the card as the fused form packs them."""
    import numpy as np

    from blendjax_torch.data import StreamDataPipeline
    from blendjax_torch.ops import tiles as T

    msgs = []
    for g in groups:
        fields = T.decode_packed_group(g)
        for images, xy, frameid in zip(fields["image"].cpu().numpy(),
                                       fields["xy"].cpu().numpy(),
                                       fields["frameid"].cpu().numpy()):
            packed, pal, bits = T.palettize_frames(images)
            msgs.append({
                "_prebatched": True, "btid": 0, "_seq": len(msgs),
                "image" + T.FRAMEPAL_SUFFIXES[bits]: packed,
                "image" + T.PALETTE_SUFFIX: pal,
                "image" + T.FRAMESHAPE_SUFFIX: np.array(
                    [*images.shape[1:], bits], np.int32),
                "xy": xy, "frameid": frameid})
    out = list(StreamDataPipeline(iter(msgs), batch_size=BATCH, chunk=1,
                                  emit_packed=True))
    if not out or any("_pal" not in g for g in out):
        fail(f"dispatch phase: {len(out)} palette groups from "
             f"{len(msgs)} messages on {card}")
    return out


PLAN_KEYS = ("_packed", "_refs", "_spec", "_names", "_geoms", "_rle",
             "_pal")


def dispatch_phase(legs: dict, echo: dict, card: str) -> dict:
    """The decoded form's decode and the reservoir's ``sample`` eager
    against captured (``CapturedDispatch``): the decode of the legs'
    recorded groups (tile K1, tile K2, full-frame palette) and ``sample``
    with the default augmentation on the echo leg's reservoir, each
    ``DISPATCH["parity"]`` calls from the same inputs and draw counters;
    then the held-batch gate (``DISPATCH["held"]`` decoded and drawn
    batches held across ``DISPATCH["later"]`` later calls that replay the
    same graphs, then each held against its eager twin). Then card time
    (``time_ms``) and host launches per call (``launches_per_call``),
    eager and captured, at the flagship shape: a K' = 4 group of 8 frames
    (32 x 480 x 640 x 4, capacity 160) and a draw of 32 rows, and the card
    time of the copy of the outputs each call makes."""
    import numpy as np

    from blendjax_torch.data.pipeline import TileStreamDecoder

    flagship = [{k: g[k] for k in PLAN_KEYS if k in g} for g in
                (*legs["flagship"]["recorded"], *legs["flagship"]["first"])]
    square = [{k: g[k] for k in PLAN_KEYS if k in g}
              for g in legs["square"]["recorded"]]
    palette = palette_groups(flagship[:DISPATCH["parity"]], card)
    n = DISPATCH["parity"]
    out = {}
    decoder = TileStreamDecoder(device="cuda")
    dec = decoder.dispatch
    for label, groups in (("decode tile K1", flagship[:n]),
                          ("decode tile K2", square[:n]),
                          ("decode palette", palette[:n])):
        if len(groups) < n:
            fail(f"dispatch phase: {len(groups)} groups for {label}")
        out[label] = dispatch_pairs(label, dec, [
            (lambda g=g: dec.fn(g), lambda g=g: dec(g)) for g in groups])
    res = echo["reservoir"]
    rng = np.random.default_rng(11)

    def draws(k):
        return [rng.integers(0, res.size, BATCH) for _ in range(k)]

    def draw_calls(idxs):
        """``sample`` of each index vector eagerly and through its graph
        at the same draw counters."""
        c0 = res._draws
        tokens = [res.draw_token(i) for i in idxs]
        res._draws = c0
        return [(lambda t=t: res.dispatch.fn(t),
                 lambda i=i: res.sample(i)) for t, i in zip(tokens, idxs)]

    out["draw"] = dispatch_pairs("sample (default augmentation)",
                                 res.dispatch, draw_calls(draws(n)))
    # the held-batch gate: the outputs handed out stay as they were while
    # later calls replay the same graphs
    held_groups = flagship[n:n + DISPATCH["held"]]
    later_groups = flagship[n + DISPATCH["held"]:][:DISPATCH["later"]]
    if len(held_groups) < DISPATCH["held"] or not later_groups:
        fail(f"dispatch phase: {len(flagship)} flagship groups for the "
             "held-batch gate")
    want = [dec.fn(g) for g in held_groups]
    held = [dec(g) for g in held_groups]
    calls = draw_calls(draws(DISPATCH["held"]))
    want_draws = [eager() for eager, _ in calls]
    held_draws = [captured() for _, captured in calls]
    for g in later_groups:
        dec(g)
    for _, captured in draw_calls(draws(DISPATCH["later"])):
        captured()
    same_outputs("held decoded batches", held, want)
    same_outputs("held drawn batches", held_draws, want_draws)
    log(f"dispatch held-batch gate on {card}: {len(held)} decoded and "
        f"{len(held_draws)} drawn batches, each held across "
        f"{len(later_groups)} later decodes and {DISPATCH['later']} later "
        "draws replaying the same graphs, equal to their eager twins bit "
        "for bit")
    out["timed"] = dispatch_timing(dec, flagship, res, card)
    out["decode_signatures"] = len(dec.signatures)
    out["draw_signatures"] = len(res.dispatch.signatures)
    return out


def dispatch_timing(dec, groups: list, res, card: str) -> dict:
    """Card time and host launches per call of the decode of a K' = 4
    flagship group and of a K' = 1 one (the echo leg's) and of a draw of
    ``DISPATCH["draw_batch"]`` rows, eager and captured, and of the copy
    of each graph's outputs; then the eager insert's."""
    import numpy as np

    group = next((g for g in groups if int(g["_packed"].shape[0]) == CHUNK),
                 None)
    if group is None:
        fail(f"dispatch timing: no flagship group of K' = {CHUNK}")
    # its first batch alone: a packed group's rows are its batches
    one = {**group, "_packed": group["_packed"][:1]}
    idx = np.random.default_rng(12).integers(0, res.size, DISPATCH["draw_batch"])
    out = {}
    for label, what, eager, captured, dispatch, batch in (
            ("decode", "a K' = 4 group of 8 frames (32 x 480 x 640 x 4, "
             "capacity 160)", lambda: dec.fn(group), lambda: dec(group),
             dec, group),
            ("decode K'=1", "a group of 8 frames, the echo leg's",
             lambda: dec.fn(one), lambda: dec(one), dec, one),
            ("draw", f"{len(idx)} rows of the echo ring",
             lambda: res.dispatch.fn(res.draw_token(idx)),
             lambda: res.sample(idx), res.dispatch, res.draw_token(idx))):
        captured()  # captures this signature before the timing
        graph = dispatch._graphs[dispatch.signature_of(batch)]
        copy_t = time_ms(lambda g=graph: {k: v.clone()
                                          for k, v in g.outputs.items()})
        # windows of 4 calls: a draw stages its host indices through 4
        # pinned buffers, so a fifth call queued behind the sleep would
        # wait for the card and read as host time
        row = {"eager": time_ms(eager, reps=4),
               "graph": time_ms(captured, reps=4),
               "eager_launches": launches_per_call(eager),
               "graph_launches": launches_per_call(captured),
               "wrapper_host_launches": dispatch.host_launches,
               "copy_bytes": graph.copy_bytes, "copy": copy_t}
        out[label] = row
        log(f"dispatch timing {label} on {card} ({what}): eager "
            f"{spread(row['eager'])} card, host enqueue "
            f"{row['eager']['host_ms']:.4f} ms, "
            f"{row['eager_launches']['host']} host launches "
            f"{row['eager_launches']['by_api']}; graph "
            f"{spread(row['graph'])} card, host enqueue "
            f"{row['graph']['host_ms']:.4f} ms, "
            f"{row['graph_launches']['host']} host launches "
            f"{row['graph_launches']['by_api']} (the wrapper counts "
            f"{row['wrapper_host_launches']}); output copy "
            f"{graph.copy_bytes} bytes per call, {spread(copy_t)} card")
    # the insert stays eager (ROADMAP, chosen differences of PR 25): its
    # launches at the echo leg's shape, a batch of 8 rows
    rows = res.gather(np.arange(BATCH))
    out["insert"] = {"launches": launches_per_call(lambda: res.insert(rows)),
                     "time": time_ms(lambda: res.insert(rows), reps=4)}
    ins = out["insert"]
    log(f"echo insert on {card} (eager, {BATCH} rows of "
        f"{sum(v[0].numel() * v.element_size() for v in rows.values())} "
        f"bytes): {ins['launches']['host']} host launches "
        f"{ins['launches']['by_api']}, {spread(ins['time'])} card, host "
        f"enqueue {ins['time']['host_ms']:.4f} ms")
    return out


def aot_phase(group: dict) -> dict:
    """``TrainDriver.build(aot=True)`` on a decoded flagship group as one
    batch of 32 (one graph per ladder rung, captured before step 0), two
    full batches and a ragged tail of 20 rows: every loss and the final
    parameters bit-equal with the eager step (cuDNN deterministic), no
    fallback."""
    import torch

    from blendjax_torch.data import bucket_sizes
    from blendjax_torch.models import CubeRegressor
    from blendjax_torch.obs.devledger import count_flops
    from blendjax_torch.ops.tiles import decode_packed_superbatch
    from blendjax_torch.train import (
        TrainDriver,
        make_supervised_step,
        make_train_state,
    )
    from blendjax_torch.train.aot import pool_bytes

    fields = decode_packed_superbatch(
        group["_packed"], group["_refs"], group["_spec"], group["_names"],
        group["_geoms"], group["_rle"])
    full = {k: fields[k].flatten(0, 1) for k in ("image", "xy")}
    lead = int(full["image"].shape[0])
    tail = {k: v[:20] for k, v in full.items()}
    torch.backends.cudnn.deterministic = True
    try:
        model = CubeRegressor().init_params(4)
        ref = make_train_state(copy.deepcopy(model))
        drv = TrainDriver.build(model, full, aot=True, inflight=2,
                                sync_every=0)
        sets = drv.step
        eager = make_supervised_step()
        from blendjax_torch.data.batcher import pad_to_bucket

        for i, batch in enumerate((full, full, {**tail, "_partial": True})):
            drv.submit(batch)
            got = drv.drain()
            want = eager(ref, pad_to_bucket(batch) if i == 2 else batch)
            want = float(want[1]["loss"])
            if got != want:
                fail(f"aot phase: step {i} loss {got} != eager {want}"
                     f"{' (the masked tail)' if i == 2 else ''}")
        for p, q in zip(drv.state.model.parameters(), ref.model.parameters()):
            if not torch.equal(p, q):
                fail("aot phase: parameters differ from the eager step's")
    finally:
        torch.backends.cudnn.deterministic = False
    # what the ledger's one FLOP count costs a build (its first capture):
    # the eager step at the full batch under FlopCounterMode against the
    # same step alone, 3 calls each, alternating
    scratch = make_train_state(CubeRegressor().init_params(4))
    count = {"counted": [], "alone": []}
    for _ in range(3):
        for key, fn in (
                ("alone", lambda: eager(scratch, full)),
                ("counted", lambda: count_flops(lambda: eager(scratch, full),
                                                torch.device("cuda")))):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            count[key].append((time.perf_counter() - t1) * 1e3)
    count = {k: sorted(v)[1] for k, v in count.items()}
    st = drv.stats
    rungs = len(bucket_sizes(lead)) + 1
    if st["aot_fallbacks"] != 0 or st["signatures"] != rungs:
        fail(f"aot phase: {st['aot_fallbacks']} fallbacks, "
             f"{st['signatures']} graphs for {rungs} ladder signatures")
    if st["graph_replays"] != 3:
        fail(f"aot phase: {st['graph_replays']} replays for 3 steps")
    capture = {"x".join(str(d) for d in dict((k, s) for k, s, _ in sig)["image"])
               + ("+mask" if any(k == "_mask" for k, _, _ in sig) else ""):
               round(ms, 1) for sig, ms in sets.capture_ms.items()}
    # what sizing the ladder's pools costs: a memory snapshot per graph
    # (``pool_bytes`` alone) against one for the set (what the ledger's
    # ``register_aot_set`` takes)
    graphs = [g for g in sets._graphs.values() if g is not None]
    t1 = time.perf_counter()
    pools = [pool_bytes(g) for g in graphs]
    each_ms = (time.perf_counter() - t1) * 1e3
    t1 = time.perf_counter()
    segments = torch.cuda.memory_snapshot()
    once = [pool_bytes(g, segments) for g in graphs]
    once_ms = (time.perf_counter() - t1) * 1e3
    if once != pools:
        fail(f"aot phase: pools sized from one snapshot {once} != {pools}")
    out = {"startup_ms": st["startup_ms"],
           "time_to_first_step_ms": st["time_to_first_step_ms"],
           "capture_ms": capture, "pool_bytes": pools,
           "count_pass_ms": count,
           "sizing_ms": {"snapshot_each": each_ms, "one_snapshot": once_ms},
           "signatures": st["signatures"], "driver": drv, "full": full}
    log(f"aot phase: TrainDriver.build(aot=True) captured {rungs} ladder "
        f"signatures (B={lead} and buckets {bucket_sizes(lead)} with _mask) "
        f"before step 0: startup_ms {st['startup_ms']:.1f}, "
        f"time_to_first_step_ms {st['time_to_first_step_ms']:.1f}; capture "
        f"ms per signature {capture} (the first holds the ledger's one FLOP "
        f"count: eager step under FlopCounterMode {count['counted']:.1f} ms "
        f"vs alone {count['alone']:.1f} ms, median of 3); private pools "
        f"{[round(b / 2**20, 1) for b in pools]} MiB, sized in "
        f"{each_ms:.1f} ms with a memory snapshot each, {once_ms:.1f} ms "
        f"with one; 2 full steps and a "
        "ragged tail of 20 rows (bucket 32, masked) bit-equal with the eager "
        "step; aot_fallbacks 0")
    return out


# -- phase 5e: the device ledger -----------------------------------------------


def ledger_phase(aot: dict, legs: dict, card: str) -> dict:
    """The device ledger on the card (the counterpart of ``bench.py``'s
    ``measure_live_device_ledger``): the AOT ladder's cost-model FLOPs per
    image against ``measure_model_flops`` on the same model (10%); no
    retrace across the prewarmed legs, then one unprepared signature fed
    twice is exactly one retrace, attributed to it; the HBM gauges after a
    reporter tick beside the ladder's pool bytes; and the StreamFormer
    leg's ledger count against the executed-work count (its own gate)
    beside the model-FLOP figure, with ``train.mfu`` from the cost model."""
    from blendjax_torch.models import CubeRegressor
    from blendjax_torch.obs import StatsReporter, ledger, measure_model_flops
    from blendjax_torch.utils.metrics import metrics

    drv = aot["driver"]
    if ledger.retrace_count != 0:
        fail(f"ledger: {ledger.retrace_count} retraces across the prewarmed "
             f"legs: {ledger.report()['retraces']['events']}")
    entries = drv.step.ledger_entries
    hand = measure_model_flops(CubeRegressor().init_params(0), shape=SHAPE,
                               batch=BATCH, memo=False)
    ratio = drv.flops_per_image / hand["flops_per_image"]
    if drv.stats["mfu_source"] != "cost-model" or abs(ratio - 1.0) > 0.10:
        fail(f"ledger: cost-model {drv.flops_per_image} FLOPs per image "
             f"({drv.stats['mfu_source']}) vs hand-fed "
             f"{hand['flops_per_image']} (bar 10%)")
    # one signature the ladder does not hold, fed twice
    odd = {k: v[:20] for k, v in aot["full"].items()}
    for _ in range(2):
        drv.submit(dict(odd))
    drv.drain()
    events = ledger.report()["retraces"]["events"]
    want = f"({20}, {SHAPE[0]}, {SHAPE[1]}, 4)"
    if ledger.retrace_count != 1 or want not in events[0]["signature"]:
        fail(f"ledger: {ledger.retrace_count} retraces after injecting "
             f"{want} twice: {events}")
    metrics.reset()
    StatsReporter(interval_s=60).tick()
    gauges = metrics.report()["gauges"]
    mem = ledger.report()["memory"]
    if not (gauges.get("device.hbm_in_use_bytes", 0) > 0
            and gauges.get("device.hbm_headroom_frac", 0) > 0):
        fail(f"ledger: HBM gauges after a reporter tick: {gauges}")
    pools = sum(e["temp_bytes"] for e in entries)
    sf = legs["streamformer"]["ledger"]
    out = {"cost_model": drv.flops_per_image, "hand_fed": hand, "ratio": ratio,
           "retrace": events[0]["signature"], "memory": mem,
           "ladder_pool_bytes": pools, "streamformer": sf,
           "entries": len(entries)}
    log(f"ledger on {card}: CubeRegressor() ladder of {len(entries)} graphs; "
        f"cost-model {drv.flops_per_image:.6g} FLOPs per image vs hand-fed "
        f"(FlopCounterMode, eager unchunked step) "
        f"{hand['flops_per_image']:.6g}, ratio {ratio:.6f} (bar 10%); "
        f"retraces 0 across the prewarmed legs, then {want} fed twice: "
        f"exactly 1, attributed to it; after a reporter tick "
        f"device.hbm_in_use_bytes {gauges['device.hbm_in_use_bytes']} "
        f"(total - free of torch.cuda.mem_get_info: graph pools and the "
        f"allocator's reserve included; the doctor reads the headroom "
        f"fraction from it) against the caching allocator's allocated "
        f"{mem['allocated_bytes']} and reserved {mem['reserved_bytes']} "
        f"bytes, device.hbm_headroom_frac {gauges['device.hbm_headroom_frac']}"
        f", limit {mem['bytes_limit']}; the ladder's private pools "
        f"{pools} bytes in all")
    log(f"ledger streamformer on {card}: the full group's graph counts "
        f"{sf['flops_per_image'] / 1e9:.4f} GFLOP per image (of it the flash "
        f"kernels' declared work {sf['kernel_flops_per_image'] / 1e9:.4f}) "
        f"vs the executed-work count {sf['executed'] / 1e9:.4f} (bar 2%) and "
        f"the model-FLOP figure (3 x forward) "
        f"{legs['streamformer']['flops_per_image'] / 1e9:.4f}; train.mfu "
        f"from the cost model ({sf['mfu_source']}) {sf['mfu']}")
    return out


# -- phase 6: the gamma-normalize kernel ---------------------------------------


def gamma_close(got, want) -> tuple:
    """(max |diff|, within the bar): f32 1e-6 absolute; bf16 one bf16 ulp
    (non-negative values order as their bit patterns)."""
    import torch

    err = float((got.float() - want.float()).abs().max())
    if got.dtype == torch.bfloat16:
        ulps = (got.view(torch.int16).int() - want.view(torch.int16).int()).abs()
        return err, int(ulps.max()) <= 1
    return err, err <= 1e-6


def gamma_phase(bw: float, decoded) -> dict:
    """K3 against its plain version, bit for bit (every uint8 value, odd
    rows, a view at byte offset 1 that takes the element path, a decoded
    batch of the stream), then its time on that batch: over
    ``L2_ROUNDS`` copies in turn (the card time reported), and on one
    buffer again and again (L2-resident; the method of the earlier
    readings)."""
    import torch

    from blendjax_torch.kernels import gamma_normalize, gamma_normalize_plain
    from blendjax_torch.kernels.work import gamma_work

    frames, gamma_f32 = decoded
    err, ok = gamma_close(gamma_f32, gamma_normalize_plain(frames))
    if not ok:
        fail(f"K3 on a decoded echo batch: max |diff| {err} vs plain")
    gen = torch.Generator().manual_seed(5)
    odd = torch.randint(0, 256, (1 + 37 * 8 * 4,), generator=gen,
                        dtype=torch.uint8).to(frames.device)[1:]
    cases = {
        "all 256 values": torch.arange(256, dtype=torch.uint8).reshape(
            1, 4, 16, 4).to(frames.device),
        "(1, 37, 8, 4)": torch.randint(0, 256, (1, 37, 8, 4), generator=gen,
                                       dtype=torch.uint8).to(frames.device),
        "(1, 37, 8, 4) at byte offset 1": odd.view(1, 37, 8, 4),
        f"decoded {tuple(frames.shape)}": frames,
    }
    worst = 0.0
    for label, x in cases.items():
        for gamma in (2.2, 1.0):
            for dtype in (torch.float32, torch.bfloat16):
                got = gamma_normalize(x, gamma, dtype)
                want = gamma_normalize_plain(x, gamma, dtype)
                e, ok = gamma_close(got, want)
                if not (ok and torch.equal(got, want)):
                    fail(f"K3 {label} gamma {gamma} {dtype}: max |diff| {e}, "
                         "not bit-exact with plain")
                if dtype == torch.float32:
                    worst = max(worst, e)
        log(f"kernel check gamma_normalize {label}: gamma 2.2 and 1.0, f32 "
            "and bf16 bit-exact with plain")
    torch.cuda.synchronize()
    n = frames.numel()
    xs = [frames.clone() for _ in range(L2_ROUNDS)]
    kt = time_ms(rotating(gamma_normalize, xs))
    pt = time_ms(rotating(gamma_normalize_plain, xs))
    bf = time_ms(rotating(
        lambda x: gamma_normalize(x, 2.2, torch.bfloat16), xs))
    hot = time_ms(lambda: gamma_normalize(frames))
    hot_bf = time_ms(lambda: gamma_normalize(frames, 2.2, torch.bfloat16))
    # what the card reaches writing only K3's output (PyTorch's fill_, same
    # rotation, nothing read): a measured floor under the HBM bound
    floor = {}
    for key, dtype in (("f32_ms", torch.float32), ("bf16_ms", torch.bfloat16)):
        outs = [torch.empty(frames.shape, dtype=dtype, device=frames.device)
                for _ in range(L2_ROUNDS)]
        floor[key] = time_ms(rotating(lambda o: o.fill_(1.0), outs))["ms"]
    del xs, outs
    bound_ms = gamma_work(n, 4)[1] / bw * 1e3
    bf_bound = gamma_work(n, 2)[1] / bw * 1e3
    log(f"kernel gamma_normalize [decoded {tuple(frames.shape)} uint8 -> f32, "
        f"{L2_ROUNDS} buffers in turn]: {spread(kt)}, "
        f"{5 * n / kt['ms'] / 1e6:.0f} GB/s, {bound_ms / kt['ms']:.1%} of the "
        f"bound {bound_ms:.4f} ms (bytes: {n / 1e6:.2f} MB in + "
        f"{4 * n / 1e6:.2f} MB out at {bw / 1e12:.2f} TB/s); plain {spread(pt)}; "
        f"bf16 out {spread(bf)}, {bf_bound / bf['ms']:.1%} of its bound "
        f"{bf_bound:.4f} ms; one buffer again and again (L2-resident): f32 "
        f"{spread(hot)}, bf16 {spread(hot_bf)}; PyTorch fill_ of the output "
        f"alone (writes only, {L2_ROUNDS} buffers in turn): f32 "
        f"{floor['f32_ms']:.4f} ms, bf16 {floor['bf16_ms']:.4f} ms; no one-call "
        "library yardstick")
    return {"gamma_normalize": {
        "max_abs_err": worst, **kt, "plain_ms": pt["ms"],
        "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
        "bf16": {**bf, "bound_ms": bf_bound},
        "same_buffer": {"f32_ms": hot["ms"], "bf16_ms": hot_bf["ms"]},
        "output_fill": floor,
    }}


# -- phase 7: reference checks --------------------------------------------------


def reference_phase(batch) -> None:
    import torch

    from blendjax_torch.models import CubeRegressor
    from blendjax_torch.ops.tiles import decode_packed_superbatch

    args = (batch["_spec"], batch["_names"], batch["_geoms"], batch["_rle"])
    on_card = decode_packed_superbatch(batch["_packed"], batch["_refs"], *args)
    on_cpu = decode_packed_superbatch(
        batch["_packed"].cpu(), {k: v.cpu() for k, v in batch["_refs"].items()},
        *args,
    )
    for name in on_card:
        if not torch.equal(on_card[name].cpu(), on_cpu[name]):
            fail(f"recorded chunk group: field {name!r} differs card vs CPU")
    img = on_card["image"]
    log(f"reference: recorded chunk group {tuple(img.shape)} decodes "
        "bit-exact on the card vs the CPU twins")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = CubeRegressor(dtype=torch.float32).init_params(7)
    x = img[0, :4].contiguous()
    with torch.no_grad():
        ref = model(x.cpu())
        got = model.cuda()(x).cpu()
    if got.shape != (4, 8, 2) or not torch.isfinite(got).all():
        fail(f"model output {tuple(got.shape)} not finite (4, 8, 2)")
    if not torch.allclose(got, ref, rtol=1e-4, atol=1e-4):
        fail(f"f32 forward card vs CPU: max diff {(got - ref).abs().max()}")
    log("reference: f32 CubeRegressor forward on the card matches the CPU "
        f"(max abs diff {float((got - ref).abs().max()):.3g}, tol 1e-4)")

    # the full-width StreamFormer in f32: the f32 flash kernel on the card,
    # the kernels' plain versions on the CPU
    from blendjax_torch.models import StreamFormer

    from blendjax_torch.kernels import flash_attention_fwd

    former = StreamFormer(**FORMER, dtype=torch.float32, attn_backend="flash",
                          image_shape=SHAPE).init_params(7)
    x = img[0, :2].contiguous()
    before = dict(flash_attention_fwd.launches_by_variant)
    with torch.no_grad():
        ref = former(x.cpu())
        got = former.cuda()(x).cpu()
    after = flash_attention_fwd.launches_by_variant
    if (after["simple"] - before["simple"] != FORMER["depth"]
            or after["sm90"] != before["sm90"]):
        fail(f"f32 StreamFormer forward: forward variants {before} -> "
             f"{after}, not {FORMER['depth']} simple launches")
    if got.shape != (2, FORMER["num_outputs"]) or not torch.isfinite(got).all():
        fail(f"StreamFormer output {tuple(got.shape)} not finite (2, 16)")
    if not torch.allclose(got, ref, rtol=1e-4, atol=1e-5):
        fail(f"f32 StreamFormer card vs CPU: max diff {(got - ref).abs().max()}")
    log("reference: f32 StreamFormer forward (the simple f32 flash forward, "
        f"{FORMER['depth']} launches; f32 never takes the sm90 variant) on the "
        "card matches the CPU plain path (max abs diff "
        f"{float((got - ref).abs().max()):.3g}, rtol 1e-4, atol 1e-5)")


def startup_probe(builds: int) -> None:
    """``python3 chip_smoke.py --startup N``: ``N`` times
    ``TrainDriver.build(CubeRegressor(), batch, rng=0, aot=True)`` on one
    seeded random batch of 32 RGBA 480x640 frames, in one fresh process
    after one eager warm-up step: each build's ``startup_ms``, its capture
    ms per ladder signature and their sum. The start-up of the library
    alone, apart from what the smoke's legs leave in the caching
    allocator; a copy of this file in a checkout of another tree measures
    that tree's package (the script's own directory comes first on
    ``sys.path``)."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    from blendjax_torch.models import CubeRegressor
    from blendjax_torch.train import (
        TrainDriver,
        make_supervised_step,
        make_train_state,
    )

    h, w = SHAPE
    n = BATCH * CHUNK
    gen = torch.Generator().manual_seed(0)
    batch = {
        "image": torch.randint(0, 256, (n, h, w, 4), dtype=torch.uint8,
                               generator=gen).cuda(),
        "xy": (torch.rand((n, 8, 2), generator=gen) * w).cuda(),
    }
    warm = make_train_state(CubeRegressor().init_params(1))
    make_supervised_step()(warm, batch)
    torch.cuda.synchronize()
    del warm
    runs = []
    for i in range(builds):
        drv = TrainDriver.build(CubeRegressor(), batch, rng=0, aot=True,
                                sync_every=0)
        captures = [round(ms, 1) for ms in drv.step.capture_ms.values()]
        runs.append({"startup_ms": round(drv.stats["startup_ms"], 1),
                     "capture_ms": captures,
                     "capture_sum_ms": round(sum(captures), 1)})
        log(f"startup probe build {i}: startup_ms {runs[-1]['startup_ms']}, "
            f"capture ms per signature {captures} (sum "
            f"{runs[-1]['capture_sum_ms']})")
        del drv
        torch.cuda.synchronize()
    print(json.dumps({"startup_probe": runs}), flush=True)


def main() -> None:
    # cuBLAS is deterministic only with a fixed workspace; it is read when
    # the first handle is made, so it is set before any CUDA work (the
    # resume phase runs under deterministic algorithms)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    import blendjax_torch  # noqa: F401  (fails outside a checkout of the repo)
    from blendjax_torch.kernels import KERNELS
    from blendjax_torch.kernels.build import build
    from blendjax_torch.models import CubeRegressor
    from blendjax_torch.train import make_train_state

    # phase 1: device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    bw = hbm_rate(kind)
    card = f"{kind}, power limit {smi.split(',')[-1].strip()}"
    log(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    host = host_report()
    log(f"host: os.cpu_count() {host['cpu_count']}, "
        f"len(os.sched_getaffinity(0)) {host['affinity']}, /dev/shm free "
        f"{host['dev_shm_free']} of {host['dev_shm_total']} bytes")

    # phase 2: build
    t0 = time.perf_counter()
    logs = build()
    log(f"build: {len(logs)} kernels in {time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "smem", "spill", "C75")):
                log(f"build {name}: {line.strip()}")
    for name in ("flash_fwd_sm90", "flash_bwd_sm90"):
        sass = sass_counts(name, ("HGMMA", "UTMALDG"))
        log(f"build {name}: SASS holds {sass['HGMMA']} HGMMA (wgmma) and "
            f"{sass['UTMALDG']} UTMALDG (TMA load) instructions")
        if not all(sass.values()):
            fail(f"{name}'s SASS lacks wgmma or TMA loads: {sass}")

    # phase 3: decode kernels
    measured = kernel_phase(bw)

    # phase 4: the slice
    torch.manual_seed(0)
    state = make_train_state(CubeRegressor().init_params(0))
    with tempfile.TemporaryDirectory() as tmp:
        recording = os.path.join(tmp, "flagship-rec")
        legs = {
            "flagship": run_leg("flagship (16,32) leg", FLAGSHIP, state, tmp,
                                record=recording,
                                keep_first=REPLAY["compare"],
                                obs=os.path.join(tmp, "obs-flagship"),
                                audit=True, census=True),
            "square": run_leg("square 16x16 leg", SQUARE, state, tmp),
            "streamformer": streamformer_leg(tmp, card),
        }
        obs_gates("flagship (16,32) leg", legs["flagship"], 2)
        echo = echo_leg(tmp)
        # phase 5c: the input side, after the earlier legs
        t0 = time.perf_counter()
        ingest = ingest_phase(tmp, card, legs["flagship"])
        equality = equality_leg(card)
        log(f"input side: ingest A/B, shm, ndz and equality legs in "
            f"{time.perf_counter() - t0:.1f} s")
        # phase 5d: the palette producer, replay and resume
        t0 = time.perf_counter()
        palette_phase(legs["flagship"], card)
        replay = replay_leg(recording, legs["flagship"], card)
        resume_phase(recording, tmp, card)
        log(f"palette producer, replay and resume phases in "
            f"{time.perf_counter() - t0:.1f} s")
        # phase 5f: the launched, gym and duplex legs
        t0 = time.perf_counter()
        launched = launched_leg(tmp, card)
        gym = gym_leg(tmp, card)
        duplex = duplex_leg(tmp, card)
        fake_blender_leg(tmp, card)
        log(f"launched, gym, duplex and fake-Blender legs in "
            f"{time.perf_counter() - t0:.1f} s")
        # phase 5g: the mesh phase (NCCL, world size 1)
        t0 = time.perf_counter()
        mesh = mesh_phase(tmp, recording, legs["flagship"], card)
        log(f"mesh phase in {time.perf_counter() - t0:.1f} s")
        # phase 5g's two-rank leg: two processes on the card, gloo
        t0 = time.perf_counter()
        two_rank = two_rank_phase(tmp, card)
        log(f"two-rank leg in {time.perf_counter() - t0:.1f} s")
        # phase 5h: mixture of experts and remat (the pipeline leg ran in
        # the mesh phase, on its NCCL group)
        t0 = time.perf_counter()
        moe = moe_leg(tmp, legs["streamformer"], card)
        remat = remat_leg(legs["streamformer"], card)
        log(f"phase 5h: moe and remat legs in {time.perf_counter() - t0:.1f} "
            "s")
        # phase 5i: RL
        t0 = time.perf_counter()
        rl = rl_phase(tmp, card)
        log(f"phase 5i: rl phase in {time.perf_counter() - t0:.1f} s; best "
            f"mean return {rl['best_return']:.2f} (floor {RL_RETURN_FLOOR})")
        # phase 5j: scoring, the scenario loop and the elastic fleet
        phase_5j(card)
    ab = {w: [r["img_s"] for r in ingest["runs"] if r["ingest_workers"] == w]
          for w in sorted(set(INGEST["order"]))}
    log(f"ingest A/B on {card}: live img/s with four producers, by ingest "
        f"workers (runs in the order {INGEST['order']}): "
        + "; ".join(f"{w}: {v}" for w, v in ab.items())
        + "; producers' own frames/s summed: "
        + str([round(r["producers"].get("own_frames_s", 0.0), 1)
               for r in ingest["runs"]])
        + "; step alone through the graph img/s: "
        + str([round(r["graph_alone_img_s"], 1) for r in ingest["runs"]]))
    if legs["flagship"]["launches"]["decode_spatial"] <= 0:
        fail("flagship leg never launched decode_spatial (K1)")
    if legs["square"]["launches"]["decode_scatter"] <= 0:
        fail("square leg never launched decode_scatter (K2)")
    for name, leg in legs.items():
        if leg["dispatch_per_step"] != 1.0:
            fail(f"{name} leg: {leg['dispatch_per_step']} step calls per "
                 "chunk group")
        log(
            f"slice {name}: {leg['img_s']:.1f} img/s over {leg['images']} "
            f"images ({leg['wall_s']:.2f} s) on {card}; "
            f"dispatches/step {leg['dispatch_per_step']:.2f}; step alone "
            f"{leg['step_alone_ms']:.2f} ms/chunk group "
            f"({leg['step_alone_img_s']:.1f} img/s) eager, "
            f"{leg['graph_alone_ms']:.2f} ms ({leg['graph_alone_img_s']:.1f} "
            f"img/s) through its graph, of which decode "
            f"{leg['decode_ms']:.3f} ms; launches (through replays) "
            f"{leg['launches']}; graphs captured in the measured window "
            f"{leg['captures_in_window']}; seq_gaps {leg['seq_gaps']}; driver "
            f"{leg['driver']}; final loss {leg['losses'][-1]:.5f}"
        )
        log(f"slice {name} {producer_text(leg['producers'])}; live "
            f"{leg['img_s']:.1f} img/s through the graph; step alone "
            f"{leg['step_alone_img_s']:.1f} img/s eager, "
            f"{leg['graph_alone_img_s']:.1f} img/s graph")
        prof = leg["profile"]
        log(
            f"slice {name} profile of one step call: wall "
            f"{prof['wall_ms']:.2f} ms, device busy {prof['device_ms']:.2f} ms "
            f"({prof['busy']:.1%}) over {prof['kernels']} kernels; by group: "
            + ", ".join(f"{g} {ms:.2f} ms" for g, ms in prof["groups"].items())
        )
    sf = legs["streamformer"]
    eager, graph = sf["alone"]["profile"], sf["alone"]["graph_profile"]
    log(f"slice streamformer kernel groups of one eager step call (the graph "
        f"launches the same kernels; torch.profiler through the guarded "
        f"trace): "
        + ", ".join(f"{g} {ms:.3f} ms" for g, ms in eager["groups"].items())
        + f"; sum {sum(eager['groups'].values()):.3f} ms of device time "
        f"beside the graph replay's {graph['device_ms']:.3f} ms "
        f"({graph['source']}) and the eager call's wall "
        f"{eager['wall_ms']:.3f} ms, on {card}; the replay's own groups "
        + (", ".join(f"{g} {ms:.3f} ms" for g, ms in graph["groups"].items())
           if graph["groups"] else "not recorded (events only)"))
    log("verdicts: " + "; ".join(
        f"{name}: {leg['verdict']}" for name, leg in
        (*legs.items(), ("echo", echo), ("replay", replay),
         ("launched", launched))))
    log(f"control on {card}: launched leg live {launched['img_s']:.1f} img/s "
        f"against its producers' own {launched['own_frames_s']:.1f} "
        f"frames/s, respawn restart {launched['restart_s']:.2f} s after the "
        f"kill, the respawn=False error {launched['raise_s']:.2f} s after it;"
        f" gym {gym['steps_s']:.1f} steps/s, round trip p50 "
        f"{gym['p50_ms']:.4f} / p99 {gym['p99_ms']:.4f} ms; duplex round trip"
        f" p50 {duplex['p50_ms']:.4f} / p99 {duplex['p99_ms']:.4f} ms")
    log(f"slice streamformer: {sf['flops_per_image'] / 1e9:.2f} GFLOP per "
        "image (fwd+bwd = 3 x fwd; dense 2*fan_in*fan_out per token, "
        "attention 4*T^2*dim per block); step alone "
        f"{sf['step_alone_img_s'] * sf['flops_per_image'] / 1e12:.1f} TFLOP/s "
        f"= {sf['step_alone_img_s'] * sf['flops_per_image'] / PEAK_BF16_FLOPS:.2%}"
        f" of 989 TFLOP/s, live {sf['img_s'] * sf['flops_per_image'] / PEAK_BF16_FLOPS:.2%}"
        f", on {card}")

    ep = echo["profile"]
    log(f"slice echo: {echo['img_s']:.1f} img/s into the step over "
        f"{ECHO['steps']} steps ({echo['wall_s']:.2f} s) on {card}; fresh "
        f"frames {echo['fresh_img_s']:.1f} img/s; drain thread busy "
        f"{echo['drain_busy_s']:.3f} s of CPU over the {echo['wall_s']:.3f} s "
        f"window ({echo['drain_busy_s'] / echo['wall_s']:.1%} of one core); "
        f"unique fraction "
        f"{echo['unique_fraction']:.4f}; stats {echo['stats']}; decoded fresh "
        f"batches {echo['decoded_batches']}; launches {echo['launches']}; "
        f"seq_gaps {echo['seq_gaps']}; dispatches/step "
        f"{echo['dispatch_per_step']:.2f}; decodes {echo['decode_replays']} "
        f"replays of {echo['decode_graphs']} captured graph(s), no eager "
        f"decode; driver {echo['driver']}; echo step "
        f"alone {echo['step_alone_ms']:.2f} ms ({echo['step_alone_img_s']:.1f} "
        f"img/s) eager, {echo['graph_alone_ms']:.2f} ms "
        f"({echo['graph_alone_img_s']:.1f} img/s) through its graph; graphs "
        f"captured in the measured window {echo['captures_in_window']}; "
        f"final loss {echo['losses'][-1]:.5f}")
    log(f"slice echo {producer_text(echo['producers'])}; fresh "
        f"{echo['fresh_img_s']:.1f} img/s, live {echo['img_s']:.1f} img/s "
        f"into the step through the graph; step alone "
        f"{echo['step_alone_img_s']:.1f} img/s eager, "
        f"{echo['graph_alone_img_s']:.1f} img/s graph")
    log(f"slice echo profile of one step call: wall {ep['wall_ms']:.2f} ms, "
        f"device busy {ep['device_ms']:.2f} ms ({ep['busy']:.1%}) over "
        f"{ep['kernels']} kernels; by group: "
        + ", ".join(f"{g} {ms:.2f} ms" for g, ms in ep["groups"].items()))

    # phase 5b: every step builder eager against its graph, then the
    # supervised AOT set of TrainDriver.build
    t0 = time.perf_counter()
    # the lengths alone: the results hold each leg's wrapper, graphs and
    # state, whose memory the later phases must not carry
    parity = len(graph_parity_phase(legs, echo))
    plain_augment_phase(legs, card)
    dispatches = dispatch_phase(legs, echo, card)
    aot = aot_phase(next(
        g for g in (*legs["flagship"]["recorded"], *legs["flagship"]["first"])
        if int(g["_packed"].shape[0]) == CHUNK))
    log(f"graphs: parity of {parity} step builders and of their "
        f"plain-augment twins, of the decoded "
        f"form's decode ({dispatches['decode_signatures']} graphs) and the "
        f"reservoir's draw ({dispatches['draw_signatures']}), and the AOT "
        f"set in {time.perf_counter() - t0:.1f} s")

    # phase 5e: the device ledger
    ledger_phase(aot, legs, card)

    # phase 6: the gamma-normalize kernel, on a decoded batch of the stream
    measured.update(gamma_phase(bw, echo["gamma_last"]))

    # phase 3b: the flash-attention kernels, after the legs: run before
    # them, this phase cost the producer-bound flagship leg 5-10% of its
    # live img/s against the parent's order (PERF.md), for no known reason
    t0 = time.perf_counter()
    measured.update(attention_phase(bw))
    log(f"kernels: flash attention checked and timed in "
        f"{time.perf_counter() - t0:.1f} s")

    # phase 7: reference checks
    reference_phase(legs["flagship"]["last"])

    # phase 5k: the examples, last: their steps capture signatures nobody
    # prepared, which the device ledger counts as retraces (phase 5e gates
    # on none across the prewarmed legs)
    with tempfile.TemporaryDirectory() as tmp:
        examples = phase_5k(tmp, card)

    legs["echo"] = echo
    leg_of = {"decode_spatial": "flagship", "decode_scatter": "square",
              "gamma_normalize": "echo"}
    rows = []
    for name, meta in KERNELS.items():
        m = measured[name]
        launches = legs[leg_of.get(name, "streamformer")]["launches"][name]
        if name == "decode_spatial":
            # input side, replay, launched, mesh, and the MoE leg's stream
            launches += (ingest["k1_launches"]
                         + replay["launches"]["decode_spatial"]
                         + launched["launches"]["decode_spatial"]
                         + mesh["flagship"]["launches"]["decode_spatial"]
                         + two_rank["launches"].get(name, 0)
                         + moe["launches"][name]
                         + examples["launches"][name]
                         + sum(mesh["sp"][run]["launches"][name] for run in
                               ("ulysses_aot", "ring_aot", "plain_aot")))
        elif name.startswith("flash_attention"):
            # the Ulysses legs (eager and captured) and the captured
            # non-mesh run beside them, the two-rank leg's ranks, the MoE
            # and remat legs, the pipeline stage
            launches += (mesh["sp"]["ulysses"]["launches"][name]
                         + mesh["sp"]["ulysses_aot"]["launches"][name]
                         + mesh["sp"]["plain_aot"]["launches"][name]
                         + moe["launches"][name] + remat["launches"][name]
                         + mesh["pipeline"]["launches"][name]
                         + two_rank["launches"].get(name, 0)
                         + examples["launches"][name])
        rows.append({
            "name": name, "route": meta["route"], "source": meta["source"],
            "replaces": meta["replaces"],
            "launches": launches,
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "min_ms": m["min_ms"], "max_ms": m["max_ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            **({"variants": legs["streamformer"]["variants"][name]}
               if name in legs["streamformer"]["variants"] else {}),
            **({"long": m["long"]} if "long" in m else {}),
            **{k: m[k] for k in ("bf16", "same_buffer", "output_fill")
               if k in m},
        })
    census_gate(legs["flagship"]["census"], echo["census"],
                rl["prioritized"]["census"])
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--startup"]:
        startup_probe(int(sys.argv[2]) if len(sys.argv) > 2 else 5)
    elif sys.argv[1:2] == ["--two-rank"]:
        two_rank_child(int(sys.argv[2]), sys.argv[3])
    elif sys.argv[1:2] == ["--gloo-probe"]:
        gloo_probe_child(sys.argv[2], int(sys.argv[3]), sys.argv[4])
    elif sys.argv[1:2] == ["--two-rank-phase"]:
        two_rank_alone()
    else:
        main()
