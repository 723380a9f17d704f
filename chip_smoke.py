#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py

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
   driver step, the ring's ``data_ptr()``s never move, and K1 and K3 each
   launched once per decoded fresh batch (on the drain thread, outside the
   step's graph), one graph replay per step and no fallback; it prints
   live img/s into the step, the fresh frame rate and the unique fraction,
   and the step alone eager and through its graph;
5b. graphs: each step builder of the slice (fused tile with K1, fused
   tile with K2, the streamformer fused step with K1 and K4a-c, echo) runs
   4 steps eagerly and 4 through ``CapturedStep`` from one state on the
   legs' last recorded chunk groups (draw tokens for echo), cuDNN
   deterministic: losses and every parameter must be bit-equal, and the
   launches counted through replays equal the eager ones. Then
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
   shards. Every run fails unless seq_gaps == 0 and restarts == 0, one step
   call and one replay per driver step, no graph captured in the measured
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

The last lines of standard output are the kernels JSON object and the
device JSON object ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
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
# steps of each step builder run eagerly and through its graph from one
# state in the graph-parity phase
PARITY_STEPS = 4
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
    moved = n * ttc + idx.numel() * 4 + valid * ttc + got.numel()
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
    moved = n * ttc + idx.numel() * 4 + valid * ttc + got.numel()
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


def attn_work(b, tq, tk, h, d, elem):
    """{kernel: (FLOPs, bytes)} of a non-causal call: FLOPs 4/8/6 *
    B*H*Tq*Tk*D; bytes each input read once and each output written once
    (lse and di are f32 (B, H, Tq))."""
    qb, kb, stat = b * tq * h * d * elem, b * tk * h * d * elem, b * h * tq * 4
    mnk = b * h * tq * tk * d
    return {
        "flash_attention_fwd": (4 * mnk, qb + 2 * kb + qb + stat),
        "flash_attention_bwd_dkv": (8 * mnk, 2 * qb + 2 * kb + 2 * stat + 2 * kb),
        "flash_attention_bwd_dq": (6 * mnk, 2 * qb + 2 * kb + 2 * stat + qb),
    }


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
        work = attn_work(b, t, t, h, d, 2)
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
    """One step call under ``torch.profiler``: the wall time, the device
    time summed over every CUDA kernel (its busy share of the wall) and
    that time by kernel group, largest first. For a graph replay
    (``graph=True``) whose kernels the profiler does not record, the
    device time is read from CUDA events around a second call instead
    (``source``: "profiler" or "events"; events time the stream from the
    replay's first kernel to its last, gaps included)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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

    def __call__(self, state, batch):
        state, m = self.inner(state, batch)
        if len(self.seen) < self.keep:
            self.seen.append(m["loss"])
        return state, m

    def values(self) -> list:
        """Every kept loss as floats, the chunk's updates in order."""
        return [x for v in self.seen for x in v.float().reshape(-1).tolist()]


def run_leg(label: str, leg: dict, state, tmp: str, loss_fn=None,
            producers: int = 2, wire: str = "raw", ingest_workers: int = 1,
            inflate_workers: int = 2, graph_step=None,
            alone: bool = True, record: str | None = None,
            keep_first: int = 0) -> dict:
    """One producer leg through the captured fused step (one CUDA graph per
    packed plan); keeps the last ``PARITY_STEPS`` chunk groups for the
    graph-parity phase. ``producers`` cube producers publish on ``wire``
    into ``StreamDataPipeline(emit_packed=True, ingest_workers=...,
    inflate_workers=...)``. A ``graph_step`` (with its ``state``) may be
    shared between legs, so only the first captures. ``alone=False`` times
    only the graph step alone on the last group (no eager run, no profile).
    ``record`` tees the first ``REPLAY["record"]`` messages received to
    ``{record}_00.bjr``; ``keep_first`` keeps copies of the first groups
    and their loss tensors (``first``)."""
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

    if graph_step is None:
        graph_step = CapturedStep(make_fused_tile_step(loss_fn))
    if not graph_step.signatures:
        prewarm(graph_step, state, leg)
    procs, addrs, logs = start_producers(tmp, leg["tile"], leg["capacity"],
                                         count=producers, wire=wire)
    rec = ({"record_path_prefix": record,
            "record_max_messages": REPLAY["record"]} if record else {})
    pipe = StreamDataPipeline(
        addrs, batch_size=BATCH, chunk=CHUNK, emit_packed=True,
        timeoutms=60_000, ingest_workers=ingest_workers,
        inflate_workers=inflate_workers,
        on_timeout=producer_watch(label, procs, logs), **rec,
    )
    step = graph_step.step
    replays0 = graph_step.graph_replays
    tap = _FirstLosses(graph_step, keep_first)
    drv = TrainDriver(tap, state, inflight=2, sync_every=4)
    total = leg["warmup"] + leg["steps"]
    images = 0
    updates = 0  # optimizer updates submitted: the chunk sizes summed
    short = 0  # step calls on a group of fewer than CHUNK batches
    recorded = collections.deque(maxlen=PARITY_STEPS)
    first = []
    t0 = None
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
            elif drv.steps > leg["warmup"]:
                images += k * BATCH
            if drv.steps >= total:
                break
        drv.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        variants = variant_counts()
        gaps, restarts = pipe.seq_gaps, pipe.restarts
    finally:
        pipe.stop()
        stop_producers(procs)
        segments = reap_segments(logs)
    shards = pipe.shard_stats()
    producers_rep = producer_report(label, logs)
    losses = drv.losses  # drain() appended the final loss
    if not all(math.isfinite(v) for v in losses):
        fail(f"{label}: non-finite loss in {losses}")
    if gaps or restarts:
        fail(f"{label}: {gaps} sequence gaps, {restarts} restarts")
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
        "ingest_workers": ingest_workers,
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
    leg = run_leg("streamformer leg", STREAMFORMER, state, tmp, former_loss)
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
    from blendjax_torch.train import (
        CapturedStep,
        TrainDriver,
        make_echo_fused_step,
        make_train_state,
    )

    state = make_train_state(CubeRegressor().init_params(0))
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
    try:
        reset_launch_counts()
        for token in echo:
            drv.submit(token)
            if drv.steps == ECHO["warmup"]:
                drv.drain()
                t0 = time.perf_counter()
                s0 = dict(echo.stats)
                ptrs0 = echo.reservoir.data_ptrs()
                sigs0 = len(graph_step.signatures)
            if drv.steps >= total:
                break
        if drv.steps < total:
            fail(f"echo leg: the stream ended after {drv.steps} steps")
        drv.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s1 = dict(echo.stats)
        ptrs1 = echo.reservoir.data_ptrs()
        echo.stop()  # joins the drain thread: no decode runs after this
        counts = launch_counts()
        gaps = pipe.seq_gaps
    finally:
        echo.stop()
        stop_producers(procs)
    producers = producer_report("echo leg", logs)
    losses = drv.losses
    decoded = tap.batches
    checks = [
        (s1["fresh"] + s1["echoed"] == drv.steps * BATCH,
         f"fresh {s1['fresh']} + echoed {s1['echoed']} != steps "
         f"{drv.steps} x batch {BATCH}"),
        (s1["echoed"] > 0, "nothing was echoed"),
        (s1["max_uses"] <= ECHO["max_echo_factor"],
         f"a sample was drawn {s1['max_uses']} times"),
        (gaps == 0, f"{gaps} sequence gaps"),
        (all(math.isfinite(v) for v in losses), f"non-finite loss in {losses}"),
        (calls[0] == drv.steps == drv.dispatches,
         f"{calls[0]} step calls for {drv.steps} driver steps"),
        (ptrs0 == ptrs1, f"the ring moved: {ptrs0} -> {ptrs1}"),
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
    ]
    for ok, what in checks:
        if not ok:
            fail(f"echo leg: {what}")
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
        "alone": alone, "profile": alone["profile"],
        "gamma_last": tap.last, "producers": producers,
        "reservoir": echo.reservoir, "tokens": tokens,
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


def palette_phase(leg: dict, card: str) -> dict:
    """The flagship leg's producers took the fused per-frame palette path
    (``producer_report`` failed the leg otherwise): print each one's
    message bytes per 8 frames and its own frames/s beside the leg's live
    img/s, and hold the frames of the leg's first two chunk groups,
    decoded on the card, against the frames the producers rendered (the
    same scenes rendered here on the host C++ path), bit for bit."""
    import numpy as np

    from blendjax_torch.ops.tiles import decode_packed_superbatch
    from blendjax_torch.producer import CubeScene

    rep = leg["producers"]
    per8 = [s["msg_bytes"] * 8 / s["frames_per_msg"] for s in rep["producers"]]
    want: dict = {}  # (btid, frameid) -> decoded frame on the host
    for g in leg["first"][:2]:
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
        scene = CubeScene(shape=SHAPE, seed=btid)  # the producer's --seed
        last = max(f for b, f in want if b == btid)
        for f in range(1, last + 1):
            scene.step(f)
            scene.render(out=buf)
            got = want.get((btid, f))
            if got is not None:
                if not np.array_equal(got, buf):
                    fail(f"palette phase: producer {btid} frame {f} decoded "
                         "on the card differs from its render")
                checked += 1
    if checked < 8:
        fail(f"palette phase: only {checked} frames checked")
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
    last = batch
    graph_ms = alone_ms(lambda: graph_step(state, last), 20)
    alone_img_s = int(last["_packed"].shape[0]) * BATCH / graph_ms * 1e3
    out = {"img_s": images / wall, "wall_s": wall, "steps": drv.steps,
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
      loss must equal B's.

    Then two more drivers time ``RESUME["window"]`` steps each, without
    and with ``checkpoint_every`` (order plain, snapshots, snapshots,
    plain). Prints the snapshot's bytes, the writer's ms per snapshot, the
    snapshots skipped under backpressure, ms per step with and without
    snapshots, and B's time to its first step."""
    import torch

    from blendjax_torch.checkpoint import SnapshotManager
    from blendjax_torch.data import StreamDataPipeline
    from blendjax_torch.models import CubeRegressor
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
        ptrs = [p.data_ptr() for p in c.state.model.parameters()]
        load_train_state_leaves(c.state, restored.state)
        c.load_state_dict(restored.session["driver"])
        if [p.data_ptr() for p in c.state.model.parameters()] != ptrs:
            fail("resume phase: the in-place restore moved a parameter")
        c_loss = _submit_all(c, batches[n:n + 1])[0]
        c.drain()
        torch.cuda.synchronize()
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


# -- phase 5b: graph parity and the supervised AOT set ---------------------------


def eager_against_graph(label: str, make_step, make_state, batches) -> dict:
    """``make_step()`` run ``len(batches)`` times eagerly on one state and
    through ``CapturedStep(make_step())`` on another made the same way:
    losses and every parameter must be bit-equal, and the launches the
    replays add must equal the eager launches."""
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
        f"replays equal the eager launches {dict((k, v) for k, v in graph_counts.items() if v)}")
    return {"steps": len(batches), "losses": [float(x.reshape(-1)[-1]) for x in la]}


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


def aot_phase(group: dict) -> dict:
    """``TrainDriver.build(aot=True)`` on a decoded flagship group as one
    batch of 32 (one graph per ladder rung, captured before step 0), two
    full batches and a ragged tail of 20 rows: every loss and the final
    parameters bit-equal with the eager step (cuDNN deterministic), no
    fallback."""
    import torch

    from blendjax_torch.data import bucket_sizes
    from blendjax_torch.models import CubeRegressor
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
    pools = [pool_bytes(g) for g in sets._graphs.values() if g is not None]
    out = {"startup_ms": st["startup_ms"],
           "time_to_first_step_ms": st["time_to_first_step_ms"],
           "capture_ms": capture, "pool_bytes": pools,
           "signatures": st["signatures"]}
    log(f"aot phase: TrainDriver.build(aot=True) captured {rungs} ladder "
        f"signatures (B={lead} and buckets {bucket_sizes(lead)} with _mask) "
        f"before step 0: startup_ms {st['startup_ms']:.1f}, "
        f"time_to_first_step_ms {st['time_to_first_step_ms']:.1f}; capture "
        f"ms per signature {capture}; private pools "
        f"{[round(b / 2**20, 1) for b in pools]} MiB; 2 full steps and a "
        "ragged tail of 20 rows (bucket 32, masked) bit-equal with the eager "
        "step; aot_fallbacks 0")
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
    bound_ms = (n + 4 * n) / bw * 1e3
    bf_bound = 3 * n / bw * 1e3
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
                                keep_first=REPLAY["compare"]),
            "square": run_leg("square 16x16 leg", SQUARE, state, tmp),
            "streamformer": streamformer_leg(tmp, card),
        }
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
        f"{echo['dispatch_per_step']:.2f}; driver {echo['driver']}; echo step "
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
    parity = graph_parity_phase(legs, echo)
    aot = aot_phase(next(
        g for g in (*legs["flagship"]["recorded"], *legs["flagship"]["first"])
        if int(g["_packed"].shape[0]) == CHUNK))
    log(f"graphs: parity of {len(parity)} step builders and the AOT set in "
        f"{time.perf_counter() - t0:.1f} s")

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

    legs["echo"] = echo
    leg_of = {"decode_spatial": "flagship", "decode_scatter": "square",
              "gamma_normalize": "echo"}
    rows = []
    for name, meta in KERNELS.items():
        m = measured[name]
        launches = legs[leg_of.get(name, "streamformer")]["launches"][name]
        if name == "decode_spatial":  # the input side and replay launch K1
            launches += (ingest["k1_launches"]
                         + replay["launches"]["decode_spatial"])
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
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
