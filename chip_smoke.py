#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. device: the card's name and power limit (``nvidia-smi``); no CUDA
   device -> exit 1 before anything else;
2. build: compile every decode kernel from ``blendjax_torch/kernels/csrc``
   (one ``nvcc`` per source, started together) and print the build time;
3. kernels: each kernel against its plain PyTorch twin, bit-exact
   (``torch.equal``), at the main path's shapes and at the edge cases
   (``Ct < C``, ``K == 0``, a row of sentinels, byte-wide geometries),
   then its median time over many launches, the twin's time, a one-call
   PyTorch yardstick where one exists, and the bytes bound;
4. slice: two cube producers (480x640 RGBA, (16, 32) tiles, capacity
   160, batch 8) -> ``StreamDataPipeline(emit_packed=True, chunk=4)`` ->
   ``make_fused_tile_step`` on the full-width ``CubeRegressor()``
   (bf16-compute) -> ``TrainDriver(inflight=2)``; then a shorter leg of
   square 16x16 tiles (capacity 288). Launch counts are zeroed just
   before each leg and read just after: the flagship leg must launch K1
   and the square leg K2; losses must be finite with zero sequence gaps;
5. reference: one recorded chunk group decoded on the card against the
   CPU twins (bit-exact), and the f32 model forward on the card against
   the CPU (TF32 off, rtol 1e-4).

The last lines of standard output are the kernels JSON object and the
device JSON object ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
FLAGSHIP = {"tile": (16, 32), "capacity": 160, "steps": 24, "warmup": 4}
SQUARE = {"tile": (16,), "capacity": 288, "steps": 6, "warmup": 1}
# Device-memory rates for the bytes bound (NVIDIA data sheets); an
# unlisted H100 name takes the SXM part's 3.35 TB/s.
HBM_BYTES_PER_S = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12),
                   ("H200", 4.8e12), ("H100", 3.35e12))


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


def time_ms(fn, reps: int = 20, windows: int = 15) -> float:
    """Median per-call time (CUDA events) over ``windows`` windows of
    ``reps`` back-to-back calls, after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    samples.sort()
    return samples[len(samples) // 2]


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
        "ms": time_ms(lambda: decode_spatial(ref, idx, tiles, (h, w, 4))),
        "plain_ms": time_ms(
            lambda: decode_spatial_plain(ref, idx, tiles, (h, w, 4)), reps=5
        ),
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
    out["decode_scatter"] = {
        "max_abs_err": int((got.int() - want.int()).abs().max()),
        "ms": time_ms(lambda: decode_scatter(ref, idx, tiles)),
        "plain_ms": time_ms(
            lambda: decode_scatter_plain(ref, idx, tiles), reps=5
        ),
        "bound_ms": moved / bw * 1e3, "bound_by": "bytes",
        # one call writing the changed tiles into initialised slots
        "library_ms": time_ms(
            lambda: slots.index_copy_(0, flat_idx, changed)
        ),
        "library_call": "Tensor.index_copy_ of the changed tiles "
                        "(slot initialisation excluded)",
        "shapes": f"B={b} K=288 16x16x4 at {h}x{w}, {valid} changed tiles",
    }
    torch.cuda.synchronize()
    for name, m in out.items():
        log(
            f"kernel {name}: bit-exact vs plain twin; {m['shapes']}; "
            f"kernel {m['ms']:.4f} ms, bound {m['bound_ms']:.4f} ms "
            f"(bytes / {bw / 1e12:.2f} TB/s), plain twin "
            f"{m['plain_ms']:.4f} ms (no yardstick), library "
            f"{m['library_ms'] if m['library_ms'] is None else round(m['library_ms'], 4)} ms"
        )
    return out


# -- phase 4: the slice ---------------------------------------------------------


def start_producers(tmp: str, tile, capacity: int, count: int = 2):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    )
    procs = []
    for i in range(count):
        addr_file = os.path.join(tmp, f"producer{i}-{'x'.join(map(str, tile))}.addr")
        cmd = [
            sys.executable, "-m", "blendjax_torch.producer.cube",
            "--addr-file", addr_file, "--btid", str(i), "--seed", str(i),
            "--shape", str(SHAPE[0]), str(SHAPE[1]), "--batch", str(BATCH),
            "--encoding", "tile", "--tile", *map(str, tile), "--tile-rgba",
            "--tile-capacity", str(capacity),
        ]
        procs.append((subprocess.Popen(cmd, cwd=ROOT, env=env), addr_file))
    addrs = []
    deadline = time.monotonic() + 120
    for proc, addr_file in procs:
        while not os.path.exists(addr_file):
            if proc.poll() is not None:
                fail(f"producer exited with {proc.returncode} before binding")
            if time.monotonic() > deadline:
                fail("producer did not bind within 120 s")
            time.sleep(0.05)
        with open(addr_file) as f:
            addrs.append(f.read().strip())
    return [p for p, _ in procs], addrs


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


def run_leg(label: str, leg: dict, state, tmp: str) -> dict:
    import torch

    from blendjax_torch.data import StreamDataPipeline
    from blendjax_torch.kernels import launch_counts, reset_launch_counts
    from blendjax_torch.train import TrainDriver, make_fused_tile_step

    procs, addrs = start_producers(tmp, leg["tile"], leg["capacity"])
    pipe = StreamDataPipeline(
        addrs, batch_size=BATCH, chunk=CHUNK, timeoutms=60_000
    )
    step = make_fused_tile_step()
    drv = TrainDriver(step, state, inflight=2, sync_every=4)
    total = leg["warmup"] + leg["steps"]
    images = 0
    last = None
    t0 = None
    try:
        reset_launch_counts()
        for batch in pipe:
            drv.submit(batch)
            last = batch
            if drv.steps == leg["warmup"]:
                drv.drain()
                t0 = time.perf_counter()
            elif drv.steps > leg["warmup"]:
                images += int(batch["_packed"].shape[0]) * BATCH
            if drv.steps >= total:
                break
        drv.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        gaps = pipe.seq_gaps
    finally:
        pipe.stop()
        stop_producers(procs)
    losses = drv.losses  # drain() appended the final loss
    if not all(math.isfinite(v) for v in losses):
        fail(f"{label}: non-finite loss in {losses}")
    if gaps:
        fail(f"{label}: {gaps} sequence gaps")
    # step alone on the last chunk group: the card's own rate
    torch.cuda.synchronize()
    s0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        step(state, last)
    torch.cuda.synchronize()
    alone = (time.perf_counter() - s0) / reps
    from blendjax_torch.ops.tiles import decode_packed_superbatch

    decode_ms = time_ms(lambda: decode_packed_superbatch(
        last["_packed"], last["_refs"], last["_spec"], last["_names"],
        last["_geoms"], last["_rle"],
    ), reps=5, windows=5)
    group_images = int(last["_packed"].shape[0]) * BATCH
    return {
        "img_s": images / wall, "wall_s": wall, "images": images,
        "steps": drv.steps, "losses": losses, "seq_gaps": gaps,
        "launches": counts, "driver": drv.stats,
        "dispatch_per_step": drv.dispatches / drv.steps,
        "step_alone_ms": alone * 1e3,
        "step_alone_img_s": group_images / alone,
        "decode_ms": decode_ms, "last": last,
    }


# -- phase 5: reference checks --------------------------------------------------


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


def main() -> None:
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

    # phase 2: build
    t0 = time.perf_counter()
    logs = build()
    log(f"build: {len(logs)} kernels in {time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "smem" in line:
                log(f"build {name}: {line.strip()}")

    # phase 3: kernels
    measured = kernel_phase(bw)

    # phase 4: the slice
    torch.manual_seed(0)
    state = make_train_state(CubeRegressor().init_params(0))
    with tempfile.TemporaryDirectory() as tmp:
        legs = {
            "flagship": run_leg("flagship (16,32) leg", FLAGSHIP, state, tmp),
            "square": run_leg("square 16x16 leg", SQUARE, state, tmp),
        }
    if legs["flagship"]["launches"]["decode_spatial"] <= 0:
        fail("flagship leg never launched decode_spatial (K1)")
    if legs["square"]["launches"]["decode_scatter"] <= 0:
        fail("square leg never launched decode_scatter (K2)")
    for name, leg in legs.items():
        log(
            f"slice {name}: {leg['img_s']:.1f} img/s over {leg['images']} "
            f"images ({leg['wall_s']:.2f} s) on {card}; "
            f"dispatches/step {leg['dispatch_per_step']:.2f}; step alone "
            f"{leg['step_alone_ms']:.2f} ms/chunk group "
            f"({leg['step_alone_img_s']:.1f} img/s), of which decode "
            f"{leg['decode_ms']:.3f} ms; launches {leg['launches']}; "
            f"seq_gaps {leg['seq_gaps']}; driver {leg['driver']}; "
            f"final loss {leg['losses'][-1]:.5f}"
        )

    # phase 5: reference checks
    reference_phase(legs["flagship"]["last"])

    leg_of = {"decode_spatial": "flagship", "decode_scatter": "square"}
    rows = []
    for name, meta in KERNELS.items():
        m = measured[name]
        rows.append({
            "name": name, "route": meta["route"], "source": meta["source"],
            "replaces": meta["replaces"],
            "launches": legs[leg_of[name]]["launches"][name],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
