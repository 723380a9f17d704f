"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout with an NVIDIA card. The cell's parts are
found by name (:mod:`portbench.cell`). The run:

1. builds the port's model (``blendjax_torch.models``) with weights drawn
   from the seed on the card (:mod:`portbench.weights`), its AdamW state
   and the captured fused step (``CapturedStep(make_fused_tile_step)``),
   captures every plan signature of the stream, starts the traffic
   (:mod:`portbench.feed`), and drives ``TrainDriver.submit`` through
   one checked call of ``chunk`` updates (:mod:`portbench.check`) and the
   mix's warm-up;
2. measures ``--seconds`` of step calls (``--trace 1``: a stretch of them
   under ``torch.profiler``, :mod:`portbench.trace`);
3. closes the window, reads the card's memory peak, stops the traffic,
   frees the program's state, runs the plain reference over the checked
   updates, and prints one JSON line: ``correct``, ``attempted``,
   ``failed``, ``metrics`` (the cell's end-to-end metrics, or with
   ``--trace 1`` its per-layer ones, each from its reader in
   ``portbench/metrics/``), ``device``, with ``--trace 1`` ``breakdown``,
   and last ``checks``, each compared number beside its limit (also the
   last lines on standard error).

It exits non-zero without a result when there is no card (or fewer than
the cell asks for), or when a module of JAX or of the JAX package is
loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

from portbench.cell import ROOT, Cell, load_cell, metric_reader  # noqa: E402

#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "blendjax")


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def set_cache_dirs(root: str = ROOT) -> None:
    """Build and kernel caches at fixed paths inside the checkout, so only
    a checkout's first run builds (the port's nvcc and g++ libraries go to
    ``build/`` beside the package already)."""
    build = os.path.join(root, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")


def forbidden_modules() -> list:
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def card_report() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"


class CallTap:
    """The captured step as the driver calls it, keeping each call's loss
    tensor (read after the window, so nothing waits for the card here).
    Everything else is the wrapped step's."""

    def __init__(self, step):
        self.inner = step
        self.losses = []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __call__(self, state, batch):
        state, m = self.inner(state, batch)
        self.losses.append(m["loss"])
        return state, m


def build_program(cell: Cell, seed: int, device):
    """The port's model with the seed's weights, its train state and the
    captured fused step."""
    import torch

    from blendjax_torch import models
    from blendjax_torch.precision import resolve_policy
    from blendjax_torch.train import (
        CapturedStep,
        corner_loss,
        make_fused_tile_step,
        make_train_state,
    )

    from portbench import weights

    cfg, traffic = cell.config, cell.traffic
    shape = tuple(traffic["shape"])
    # the policy binds the model's compute dtype and the step's gradients
    policy = resolve_policy(cfg["precision"])
    kwargs = {**cfg["port"]["kwargs"], **policy.module_kwargs()}
    if cfg["port"].get("image_shape"):
        kwargs["image_shape"] = shape
    with torch.device(device):
        model = getattr(models, cfg["port"]["class"])(**kwargs)
    weights.load_into(model, seed)
    opt = cfg["optimizer"]
    state = make_train_state(model, learning_rate=opt["lr"], device=device)
    group = state.optimizer.param_groups[0]
    stated = (tuple(opt["betas"]), opt["eps"], opt["weight_decay"])
    if (tuple(group["betas"]), group["eps"], group["weight_decay"]) != stated:
        raise RuntimeError(f"the port's AdamW {group} is not the "
                           f"configuration's {opt}")

    def loss(model, batch):
        image = batch["image"]
        return corner_loss(model(image).reshape(-1, 8, 2), batch["xy"],
                           image_shape=tuple(image.shape[1:3]))

    step = CapturedStep(make_fused_tile_step(loss, precision=cfg["precision"]))
    return model, state, step


class Driving:
    """The driver and the feed's batches, with each call's records."""

    def __init__(self, driver, tap, feed, batch: int, annotate: bool):
        self.driver, self.tap, self.feed = driver, tap, feed
        self.batch = batch
        self.it = iter(feed.pipeline)
        self.annotate = annotate

    def _label(self, name: str):
        if not self.annotate:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)

    def next_group(self) -> dict:
        with self._label("bench.next_batch"):
            return next(self.it)

    def skip(self, group: dict) -> None:
        """Drop a group untrained, with its messages' records."""
        for meta in group["_meta"]:
            self.feed.records.take(meta.get("btid"))

    def submit(self, group: dict) -> tuple:
        """One step call; returns ``(images, records of its messages)``."""
        records = [self.feed.records.take(meta.get("btid"))
                   for meta in group["_meta"]]
        with self._label("bench.submit"):
            self.driver.submit(group)
        return int(group["_packed"].shape[0]) * self.batch, records


def checked_updates(drive: Driving, state, chunk: int) -> dict:
    """One step call of the signature the window times: the feed's first
    group of ``chunk`` messages (one replay of the captured graph, one
    update per message), through the window's driver; keeps what the
    check compares. Shorter groups before it go untrained."""
    from portbench.check import program_snapshot

    group = drive.next_group()
    while int(group["_packed"].shape[0]) != chunk:
        drive.skip(group)
        group = drive.next_group()
    _, records = drive.submit(group)
    drive.driver.drain()
    out = program_snapshot(state)
    out["losses"] = [float(v) for v in drive.tap.losses[0].reshape(-1)]
    out["keys"] = [("seq", r["btid"], r["seq"]) if "seq" in r
                   else ("index", r["index"]) for r in records]
    return out


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: str = "cuda") -> dict:
    """One run of ``cell``; returns the result line's dict."""
    import torch

    from blendjax_torch.train import TrainDriver
    from blendjax_torch.utils.metrics import metrics

    from portbench import check, weights
    from portbench.cell import family_module
    from portbench.feed import make_feed, plan_groups
    from portbench.formulas.peaks import peaks
    from portbench.trace import TracedWindow

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    traffic, cfg = cell.traffic, cell.config
    workdir = tempfile.mkdtemp(prefix="portbench-")  # under TMPDIR
    feed = None
    marks = [("imports", time.perf_counter())]
    try:
        model, state, step = build_program(cell, seed, dev)
        marks.append(("model", time.perf_counter()))
        # captures before the traffic starts: no producer competes with
        # them for the host's cores
        if on_card:  # a CPU step runs eagerly: nothing to capture
            for group in plan_groups(traffic, dev):
                step.prepare(state, group)
        signatures = len(step.signatures)
        marks.append(("captures", time.perf_counter()))
        feed = make_feed(traffic, seed, workdir, dev)
        marks.append(("traffic", time.perf_counter()))
        tap = CallTap(step)
        driver = TrainDriver(tap, state, inflight=traffic["inflight"],
                             sync_every=traffic["sync_every"])
        drive = Driving(driver, tap, feed, traffic["batch"], trace)
        program = checked_updates(drive, state, traffic["chunk"])
        marks.append(("checked call", time.perf_counter()))
        for _ in range(traffic["warmup_calls"]):
            drive.submit(drive.next_group())
        driver.drain()
        tap.losses.clear()
        marks.append(("warm-up", time.perf_counter()))
        log("set-up: " + ", ".join(
            f"{name} {t - prev:.3f} s" for (name, t), (_n, prev)
            in zip(marks, [("start", T_START)] + marks[:-1])))

        # -- the window ----------------------------------------------------
        metrics.reset()
        if trace:
            metrics.enable_span_events()
        traced = TracedWindow(workdir, on_card) if trace else None
        calls = []  # (images, records, completion event or host time)
        if on_card:
            torch.cuda.synchronize()
            ref_event = torch.cuda.Event(enable_timing=True)
            ref_event.record()
            ref_event.synchronize()
        t0_wall = time.time()
        t0 = time.perf_counter()
        setup_s = t0 - T_START
        # a --trace 1 run profiles the window's last ``trace_seconds``: the
        # profiler's stop and export come after the window has closed
        trace_at = max(seconds - traffic["trace_seconds"], 0.0)
        while True:
            now = time.perf_counter() - t0
            if now >= seconds:
                break
            if traced is not None and traced.prof is None and now >= trace_at:
                traced.start()
            images, records = drive.submit(drive.next_group())
            if on_card:
                done = torch.cuda.Event(enable_timing=True)
                done.record()
            else:
                done = time.time()
            calls.append((images, records, done, traced is not None
                          and traced.active))
        driver.drain()
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if traced is not None and traced.active:
            traced.stop()
        t1_wall = t0_wall + wall
        spans = {}
        for name, _t, dur, _tid in metrics.span_events():
            spans.setdefault(name, []).append(dur)
        metrics.disable_span_events()
        memory_peak = (torch.cuda.max_memory_allocated(dev) if on_card
                       else 0)
        captured_in_window = len(step.signatures) - signatures
        losses = list(tap.losses)
        failed = sum(int(not bool(torch.isfinite(t).all())) for t in losses)
        ages = []
        for _images, records, done, _tr in calls:
            end = (t0_wall + ref_event.elapsed_time(done) / 1e3 if on_card
                   else done)
            ages += [end - r["pub_wall"] for r in records
                     if r.get("pub_wall") is not None]
        trace_rep = traced.read() if traced is not None else None
        if trace_rep is not None:
            traced_calls = [c for c in calls if c[3]]
            trace_rep["images"] = sum(c[0] for c in traced_calls)
            trace_rep["records"] = [r for c in traced_calls for r in c[1]]
        feed.stop()
        card = torch.cuda.get_device_name(dev) if on_card else "cpu"
        flops_module = family_module("formulas", cfg["family"])
        ctx = {
            "cell": cell, "setup_s": setup_s, "seconds": wall,
            "images": sum(c[0] for c in calls), "calls": len(calls),
            "frame_ages_s": ages, "spans": spans, "trace": trace_rep,
            "producers": feed.producer_stats(),
            "staleness_s": [r["recv_wall"] - r["pub_wall"]
                            for c in calls for r in c[1]
                            if r.get("pub_wall") is not None
                            and t0_wall <= r["recv_wall"] <= t1_wall],
            "peaks": peaks(card) if on_card else None,
            "flops_per_image": flops_module.flops_per_image(
                cfg["model"], traffic["shape"]),
        }
        log(f"window: {len(calls)} step calls, {ctx['images']} images in "
            f"{wall:.3f} s; set-up {setup_s:.3f} s; {captured_in_window} "
            f"captures in the window; {failed} calls with a non-finite loss")

        # -- free the program, then the reference ---------------------------
        del drive, driver, tap, step, state, model, losses, calls
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        raw = feed.check_messages()
        batches = check.decoded_messages(raw, program["keys"])
        shape = tuple(traffic["shape"])
        reference = check.reference_updates(cfg, shape, seed, batches, dev)
        start = weights.seeded_weights(
            {n: tuple(t.shape) for n, t in reference["params"].items()},
            seed, dev)
        values = check.readings(program, reference, start)
        log(f"check's readings: {json.dumps(values)}")
        log(f"check's look: {json.dumps(check.look(program, reference, start))}")
        correct, checks = check.verdict(values, cell.limits)
        for c in checks.values():  # a non-finite reading prints as null
            if not math.isfinite(c["value"]):
                c["value"] = None
        correct = correct and failed == 0

        metrics_out = {}
        wanted = cell.per_layer if trace else cell.end_to_end
        for m in wanted:
            value = metric_reader(m["name"])(ctx)
            if value is not None:
                metrics_out[m["name"]] = {"value": value, "unit": m["unit"]}
        result = {
            "correct": bool(correct), "attempted": ctx["calls"], "failed": failed,
            "metrics": metrics_out,
            "device": {"platform": "gpu" if on_card else "cpu",
                       "kind": card, "count": 1 if on_card else 0,
                       "memory_peak_bytes": int(memory_peak)},
        }
        if trace_rep is not None:
            result["device"]["busy_s"] = trace_rep["busy_s"]
            result["device"]["window_s"] = trace_rep["window_s"]
            result["breakdown"] = {
                "device_ops": [[n, s] for n, s in trace_rep["device_ops"]],
                "idle_gaps": [[n, s] for n, s in trace_rep["idle_gaps"]]}
        result["checks"] = checks
        return result
    finally:
        if feed is not None:
            feed.stop()
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cell = load_cell(args.workload)
    set_cache_dirs()
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(f"card: {card_report()}")
    result = run(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        log(f"modules of JAX or the JAX package were loaded: {found}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
