"""Stall doctor: classify the pipeline's current bottleneck (copied from
``blendjax/obs/doctor.py``; the port's evidence: ``train.compile_ms`` is
CUDA-graph capture time, ``device.retraces`` counts captures after
warm-up, ``device.hbm_headroom_frac`` comes from the device ledger).

tf.data-style per-stage bottleneck attribution over the metrics the
pipeline already emits. The streaming stack has five distinct failure
modes, otherwise told apart by hand-reading counter dumps; the doctor encodes that reading as a deterministic
decision procedure over one :meth:`Metrics.report` snapshot:

==============  ============================================================
verdict         evidence
==============  ============================================================
compile-bound   one-time jit/AOT compile wall time (``train.compile_ms``)
                dominates the window: a cold start, not a slow step —
                checked first so cold-start runs never misread as
                step-bound; the advice points at the persistent
                compilation cache (docs/performance.md "Instant start")
step-bound      ingest outruns the consumer: ``ingest.queue_full_waits``
                climbing while the consumer barely waits on the queue, or
                the driver's dispatch ring blocking (``driver.ring_wait`` /
                ``train.host_blocks``)
feed-bound      host→device transfer is the wall: ``feed.throttle_blocks``
                with a significant ``feed.throttle_wait``/``feed.place``
                share
decode-bound    the standalone decode jit dominates (``decode.dispatch``)
wire-bound      the consumer starves (``ingest.queue_wait`` high) AND
                frames arrive already old (per-producer e2e staleness p95
                above ``stale_wire_s``): the socket/codec path is slow,
                not the producers
producer-bound  the consumer starves but frames arrive FRESH: producers
                simply don't render fast enough
echo-saturated  a data-echoing pipeline's draw loop blocked on its echo
                budget (``echo.saturated_waits`` / ``echo.wait_fresh``):
                echoing already absorbs all it may — raise producers,
                reservoir capacity, or ``max_echo_factor``
retrace-storm   compiles recurring past warm-up: the device ledger's
                retrace audit counted ``device.retraces`` dispatches
                whose batch signature missed every compiled shape —
                each one re-traces and re-compiles mid-run
memory-bound    HBM headroom collapsing (``device.hbm_headroom_frac``
                below the floor), with the ledger's static accounting
                (``device.temp_bytes`` vs ``device.hbm_peak_bytes``)
                naming whether temporaries or resident state dominate
==============  ============================================================

plus ``balanced`` (no single stage dominates — the healthy verdict) and
``idle`` (no span data yet). The discriminator between wire- and
producer-bound is frame lineage (:mod:`blendjax_torch.obs.lineage`): identical
queue-wait symptoms, opposite staleness signatures. A starving consumer
whose ``echo.*`` counters show an active, unsaturated reservoir is
reported producer-bound with an "echo-mitigated" reason — the step rate
is being sustained by echoing, and the advice shifts from "the run is
starving" to "fresh-data diversity is the limit".

All inputs are plain dicts so synthetic fixtures exercise every verdict
without sockets or devices (``tests/test_torch_obs.py`` holds them
against the JAX package's doctor).
"""

from __future__ import annotations

import dataclasses

# Verdict kinds, in the order the decision procedure tests them.
VERDICTS = (
    "compile-bound",
    "retrace-storm",
    "memory-bound",
    "step-bound",
    "feed-bound",
    "decode-bound",
    "wire-bound",
    "producer-bound",
    "echo-saturated",
    "balanced",
    "idle",
)

# Staleness p95 above which a starving consumer reads wire-bound rather
# than producer-bound: a healthy local pipe delivers frames in tens of
# milliseconds; a quarter second of age on arrival means the frames
# existed long before we got them.
DEFAULT_STALE_WIRE_S = 0.25

# device.retraces at or above which recurring mid-run recompiles read as
# a storm: one or two can be a legitimately novel shape; three means
# shapes keep missing the compiled ladder.
DEFAULT_RETRACE_STORM = 3

# device.hbm_headroom_frac below which the run reads memory-bound: under
# ~8% free, allocator fragmentation alone can OOM a step whose peak fits
# on paper.
DEFAULT_HBM_HEADROOM_FLOOR = 0.08


@dataclasses.dataclass(frozen=True)
class Verdict:
    """One classification: ``kind`` (a :data:`VERDICTS` member), a
    human ``reason`` with the deciding numbers inlined, ``advice`` (the
    lever to pull), and the span ``shares`` it was computed from."""

    kind: str
    reason: str
    advice: str
    shares: dict

    def render(self) -> str:
        return f"doctor: {self.kind} — {self.reason} ({self.advice})"

    def __str__(self) -> str:  # str(verdict) in f-strings/logs
        return self.render()


def _total(spans: dict, name: str) -> float:
    v = spans.get(name)
    if not v:
        return 0.0
    return float(v.get("total_s", 0.0))


def diagnose(
    report: dict,
    driver: dict | None = None,
    lineage: dict | None = None,
    staleness_p95_s: float | None = None,
    stale_wire_s: float = DEFAULT_STALE_WIRE_S,
    prefetch: int | None = None,
    retrace_storm: int = DEFAULT_RETRACE_STORM,
    hbm_headroom_floor: float = DEFAULT_HBM_HEADROOM_FLOOR,
) -> Verdict:
    """Classify one :meth:`blendjax_torch.utils.metrics.Metrics.report`
    snapshot. ``driver`` is an optional ``TrainDriver.stats`` dict;
    ``lineage`` an optional :meth:`FrameLineage.report` snapshot (used
    for the staleness discriminator when ``staleness_p95_s`` isn't
    given directly); ``prefetch`` — when the caller knows the ingest
    queue bound — lets the ``ingest.queue_depth_hwm`` gauge act as
    backpressure evidence (queue pinned at its bound == producers
    outran the consumer) alongside ``ingest.queue_full_waits``."""
    spans = report.get("spans", {})
    counters = report.get("counters", {})
    gauges = report.get("gauges", {})

    recv = sum(
        float(v.get("total_s", 0.0))
        for k, v in spans.items()
        if k.startswith("ingest.recv")
    )
    qwait = _total(spans, "ingest.queue_wait")
    place = _total(spans, "feed.place")
    throttle = _total(spans, "feed.throttle_wait")
    decode = _total(spans, "decode.dispatch")
    train = _total(spans, "train.dispatch")
    ring = _total(spans, "driver.ring_wait")
    # Echoing pipelines starve in their own span: the draw loop blocked
    # waiting for fresh frames (the inner consumer's queue_wait accrues
    # concurrently in the drain thread).
    ewait = _total(spans, "echo.wait_fresh")
    # One-time graph capture wall time (blendjax_torch.train.aot). Included
    # in the evidence so a cold-start-dominated run reads compile-bound
    # — not step-bound — and the advice points at the persistent cache.
    compile_s = _total(spans, "train.compile_ms")

    busy = (
        recv + qwait + place + throttle + decode + train + ring + ewait
        + compile_s
    )
    shares = {
        "ingest.recv": recv,
        "ingest.queue_wait": qwait,
        "feed.place": place,
        "feed.throttle_wait": throttle,
        "decode.dispatch": decode,
        "train.dispatch": train,
        "driver.ring_wait": ring,
        "echo.wait_fresh": ewait,
        "train.compile_ms": compile_s,
    }
    if busy <= 0.0:
        return Verdict(
            "idle", "no span data recorded yet",
            "run the pipeline before asking for a diagnosis", shares,
        )
    shares = {k: round(v / busy, 4) for k, v in shares.items()}

    full_waits = int(counters.get("ingest.queue_full_waits", 0))
    throttle_blocks = int(counters.get("feed.throttle_blocks", 0))
    host_blocks = int(counters.get("train.host_blocks", 0))
    if driver:
        host_blocks = max(host_blocks, int(driver.get("host_blocks", 0)))

    if staleness_p95_s is None and lineage:
        vals = [
            p.get("e2e_staleness_ms", {}).get("p95")
            for p in lineage.values()
            if p.get("e2e_staleness_ms", {}).get("count")
        ]
        vals = [v for v in vals if v is not None]
        if vals:
            staleness_p95_s = max(vals) / 1e3

    # 0. compile-bound: one-time trace+compile wall time dominates the
    #    window — a cold start, not a slow step. Checked FIRST: compile
    #    stalls the consumer loop, so every downstream signature (full
    #    ingest queue, ring waits) fires too and would misread as
    #    step-bound.
    if shares["train.compile_ms"] > 0.5:
        return Verdict(
            "compile-bound",
            f"train.compile_ms share={shares['train.compile_ms']:.0%} "
            f"(aot_cache_hits={int(counters.get('train.aot_cache_hits', 0))}, "
            f"aot_cache_misses="
            f"{int(counters.get('train.aot_cache_misses', 0))}): this "
            "window is cold-start compilation, not steady-state work",
            "AOT-compile before step 0 behind the persistent cache "
            "(TrainDriver.build(aot=True, aot_cache_dir=...)); warm "
            "restarts then pay milliseconds — see docs/performance.md "
            "'Instant start'",
            shares,
        )

    # 0b. retrace-storm: the device ledger's audit counted dispatches
    #     whose batch signature missed every compiled shape — each one
    #     re-traces and re-compiles MID-RUN (unlike arm 0's one-time
    #     cold start). Checked before step-bound: a storm's compile
    #     stalls produce ring waits and full queues too, and the lever
    #     is shape hygiene, not a faster step.
    retraces = int(counters.get("device.retraces", 0))
    if retraces >= max(1, int(retrace_storm)):
        return Verdict(
            "retrace-storm",
            f"device.retraces={retraces} (threshold {retrace_storm}): "
            "batch shapes keep missing the compiled ladder and "
            "re-compile mid-run — the ledger's retrace events name the "
            "offending signatures",
            "bucket the ragged tails (pad_to_bucket / driver "
            "pad_partial=True), widen buckets= to cover the observed "
            "shapes, or AOT-compile the full ladder "
            "(TrainDriver.build(aot=True))",
            shares,
        )

    # 0c. memory-bound: live HBM headroom collapsing (the reporter-tick
    #     device.memory_stats() poll). Before step-bound for the same
    #     reason: an allocator running at the wall thrashes and stalls
    #     dispatches, and the fix is memory, not compute.
    headroom = gauges.get("device.hbm_headroom_frac")
    if headroom is not None and float(headroom) < hbm_headroom_floor:
        temp = float(gauges.get("device.temp_bytes", 0) or 0)
        peak = float(gauges.get("device.hbm_peak_bytes", 0) or 0)
        temp_dominant = peak > 0 and temp / peak > 0.5
        culprit = (
            "step temporaries dominate the compiled peak "
            f"(temp {temp / peak:.0%} of it)" if temp_dominant
            else "resident state (params/optimizer/batches), not step "
            "temporaries, holds the memory"
        )
        return Verdict(
            "memory-bound",
            f"device.hbm_headroom_frac={float(headroom):.1%} < floor "
            f"{hbm_headroom_floor:.0%}: {culprit}",
            "shrink batch/chunk or remat the step if temporaries "
            "dominate; shard state over the mesh (fsdp) or drop "
            "optimizer precision if resident state does — see "
            "docs/performance.md 'Reading the device ledger'",
            shares,
        )

    # 1. step-bound (specific evidence): the dispatch ring genuinely
    #    filling — these signals implicate the STEP itself, so they
    #    outrank the generic backpressure arm below (which any
    #    downstream-of-queue bottleneck also produces).
    depth_hwm = int(gauges.get("ingest.queue_depth_hwm", 0))
    backpressured = full_waits > 0 or (
        prefetch is not None and prefetch > 0 and depth_hwm >= prefetch
    )

    def step_verdict():
        return Verdict(
            "step-bound",
            f"ingest.queue_full_waits={full_waits}, "
            f"queue_depth_hwm={depth_hwm}, "
            f"ring_wait share={shares['driver.ring_wait']:.0%}, "
            f"host_blocks={host_blocks}: the train step can't keep up "
            "with ingest",
            "raise chunk/inflight, shrink the model, or add chips",
            shares,
        )

    if shares["driver.ring_wait"] > 0.35 or (
        host_blocks > 0 and shares["train.dispatch"] > 0.35
    ):
        return step_verdict()

    # 2. feed-bound: host→device transfer throttling the loop. Checked
    #    BEFORE the backpressure step-bound arm: a slow feed fills the
    #    ingest queue too, and its own counters are the more specific
    #    evidence.
    if throttle_blocks > 0 and (
        shares["feed.throttle_wait"] + shares["feed.place"] > 0.25
    ):
        return Verdict(
            "feed-bound",
            f"feed.throttle_blocks={throttle_blocks}, "
            f"throttle_wait+place share="
            f"{shares['feed.throttle_wait'] + shares['feed.place']:.0%}: "
            "host->device transfer is the wall",
            "shrink wire bytes (tile/pal encoding), raise chunk, or "
            "check link weather",
            shares,
        )

    # 3. decode-bound: the standalone decode jit dominates.
    others = max(
        shares["ingest.recv"], shares["ingest.queue_wait"],
        shares["feed.place"], shares["feed.throttle_wait"],
        shares["train.dispatch"], shares["driver.ring_wait"],
        shares["echo.wait_fresh"], shares["train.compile_ms"],
    )
    if shares["decode.dispatch"] > 0.30 and shares["decode.dispatch"] >= others:
        return Verdict(
            "decode-bound",
            f"decode.dispatch share={shares['decode.dispatch']:.0%} "
            "dominates the loop",
            "fuse the decode into the step (emit_packed + "
            "make_fused_tile_step — run-length 'ndr' wire frames then "
            "expand in-jit too) or revisit tile geometry",
            shares,
        )

    # 3b. step-bound (generic backpressure): ingest blocked on a full
    #     queue — or the depth high-water mark pinned at the known
    #     bound — while the consumer barely waits on it. Reached only
    #     once feed and decode have been ruled out, because ANY
    #     downstream-of-queue bottleneck produces this signature.
    if backpressured and shares["ingest.queue_wait"] < 0.15:
        return step_verdict()

    # 4/5. consumer starving: gate on ingest.queue_wait (the consumer-
    #      observed wait) or echo.wait_fresh (the echoing draw loop's
    #      own starvation span) — NOT ingest.recv, which accrues
    #      concurrently in N worker threads (N shards blocked in recv
    #      can bank ~N x wall of span time) and would misclassify a
    #      healthy sharded run as starving; it only corroborates via
    #      the reason string.
    starving = (
        shares["ingest.queue_wait"] > 0.30
        or shares["echo.wait_fresh"] > 0.30
    )
    echo_fresh = int(counters.get("echo.fresh", 0))
    echo_echoed = int(counters.get("echo.echoed", 0))
    echo_active = echo_fresh + echo_echoed > 0
    if starving:
        if staleness_p95_s is not None and staleness_p95_s >= stale_wire_s:
            return Verdict(
                "wire-bound",
                f"consumer starving (queue_wait share="
                f"{shares['ingest.queue_wait']:.0%}) and frames arrive "
                f"{staleness_p95_s * 1e3:.0f} ms old (p95): the "
                "socket/codec path is slow, not the producers",
                "enable wire compression (compress_level zlib, or "
                "compress_rle for run-heavy frames — near-free "
                "inflate, in-jit on the fused path), raise "
                "ingest_workers (whose shared inflate pool pipelines "
                "decode-ahead; wire.inflate_ms shows the host decode "
                "cost), or fix the link",
                shares,
            )
        fresh = (
            f"{staleness_p95_s * 1e3:.0f} ms old (p95)"
            if staleness_p95_s is not None else "unstamped"
        )
        if echo_active:
            # The echo arm: same producer-shaped starvation, but a data-
            # echoing reservoir sits between it and the step. Saturated
            # (the draw loop blocked on its budget) means echoing already
            # gives all it may; unsaturated means the step rate is being
            # sustained and fresh-data diversity is the real limit.
            sat = int(counters.get("echo.saturated_waits", 0))
            factor = round(
                (echo_fresh + echo_echoed) / max(echo_fresh, 1), 2
            )
            if sat > 0 or shares["echo.wait_fresh"] > 0.30:
                return Verdict(
                    "echo-saturated",
                    f"echo budget exhausted {sat} times "
                    f"(wait_fresh share={shares['echo.wait_fresh']:.0%}, "
                    f"echo factor {factor}): the reservoir can't echo "
                    "any further under its budget",
                    "raise producer instances (blendjax_torch.fleet autoscales "
                    "on this verdict), reservoir capacity, or "
                    "max_echo_factor",
                    shares,
                )
            return Verdict(
                "producer-bound",
                f"producer-bound, echo-mitigated: frames arrive fresh "
                f"({fresh}) at a fraction of the step rate, and the "
                f"reservoir echoes each {factor}x to keep the step fed "
                f"(unique fraction "
                f"{echo_fresh / (echo_fresh + echo_echoed):.0%})",
                "launch more producer instances for fresh-data "
                "diversity; the step rate itself is already sustained",
                shares,
            )
        return Verdict(
            "producer-bound",
            f"consumer starving (queue_wait share="
            f"{shares['ingest.queue_wait']:.0%}) while frames arrive "
            f"fresh ({fresh}): producers don't render fast enough",
            "launch more producer instances — by hand or via "
            "blendjax_torch.fleet.FleetController, which autoscales on this "
            "verdict — cheapen the scene/render, or absorb the gap "
            "with data echoing (blendjax_torch.data.EchoingPipeline)",
            shares,
        )

    return Verdict(
        "balanced",
        "no single stage dominates",
        "nothing to fix; scale the workload to find the next wall",
        shares,
    )


def diagnose_current(driver: dict | None = None,
                     stale_wire_s: float = DEFAULT_STALE_WIRE_S,
                     prefetch: int | None = None) -> Verdict:
    """Diagnose the live process-wide registries (the convenience the
    :class:`blendjax_torch.obs.reporter.StatsReporter` thread and
    ``StreamDataPipeline.doctor()`` call)."""
    from blendjax_torch.obs.lineage import lineage
    from blendjax_torch.utils.metrics import metrics

    return diagnose(
        metrics.report(),
        driver=driver,
        staleness_p95_s=lineage.staleness_p95_s(),
        stale_wire_s=stale_wire_s,
        prefetch=prefetch,
    )
