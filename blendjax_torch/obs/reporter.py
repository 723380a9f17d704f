"""StatsReporter: a background thread that keeps the operator informed
(copied from ``blendjax/obs/reporter.py``).

Every ``interval_s`` it takes one consistent metrics snapshot, runs the
stall doctor over it, logs the one-line verdict, and (optionally)
appends the full snapshot to a JSONL archive — the always-on version of
the ``stages`` line ``chip_smoke.py`` prints, for long training runs.

Since the SLO watchdog landed the reporter is also the evaluation
cadence for declarative health rules: pass ``slos=[...]`` (specs or
:class:`~blendjax_torch.obs.watchdog.Slo` objects) and each tick checks them
against the fresh snapshot; a sustained breach triggers the
:class:`~blendjax_torch.obs.watchdog.FlightRecorder` (``flight_dir=...``)
with the reporter's last-K history ring as evidence, and
:meth:`health` backs the HTTP exporter's ``/healthz`` (200/503).
"""

from __future__ import annotations

import collections
import time

import threading

from blendjax_torch.obs.doctor import diagnose
from blendjax_torch.obs.exporters import JsonlExporter
from blendjax_torch.obs.lineage import FrameLineage
from blendjax_torch.obs.lineage import lineage as default_lineage
from blendjax_torch.utils.metrics import Metrics, metrics
from blendjax_torch.utils.logging import get_logger

logger = get_logger("obs")

# Default JSONL archive bound: ~64 MiB per generation, 3 generations
# kept. A 10s-tick run writes a few KB per line, so this is weeks of
# history — while an unbounded archive on a long-lived trainer is a
# disk-full incident waiting (the pre-rotation behavior).
DEFAULT_ROTATE_BYTES = 64 * 1024 * 1024


class StatsReporter:
    """Periodic doctor verdict + optional JSONL snapshot archive,
    SLO evaluation, and breach-triggered flight recording.

    >>> rep = StatsReporter(
    ...     interval_s=10, jsonl_path="run_stats.jsonl",
    ...     slos=["rate(wire.seq_gaps) == 0",
    ...           "p95(wire.e2e_staleness_s) <= 0.5 @ 30"],
    ...     flight_dir="flight-records",
    ... )
    >>> rep.start()
    ... # train ...  (serve rep.health via start_http_exporter(health=...))
    >>> rep.stop()

    ``driver_stats`` may be a zero-arg callable returning a
    ``TrainDriver.stats`` dict so ring-full blocks feed the diagnosis.
    ``history`` bounds the ring of recent (snapshot, verdict) pairs the
    flight recorder dumps on a breach.
    """

    def __init__(
        self,
        interval_s: float = 10.0,
        registry: Metrics = metrics,
        lineage: FrameLineage = default_lineage,
        jsonl_path: str | None = None,
        driver_stats=None,
        log=logger,
        slos=None,
        flight_dir: str | None = None,
        flight_profile_s: float = 0.0,
        history: int = 32,
        jsonl_rotate_bytes: int | None = DEFAULT_ROTATE_BYTES,
        jsonl_keep: int = 3,
        fleet=None,
        checkpoint_on_breach=None,
    ):
        self.interval_s = float(interval_s)
        self.registry = registry
        self.lineage = lineage
        self.driver_stats = driver_stats
        # Optional FleetController (or anything with .state() -> dict):
        # its instance count / streaks / scale-event log are archived
        # beside the verdict each tick, so a JSONL trail answers "what
        # did the fleet do when the verdict flipped" without correlating
        # two logs.
        self.fleet = fleet
        self.log = log
        self._jsonl = (
            JsonlExporter(
                jsonl_path, rotate_bytes=jsonl_rotate_bytes,
                keep=jsonl_keep,
            )
            if jsonl_path else None
        )
        # Last-K (snapshot, verdict) ring — always on (cheap: K dict
        # refs), so a flight record has history even when the breach
        # lands on the first watchdog tick after a long healthy run.
        self.history: collections.deque = collections.deque(
            maxlen=max(1, int(history))
        )
        self.watchdog = None
        if slos:
            from blendjax_torch.obs.watchdog import SloWatchdog

            self.watchdog = SloWatchdog(slos)
        self.flight = None
        if flight_dir:
            from blendjax_torch.obs.watchdog import FlightRecorder

            # checkpoint_on_breach: zero-arg callable fired inside the
            # breach bundle dump — wire ``driver.request_checkpoint``
            # so a breached run snapshots at its next step boundary
            # (the JAX package's docs/checkpointing.md, "Checkpoint on breach").
            self.flight = FlightRecorder(
                flight_dir, profile_s=flight_profile_s,
                checkpoint=checkpoint_on_breach,
            )
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.last_verdict = None
        # The reporter tick is the device ledger's runtime cadence: the
        # HBM poll runs before each snapshot, and the ledger's retrace
        # storm can trip this reporter's flight recorder.
        from blendjax_torch.obs.devledger import ledger as _ledger

        self.ledger = _ledger
        if self.flight is not None:
            self.ledger.attach_flight(self.flight)

    def tick(self):
        """One report cycle (public so tests — and callers that want a
        verdict NOW — can run it synchronously)."""
        try:
            # device.hbm_* gauges land in the snapshot below; a no-stats
            # backend (CPU) returns None without publishing
            self.ledger.poll_memory(self.registry)
        except Exception:
            self.log.exception("device memory poll failed")
        report = self.registry.report()
        driver = self.driver_stats() if callable(self.driver_stats) else None
        verdict = diagnose(
            report, driver=driver,
            staleness_p95_s=self.lineage.staleness_p95_s(),
        )
        # Lock-free observability publish: one atomic reference
        # swap per tick; /healthz reads whole verdict objects.
        # bjx: ignore[BJX117] — atomic reference publish, as blendjax/obs/reporter.py:148
        self.last_verdict = verdict
        self.log.info("%s", verdict.render())
        self.history.append({
            "t": time.time(),
            "doctor": {
                "kind": verdict.kind,
                "reason": verdict.reason,
                "shares": verdict.shares,
            },
            "report": report,
        })
        if self.watchdog is not None:
            self._evaluate_slos(report, verdict)
        if self._jsonl is not None:
            extra = {
                "doctor": {
                    "kind": verdict.kind,
                    "reason": verdict.reason,
                    "shares": verdict.shares,
                },
                "lineage": self.lineage.report(),
            }
            if self.watchdog is not None:
                extra["slo"] = self.watchdog.state()
            if self.fleet is not None:
                try:
                    extra["fleet"] = self.fleet.state()
                except Exception:
                    self.log.exception("fleet state snapshot failed")
            # Echoing runs get their accounting surfaced beside the
            # verdict (fresh/echoed counters sum exactly to drawn
            # samples; the echo-mitigated/saturated arms read these).
            echo = {
                k: v
                for src in (report.get("counters", {}),
                            report.get("gauges", {}))
                for k, v in src.items()
                if k.startswith("echo.")
            }
            if echo:
                extra["echo"] = echo
            # Device ledger family beside the verdict: the static
            # compile-time accounting gauges plus the live HBM poll and
            # retrace counter, so a JSONL trail answers "what did the
            # device look like when the verdict flipped".
            device = {
                k: v
                for src in (report.get("counters", {}),
                            report.get("gauges", {}))
                for k, v in src.items()
                if k.startswith("device.")
            }
            if device:
                extra["device"] = device
            self._jsonl.write(report, extra=extra)
        return verdict

    def _evaluate_slos(self, report: dict, verdict) -> None:
        result = self.watchdog.evaluate(report, verdict=verdict)
        # Registry mirrors: the gauge is the scrapeable health bit, the
        # counter the lifetime breach count — both constant names.
        self.registry.gauge("slo.breached", 0 if result["healthy"] else 1)
        if result["newly_breached"]:
            self.registry.count(
                "slo.breach_events", len(result["newly_breached"])
            )
            names = [s["slo"] for s in result["newly_breached"]]
            self.log.warning(
                "SLO breach: %s (values %s)",
                names,
                {s["slo"]: s["value"] for s in result["newly_breached"]},
            )
            if self.flight is not None:
                try:
                    self.flight.dump(
                        reason=f"slo-breach: {'; '.join(names)}",
                        history=list(self.history),
                        lineage_report=self.lineage.report(),
                        slo_states=result["states"],
                        registry=self.registry,
                    )
                except Exception:
                    # evidence capture must never take the reporter down
                    self.log.exception("flight-record dump failed")
        for spec in result["newly_recovered"]:
            self.log.info("SLO recovered: %s", spec)

    # -- health (the /healthz source) -----------------------------------------

    @property
    def healthy(self) -> bool:
        return self.watchdog is None or self.watchdog.healthy

    def health(self) -> dict:
        """State dict for the HTTP exporter's ``/healthz`` endpoint:
        ``start_http_exporter(health=reporter.health)``."""
        out = {
            "healthy": self.healthy,
            "verdict": getattr(self.last_verdict, "kind", None),
        }
        if self.watchdog is None:
            out["slo"] = "unconfigured"
        else:
            out["slo"] = self.watchdog.state()
        return out

    def _run(self) -> None:
        # wait-first loop: a reporter started beside an empty pipeline
        # shouldn't open with a meaningless "idle" line
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # a reporting flake must not kill the run
                self.log.exception("stats reporter tick failed")

    def start(self) -> "StatsReporter":
        assert self._thread is None, "already started"
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="blendjax-stats-reporter", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, final_tick: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if final_tick:
            try:
                self.tick()  # closing snapshot: the run's last word
            except Exception:
                self.log.exception("final stats tick failed")

    def __enter__(self) -> "StatsReporter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
