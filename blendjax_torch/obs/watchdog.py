"""SLO watchdog + flight recorder: breach detection with evidence capture
(copied from ``blendjax/obs/watchdog.py``).

The doctor only speaks when polled; the ROADMAP's fleet controller
and multi-host driver both need a *continuous, machine-readable* health
signal plus automatic evidence when it goes bad. Two pieces:

- :class:`Slo` / :class:`SloWatchdog` — declarative floor/ceiling rules
  over any counter **rate**, gauge, histogram **quantile**, or doctor
  verdict, evaluated against plain ``Metrics.report()`` snapshots (one
  per :class:`~blendjax_torch.obs.reporter.StatsReporter` tick) with
  sustained-breach windows, so a one-tick blip doesn't page anyone.
- :class:`FlightRecorder` — on a breach transition, dump a bounded
  diagnostic bundle to disk: the last-K metrics snapshots + doctor
  verdicts (the reporter's history ring), the span-event ring and
  completed frame traces as one Chrome trace, the raw frame-trace
  records, the lineage report, the breaching rule states, and an
  optional *guarded* ``torch.profiler`` capture of the next few seconds
  (a no-op with a warning if a user trace is already open — see the
  reentrancy-safe :func:`blendjax_torch.utils.metrics.trace`).

The HTTP exporter serves the watchdog state at ``/healthz`` (200/503)
beside ``/metrics`` — the admission/scaling signal a fleet controller
consumes. Wire all of it through
``StatsReporter(slos=..., flight_dir=...)`` (the JAX package's
docs/observability.md, "SLOs and the flight recorder", describes the same
surface).

Rule spec grammar (``Slo.parse``)::

    rate(echo.fresh) >= 80          # counter rate, per second between ticks
    rate(wire.seq_gaps) == 0        # exact-zero floor on a drop counter
    p95(wire.e2e_staleness_s) <= 0.5   # histogram quantile (source unit)
    gauge(train.mfu) >= 0.01        # gauge floor
    doctor != wire-bound            # verdict rule (string compare)
    rate(echo.saturated_waits) == 0 @ 30   # sustain: breach must hold 30s

Everything stdlib-only and import-cheap (no torch until a profiler
capture actually starts), like the rest of ``blendjax_torch.obs``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
import time

from blendjax_torch.utils.logging import get_logger
from blendjax_torch.utils.metrics import metrics

logger = get_logger("obs")

_OPS = {
    "<=": lambda v, t: v <= t,
    ">=": lambda v, t: v >= t,
    "==": lambda v, t: v == t,
    "!=": lambda v, t: v != t,
    "<": lambda v, t: v < t,
    ">": lambda v, t: v > t,
}

_SPEC_RE = re.compile(
    r"^\s*(?P<target>[^<>=!]+?)\s*(?P<op><=|>=|==|!=|<|>)\s*"
    r"(?P<value>[^@]+?)\s*(?:@\s*(?P<sustain>[0-9.]+)\s*s?\s*)?$"
)
_FUNC_RE = re.compile(
    r"^(?P<fn>rate|gauge|counter|p50|p95|p99)\s*\(\s*(?P<metric>[^)]+?)\s*\)$"
)


@dataclasses.dataclass(frozen=True)
class Slo:
    """One declarative rule: ``kind`` is how the value is read from a
    report snapshot (``rate``/``gauge``/``counter``/``quantile``/
    ``doctor``), ``op``+``threshold`` the bound, ``sustain_s`` how long
    the violation must hold continuously before it counts as a breach.
    ``spec`` keeps the original text for logs and bundle files."""

    spec: str
    kind: str
    metric: str
    op: str
    threshold: float | str
    quantile: str = "p95"
    sustain_s: float = 0.0

    @classmethod
    def parse(cls, spec: str) -> "Slo":
        m = _SPEC_RE.match(spec)
        if not m:
            raise ValueError(
                f"unparseable SLO spec {spec!r} (expected e.g. "
                "'rate(wire.seq_gaps) == 0', 'p95(wire.e2e_staleness_s) "
                "<= 0.5 @ 30', 'doctor != wire-bound')"
            )
        target = m.group("target").strip()
        op = m.group("op")
        raw_value = m.group("value").strip()
        sustain = float(m.group("sustain") or 0.0)
        if target == "doctor":
            if op not in ("==", "!="):
                raise ValueError(
                    f"doctor SLOs compare verdict kinds with == / != "
                    f"(got {op!r} in {spec!r})"
                )
            return cls(spec=spec, kind="doctor", metric="doctor", op=op,
                       threshold=raw_value, sustain_s=sustain)
        fm = _FUNC_RE.match(target)
        if fm:
            fn, metric = fm.group("fn"), fm.group("metric")
        else:
            # bare name: a gauge (the most common always-on signal)
            fn, metric = "gauge", target
        try:
            value = float(raw_value)
        except ValueError:
            raise ValueError(
                f"SLO threshold {raw_value!r} is not a number ({spec!r})"
            ) from None
        if fn in ("p50", "p95", "p99"):
            return cls(spec=spec, kind="quantile", metric=metric, op=op,
                       threshold=value, quantile=fn, sustain_s=sustain)
        return cls(spec=spec, kind=fn, metric=metric, op=op,
                   threshold=value, sustain_s=sustain)


class SloWatchdog:
    """Evaluate a rule set against successive report snapshots.

    Pure over plain dicts (no registry coupling, no side effects beyond
    its own breach state) so tests — and the flight-record bundle —
    exercise every arm synthetically. Counter rates are computed
    between consecutive ``evaluate`` calls; the first call therefore
    reports rates as "no evidence yet" (healthy)."""

    def __init__(self, slos):
        self.slos = [
            Slo.parse(s) if isinstance(s, str) else s for s in slos
        ]
        # One RLock over all breach state: evaluate() runs on the
        # reporter thread while /healthz serves state() from the HTTP
        # exporter's thread — an unlocked sorted(self._breached) there
        # can throw "set changed size during iteration" mid-breach
        # (BJX117; reentrant because evaluate reads `healthy` itself).
        self._lock = threading.RLock()
        self._prev: tuple | None = None  # (t_mono, counters snapshot)
        self._breach_start: dict = {}
        self._breached: set = set()
        self.breach_events = 0
        self.last_states: list = []

    @property
    def healthy(self) -> bool:
        with self._lock:
            return not self._breached

    def _value(self, slo: Slo, report: dict, verdict, now: float):
        if slo.kind == "doctor":
            if verdict is None:
                return None
            return getattr(verdict, "kind", verdict)
        if slo.kind == "gauge":
            return report.get("gauges", {}).get(slo.metric)
        if slo.kind == "counter":
            # absent counter = no evidence yet (rules bind once the
            # metric exists), NOT an implicit zero
            return report.get("counters", {}).get(slo.metric)
        if slo.kind == "quantile":
            h = report.get("histograms", {}).get(slo.metric)
            if not h or not h.get("count"):
                return None
            return h.get(slo.quantile)
        # rate: delta over the previous evaluate call
        if self._prev is None:
            return None
        t0, prev = self._prev
        dt = now - t0
        if dt <= 0:
            return None
        counters = report.get("counters", {})
        if slo.metric not in counters and slo.metric not in prev:
            # the counter has never existed: no evidence, not rate 0 —
            # a floor rule must not breach before the pipeline has even
            # started producing the metric (slow producer spin-up)
            return None
        return (
            counters.get(slo.metric, 0) - prev.get(slo.metric, 0)
        ) / dt

    def evaluate(self, report: dict, verdict=None,
                 now: float | None = None) -> dict:
        """One evaluation pass. Returns ``{"healthy", "states",
        "newly_breached", "newly_recovered"}``; ``states`` carries one
        entry per rule with the observed value and its breach state."""
        now = time.monotonic() if now is None else now
        with self._lock:
            return self._evaluate_locked(report, verdict, now)

    def _evaluate_locked(self, report: dict, verdict, now: float) -> dict:
        was_breached = set(self._breached)
        states: list = []
        newly_recovered: list = []
        for slo in self.slos:
            value = self._value(slo, report, verdict, now)
            ok = True if value is None else _OPS[slo.op](
                value, slo.threshold
            )
            if ok:
                self._breach_start.pop(slo.spec, None)
                if slo.spec in self._breached:
                    self._breached.discard(slo.spec)
                    newly_recovered.append(slo.spec)
            else:
                t0 = self._breach_start.setdefault(slo.spec, now)
                if now - t0 >= slo.sustain_s:
                    self._breached.add(slo.spec)
            states.append({
                "slo": slo.spec,
                "value": value,
                "ok": ok,
                "breached": slo.spec in self._breached,
                "violating_for_s": (
                    round(now - self._breach_start[slo.spec], 3)
                    if slo.spec in self._breach_start else 0.0
                ),
            })
        self._prev = (now, dict(report.get("counters", {})))
        self.last_states = states
        newly_breached = [
            s for s in states
            if s["breached"] and s["slo"] not in was_breached
        ]
        if newly_breached:
            # one event per newly-breached RULE, matching the
            # reporter's slo.breach_events registry counter — the two
            # published totals must agree whichever surface is read
            self.breach_events += len(newly_breached)
        return {
            "healthy": self.healthy,
            "states": states,
            "newly_breached": newly_breached,
            "newly_recovered": newly_recovered,
        }

    def state(self) -> dict:
        with self._lock:
            return {
                "healthy": self.healthy,
                "breached": sorted(self._breached),
                "breach_events": self.breach_events,
                "states": self.last_states,
            }


class FlightRecorder:
    """Dump bounded diagnostic bundles on SLO breaches.

    Each ``dump()`` writes one ``flight-<n>/`` directory under
    ``directory`` containing:

    - ``breach.json`` — reason, timestamp, the full SLO rule states
    - ``snapshots.jsonl`` — the reporter's last-K history entries
      (metrics report + doctor verdict per tick)
    - ``lineage.json`` — the per-producer lineage report
    - ``trace.json`` — span-event ring + completed frame traces as one
      Chrome/Perfetto trace (load in ui.perfetto.dev)
    - ``frame_traces.json`` — the raw completed frame-trace records
    - ``profile/`` — optional ``torch.profiler`` capture of the next
      ``profile_s`` seconds (guarded: degrades to a no-op when a user
      trace is already open, never raises into the reporter thread)

    At most ``max_bundles`` bundles are kept (oldest deleted), so a
    flapping SLO cannot fill the disk.
    """

    def __init__(self, directory: str, max_bundles: int = 4,
                 profile_s: float = 0.0, keep_traces: int = 64,
                 checkpoint=None):
        self.directory = directory
        self.max_bundles = max(1, int(max_bundles))
        self.profile_s = float(profile_s)
        self.keep_traces = int(keep_traces)
        # Checkpoint-on-breach arm: a zero-arg
        # callable — typically ``driver.request_checkpoint``, which
        # flags the TRAIN thread to snapshot at its next step boundary
        # (the recorder must never serialize device state from the
        # reporter thread itself). Its invocation + return value are
        # recorded in the bundle's checkpoint.json.
        self.checkpoint = checkpoint
        self._lock = threading.Lock()
        os.makedirs(directory, exist_ok=True)
        # Resume numbering after existing bundles: a restarted run must
        # not reuse flight-0001 (mixing two incidents' artifacts in one
        # directory, and sorting itself to the front of the prune line).
        self._seq = max(
            (
                int(d.rsplit("-", 1)[1])
                for d in os.listdir(directory)
                if d.startswith("flight-")
                and d.rsplit("-", 1)[1].isdigit()
            ),
            default=0,
        )

    def dump(self, reason: str = "slo-breach", history=(),
             lineage_report: dict | None = None,
             slo_states=None, registry=metrics,
             frame_tracer=None) -> str:
        """Write one bundle; returns its path. Never raises into the
        caller for partial-evidence failures — each artifact is written
        independently and a broken one is logged and skipped."""
        from blendjax_torch.obs.exporters import write_chrome_trace

        if frame_tracer is None:
            from blendjax_torch.obs.trace import tracer as frame_tracer
        with self._lock:
            self._seq += 1
            bundle = os.path.join(
                self.directory, f"flight-{self._seq:04d}"
            )
            os.makedirs(bundle, exist_ok=True)
            self._prune_locked()
        def _write(name, fn):
            try:
                fn(os.path.join(bundle, name))
            except Exception:
                logger.exception("flight recorder: %s failed", name)

        def _json(obj, indent=None):
            def writer(p):
                with open(p, "w", encoding="utf-8") as f:
                    json.dump(obj, f, default=str, indent=indent)
            return writer

        def _snapshots(p):
            with open(p, "w", encoding="utf-8") as f:
                for entry in history:
                    f.write(json.dumps(entry, default=str) + "\n")

        _write("breach.json", _json(
            {"t": time.time(), "reason": reason, "slo": slo_states},
            indent=2,
        ))
        _write("snapshots.jsonl", _snapshots)
        if lineage_report is not None:
            _write("lineage.json", _json(lineage_report, indent=2))
        _write("trace.json", lambda p: write_chrome_trace(
            p, registry=registry, frame_traces=frame_tracer,
        ))
        _write("frame_traces.json", _json({
            "report": frame_tracer.report(),
            "records": frame_tracer.records()[-self.keep_traces:],
        }))

        def _device_ledger(p):
            from blendjax_torch.obs.devledger import ledger

            with open(p, "w", encoding="utf-8") as f:
                json.dump(ledger.report(), f, default=str, indent=2)

        # per-signature cost/memory/collective accounting + retrace
        # events + last HBM sample — what the device was doing when the
        # breach (or retrace storm) fired
        _write("device_ledger.json", _device_ledger)
        if self.checkpoint is not None:
            def _ckpt_arm(p):
                result = self.checkpoint()
                with open(p, "w", encoding="utf-8") as f:
                    json.dump(
                        {
                            "t": time.time(),
                            "requested": True,
                            "result": result,
                        },
                        f, default=str, indent=2,
                    )
            _write("checkpoint.json", _ckpt_arm)
        if self.profile_s > 0:
            t = threading.Thread(
                target=self._profile,
                args=(os.path.join(bundle, "profile"),),
                name="blendjax-flight-profile", daemon=True,
            )
            t.start()
        logger.warning("flight record written: %s (%s)", bundle, reason)
        return bundle

    def _prune_locked(self) -> None:
        bundles = sorted(
            d for d in os.listdir(self.directory)
            if d.startswith("flight-")
            and os.path.isdir(os.path.join(self.directory, d))
        )
        while len(bundles) > self.max_bundles:
            victim = bundles.pop(0)
            shutil.rmtree(
                os.path.join(self.directory, victim), ignore_errors=True
            )

    def _profile(self, logdir: str) -> None:
        """Guarded post-breach profiler capture: the reentrancy-safe
        :func:`blendjax_torch.utils.metrics.trace` degrades to a warning
        no-op when a user trace is already open, and any backend error
        (no card, a profiler error) is logged, never raised."""
        try:
            from blendjax_torch.utils.metrics import trace

            with trace(logdir):
                time.sleep(self.profile_s)
        except Exception:
            logger.exception("flight recorder: profiler capture failed")
