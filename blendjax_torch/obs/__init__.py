"""blendjax_torch.obs — end-to-end pipeline telemetry (the port of
``blendjax/obs``; the fleet view of many processes waits for the
multi-GPU slice, ROADMAP Queue A item 5).

- :mod:`~blendjax_torch.obs.lineage` — frame lineage: per-producer
  staleness histograms, exact gap/reorder/restart counts and the
  producers' piggybacked telemetry.
- :mod:`~blendjax_torch.obs.doctor` — the stall doctor: names the current
  bound from one metrics snapshot.
- :mod:`~blendjax_torch.obs.devledger` — the device ledger: per-graph
  FLOPs and memory, live HBM gauges, the retrace audit (``device.*``).
- :mod:`~blendjax_torch.obs.exporters` — Prometheus text over a stdlib
  HTTP endpoint, JSONL snapshots, Chrome/Perfetto traces.
- :mod:`~blendjax_torch.obs.reporter` — ``StatsReporter``, the thread that
  logs a verdict per interval, archives snapshots and evaluates SLOs.
- :mod:`~blendjax_torch.obs.trace` — sampled frame traces from publish to
  step retirement.
- :mod:`~blendjax_torch.obs.watchdog` — ``Slo`` rules with sustained-
  breach windows and the ``FlightRecorder``.

Metric names, report shapes, stamps and exposition are the JAX package's,
so the two packages' producers, consumers and dashboards mix.
"""

from __future__ import annotations

from blendjax_torch.obs.devledger import (  # noqa: F401
    ExecutableLedger,
    RetraceAudit,
    default_peak_flops,
    ledger,
    measure_model_flops,
)
from blendjax_torch.obs.doctor import (  # noqa: F401
    DEFAULT_HBM_HEADROOM_FLOOR,
    DEFAULT_RETRACE_STORM,
    DEFAULT_STALE_WIRE_S,
    VERDICTS,
    Verdict,
    diagnose,
    diagnose_current,
)
from blendjax_torch.obs.exporters import (  # noqa: F401
    JsonlExporter,
    MetricsHTTPServer,
    chrome_trace,
    prometheus_text,
    start_http_exporter,
    write_chrome_trace,
)
from blendjax_torch.obs.lineage import (  # noqa: F401
    FrameLineage,
    lineage,
    strip_stamps,
)
from blendjax_torch.obs.reporter import StatsReporter  # noqa: F401
from blendjax_torch.obs.trace import (  # noqa: F401
    TRACE_KEY,
    FrameTraceCollector,
    tracer,
)
from blendjax_torch.obs.watchdog import (  # noqa: F401
    FlightRecorder,
    Slo,
    SloWatchdog,
)

__all__ = [
    "TRACE_KEY",
    "FrameTraceCollector",
    "tracer",
    "FlightRecorder",
    "Slo",
    "SloWatchdog",
    "ExecutableLedger",
    "RetraceAudit",
    "default_peak_flops",
    "ledger",
    "measure_model_flops",
    "DEFAULT_HBM_HEADROOM_FLOOR",
    "DEFAULT_RETRACE_STORM",
    "DEFAULT_STALE_WIRE_S",
    "VERDICTS",
    "Verdict",
    "diagnose",
    "diagnose_current",
    "JsonlExporter",
    "MetricsHTTPServer",
    "chrome_trace",
    "prometheus_text",
    "start_http_exporter",
    "write_chrome_trace",
    "FrameLineage",
    "lineage",
    "strip_stamps",
    "StatsReporter",
]
