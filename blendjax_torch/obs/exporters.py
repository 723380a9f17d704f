"""Exporters: Prometheus text endpoint, JSONL snapshots, Chrome trace
(copied from ``blendjax/obs/exporters.py``: the same metric names and
exposition, so one scrape configuration reads either package).

Everything here is stdlib-only (``http.server``, ``json``, ``re``) so a
producer process — Blender's Python — can export its own metrics
without torch, zmq, or numpy.

Three sinks, one source (:meth:`blendjax_torch.utils.metrics.Metrics.report`
plus the optional :meth:`blendjax_torch.obs.lineage.FrameLineage.report`):

- :func:`prometheus_text` / :func:`start_http_exporter` — the pull
  model: a ``GET /metrics`` endpoint in Prometheus text exposition
  format (counters as ``_total``, gauges as-is, histograms as native
  cumulative ``_bucket``/``_sum``/``_count`` series, per-producer
  lineage as labeled series with bounded label cardinality).
- :class:`JsonlExporter` — the archive model: append one
  timestamped JSON line per snapshot.
- :func:`chrome_trace` / :func:`write_chrome_trace` — the deep-dive
  model: span events as Chrome/Perfetto "complete" (``ph: "X"``)
  events, loadable in ``chrome://tracing`` / ui.perfetto.dev next to a
  ``torch.profiler`` trace of the same run (enable event recording first:
  ``metrics.enable_span_events()``).
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from blendjax_torch.utils.metrics import Metrics, metrics

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _prom_name(name: str, prefix: str = "blendjax_") -> str:
    """Sanitize a dotted metric name into the Prometheus grammar
    (``wire.raw_bytes`` -> ``blendjax_wire_raw_bytes``)."""
    out = prefix + _NAME_RE.sub("_", name)
    if not re.match(r"[a-zA-Z_:]", out[0]):
        out = "_" + out
    return out


def _num(v) -> str:
    """Prometheus sample value rendering (floats stay floats; bools and
    non-numbers degrade to 1/0 rather than invalidating the page)."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, (int, float)):
        return repr(float(v)) if isinstance(v, float) else str(v)
    return "0"


def prometheus_text(report: dict | None = None,
                    lineage_report: dict | None = None,
                    registry: Metrics = metrics) -> str:
    """Render one snapshot as Prometheus text exposition format.

    ``report`` defaults to a fresh ``registry.report()``;
    ``lineage_report`` defaults to the process-wide lineage tracker's
    snapshot. Histograms (which include every span's duration
    distribution) are emitted as native cumulative-bucket histograms in
    their source unit (seconds for spans).
    """
    if report is None:
        # include_buckets: the native-histogram buckets come from the
        # SAME locked snapshot as the counters/gauges/spans, so a page
        # can never pair one snapshot's counters with another's
        # histogram series.
        report = registry.report(include_buckets=True)
    if lineage_report is None:
        from blendjax_torch.obs.lineage import lineage

        lineage_report = lineage.report()
    lines: list = []

    for name in sorted(report.get("counters", {})):
        pn = _prom_name(name) + "_total"
        lines.append(f"# TYPE {pn} counter")
        lines.append(f"{pn} {_num(report['counters'][name])}")

    for name in sorted(report.get("gauges", {})):
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} gauge")
        lines.append(f"{pn} {_num(report['gauges'][name])}")

    # Native histograms need the raw buckets: prefer the ones carried
    # in the report snapshot itself (same lock acquisition as the
    # counters above); a caller-provided report without them falls
    # back to a fresh locked snapshot from ``registry`` — consistent
    # only if that is the registry the report came from.
    hists = report.get("histogram_buckets")
    if hists is None:
        hists = registry.histogram_buckets()
    for name in sorted(hists):
        buckets, count, total = hists[name]
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} histogram")
        for le, cum in buckets:
            lines.append(f'{pn}_bucket{{le="{le!r}"}} {cum}')
        lines.append(f'{pn}_bucket{{le="+Inf"}} {count}')
        lines.append(f"{pn}_sum {_num(total)}")
        lines.append(f"{pn}_count {count}")

    if lineage_report:
        # Metric-major emission: the exposition format requires every
        # line of one metric name to form a single contiguous group —
        # interleaving btids across names (btid-major) is rejected by
        # strict parsers (promtool/OpenMetrics) exactly in the
        # multi-producer case this export exists for.
        btids = sorted(lineage_report)
        sn = "blendjax_producer_e2e_staleness_ms"
        lines.append(f"# TYPE {sn} summary")
        for btid in btids:
            stale = lineage_report[btid].get("e2e_staleness_ms", {})
            for q, key in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
                if key in stale:
                    lines.append(
                        f'{sn}{{btid="{btid}",quantile="{q}"}} '
                        f"{_num(stale[key])}"
                    )
        for key, metric in (
            ("received", "blendjax_producer_frames_total"),
            ("seq_gaps", "blendjax_producer_seq_gaps_total"),
            ("seq_reorders", "blendjax_producer_seq_reorders_total"),
            ("restarts", "blendjax_producer_restarts_total"),
        ):
            lines.append(f"# TYPE {metric} counter")
            for btid in btids:
                lines.append(
                    f'{metric}{{btid="{btid}"}} '
                    f"{_num(lineage_report[btid].get(key, 0))}"
                )
    return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    server: "MetricsHTTPServer"

    def do_GET(self):  # noqa: N802 (http.server API)
        if self.path.split("?", 1)[0] == "/healthz":
            self._serve_health()
            return
        try:
            body = prometheus_text(registry=self.server.registry).encode()
        except Exception as e:  # never take the scrape target down
            self.send_response(500)
            self.end_headers()
            self.wfile.write(repr(e).encode())
            return
        self.send_response(200)
        self.send_header("Content-Type", PROMETHEUS_CONTENT_TYPE)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _serve_health(self) -> None:
        """``/healthz``: 200 when the configured health source says
        healthy (or when none is configured — an exporter without SLOs
        is a metrics endpoint, not a judge), 503 on an active SLO
        breach. The body is the health source's full state as JSON, so
        a fleet controller gets the breaching rules, not just a bit."""
        health = self.server.health
        try:
            state = health() if callable(health) else None
        except Exception as e:
            self.send_response(500)
            self.end_headers()
            self.wfile.write(repr(e).encode())
            return
        if state is None:
            state = {"healthy": True, "slo": "unconfigured"}
        elif not isinstance(state, dict):
            state = {"healthy": bool(state)}
        body = json.dumps(state, default=str).encode()
        self.send_response(200 if state.get("healthy", True) else 503)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # silence per-scrape stderr spam
        del args


class MetricsHTTPServer(ThreadingHTTPServer):
    """Prometheus scrape target on a daemon thread. ``port=0`` picks a
    free port; read it back from :attr:`port`. Close with
    :meth:`close`. ``health`` is an optional zero-arg callable (e.g.
    ``StatsReporter.health``) returning a dict with a ``healthy`` key:
    it backs the ``/healthz`` endpoint (200/503) beside ``/metrics``."""

    daemon_threads = True

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 registry: Metrics = metrics, health=None):
        super().__init__((host, port), _Handler)
        self.registry = registry
        self.health = health
        self.port = self.server_address[1]
        self._thread = threading.Thread(
            target=self.serve_forever, name="blendjax-metrics-http",
            daemon=True,
        )

    def start(self) -> "MetricsHTTPServer":
        self._thread.start()
        return self

    def close(self) -> None:
        self.shutdown()
        self.server_close()


def start_http_exporter(port: int = 0, host: str = "127.0.0.1",
                        registry: Metrics = metrics,
                        health=None) -> MetricsHTTPServer:
    """``curl http://host:port/metrics`` (and ``/healthz``, when a
    ``health`` source is given) while the pipeline runs."""
    return MetricsHTTPServer(
        host=host, port=port, registry=registry, health=health
    ).start()


class JsonlExporter:
    """Append timestamped report snapshots to a JSONL file (one JSON
    object per line; safe to tail while the run is live).

    ``rotate_bytes`` bounds the archive: once the file reaches that
    size it is rotated to ``<path>.1`` (older generations shift to
    ``.2`` … ``.<keep>``, the oldest deleted), so a long run's
    ``run_stats.jsonl`` can no longer grow without limit. ``None``
    (the default here; :class:`blendjax_torch.obs.reporter.StatsReporter`
    turns rotation on) keeps the historical append-forever behavior."""

    def __init__(self, path: str, rotate_bytes: int | None = None,
                 keep: int = 3):
        self.path = path
        self.rotate_bytes = int(rotate_bytes) if rotate_bytes else None
        self.keep = max(1, int(keep))
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._lock = threading.Lock()

    def write(self, report: dict | None = None,
              extra: dict | None = None,
              registry: Metrics = metrics) -> None:
        if report is None:
            report = registry.report()
        rec = {"t": time.time(), "report": report}
        if extra:
            rec.update(extra)
        line = json.dumps(rec, default=str)
        with self._lock:
            with open(self.path, "a", encoding="utf-8") as f:
                f.write(line + "\n")
                size = f.tell()
            if self.rotate_bytes and size >= self.rotate_bytes:
                self._rotate_locked()

    def _rotate_locked(self) -> None:
        # shift .1 -> .2 ... .<keep-1> -> .<keep> (overwriting the
        # oldest), then the live file becomes .1 — a fresh append
        # starts the next generation.
        for i in range(self.keep - 1, 0, -1):
            src = f"{self.path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i + 1}")
        os.replace(self.path, f"{self.path}.1")


def chrome_trace(events: list | None = None,
                 registry: Metrics = metrics,
                 frame_traces=None) -> dict:
    """Span events → a Chrome trace object (``traceEvents`` with
    ``ph: "X"`` complete events, microsecond timestamps on the
    ``perf_counter`` clock). Load in ui.perfetto.dev beside a
    ``torch.profiler`` trace of the same window to line host-side ingest
    stages up with device activity.

    Completed distributed frame traces (:mod:`blendjax_torch.obs.trace`) are
    merged in as cross-process lanes with producer→consumer flow
    arrows: pass a :class:`~blendjax_torch.obs.trace.FrameTraceCollector` as
    ``frame_traces``, or leave the default — exporting the process-wide
    registry pulls the process-wide ``tracer`` in automatically
    (``frame_traces=False`` opts out)."""
    if events is None:
        events = registry.span_events()
    pid = os.getpid()
    trace_events = [
        {
            "name": name,
            "cat": name.split(".", 1)[0],
            "ph": "X",
            "ts": round(t0 * 1e6, 3),
            "dur": round(dur * 1e6, 3),
            "pid": pid,
            "tid": tid,
        }
        for name, t0, dur, tid in events
    ]
    if frame_traces is None and registry is metrics:
        from blendjax_torch.obs.trace import tracer as frame_traces
    if frame_traces:
        trace_events.extend(frame_traces.chrome_events())
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, events: list | None = None,
                       registry: Metrics = metrics,
                       frame_traces=None) -> int:
    """Write the Chrome trace JSON; returns the event count. Requires
    event recording to have been on (``metrics.enable_span_events()``)
    or completed frame traces in the collector — without either the
    trace is valid but empty."""
    obj = chrome_trace(events, registry=registry, frame_traces=frame_traces)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f)
    return len(obj["traceEvents"])
