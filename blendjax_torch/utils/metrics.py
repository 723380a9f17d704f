"""Lightweight metrics: counters, gauges, exact histograms, timing spans
(copied from ``blendjax/utils/metrics.py``: the same names, buckets and
report shape, so either package's exporters and doctor read the other's
snapshots).

The port instruments the whole producer → wire →
ingest → train pipeline so feed stalls are diagnosable: per-stage spans
feed lock-exact log-bucketed histograms (p50/p95/p99, not just means —
the mean hides exactly the tail a stall doctor needs), queue-depth
gauges, and a one-line report. ``blendjax_torch.obs`` builds the cross-process
layer on top: frame lineage, the stall doctor, and the Prometheus /
JSONL / Chrome-trace exporters. For deep device-side dives, ``trace``
wraps ``torch.profiler.profile`` (host and CUDA activities) and writes a
Chrome trace of the block into its log directory.
"""

from __future__ import annotations

import contextlib
import math
import threading
import time
from collections import defaultdict, deque

from blendjax_torch.utils.tg import guard

# 8 buckets per octave: bucket bounds grow by 2**(1/8) ≈ 9.05%, so a
# quantile read from the bucket midpoint is within ~4.4% of the true
# value — tight enough to tell a 2x tail regression apart, cheap enough
# (one log + one dict bump) for the ingest hot path.
_GAMMA = 2.0 ** 0.125
_LOG_GAMMA = math.log(_GAMMA)


class Histogram:
    """Exact-count log-bucketed histogram.

    COUNTS are exact (every ``observe`` lands in exactly one bucket;
    bucket counts always sum to ``count`` — the property ``chip_smoke.py``'s
    "histogram counts sum exactly to span counts" acceptance check
    rides on); VALUES are bucketed at ~9% geometric resolution, with
    exact ``min``/``max``/``sum`` kept alongside so p0/p100 and the
    mean never suffer bucketing error. Not self-locking: the owning
    :class:`Metrics` registry serializes access under its one lock.
    """

    __slots__ = (
        "count", "total", "min", "max", "zeros", "nonfinite", "buckets",
    )

    def __init__(self) -> None:
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        # Non-positive observations (e.g. cross-host staleness under
        # clock skew) can't take a log: they get their own bucket below
        # every log bucket, so ordering — and therefore quantiles —
        # stays correct.
        self.zeros = 0
        # NaN/inf observations (a producer with a corrupted clock can
        # put one on the wire as a staleness input) are counted here
        # and otherwise ignored: math.log would raise and kill the
        # observing thread — the ingest loop, for lineage — over one
        # bad telemetry stamp.
        self.nonfinite = 0
        self.buckets: dict = {}

    def observe(self, value) -> None:
        v = float(value)
        if not math.isfinite(v):
            self.nonfinite += 1
            return
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if v <= 0.0:
            self.zeros += 1
            return
        idx = math.floor(math.log(v) / _LOG_GAMMA)
        self.buckets[idx] = self.buckets.get(idx, 0) + 1

    def quantile(self, q: float) -> float:
        """Value at quantile ``q`` in [0, 1] (bucket-midpoint estimate,
        clamped to the exact observed [min, max])."""
        if self.count == 0:
            return 0.0
        if q <= 0.0:
            return self.min
        if q >= 1.0:
            return self.max
        rank = q * (self.count - 1)
        seen = self.zeros
        if rank < seen:
            return min(self.min, 0.0)
        for idx in sorted(self.buckets):
            seen += self.buckets[idx]
            if rank < seen:
                mid = _GAMMA ** (idx + 0.5)
                return min(max(mid, self.min), self.max)
        return self.max

    def summary(self) -> dict:
        if self.count == 0:
            out = {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                   "p50": 0.0, "p95": 0.0, "p99": 0.0}
            if self.nonfinite:
                out["nonfinite"] = self.nonfinite
            return out
        out = {
            "count": self.count,
            "sum": self.total,
            "min": self.min,
            "max": self.max,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }
        if self.nonfinite:
            out["nonfinite"] = self.nonfinite
        return out

    def state_dict(self) -> dict:
        """Snapshot for the session store (blendjax_torch.checkpoint):
        exact counts + bucket map; min/max only when observed (±inf
        sentinels don't belong in a wire document)."""
        d = {
            "count": self.count,
            "sum": self.total,
            "zeros": self.zeros,
            "nonfinite": self.nonfinite,
            "buckets": dict(self.buckets),
        }
        if self.count:
            d["min"] = self.min
            d["max"] = self.max
        return d

    def load_state_dict(self, d: dict) -> None:
        self.count = int(d["count"])
        self.total = float(d["sum"])
        self.zeros = int(d.get("zeros", 0))
        self.nonfinite = int(d.get("nonfinite", 0))
        self.buckets = {int(k): int(v) for k, v in d["buckets"].items()}
        self.min = float(d["min"]) if "min" in d else math.inf
        self.max = float(d["max"]) if "max" in d else -math.inf

    def cumulative_buckets(self) -> list:
        """``(upper_bound, cumulative_count)`` pairs in ascending bound
        order — the Prometheus histogram exposition shape (the exporter
        appends the implicit ``+Inf`` bucket itself)."""
        out = []
        cum = self.zeros
        if self.zeros:
            out.append((0.0, cum))
        for idx in sorted(self.buckets):
            cum += self.buckets[idx]
            out.append((_GAMMA ** (idx + 1), cum))
        return out


# bjx: thread-shared (every thread in the process reports here; one
# `_lock` makes each snapshot/update consistent — BJX117)
class Metrics:
    """Process-local registry. Thread-safe AND snapshot-exact: every
    mutation — counters, gauges, spans, histograms — runs under one
    lock (uncontended CPython lock acquire is ~100 ns — noise next to
    the per-batch work being counted, and the sharded ingest pool's
    ``wire.*``/``ingest.*`` pairs must sum EXACTLY, not approximately,
    for the compression/throughput evidence), and ``report()``
    reads a consistent snapshot under the same lock (a lock-free read
    raced worker mutation: torn gauge snapshots and a possible
    ``RuntimeError: dictionary changed size during iteration``).
    """

    def __init__(self):
        self._lock = threading.Lock()
        # threadguard wiring (blendjax_torch.utils.tg): under
        # BLENDJAX_THREADGUARD=1 a table touched without `_lock` held
        # raises at the access site; disabled, guard() is the identity
        # and these are the plain tables. The read-only dict surface of the two public tables is exempt: tests
        # and debug code read counters after quiescing, and the consistent-
        # snapshot path is report(), not the raw dict.
        reads = (
            "get", "keys", "items", "values", "copy",
            "__getitem__", "__iter__", "__len__", "__contains__",
        )
        self.counters: dict = guard(
            defaultdict(int), name="metrics.counters", lock=self._lock,
            exempt=reads,
        )
        self.gauges: dict = guard(
            {}, name="metrics.gauges", lock=self._lock, exempt=reads,
        )
        self._spans: dict = guard(  # count, total_s
            defaultdict(lambda: [0, 0.0]), name="metrics.spans",
            lock=self._lock,
        )
        self._hists: dict = guard(
            defaultdict(Histogram), name="metrics.hists", lock=self._lock
        )
        # Optional per-span event ring for Chrome-trace export
        # (blendjax_torch.obs.exporters.write_chrome_trace): disabled by
        # default — aggregates are always on, events are opt-in.
        self._events: deque | None = None

    def count(self, name: str, n: int = 1) -> None:
        # `dict[k] += n` is load/add/store bytecode — two workers
        # interleaving it lose increments. The lock makes the pair of
        # counters the ratios (compressed vs raw) read exact.
        with self._lock:
            self.counters[name] += n

    def counter_value(self, name: str) -> int:
        """Locked read of one counter's current value — for writers
        that derive a gauge from counters they also emit (the value
        then stays consistent with the counters in the same snapshot,
        across any ``reset()``)."""
        with self._lock:
            return self.counters.get(name, 0)

    def gauge(self, name: str, value) -> None:
        # Locked like everything else: a bare dict store is GIL-atomic,
        # but report()'s consistent snapshot needs writers excluded.
        with self._lock:
            self.gauges[name] = value

    def gauge_max(self, name: str, value) -> None:
        # High-water-mark gauge: read-max-store is a lost-update race
        # for concurrent writers (the sharded ingest pool), so the pair
        # runs under the counter lock.
        with self._lock:
            if value > self.gauges.get(name, value - 1):
                self.gauges[name] = value

    def observe(self, name: str, value) -> None:
        """Record one sample into the named histogram (lock-exact:
        concurrent observers never lose a count)."""
        with self._lock:
            self._hists[name].observe(value)

    def observe_many(self, name: str, values) -> None:
        """Record a batch of samples into one histogram under a SINGLE
        lock acquisition — for hot loops that produce a vector of
        observations per iteration (e.g. the echo reservoir's per-draw
        sample ages): one lock round trip instead of len(values)."""
        with self._lock:
            h = self._hists[name]
            for v in values:
                h.observe(v)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                s = self._spans[name]
                s[0] += 1
                s[1] += dt
                # Spans FEED the histogram of the same name, under the
                # same lock acquisition: histogram counts sum exactly
                # to span counts, by construction, at any concurrency.
                self._hists[name].observe(dt)
                if self._events is not None:
                    self._events.append(
                        (name, t0, dt, threading.get_ident())
                    )

    # -- span events (Chrome-trace source) -----------------------------------

    def enable_span_events(self, capacity: int = 200_000) -> None:
        """Start recording one ``(name, t0, dur_s, tid)`` event per span
        into a bounded ring (oldest dropped past ``capacity``).
        Timestamps are ``perf_counter`` seconds — the same clock the
        span aggregates use, so the exported trace lines up with spans
        taken anywhere in the process."""
        with self._lock:
            self._events = deque(self._events or (), maxlen=int(capacity))

    def disable_span_events(self) -> None:
        with self._lock:
            self._events = None

    def span_events(self) -> list:
        with self._lock:
            return list(self._events or ())

    # -- snapshots ------------------------------------------------------------

    def _spans_locked(self) -> dict:
        out = {}
        for k, (c, t) in self._spans.items():
            d = {
                "count": c,
                "total_s": t,
                "mean_ms": (t / c * 1e3) if c else 0.0,
            }
            h = self._hists.get(k)
            if h is not None and h.count:
                d["p50_ms"] = h.quantile(0.50) * 1e3
                d["p95_ms"] = h.quantile(0.95) * 1e3
                d["p99_ms"] = h.quantile(0.99) * 1e3
            out[k] = d
        return out

    def spans(self) -> dict:
        with self._lock:
            return self._spans_locked()

    def histograms(self) -> dict:
        with self._lock:
            return {k: h.summary() for k, h in self._hists.items()}

    def histogram_buckets(self) -> dict:
        """``name -> (cumulative_buckets, count, sum)`` snapshot — the
        raw-bucket view the Prometheus exporter renders."""
        with self._lock:
            return {
                k: (h.cumulative_buckets(), h.count, h.total)
                for k, h in self._hists.items()
            }

    def report(self, include_buckets: bool = False) -> dict:
        # One lock acquisition for the WHOLE snapshot: counters, gauges,
        # spans, and histograms are mutually consistent (no worker can
        # bump a counter between the copies). ``include_buckets`` adds
        # the raw cumulative-bucket view under the SAME lock, so an
        # exporter can render native histograms from the same snapshot
        # as the counters beside them (a separate histogram_buckets()
        # call races spans recorded in between).
        with self._lock:
            out = {
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "spans": self._spans_locked(),
                "histograms": {
                    k: h.summary() for k, h in self._hists.items()
                },
            }
            if include_buckets:
                out["histogram_buckets"] = {
                    k: (h.cumulative_buckets(), h.count, h.total)
                    for k, h in self._hists.items()
                }
            return out

    def reset(self) -> None:
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self._spans.clear()
            self._hists.clear()
            if self._events is not None:
                self._events.clear()


# Default process-wide registry (imports stay cheap: stdlib only).
metrics = Metrics()


# One profiler per process: a second torch.profiler session started
# inside an open one fails (or corrupts the first's records). The SLO
# watchdog's flight recorder may fire a capture at any moment — possibly
# inside a user's own open trace — so activation is tracked under a
# module lock and a nested trace degrades to a logged no-op instead of
# killing the run.
_trace_lock = threading.Lock()
_trace_active = False

#: File name of the Chrome trace :func:`trace` writes into its directory.
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` trace around a code block (host activity, and
    the card's kernels when CUDA is available); on exit the Chrome trace
    is exported to ``logdir/trace.json`` (load it in ui.perfetto.dev).
    Yields the ``torch.profiler.profile`` object, so the caller can read
    ``key_averages()`` after the block.

    Reentrancy-safe: if a trace is already active in this process, the
    nested call logs a warning, yields ``None`` and runs the block
    untraced instead of starting a second profiler — so a watchdog-
    triggered capture can never take down a run that was already being
    profiled.

    >>> with trace("/tmp/profile"):
    ...     for batch in pipeline: step(state, batch)
    """
    global _trace_active
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    with _trace_lock:
        already = _trace_active
        if not already:
            _trace_active = True
    if already:
        from blendjax_torch.utils.logging import get_logger

        get_logger("metrics").warning(
            "torch profiler trace already active: nested trace(%r) "
            "degrades to a no-op", logdir,
        )
        yield None
        return
    try:
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            yield prof
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))
    finally:
        with _trace_lock:
            _trace_active = False
