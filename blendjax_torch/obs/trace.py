"""Frame-level distributed tracing: sampled end-to-end frame timelines
(copied from ``blendjax/obs/trace.py``; the stage names, the wire shape of
``_trace`` and the transition histograms are the JAX package's, so a trace
stamped by either package's publisher completes in either consumer).

Lineage answers "how old are frames on arrival, per producer";
this module answers the question lineage can't: *where does one frame's
latency go* across the whole pipeline. Following the Dapper pattern
(sampled end-to-end traces beside always-on aggregates),
``DataPublisherSocket`` stamps every ``trace_every``-th message (default
64) with a ``_trace`` context — a tiny dict riding beside the existing
``_seq``/``_pub_*`` lineage stamps — and each downstream stage appends
``[stage, t_mono, t_wall]`` in place as the frame passes through:

==================  =========================================================
stage               where it is stamped
==================  =========================================================
``publish``         ``DataPublisherSocket._stamp`` (producer process)
``recv``            ``RemoteStream.__iter__`` (after lineage accounting)
``batch``           ``HostIngest``/``ShardedHostIngest`` handing the message
                    to batch assembly (or passing a prebatched one through)
``place``           ``DeviceFeeder.place`` after the host->device copies are
                    queued
``decode``          ``TileStreamDecoder.device_stage`` after the decode
                    kernels are queued (absent on the fused ``emit_packed``
                    path, where the decode lives inside the train step)
``reservoir_insert``  ``EchoingPipeline`` writing the sample into the ring
``reservoir_sample``  the frame's FIRST draw back out of the reservoir
``step_dispatch``   ``TrainDriver.submit``
``step_retire``     ``TrainDriver`` retiring the ring entry (terminal stage:
                    the driver hands the completed record to the collector)
==================  =========================================================

Clocks: every stamp carries BOTH ``time.monotonic()`` (duration-safe —
and comparable across processes on one host, where CLOCK_MONOTONIC is
system-wide) and ``time.time()`` (the only clock comparable across
hosts). Same-process transitions are measured on the monotonic clock;
the cross-process ``publish -> recv`` hop uses wall time, exactly like
lineage staleness.

Off the sampled path the cost is one dict lookup per message — no
allocations beyond the existing lineage stamps; ``trace_every=0``
disables stamping entirely.

:class:`FrameTraceCollector` (module-global ``tracer``, mirroring the
``metrics``/``lineage`` registries) receives completed records, feeds
the per-transition histograms (``trace.wire_ms``, ``trace.queue_ms``,
``trace.decode_ms``, ``trace.reservoir_dwell_ms``, ``trace.step_ms``),
and renders cross-process Chrome-trace output with flow arrows binding
the producer's pid lane to the consumer lanes
(:meth:`FrameTraceCollector.chrome_events`, merged into
:func:`blendjax_torch.obs.exporters.chrome_trace`).

Import-cheap and stdlib-only, like the rest of ``blendjax_torch.obs``.
"""

from __future__ import annotations

import os
import threading
import time
import zlib
from collections import deque

from blendjax_torch.utils.metrics import metrics

# Wire key for the sampled trace context (underscored like the lineage
# stamps so it can never collide with a user field). Stripped on replay
# (``blendjax_torch.obs.lineage.strip_stamps``) — recorded wall stamps would
# read as hours of wire latency.
TRACE_KEY = "_trace"

# Batch-level carrier: once a traced message is folded into a batch its
# trace context rides the batch dict (and survives the tile host stage
# inside the per-batch ``rest``/``_meta`` sidecars) under this key.
TRACES_KEY = "_traces"

TERMINAL_STAGE = "step_retire"

# Named per-transition histograms (milliseconds). ``from`` may list
# fallbacks: the first stage present in the record wins — e.g. the
# fused emit_packed path has no ``decode`` stamp, and a non-echo
# pipeline has no reservoir stages; transitions whose endpoints are
# absent are simply not observed.
_TRANSITIONS = (
    ("trace.wire_ms", ("publish",), "recv", "wall"),
    ("trace.queue_ms", ("recv",), "batch", "mono"),
    ("trace.decode_ms", ("place", "batch"), "decode", "mono"),
    ("trace.reservoir_dwell_ms", ("reservoir_insert",),
     "reservoir_sample", "mono"),
    ("trace.step_ms", ("step_dispatch",), "step_retire", "mono"),
)


def make_trace(trace_id: str, btid=None, pid: int | None = None) -> dict:
    """A fresh trace context with its ``publish`` stamp. Producers
    (Blender's Python) inline this shape rather than importing the
    module; it exists for tests and non-socket sources."""
    return {
        "id": trace_id,
        "btid": btid,
        "pid": os.getpid() if pid is None else pid,
        "stages": [["publish", time.monotonic(), time.time()]],
    }


def stage(tr: dict, name: str) -> None:
    """Append one ``[stage, t_mono, t_wall]`` stamp in place."""
    tr["stages"].append([name, time.monotonic(), time.time()])


def iter_traces(batch: dict):
    """Yield every trace context reachable from a batch dict: the
    batch-level ``_traces`` list, plus any carried inside ``_meta``
    when it is a list of sidecar dicts (the tile chunk-group form,
    where per-batch ``rest`` dicts ride as ``_meta`` entries)."""
    trs = batch.get(TRACES_KEY)
    if trs:
        yield from trs
    meta = batch.get("_meta")
    if isinstance(meta, list):
        for m in meta:
            if isinstance(m, dict):
                inner = m.get(TRACES_KEY)
                if inner:
                    yield from inner


def stamp_batch(batch: dict, name: str) -> None:
    """Stamp ``name`` onto every trace riding a batch (fast no-op for
    the untraced common case)."""
    trs = batch.get(TRACES_KEY)
    if trs:
        for tr in trs:
            stage(tr, name)
    meta = batch.get("_meta")
    if isinstance(meta, list):
        for m in meta:
            if isinstance(m, dict):
                inner = m.get(TRACES_KEY)
                if inner:
                    for tr in inner:
                        stage(tr, name)


def pop_traces(batch: dict) -> list:
    """Remove and return every trace riding a batch (batch-level key
    and ``_meta``-carried alike); ``[]`` when untraced."""
    out = list(batch.pop(TRACES_KEY, None) or ())
    meta = batch.get("_meta")
    if isinstance(meta, list):
        for m in meta:
            if isinstance(m, dict) and TRACES_KEY in m:
                out.extend(m.pop(TRACES_KEY) or ())
    return out


def _first_stamps(tr: dict) -> tuple:
    """``(first-occurrence {stage: (mono, wall)}, mono-ordered?)``."""
    stamps: dict = {}
    ordered = True
    prev = None
    for entry in tr.get("stages", ()):
        name, mono, wall = entry[0], float(entry[1]), float(entry[2])
        if name not in stamps:
            stamps[name] = (mono, wall)
        if prev is not None and mono < prev:
            ordered = False
        prev = mono
    return stamps, ordered


class FrameTraceCollector:
    """Process-wide sink for completed frame traces (one per process,
    like the metrics registry; thread-safe — the driver's retire path
    and tests hand records in concurrently).

    ``complete(tr)`` files one finished record: per-transition durations
    are observed into the shared metrics registry (so ``trace.*``
    histograms appear in every ``Metrics.report()``/Prometheus page),
    and the record itself is kept in a bounded ring (``keep``, oldest
    dropped) for Chrome-trace export and flight-record bundles.
    """

    def __init__(self, keep: int = 256, registry=metrics):
        self._lock = threading.Lock()
        self._records: deque = deque(maxlen=int(keep))
        self.registry = registry
        self.n_completed = 0
        self.n_unordered = 0

    def complete(self, tr: dict) -> None:
        stamps, ordered = _first_stamps(tr)
        durs = []
        for metric, froms, to, clock in _TRANSITIONS:
            end = stamps.get(to)
            if end is None:
                continue
            start = next(
                (stamps[f] for f in froms if f in stamps), None
            )
            if start is None:
                continue
            i = 0 if clock == "mono" else 1
            durs.append((metric, (end[i] - start[i]) * 1e3))
        with self._lock:
            self._records.append(tr)
            self.n_completed += 1
            if not ordered:
                self.n_unordered += 1
        # Registry observes OUTSIDE the collector lock (the registry has
        # its own; nesting the two invites ordering deadlocks).
        for metric, ms in durs:
            self.registry.observe(metric, ms)
        self.registry.count("trace.completed")
        if not ordered:
            self.registry.count("trace.unordered")

    # -- snapshots ------------------------------------------------------------

    def records(self) -> list:
        with self._lock:
            return list(self._records)

    def report(self) -> dict:
        """Summary over the kept records: counts, end-to-end stage
        completeness (every record spans publish -> step_retire), mono
        ordering, and per-transition percentiles in ms."""
        recs = self.records()
        with self._lock:
            completed, unordered = self.n_completed, self.n_unordered
        transitions: dict = {}
        end_to_end = bool(recs)
        for tr in recs:
            stamps, _ = _first_stamps(tr)
            if "publish" not in stamps or TERMINAL_STAGE not in stamps:
                end_to_end = False
            for metric, froms, to, clock in _TRANSITIONS:
                end = stamps.get(to)
                start = next(
                    (stamps[f] for f in froms if f in stamps), None
                )
                if end is None or start is None:
                    continue
                i = 0 if clock == "mono" else 1
                transitions.setdefault(metric, []).append(
                    (end[i] - start[i]) * 1e3
                )

        def summary(vals: list) -> dict:
            vals = sorted(vals)
            pick = lambda q: vals[min(int(q * len(vals)), len(vals) - 1)]  # noqa: E731
            return {
                "count": len(vals),
                "p50_ms": round(pick(0.50), 3),
                "p95_ms": round(pick(0.95), 3),
                "max_ms": round(vals[-1], 3),
            }

        return {
            "completed": completed,
            "unordered": unordered,
            "kept": len(recs),
            "end_to_end": end_to_end,
            "transitions": {k: summary(v) for k, v in transitions.items()},
        }

    # -- Chrome-trace rendering ----------------------------------------------

    def chrome_events(self) -> list:
        """Completed records as Chrome/Perfetto events: one ``ph: "X"``
        slice per stage transition — producer-side slices in the
        producer's pid lane, consumer-side slices in this process's —
        plus ``s``/``f`` flow events binding the publish slice to the
        recv slice across lanes (the producer -> consumer arrow), and
        process_name metadata so the lanes are labeled.

        Timestamps are wall-clock micros shifted onto the consumer's
        ``perf_counter`` timebase, so frame-trace lanes line up with
        the span-event lanes :func:`blendjax_torch.obs.exporters.chrome_trace`
        already emits from the same process."""
        recs = self.records()
        if not recs:
            return []
        off = time.perf_counter() - time.time()
        cpid = os.getpid()
        events: list = []
        lanes: dict = {cpid: "blendjax consumer"}
        for tr in recs:
            sts = tr.get("stages") or []
            if len(sts) < 2:
                continue
            ppid = int(tr.get("pid") or 0)
            lanes.setdefault(ppid, f"blendjax producer btid={tr.get('btid')}")
            tid = int(tr.get("btid") or 0)
            flow_id = zlib.crc32(str(tr.get("id")).encode()) & 0x7FFFFFFF
            for (n0, _m0, w0), (n1, _m1, w1) in zip(sts, sts[1:]):
                events.append({
                    "name": f"{n0}→{n1}",
                    "cat": "frame_trace",
                    "ph": "X",
                    "ts": round((w0 + off) * 1e6, 3),
                    "dur": round(max(w1 - w0, 0.0) * 1e6, 3),
                    "pid": ppid if n0 == "publish" else cpid,
                    "tid": tid,
                    "args": {"trace": tr.get("id")},
                })
            events.append({
                "name": "frame", "cat": "frame_trace", "ph": "s",
                "id": flow_id, "pid": ppid, "tid": tid,
                "ts": round((sts[0][2] + off) * 1e6, 3),
            })
            events.append({
                "name": "frame", "cat": "frame_trace", "ph": "f",
                "bp": "e", "id": flow_id, "pid": cpid, "tid": tid,
                "ts": round((sts[1][2] + off) * 1e6, 3),
            })
        for pid, label in lanes.items():
            events.append({
                "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": label},
            })
        return events

    def reset(self) -> None:
        with self._lock:
            self._records.clear()
            self.n_completed = 0
            self.n_unordered = 0


# Default process-wide collector (mirrors ``metrics``/``lineage``).
tracer = FrameTraceCollector()
