"""Parity of the port's metrics and observability (``blendjax_torch.utils
.metrics``, ``blendjax_torch.obs``) with the JAX package's: the same
seeded inputs through both, compared exactly unless a tolerance is stated.

Wall-clock readings (span durations, staleness, telemetry age) differ
between two runs by nature: those are compared by count only.
"""

import json
import math
import os
import re
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from blendjax.obs import diagnose as jdiagnose
from blendjax.obs.exporters import prometheus_text as jprometheus_text
from blendjax.obs.lineage import FrameLineage as JFrameLineage
from blendjax.obs.trace import FrameTraceCollector as JFrameTraceCollector
from blendjax.obs.watchdog import Slo as JSlo
from blendjax.obs.watchdog import SloWatchdog as JSloWatchdog
from blendjax.utils.metrics import Histogram as JHistogram
from blendjax.utils.metrics import Metrics as JMetrics
from blendjax_torch.obs import (
    VERDICTS,
    FlightRecorder,
    JsonlExporter,
    Slo,
    SloWatchdog,
    StatsReporter,
    chrome_trace,
    diagnose,
    prometheus_text,
    start_http_exporter,
    write_chrome_trace,
)
from blendjax_torch.obs.lineage import (
    PUB_MONO_KEY,
    PUB_WALL_KEY,
    SEQ_KEY,
    TELEMETRY_KEY,
    FrameLineage,
    lineage,
    strip_stamps,
)
from blendjax_torch.obs.trace import (
    TRACE_KEY,
    TRACES_KEY,
    FrameTraceCollector,
    make_trace,
    pop_traces,
    stamp_batch,
    tracer,
)
from blendjax_torch.obs.trace import stage as trace_stage
from blendjax_torch.utils.metrics import Histogram, Metrics, metrics

WILD = "tcp://127.0.0.1:*"


@pytest.fixture(autouse=True)
def _fresh_registries():
    """The port's registry, lineage, tracer and ledger are process-wide;
    the tests of one file share a process. The JAX package's singletons
    are other objects and are never touched here."""
    from blendjax_torch.obs.devledger import ledger

    for reg in (metrics, lineage, tracer, ledger):
        reg.reset()
    yield
    for reg in (metrics, lineage, tracer, ledger):
        reg.reset()


def _values(seed: int, n: int = 2000) -> np.ndarray:
    """Log-normal values with zeros, negatives and non-finite ones mixed in
    (every branch of ``Histogram.observe``)."""
    rng = np.random.default_rng(seed)
    v = rng.lognormal(mean=-4.0, sigma=2.0, size=n)
    v[rng.integers(0, n, 40)] = 0.0
    v[rng.integers(0, n, 40)] *= -1.0
    v[rng.integers(0, n, 5)] = np.nan
    v[rng.integers(0, n, 5)] = np.inf
    return v


# -- metrics ------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_summaries_quantiles_and_buckets_equal_the_reference(seed):
    """Exact: the same bucket index arithmetic on the same float values."""
    port, ref = Histogram(), JHistogram()
    for v in _values(seed):
        port.observe(v)
        ref.observe(v)
    assert port.summary() == ref.summary()
    for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert port.quantile(q) == ref.quantile(q)
    assert port.cumulative_buckets() == ref.cumulative_buckets()
    assert port.state_dict() == ref.state_dict()


def test_metrics_reports_equal_for_equal_observations():
    """Counters, gauges and histograms exact; span timings differ between
    any two runs, so spans are compared by count."""
    port, ref = Metrics(), JMetrics()
    vals = _values(3, 300)
    for reg in (port, ref):
        reg.count("wire.raw_bytes", 1024)
        reg.count("ingest.items")
        reg.gauge("ingest.queue_depth", 2)
        reg.gauge_max("ingest.queue_depth_hwm", 3)
        reg.gauge_max("ingest.queue_depth_hwm", 1)
        reg.observe_many("echo.sample_age_s", vals[:100])
        for v in vals[100:]:
            reg.observe("wire.inflate_ms", v)
        with reg.span("feed.place"):
            pass
    a, b = port.report(include_buckets=True), ref.report(include_buckets=True)
    for key in ("counters", "gauges"):
        assert a[key] == b[key]
    assert set(a["spans"]) == set(b["spans"]) == {"feed.place"}
    assert a["spans"]["feed.place"]["count"] == 1
    for name in ("echo.sample_age_s", "wire.inflate_ms"):
        assert a["histograms"][name] == b["histograms"][name]
        assert a["histogram_buckets"][name] == b["histogram_buckets"][name]


def test_histogram_state_dict_loads_across_the_two_packages():
    port, ref = Histogram(), JHistogram()
    for v in _values(4, 500):
        ref.observe(v)
    port.load_state_dict(ref.state_dict())
    assert port.summary() == ref.summary()
    back = JHistogram()
    back.load_state_dict(port.state_dict())
    assert back.summary() == ref.summary()
    assert back.cumulative_buckets() == port.cumulative_buckets()


def test_span_histogram_counts_sum_to_span_counts_under_threads():
    reg = Metrics()

    def work():
        for _ in range(200):
            with reg.span("ingest.recv"):
                pass

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    rep = reg.report()
    assert rep["spans"]["ingest.recv"]["count"] == 800
    assert rep["histograms"]["ingest.recv"]["count"] == 800


def test_profiler_trace_writes_a_chrome_trace_and_nests_as_a_noop(tmp_path):
    """``trace`` wraps torch.profiler; a nested trace yields None and runs
    the block untraced (one profiler per process)."""
    from blendjax_torch.utils.metrics import TRACE_FILE, trace

    with trace(str(tmp_path / "outer")) as prof:
        assert prof is not None
        with trace(str(tmp_path / "inner")) as inner:
            assert inner is None
            torch.ones(4).sum()
    with open(tmp_path / "outer" / TRACE_FILE) as f:
        assert "traceEvents" in json.load(f)
    assert not (tmp_path / "inner").exists()
    with trace(str(tmp_path / "again")) as prof:  # the guard was released
        assert prof is not None


# -- lineage ------------------------------------------------------------------


def _corpus(seed: int = 0) -> list:
    """(btid, seq or None, wall offset) in arrival order: gaps, a reorder,
    a respawn at 0 with a drop after it, interleaved producers, unstamped
    messages and a non-finite wall stamp."""
    rng = np.random.default_rng(seed)
    out = []
    for seq in (0, 1, 4, 3, 5, 6):  # gap 2, reorder 1
        out.append((7, seq, float(rng.uniform(0.0, 0.05))))
    for seq in list(range(30)) + [0, 1, 3, 4]:  # respawn, then a drop
        out.append((5, seq, float(rng.uniform(0.0, 0.05))))
    for seq in range(10):  # interleaved producers: no gaps
        for btid in (0, 1, 2):
            out.append((btid, seq, float(rng.uniform(0.0, 0.05))))
    out.append((3, None, 0.0))  # unstamped
    out.append((2, 10, math.nan))  # a corrupted clock
    out.append((2, 11, math.inf))
    return out


def _message(btid, seq, age, now):
    if seq is None:
        return {"btid": btid, "frameid": -1}
    return {"btid": btid, SEQ_KEY: seq, PUB_WALL_KEY: now - age,
            PUB_MONO_KEY: 0.0, "frameid": seq}


def _strip_wall(rep: dict) -> dict:
    out = {}
    for btid, e in rep.items():
        e = dict(e)
        e["e2e_staleness_ms"] = e["e2e_staleness_ms"]["count"]
        e.pop("telemetry_age_s", None)
        out[btid] = e
    return out


@pytest.mark.parametrize("track_gaps", [True, False])
def test_lineage_reports_equal_the_reference(track_gaps):
    port, ref = FrameLineage(), JFrameLineage()
    now = time.time()
    for btid, seq, age in _corpus():
        a, b = _message(btid, seq, age, now), _message(btid, seq, age, now)
        port.ingest(a, track_gaps=track_gaps)
        ref.ingest(b, track_gaps=track_gaps)
        assert a == b  # the same stamps popped, the payload untouched
    assert _strip_wall(port.report()) == _strip_wall(ref.report())
    assert port.total_gaps() == ref.total_gaps()
    assert port.state_dict() == ref.state_dict()
    assert (port.staleness_p95_s() is None) == (ref.staleness_p95_s() is None)
    if track_gaps:
        rep = port.report()
        assert (rep["7"]["seq_gaps"], rep["7"]["seq_reorders"]) == (2, 1)
        assert (rep["5"]["restarts"], rep["5"]["seq_gaps"]) == (1, 1)


def test_lineage_ingest_returns_the_sequence_verdict():
    ln = FrameLineage()
    verdicts = [ln.ingest({"btid": 0, SEQ_KEY: s})
                for s in (0, 1, 3, 2, 4, 5, 0, 1)]
    assert verdicts == [(0, False, False), (0, False, False),
                        (1, False, False), (0, True, False),
                        (0, False, False), (0, False, False),
                        (0, False, True), (0, False, False)]
    assert ln.ingest({"btid": 0, "image": 1}) == (0, False, False)


def test_lineage_register_retire_and_telemetry():
    port, ref = FrameLineage(), JFrameLineage()
    tele = {"seq": 0, "mps": 12.5, "spans": {}, "counters": {"x": 1}}
    for ln in (port, ref):
        ln.register(9)
        ln.ingest({"btid": 0, SEQ_KEY: 0, TELEMETRY_KEY: dict(tele)})
        assert ln.retire(9) and not ln.retire(9)
    assert _strip_wall(port.report()) == _strip_wall(ref.report())
    assert port.report()["0"]["telemetry"]["mps"] == 12.5


def test_lineage_session_state_restores_across_the_frameworks():
    """Port -> the port's session codec -> the JAX lineage, and back: the
    restored tracker counts a fresh publisher's 0 as a restart and the
    next drop as a gap, in both packages."""
    from blendjax.checkpoint.format import pack_session as jpack
    from blendjax.checkpoint.format import unpack_session as junpack
    from blendjax_torch.checkpoint import collect_session, restore_session
    from blendjax_torch.checkpoint.format import pack_session, unpack_session

    port = FrameLineage()
    for btid, seq, age in _corpus(1):
        port.ingest(_message(btid, seq, age, time.time()))
    raw = pack_session(collect_session(lineage=port))
    ref = JFrameLineage()
    ref.load_state_dict(junpack(raw)["lineage"])
    assert ref.state_dict() == port.state_dict()
    back = FrameLineage()
    restore_session(unpack_session(jpack({"lineage": ref.state_dict()})),
                    lineage=back)
    assert back.state_dict() == port.state_dict()
    for ln in (ref, back):
        for seq in (0, 1, 3):
            ln.ingest({"btid": 7, SEQ_KEY: seq})
        e = ln.state_dict()[7]
        assert (e["restarts"], e["gaps"]) == (1, 2 + 1)


def test_strip_stamps_removes_every_stamp_like_the_reference():
    from blendjax.obs.lineage import strip_stamps as jstrip

    msg = {"btid": 0, SEQ_KEY: 3, PUB_WALL_KEY: 1.0, PUB_MONO_KEY: 2.0,
           TELEMETRY_KEY: {}, TRACE_KEY: {"id": "x"}, "_scenario": "s",
           "frameid": 1}
    assert strip_stamps(dict(msg)) == jstrip(dict(msg))
    assert set(strip_stamps(dict(msg))) == {"btid", "_scenario", "frameid"}


# -- C4: the stream's seq accounting ------------------------------------------


C4_SEQS = (0, 1, 3, 2, 4, 5, 0, 1)


def _publish_seqs(pub, seqs, frameid0: int = 0):
    """Publish one message per seq, numbered as given (the publisher's own
    counter is set before each)."""
    for i, s in enumerate(seqs):
        pub._seq = s
        pub.publish(image=np.zeros((2, 2), np.uint8), frameid=frameid0 + i)


def test_stream_seq_accounting_matches_the_reference():
    """The corpus through the port's RemoteStream (a live socket) and
    through ShardedHostIngest (two shards, one producer each) counts gaps
    1, reorders 1, restarts 1 per producer: the reference lineage's
    accounting of the same seqs."""
    from blendjax_torch.data import (
        RemoteStream,
        ShardedHostIngest,
        partition_addresses,
    )
    from blendjax_torch.transport import DataPublisherSocket

    ref = JFrameLineage()
    for s in C4_SEQS:
        ref.ingest({"btid": 0, SEQ_KEY: s})
    want = ref.report()["0"]
    want = (want["seq_gaps"], want["seq_reorders"], want["restarts"])
    assert want == (1, 1, 1)

    pub = DataPublisherSocket(WILD, btid=0)
    stream = RemoteStream([pub.addr], timeoutms=10_000, max_items=8)
    t = threading.Thread(target=_publish_seqs, args=(pub, C4_SEQS),
                         daemon=True)
    t.start()
    items = list(stream)
    t.join(timeout=10)
    pub.close()
    assert [int(m["frameid"]) for m in items] == list(range(8))
    assert (stream.seq_gaps, stream.reorders, stream.restarts) == want
    assert stream.messages == 8

    lineage.reset()
    pubs = [DataPublisherSocket(WILD, btid=k) for k in range(2)]
    shards = partition_addresses([p.addr for p in pubs], 2)
    streams = [RemoteStream(s, worker_index=i, num_workers=2,
                            track_gaps=True, timeoutms=10_000)
               for i, s in enumerate(shards)]
    ingest = ShardedHostIngest(streams, batch_size=4, max_messages=16,
                               inflate_workers=0)
    feeders = [threading.Thread(target=_publish_seqs, args=(p, C4_SEQS),
                                daemon=True) for p in pubs]
    for f in feeders:
        f.start()
    batches = list(ingest)
    for f in feeders:
        f.join(timeout=10)
    for p in pubs:
        p.close()
    assert sum(len(b["_meta"]) for b in batches) == 16
    for s in streams:
        assert (s.seq_gaps, s.reorders, s.restarts) == want
    rep = lineage.report()
    for btid in ("0", "1"):
        got = rep[btid]
        assert (got["seq_gaps"], got["seq_reorders"], got["restarts"]) == want


# -- frame traces -------------------------------------------------------------


def _stage_names(col) -> list:
    return sorted(tuple(s[0] for s in tr["stages"]) for tr in col.records())


def test_frame_trace_stages_equal_the_reference_end_to_end():
    """Publisher (trace_every=2) -> RemoteStream -> HostIngest ->
    TrainDriver(device cpu) in each package: the same stage names in the
    same order on every completed trace, ordered monotonically."""
    from blendjax.data.batcher import HostIngest as JHostIngest
    from blendjax.data.stream import RemoteStream as JRemoteStream
    from blendjax.obs.trace import tracer as jtracer
    from blendjax.train.driver import TrainDriver as JTrainDriver
    from blendjax.transport import DataPublisherSocket as JPublisher
    from blendjax_torch.data import HostIngest, RemoteStream
    from blendjax_torch.train import TrainDriver
    from blendjax_torch.transport import DataPublisherSocket

    class _Loss:
        def is_ready(self):
            return True

        def __array__(self, dtype=None, copy=None):
            return np.zeros(1, np.float32)

    runs = {}
    for name, pub_cls, stream_cls, ingest_cls, driver_cls, loss, col in (
        ("port", DataPublisherSocket, RemoteStream, HostIngest, TrainDriver,
         lambda: torch.zeros(1), tracer),
        ("ref", JPublisher, JRemoteStream, JHostIngest, JTrainDriver,
         _Loss, jtracer),
    ):
        col.reset()
        pub = pub_cls(WILD, btid=7, telemetry_every=0, trace_every=2)
        stream = stream_cls([pub.addr], timeoutms=5000, max_items=8)
        ingest = ingest_cls(stream, batch_size=4).start()
        t = threading.Thread(target=lambda p=pub: [
            p.publish(image=np.zeros((2, 2), np.uint8), frameid=i)
            for i in range(8)], daemon=True)
        t.start()
        drv = driver_cls(lambda state, batch, loss=loss: (state,
                                                          {"loss": loss()}),
                         state=0, inflight=2, sync_every=0)
        for batch in ingest:
            assert TRACE_KEY not in batch
            drv.submit(batch)
        drv.finish()
        t.join(timeout=5)
        pub.close()
        rep = col.report()
        assert rep["completed"] == 4 and rep["end_to_end"] is True
        assert rep["unordered"] == 0
        runs[name] = _stage_names(col)
        col.reset()
    assert runs["port"] == runs["ref"]
    assert runs["port"][0] == ("publish", "recv", "batch", "step_dispatch",
                               "step_retire")
    hists = metrics.report()["histograms"]
    assert hists["trace.step_ms"]["count"] == 4
    assert hists["train.step_device_ms"]["count"] == 2


def test_trace_collector_report_and_chrome_events_match_the_reference():
    """The same record through both collectors: the same transitions (by
    count), flags and Chrome event structure."""
    port, ref = FrameTraceCollector(registry=Metrics()), \
        JFrameTraceCollector(registry=JMetrics())
    tr = make_trace("f-1", btid=3, pid=31337)
    for s in ("recv", "batch", "place", "decode", "reservoir_insert",
              "reservoir_sample", "step_dispatch", "step_retire"):
        trace_stage(tr, s)
    port.complete(json.loads(json.dumps(tr)))
    ref.complete(json.loads(json.dumps(tr)))
    a, b = port.report(), ref.report()
    assert {k: v for k, v in a.items() if k != "transitions"} == \
        {k: v for k, v in b.items() if k != "transitions"}
    assert {k: v["count"] for k, v in a["transitions"].items()} == \
        {k: v["count"] for k, v in b["transitions"].items()}

    def shape(evs):
        return sorted((e["ph"], e["name"], e.get("cat"), e["pid"])
                      for e in evs)

    assert shape(port.chrome_events()) == shape(ref.chrome_events())


def test_trace_batch_helpers_reach_meta_sidecars():
    tr1, tr2 = make_trace("a", btid=0, pid=1), make_trace("b", btid=0, pid=1)
    batch = {TRACES_KEY: [tr1], "_meta": [{TRACES_KEY: [tr2]}, {"o": 1}]}
    stamp_batch(batch, "place")
    assert tr1["stages"][-1][0] == tr2["stages"][-1][0] == "place"
    assert {t["id"] for t in pop_traces(batch)} == {"a", "b"}
    assert TRACES_KEY not in batch and TRACES_KEY not in batch["_meta"][0]


def test_mixed_producers_and_consumers_decode_each_others_stamps():
    """A JAX publisher's _telemetry/_trace decode on the port's stream and
    lineage, and the port's on the JAX consumer."""
    from blendjax.data.stream import RemoteStream as JRemoteStream
    from blendjax.obs.lineage import lineage as jlineage
    from blendjax.transport import DataPublisherSocket as JPublisher
    from blendjax_torch.data import RemoteStream
    from blendjax_torch.transport import DataPublisherSocket

    for pub_cls, stream_cls, ln in ((JPublisher, RemoteStream, lineage),
                                    (DataPublisherSocket, JRemoteStream,
                                     jlineage)):
        ln.reset()
        pub = pub_cls(WILD, btid=4, telemetry_every=2, trace_every=2)
        stream = stream_cls([pub.addr], timeoutms=5000, max_items=4)
        t = threading.Thread(target=lambda p=pub: [
            p.publish(image=np.zeros((2, 2), np.uint8), frameid=i)
            for i in range(4)], daemon=True)
        t.start()
        items = list(stream)
        t.join(timeout=5)
        pub.close()
        traced = [it[TRACE_KEY] for it in items if TRACE_KEY in it]
        assert len(traced) == 2
        for tr in traced:
            assert [s[0] for s in tr["stages"]] == ["publish", "recv"]
            assert tr["btid"] == 4
        assert all(TELEMETRY_KEY not in it and SEQ_KEY not in it
                   for it in items)
        rep = ln.report()["4"]
        assert rep["received"] == 4 and rep["seq_gaps"] == 0
        assert set(rep["telemetry"]) >= {"seq", "mps", "counters", "spans"}
        ln.reset()


def test_producer_frame_span_rides_the_telemetry():
    """The port's publisher snapshots its process's registry, so the
    producer's producer.frame span reaches the consumer's lineage."""
    from blendjax_torch.transport import DataPublisherSocket

    with metrics.span("producer.frame"):
        pass
    pub = DataPublisherSocket(WILD, btid=1, telemetry_every=1, trace_every=0)
    msg = pub._stamp({"btid": 1})
    pub.close()
    assert msg[TELEMETRY_KEY]["spans"]["producer.frame"]["count"] == 1
    assert TRACE_KEY not in msg
    off = DataPublisherSocket(WILD, btid=1, lineage=False)
    assert off._stamp({"btid": 1}) == {"btid": 1}
    off.close()


# -- the doctor ---------------------------------------------------------------


def _report(spans=None, counters=None, gauges=None):
    return {
        "spans": {k: {"count": 10, "total_s": v}
                  for k, v in (spans or {}).items()},
        "counters": counters or {},
        "gauges": gauges or {},
        "histograms": {},
    }


_STALE = {"0": {"e2e_staleness_ms": {"count": 50, "p95": 900.0}}}
_FRESH = {"0": {"e2e_staleness_ms": {"count": 50, "p95": 8.0}}}
_STARVING = {"ingest.queue_wait": 6.0, "ingest.recv": 2.0,
             "train.dispatch": 1.0}

#: every report the JAX package's doctor tests build, with their keywords
DOCTOR_CORPUS = [
    (_report(spans={"ingest.recv": 1.0, "ingest.queue_wait": 0.1,
                    "train.dispatch": 8.0},
             counters={"ingest.queue_full_waits": 40}), {}),
    (_report(spans={"train.dispatch": 1.0, "driver.ring_wait": 4.0}),
     {"driver": {"host_blocks": 25}}),
    (_report(spans={"feed.throttle_wait": 5.0, "feed.place": 1.0,
                    "train.dispatch": 2.0},
             counters={"feed.throttle_blocks": 17}), {}),
    (_report(spans={"decode.dispatch": 6.0, "train.dispatch": 2.0,
                    "ingest.queue_wait": 1.0}), {}),
    (_report(spans={"train.dispatch": 5.0, "ingest.queue_wait": 0.1},
             gauges={"ingest.queue_depth_hwm": 2}), {"prefetch": 2}),
    (_report(spans={"ingest.recv.shard0": 2.0, "ingest.recv.shard1": 2.0,
                    "ingest.recv.shard2": 2.0, "ingest.recv.shard3": 2.0,
                    "ingest.queue_wait": 0.1, "train.dispatch": 2.0,
                    "feed.place": 1.0}), {}),
    (_report(spans=_STARVING), {"lineage": _STALE}),
    (_report(spans=_STARVING), {"lineage": _FRESH}),
    (_report(spans=_STARVING), {}),
    (_report(), {}),
    (_report(spans={"ingest.recv": 1.0, "ingest.queue_wait": 1.0,
                    "feed.place": 1.0, "decode.dispatch": 1.0,
                    "train.dispatch": 1.0}), {}),
    (_report(spans={"train.dispatch": 2.0},
             counters={"device.retraces": 3}), {}),
    (_report(spans={"train.dispatch": 2.0},
             counters={"device.retraces": 2}), {}),
    (_report(spans={"train.dispatch": 2.0},
             gauges={"device.hbm_headroom_frac": 0.05,
                     "device.temp_bytes": 800.0,
                     "device.hbm_peak_bytes": 1000.0}), {}),
    (_report(spans={"train.dispatch": 2.0},
             gauges={"device.hbm_headroom_frac": 0.03,
                     "device.temp_bytes": 100.0,
                     "device.hbm_peak_bytes": 1000.0}), {}),
    (_report(spans={"train.dispatch": 2.0},
             gauges={"device.hbm_headroom_frac": 0.5}), {}),
    # the arms the corpus above leaves out: compile-bound and echo
    (_report(spans={"train.compile_ms": 9.0, "train.dispatch": 1.0},
             counters={"train.aot_cache_misses": 5}), {}),
    (_report(spans={"echo.wait_fresh": 6.0, "train.dispatch": 1.0},
             counters={"echo.fresh": 10, "echo.echoed": 30,
                       "echo.saturated_waits": 4}), {}),
    (_report(spans=_STARVING,
             counters={"echo.fresh": 10, "echo.echoed": 30}),
     {"lineage": _FRESH}),
]


@pytest.mark.parametrize("case", range(len(DOCTOR_CORPUS)))
def test_doctor_gives_the_reference_verdict(case):
    report, kw = DOCTOR_CORPUS[case]
    got, want = diagnose(report, **kw), jdiagnose(report, **kw)
    assert (got.kind, got.reason, got.advice, got.shares) == \
        (want.kind, want.reason, want.advice, want.shares)
    assert got.kind in VERDICTS
    assert got.render() == want.render()


def test_pipeline_doctor_reads_the_live_registry():
    """A port pipeline's doctor() diagnoses the process-wide registry with
    its prefetch bound (here: the queue pinned at it, step-bound)."""
    from blendjax_torch.data import StreamDataPipeline

    pipe = StreamDataPipeline(iter([]), batch_size=2, device="cpu",
                              prefetch=2)
    assert pipe.doctor().kind == "idle"
    with metrics.span("train.dispatch"):
        time.sleep(0.01)
    metrics.gauge_max("ingest.queue_depth_hwm", 2)
    v = pipe.doctor()
    assert v.kind == "step-bound" and "queue_depth_hwm=2" in v.reason
    assert metrics.report()["gauges"]["ingest.queue_depth"] == 0


# -- exporters ----------------------------------------------------------------


def _fill(reg):
    reg.count("wire.raw_bytes", 1024)
    reg.count("train.dispatches", 7)
    reg.gauge("ingest.queue_depth", 2)
    reg.gauge("device.hbm_headroom_frac", 0.25)
    for v in (0.001, 0.002, 0.004, 0.02, 0.0, -1.0):
        reg.observe("ingest.recv", v)
    return reg


_LINEAGE = {
    "0": {"received": 10, "seq_gaps": 0, "seq_reorders": 1, "restarts": 0,
          "e2e_staleness_ms": {"count": 10, "p50": 1.5, "p95": 3.0,
                               "p99": 4.0, "max": 4.2}},
    "1": {"received": 9, "seq_gaps": 2, "seq_reorders": 0, "restarts": 1,
          "e2e_staleness_ms": {"count": 9, "p50": 2.0, "p95": 5.0,
                               "p99": 6.0, "max": 6.5}},
}

_PROM_SAMPLE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? "
    r"[-+]?[0-9]+(\.[0-9]+)?([eE][-+]?[0-9]+)?$"
)


def test_prometheus_text_is_byte_identical_to_the_reference():
    port, ref = _fill(Metrics()), _fill(JMetrics())
    a = prometheus_text(port.report(include_buckets=True),
                        lineage_report=_LINEAGE, registry=port)
    b = jprometheus_text(ref.report(include_buckets=True),
                         lineage_report=_LINEAGE, registry=ref)
    assert a == b
    for line in a.splitlines():
        assert line.startswith("# TYPE ") or _PROM_SAMPLE.match(line), line


def test_http_exporter_serves_the_live_registry():
    _fill(metrics)
    srv = start_http_exporter(port=0)
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics", timeout=5) as r:
            body = r.read().decode()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/healthz", timeout=5) as r:
            health = json.loads(r.read())
    finally:
        srv.close()
    assert "blendjax_train_dispatches_total 7" in body
    assert health == {"healthy": True, "slo": "unconfigured"}


def test_jsonl_and_chrome_trace_have_the_reference_structure(tmp_path):
    from blendjax.obs.exporters import JsonlExporter as JJsonl
    from blendjax.obs.exporters import chrome_trace as jchrome

    port, ref = _fill(Metrics()), _fill(JMetrics())
    JsonlExporter(str(tmp_path / "a.jsonl")).write(registry=port,
                                                   extra={"x": 1})
    JJsonl(str(tmp_path / "b.jsonl")).write(registry=ref, extra={"x": 1})
    lines = [json.loads((tmp_path / n).read_text())
             for n in ("a.jsonl", "b.jsonl")]

    def keys(d):
        return {k: keys(v) if isinstance(v, dict) else None
                for k, v in d.items() if k != "t"}

    assert keys(lines[0]) == keys(lines[1])
    assert lines[0]["report"]["counters"] == lines[1]["report"]["counters"]
    events = [("feed.place", 1.0, 0.002, 11), ("ingest.recv", 1.5, 0.001, 12)]
    a = chrome_trace(events, registry=port, frame_traces=False)
    b = jchrome(events, registry=ref, frame_traces=False)
    for e in a["traceEvents"] + b["traceEvents"]:
        e["pid"] = 0
    assert a == b
    col = FrameTraceCollector(registry=Metrics())
    tr = make_trace("f", btid=0, pid=4)
    trace_stage(tr, "recv")
    col.complete(tr)
    n = write_chrome_trace(str(tmp_path / "t.json"), events=[],
                           registry=port, frame_traces=col)
    obj = json.loads((tmp_path / "t.json").read_text())
    assert n == len(obj["traceEvents"]) > 0
    assert any(e.get("cat") == "frame_trace" for e in obj["traceEvents"])


# -- watchdog, reporter, flight recorder --------------------------------------


SLO_SPECS = [
    "rate(wire.seq_gaps) == 0",
    "p95(wire.e2e_staleness_s) <= 0.5 @ 2",
    "gauge(train.mfu) >= 0.01",
    "doctor != wire-bound",
    "counter(train.host_blocks) < 3",
    "ingest.queue_depth <= 4",
]


def test_slo_parsing_equals_the_reference():
    for spec in SLO_SPECS:
        assert dataclass_fields(Slo.parse(spec)) == dataclass_fields(
            JSlo.parse(spec))
    for bad in ("nonsense", "doctor < step-bound", "gauge(x) >= abc"):
        with pytest.raises(ValueError):
            Slo.parse(bad)
        with pytest.raises(ValueError):
            JSlo.parse(bad)


def dataclass_fields(slo) -> tuple:
    return (slo.spec, slo.kind, slo.metric, slo.op, slo.threshold,
            slo.quantile, slo.sustain_s)


def _ticks(seed: int = 0) -> list:
    """A seeded tick sequence: (t, report, verdict kind)."""
    rng = np.random.default_rng(seed)
    out, gaps, blocks = [], 0, 0
    for i in range(12):
        gaps += int(rng.integers(0, 2)) if i in (4, 5, 9) else 0
        blocks += int(rng.integers(0, 2))
        stale = float(rng.choice([0.1, 0.9]))
        out.append((float(i), {
            "counters": {"wire.seq_gaps": gaps, "train.host_blocks": blocks},
            "gauges": {"train.mfu": float(rng.uniform(0.0, 0.02)),
                       "ingest.queue_depth": int(rng.integers(0, 6))},
            "histograms": {"wire.e2e_staleness_s": {"count": 5, "p95": stale}},
        }, str(rng.choice(["producer-bound", "wire-bound"]))))
    return out


def test_watchdog_sustain_windows_equal_the_reference():
    port, ref = SloWatchdog(SLO_SPECS), JSloWatchdog(SLO_SPECS)
    for t, report, kind in _ticks():
        a = port.evaluate(report, verdict=kind, now=t)
        b = ref.evaluate(report, verdict=kind, now=t)
        assert a == b
    assert port.state() == ref.state()


def test_reporter_tick_archives_a_line_and_polls_memory(tmp_path):
    from blendjax_torch.obs.devledger import ledger

    path = tmp_path / "run.jsonl"
    rep = StatsReporter(interval_s=60, jsonl_path=str(path),
                        slos=["rate(wire.seq_gaps) == 0"])
    with metrics.span("train.dispatch"):
        pass
    metrics.count("echo.fresh", 2)
    v = rep.tick()
    rep.tick()
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert len(lines) == 2
    assert lines[0]["doctor"]["kind"] == v.kind
    assert lines[0]["echo"] == {"echo.fresh": 2}
    assert "slo" in lines[0] and rep.health()["healthy"] is True
    # the CPU has no card: the poll ran and set nothing
    assert ledger.report()["memory"] == {"supported": False}
    assert not any(k.startswith("device.hbm")
                   for k in metrics.report()["gauges"])


def test_reporter_thread_ticks_on_its_interval(tmp_path):
    path = tmp_path / "run.jsonl"
    rep = StatsReporter(interval_s=0.05, jsonl_path=str(path)).start()
    time.sleep(0.3)
    rep.stop()
    n = len(path.read_text().splitlines())
    assert n >= 3  # ticks on the thread plus the closing one


def test_flight_recorder_bundle_and_guarded_profile(tmp_path):
    fr = FlightRecorder(str(tmp_path / "fl"), max_bundles=2, profile_s=0.05)
    col = FrameTraceCollector(registry=Metrics())
    tr = make_trace("f", btid=0, pid=4)
    trace_stage(tr, "recv")
    col.complete(tr)
    paths = []
    for i in range(3):
        # only the last bundle profiles: a profile written after its
        # bundle was pruned would make the directory again
        fr.profile_s = 0.05 if i == 2 else 0.0
        paths.append(fr.dump(reason=f"r{i}", history=[{"t": 0}],
                             lineage_report={}, frame_tracer=col))
    time.sleep(1.0)  # the profile thread of the last bundle
    kept = sorted(os.listdir(tmp_path / "fl"))
    assert kept == [os.path.basename(p) for p in paths[1:]]
    files = set(os.listdir(paths[-1]))
    assert {"breach.json", "snapshots.jsonl", "lineage.json", "trace.json",
            "frame_traces.json", "device_ledger.json"} <= files
    assert os.path.exists(os.path.join(paths[-1], "profile", "trace.json"))
