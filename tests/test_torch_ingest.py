"""The port's ingest side on the CPU: ``partition_addresses``,
``ParallelBatchAssembler``, ``ShardedHostIngest`` (counts, tails, errors,
stop, the global message budget, the shared inflate pool and its
decode-ahead), ``HostIngest``'s new options, the pipeline's
``ingest_workers`` wiring, and the whole slice: four port publishers
through ``StreamDataPipeline(ingest_workers=2, chunk=4, device="cpu")``
into the fused step, every frame once and bit-equal with the JAX
pipeline's decode, and the shared-memory route training exactly as the
raw one. No test here asserts a wall-clock time. The sharded ingest live
on a card is in ``tests/test_torch_ingest_card.py``."""

import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import zmq

from blendjax.data import ShardedHostIngest as JShardedHostIngest
from blendjax.data import partition_addresses as jpartition_addresses
from blendjax_torch.data import (
    HostIngest,
    ParallelBatchAssembler,
    RemoteStream,
    SchemaError,
    ShardedHostIngest,
    StreamDataPipeline,
    StreamSchema,
    partition_addresses,
)
from blendjax_torch.transport import DataPublisherSocket, detach_all

WILD = "tcp://127.0.0.1:*"


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """At most two torch threads: the suite runs six workers on eight
    cores beside timing-sensitive tests of the JAX package."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _item(i, btid=0, h=4, w=6):
    return {
        "btid": btid,
        "image": np.full((h, w, 4), i % 255, np.uint8),
        "xy": np.full((8, 2), float(i), np.float32),
        "frameid": i,
    }


def _publish_async(pub, items):
    t = threading.Thread(target=lambda: [pub.publish(**it) for it in items],
                         daemon=True)
    t.start()
    return t


def _frameids(batches):
    return sorted(int(v) for b in batches for v in np.asarray(b["frameid"]))


# -- shard partitioning ------------------------------------------------------------


@pytest.mark.parametrize("n", range(8))
def test_partition_addresses_matches_jax(n):
    addrs = [f"tcp://10.0.0.{i}:5555" for i in range(n)]
    for shards in range(1, 6):
        if n == 0:
            assert partition_addresses(addrs, shards) == \
                jpartition_addresses(addrs, shards) == [[]]
            continue
        got = partition_addresses(addrs, shards)
        assert got == jpartition_addresses(addrs, shards)
        assert sorted(a for g in got for a in g) == addrs
        assert all(g for g in got) and len(got) == min(shards, n)
    assert partition_addresses("tcp://one", 4) == \
        jpartition_addresses("tcp://one", 4)


# -- parallel assembly -------------------------------------------------------------


def test_parallel_assembler_loses_and_duplicates_no_slot():
    """16 writer threads (more than the cores) with a short switch
    interval: every item lands in exactly one slot of one batch."""
    import sys

    schema = StreamSchema.infer(_item(0))
    asm = ParallelBatchAssembler(schema, batch_size=8, num_buffers=24)
    seen, sizes = [], []
    lock = threading.Lock()

    def writer(lo, hi):
        for i in range(lo, hi):
            pending, slot = asm.reserve()
            batch = asm.write(pending, slot, _item(i))
            if batch is not None:
                with lock:
                    seen.extend(int(v) for v in batch["frameid"])
                    sizes.append(len(batch["_meta"]))

    threads = [threading.Thread(target=writer, args=(k * 50, (k + 1) * 50))
               for k in range(16)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert sorted(seen) == list(range(800))
    assert sizes == [8] * 100


def test_parallel_assembler_flush_partial():
    asm = ParallelBatchAssembler(StreamSchema.infer(_item(0)), batch_size=4,
                                 num_buffers=3)
    assert asm.flush() is None
    for i in range(3):
        assert asm.add(_item(i)) is None
    tail = asm.flush()
    assert tail["_partial"] is True
    assert [int(v) for v in tail["frameid"]] == [0, 1, 2]
    assert len(tail["_meta"]) == 3
    assert asm.flush() is None


# -- the worker pool over plain iterables ------------------------------------------


@pytest.mark.parametrize("partial", [True, False])
def test_sharded_ingest_counts_and_tail_match_jax(partial):
    def streams():
        return [[_item(i) for i in range(k, 60, 3)] for k in range(3)]

    got, jgot = [], []
    ingest = ShardedHostIngest(streams(), batch_size=8,
                               emit_partial_final=partial)
    tails = []
    for b in ingest:  # buffers recycle: read each batch as it comes
        got.extend(int(v) for v in b["frameid"])
        if b.get("_partial"):
            tails.append(len(b["frameid"]))
    for b in JShardedHostIngest(streams(), batch_size=8,
                                emit_partial_final=partial):
        jgot.extend(int(v) for v in b["frameid"])
    assert len(got) == len(set(got)) and len(jgot) == len(set(jgot))
    if partial:
        assert sorted(got) == sorted(jgot) == list(range(60))
        assert tails == [60 % 8]
    else:
        assert len(got) == len(jgot) == 56 and not tails
    assert ingest.items_in == 60 and sum(ingest.shard_items) == 60
    assert ingest.shard_items == [20, 20, 20]
    assert ingest.batches_out == 60 // 8 + (1 if partial else 0)


def test_sharded_ingest_propagates_a_shard_error():
    bad = dict(_item(1))
    bad["image"] = np.zeros((9, 9, 4), np.uint8)
    ingest = ShardedHostIngest([[_item(0)], [_item(2), bad]], batch_size=2)
    with pytest.raises(SchemaError):
        list(ingest)


def test_sharded_ingest_passes_prebatched_messages_through():
    msgs = [[{"_prebatched": True, "btid": k,
              "image__tileidx": np.zeros((4, 2), np.int32) + i}
             for i in range(3)] for k in range(2)]
    ingest = ShardedHostIngest(msgs, batch_size=4)
    got = list(ingest)
    assert len(got) == 6 and all("_prebatched" not in b for b in got)
    assert ingest.shard_items == [12, 12] and ingest.shard_batches == [3, 3]


def test_host_ingest_validate_every_and_partial_final():
    items = [_item(i) for i in range(10)]
    off_schema = dict(items[1], xy=items[1]["xy"].astype(np.float64))
    items_bad = [items[0], off_schema] + items[2:]
    with pytest.raises(SchemaError):
        list(HostIngest(iter(items_bad), batch_size=4))
    # one item in four is validated: item 1 is not, and its float64 xy is
    # copied into the float32 batch
    got = [(len(b["frameid"]), bool(b.get("_partial")))
           for b in HostIngest(iter(items_bad), batch_size=4,
                               validate_every=4, emit_partial_final=True)]
    assert got == [(4, False), (4, False), (2, True)]
    got = [len(b["frameid"]) for b in HostIngest(iter(items), batch_size=4)]
    assert got == [4, 4]  # the tail is dropped unless asked for


def test_inflate_pool_is_torn_down_from_one_side():
    class HookableEmpty:
        def __init__(self):
            self.pool = None

        def set_inflate_pool(self, pool):
            self.pool = pool

        def __iter__(self):
            return iter([])

    streams = [HookableEmpty(), HookableEmpty()]
    ingest = ShardedHostIngest(streams, batch_size=2, inflate_workers=2)
    ingest.start()
    assert streams[0].pool is not None and streams[0].pool is streams[1].pool
    list(ingest)  # to the end sentinel: the last worker shut the pool
    ingest.stop()
    assert ingest._inflate_pool is None
    ingest.stop()
    assert ingest._inflate_pool is None
    assert streams[0].pool._shutdown


# -- the worker pool over sockets --------------------------------------------------


def test_sharded_ingest_two_producers_two_shards():
    pubs = [DataPublisherSocket(WILD, btid=k) for k in range(2)]
    feeders = [_publish_async(p, [_item(k * 20 + i, k) for i in range(20)])
               for k, p in enumerate(pubs)]
    shards = partition_addresses([p.addr for p in pubs], 2)
    streams = [RemoteStream(s, timeoutms=10_000, max_items=40,
                            worker_index=i, num_workers=2, track_gaps=True)
               for i, s in enumerate(shards)]
    ingest = ShardedHostIngest(streams, batch_size=8)
    assert _frameids(ingest) == list(range(40))
    assert [s.messages for s in streams] == [20, 20]
    assert sum(s.seq_gaps for s in streams) == 0
    for t in feeders:
        t.join(timeout=10)
    for p in pubs:
        p.close()


def test_sharded_ingest_stop_answers_under_a_long_timeout():
    pub = DataPublisherSocket(WILD, btid=0)
    streams = [RemoteStream([pub.addr], timeoutms=60_000) for _ in range(2)]
    ingest = ShardedHostIngest(streams, batch_size=4).start()
    deadline = threading.Event()
    deadline.wait(0.6)  # both workers sit in the sliced poll
    ingest.stop(timeout=10.0)  # raises if a worker outlives the timeout
    assert not any(t.is_alive() for t in ingest._threads)
    pub.close()


def test_connect_and_disconnect_go_to_the_owning_shard():
    streams = [RemoteStream(["tcp://127.0.0.1:1", "tcp://127.0.0.1:2"]),
               RemoteStream(["tcp://127.0.0.1:3"])]
    ingest = ShardedHostIngest(streams, batch_size=2)
    ingest.connect("tcp://127.0.0.1:4")
    assert streams[1].addresses[-1] == "tcp://127.0.0.1:4"
    ingest.connect("tcp://127.0.0.1:1")  # already a member: no-op
    assert len(streams[0].addresses) == 2
    ingest.disconnect("tcp://127.0.0.1:2")
    assert streams[0].addresses == ["tcp://127.0.0.1:1"]
    assert list(streams[0]._membership_ops) == [
        ("disconnect", "tcp://127.0.0.1:2")]


def test_a_connect_is_applied_on_the_iterating_thread():
    pubs = [DataPublisherSocket(WILD, btid=k) for k in range(2)]
    stream = RemoteStream([pubs[0].addr], timeoutms=10_000, max_items=6)
    feeders = [_publish_async(p, [_item(k * 10 + i, k) for i in range(3)])
               for k, p in enumerate(pubs)]
    stream.connect(pubs[1].addr)
    got = sorted(int(m["frameid"]) for m in stream)
    assert got == [0, 1, 2, 10, 11, 12]
    for t in feeders:
        t.join(timeout=10)
    for p in pubs:
        p.close()


def test_shared_inflate_pool_keeps_content_and_order():
    pubs = [DataPublisherSocket(WILD, btid=i, compress_level=6,
                                compress_min_bytes=1024) for i in range(2)]
    ramp = np.tile(np.arange(64, dtype=np.uint8), 1024).reshape(256, 256)
    n_per = 8

    def feed():
        for i in range(n_per):
            for p in pubs:
                p.publish(image=ramp + (i % 4), frameid=i)

    streams = [RemoteStream([p.addr], timeoutms=10_000, max_items=n_per)
               for p in pubs]
    order = [[] for _ in pubs]
    for k, s in enumerate(streams):
        s.item_transform = (
            lambda m, k=k: order[k].append(m["frameid"]) or m)
    ingest = ShardedHostIngest(streams, batch_size=4, inflate_workers=2)
    t = threading.Thread(target=feed)
    t.start()
    n = 0
    for b in ingest:
        for row, fid in zip(b["image"], b["frameid"]):
            np.testing.assert_array_equal(row, ramp + (int(fid) % 4))
            n += 1
    t.join()
    assert n == 2 * n_per
    assert ingest._inflate_pool is None  # shut with the workers
    assert [s.pool_decodes for s in streams] == [n_per, n_per]
    assert order == [list(range(n_per))] * 2  # receive order per producer
    assert sum(s.seq_gaps + s.restarts for s in streams) == 0
    assert all(s.counts.compressed_bytes < s.counts.raw_bytes
               for s in streams)
    for p in pubs:
        p.close()


def test_inflate_workers_zero_keeps_inline_decode():
    pub = DataPublisherSocket(WILD, btid=0, compress_level=6,
                              compress_min_bytes=1024)
    ramp = np.tile(np.arange(64, dtype=np.uint8), 1024)
    stream = RemoteStream([pub.addr], timeoutms=10_000, max_items=3)
    ingest = ShardedHostIngest([stream], batch_size=3, inflate_workers=0)
    t = _publish_async(pub, [dict(image=ramp, frameid=i) for i in range(3)])
    assert _frameids(ingest) == [0, 1, 2]
    t.join()
    assert ingest._inflate_pool is None and stream.pool_decodes == 0
    pub.close()


def test_decode_ahead_never_receives_past_max_items():
    pub = DataPublisherSocket(WILD, btid=0, send_hwm=64, compress_level=6,
                              compress_min_bytes=1024)
    pub.sock.setsockopt(zmq.SNDTIMEO, 2000)
    ramp = np.tile(np.arange(64, dtype=np.uint8), 1024)
    n = 5

    def feed():
        for i in range(n + 3):
            try:
                pub.publish(image=ramp, frameid=i)
            except zmq.Again:
                return  # the consumer is gone

    stream = RemoteStream([pub.addr], timeoutms=10_000, max_items=n)
    with ThreadPoolExecutor(2) as pool:
        stream.set_inflate_pool(pool)
        t = threading.Thread(target=feed)
        t.start()
        got = list(stream)
        t.join(timeout=10.0)
    assert not t.is_alive()
    assert [int(m["frameid"]) for m in got] == list(range(n))
    assert stream.pool_decodes == n == stream.messages
    pub.close()


# -- the pipeline's ingest_workers -------------------------------------------------


def test_pipeline_ingest_workers_shards_the_producers():
    pubs = [DataPublisherSocket(WILD, btid=k) for k in range(3)]
    feeders = [_publish_async(p, [_item(k * 16 + i, k) for i in range(16)])
               for k, p in enumerate(pubs)]
    with StreamDataPipeline([p.addr for p in pubs], batch_size=8,
                            device="cpu", ingest_workers=2, timeoutms=10_000,
                            max_items=48) as pipe:
        got = sorted(int(v) for b in pipe for v in b["frameid"].reshape(-1))
    assert got == list(range(48))
    assert isinstance(pipe.ingest, ShardedHostIngest)
    stats = pipe.shard_stats()
    assert [len(s["addresses"]) for s in stats] == [2, 1]
    assert [s["messages"] for s in stats] == [32, 16]
    assert sum(s["items"] for s in stats) == 48
    assert pipe.seq_gaps == 0 and pipe.restarts == 0
    assert all(s.track_gaps for s in pipe.shards)
    for t in feeders:
        t.join(timeout=10)
    for p in pubs:
        p.close()


def test_pipeline_max_items_is_one_budget_across_unequal_shards():
    pubs = [DataPublisherSocket(WILD, btid=k) for k in range(2)]
    counts = [24, 8]  # an even split would wait on 8 that never come
    feeders = [_publish_async(p, [_item(k * 100 + i, k)
                                  for i in range(counts[k])])
               for k, p in enumerate(pubs)]
    with StreamDataPipeline([p.addr for p in pubs], batch_size=8,
                            device="cpu", ingest_workers=2, timeoutms=10_000,
                            max_items=32) as pipe:
        got = sorted(int(v) for b in pipe for v in b["frameid"].reshape(-1))
    assert got == sorted(list(range(24)) + [100 + i for i in range(8)])
    for t in feeders:
        t.join(timeout=10)
    for p in pubs:
        p.close()


def test_pipeline_falls_back_to_one_thread(caplog):
    pub = DataPublisherSocket(WILD, btid=0)
    feeder = _publish_async(pub, [_item(i) for i in range(8)])
    with StreamDataPipeline([pub.addr], batch_size=4, device="cpu",
                            ingest_workers=2, timeoutms=10_000,
                            max_items=8) as pipe:
        got = sorted(int(v) for b in pipe for v in b["frameid"].reshape(-1))
    assert got == list(range(8))
    assert isinstance(pipe.ingest, HostIngest)
    feeder.join(timeout=10)
    pub.close()
    pipe = StreamDataPipeline(iter([_item(i) for i in range(4)]),
                              batch_size=4, device="cpu", ingest_workers=2)
    assert len(list(pipe)) == 1 and isinstance(pipe.ingest, HostIngest)
    warned = [r.getMessage() for r in caplog.records]
    assert any("only one producer address" in m for m in warned)
    assert any("opaque iterable" in m for m in warned)


def test_pipeline_rejects_worker_kwargs_with_sharding():
    with pytest.raises(ValueError, match="worker"):
        StreamDataPipeline(["tcp://a", "tcp://b"], batch_size=4,
                           device="cpu", ingest_workers=2, num_workers=2)


@pytest.mark.parametrize("decode_ahead", [False, True])
def test_the_stream_records_exactly_what_it_received(tmp_path, decode_ahead):
    """The tee sees the messages in the order ingest does, with decode-
    ahead on and off, and a recording made from a stream stopped at
    max_items holds exactly the `received` messages; the JAX package's
    reader replays it to the same messages."""
    from blendjax.data.replay import FileReader as JFileReader
    from blendjax_torch.data import FileReader

    pub = DataPublisherSocket(WILD, btid=0)
    feeder = _publish_async(pub, [_item(i) for i in range(12)])
    prefix = str(tmp_path / "rec")
    stream = RemoteStream([pub.addr], timeoutms=10_000, max_items=7,
                          record_path_prefix=prefix)
    pool = ThreadPoolExecutor(2) if decode_ahead else None
    stream.set_inflate_pool(pool)
    try:
        got = [int(m["frameid"]) for m in stream]
    finally:
        if pool is not None:
            pool.shutdown()
    feeder.join(timeout=10)
    pub.close()
    assert got == list(range(7))
    path = str(tmp_path / "rec_00.bjr")
    port, jax_side = FileReader(path), JFileReader(path)
    assert len(port) == len(jax_side) == stream.received >= 7
    for i in range(len(port)):
        a, b = port[i], jax_side[i]
        assert a["_seq"] == b["_seq"] == i  # recorded with their stamps
        assert int(a["frameid"]) == int(b["frameid"]) == i
        np.testing.assert_array_equal(a["image"], b["image"])


def test_enable_recording_and_the_shards_record_per_worker(tmp_path):
    """enable_recording on a pipeline's stream reaches every shard: each
    writes its own worker-indexed file, and from_recording of the prefix
    replays every message."""
    pubs = [DataPublisherSocket(WILD, btid=k) for k in range(2)]
    feeders = [_publish_async(p, [_item(k * 16 + i, k) for i in range(8)])
               for k, p in enumerate(pubs)]
    prefix = str(tmp_path / "rec")
    pipe = StreamDataPipeline([p.addr for p in pubs], batch_size=8,
                              device="cpu", ingest_workers=2,
                              timeoutms=10_000, max_items=16)
    pipe.stream.enable_recording(prefix)
    with pipe:
        live = sorted(int(v) for b in pipe for v in b["frameid"].reshape(-1))
    for t in feeders:
        t.join(timeout=10)
    for p in pubs:
        p.close()
    assert sorted(os.listdir(tmp_path)) == ["rec_00.bjr", "rec_01.bjr"]
    replay = StreamDataPipeline.from_recording(prefix, batch_size=8,
                                               device="cpu")
    with replay:
        again = sorted(int(v) for b in replay
                       for v in b["frameid"].reshape(-1))
    assert live == again == sorted([k * 16 + i for k in range(2)
                                    for i in range(8)])


def _cube_producer(tmp, wire, extra=()):
    import os
    import subprocess
    import sys
    import time

    from blendjax_torch.transport import REGISTRY_ENV

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    addr_file = os.path.join(tmp, f"{wire}.addr")
    env = dict(os.environ, PYTHONPATH=repo)
    env[REGISTRY_ENV] = os.path.join(tmp, "shm")
    proc = subprocess.Popen(
        [sys.executable, "-m", "blendjax_torch.producer.cube",
         "--addr-file", addr_file, "--btid", "0", "--seed", "3",
         "--shape", "64", "128", "--batch", "4", "--tile", "16", "32",
         "--tile-rgba", "--tile-capacity", "16", "--wire", wire, *extra],
        cwd=repo, env=env)
    deadline = time.monotonic() + 60
    while not os.path.exists(addr_file):
        assert proc.poll() is None, "producer exited before binding"
        assert time.monotonic() < deadline, "producer did not bind"
        time.sleep(0.05)
    with open(addr_file) as f:
        return proc, f.read().strip()


@pytest.mark.parametrize("wire,extra", [
    ("raw", ()), ("ndz", ()), ("ndr", ("--rle-cap", "512")), ("shm", ()),
])
def test_every_producer_wire_decodes_to_the_rendered_frames(tmp_path, wire,
                                                            extra):
    """The cube producer's --wire choices through the pipeline on the CPU:
    the decoded frames equal the scene rendered here, bit for bit; ndr
    arrives packed with the pinned capacity, shm through the ring."""
    from blendjax_torch.ops.tiles import decode_packed_superbatch
    from blendjax_torch.producer import CubeScene
    from blendjax_torch.transport import reap_registry

    proc, addr = _cube_producer(str(tmp_path), wire, extra)
    try:
        pipe = StreamDataPipeline([addr], batch_size=4, device="cpu",
                                  chunk=2, emit_packed=True, timeoutms=30_000,
                                  max_items=4)
        groups = list(pipe)
    finally:
        proc.terminate()
        proc.wait(timeout=20)
        detach_all()
    assert reap_registry(str(tmp_path / "shm")) == (wire == "shm")
    frames = []
    for g in groups:
        fields = decode_packed_superbatch(g["_packed"], g["_refs"], g["_spec"],
                                          g["_names"], g["_geoms"], g["_rle"])
        frames += list(fields["image"].reshape(-1, 64, 128, 4).numpy())
        if wire == "ndr":
            assert g["_rle"] and all(cap == 512 for _, (_, _, cap)
                                     in g["_rle"])
        else:
            assert not g["_rle"]
    scene = CubeScene(shape=(64, 128), seed=3)
    buf = np.empty((64, 128, 4), np.uint8)
    assert len(frames) == 16
    for f, got in enumerate(frames, start=1):
        scene.step(f)
        scene.render(out=buf)
        np.testing.assert_array_equal(got, buf)
    stats = pipe.shard_stats()[0]
    assert pipe.seq_gaps == 0 and stats["received"] == 4
    if wire == "shm":
        assert stats["shm_reads"] == 4 and stats["raw_bytes"] == 0
    if wire in ("ndz", "ndr"):
        assert stats["compressed_bytes"] < stats["raw_bytes"]


def test_wire_kwargs_follow_the_jax_synthetic_producer():
    from blendjax_torch.producer import cube

    def kw(*argv):
        return cube.wire_kwargs(cube.parse_args(list(argv)))

    assert kw() == {}
    assert kw("--wire", "ndz") == {"compress_min_bytes": 1024,
                                   "compress_level": 6}
    assert kw("--wire", "ndr", "--rle-cap", "96") == {
        "compress_min_bytes": 1024, "compress_rle": True, "rle_cap": 96}
    assert kw("--wire", "ndr")["rle_cap"] is None
    assert kw("--wire", "shm") == {"shm": 4}


# -- the whole slice ----------------------------------------------------------------

SHAPE = (32, 64)
TILE = (16, 32)
FRAMES = 16   # per producer
BATCH = 4
PRODUCERS = 4


class _Tee:
    """Publishes through the socket and keeps the message (for the JAX
    pipeline's decode of the same frames)."""

    def __init__(self, pub):
        self.pub = pub
        self.msgs = []

    def publish(self, **msg):
        self.msgs.append(dict(msg, btid=self.pub.btid))
        self.pub.publish(**msg)


def _producer_thread(pub, seed):
    from blendjax_torch.producer import CubeScene, TileBatchPublisher

    scene = CubeScene(shape=SHAPE, seed=seed)
    tee = _Tee(pub)
    tp = TileBatchPublisher(tee, scene.background_image(), BATCH, tile=TILE,
                            alpha_slice=False, capacity=4)
    buf = np.empty((*SHAPE, 4), np.uint8)

    def run():
        for f in range(1, FRAMES + 1):
            scene.step(f)
            scene.render(out=buf)
            tp.add(buf, xy=scene.camera.world_to_pixel(
                scene.corners_world()).astype(np.float32),
                frameid=np.int64(f))

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, tee


def _run_slice(**pub_kwargs):
    """Four publishers -> the sharded pipeline on the CPU; returns the
    chunk groups it yielded, per batch keyed by (btid, first frameid),
    the messages published, and the pipeline."""
    pubs = [DataPublisherSocket(WILD, btid=k, **pub_kwargs)
            for k in range(PRODUCERS)]
    started = [_producer_thread(p, seed=k) for k, p in enumerate(pubs)]
    pipe = StreamDataPipeline(
        [p.addr for p in pubs], batch_size=BATCH, device="cpu", chunk=4,
        emit_packed=True, ingest_workers=2, timeoutms=20_000,
        max_items=PRODUCERS * FRAMES // BATCH)
    batches = {}
    groups = 0
    try:
        for g in pipe:
            groups += 1
            assert g["_packed"].shape[0] <= 4
            for k, rest in enumerate(g["_meta"]):
                row = {
                    "packed": g["_packed"][k].clone(), "rest": rest,
                    "refs": g["_refs"], "plan": (g["_spec"], g["_names"],
                                                 g["_geoms"], g["_rle"]),
                }
                from blendjax_torch.ops.tiles import decode_packed_superbatch

                fields = decode_packed_superbatch(
                    row["packed"][None], g["_refs"], *row["plan"])
                fids = tuple(int(v) for v in fields["frameid"][0])
                key = (rest["btid"], fids[0])
                assert key not in batches, f"batch {key} arrived twice"
                row["fields"] = {f: v[0] for f, v in fields.items()}
                batches[key] = row
    finally:
        pipe.stop()
        for t, _ in started:
            t.join(timeout=20)
        detach_all()
        for p in pubs:
            p.close()
    msgs = [m for _, tee in started for m in tee.msgs]
    return batches, msgs, pipe, groups


def _canonical_losses(batches):
    """The fused step over the received batches in (btid, frameid) order,
    four per call, from one seeded state."""
    from blendjax_torch.models import CubeRegressor
    from blendjax_torch.train import make_fused_tile_step, make_train_state

    state = make_train_state(CubeRegressor(features=(8, 16)).init_params(0),
                             device="cpu")
    step = make_fused_tile_step()
    keys = sorted(batches)
    losses = []
    for i in range(0, len(keys), 4):
        rows = [batches[k] for k in keys[i:i + 4]]
        assert all(r["plan"] == rows[0]["plan"] for r in rows)
        spec, names, geoms, rle = rows[0]["plan"]
        group = {"_packed": torch.stack([r["packed"] for r in rows]),
                 "_refs": rows[0]["refs"], "_spec": spec, "_names": names,
                 "_geoms": geoms, "_rle": rle,
                 "_meta": [r["rest"] for r in rows]}
        state, out = step(state, group)
        losses.append(float(out["loss"].reshape(-1)[-1]))
    return losses


def test_whole_slice_every_frame_once_and_bit_equal_with_jax():
    from blendjax.data import StreamDataPipeline as JPipeline

    batches, msgs, pipe, groups = _run_slice()
    want = {(b, f) for b in range(PRODUCERS) for f in range(1, FRAMES + 1)}
    got = [(k[0], int(f)) for k, r in batches.items()
           for f in r["fields"]["frameid"]]
    assert len(got) == len(set(got)) and set(got) == want
    assert pipe.seq_gaps == 0 and pipe.restarts == 0
    stats = pipe.shard_stats()
    assert len(stats) == 2 and all(s["items"] > 0 for s in stats)
    assert sum(s["messages"] for s in stats) == PRODUCERS * FRAMES // BATCH
    assert groups >= PRODUCERS * FRAMES // BATCH // 4
    # the JAX pipeline's decode of the same published messages
    jpipe = JPipeline(iter([dict(m) for m in msgs]), batch_size=BATCH)
    jframes = {}
    for b in jpipe:
        for fid, img in zip(np.asarray(b["frameid"]), np.asarray(b["image"])):
            jframes[(int(b["btid"]), int(fid))] = img
    assert set(jframes) == want
    for (btid, _), row in batches.items():
        for fid, img in zip(row["fields"]["frameid"], row["fields"]["image"]):
            np.testing.assert_array_equal(img.numpy(),
                                          jframes[(btid, int(fid))])
    losses = _canonical_losses(batches)
    assert len(losses) == 4 and all(np.isfinite(losses))


def test_whole_slice_shm_trains_exactly_as_the_raw_wire():
    raw, _, _, _ = _run_slice()
    via_shm, _, pipe, _ = _run_slice(shm=4)
    stats = pipe.shard_stats()
    assert sum(s["shm_reads"] for s in stats) == sum(
        s["received"] for s in stats) == len(via_shm)
    assert sum(s["shm_torn"] + s["raw_bytes"] for s in stats) == 0
    assert set(raw) == set(via_shm)
    for k in raw:
        assert torch.equal(raw[k]["packed"], via_shm[k]["packed"])
    assert _canonical_losses(raw) == _canonical_losses(via_shm)
