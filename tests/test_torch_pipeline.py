"""Wire, stream, pipeline and driver of blendjax_torch on the CPU.

The wire round trip runs in both directions between the two packages
(arrays identical); the end-to-end test starts a port producer process
and trains through StreamDataPipeline(emit_packed=True) and TrainDriver
with device="cpu".
"""

import math
import os
import subprocess
import sys
import time

import msgpack
import numpy as np
import pytest
import torch

from blendjax.transport import wire as jwire
from blendjax_torch.transport import wire

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """At most two torch threads: the suite runs six workers on eight
    cores beside timing-sensitive tests of the JAX package."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _fresh_lineage():
    """The port's frame lineage is process-wide and keyed by producer btid,
    as the JAX package's is: a producer of one test reusing the btid of an
    earlier test's would read as a restart. Each test starts from none."""
    from blendjax_torch.obs.lineage import lineage

    lineage.reset()


def _message():
    rng = np.random.default_rng(0)
    flat = np.repeat(rng.integers(0, 4, (4, 64), dtype=np.uint8), 64, axis=1)
    return {
        "raw": rng.integers(0, 256, (3, 5), dtype=np.uint8),
        "xy": rng.normal(size=(4, 8, 2)).astype(np.float32),
        "zeros": np.zeros((64, 64), np.int32),  # zlib-compressible
        "plane": flat,                          # run-length friendly
        "btid": 3,
        "shape": [480, 640, 4, 16, 32],
        "_prebatched": True,
    }


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("defer", [False, True])
def test_wire_round_trip_between_packages(direction, defer):
    msg = _message()
    kw = dict(compress_level=1, compress_min_bytes=1024, compress_rle=True)
    if direction == "jax_to_port":
        frames = jwire.encode_message(msg, **kw)
        out = wire.decode_message(frames, defer_rle=defer)
    else:
        frames = wire.encode_message(msg, **kw)
        out = jwire.decode_message(frames, defer_rle=defer)
    header_kinds = {
        e[0] for e in msgpack.unpackb(bytes(frames[0])[4:], raw=False)[1]
    }
    assert {"nd", "ndz", "ndr", "obj"} <= header_kinds
    if defer:
        from blendjax_torch.ops.tiles import rle_expand_packed_np

        shape, isz, cap = out.pop("plane__ndrspec")
        out["plane"] = rle_expand_packed_np(out.pop("plane__ndr"), shape,
                                            isz, cap)
    assert set(out) == set(msg)
    for k, v in msg.items():
        if isinstance(v, np.ndarray):
            assert out[k].dtype == v.dtype
            np.testing.assert_array_equal(out[k], v)
        else:
            assert out[k] == v


def test_wire_refuses_what_it_does_not_carry():
    """A value msgpack cannot carry rides as an embedded pickle, as in the
    JAX package; the port decodes it only when asked (allow_pickle)."""
    assert wire.encode_message({"obj": {1, 2}})[0] == jwire.encode_message(
        {"obj": {1, 2}})[0]
    frames = jwire.encode_message({"obj": {1, 2}})  # embedded pickle
    with pytest.raises(ValueError, match="allow_pickle"):
        wire.decode_message(frames)
    assert wire.decode_message(frames, allow_pickle=True) == {"obj": {1, 2}}


def test_stream_counts_sequence_gaps_and_restarts():
    from blendjax_torch.data import RemoteStream

    s = RemoteStream("tcp://127.0.0.1:1")
    for seq in (0, 1, 2, 5, 6):
        s._account({"btid": 0, "_seq": seq, "_pub_wall": 0, "_pub_mono": 0})
    for seq in (0, 1):
        s._account({"btid": 1, "_seq": seq})
    s._account({"btid": 1, "_seq": 0})
    assert (s.seq_gaps, s.restarts, s.messages) == (2, 1, 8)


def _fake_step(state, batch):
    state["n"] += 1
    return state, {"loss": torch.tensor([float(state["n"])])}


def test_train_driver_ring_stats():
    from blendjax_torch.train import TrainDriver

    drv = TrainDriver(_fake_step, {"n": 0}, inflight=2, sync_every=3)
    for _ in range(7):
        drv.submit({"x": np.zeros((2,))})
    state, loss = drv.finish()
    assert loss == 7.0 and state["n"] == 7
    # CPU steps are complete on return, so finished entries retire before
    # the next submit and each sync reads the step just taken
    assert drv.losses == [3.0, 6.0, 7.0]
    st = drv.stats
    assert (st["steps"], st["dispatches"], st["syncs"]) == (7, 7, 3)
    assert st["host_blocks"] == 0 and st["inflight_hwm"] >= 1


def test_train_driver_pads_partial_batches():
    from blendjax_torch.train import TrainDriver

    seen = []

    def step(state, batch):
        seen.append(batch)
        return state, {"loss": torch.zeros(())}

    drv = TrainDriver(step, None, buckets=(1, 2, 4))
    drv.submit({"x": np.ones((3, 2), np.float32), "_partial": True})
    assert seen[0]["x"].shape == (4, 2)
    np.testing.assert_array_equal(seen[0]["_mask"], [1, 1, 1, 0])


class _Capture:
    def __init__(self):
        self.msgs = []

    def publish(self, **msg):
        self.msgs.append(dict(msg, btid=0, _seq=len(self.msgs)))


def test_pipeline_groups_chunks_and_degrades_raw_batches():
    """Recorded messages (no sockets): K=2 groups form while layouts
    match; a raw batch flushes the open group and travels alone."""
    from blendjax_torch.data import StreamDataPipeline
    from blendjax_torch.producer import CubeScene, TileBatchPublisher

    scene = CubeScene(shape=(32, 64), seed=1)
    cap = _Capture()
    tp = TileBatchPublisher(cap, scene.background_image(), 2, tile=(16, 32),
                            alpha_slice=False, capacity=4)
    buf = np.empty((32, 64, 4), np.uint8)
    for f in range(1, 7):
        scene.step(f)
        scene.render(out=buf)
        tp.add(buf, xy=np.zeros((8, 2), np.float32), frameid=np.int64(f))
    msgs = cap.msgs[:2] + [{
        "_batched": True, "image": np.zeros((2, 32, 64, 4), np.uint8),
        "xy": np.zeros((2, 8, 2), np.float32),
    }] + cap.msgs[2:]
    pipe = StreamDataPipeline(iter(msgs), batch_size=2, device="cpu", chunk=2,
                              emit_packed=True)
    out = list(pipe)
    assert [("_packed" in b) for b in out] == [True, False, True]
    assert out[0]["_packed"].shape[0] == 2 and out[2]["_packed"].shape[0] == 1
    assert out[1]["image"].shape == (1, 2, 32, 64, 4)
    assert isinstance(out[0]["_packed"], torch.Tensor)


def test_decoded_form_yields_frames_decoded_on_the_device():
    """emit_packed=False, chunk=1: every tile batch arrives decoded,
    bit-exact with the rendered frames, with its sidecars and host fields;
    a raw batch passes as it is."""
    from blendjax_torch.data import StreamDataPipeline
    from blendjax_torch.producer import CubeScene, TileBatchPublisher

    scene = CubeScene(shape=(32, 64), seed=2)
    cap = _Capture()
    tp = TileBatchPublisher(cap, scene.background_image(), 2, tile=(16, 32),
                            alpha_slice=False, capacity=4)
    buf = np.empty((32, 64, 4), np.uint8)
    frames = []
    for f in range(1, 7):
        scene.step(f)
        scene.render(out=buf)
        frames.append(buf.copy())
        tp.add(buf, xy=np.full((8, 2), f, np.float32), frameid=np.int64(f))
    raw = {"_batched": True, "image": np.full((2, 32, 64, 4), 7, np.uint8),
           "xy": np.zeros((2, 8, 2), np.float32)}
    msgs = cap.msgs[:2] + [raw] + cap.msgs[2:]
    pipe = StreamDataPipeline(iter(msgs), batch_size=2, device="cpu",
                              emit_packed=False)
    assert pipe.tiles.emit_packed is False
    out = list(pipe)
    assert len(out) == 4 and not any("_packed" in b for b in out)
    tiles = [b for i, b in enumerate(out) if i != 2]
    np.testing.assert_array_equal(
        torch.cat([b["image"] for b in tiles]).numpy(), np.stack(frames))
    np.testing.assert_array_equal(
        torch.cat([b["xy"][:, 0, 0] for b in tiles]).numpy(), np.arange(1, 7))
    assert [b["btid"] for b in tiles] == [0, 0, 0]
    assert out[2]["image"].shape == (2, 32, 64, 4)
    assert int(out[2]["image"].float().mean()) == 7


def _producer(tmp, i, frames=-1):
    addr_file = os.path.join(tmp, f"p{i}.addr")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "blendjax_torch.producer.cube",
         "--addr-file", addr_file, "--btid", str(i), "--seed", str(i),
         "--shape", "64", "128", "--batch", "4", "--encoding", "tile",
         "--tile", "16", "32", "--tile-rgba", "--tile-capacity", "16",
         "--frames", str(frames)],
        cwd=REPO, env=env,
    )
    deadline = time.monotonic() + 60
    while not os.path.exists(addr_file):
        assert proc.poll() is None, "producer exited before binding"
        assert time.monotonic() < deadline, "producer did not bind"
        time.sleep(0.05)
    with open(addr_file) as f:
        return proc, f.read().strip()


def test_cpu_end_to_end_producer_pipeline_driver(tmp_path):
    from blendjax_torch.data import StreamDataPipeline
    from blendjax_torch.models import CubeRegressor
    from blendjax_torch.train import (
        TrainDriver,
        make_fused_tile_step,
        make_train_state,
    )

    proc, addr = _producer(str(tmp_path), 0)
    try:
        state = make_train_state(
            CubeRegressor(features=(8, 16)).init_params(0), device="cpu"
        )
        pipe = StreamDataPipeline([addr], batch_size=4, device="cpu",
                                  chunk=2, emit_packed=True, timeoutms=30_000)
        drv = TrainDriver(make_fused_tile_step(), state, inflight=2,
                          sync_every=2)
        try:
            for batch in pipe:
                assert batch["_geoms"] == ((64, 128, 4, 16, 32),)
                drv.submit(batch)
                if drv.steps >= 4:
                    break
            final = drv.drain()
        finally:
            pipe.stop()
    finally:
        proc.terminate()
        proc.wait(timeout=10)
    assert all(math.isfinite(v) for v in drv.losses) and math.isfinite(final)
    assert pipe.seq_gaps == 0
    assert drv.stats["dispatches"] == drv.stats["steps"] == 4
    assert state.step == 8  # chunk=2: two updates per step


# -- ragged tails, the decoded form's defaults (ROADMAP C1-C3) ----------------


def _items(n):
    for i in range(n):
        yield {"image": np.full((8, 8, 4), i, np.uint8),
               "xy": np.full((8, 2), i, np.float32)}


def _host(v):
    return np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)


def test_cpu_batches_keep_their_frames_while_later_ones_assemble():
    """C10: the CPU feeder copies each batch out of the assembler's pool
    (it once wrapped the pool's arrays without a copy, and the assembler
    filled them again while the consumer still held them): a consumer
    holding every batch (a recording replayed, a loop behind the ingest)
    sees each batch's own frames, in the stream's order."""
    from blendjax_torch.data import StreamDataPipeline

    msgs = [{"btid": 0, "_seq": i, "frameid": np.int64(i + 1),
             "image": np.full((4, 6, 4), i + 1, np.uint8)}
            for i in range(40)]
    batches = list(StreamDataPipeline(iter(msgs), batch_size=8,
                                      device="cpu"))
    assert len(batches) == 5
    for k, b in enumerate(batches):
        want = np.arange(8 * k + 1, 8 * k + 9)
        np.testing.assert_array_equal(b["frameid"].numpy(), want)
        np.testing.assert_array_equal(b["image"][:, 0, 0, 0].numpy(), want)


def test_a_batch_taken_from_the_ingest_stays_whole_while_it_runs_ahead():
    """C10: the ingest's pool holds the queue's batches, the one the
    consumer is placing and the one being assembled (it once held one
    fewer, and the ingest assembled into the batch the consumer had just
    taken as soon as the queue had room)."""
    from blendjax_torch.data.batcher import HostIngest

    msgs = [{"frameid": np.int64(i + 1),
             "image": np.full((4, 6, 4), i + 1, np.uint8)}
            for i in range(48)]
    ingest = HostIngest(iter(msgs), batch_size=8, prefetch=2)
    try:
        for k, b in enumerate(ingest):
            # the ingest fills the queue again and assembles one more
            ahead = min(len(msgs), 8 * (k + 4))
            deadline = time.monotonic() + 10
            while ingest.items_in < ahead and time.monotonic() < deadline:
                time.sleep(0.01)
            assert ingest.items_in >= ahead
            want = np.arange(8 * k + 1, 8 * k + 9)
            np.testing.assert_array_equal(b["frameid"], want)
            np.testing.assert_array_equal(b["image"][:, 0, 0, 0], want)
        assert k == 5
    finally:
        ingest.stop()


@pytest.mark.parametrize("emit_packed", [False, True])
@pytest.mark.parametrize("pad_partial", [True, False])
def test_ragged_tail_is_padded_as_the_reference_pads_it(emit_packed,
                                                        pad_partial):
    """7 items at batch 4 with emit_partial_final: by default the tail is
    a bucket of 4 rows with _mask [1, 1, 1, 0]; pad_partial=False keeps
    the 3-row _partial batch. The port's batches equal the JAX
    pipeline's, field for field and bit for bit, in the decoded form and
    in the packed form (where a raw batch travels as a K'=1 group)."""
    from blendjax.data import StreamDataPipeline as JaxPipeline
    from blendjax_torch.data import StreamDataPipeline

    kw = dict(batch_size=4, emit_partial_final=True, pad_partial=pad_partial,
              emit_packed=emit_packed)
    with StreamDataPipeline(_items(7), device="cpu", **kw) as pipe:
        got = list(pipe)
    with JaxPipeline(_items(7), **kw) as pipe:
        want = list(pipe)
    assert len(got) == len(want) == 2
    lead = 1 if emit_packed else 0  # the packed form's K'=1 axis
    tail = got[-1]
    if pad_partial:
        assert _host(tail["image"]).shape[lead] == 4
        assert _host(tail["_mask"]).reshape(-1).tolist() == [1, 1, 1, 0]
        assert "_partial" not in tail
    else:
        assert _host(tail["image"]).shape[lead] == 3
        assert tail["_partial"] is True and "_mask" not in tail
    for g, w in zip(got, want):
        arrays = sorted(k for k, v in w.items() if hasattr(v, "shape"))
        assert sorted(k for k, v in g.items() if hasattr(v, "shape")) == arrays
        for k in arrays:
            a, b = _host(g[k]), np.asarray(w[k])
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b)


def test_the_decoded_form_warns_of_no_superbatch(caplog):
    """C2: with emit_packed=False and chunk=1 a raw batch passes through
    unlifted and without the "K'=1 superbatch" warning, as in the JAX
    pipeline; the chunked form still warns."""
    import logging

    from blendjax_torch.data import StreamDataPipeline

    with caplog.at_level(logging.WARNING):
        out = list(StreamDataPipeline(_items(7), batch_size=4, device="cpu",
                                      emit_partial_final=True))
    assert [tuple(b["image"].shape) for b in out] == [(4, 8, 8, 4)] * 2
    assert not any("superbatch" in r.getMessage() for r in caplog.records)
    with caplog.at_level(logging.WARNING):
        out = list(StreamDataPipeline(_items(8), batch_size=4, device="cpu",
                                      chunk=2))
    assert [tuple(b["image"].shape) for b in out] == [(1, 4, 8, 8, 4)] * 2
    assert any("superbatch" in r.getMessage() for r in caplog.records)


def test_emit_packed_defaults_to_the_decoded_form_as_in_the_reference():
    """C3: the same call gives decoded batches on both packages."""
    import inspect

    from blendjax.data import StreamDataPipeline as JaxPipeline
    from blendjax_torch.data import StreamDataPipeline

    for cls in (StreamDataPipeline, JaxPipeline):
        params = inspect.signature(cls).parameters
        assert params["emit_packed"].default is False
        assert params["pad_partial"].default is True
    assert StreamDataPipeline([], batch_size=2,
                              device="cpu").tiles.emit_packed is False


def test_decoded_chunked_form_stacks_decoded_superbatches():
    """emit_packed=False with chunk=2 (it raised before this port had it):
    (K, B, ...) superbatches with one _meta entry per batch, equal to the
    packed groups decoded, and to the JAX pipeline's decoded chunk groups
    bit for bit."""
    from blendjax.data import StreamDataPipeline as JaxPipeline
    from blendjax_torch.data import StreamDataPipeline
    from blendjax_torch.ops.tiles import decode_packed_superbatch
    from blendjax_torch.producer import CubeScene, TileBatchPublisher

    scene = CubeScene(shape=(32, 64), seed=5)
    cap = _Capture()
    tp = TileBatchPublisher(cap, scene.background_image(), 2, tile=(16, 32),
                            alpha_slice=False, capacity=4)
    buf = np.empty((32, 64, 4), np.uint8)
    for f in range(1, 9):
        scene.step(f)
        scene.render(out=buf)
        tp.add(buf, xy=np.full((8, 2), f, np.float32), frameid=np.int64(f))
    import copy

    decoded = list(StreamDataPipeline(iter(copy.deepcopy(cap.msgs)),
                                      batch_size=2, device="cpu", chunk=2))
    packed = list(StreamDataPipeline(iter(copy.deepcopy(cap.msgs)),
                                     batch_size=2, device="cpu", chunk=2,
                                     emit_packed=True))
    with JaxPipeline(iter(copy.deepcopy(cap.msgs)), batch_size=2,
                     chunk=2) as pipe:
        want = list(pipe)
    assert len(decoded) == len(packed) == len(want) == 2
    for d, p, w in zip(decoded, packed, want):
        assert d["image"].shape == (2, 2, 32, 64, 4)
        assert len(d["_meta"]) == 2 and "_packed" not in d
        fields = decode_packed_superbatch(p["_packed"], p["_refs"], p["_spec"],
                                          p["_names"], p["_geoms"], p["_rle"])
        for k in ("image", "xy", "frameid"):
            assert torch.equal(d[k], fields[k]), k
            np.testing.assert_array_equal(d[k].numpy(), np.asarray(w[k]))


# -- StreamDataPipeline(launcher=) -----------------------------------------------

CUBE = os.path.join(REPO, "blendjax_torch", "producer", "cube.py")
CUBE_ARGS = ["--shape", "64", "128", "--batch", "4", "--encoding", "tile",
             "--tile", "16", "32",
             "--tile-rgba", "--tile-capacity", "16"]


def _cube_launcher(n, frames=-1, respawn=False):
    from blendjax_torch.launcher import PythonProducerLauncher

    return PythonProducerLauncher(
        script=CUBE, num_instances=n, named_sockets=["DATA"], seed=0,
        instance_args=[CUBE_ARGS + ["--frames", str(frames)]] * n,
        respawn=respawn, proto="ipc", bind_grace_s=0.5,
    )


def test_a_launched_stream_gives_the_references_batches():
    """The port's cube producer, started by the port's launcher from its
    file, into ``StreamDataPipeline(launcher=)`` on each package (the
    decoded form): the same frames, labels and frame ids, batch for batch
    (one producer, so the order is fixed; the producers are launched
    twice with the same seed)."""
    from blendjax.data.pipeline import StreamDataPipeline as JPipeline
    from blendjax_torch.data import StreamDataPipeline

    out = {}
    for side in ("port", "jax"):
        with _cube_launcher(1, frames=24) as ln:
            if side == "port":
                pipe = StreamDataPipeline(
                    ln.addresses["DATA"], batch_size=4, device="cpu",
                    launcher=ln, timeoutms=30_000, max_items=6)
            else:
                pipe = JPipeline(ln.addresses["DATA"], batch_size=4,
                                 launcher=ln, timeoutms=30_000, max_items=6)
            with pipe:
                out[side] = [{k: np.asarray(b[k]) for k in
                              ("image", "xy", "frameid")} for b in pipe]
        assert pipe._auto_timeout
    assert len(out["port"]) == len(out["jax"]) == 6
    for a, b in zip(out["port"], out["jax"]):
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(
        np.concatenate([b["frameid"] for b in out["port"]]), np.arange(1, 25))


@pytest.mark.parametrize("workers", [1, 2])
def test_a_killed_producer_raises_the_launchers_error(workers):
    """respawn=False: SIGKILL a producer mid-stream; the stream's receive
    timeout asks the launcher, which raises its dead-producer error,
    within the timeout budget (one producer on the single ingest thread,
    two producers on two shards)."""
    import signal

    from blendjax_torch.data import StreamDataPipeline

    timeoutms = 3000
    with _cube_launcher(workers) as ln:
        pipe = StreamDataPipeline(
            ln.addresses["DATA"], batch_size=4, device="cpu", launcher=ln,
            timeoutms=timeoutms, ingest_workers=workers)
        it = iter(pipe)
        try:
            for _ in range(4):
                next(it)
            victim = ln.processes[workers - 1]
            os.kill(victim.pid, signal.SIGKILL)
            assert victim.wait(timeout=10) == -signal.SIGKILL
            t0 = time.monotonic()
            with pytest.raises(RuntimeError, match="died") as err:
                for _ in it:
                    assert time.monotonic() - t0 < 60, "no error raised"
            elapsed = time.monotonic() - t0
        finally:
            pipe.stop()
    assert f"{workers - 1}: -9" in str(err.value)
    assert elapsed < 2 * timeoutms / 1e3 + 5


def test_a_respawned_producer_counts_one_restart():
    """respawn=True on two shards: the killed producer's shard times out,
    the launcher respawns it (same btid and seed), the stream reads its
    fresh numbering as exactly one restart, and batches keep coming."""
    import signal

    from blendjax_torch.data import StreamDataPipeline

    with _cube_launcher(2, respawn=True) as ln:
        pipe = StreamDataPipeline(
            ln.addresses["DATA"], batch_size=4, device="cpu", launcher=ln,
            timeoutms=3000, ingest_workers=2)
        try:
            it = iter(pipe)
            deadline = time.monotonic() + 60
            # both producers streaming: a restart needs a first life
            while min(s.received for s in pipe.shards) < 2:
                assert time.monotonic() < deadline, "a producer never sent"
                next(it)
            first = ln.processes[1]
            os.kill(first.pid, signal.SIGKILL)
            first.wait(timeout=10)
            deadline = time.monotonic() + 60
            while pipe.restarts == 0:
                assert time.monotonic() < deadline, "no restart counted"
                next(it)
            for _ in range(8):  # training goes on
                next(it)
        finally:
            pipe.stop()
        assert ln.processes[1].pid != first.pid
        assert ln.processes[1].poll() is None
    assert pipe.restarts == 1
    assert pipe.seq_gaps == 0 and pipe.reorders == 0
    from blendjax_torch.obs.lineage import lineage

    assert lineage.report()["1"]["restarts"] == 1
    assert lineage.report()["0"]["restarts"] == 0


def test_a_callers_on_timeout_wins_over_the_launcher():
    from blendjax_torch.data import StreamDataPipeline

    class Launcher:
        def assert_alive(self):
            raise AssertionError("not consulted")

    hook = lambda: False  # noqa: E731
    pipe = StreamDataPipeline(["ipc:///nonexistent"], batch_size=2,
                              device="cpu", launcher=Launcher(),
                              on_timeout=hook, ingest_workers=1)
    assert not pipe._auto_timeout and pipe.stream.on_timeout is hook


# -- the registry sites, the receiver's pair, the stream options (C6-C8) -------


def _names_messages(n=6):
    rng = np.random.default_rng(0)
    for i in range(n):
        yield {"_batched": True, "btid": 0, "frameid": np.arange(4) + 4 * i,
               "image": rng.integers(0, 255, (4, 16, 16, 4), np.uint8),
               "xy": (rng.random((4, 8, 2)) * 16).astype(np.float32)}


def _names_run(pkg, directory):
    """A short recorded driver run: six messages through the pipeline into
    a ``TrainDriver`` with a snapshot manager, preempted after three
    steps; returns the registry's counter, gauge and span names."""
    if pkg == "port":
        from blendjax_torch.checkpoint import (
            PreemptionGuard,
            PreemptionRequested,
            SnapshotManager,
        )
        from blendjax_torch.data import StreamDataPipeline
        from blendjax_torch.models import CubeRegressor
        from blendjax_torch.train import (
            TrainDriver,
            make_supervised_step,
            make_train_state,
        )
        from blendjax_torch.utils.metrics import metrics
        state = make_train_state(CubeRegressor(features=(8,)).init_params(0),
                                 device="cpu")
        kw = {"device": "cpu"}
    else:
        from blendjax.checkpoint import (
            PreemptionGuard,
            PreemptionRequested,
            SnapshotManager,
        )
        from blendjax.data import StreamDataPipeline
        from blendjax.models import CubeRegressor
        from blendjax.train import (
            TrainDriver,
            make_supervised_step,
            make_train_state,
        )
        from blendjax.utils.metrics import metrics
        state = make_train_state(CubeRegressor(features=(8,)),
                                 np.zeros((4, 16, 16, 4), np.uint8))
        kw = {}
    metrics.reset()
    drv = TrainDriver(make_supervised_step(), state, inflight=2,
                      sync_every=1, checkpoint=SnapshotManager(directory),
                      checkpoint_every=0)
    guard = PreemptionGuard(drv, signals=())
    preempted = False
    try:
        with StreamDataPipeline(_names_messages(), batch_size=4,
                                **kw) as pipe:
            for i, b in enumerate(pipe):
                if i == 0:
                    time.sleep(0.5)  # the ingest queue fills on both sides
                if i == 3:
                    guard.request()
                drv.submit({k: b[k] for k in ("image", "xy")})
    except PreemptionRequested:
        preempted = True
    finally:
        guard.uninstall()
        drv.checkpoint.close()
    report = metrics.report()
    metrics.reset()
    assert preempted
    return {k: set(report[k]) for k in ("counters", "gauges", "spans")}


def test_a_driver_run_emits_the_reference_registry_names(tmp_path):
    """C6: the port's registry holds every counter, gauge and span name the
    JAX package's holds after the same run (``train.inflight_hwm`` on
    every dispatch, ``ckpt.preemptions`` before the preemption raises)."""
    got = _names_run("port", str(tmp_path / "port"))
    want = _names_run("jax", str(tmp_path / "jax"))
    for kind in ("counters", "gauges", "spans"):
        assert want[kind] <= got[kind], (kind, sorted(want[kind] - got[kind]))
    assert "train.inflight_hwm" in got["gauges"]
    assert "ckpt.preemptions" in got["counters"]


def test_a_driver_gauges_its_inflight_high_water_mark():
    from blendjax_torch.models import CubeRegressor
    from blendjax_torch.train import (
        TrainDriver,
        make_supervised_step,
        make_train_state,
    )
    from blendjax_torch.utils.metrics import metrics

    metrics.reset()
    drv = TrainDriver(make_supervised_step(), make_train_state(
        CubeRegressor(features=(8,)).init_params(0), device="cpu"),
        inflight=3, sync_every=0)
    batch = {"image": torch.zeros((2, 16, 16, 4), dtype=torch.uint8),
             "xy": torch.zeros((2, 8, 2))}
    for _ in range(3):
        drv.submit(batch)
    metrics.reset()  # a measured window starts: the gauge comes back
    drv.submit(batch)
    assert metrics.report()["gauges"]["train.inflight_hwm"] >= 1
    drv.finish()
    metrics.reset()


class _Event:
    """A pinned buffer's copy event that has not finished."""

    def __init__(self):
        self.waits = 0

    def query(self):
        return False

    def synchronize(self):
        self.waits += 1


def test_the_feeders_throttle_counts_its_waits_for_the_doctor():
    """C6: ``DeviceFeeder(throttle=)`` is the pinned ring's length; a
    placement that finds all of them still copying waits on the oldest,
    counted as ``feed.throttle_blocks`` under the ``feed.throttle_wait``
    span, which the doctor reads as feed-bound evidence. (The ring exists
    on the card only; its buffers are stood in for here.)"""
    from blendjax_torch.data.pipeline import DeviceFeeder
    from blendjax_torch.obs.doctor import diagnose
    from blendjax_torch.utils.metrics import metrics

    metrics.reset()
    feeder = DeviceFeeder(device="cpu", throttle=2)
    assert feeder.throttle == 2 and DeviceFeeder(device="cpu").throttle == 8
    arr = np.zeros((4, 4), np.uint8)
    events = [_Event(), _Event()]
    bufs = [torch.zeros(4, 4), torch.zeros(4, 4)]
    feeder._pinned[(arr.shape, arr.dtype.str)] = __import__(
        "collections").deque([[b, e] for b, e in zip(bufs, events)])
    entry = feeder._pinned_slot(arr)
    assert entry[0] is bufs[0] and events[0].waits == 1
    assert entry[1] is None  # taken until its placement records a copy
    report = metrics.report()
    assert report["counters"]["feed.throttle_blocks"] == 1
    assert report["spans"]["feed.throttle_wait"]["count"] == 1
    verdict = diagnose(report)
    assert verdict.shares["feed.throttle_wait"] > 0
    metrics.reset()


def test_a_finished_copy_frees_its_buffer_without_a_wait():
    from blendjax_torch.data.pipeline import DeviceFeeder
    from blendjax_torch.utils.metrics import metrics

    class Done(_Event):
        def query(self):
            return True

    metrics.reset()
    feeder = DeviceFeeder(device="cpu", throttle=0)
    arr = np.zeros((4, 4), np.uint8)
    done = Done()
    buf = torch.zeros(4, 4)
    slots = __import__("collections").deque([[buf, done]])
    feeder._pinned[(arr.shape, arr.dtype.str)] = slots
    assert feeder._pinned_slot(arr)[0] is buf and len(slots) == 1
    assert "feed.throttle_blocks" not in metrics.report()["counters"]


@pytest.mark.parametrize("throttle", [0, 1, 8])
def test_two_fields_of_one_shape_never_share_a_pinned_buffer(
        monkeypatch, throttle):
    """Two fields of one placement with the same shape and dtype (a
    supershape stream's ``shape_id`` and ``frameid``, both (B,) int64)
    get two pinned buffers, on the first batch and once the ring holds
    finished copies; at ``throttle=1`` the ring grows past it rather than
    hand one buffer out twice."""
    from blendjax_torch.data.pipeline import DeviceFeeder
    from blendjax_torch.utils.metrics import metrics

    class Done(_Event):
        def query(self):
            return True

    metrics.reset()
    feeder = DeviceFeeder(device="cpu", throttle=throttle)
    monkeypatch.setattr(feeder, "_pinned_buffer",
                        lambda arr: torch.from_numpy(np.empty_like(arr)))
    arr = np.zeros(8, np.int64)
    for _ in range(3):  # a first batch, then the steady state
        taken = [feeder._pinned_slot(arr) for _ in range(2)]
        assert taken[0][0] is not taken[1][0]
        assert all(e[1] is None for e in taken)
        for e in taken:  # the placement records its finished copies
            e[1] = Done()
    assert len(feeder._pinned[(arr.shape, arr.dtype.str)]) == 2
    assert "feed.throttle_blocks" not in metrics.report()["counters"]


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_chunk_strict_rejects_raw_messages(pkg):
    """C8: the JAX package's case (``tests/test_tiles.py``) on both
    packages: a non-tile message in a chunked stream raises."""
    if pkg == "port":
        from blendjax_torch.data import StreamDataPipeline
        kw = {"device": "cpu"}
    else:
        from blendjax.data import StreamDataPipeline
        kw = {}

    def messages():
        yield {"_batched": True, "btid": 0,
               "image": np.zeros((4, 32, 32, 4), np.uint8)}

    pipe = StreamDataPipeline(messages(), batch_size=4, chunk=4,
                              chunk_strict=True, **kw)
    with pytest.raises(RuntimeError, match="all-tile"):
        list(pipe)


def test_without_chunk_strict_a_raw_message_degrades():
    from blendjax_torch.data import StreamDataPipeline

    def messages():
        yield {"_batched": True, "btid": 0,
               "image": np.zeros((4, 32, 32, 4), np.uint8)}

    got = list(StreamDataPipeline(messages(), batch_size=4, chunk=4,
                                  device="cpu"))
    assert len(got) == 1 and got[0]["image"].shape == (1, 4, 32, 32, 4)


@pytest.mark.parametrize("source", ["iterable", "addresses"])
def test_an_unknown_stream_option_raises(source):
    """C8: options meant for a producers' stream raise ``TypeError`` on an
    iterable source too, instead of being kept and never read."""
    from blendjax_torch.data import StreamDataPipeline

    src = iter([]) if source == "iterable" else ["tcp://127.0.0.1:5555"]
    with pytest.raises(TypeError):
        StreamDataPipeline(src, batch_size=4, device="cpu",
                           no_such_option=1)
    if source == "iterable":
        with pytest.raises(TypeError, match="timeoutms"):
            StreamDataPipeline(iter([]), batch_size=4, device="cpu",
                               timeoutms=5)


def test_a_given_schema_is_the_streams_contract():
    """C8: ``schema=`` fixes the contract: an item that breaks it raises
    at ingest instead of being inferred."""
    from blendjax_torch.data import StreamDataPipeline
    from blendjax_torch.data.schema import SchemaError, StreamSchema

    schema = StreamSchema({"image": ((8, 8, 4), np.uint8)})
    assert schema.batch_shapes(2) == {"image": (2, 8, 8, 4)}
    good = [{"btid": 0, "image": np.zeros((8, 8, 4), np.uint8)}] * 2
    pipe = StreamDataPipeline(iter(good), batch_size=2, device="cpu",
                              schema=schema)
    assert pipe.schema is schema
    assert list(pipe)[0]["image"].shape == (2, 8, 8, 4)
    bad = [{"btid": 0, "image": np.zeros((4, 4, 4), np.uint8)}] * 2
    with pytest.raises(SchemaError):
        list(StreamDataPipeline(iter(bad), batch_size=2, device="cpu",
                                schema=schema))
