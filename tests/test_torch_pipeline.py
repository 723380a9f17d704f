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
         "--shape", "64", "128", "--batch", "4", "--tile", "16", "32",
         "--tile-rgba", "--tile-capacity", "16", "--frames", str(frames)],
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
