"""Record and replay of blendjax_torch against the JAX package on the CPU.

- The ``.bjr`` container: a recording written by either package is read by
  the other message for message (arrays equal, stamps kept), a recording
  cut short is recovered to the same offsets by both, and a reference
  ``.btr`` replays only behind ``allow_pickle=True``.
- ``StreamDataPipeline.from_recording``: a recorded tile stream (cube
  frames) replays on both packages to identical decoded batches, bit for
  bit, in the decoded and the chunked form, with the lineage stamps
  stripped; ``loop=True`` repeats the recording.
- ``EchoingPipeline(warm_start=)`` fills the reservoir from a recording
  before the first draw.

Tolerance: none; every comparison is exact.
"""

import copy
import os
import pickle

import numpy as np
import pytest
import torch

from blendjax.data import StreamDataPipeline as JaxPipeline
from blendjax.data import replay as jreplay
from blendjax_torch.data import StreamDataPipeline
from blendjax_torch.data import replay
from blendjax_torch.transport import wire

SHAPE = (32, 64)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


class _Capture:
    def __init__(self):
        self.msgs = []

    def publish(self, **msg):
        self.msgs.append(msg)


def _tile_messages(n_frames=16, batch=2, seed=3, rgba=True):
    """A cube producer's messages, stamped as a publisher stamps them."""
    from blendjax_torch.producer import CubeScene, TileBatchPublisher

    scene = CubeScene(shape=SHAPE, seed=seed)
    cap = _Capture()
    tp = TileBatchPublisher(cap, scene.background_image(), batch,
                            tile=(16, 32), alpha_slice=not rgba, capacity=4)
    buf = np.empty((*SHAPE, 4), np.uint8)
    for f in range(1, n_frames + 1):
        scene.step(f)
        scene.render(out=buf)
        tp.add(buf, hint=scene.raster.last_drawn,
               xy=np.full((8, 2), f, np.float32), frameid=np.int64(f))
    for i, m in enumerate(cap.msgs):
        m.update(btid=0, _seq=i, _pub_wall=1.5, _pub_mono=2.5)
    return cap.msgs


def _record(recorder_cls, path, msgs):
    with recorder_cls(path) as rec:
        for m in msgs:
            rec.save(wire.encode_message(dict(m)))


def _same(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k, v in a.items():
        if isinstance(v, np.ndarray):
            assert v.dtype == b[k].dtype and v.shape == b[k].shape, k
            np.testing.assert_array_equal(v, b[k])
        else:
            assert v == b[k], k


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_recordings_read_across_packages(tmp_path, writer):
    """Each package reads the other's recording: the same messages with
    their stamps, in order; the file bytes are the same whoever wrote."""
    msgs = _tile_messages()
    paths = {w: str(tmp_path / f"{w}_00.bjr") for w in ("port", "jax")}
    _record(replay.FileRecorder, paths["port"], msgs)
    _record(jreplay.FileRecorder, paths["jax"], msgs)
    with open(paths["port"], "rb") as f, open(paths["jax"], "rb") as g:
        assert f.read() == g.read()
    for reader in (replay.FileReader(paths[writer]),
                   jreplay.FileReader(paths[writer])):
        assert len(reader) == len(msgs)
        for i, m in enumerate(msgs):
            _same(reader[i], m)
        reader.close()
    assert replay.FileRecorder.filename("p", 3) == "p_03.bjr"


def test_a_cut_recording_recovers_as_in_the_jax_package(tmp_path):
    msgs = _tile_messages()
    path = str(tmp_path / "cut_00.bjr")
    _record(replay.FileRecorder, path, msgs)
    data = open(path, "rb").read()
    open(path, "wb").write(data[: len(data) - 8 * len(msgs) - 40])
    for mod in (replay, jreplay):
        with pytest.raises(ValueError, match="footer"):
            mod.FileReader(path)
    got = replay.FileReader.recover(path)
    assert got == jreplay.FileReader.recover(path)
    assert 1 <= len(got) < len(msgs)


def _write_reference_btr(path, messages, capacity=16):
    """The reference blendtorch's .btr: one pickler (protocol 3) dumps an
    int64 offset header, then each message; the header is rewritten with
    the offsets on close, -1 marking unused slots."""
    with open(path, "wb") as f:
        pickler = pickle.Pickler(f, protocol=3)
        offsets = np.full(capacity, -1, dtype=np.int64)
        pickler.dump(offsets)
        for i, msg in enumerate(messages):
            offsets[i] = f.tell()
            pickler.dump(msg)
        f.seek(0)
        pickle.Pickler(f, protocol=3).dump(offsets)


def test_a_legacy_btr_replays_only_with_allow_pickle(tmp_path):
    items = [{"image": np.full((4, 4, 3), i, np.uint8), "frameid": i}
             for i in range(5)]
    path = str(tmp_path / "legacy_00.btr")
    _write_reference_btr(path, items)
    with pytest.raises(ValueError, match="allow_pickle"):
        replay.open_reader(path)
    reader = replay.open_reader(path, allow_pickle=True)
    assert isinstance(reader, replay.LegacyBtrReader) and len(reader) == 5
    assert [reader[i]["frameid"] for i in (4, 0, 2)] == [4, 0, 2]
    ds = replay.FileDataset(str(tmp_path / "legacy"), allow_pickle=True)
    assert [int(ds[i]["frameid"]) for i in range(len(ds))] == list(range(5))


def _host(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@pytest.mark.parametrize("chunk", [1, 2])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_from_recording_decodes_as_the_jax_pipeline(tmp_path, chunk, writer):
    """A recorded tile stream through from_recording on both packages:
    the decoded batches are identical (frames, sidecars, shapes), the
    lineage stamps are gone, and on the port they equal the live
    pipeline's batches over the same messages."""
    msgs = _tile_messages()
    prefix = str(tmp_path / "rec")
    rec = replay.FileRecorder if writer == "port" else jreplay.FileRecorder
    _record(rec, f"{prefix}_00.bjr", msgs)
    got = list(StreamDataPipeline.from_recording(prefix, batch_size=2,
                                                 device="cpu", chunk=chunk))
    with JaxPipeline.from_recording(prefix, batch_size=2, chunk=chunk) as p:
        want = list(p)
    live = list(StreamDataPipeline(
        iter([{k: v for k, v in m.items()
               if k not in ("_seq", "_pub_wall", "_pub_mono")}
              for m in copy.deepcopy(msgs)]),
        batch_size=2, device="cpu", chunk=chunk))
    assert len(got) == len(want) == len(live) == 8 // chunk
    for g, w, li in zip(got, want, live):
        assert not any(k in g for k in ("_seq", "_pub_wall", "_pub_mono"))
        for k in ("image", "xy", "frameid"):
            np.testing.assert_array_equal(_host(g[k]), np.asarray(w[k]))
            assert torch.equal(g[k], li[k])


def test_from_recording_loops_and_strips_stamps(tmp_path):
    msgs = _tile_messages(n_frames=4)
    path = str(tmp_path / "one.bjr")
    _record(replay.FileRecorder, path, msgs)
    stream = replay.ReplayStream(path, loop=True)
    seen = []
    for m in stream:
        assert "_seq" not in m and "_pub_wall" not in m
        seen.append(list(m["frameid"]))
        if len(seen) == 5:
            break
    assert seen == [[1, 2], [3, 4], [1, 2], [3, 4], [1, 2]]
    pipe = StreamDataPipeline.from_recording(path, batch_size=2, device="cpu",
                                             loop=True, emit_packed=True,
                                             chunk=2)
    it = iter(pipe)
    groups = [next(it) for _ in range(3)]
    pipe.stop()
    assert all(g["_packed"].shape[0] == 2 for g in groups)
    with pytest.raises(FileNotFoundError):
        replay.ReplayStream(str(tmp_path / "nothing"))


def test_echo_warm_start_fills_the_reservoir_from_a_recording(tmp_path):
    """warm_start inserts one reservoir's worth of recorded batches before
    the first draw: the first draw needs no live frame."""
    from blendjax_torch.data import EchoingPipeline

    msgs = _tile_messages(n_frames=16)
    path = str(tmp_path / "warm.bjr")
    _record(replay.FileRecorder, path, msgs)
    echo = EchoingPipeline(iter([]), capacity=8, batch_size=2,
                           max_echo_factor=2, augment=None, warm_start=path,
                           device="cpu")
    draws = list(echo)
    assert echo.stats["inserted"] == 8 and len(draws) == 8
    frames = {int(v) for d in draws for v in d["frameid"]}
    assert frames == set(range(1, 9))
    assert echo.fresh + echo.echoed == 16


# -- recordings of a mesh's ranks ---------------------------------------------


def test_each_rank_of_a_mesh_records_under_a_prefix_of_its_own(tmp_path):
    """Rank-tagged prefixes: distinct files per rank, out of reach of the
    one-card glob; the world size is read back, and a recording with a rank
    missing or with two world sizes is refused."""
    prefix = str(tmp_path / "rec")
    names = [replay.rank_prefix(prefix, r, 2) for r in range(2)]
    assert names == [f"{prefix}.rank0-of-2", f"{prefix}.rank1-of-2"]
    assert replay.recorded_world(prefix) is None
    _record(replay.FileRecorder, f"{names[0]}_00.bjr", _tile_messages(4))
    with pytest.raises(ValueError, match="ranks \\[0\\] only"):
        replay.recorded_world(prefix)
    _record(replay.FileRecorder, f"{names[1]}_00.bjr", _tile_messages(4))
    assert replay.recorded_world(prefix) == 2
    with pytest.raises(FileNotFoundError):  # not a one-card recording
        replay.ReplayStream(prefix)
    _record(replay.FileRecorder,
            f"{replay.rank_prefix(prefix, 0, 3)}_00.bjr", _tile_messages(4))
    with pytest.raises(ValueError, match="several world sizes"):
        replay.recorded_world(prefix)


@pytest.mark.parametrize("chunk", [1, 2])
def test_a_two_rank_recording_assembles_global_batches_on_one_card(
        tmp_path, chunk):
    """On one card a two-rank tile recording replays as global batches of
    rank 0's rows, then rank 1's, each decoded with its rank's own
    references; the packed form asks for decoded batches instead."""
    prefix = str(tmp_path / "rec")
    for r in range(2):
        _record(replay.FileRecorder,
                f"{replay.rank_prefix(prefix, r, 2)}_00.bjr",
                _tile_messages(seed=3 + r))
    parts = [list(StreamDataPipeline.from_recording(
        f"{replay.rank_prefix(prefix, r, 2)}_00.bjr", batch_size=2,
        device="cpu", chunk=chunk)) for r in range(2)]
    for packed in (False, True):
        pipe = StreamDataPipeline.from_recording(
            prefix, batch_size=4, device="cpu", chunk=chunk,
            emit_packed=packed)
        assert pipe.world == 2 and pipe.batch_size == 4
        with pipe:
            got = list(pipe)
        assert len(got) == len(parts[0]) == 8 // chunk
        for g, a, b in zip(got, *parts):
            for k in ("image", "xy", "frameid"):
                assert torch.equal(g[k], torch.cat([a[k], b[k]],
                                                   dim=chunk - 1))
