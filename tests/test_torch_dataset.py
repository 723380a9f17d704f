"""The port's ``RemoteIterableDataset`` through ``torch.utils.data.DataLoader``
against the JAX package's adapter on the same published tile-delta
messages: the same items with 0 and 2 workers, ``max_items`` counted after
the batch split, the trace and scenario stamps dropped, and recording
refused until the replay slice."""

import threading

import numpy as np
import pytest
import torch
import zmq
from torch.utils.data import DataLoader

from blendjax.data.torch_compat import (
    RemoteIterableDataset as JRemoteIterableDataset,
)
from blendjax_torch.data import RemoteIterableDataset
from blendjax_torch.transport import DataPublisherSocket

WILD = "tcp://127.0.0.1:*"
SHAPE = (32, 64)
FRAMES = 16
BATCH = 4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _tile_messages(seed=4, extra=None):
    """One cube producer's tile-delta messages, each carrying its
    reference (so every DataLoader worker can decode every message)."""
    from blendjax_torch.producer import CubeScene, TileBatchPublisher

    class Capture:
        def __init__(self):
            self.msgs = []

        def publish(self, **msg):
            self.msgs.append(dict(msg, **(extra or {})))

    scene = CubeScene(shape=SHAPE, seed=seed)
    cap = Capture()
    tp = TileBatchPublisher(cap, scene.background_image(), BATCH,
                            tile=(16, 32), alpha_slice=False, capacity=4,
                            ref_interval=1)
    buf = np.empty((*SHAPE, 4), np.uint8)
    for f in range(1, FRAMES + 1):
        scene.step(f)
        scene.render(out=buf)
        tp.add(buf, xy=np.full((8, 2), f, np.float32), frameid=np.int64(f))
    return cap.msgs


class _Looping:
    """A publisher thread that sends ``msgs`` round and round until
    stopped (several DataLoader workers share its fan-out)."""

    def __init__(self, msgs):
        self.pub = DataPublisherSocket(WILD, btid=0)
        self.pub.sock.setsockopt(zmq.SNDTIMEO, 200)
        self.stop = threading.Event()
        self.msgs = msgs
        self.t = threading.Thread(target=self._run, daemon=True)
        self.t.start()

    def _run(self):
        i = 0
        while not self.stop.is_set():
            try:
                self.pub.publish(**self.msgs[i % len(self.msgs)])
            except zmq.Again:
                continue
            i += 1

    def close(self):
        self.stop.set()
        self.t.join(timeout=10)
        self.pub.close()


def _jax_items(msgs):
    """The JAX adapter's items for one pass of ``msgs``, by frameid."""
    src = _Looping(msgs)
    try:
        ds = JRemoteIterableDataset([src.pub.addr], max_items=FRAMES,
                                    timeoutms=20_000)
        return {int(it["frameid"]): it for it in ds}
    finally:
        src.close()


@pytest.mark.parametrize("workers", [0, 2])
def test_dataloader_items_match_the_jax_adapter(workers):
    msgs = _tile_messages()
    want = _jax_items(msgs)
    assert sorted(want) == list(range(1, FRAMES + 1))
    src = _Looping(msgs)
    try:
        ds = RemoteIterableDataset([src.pub.addr], max_items=2 * FRAMES,
                                   timeoutms=20_000)
        kw = dict(multiprocessing_context="spawn") if workers else {}
        batches = list(DataLoader(ds, batch_size=BATCH, num_workers=workers,
                                  **kw))
    finally:
        src.close()
    n = 0
    for b in batches:
        assert isinstance(b["image"], torch.Tensor)
        assert b["image"].shape[1:] == (*SHAPE, 4)
        for fid, img, xy in zip(b["frameid"], b["image"], b["xy"]):
            ref = want[int(fid)]
            np.testing.assert_array_equal(img.numpy(), ref["image"])
            np.testing.assert_array_equal(xy.numpy(), ref["xy"])
            n += 1
    assert n == 2 * FRAMES  # max_items counts items, split over workers


def test_max_items_counts_items_after_the_split():
    msgs = _tile_messages(seed=5)
    src = _Looping(msgs)
    try:
        items = list(RemoteIterableDataset([src.pub.addr], max_items=10,
                                           timeoutms=20_000))
    finally:
        src.close()
    assert len(items) == 10  # 2.5 producer batches of 4
    assert all(it["image"].shape == (*SHAPE, 4) for it in items)
    assert all(it["image"].flags.writeable for it in items)


def test_trace_and_scenario_stamps_are_dropped():
    msgs = _tile_messages(seed=6, extra={"_trace": {"id": "x", "stages": []},
                                         "_scenario": {"name": "s"}})
    src = _Looping(msgs)
    try:
        batches = list(DataLoader(
            RemoteIterableDataset([src.pub.addr], max_items=8,
                                  timeoutms=20_000), batch_size=4))
    finally:
        src.close()
    assert len(batches) == 2
    assert not any(k.startswith("_") for b in batches for k in b)


def test_recording_is_refused_until_the_replay_slice():
    with pytest.raises(NotImplementedError, match="item 5"):
        RemoteIterableDataset(["tcp://a"], record_path_prefix="/tmp/x")
    with pytest.raises(NotImplementedError, match="item 5"):
        RemoteIterableDataset(["tcp://a"]).enable_recording("/tmp/x")
