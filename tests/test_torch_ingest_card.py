"""The sharded ingest live on a CUDA card: four port publishers ->
``StreamDataPipeline(ingest_workers=2, chunk=4)`` ->
``CapturedStep(make_fused_tile_step())``, on the raw wire, over
shared-memory rings and as zlib through the inflate pool.

Every test here is ``cuda``-marked and skips without a card. The file
imports no JAX, so it runs on a machine without it:
``python -m pytest --noconftest -m cuda tests/test_torch_ingest_card.py``.
"""

import threading

import numpy as np
import pytest
import torch

from blendjax_torch.transport import DataPublisherSocket, detach_all

WILD = "tcp://127.0.0.1:*"
SHAPE = (32, 64)
FRAMES = 16   # per producer
BATCH = 4
PRODUCERS = 4


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the GPU machine)")
    return torch.device("cuda")


def _producer_thread(pub, seed):
    from blendjax_torch.producer import CubeScene, TileBatchPublisher

    scene = CubeScene(shape=SHAPE, seed=seed)
    tp = TileBatchPublisher(pub, scene.background_image(), BATCH,
                            tile=(16, 32), alpha_slice=False, capacity=4)
    buf = np.empty((*SHAPE, 4), np.uint8)

    def run():
        for f in range(1, FRAMES + 1):
            scene.step(f)
            scene.render(out=buf)
            tp.add(buf, xy=np.full((8, 2), f, np.float32),
                   frameid=np.int64(f))

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["raw", "shm", "ndz"])
def test_sharded_ingest_live_through_a_captured_step(cuda_card, wire):
    """Finite losses, one replay per step, K1 launched, both shards fed,
    no gaps; the shm route reads every message it received from the
    rings, the ndz route decodes on the inflate pool."""
    from blendjax_torch.data import StreamDataPipeline
    from blendjax_torch.kernels import launch_counts, reset_launch_counts
    from blendjax_torch.models import CubeRegressor
    from blendjax_torch.train import (
        CapturedStep,
        TrainDriver,
        make_fused_tile_step,
        make_train_state,
    )

    kw = {"raw": {}, "shm": {"shm": 4},
          "ndz": {"compress_level": 6, "compress_min_bytes": 64}}[wire]
    pubs = [DataPublisherSocket(WILD, btid=k, **kw) for k in range(PRODUCERS)]
    threads = [_producer_thread(p, seed=k) for k, p in enumerate(pubs)]
    state = make_train_state(CubeRegressor(features=(8, 16)).init_params(0))
    graph_step = CapturedStep(make_fused_tile_step())
    drv = TrainDriver(graph_step, state, inflight=2)
    pipe = StreamDataPipeline(
        [p.addr for p in pubs], batch_size=BATCH, chunk=4, emit_packed=True,
        ingest_workers=2,
        timeoutms=20_000, max_items=PRODUCERS * FRAMES // BATCH)
    reset_launch_counts()
    try:
        for g in pipe:
            drv.submit(g)
        drv.drain()
    finally:
        pipe.stop()
        for t in threads:
            t.join(timeout=20)
        detach_all()
        for p in pubs:
            p.close()
    assert all(np.isfinite(drv.losses))
    assert graph_step.graph_replays == drv.steps > 0
    assert graph_step.aot_fallbacks == 0
    assert launch_counts()["decode_spatial"] > 0
    stats = pipe.shard_stats()
    assert [len(s["addresses"]) for s in stats] == [2, 2]
    assert all(s["items"] > 0 for s in stats)
    assert pipe.seq_gaps == 0 and pipe.restarts == 0
    if wire == "shm":
        assert sum(s["shm_reads"] for s in stats) == sum(
            s["received"] for s in stats) > 0
        assert sum(s["shm_torn"] for s in stats) == 0
    if wire == "ndz":
        assert sum(s["pool_decodes"] for s in stats) > 0
