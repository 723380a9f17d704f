"""Captured train steps on a CUDA card: one CUDA graph per batch
signature (``blendjax_torch.train.aot``) against the eager step, bit for
bit, over 4 steps from one state (cuDNN deterministic on both sides), for
the supervised ladder with a ragged tail, the fused tile step through K1
and through K2, a depth-2 StreamFormer through K4a-c, and the echo step;
an unseen signature's fallback, a failing capture, launch counts through
replays and registered generators.

Every test here is ``cuda``-marked and skips without a card; on the CPU
the steps run eagerly by design (``tests/test_torch_train.py``). The file
imports no JAX, so it runs on a machine without it:
``python -m pytest --noconftest -m cuda tests/test_torch_graphs.py``.
"""

import copy

import numpy as np
import pytest
import torch

from blendjax_torch.models import CubeRegressor
from blendjax_torch.ops import augment as A
from blendjax_torch.train import aot
from blendjax_torch.train import steps as S
from blendjax_torch.train.driver import TrainDriver

FEATURES = (8, 16, 8)
SHAPE = (32, 48, 4)


def _batch(b=8, seed=1):
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 256, (b, *SHAPE), dtype=np.uint8),
            "xy": rng.uniform(0, 48, (b, 8, 2)).astype(np.float32)}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _padded(batch):
    """What the driver steps on: a partial batch padded to its bucket."""
    from blendjax_torch.data.batcher import pad_to_bucket

    return pad_to_bucket(batch) if batch.get("_partial") else batch


def _images(b=4, seed=6):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (b, *SHAPE), dtype=np.uint8))


class _Capture:
    def __init__(self):
        self.msgs = []

    def publish(self, **msg):
        self.msgs.append(dict(msg, btid=0, _seq=len(self.msgs)))


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the GPU machine)")
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    torch.backends.cudnn.deterministic = False


def _card_cube(card, seed=0):
    return CubeRegressor(features=FEATURES).init_params(seed).to(card)


def _fused_case(card, tile, seed):
    """Recorded packed chunk groups of the port's producer path, on the
    card, with their plan."""
    from blendjax_torch.data import StreamDataPipeline
    from blendjax_torch.producer import CubeScene, TileBatchPublisher

    scene = CubeScene(shape=(64, 128), seed=seed)
    cap = _Capture()
    tp = TileBatchPublisher(cap, scene.background_image(), 4, tile=tile,
                            alpha_slice=False, capacity=24)
    buf = np.empty((64, 128, 4), np.uint8)
    for f in range(1, 33):
        scene.step(f)
        scene.render(out=buf)
        tp.add(buf, hint=scene.raster.last_drawn,
               xy=scene.camera.world_to_pixel(scene.corners_world()).astype(
                   np.float32), frameid=np.int64(f))
    pipe = StreamDataPipeline(iter(cap.msgs), batch_size=4, device=card,
                              chunk=2)
    return list(pipe)


def _assert_bit_equal(a, b, la, lb):
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n
    assert a.step == b.step


def _eager_and_graph(make_step, make_state, batches):
    """N steps eagerly, N through a captured step, from one state."""
    from blendjax_torch.kernels import launch_counts, reset_launch_counts

    a, b = make_state(), make_state()
    step = make_step()
    reset_launch_counts()
    la = [step(a, x)[1]["loss"] for x in batches]
    eager_counts = launch_counts()
    reset_launch_counts()
    graph = aot.CapturedStep(make_step())
    lb = [graph(b, x)[1]["loss"] for x in batches]
    torch.cuda.synchronize()
    _assert_bit_equal(a, b, la, lb)
    assert graph.graph_replays == len(batches)
    assert launch_counts() == eager_counts
    return graph


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [(16, 32), (16, 16)], ids=["K1", "K2"])
def test_captured_fused_step_is_the_eager_step_on_card(cuda_card, tile):
    batches = _fused_case(cuda_card, tile, seed=4)[:4]
    model = _card_cube(cuda_card)
    _eager_and_graph(S.make_fused_tile_step,
                     lambda: S.make_train_state(copy.deepcopy(model)),
                     batches)


@pytest.mark.cuda
def test_captured_streamformer_step_is_the_eager_step_on_card(cuda_card):
    from blendjax_torch.kernels import variant_counts
    from blendjax_torch.models import StreamFormer

    batches = _fused_case(cuda_card, (16, 32), seed=5)[:4]
    model = StreamFormer(patch=16, dim=128, depth=2, num_heads=2,
                         num_outputs=16, attn_backend="flash",
                         image_shape=(64, 128)).init_params(0).to(cuda_card)

    def loss(m, batch):
        return S.corner_loss(m(batch["image"]).reshape(-1, 8, 2), batch["xy"],
                             image_shape=tuple(batch["image"].shape[1:3]))

    _eager_and_graph(lambda: S.make_fused_tile_step(loss),
                     lambda: S.make_train_state(copy.deepcopy(model)),
                     batches)
    assert variant_counts()["flash_attention_fwd"]["sm90"] == 2 * 2 * 4


@pytest.mark.cuda
def test_captured_echo_step_is_the_eager_step_on_card(cuda_card):
    from blendjax_torch.data import SampleReservoir, default_echo_augment

    rng = np.random.default_rng(0)
    res = SampleReservoir(16, augment=default_echo_augment(points_key="xy"),
                          device=cuda_card)
    res.insert({"image": rng.integers(0, 256, (16, *SHAPE), dtype=np.uint8),
                "xy": rng.uniform(0, 32, (16, 8, 2)).astype(np.float32)})
    tokens = [res.draw_token(rng.integers(0, 16, 8)) for _ in range(4)]
    model = _card_cube(cuda_card)

    def replay_tokens():
        return [dict(t) for t in tokens]

    a = S.make_train_state(copy.deepcopy(model))
    b = S.make_train_state(copy.deepcopy(model))
    la = [S.make_echo_fused_step(res.draw)(a, t)[1]["loss"]
          for t in replay_tokens()]
    graph = aot.CapturedStep(S.make_echo_fused_step(res.draw))
    lb = [graph(b, t)[1]["loss"] for t in replay_tokens()]
    torch.cuda.synchronize()
    _assert_bit_equal(a, b, la, lb)
    assert len(graph.signatures) == 1 and graph.graph_replays == 4


@pytest.mark.cuda
def test_aot_ladder_with_a_ragged_tail_is_the_eager_step_on_card(cuda_card):
    model = _card_cube(cuda_card)
    example = _t(_batch())
    ref = S.make_train_state(copy.deepcopy(model))
    drv = TrainDriver.build(copy.deepcopy(model), example, sync_every=0)
    assert len(drv.step.signatures) == 5
    eager = S.make_supervised_step()
    batches = [_batch(seed=s) for s in (1, 2, 3)] + [_batch(b=3, seed=4)]
    for hb in batches:
        batch = {k: v.to(cuda_card) for k, v in _t(hb).items()}
        if len(hb["image"]) < 8:
            batch["_partial"] = True
        drv.submit(batch)
        want = eager(ref, _padded(batch))[1]["loss"]
        assert drv.drain() == float(want)
    assert drv.stats["aot_fallbacks"] == 0 and drv.stats["graph_replays"] == 4
    for p, q in zip(drv.state.model.parameters(), ref.model.parameters()):
        assert torch.equal(p, q)
    odd = {k: v.to(cuda_card) for k, v in _t(_batch(b=5)).items()}
    drv.submit(odd)  # 5 rows, unpadded: no ladder signature
    assert drv.drain() == float(eager(ref, odd)[1]["loss"])
    assert drv.stats["aot_fallbacks"] == 1
    assert drv.stats["graph_replays"] == 4


@pytest.mark.cuda
def test_launch_counts_advance_by_replays_on_card(cuda_card):
    from blendjax_torch.kernels import launch_counts, reset_launch_counts

    batches = _fused_case(cuda_card, (16, 32), seed=6)[:2]
    state = S.make_train_state(_card_cube(cuda_card))
    graph = aot.CapturedStep(S.make_fused_tile_step())
    reset_launch_counts()
    graph(state, batches[0])  # capture (warm-up not counted) + one replay
    assert launch_counts()["decode_spatial"] == 1
    for _ in range(3):
        graph(state, batches[1])
    assert launch_counts()["decode_spatial"] == 4 and graph.graph_replays == 4


@pytest.mark.cuda
def test_registered_generators_give_the_eager_draws_on_card(cuda_card):
    aug = A.make_augment(A.random_flip, A.color_jitter)
    x = _images().to(cuda_card)
    static = x.clone()
    graph = torch.cuda.CUDAGraph()
    for gen in aug.generators(cuda_card):
        graph.register_generator_state(gen)
    aug(0, static)  # warm-up
    with torch.cuda.graph(graph):
        out = aug(0, static)
    for seed in (3, 4, 3):
        aug.seed(seed, cuda_card)
        graph.replay()
        assert torch.equal(out, aug(seed, x))


@pytest.mark.cuda
def test_a_failing_capture_raises_on_card(cuda_card):
    def step(state, batch):
        float(batch["x"].sum())  # a host sync: illegal while capturing
        return state, {"loss": batch["x"].sum()}

    step.generators = lambda s, b: []
    step.reseed = lambda s, b: None
    state = S.make_train_state(_card_cube(cuda_card))
    before = [p.detach().clone() for p in state.model.parameters()]
    with pytest.raises(RuntimeError):
        aot.CapturedStep(step)(state, {"x": torch.ones(4, device=cuda_card)})
    assert state.step == 0
    for p, q in zip(state.model.parameters(), before):
        assert torch.equal(p, q)
