"""Captured train steps on a CUDA card: one CUDA graph per batch
signature (``blendjax_torch.train.aot``) against the eager step, bit for
bit, over 4 steps from one state (cuDNN deterministic on both sides), for
the supervised ladder with a ragged tail, the fused tile step through K1
and through K2, a depth-2 StreamFormer through K4a-c, and the echo step;
an unseen signature's fallback, a failing capture, launch counts through
replays and registered generators. The dispatches outside a step
(``aot.CapturedDispatch``): the decoded form's decode of tile K1, tile K2
and palette groups and the reservoir's ``sample``, each held batch
bit-equal with the eager run's after later replays, and a failing
capture.

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
from blendjax_torch.testing.donation import tree_pointers
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
                              chunk=2, emit_packed=True)
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


@pytest.mark.cuda
def test_prepare_captures_without_stepping_on_card(cuda_card):
    """CapturedStep.prepare captures a signature ahead of its first call
    and leaves the state as it was; the calls then replay it and equal
    the eager step bit for bit."""
    batches = _fused_case(cuda_card, (16, 32), seed=4)[:3]
    model = _card_cube(cuda_card)
    a = S.make_train_state(copy.deepcopy(model))
    b = S.make_train_state(copy.deepcopy(model))
    before = [p.detach().clone() for p in b.model.parameters()]
    graph = aot.CapturedStep(S.make_fused_tile_step())
    graph.prepare(b, batches[0])
    assert len(graph.signatures) == 1 and graph.graph_replays == 0
    assert b.step == 0
    assert all(torch.equal(p, q) for p, q in zip(b.model.parameters(), before))
    step = S.make_fused_tile_step()
    la = [step(a, x)[1]["loss"] for x in batches]
    lb = [graph(b, x)[1]["loss"] for x in batches]
    torch.cuda.synchronize()
    _assert_bit_equal(a, b, la, lb)


@pytest.mark.cuda
def test_snapshots_of_a_captured_run_hold_each_step_on_card(cuda_card,
                                                             tmp_path):
    """A driver over a captured step hands a snapshot to the manager
    every step (clones queued on the replay's stream, written on the
    manager's thread; a snapshot still pending when the next comes is
    replaced): every committed snapshot equals the eager state after that
    many steps, bit for bit, though the next replays update the
    parameters in place meanwhile. A captured driver restored in place
    from the first snapshot then replays the next step exactly as the
    uninterrupted run did."""
    from blendjax_torch.checkpoint import SnapshotManager
    from blendjax_torch.weights import (
        load_train_state_leaves,
        train_state_leaves,
    )

    def host(leaves):
        return {k: np.array(v.detach().cpu() if isinstance(v, torch.Tensor)
                            else v) for k, v in leaves.items()}

    batches = _fused_case(cuda_card, (16, 32), seed=4)[:4]
    model = _card_cube(cuda_card)
    ref = S.make_train_state(copy.deepcopy(model))
    eager = S.make_fused_tile_step()
    want = []
    for x in batches:
        eager(ref, x)
        want.append(host(train_state_leaves(ref)))
    mgr = SnapshotManager(str(tmp_path), keep=10)
    state = S.make_train_state(copy.deepcopy(model))
    drv = TrainDriver(aot.CapturedStep(S.make_fused_tile_step()), state,
                      inflight=4, sync_every=0, checkpoint=mgr,
                      checkpoint_every=1)
    for x in batches:
        drv.submit(x)
    drv.drain()
    mgr.wait()
    steps = mgr.steps()
    assert mgr.last_error is None and steps[0] == 1 and steps[-1] == 4
    assert len(steps) + mgr.skipped == 4
    for k in steps:
        got = mgr.restore(step=k).state
        for name, v in want[k - 1].items():
            np.testing.assert_array_equal(got[name], v, err_msg=name)
    other = S.make_train_state(copy.deepcopy(model))
    drv2 = TrainDriver(aot.CapturedStep(S.make_fused_tile_step()), other,
                       inflight=2, sync_every=0)
    drv2.submit(batches[0])
    drv2.drain()
    load_train_state_leaves(other, mgr.restore(step=1).state)
    drv2.submit(batches[1])
    drv2.drain()
    for name, v in host(train_state_leaves(other)).items():
        np.testing.assert_array_equal(v, want[1][name], err_msg=name)
    mgr.close()


def _former(card, **kw):
    from blendjax_torch.models import StreamFormer

    return StreamFormer(patch=16, dim=128, depth=2, num_heads=2,
                        num_outputs=16, attn_backend="flash",
                        image_shape=(64, 128), **kw).init_params(0).to(card)


def _former_loss(m, batch):
    return S.corner_loss(m(batch["image"]).reshape(-1, 8, 2), batch["xy"],
                         image_shape=tuple(batch["image"].shape[1:3]))


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{"num_experts": 2}, {"remat": True}],
                         ids=["moe", "remat"])
def test_captured_moe_and_remat_steps_are_the_eager_step_on_card(cuda_card,
                                                                 kw):
    """A MoE StreamFormer (MoE in block 0) and a remat one through the
    fused step: captured against eager, bit for bit; under remat the
    forward kernel runs twice per block and update."""
    from blendjax_torch.kernels import variant_counts

    batches = _fused_case(cuda_card, (16, 32), seed=5)[:4]
    model = _former(cuda_card, **kw)
    _eager_and_graph(lambda: S.make_fused_tile_step(_former_loss),
                     lambda: S.make_train_state(copy.deepcopy(model)),
                     batches)
    per_update = 2 if kw.get("remat") else 1
    assert variant_counts()["flash_attention_fwd"]["sm90"] == (
        per_update * 2 * 2 * 4)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dqn", "pg"])
def test_captured_rl_step_is_the_eager_step_on_card(cuda_card, kind):
    """The DQN and policy-gradient learner steps captured into one graph
    each: 4 replays against 4 eager steps from twin reservoirs and states,
    losses, parameters, target and priorities bit-equal; the ring and the
    priorities never move."""
    from blendjax_torch.models import QNetwork
    from blendjax_torch.rl import (
        TrajectoryReservoir,
        make_dqn_step,
        make_pg_step,
        make_rl_train_state,
    )

    rng = np.random.default_rng(0)
    rows = {"obs": rng.normal(size=(64, 4)).astype(np.float32),
            "action": rng.integers(0, 3, 64).astype(np.int32),
            "reward": rng.normal(size=64).astype(np.float32),
            "done": rng.random(64) < 0.2,
            "next_obs": rng.normal(size=(64, 4)).astype(np.float32),
            "ret": rng.normal(size=64).astype(np.float32)}
    model = QNetwork(hidden=(32, 32)).init_params(0)
    out = []
    for captured in (False, True):
        res = TrajectoryReservoir(64, rng=1, prioritized=True,
                                  device=cuda_card)
        res.insert(rows)
        ptrs = tree_pointers(res.device_buffers())
        state = make_rl_train_state(copy.deepcopy(model), target=kind == "dqn")
        step = (make_dqn_step(res) if kind == "dqn" else make_pg_step(res))
        if captured:
            step = aot.CapturedStep(step)
        losses = [step(state, res.draw_token(*res.compose(32)))[1]["loss"]
                  for _ in range(4)]
        torch.cuda.synchronize()
        assert tree_pointers(res.device_buffers()) == ptrs
        out.append((losses, state, res))
    (la, a, ra), (lb, b, rb) = out
    _assert_bit_equal(a, b, la, lb)
    assert torch.equal(ra._priorities, rb._priorities)
    if kind == "dqn":
        for p, q in zip(a.target.parameters(), b.target.parameters()):
            assert torch.equal(p, q)


@pytest.mark.cuda
def test_the_feeders_throttle_waits_on_the_card(cuda_card):
    """``DeviceFeeder(throttle=2)``: with the side stream's copies held
    behind a sleep, the third placement of one shape finds both pinned
    buffers still copying and waits once, counted for the doctor; every
    placed batch still arrives whole."""
    from blendjax_torch.data.pipeline import DeviceFeeder
    from blendjax_torch.utils.metrics import metrics

    metrics.reset()
    feeder = DeviceFeeder(device=cuda_card, throttle=2)
    batches = [{"image": np.full((4, 64, 64, 4), i, np.uint8)}
               for i in range(3)]
    with torch.cuda.stream(feeder._copy_stream):
        torch.cuda._sleep(int(2e8))  # the copies queue behind ~0.1 s
    outs = [feeder.place(b) for b in batches]
    torch.cuda.synchronize()
    report = metrics.report()
    assert report["counters"]["feed.throttle_blocks"] == 1
    assert report["spans"]["feed.throttle_wait"]["count"] == 1
    for i, out in enumerate(outs):
        assert bool((out["image"] == i).all())
    metrics.reset()


@pytest.mark.cuda
def test_the_feeder_keeps_same_shaped_fields_apart_on_the_card(cuda_card):
    """``shape_id`` and ``frameid``, both (B,) int64, in each of several
    placements whose copies queue behind a sleep on the side stream: each
    field arrives with its own values (two fields never share a pinned
    buffer while a copy out of it may still be queued)."""
    from blendjax_torch.data.pipeline import DeviceFeeder

    feeder = DeviceFeeder(device=cuda_card)
    batches = [{"shape_id": np.arange(8, dtype=np.int64) + 100 * i,
                "frameid": np.arange(8, dtype=np.int64) * -1 - 100 * i,
                "image": np.full((8, 16, 16, 4), i, np.uint8)}
               for i in range(4)]
    outs = []
    for b in batches:
        with torch.cuda.stream(feeder._copy_stream):
            torch.cuda._sleep(int(5e7))  # this batch's copies queue
        outs.append(feeder.place(b))
    torch.cuda.synchronize()
    for b, out in zip(batches, outs):
        for k, v in b.items():
            assert np.array_equal(out[k].cpu().numpy(), v), k


@pytest.mark.cuda
def test_the_discriminator_on_card_matches_the_cpu(cuda_card):
    """The f32 discriminator (TF32 off) on the card against its plain run
    on the CPU at an odd size, within 1e-4."""
    from blendjax_torch.models import Discriminator

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = Discriminator(features=(8, 16), dtype=torch.float32).init_params(3)
    card = copy.deepcopy(cpu).to(cuda_card)
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 30, 22, 4), dtype=np.uint8))
    with torch.no_grad():
        want, got = cpu(x), card(x.to(cuda_card)).cpu()
    assert float((got - want).abs().max()) <= 1e-4


# -- dispatches outside a step: the decoded form and the reservoir's draw ------


def _decoded_messages(source):
    """Recorded messages of the decoded form's three plans: tile groups
    through K1 ((16, 32) tiles) or K2 (16x16), or full-frame palette
    groups of 3 and 9 colours (2-bit and 4-bit plans)."""
    from blendjax_torch.ops import tiles as T
    from blendjax_torch.producer import CubeScene, TileBatchPublisher

    if source == "palette":
        rng = np.random.default_rng(2)
        msgs = []
        for i in range(12):
            colors = rng.integers(0, 256, (3 if i % 2 else 9, 4),
                                  dtype=np.uint8)
            frames = colors[rng.integers(0, len(colors), (4, 64, 128))]
            packed, pal, bits = T.palettize_frames(frames)
            msgs.append({
                "_prebatched": True, "btid": 0, "_seq": i,
                "image" + T.FRAMEPAL_SUFFIXES[bits]: packed,
                "image" + T.PALETTE_SUFFIX: pal,
                "image" + T.FRAMESHAPE_SUFFIX: np.array([64, 128, 4, bits],
                                                        np.int32),
                "xy": np.full((4, 8, 2), i, np.float32),
                "frameid": np.arange(4, dtype=np.int64) + 4 * i})
        return msgs
    scene = CubeScene(shape=(64, 128), seed=5)
    cap = _Capture()
    tp = TileBatchPublisher(cap, scene.background_image(), 4,
                            tile=(16, 32) if source == "K1" else (16, 16),
                            alpha_slice=False, capacity=24)
    buf = np.empty((64, 128, 4), np.uint8)
    for f in range(1, 49):
        scene.step(f)
        scene.render(out=buf)
        tp.add(buf, hint=scene.raster.last_drawn,
               xy=scene.camera.world_to_pixel(scene.corners_world()).astype(
                   np.float32), frameid=np.int64(f))
    return cap.msgs


def _decoded(card, msgs, eager: bool):
    """Every batch of ``StreamDataPipeline(emit_packed=False)`` on
    ``msgs`` (held), with the launch counts and the pipeline's dispatch;
    ``eager`` runs each decode eagerly on the card."""
    from blendjax_torch.data import StreamDataPipeline
    from blendjax_torch.kernels import launch_counts, reset_launch_counts

    pipe = StreamDataPipeline(iter(copy.deepcopy(msgs)), batch_size=4,
                              device=card)
    dispatch = pipe.tiles.dispatch
    if eager:
        pipe.tiles.dispatch = dispatch.eager
    reset_launch_counts()
    out = list(pipe)
    torch.cuda.synchronize()
    return out, launch_counts(), dispatch


def _same_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        keys = {k for k, v in w.items() if isinstance(v, torch.Tensor)}
        assert keys == {k for k, v in g.items()
                        if isinstance(v, torch.Tensor)}
        for k in keys:
            assert torch.equal(g[k], w[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["K1", "K2", "palette"])
def test_captured_decode_is_the_eager_decode_on_card(cuda_card, source):
    """The decoded form replays one graph per group (no eager call), one
    graph per plan, and every batch, each held while the later groups
    replay the same graphs, equals the eager decode's bit for bit, with
    the launches counted through replays equal to the eager launches."""
    msgs = _decoded_messages(source)
    want, eager_counts, _ = _decoded(cuda_card, msgs, eager=True)
    got, counts, dispatch = _decoded(cuda_card, msgs, eager=False)
    _same_batches(got, want)
    assert len(got) >= 8
    assert dispatch.graph_replays == len(got) and dispatch.eager_calls == 0
    assert counts == eager_counts
    kernel = {"K1": "decode_spatial", "K2": "decode_scatter"}.get(source)
    if kernel:
        assert counts[kernel] == len(got)
    plans = {tuple(e for e in sig if e[0] != "_refs")
             for sig in dispatch.signatures}
    assert len(plans) == len(dispatch.signatures)


@pytest.mark.cuda
def test_captured_draw_is_the_eager_draw_on_card(cuda_card):
    """``sample`` with the default augmentation replays one graph per draw
    and equals the eager draw of the same counter bit for bit; 8 drawn
    batches held across later draws and inserts keep their values; an
    insert keeps the graph, ``load_state_dict`` drops it."""
    from blendjax_torch.data import SampleReservoir, default_echo_augment

    def make():
        return SampleReservoir(
            16, augment=default_echo_augment(points_key="xy"), rng=3,
            device=cuda_card)

    rng = np.random.default_rng(0)
    inserts = [{"image": rng.integers(0, 256, (8, *SHAPE), dtype=np.uint8),
                "xy": rng.uniform(0, 32, (8, 8, 2)).astype(np.float32)}
               for _ in range(4)]
    idxs = [rng.integers(0, 16, 8) for _ in range(12)]
    eager, graphed = make(), make()
    eager.dispatch = eager.dispatch.eager
    want, got = [], []
    for i, idx in enumerate(idxs):
        if i % 3 == 0:
            for res in (eager, graphed):
                res.insert(inserts[i // 3])
        want.append(eager.sample(idx))
        got.append(graphed.sample(idx))
    torch.cuda.synchronize()
    _same_batches(got, want)
    dispatch = graphed.dispatch
    assert len(dispatch.signatures) == 1
    assert dispatch.graph_replays == len(idxs) and dispatch.eager_calls == 0
    snap = graphed.state_dict()
    snap["buffers"] = {k: v.cpu() for k, v in snap["buffers"].items()}
    graphed.load_state_dict(snap)
    assert dispatch.signatures == ()
    again = graphed.sample(idxs[0])
    assert len(dispatch.signatures) == 1
    assert again["image"].shape == got[0]["image"].shape


@pytest.mark.cuda
def test_a_failing_dispatch_capture_raises_on_card(cuda_card):
    """A dispatch that cannot be captured (a host sync) raises; its eager
    body does not run in its place."""
    calls = []

    def body(batch):
        calls.append(1)
        float(batch["x"].sum())  # a host sync: illegal while capturing
        return {"y": batch["x"] + 1}

    dispatch = aot.CapturedDispatch(body, cuda_card, "probe")
    with pytest.raises(RuntimeError):
        dispatch({"x": torch.ones(4, device=cuda_card)})
    assert dispatch.eager_calls == 0 and dispatch.graph_replays == 0
