"""The dispatches the JAX package jits outside a step, as the port captures
them (``blendjax_torch.train.aot.CapturedDispatch``): the decoded form's
decode of each packed group and the echo reservoir's ``sample``.

On the CPU every call is the eager body, which these tests hold against
the JAX package bit for bit (the decoded form on tile groups of both
decode kernels and on full-frame palette groups; the reservoir's gather on
the same inserts, indices and counter). The wrapper's own logic, its
signature keying, its graphs' lifetime and the copy of every output after
a replay, runs here through a stand-in capture: a real ``_DispatchGraph``
over static CPU buffers whose "replay" writes the same static outputs
again, as a CUDA graph replay does (``tests/test_torch_graphs.py`` holds
the real graphs on the card).
"""

import copy
from unittest import mock

import numpy as np
import pytest
import torch

from blendjax.data import StreamDataPipeline as JaxPipeline
from blendjax.data.echo import SampleReservoir as JaxReservoir
from blendjax_torch.data import SampleReservoir, StreamDataPipeline
from blendjax_torch.data.echo import default_echo_augment
from blendjax_torch.ops import tiles as T
from blendjax_torch.ops.augment import SeededAugment
from blendjax_torch.train import aot

SHAPE = (32, 64)
B = 2


@pytest.fixture(autouse=True)
def _fresh_lineage():
    from blendjax_torch.obs.lineage import lineage

    lineage.reset()


class _Capture:
    def __init__(self):
        self.msgs = []

    def publish(self, **msg):
        self.msgs.append(dict(msg, btid=0, _seq=len(self.msgs)))


def _tile_messages(tile, frames=8, seed=3):
    """Tile-delta messages of a cube scene (B frames each) and the frames
    they carry."""
    from blendjax_torch.producer import CubeScene, TileBatchPublisher

    scene = CubeScene(shape=SHAPE, seed=seed)
    cap = _Capture()
    n = (SHAPE[0] // tile[0]) * (SHAPE[1] // tile[-1])
    tp = TileBatchPublisher(cap, scene.background_image(), B, tile=tile,
                            alpha_slice=False, capacity=n)
    buf = np.empty((*SHAPE, 4), np.uint8)
    rendered = []
    for f in range(1, frames + 1):
        scene.step(f)
        scene.render(out=buf)
        rendered.append(buf.copy())
        tp.add(buf, xy=np.full((8, 2), f, np.float32), frameid=np.int64(f))
    return cap.msgs, np.stack(rendered)


def _palette_messages(n=4, seed=0):
    """Full-frame palette messages (the cube producer's ``--encoding
    pal``): frames of 3 and of 9 colours, so both 2-bit and 4-bit plans."""
    rng = np.random.default_rng(seed)
    msgs, frames = [], []
    for i in range(n):
        colors = rng.integers(0, 256, (3 if i % 2 == 0 else 9, 4),
                              dtype=np.uint8)
        f = colors[rng.integers(0, len(colors), (B, *SHAPE))]
        packed, pal, bits = T.palettize_frames(f)
        msgs.append({
            "_prebatched": True, "btid": 0, "_seq": i,
            "image" + T.FRAMEPAL_SUFFIXES[bits]: packed,
            "image" + T.PALETTE_SUFFIX: pal,
            "image" + T.FRAMESHAPE_SUFFIX: np.array([*SHAPE, 4, bits],
                                                    np.int32),
            "xy": np.full((B, 8, 2), i, np.float32),
            "frameid": np.arange(B, dtype=np.int64) + B * i,
        })
        frames.append(f)
    return msgs, np.concatenate(frames)


def _stand_in_capture(fn, batch, stream, mode, generators, stager, device):
    """``aot._capture_dispatch`` on the CPU: static buffers made as on the
    card, and a graph whose replay runs ``fn`` on them and writes its
    results into the SAME output tensors every time. As a replay of
    registered generators does, it draws from the generators as the host
    seeded them before it (a ``SeededAugment`` call seeds nothing)."""
    static = aot._make_static(batch, torch.device("cpu"))
    outputs = dict(fn(static))

    class Replayed:
        replays = 0

        def replay(self):
            self.replays += 1
            with mock.patch.object(SeededAugment, "seed",
                                   lambda *a, **k: None):
                for k, v in fn(static).items():
                    outputs[k].copy_(v)

    return aot._DispatchGraph(Replayed(), static, outputs,
                              {"launches": {}, "variants": {}}, None,
                              list(generators(static)), stager, 1)


@pytest.fixture
def stand_in(monkeypatch):
    """Route every ``CapturedDispatch`` whose device is set to ``cuda``
    through :func:`_stand_in_capture`."""
    monkeypatch.setattr(aot, "_capture_dispatch", _stand_in_capture)
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: None)

    def on_card(dispatch):
        dispatch.device = torch.device("cuda")
        return dispatch

    return on_card


def _entry(sig, key):
    """The value a plan signature keys ``key`` by."""
    return next(e[1] for e in sig if e[0] == key)


def _host(batch):
    return {k: v.numpy() for k, v in batch.items()
            if isinstance(v, torch.Tensor)}


def _equal(a, b):
    assert set(_host(a)) == set(_host(b))
    for k, v in _host(a).items():
        np.testing.assert_array_equal(v, _host(b)[k], err_msg=k)


# -- the decoded form ------------------------------------------------------------


@pytest.mark.parametrize("source", ["tile K1", "tile K2", "palette"])
@pytest.mark.parametrize("chunk", [1, 2])
def test_the_decoded_form_matches_the_jax_pipeline(source, chunk):
    """``StreamDataPipeline(emit_packed=False)`` on the same recorded
    messages as the JAX package's: every field of every batch equal bit
    for bit, and the frames equal to the rendered ones."""
    if source == "palette":
        msgs, frames = _palette_messages()
    else:
        msgs, frames = _tile_messages((16, 32) if source == "tile K1"
                                      else (16, 16))
    got = list(StreamDataPipeline(iter(copy.deepcopy(msgs)), batch_size=B,
                                  device="cpu", chunk=chunk))
    with JaxPipeline(iter(copy.deepcopy(msgs)), batch_size=B,
                     chunk=chunk) as pipe:
        want = list(pipe)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for k in ("image", "xy", "frameid"):
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]),
                                          err_msg=k)
    images = torch.cat([g["image"].reshape(-1, *SHAPE, 4) for g in got])
    np.testing.assert_array_equal(images.numpy(), frames[:len(images)])


def test_the_decode_keys_one_graph_per_plan(stand_in):
    """Groups of one plan replay one graph, a new plan (another index
    width, another chunk length) captures another; every group is one
    replay and no call runs eagerly. The captured form's batches equal
    the eager form's bit for bit."""
    msgs, _frames = _palette_messages(6)
    eager = list(StreamDataPipeline(iter(copy.deepcopy(msgs)), batch_size=B,
                                    device="cpu"))
    pipe = StreamDataPipeline(iter(copy.deepcopy(msgs)), batch_size=B,
                              device="cpu")
    dispatch = stand_in(pipe.tiles.dispatch)
    got = list(pipe)
    assert len(got) == len(eager) == 6
    for g, e in zip(got, eager):
        _equal(g, e)
    # 3 and 9 colours: a 2-bit and a 4-bit plan
    assert len(dispatch.signatures) == 2
    assert dispatch.graph_replays == 6 and dispatch.eager_calls == 0
    assert {_entry(sig, "_pal") for sig in dispatch.signatures} == {
        (("image", (*SHAPE, 4, 2)),), (("image", (*SHAPE, 4, 4)),)}

    tile, _ = _tile_messages((16, 32), frames=6)
    pipe = StreamDataPipeline(iter(tile), batch_size=B, device="cpu")
    dispatch = stand_in(pipe.tiles.dispatch)
    assert len(list(pipe)) == 3
    assert dispatch.graph_replays == 3
    keyed = {_entry(sig, "_spec") for sig in dispatch.signatures}
    assert len(dispatch.signatures) == len(keyed)  # one graph per plan


def test_a_decoded_batch_handed_out_never_changes(stand_in):
    """The held-batch rule: every batch of ``list(pipeline)`` (8 of them,
    each handed out before the next replay wrote the same static
    outputs) equals its eager twin after the run, bit for bit; the
    graph's own outputs hold the last group only, so the copies are what
    kept the others."""
    msgs, _frames = _tile_messages((16, 32), frames=16)
    eager = list(StreamDataPipeline(iter(copy.deepcopy(msgs)), batch_size=B,
                                    device="cpu"))
    pipe = StreamDataPipeline(iter(copy.deepcopy(msgs)), batch_size=B,
                              device="cpu")
    dispatch = stand_in(pipe.tiles.dispatch)
    held = list(pipe)
    assert len(held) == len(eager) == 8
    for g, e in zip(held, eager):
        _equal(g, e)
    graph = dispatch._graphs[max(dispatch._graphs,
                                 key=lambda s: dispatch._graphs[s]
                                 .graph.replays)]
    assert graph.graph.replays > 1
    assert graph.copy_bytes == sum(v.numel() * v.element_size()
                                   for v in graph.outputs.values())
    assert not all(torch.equal(graph.outputs["image"][0], g["image"])
                   for g in held)


# -- the reservoir's draw ----------------------------------------------------------


def _ring_batch(seed, b=4):
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 256, (b, 8, 16, 4), dtype=np.uint8),
            "xy": rng.random((b, 8, 2)).astype(np.float32)}


def test_sample_matches_the_jax_reservoir_eager_and_captured(stand_in):
    """``sample`` without augmentation on the same inserts, indices and
    counters as the JAX reservoir's: equal bit for bit, eagerly and
    through the captured form, which draws from one graph per draw size."""
    jres = JaxReservoir(8, augment=None)
    eager = SampleReservoir(8, augment=None, device="cpu")
    graphed = SampleReservoir(8, augment=None, device="cpu")
    dispatch = stand_in(graphed.dispatch)
    rng = np.random.default_rng(0)
    for seed in range(3):
        batch = _ring_batch(seed)
        for res in (jres, eager, graphed):
            res.insert(batch)
        for n in (4, 4, 3):
            idx = rng.integers(0, 8, n)
            want = jres.sample(idx)
            for got in (eager.sample(idx), graphed.sample(idx)):
                for k in ("image", "xy"):
                    np.testing.assert_array_equal(got[k].numpy(),
                                                  np.asarray(want[k]))
    assert jres._draws == eager._draws == graphed._draws == 9
    assert len(dispatch.signatures) == 2 and dispatch.graph_replays == 9


def test_a_captured_draw_augments_as_the_eager_draw(stand_in):
    """With the default augmentation, draw ``n`` through the captured
    form equals eager draw ``n`` (the counter seeds the registered
    generators on the host before each replay), and 8 drawn batches held
    across later draws keep their values."""
    def make():
        res = SampleReservoir(8, augment=default_echo_augment(points_key="xy"),
                              rng=7, device="cpu")
        res.insert(_ring_batch(5, 8))
        return res

    eager, graphed = make(), make()
    dispatch = stand_in(graphed.dispatch)
    rng = np.random.default_rng(1)
    idxs = [rng.integers(0, 8, 4) for _ in range(10)]
    want = [eager.sample(i) for i in idxs]
    held = [graphed.sample(i) for i in idxs]
    for g, w in zip(held, want):
        _equal(g, w)
    assert not torch.equal(held[0]["image"], held[1]["image"])
    assert len(dispatch.signatures) == 1 and dispatch.graph_replays == 10
    (graph,) = dispatch._graphs.values()
    assert len(graph.generators) == len(graphed.draw_generators()) == 3


def test_the_draw_graphs_outlive_inserts_and_die_with_the_ring(stand_in):
    """An insert writes the ring in place (the same tensors): the draw's
    graph is kept. ``load_state_dict`` replaces the ring's tensors: the
    graphs that read the old ones are dropped, and the next draw captures
    one on the new ring, which draws what the restored reservoir holds."""
    res = SampleReservoir(8, augment=None, device="cpu")
    dispatch = stand_in(res.dispatch)
    res.insert(_ring_batch(0))
    idx = np.array([0, 1, 2, 3])
    res.sample(idx)
    (sig,) = dispatch.signatures
    for seed in (1, 2, 3):
        res.insert(_ring_batch(seed))
        res.sample(idx)
    assert dispatch.signatures == (sig,) and dispatch.graph_replays == 4
    snap = copy.deepcopy(res.state_dict())
    before = res.sample(idx)
    other = SampleReservoir(8, augment=None, device="cpu")
    stand_in(other.dispatch)
    other.insert(_ring_batch(9))
    other.sample(idx)
    assert len(other.dispatch.signatures) == 1
    other.load_state_dict(snap)
    assert other.dispatch.signatures == ()
    _equal(other.sample(idx), before)
    (new,) = other.dispatch.signatures
    assert {p for _n, p, _s, _d in _entry(new, "_echo_buffers")} == {
        t.data_ptr() for t in other.device_buffers().values()}


def test_a_plain_augment_draws_eagerly_on_the_card_and_counts(stand_in):
    """An ``augment`` that is a plain ``fn(seed, batch)`` takes its seed
    on the host, which a graph would freeze: on the card its draws run
    eagerly and count ``eager_calls``; on the CPU nothing is counted."""
    seeds = []

    def plain(seed, batch):
        seeds.append(seed)
        return batch

    res = SampleReservoir(8, augment=plain, device="cpu")
    res.insert(_ring_batch(0))
    res.sample(np.arange(4))
    assert res.dispatch.eager_calls == 0
    res.device = torch.device("cuda")  # as a reservoir on the card sees it
    stand_in(res.dispatch)
    res.sample(np.arange(4))
    res.sample(np.arange(4))
    assert res.dispatch.eager_calls == 2 and res.dispatch.signatures == ()
    assert len(set(seeds)) == 3


def test_a_failing_dispatch_capture_raises(monkeypatch, stand_in):
    """A capture that fails raises out of the call; the eager body does
    not run in its place."""
    def capture(*a, **k):
        raise RuntimeError("capture failed")

    calls = []

    def body(batch):
        calls.append(1)
        return {"x": batch["x"] + 1}

    dispatch = stand_in(aot.CapturedDispatch(body, "cpu", "probe"))
    monkeypatch.setattr(aot, "_capture_dispatch", capture)
    with pytest.raises(RuntimeError, match="capture failed"):
        dispatch({"x": torch.zeros(3)})
    assert calls == [] and dispatch.eager_calls == 0


def test_a_gloo_mesh_dispatch_runs_eagerly_and_counts(stand_in):
    """Over a gloo group of several ranks (whose collectives a capture
    forbids) every call is the eager body, counted in ``eager_calls``."""
    dispatch = stand_in(aot.CapturedDispatch(lambda b: {"y": b["x"] * 2},
                                             "cpu", "probe"))
    dispatch.host_collectives = True
    out = dispatch({"x": torch.ones(3)})
    assert torch.equal(out["y"], torch.full((3,), 2.0))
    assert dispatch.eager_calls == 1 and dispatch.signatures == ()


def test_a_dispatch_graph_is_in_the_ledger_but_not_in_the_step_figures(
        monkeypatch):
    """The device ledger keeps a dispatch's entry (``kind`` "dispatch",
    its outputs' bytes) beside the steps', but the ``device.*`` step
    gauges and the cost-model FLOPs per image read the steps alone."""
    from blendjax_torch.obs.devledger import ExecutableLedger
    from blendjax_torch.utils.metrics import Metrics

    class Step:
        flops, work, state_bytes, graph = 4e9, {}, 0, None
        static = {"image": torch.zeros(4, 2, dtype=torch.uint8)}
        loss = torch.zeros(())

    outputs = {"image": torch.zeros(4, 8, dtype=torch.uint8)}
    decode = aot._DispatchGraph(None, {"_packed": torch.zeros(1, 8)}, outputs,
                                {"launches": {}, "variants": {},
                                 "work": {"decode_spatial": (0, 64)}},
                                None, [], None, 4)
    monkeypatch.setattr(aot, "pool_bytes", lambda g, segments=None: 0)
    reg = Metrics()
    led = ExecutableLedger(registry=reg)
    led.register("captured_step", Step(), batch_images=4)
    flops = reg.report()["gauges"]["device.flops_per_step"]
    e = led.register("decode", decode, batch_images=4)
    assert e["kind"] == "dispatch" and e["output_bytes"] == 32
    assert e["flops"] == 0.0 and e["kernel_bytes"] == 64
    assert reg.report()["gauges"]["device.flops_per_step"] == flops == 4e9
    assert led.flops_per_image(4) == 1e9
    assert [x["kind"] for x in led.report()["entries"]] == ["step", "dispatch"]
