"""The port's device ledger (``blendjax_torch.obs.devledger``) and the
kernels' declared work (``blendjax_torch.kernels.work``), against the JAX
package's ledger where the two count the same thing.

The JAX package is imported inside the parity tests only: the ``cuda``-
marked tests at the end run on the card without JAX (``python -m pytest
--noconftest -m cuda tests/test_torch_devledger.py``) and skip here.
"""

import os
import sys
import types

import numpy as np
import pytest
import torch

from blendjax_torch.kernels import work as W
from blendjax_torch.obs.devledger import (
    HBM_GAUGES,
    LEDGER_GAUGES,
    ExecutableLedger,
    RetraceAudit,
    batch_signature,
    count_flops,
    default_peak_flops,
    ledger,
    measure_model_flops,
)
from blendjax_torch.utils.metrics import Metrics, metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_registries():
    """The port's registry and ledger are process-wide; each test starts
    from empty ones."""
    from blendjax_torch.obs.lineage import lineage
    from blendjax_torch.obs.trace import tracer

    for reg in (metrics, lineage, tracer, ledger):
        reg.reset()
    yield
    for reg in (metrics, lineage, tracer, ledger):
        reg.reset()


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """At most two torch threads: the suite runs six workers on eight
    cores beside timing-sensitive tests of the JAX package."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _batch(b=4, h=16, w=16, seed=0):
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 256, (b, h, w, 4), dtype=np.uint8),
            "xy": rng.uniform(0, 16, (b, 8, 2)).astype(np.float32)}


# -- FLOPs --------------------------------------------------------------------


def test_measure_model_flops_within_ten_percent_of_the_reference():
    """CubeRegressor() at (64, 96), batch 4: FlopCounterMode counts the
    convolutions and dense products, XLA's cost model also counts the
    elementwise work, so the port's count sits below; the bar is 10%."""
    pytest.importorskip("jax")
    from blendjax.obs.devledger import measure_model_flops as jmeasure

    port = measure_model_flops(shape=(64, 96), batch=4, device="cpu",
                               memo=False)
    ref = jmeasure(shape=(64, 96), batch=4, memo=False)
    ratio = port["flops_per_image"] / ref["flops_per_image"]
    assert 0.9 <= ratio <= 1.1, (port, ref)
    assert port["kernel_flops"] == 0  # no kernel launches on the CPU
    assert port["chip"] == "cpu" and port["peak_flops"] is None


def test_measure_model_flops_memo_and_count_flops_agree():
    from blendjax_torch.models import CubeRegressor
    from blendjax_torch.obs import devledger

    out = measure_model_flops(CubeRegressor(features=(2,)).init_params(0),
                              shape=(16, 16), batch=2, device="cpu")
    assert ("CubeRegressor", (16, 16), 2, None, "cpu") in devledger._FLOPS_MEMO
    again = measure_model_flops(CubeRegressor(features=(2,)).init_params(0),
                                shape=(16, 16), batch=2, device="cpu")
    assert again == out and out["flops_per_image"] > 0
    flops, work = count_flops(
        lambda: torch.ones(3, 5) @ torch.ones(5, 7), torch.device("cpu"))
    assert (flops, work) == (2 * 3 * 5 * 7, {})


def test_streamformer_executed_work_count_on_the_cpu():
    """On the CPU the flash wrappers run their plain versions, whose
    products FlopCounterMode sees: 4, 8 and 6 x B*H*T^2*D per block, the
    executed-work count ``chip_smoke.py`` holds the ledger against on the
    card. Here at a small width, within the same 2%."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from blendjax_torch.models import StreamFormer
    from blendjax_torch.train.steps import make_supervised_step, make_train_state

    cfg = {"patch": 8, "dim": 64, "depth": 2, "num_heads": 2,
           "num_outputs": 16}
    shape = (32, 48)
    model = StreamFormer(**cfg, attn_backend="flash",
                         image_shape=shape).init_params(0)
    state = make_train_state(model, device="cpu")
    step = make_supervised_step(chip_smoke.former_loss)
    b = _batch(2, *shape)
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    flops, _ = count_flops(lambda: step(state, batch), torch.device("cpu"))
    want = chip_smoke.former_executed_flops_per_image(cfg, model.tokens)
    assert flops / 2 == pytest.approx(want, rel=0.02)
    # against the model-FLOP figure: the backward's two recomputations of
    # q k^T (6 T^2 dim per block), less the patch embedding's input
    # gradient, which nothing computes
    t, c = model.tokens, cfg["dim"]
    embed = 2 * t * cfg["patch"] ** 2 * 4 * c
    assert want - chip_smoke.former_flops_per_image(cfg, t) == \
        cfg["depth"] * 6 * t * t * c - embed


# -- the kernels' declared work -----------------------------------------------


def test_each_wrapper_declares_the_shared_formula():
    from blendjax_torch import kernels as K

    q = torch.zeros(2, 24, 3, 16, dtype=torch.bfloat16)
    k = torch.zeros(2, 40, 3, 16, dtype=torch.bfloat16)
    for causal in (False, True):
        want = W.attention_work(2, 24, 40, 3, 16, 2, causal)
        for name in ("flash_attention_fwd", "flash_attention_bwd_dkv",
                     "flash_attention_bwd_dq"):
            assert K.KERNELS[name]["wrapper"].work(q, k, causal) == want[name]
    assert W.attention_work(1, 4, 4, 1, 1, 4)["flash_attention_fwd"][0] == 64
    assert W.causal_pairs(4, 4) == 10 and W.causal_pairs(5, 3) == 12
    assert W.causal_pairs(2, 5) == 3

    ref = torch.zeros(40, 16, 32, 4, dtype=torch.uint8)  # (160, 256) grid
    idx = torch.zeros(3, 7, dtype=torch.int32)
    tiles = torch.zeros(3, 7, 16, 32, 4, dtype=torch.uint8)
    ttc = 16 * 32 * 4
    assert K.decode_spatial.work(ref, idx, tiles, (160, 256, 4)) == \
        W.decode_work(40, ttc, 21, 21, 3 * 160 * 256 * 4)
    assert K.decode_scatter.work(ref, idx, tiles) == \
        W.decode_work(40, ttc, 21, 21, 3 * 40 * ttc)
    x = torch.zeros(2, 5, 7, 4, dtype=torch.uint8)
    assert K.gamma_normalize.work(x) == W.gamma_work(280, 4) == (0, 1400)
    assert K.gamma_normalize.work(x, torch.bfloat16) == W.gamma_work(280, 2)


def test_a_diverted_tally_sums_declared_work():
    from blendjax_torch.kernels.counting import count_launch, diverted

    class _Stream:
        cuda_stream = 12345

    def fake():
        pass

    fake.launches = 0
    stream = _Stream()
    orig = torch.cuda.current_stream
    torch.cuda.current_stream = lambda *a: stream
    try:
        with diverted(stream) as tally:
            count_launch(fake, work=lambda: (10, 100))
            count_launch(fake, work=lambda: (5, 50))
            count_launch(fake)
    finally:
        torch.cuda.current_stream = orig
    assert tally["launches"] == {"fake": 3}
    assert tally["work"] == {"fake": (15, 150)}
    assert fake.launches == 0

    def unread():
        raise AssertionError("work read outside a tally")

    count_launch(fake, work=unread)  # not diverted: the work is not read
    assert fake.launches == 1


# -- the ledger ---------------------------------------------------------------


class _FakeGraph:
    """What ``ExecutableLedger.register`` reads of a captured graph."""

    def __init__(self, flops=1e9, lead=4):
        self.flops = flops
        self.work = {"flash_attention_fwd": (2e8, 1e6)}
        self.static = {"image": torch.zeros(lead, 2, dtype=torch.uint8),
                       "xy": torch.zeros(lead, 8, 2)}
        self.loss = torch.zeros(())
        self.state_bytes = 1000
        self.graph = None


def test_register_publishes_gauges_and_picks_flops_per_image(monkeypatch):
    from blendjax_torch.train import aot

    monkeypatch.setattr(aot, "pool_bytes", lambda g, segments=None: 4096)
    reg = Metrics()
    led = ExecutableLedger(registry=reg)
    sig = (("image", (4, 2), "torch.uint8"), ("xy", (4, 8, 2), "torch.float32"))
    e = led.register("step", _FakeGraph(), signature=sig)
    assert e["batch_images"] == 4 and e["flops"] == 1e9
    assert e["kernel_flops"] == 2e8 and e["kernel_bytes"] == 1e6
    assert e["argument_bytes"] == 8 + 256 + 1000
    assert e["output_bytes"] == 4 and e["temp_bytes"] == 4096
    assert e["hbm_peak_bytes"] == 8 + 256 + 1000 + 4 + 4096
    assert e["collectives"]["total_bytes"] == 0
    gauges = reg.report()["gauges"]
    assert gauges["device.flops_per_step"] == 1e9
    assert gauges["device.collective_bytes"] == 0
    assert "device.bytes_accessed" not in gauges  # unavailable, unpublished
    led.register("step", _FakeGraph(flops=5e8, lead=2), batch_images=2)
    assert led.flops_per_image() == 1e9 / 4
    assert led.flops_per_image(batch_images=2) == 5e8 / 2
    assert set(LEDGER_GAUGES) >= set(k for k in gauges
                                     if not k.startswith("device.collective."))


def test_pool_bytes_sums_the_segments_of_the_graph_pool():
    from blendjax_torch.train.aot import pool_bytes

    class _Pool:
        @staticmethod
        def pool():
            return (0, 7)

    graph = types.SimpleNamespace(graph=_Pool())
    segments = [{"total_size": 10, "segment_pool_id": (0, 7)},
                {"total_size": 5, "segment_pool_id": (0, 0)},
                {"total_size": 3, "segment_pool_id": (0, 7)},
                {"total_size": 9}]
    assert pool_bytes(graph, segments) == 13


def test_register_aot_set_sizes_every_pool_from_one_snapshot(monkeypatch):
    from blendjax_torch.train import aot

    snapshots, seen = [], []
    monkeypatch.setattr(torch.cuda, "memory_snapshot",
                        lambda: snapshots.append(1) or ["segments"])
    monkeypatch.setattr(
        aot, "pool_bytes",
        lambda g, segments=None: seen.append(segments) or 4096)
    led = ExecutableLedger(registry=Metrics())
    graphs = {}
    for lead in (1, 2, 4):
        sig = (("image", (lead, 2), "torch.uint8"),
               ("xy", (lead, 8, 2), "torch.float32"))
        graphs[sig] = _FakeGraph(flops=1e9 * lead, lead=lead)
    graphs["cpu"] = None
    entries = led.register_aot_set("ladder", graphs)
    assert [e["batch_images"] for e in entries] == [1, 2, 4]
    assert all(e["temp_bytes"] == 4096 for e in entries)
    assert snapshots == [1] and seen == [["segments"]] * 3
    assert led.register_aot_set("empty", {"cpu": None}) == []
    assert snapshots == [1]  # no snapshot for a set with no graph


def test_register_degrades_and_never_raises():
    reg = Metrics()
    led = ExecutableLedger(registry=reg)
    e = led.register("broken", object())
    assert e["flops"] == "unavailable" and e["temp_bytes"] == "unavailable"
    assert reg.report()["counters"]["device.ledger_failures"] == 2
    assert led.flops_per_image() is None


def test_batch_signature_equals_the_reference():
    pytest.importorskip("jax")
    from blendjax.obs.devledger import batch_signature as jsig

    b = {"image": np.zeros((6, 8, 8, 4), np.uint8),
         "xy": np.zeros((6, 8, 2), np.float32), "_mask": np.ones(6),
         "_meta": [1], "scalar": np.float32(1.0), "frameid": np.arange(6)}
    assert batch_signature(b) == jsig(b)


def test_poll_memory_is_none_on_the_cpu():
    assert ledger.poll_memory() is None
    assert ledger.report()["memory"] == {"supported": False}
    assert not any(k in metrics.report()["gauges"] for k in HBM_GAUGES)


def test_default_peak_flops_by_name():
    assert default_peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert default_peak_flops("NVIDIA H100 PCIe") == 756e12
    assert default_peak_flops("Unknown") is None


def test_note_retrace_counts_attributes_and_fires_flight_once():
    class _Flight:
        def __init__(self):
            self.dumps = []

        def dump(self, **kw):
            self.dumps.append(kw)

    reg = Metrics()
    led = ExecutableLedger(registry=reg)
    fl = _Flight()
    led.attach_flight(fl, threshold=2)
    sig = (("image", (6, 8, 8, 4), "torch.uint8"),)
    led.note_retrace(sig)
    assert fl.dumps == []
    led.note_retrace(sig)
    led.note_retrace(sig)
    assert len(fl.dumps) == 1
    assert reg.report()["counters"]["device.retraces"] == 3
    assert "(6, 8, 8, 4)" in led.report()["retraces"]["events"][0]["signature"]


def test_retrace_audit_counts_a_new_signature_once_after_warmup():
    sizes = iter([3, 3, 3, 4, 4, 5])
    step = types.SimpleNamespace(_cache_size=lambda: next(sizes),
                                 signature_of=lambda b: ("sig", b["n"]))
    audit = RetraceAudit(step, warmup=1)
    got = [audit.observe({"n": i}) for i in range(6)]
    assert got == [False, False, False, True, False, True]
    ev = ledger.report()["retraces"]["events"]
    assert [e["signature"] for e in ev] == ["('sig', 3)", "('sig', 5)"]
    assert RetraceAudit.for_step(lambda s, b: (s, b)) is None


def test_driver_build_counts_no_retrace_on_the_ladder_and_one_outside():
    """TrainDriver.build(aot=True) on the CPU: every bucketed shape is a
    known signature (no retrace); an unbucketed lead of 3 fed twice is one
    retrace, attributed to it."""
    from blendjax_torch.models import CubeRegressor
    from blendjax_torch.train import TrainDriver

    drv = TrainDriver.build(CubeRegressor(features=(2,)).init_params(0),
                            _batch(4), rng=0, sync_every=0, device="cpu")
    assert drv.retrace_audit is not None
    full = {k: torch.from_numpy(v) for k, v in _batch(4, seed=1).items()}
    for _ in range(3):
        drv.submit(dict(full))
    part = {k: v[:2] for k, v in full.items()}
    part["_mask"] = torch.ones(2)
    drv.submit(part)  # a bucket of the ladder: known
    assert ledger.retrace_count == 0
    odd = {k: v[:3] for k, v in full.items()}
    drv.submit(dict(odd))
    drv.submit(dict(odd))
    drv.drain()
    assert ledger.retrace_count == 1
    assert metrics.report()["counters"]["device.retraces"] == 1
    assert "(3, 16, 16, 4)" in ledger.report()["retraces"]["events"][0][
        "signature"]
    assert drv.step.aot_fallbacks == 2
    assert metrics.report()["counters"]["train.aot_fallbacks"] == 2
    assert drv.stats["mfu_source"] is None  # no graphs, no cost model


def test_driver_adopts_cost_model_flops_unless_hand_fed():
    from blendjax_torch.train import TrainDriver

    def step(state, batch):
        return state, {"loss": torch.zeros(())}

    step.ledger_entries = [
        {"flops": 8e9, "batch_images": 8}, {"flops": 4e9, "batch_images": 4},
        {"flops": "unavailable", "batch_images": 16},
    ]
    drv = TrainDriver(step, None, peak_flops=1e12)
    assert drv.stats["mfu_source"] == "cost-model"
    assert drv.flops_per_image == 1e9
    hand = TrainDriver(step, None, flops_per_image=123.0, peak_flops=1e12)
    assert (hand.stats["mfu_source"], hand.flops_per_image) == ("hand-fed",
                                                                123.0)


def test_driver_emits_the_reference_metric_names():
    from blendjax_torch.train import TrainDriver

    def step(state, batch):
        return state, {"loss": torch.zeros(())}

    drv = TrainDriver(step, None, sync_every=2, flops_per_image=1e9,
                      peak_flops=1e12)
    for _ in range(5):
        drv.submit({"image": np.zeros((2, 4, 4, 4), np.uint8)})
    drv.drain()
    rep = metrics.report()
    assert rep["counters"]["train.dispatches"] == 5
    assert rep["spans"]["train.dispatch"]["count"] == 5
    assert rep["spans"]["driver.loss_sync"]["count"] == 2
    assert rep["histograms"]["train.step_device_ms"]["count"] == 5
    assert rep["gauges"]["train.mfu"] > 0


# -- on the card --------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_ladder_cost_model_within_ten_percent_of_hand_fed(card):
    """TrainDriver.build(aot=True) registers its ladder; the cost-model
    FLOPs per image agree with measure_model_flops within 10%."""
    from blendjax_torch.models import CubeRegressor
    from blendjax_torch.train import TrainDriver

    model = CubeRegressor(features=(8, 16)).init_params(0)
    hand = measure_model_flops(model, shape=(32, 48), batch=4, memo=False)
    drv = TrainDriver.build(model, _batch(4, 32, 48), rng=0, sync_every=0)
    entries = drv.step.ledger_entries
    assert len(entries) == len(drv.step.signatures)
    assert all(isinstance(e["flops"], float) for e in entries)
    assert all(e["temp_bytes"] > 0 for e in entries)
    assert drv.stats["mfu_source"] == "cost-model"
    assert drv.flops_per_image == pytest.approx(hand["flops_per_image"],
                                                rel=0.10)


@pytest.mark.cuda
def test_card_ladder_counts_once_and_scales_exactly(card):
    """The ladder counts the torch operators on its first capture only and
    scales by images for the rest: every entry equals count_flops over the
    eager step at its own batch size."""
    import copy

    from blendjax_torch.models import CubeRegressor
    from blendjax_torch.train import TrainDriver
    from blendjax_torch.train.steps import make_supervised_step, make_train_state

    model = CubeRegressor(features=(8, 16)).init_params(0)
    full = _batch(8, 32, 48)
    drv = TrainDriver.build(copy.deepcopy(model), full, rng=0, sync_every=0)
    step = make_supervised_step()
    leads = set()
    for e in drv.step.ledger_entries:
        n = e["batch_images"]
        leads.add(n)
        state = make_train_state(copy.deepcopy(model))
        b = {k: torch.from_numpy(v[:n]).to(card) for k, v in full.items()}
        flops, work = count_flops(lambda: step(state, b), card)
        assert work == {}
        assert e["flops"] == pytest.approx(flops, rel=1e-9)
    assert len(leads) > 1


@pytest.mark.cuda
def test_card_poll_memory_sets_the_hbm_gauges(card):
    x = torch.empty(1 << 24, dtype=torch.uint8, device=card)
    sample = ledger.poll_memory()
    assert sample["bytes_in_use"] > 0 and sample["allocated_bytes"] >= x.numel()
    gauges = metrics.report()["gauges"]
    assert gauges["device.hbm_in_use_bytes"] > 0
    assert 0.0 < gauges["device.hbm_headroom_frac"] < 1.0


@pytest.mark.cuda
def test_card_retrace_after_warmup_on_a_captured_step(card):
    """A CapturedStep prepared ahead is warm; a signature met after the
    warm-up is one retrace, attributed."""
    from blendjax_torch.models import CubeRegressor
    from blendjax_torch.train import CapturedStep, TrainDriver
    from blendjax_torch.train.steps import make_supervised_step, make_train_state

    state = make_train_state(CubeRegressor(features=(8,)).init_params(0))
    graph = CapturedStep(make_supervised_step())

    def dev(b):
        return {k: torch.from_numpy(v).to(card) for k, v in b.items()}

    graph.prepare(state, dev(_batch(4, 16, 16)))
    assert len(graph.ledger_entries) == 1
    drv = TrainDriver(graph, state, sync_every=0)
    for _ in range(3):
        drv.submit(dev(_batch(4, 16, 16)))
    assert ledger.retrace_count == 0
    for _ in range(2):
        drv.submit(dev(_batch(2, 16, 16)))
    drv.drain()
    assert ledger.retrace_count == 1
    assert len(graph.ledger_entries) == 2
