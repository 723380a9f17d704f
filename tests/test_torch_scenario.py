"""The port's scenario subsystem (blendjax_torch.scenario, the producer's
applicator, the scene hooks and the stamp plumbing) against the JAX
package's (blendjax.scenario), on the CPU.

Space, accounting and curriculum run the JAX package's own cases on both
packages with the same inputs: the same seed draws the same scenarios and
parameters, the ledgers give identical reports, and the curriculum gives
the same weights and versions, its Gaussian ``mu`` within 1e-6 (f32 on
both sides). The echo pipelines of the two packages, fed the same stamped
batches one at a time (the next only once the draw loop waits for it),
attribute every drawn row identically. Service and applicator talk across
the packages over real PAIR sockets, each wait with its own timeout.
"""

import time

import numpy as np
import pytest
import torch

import blendjax.scenario as J
import blendjax_torch.scenario as P

SPECS = [
    "easy:half_extent=u(0.5,0.8) / "
    "hard*3:xy_jitter=g(6,0.5),style=c(a|b|c),size=m(u(0,1)@0.7|g(2,0.1)@0.3),k=42",
    "s:a=u(1,2),b=g(10,0.1),c=g(-5,0.1)",
    "easy*2:half_extent=u(0.8,1.2) / hard:xy_jitter=g(6,0.5),style=c(a|b@0.25|c)",
    "a:tex=c(wood/oak|stone/slate) / b:x=u(0,1)",
    "s:style=c(a@0.9|b),mix=m(u(0,1)@3|g(5,1))",
]
TIMEOUT_S = 10.0


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _stamped_batch(sid, ver, n=4, theta=None, image=0):
    stamp = {"id": sid, "ver": ver}
    if theta is not None:
        stamp["theta"] = theta
    return {
        "image": np.full((n, 4, 4, 3), image, np.uint8),
        "_meta": [{"btid": 0, "_scenario": dict(stamp)}] * n,
    }


# -- space: grammar, sampling, wire form ---------------------------------------


@pytest.mark.parametrize("spec", range(len(SPECS)))
def test_space_parses_and_draws_as_the_reference(spec):
    mine, ref = P.ScenarioSpace.parse(SPECS[spec]), J.ScenarioSpace.parse(
        SPECS[spec])
    assert mine.to_wire() == ref.to_wire()
    assert mine.weights() == ref.weights()
    r1, r2 = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(64):
        assert mine.sample(r1) == ref.sample(r2)


def test_space_grammar_distributions_and_weights():
    sp = P.ScenarioSpace.parse(SPECS[0])
    assert sp.names == ("easy", "hard")
    w = sp.weights()
    assert abs(w["hard"] - 0.75) < 1e-9 and abs(sum(w.values()) - 1) < 1e-9
    hard = sp.scenarios["hard"]
    assert isinstance(hard.params["xy_jitter"], P.Gaussian)
    assert type(hard.params["style"]).__name__ == "Choice"
    assert type(hard.params["size"]).__name__ == "Mixture"
    assert hard.params["k"].sample(np.random.default_rng(0)) == 42
    assert isinstance(sp.scenarios["easy"].params["half_extent"], P.Uniform)


def test_space_sampling_bounds_and_theta_order():
    sp = P.ScenarioSpace.parse(SPECS[1])
    rng = np.random.default_rng(0)
    for _ in range(32):
        name, params, theta = sp.sample(rng)
        assert name == "s" and 1 <= params["a"] <= 2
        assert theta == [params["b"], params["c"]]


@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port"])
def test_space_wire_round_trip_is_pickle_free_across_packages(direction):
    from blendjax.transport.wire import decode_message as jdecode
    from blendjax.transport.wire import encode_message as jencode
    from blendjax_torch.transport.wire import decode_message, encode_message

    src_pkg, dst_pkg = (P, J) if direction == "port-to-jax" else (J, P)
    enc = encode_message if src_pkg is P else jencode
    dec = jdecode if dst_pkg is J else decode_message
    sp = src_pkg.ScenarioSpace.parse(SPECS[2], version=7)
    frames = enc({"scenario_space": sp.to_wire(),
                  "scenario_version": sp.version})
    msg = dec([bytes(f) for f in frames], allow_pickle=False)
    sp2 = dst_pkg.ScenarioSpace.from_wire(msg["scenario_space"])
    assert sp2.version == 7 and sp2.names == sp.names
    assert sp2.weights() == sp.weights()
    assert sp2.to_wire() == sp.to_wire()
    assert sp2.scenarios["hard"].params["xy_jitter"].mu == 6.0
    assert sp2.scenarios["hard"].params["style"].values == ["a", "b", "c"]


def test_space_grammar_slash_and_partial_weights():
    sp = P.ScenarioSpace.parse(SPECS[3])
    assert sp.names == ("a", "b")
    assert sp.scenarios["a"].params["tex"].values == ["wood/oak",
                                                      "stone/slate"]
    sp = P.ScenarioSpace.parse(SPECS[4])
    c = sp.scenarios["s"].params["style"]
    assert c.probs is not None and abs(c.probs[0] - 0.9 / 1.9) < 1e-9
    assert abs(sp.scenarios["s"].params["mix"].weights[0] - 0.75) < 1e-9


@pytest.mark.parametrize("bad", ["", "noparams-and-no-colon", "s:a=zzz(1,2)",
                                 "s:a=u(2,1)", "s:a=g(0,-1)", "s*0:a=1"])
def test_space_grammar_errors_as_the_reference(bad):
    with pytest.raises(ValueError):
        J.ScenarioSpace.parse(bad)
    with pytest.raises(ValueError):
        P.ScenarioSpace.parse(bad)


def test_an_empty_space_raises():
    with pytest.raises(ValueError):
        P.ScenarioSpace([])


# -- accounting: exact counts, versions, losses ---------------------------------


def _report(pkg, case):
    led = pkg.ScenarioAccounting(max_scenarios=2 if case == "overflow" else 256)
    if case == "versions":
        led.declare(pkg.ScenarioSpace.parse("a:x=1 / b:x=2", version=2))
        led.account_batch(_stamped_batch("a", 1, n=4), loss=0.5)
        led.account_batch(_stamped_batch("b", 2, n=4), loss=1.5)
        led.account_batch(_stamped_batch("a", 1, n=2), loss=0.25)
    elif case == "batch-stamp":
        assert led.account_batch({
            "image": np.zeros((3, 4, 4, 3), np.uint8),
            "_scenario": {"id": "solo", "ver": 1}}, loss=1.0) == 3
    elif case == "unstamped":
        assert led.account_batch(
            {"image": np.zeros((3, 4, 4, 3), np.uint8)}, loss=1.0) == 0
    elif case == "overflow":
        led.account_batch(_stamped_batch("a", 1, n=1))
        led.account_batch(_stamped_batch("b", 1, n=1))
        for i in range(5):
            led.account_batch(_stamped_batch(f"junk{i}", 1, n=1), loss=1.0)
    elif case == "chunked":
        rests = [{"btid": 0, "_meta": [
            {"btid": 0, "_scenario": {"id": "a", "ver": 1}},
            {"btid": 0, "_scenario": {"id": "b", "ver": 1}},
        ]} for _ in range(3)]
        assert led.account_batch(
            {"image": np.zeros((3, 2, 4, 4, 3), np.uint8), "_meta": rests},
            loss=0.5) == 6
    elif case == "echo-rows":
        rows = [{"id": "a", "ver": 1, "theta": [0.5]}, None,
                {"id": "b", "ver": 3}, {"id": "a", "ver": 2}]
        led.observe_rows(rows, fresh=[True, True, False, False])
        led.account_batch({"_scenario_rows": rows}, loss=2.0)
        assert led.theta_samples("a", drain=False) == [([0.5], 2.0)]
    return led.report(), led.totals(), led.window_losses(reset=False)


CASES = ["versions", "batch-stamp", "unstamped", "overflow", "chunked",
         "echo-rows"]


@pytest.mark.parametrize("case", CASES)
def test_accounting_reports_as_the_reference(case):
    from blendjax.utils.metrics import metrics as jmetrics
    from blendjax_torch.utils.metrics import metrics

    before = (metrics.report()["counters"], jmetrics.report()["counters"])
    got, want = _report(P, case), _report(J, case)
    assert got == want
    # the registry sees the same constant names and counts on both sides
    after = (metrics.report()["counters"], jmetrics.report()["counters"])
    deltas = [{k: v - b.get(k, 0) for k, v in a.items()
               if k.startswith("scenario.") and v != b.get(k, 0)}
              for a, b in zip(after, before)]
    assert deltas[0] == deltas[1]


def test_accounting_exact_counts_and_stale_version_attribution():
    rep, totals, _ = _report(P, "versions")
    a, b = rep["scenarios"]["a"], rep["scenarios"]["b"]
    assert a["rows"] == 6 and a["fresh"] == 6 and a["echoed"] == 0
    assert b["rows"] == 4 and a["versions"] == {1: 6}
    assert b["versions"] == {2: 4}
    assert a["loss"]["count"] == 6 and b["loss"]["count"] == 4
    assert a["declared"] and b["declared"] and rep["space_version"] == 2
    assert totals == {"a": (6, 0), "b": (4, 0)}


def test_accounting_overflow_folds_into_one_bucket():
    from blendjax_torch.utils.metrics import metrics

    before = metrics.counter_value("scenario.overflow_rows")
    _, totals, _ = _report(P, "overflow")
    assert set(totals) == {"a", "b", "__overflow__"}
    assert totals["__overflow__"] == (5, 0)
    assert metrics.counter_value("scenario.overflow_rows") - before == 5


def test_the_ledger_snapshot_crosses_the_packages():
    """The port's ``state_dict`` loads into the JAX ledger and back, and
    both report the same afterwards (one session store for both)."""
    port = P.ScenarioAccounting()
    port.declare(P.ScenarioSpace.parse("a:x=g(0,1) / b:x=2", version=3))
    port.account_batch(_stamped_batch("a", 3, n=4, theta=[0.25]), loss=0.5)
    port.account_batch(_stamped_batch("b", 2, n=2), loss=1.5)
    ref = J.ScenarioAccounting()
    ref.load_state_dict(port.state_dict())
    assert ref.report() == port.report()
    back = P.ScenarioAccounting()
    back.load_state_dict(ref.state_dict())
    assert back.state_dict() == port.state_dict()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_schema_keeps_scenario_meta_even_when_first_item_unstamped(pkg):
    if pkg == "port":
        from blendjax_torch.data.batcher import BatchAssembler
        from blendjax_torch.data.schema import StreamSchema
        rows_of = P.batch_row_scenarios
    else:
        from blendjax.data.batcher import BatchAssembler
        from blendjax.data.schema import StreamSchema
        rows_of = J.batch_row_scenarios
    first = {"image": np.zeros((4, 4, 3), np.uint8), "btid": 0}
    schema = StreamSchema.infer(first)
    assert "_scenario" in schema.meta_keys
    asm = BatchAssembler(schema, batch_size=2)
    assert asm.add(first) is None
    stamped = dict(first)
    stamped["_scenario"] = {"id": "late", "ver": 2}
    batch = asm.add(stamped)
    assert rows_of(batch, 2) == [None, {"id": "late", "ver": 2}]


def test_schema_batch_shapes_and_keys_as_the_reference():
    from blendjax.data.schema import StreamSchema as JSchema
    from blendjax_torch.data.schema import StreamSchema

    item = {"image": np.zeros((4, 6, 3), np.uint8), "xy": np.zeros(
        (8, 2), np.float32), "frameid": 3, "btid": 1, "name": "x"}
    mine, ref = StreamSchema.infer(item), JSchema.infer(item)
    assert mine.batch_shapes(5) == ref.batch_shapes(5)
    assert list(mine.keys()) == list(ref.keys())
    assert mine.meta_keys == ref.meta_keys
    assert repr(mine) == repr(ref)


def test_batch_row_scenarios_precedence():
    rows = [{"id": "r", "ver": 3}] * 2
    batch = {"_scenario_rows": rows,
             "_meta": [{"_scenario": {"id": "m", "ver": 1}}] * 2,
             "_scenario": {"id": "b", "ver": 1}}
    for fn in (P.batch_row_scenarios, J.batch_row_scenarios):
        b = dict(batch)
        assert fn(b, 2) == rows
        del b["_scenario_rows"]
        assert [r["id"] for r in fn(b, 2)] == ["m", "m"]
        del b["_meta"]
        assert [r["id"] for r in fn(b, 2)] == ["b", "b"]


# -- echo: per-row attribution, slot clearing -----------------------------------


def _paced(pipe_ref, batches):
    """Yield each batch only once the draw loop has waited for it, so
    both packages insert at the same draws."""
    for i, b in enumerate(batches):
        if i:
            deadline = time.monotonic() + TIMEOUT_S
            while pipe_ref[0].saturated_waits < i:
                if time.monotonic() > deadline:
                    raise TimeoutError("the draw loop never waited")
                time.sleep(0.002)
        yield b


def _echo_run(pkg, batches, monkeypatch, **kw):
    if pkg == "port":
        import blendjax_torch.data.echo as mod
        kw["device"] = "cpu"
    else:
        import blendjax.data.echo as mod
    led = (P if pkg == "port" else J).ScenarioAccounting()
    monkeypatch.setattr(mod, "scenario_accounting", led)
    ref = [None]
    pipe = mod.EchoingPipeline(_paced(ref, batches), augment=None,
                               batch_size=4, rng=3, **kw)
    ref[0] = pipe
    rows = []
    with pipe:
        for b in pipe:
            rows.append(b.get("_scenario_rows"))
    return rows, led.totals(), (pipe.fresh, pipe.echoed, pipe.steps)


def test_echo_rows_are_attributed_as_the_reference(monkeypatch):
    batches = [_stamped_batch("even" if i % 2 == 0 else "odd", 1, n=4,
                              image=i) for i in range(8)]
    got = _echo_run("port", batches, monkeypatch, capacity=32,
                    max_echo_factor=4)
    want = _echo_run("jax", batches, monkeypatch, capacity=32,
                     max_echo_factor=4)
    assert got == want
    rows, totals, (fresh, echoed, steps) = got
    assert set(totals) == {"even", "odd"}
    assert sum(f + e for f, e in totals.values()) == steps * 4
    assert sum(f for f, _ in totals.values()) == fresh
    assert sum(e for _, e in totals.values()) == echoed
    assert all(len(r) == 4 and all(s["id"] in ("even", "odd") for s in r)
               for r in rows)


def test_echo_unstamped_batches_clear_the_slot_sidecar(monkeypatch):
    batches = [_stamped_batch("a", 1, n=4),
               {"image": np.ones((4, 4, 4, 3), np.uint8)}]
    got = _echo_run("port", batches, monkeypatch, capacity=4,
                    max_echo_factor=2)
    want = _echo_run("jax", batches, monkeypatch, capacity=4,
                     max_echo_factor=2)
    assert got == want
    rows, totals, _ = got
    f, e = totals.get("a", (0, 0))
    assert f + e <= 8  # at most the stamped batch's own echo budget
    assert rows[-1] == [None] * 4  # drawn after the overwrite


def test_echo_state_dict_carries_the_sidecar():
    from blendjax_torch.data.echo import EchoingPipeline

    pipe = EchoingPipeline(iter([]), capacity=4, batch_size=4, augment=None,
                           device="cpu")
    pipe._insert_fresh(_stamped_batch("a", 2, n=4))
    d = pipe.state_dict()
    assert d["scen_active"] is True
    assert d["slot_scen"] == [{"id": "a", "ver": 2}] * 4
    other = EchoingPipeline(iter([]), capacity=4, batch_size=4,
                            augment=None, device="cpu")
    other.load_state_dict(d)
    assert other._slot_scen == d["slot_scen"] and other._scen_active


# -- curriculum ------------------------------------------------------------------


def _curriculum(pkg, case):
    led = pkg.ScenarioAccounting()
    if case == "reinforce":
        sp = pkg.ScenarioSpace([pkg.Scenario("s", {"jit": pkg.Gaussian(0.0,
                                                                       1.0)})])
        cur = pkg.ScenarioCurriculum(sp, ledger=led, every_steps=1,
                                     min_rows=2, param_lr=0.2,
                                     weight_lr=0.0)
        rng = np.random.default_rng(0)
        for _ in range(3):
            for _ in range(16):
                theta = float(rng.normal(0.0, 1.0)
                              + sp.scenarios["s"].params["jit"].mu)
                led.observe_rows([{"id": "s", "ver": sp.version}])
                led.observe_loss(
                    [{"id": "s", "ver": sp.version, "theta": [theta]}],
                    (theta - 2.0) ** 2)
            cur.update()
        g = sp.scenarios["s"].params["jit"]
        return sp.version, (g.mu, g.sigma), cur.state_dict()
    spec, kw, feed = {
        "toward-loss": ("calm:x=1 / storm:x=2",
                        dict(adapt_params=False, min_rows=4),
                        [("calm", 4, 0.1), ("storm", 4, 1.0)] * 4),
        "frozen": ("a:x=1 / b:x=2",
                   dict(adapt_params=False, frozen=True),
                   [("a", 8, 0.1), ("b", 8, 9.0)]),
        "min-rows": ("a:x=1 / b:x=2",
                     dict(min_rows=100, adapt_params=False),
                     [("a", 4, 1.0)]),
        "no-signal": ("a:x=1 / b:x=2",
                      dict(min_rows=2, adapt_params=False),
                      [("a", 8, 1.0), ("b", 8, 1.0)]),
    }.get(case, (None, None, None))
    if case in ("starved", "noop-cadence"):
        sp = pkg.ScenarioSpace.parse(
            "rich:x=1 / poor:x=2" if case == "starved" else "a:x=1 / b:x=2")
        cur = pkg.ScenarioCurriculum(
            sp, ledger=led, every_steps=1, adapt_params=False,
            min_rows=8 if case == "starved" else 4)
        reports = []
        if case == "starved":
            for _ in range(3):
                led.account_batch(_stamped_batch("rich", 1, n=16), loss=0.1)
                led.account_batch(_stamped_batch("poor", 1, n=4), loss=2.0)
                reports.append(cur.update())
        else:
            led.account_batch(_stamped_batch("a", 1, n=8), loss=1.0)
            led.account_batch(_stamped_batch("b", 1, n=8), loss=1.0)
            reports.append(cur.update())
            led.account_batch(_stamped_batch("b", 1, n=8), loss=3.0)
            reports.append(cur.update())
            reports.append(led.window_losses(reset=False, min_rows=1))
        return sp.version, sp.weights(), reports
    sp = pkg.ScenarioSpace.parse(spec)
    cur = pkg.ScenarioCurriculum(sp, ledger=led, every_steps=1, **kw)
    for sid, n, loss in feed:
        led.account_batch(_stamped_batch(sid, 1, n=n), loss=loss)
    report = cur.step(1) if case == "frozen" else cur.update()
    return sp.version, sp.weights(), report, cur.weight_floor


CURRICULA = ["toward-loss", "frozen", "min-rows", "no-signal", "starved",
             "noop-cadence"]


@pytest.mark.parametrize("case", CURRICULA)
def test_curriculum_weights_as_the_reference(case):
    got, want = _curriculum(P, case), _curriculum(J, case)
    assert got == want
    version, weights = got[0], got[1]
    if case == "toward-loss":
        assert version == 2 and weights["storm"] > 0.5 > weights["calm"]
        assert weights["calm"] >= got[3]
    elif case in ("frozen", "min-rows", "no-signal"):
        assert version == 1 and got[2] is None
    elif case == "starved":
        assert weights["poor"] > 0.5 and version >= 2
    else:
        assert got[2][0] is None and weights["b"] > 0.5
        assert got[2][2] == {}


def test_curriculum_reinforce_moves_mu_as_the_reference():
    (v1, (mu1, s1), st1), (v2, (mu2, s2), st2) = (
        _curriculum(P, "reinforce"), _curriculum(J, "reinforce"))
    assert v1 == v2 and v1 > 1
    assert abs(mu1 - mu2) <= 1e-6 and abs(s1 - s2) <= 1e-6
    assert mu1 > 0.15
    assert abs(st1["baselines"]["s"] - st2["baselines"]["s"]) <= 1e-6
    assert st1["space"]["version"] == st2["space"]["version"]


def test_curriculum_runs_its_reinforce_on_the_cpu_by_choice():
    led = P.ScenarioAccounting()
    sp = P.ScenarioSpace([P.Scenario("s", {"jit": P.Gaussian(0.0, 1.0)})])
    cur = P.ScenarioCurriculum(sp, ledger=led, every_steps=1, min_rows=2,
                               weight_lr=0.0)
    for t in (0.5, -0.5, 1.0, 2.0):
        led.observe_loss([{"id": "s", "ver": 1, "theta": [t]}], t * t)
    assert cur.update() is not None
    assert cur._sim["s"].device.type == "cpu"


def test_the_curriculum_snapshot_crosses_the_packages():
    _, _, state = _curriculum(P, "reinforce")
    led = J.ScenarioAccounting()
    sp = J.ScenarioSpace([J.Scenario("s", {"jit": J.Gaussian(0.0, 1.0)})])
    cur = J.ScenarioCurriculum(sp, ledger=led)
    cur.load_state_dict(state)
    assert sp.version == state["space"]["version"]
    assert cur.state_dict()["space"] == state["space"]


# -- the scene, the driver and the stamp keys --------------------------------------


@pytest.mark.parametrize("native", [True, False], ids=["cpp", "numpy"])
def test_cube_scene_scenario_draw_is_complete_not_a_delta(native):
    from blendjax_torch.producer.sim import CubeScene

    scene = CubeScene(shape=(16, 16), seed=0, half_extent=1.25,
                      native=native)
    scene.apply_scenario({"xy_jitter": 9.0, "half_extent": 0.5})
    assert scene.xy_jitter == 9.0 and scene.half_extent == 0.5
    scene.apply_scenario({"half_extent": 0.7})
    assert scene.xy_jitter == 0.0
    scene.apply_scenario({})
    assert scene.half_extent == 1.25
    scene.apply_scenario({"bg": 90})
    assert (scene.render()[0, 0] == [90, 90, 90, 255]).all()
    scene.apply_scenario({})
    assert (scene.render()[0, 0] == [0, 0, 0, 255]).all()


def test_cube_scene_labels_and_frames_match_the_reference_under_a_scenario():
    from blendjax.producer.sim import CubeScene as JCube
    from blendjax_torch.producer.sim import CubeScene

    params = {"xy_jitter": 4.0, "half_extent": 0.8, "bg": 60}
    mine, ref = CubeScene(shape=(24, 32), seed=5), JCube(shape=(24, 32),
                                                         seed=5)
    for scene in (mine, ref):
        scene.apply_scenario(params)
    for frame in range(3):
        mine.step(frame)
        ref.step(frame)
        got, want = mine.observation(frame), ref.observation(frame)
        np.testing.assert_allclose(got["xy"], want["xy"], atol=1e-4)
        np.testing.assert_array_equal(got["image"], want["image"])


def test_driver_strips_the_scenario_sidecar_before_the_step():
    from blendjax_torch.models import CubeRegressor
    from blendjax_torch.train import (
        TrainDriver,
        make_supervised_step,
        make_train_state,
    )

    state = make_train_state(CubeRegressor(features=(8,)).init_params(0),
                             device="cpu")
    driver = TrainDriver(make_supervised_step(), state, inflight=2,
                         sync_every=1)
    batch = {
        "image": torch.zeros((4, 16, 16, 4), dtype=torch.uint8),
        "xy": torch.zeros((4, 8, 2)),
        "_scenario_rows": [{"id": "a", "ver": 1}, None, None, None],
        "_scenario": {"id": "a", "ver": 1},
    }
    driver.submit(batch)
    driver.submit(batch)
    loss = driver.finish()[1]
    assert loss is not None and np.isfinite(loss)
    assert "_scenario_rows" in batch  # the caller's batch keeps it


def test_stamps_stay_out_of_a_captured_steps_signature():
    from blendjax_torch.train.aot import _plan_signature

    token = {"_echo_idx": np.arange(4), "_echo_counter": 3,
             "_by_reference": ()}
    stamped = dict(token, _scenario_rows=[{"id": "a", "ver": 1}, None],
                   _scenario={"id": "a", "ver": 1})
    assert _plan_signature(stamped) == _plan_signature(token)


def test_the_feeder_passes_stamps_as_host_sidecars():
    from blendjax_torch.data.pipeline import DeviceFeeder, _signature

    rows = [{"id": "a", "ver": 1}, None]
    hb = {"image": np.zeros((2, 4, 4, 4), np.uint8), "_scenario_rows": rows,
          "_scenario": {"id": "a", "ver": 1}, "_meta": [{}, {}]}
    out = DeviceFeeder(device="cpu").place(hb)
    assert out["_scenario_rows"] is rows and out["_scenario"] == hb[
        "_scenario"]
    assert isinstance(out["image"], torch.Tensor)
    assert _signature(hb) == _signature({"image": hb["image"],
                                         "_meta": [{}, {}]})


def test_strip_stamps_keeps_scenario_for_replay_reaccounting():
    from blendjax_torch.obs.lineage import strip_stamps

    msg = {"_seq": 4, "_pub_wall": 1.0, "_pub_mono": 2.0,
           "_trace": {"id": "x"}, "_scenario": {"id": "s", "ver": 3},
           "image": 1}
    out = strip_stamps(msg)
    assert "_seq" not in out and "_trace" not in out
    assert out["_scenario"] == {"id": "s", "ver": 3}


def test_the_stamp_keys_are_the_references():
    from blendjax_torch.data import torch_compat

    assert (P.SCENARIO_KEY, P.SCENARIO_ROWS_KEY) == (J.SCENARIO_KEY,
                                                     J.SCENARIO_ROWS_KEY)
    assert torch_compat.SCENARIO_KEY is P.SCENARIO_KEY


def test_session_composes_scenario_curriculum_lineage_and_fleet():
    """One session over the port's components, through the port's
    snapshot codec, restores the JAX package's components (the two
    packages share the format)."""
    from blendjax.checkpoint.format import unpack_session as junpack
    from blendjax.checkpoint.session import restore_session as jrestore
    from blendjax.fleet import FleetController as JController
    from blendjax.obs.lineage import FrameLineage as JLineage
    from blendjax_torch.checkpoint.format import pack_session
    from blendjax_torch.checkpoint.session import collect_session
    from blendjax_torch.fleet import FleetController
    from blendjax_torch.obs.lineage import FrameLineage

    class Launcher:
        def __init__(self, n):
            self.n = n

        def active_count(self):
            return self.n

    led = P.ScenarioAccounting()
    sp = P.ScenarioSpace.parse("a:x=g(0,1) / b:x=2")
    cur = P.ScenarioCurriculum(sp, ledger=led)
    led.account_batch(_stamped_batch("a", 1, n=4, theta=[0.1]), loss=0.5)
    lin = FrameLineage()
    lin.ingest({"btid": 3, "_seq": 0, "_pub_wall": time.time(),
                "_pub_mono": time.monotonic()})
    ctrl = FleetController(Launcher(2), lineage=lin)
    ctrl.remote["box"] = "tcp://10.0.0.2:5555"
    raw = pack_session(collect_session(scenario=led, curriculum=cur,
                                       lineage=lin, fleet=ctrl))
    session = junpack(raw)

    class JLauncher(Launcher):
        def active_indices(self):
            return list(range(self.n))

    jled, jlin = J.ScenarioAccounting(), JLineage()
    jsp = J.ScenarioSpace.parse("a:x=1")
    jcur = J.ScenarioCurriculum(jsp, ledger=jled)

    class Conn:
        def __init__(self):
            self.addrs = []

        def connect(self, a):
            self.addrs.append(a)

    jctrl = JController(JLauncher(2), connector=Conn(), lineage=jlin)
    restored = jrestore(session, scenario=jled, curriculum=jcur,
                        lineage=jlin, fleet=jctrl)
    assert restored == ["scenario", "curriculum", "lineage", "fleet"]
    assert jled.report() == led.report()
    assert jsp.to_wire() == sp.to_wire()
    assert jctrl.remote == {"box": "tcp://10.0.0.2:5555"}
    assert jctrl.connector.addrs == ["tcp://10.0.0.2:5555"]


# -- service and applicator over real PAIR channels ---------------------------------


def _wait(cond, what):
    deadline = time.monotonic() + TIMEOUT_S
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError(what)
        time.sleep(0.01)


@pytest.mark.parametrize("service_pkg", ["jax", "port"])
def test_service_and_applicator_across_the_packages(service_pkg):
    """A JAX service publishing to a port applicator, and the reverse:
    the space arrives, is acked, a republished version is adopted, and
    the stamp carries it."""
    if service_pkg == "jax":
        from blendjax_torch.producer import DuplexChannel
        from blendjax_torch.producer.scenario import ScenarioApplicator
        svc_mod, app_mod = J, P
    else:
        from blendjax.producer import DuplexChannel
        from blendjax.producer.scenario import ScenarioApplicator
        svc_mod, app_mod = P, J
    applied = []
    chan = DuplexChannel("tcp://127.0.0.1:0", btid=0, allow_pickle=False)
    app = ScenarioApplicator(chan, apply=applied.append, rng=0)
    sp = svc_mod.ScenarioSpace.parse("s:a=u(0,1)")
    svc = svc_mod.ScenarioService(sp, ledger=svc_mod.ScenarioAccounting())
    try:
        svc.attach(0, chan.addr)
        assert app.wait_for_space(timeout_s=TIMEOUT_S)
        assert app.version == 1 and isinstance(app.space,
                                               app_mod.ScenarioSpace)
        assert svc.wait_acked(version=1, timeout=TIMEOUT_S), svc.state()
        sp.bump()
        svc.publish(sp)
        _wait(lambda: app.poll() or app.version >= 2, "version 2")
        assert svc.wait_acked(version=2, timeout=TIMEOUT_S), svc.state()
        draw = app.sample()
        assert draw.scenario == "s" and 0 <= draw.params["a"] <= 1
        assert applied[-1] == draw.params
        stamp = app.next_scenario()["_scenario"]
        assert stamp == {"id": "s", "ver": 2}
    finally:
        svc.stop()
        chan.close()


def test_service_detach_closes_member():
    from blendjax_torch.producer import DuplexChannel
    from blendjax_torch.producer.scenario import ScenarioApplicator

    chan = DuplexChannel("tcp://127.0.0.1:0", btid=0)
    app = ScenarioApplicator(chan)
    svc = P.ScenarioService(P.ScenarioSpace.parse("s:a=1"),
                            ledger=P.ScenarioAccounting())
    try:
        svc.attach(7, chan.addr)
        assert app.wait_for_space(timeout_s=TIMEOUT_S)
        assert svc.wait_acked(timeout=TIMEOUT_S), svc.state()
        assert 7 in svc.members()
        svc.detach(7)
        assert 7 not in svc.members()
    finally:
        svc.stop()
        chan.close()


def test_service_survives_dead_member_and_malformed_acks():
    from blendjax_torch.producer import DuplexChannel
    from blendjax_torch.producer.scenario import ScenarioApplicator

    chan = DuplexChannel("tcp://127.0.0.1:0", btid=0)
    app = ScenarioApplicator(chan)
    sp = P.ScenarioSpace.parse("s:a=u(0,1)")
    svc = P.ScenarioService(sp, ledger=P.ScenarioAccounting())
    try:
        svc.attach(99, "tcp://127.0.0.1:9")  # nobody listens there
        svc.attach(0, chan.addr)
        assert app.wait_for_space(timeout_s=TIMEOUT_S)
        chan.send(scenario_ack="junk")
        chan.send(scenario_ack=None)
        for _ in range(3):
            sp.bump()
            svc.publish(sp)
        _wait(lambda: app.poll() or app.version >= sp.version, "republish")
        assert svc.wait_acked(version=sp.version, btids=[0],
                              timeout=TIMEOUT_S), svc.state()
    finally:
        svc.stop()
        chan.close()


def test_applicator_sets_bounded_ack_send_timeout():
    import zmq

    from blendjax_torch.producer import DuplexChannel
    from blendjax_torch.producer.scenario import ScenarioApplicator

    chan = DuplexChannel("tcp://127.0.0.1:0", btid=0, allow_pickle=False)
    try:
        ScenarioApplicator(chan)
        assert chan.sock.getsockopt(zmq.SNDTIMEO) == 500
    finally:
        chan.close()


def test_applicator_survives_a_pickle_from_a_jax_peer():
    """A JAX peer's pickle-bearing control payload (a set travels as an
    embedded pickle) is refused without killing the poll loop, and the
    space right behind it lands."""
    from blendjax.transport import PairChannel as JPair
    from blendjax_torch.producer import DuplexChannel
    from blendjax_torch.producer.scenario import ScenarioApplicator

    chan = DuplexChannel("tcp://127.0.0.1:0", btid=0, allow_pickle=False)
    app = ScenarioApplicator(chan)
    peer = JPair(chan.addr, bind=False)
    try:
        peer.send(scenario_space={1, 2, 3})
        peer.send(scenario_space=J.ScenarioSpace.parse("s:a=1").to_wire(),
                  scenario_version=1)
        assert app.wait_for_space(timeout_s=TIMEOUT_S)
        assert app.version == 1
    finally:
        peer.close()
        chan.close()


# -- end to end: the synthetic fleet, exact per-scenario histograms ------------------


def test_e2e_synthetic_fleet_exact_per_scenario_histograms(monkeypatch):
    import blendjax_torch.data.echo as echo_mod
    from blendjax_torch.data import EchoingPipeline, StreamDataPipeline
    from blendjax_torch.fleet import synthetic_fleet
    from blendjax_torch.obs.lineage import lineage

    lineage.reset()
    led = P.ScenarioAccounting()
    monkeypatch.setattr(echo_mod, "scenario_accounting", led)
    sp = P.ScenarioSpace.parse(
        "easy:half_extent=u(0.8,1.2) / hard:xy_jitter=g(6,0.5)")
    svc = P.ScenarioService(sp, ledger=led)
    steps = 0
    try:
        with synthetic_fleet(2, shape=(32, 32), batch=4, rate=60,
                             scenario=True, bind_grace_s=0.5) as launcher:
            for i, addr in enumerate(launcher.addresses["CTRL"]):
                svc.attach(i, addr)
            assert svc.wait_acked(timeout=15), svc.state()
            pipe = StreamDataPipeline(launcher.addresses["DATA"],
                                      batch_size=8, timeoutms=20_000,
                                      device="cpu")
            echo = EchoingPipeline(pipe, capacity=64, max_echo_factor=4,
                                   augment=None, device="cpu")
            with echo:
                for b in echo:
                    led.observe_loss(b["_scenario_rows"], 0.5 + 0.01 * steps)
                    steps += 1
                    if steps >= 25:
                        break
    finally:
        svc.stop()
        lineage.reset()
    totals = led.totals()
    assert set(totals) == {"easy", "hard"}
    assert sum(f + e for f, e in totals.values()) == steps * 8
    rep = led.report()
    for sid in ("easy", "hard"):
        s = rep["scenarios"][sid]
        assert s["loss"]["count"] == s["rows"]
        assert s["declared"] and set(s["versions"]) == {1}
