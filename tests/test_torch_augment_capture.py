"""Captured steps over a plain ``fn(seed, images)`` augmentation.

The JAX package folds each update's step (each draw's counter) into the
augmentation key inside its jitted step, so every update augments with
its own key, whatever ``fn`` is. A CUDA graph replays the host values of
its capture, so the port captures only a ``SeededAugment`` (whose
generators are seeded on the host before each replay) and runs a step
over any other ``fn`` eagerly on the card, counted in ``eager_calls``
(``step.capturable``).

On the CPU the wrappers are driven as on a card: the state reads as a
card's (``aot.state_device``), and every capture goes through a stand-in,
a real ``aot._Graph`` whose "replay" reruns the step on its static inputs
with the host values the capture call saw (``state.step``, the draw
counter), as a CUDA graph replay does; registered generators draw as the
host seeded them before the replay (``SeededAugment.seed`` is patched off
inside it). ``tests/test_torch_graphs.py`` holds the real graphs on a card.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from blendjax_torch.data import SampleReservoir, StreamDataPipeline
from blendjax_torch.data.echo import default_echo_augment
from blendjax_torch.models import CubeRegressor
from blendjax_torch.ops import augment as A
from blendjax_torch.train import aot
from blendjax_torch.train import steps as S

FEATURES = (8, 16, 8)
SHAPE = (32, 64, 4)
BASE = 7  # augment_rng, and the reservoir's rng


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _stand_in_capture(step, state, batch, stream, mode, stager,
                      op_flops_per_image=None):
    """``aot._capture`` on the CPU: static inputs made as on the card, one
    call of the step on them (the capture) with the state put back after
    it, and a graph whose replay reruns the step on the static inputs with
    the capture call's host values: ``state.step`` as it stood, and the
    static batch's unkeyed entries (the draw counter) as they were."""
    device = torch.device("cpu")
    static = aot._make_static(batch, device)
    snap = aot._snapshot(state, step, batch)
    step0 = state.step
    generators = aot._generators(step, state, static)
    aot._reseed(step, state, static)
    _, out = step(state, static)
    updates = state.step - step0
    aot._restore(state, snap, step, batch)
    state.step = step0
    loss = out["loss"].clone()

    class Replayed:
        replays = 0

        def replay(self):
            self.replays += 1
            live = state.step
            state.step = step0
            with mock.patch.object(A.SeededAugment, "seed",
                                   lambda *a, **k: None):
                _, got = step(state, static)
            state.step = live
            loss.copy_(got["loss"])

    return aot._Graph(step, Replayed(), static, loss, updates, {}, {},
                      generators, stager, images=aot.batch_images(batch))


class _NoLedger:
    def register(self, *a, **k):
        return {}

    def register_aot_set(self, *a, **k):
        return []


@pytest.fixture
def card(monkeypatch):
    """Run the wrappers on a CPU state as on a card's; returns the list of
    batches a capture was tried on."""
    tried = []

    def capture(step, state, batch, *rest):
        tried.append(batch)
        return _stand_in_capture(step, state, batch, *rest)

    monkeypatch.setattr(aot, "_capture", capture)
    monkeypatch.setattr(aot, "state_device", lambda state: torch.device("cuda"))
    monkeypatch.setattr(aot, "ledger", _NoLedger())
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: None)
    return tried


def _plain(seen):
    """A plain ``fn(seed, images)`` whose output depends on the seed (a
    brightness shift drawn by a generator seeded from it); it records each
    seed and each image batch it returns."""
    def fn(seed, images):
        gen = torch.Generator(device=images.device).manual_seed(seed)
        shift = torch.randint(1, 64, (), generator=gen, device=images.device)
        out = images + shift.to(images.dtype)
        seen.append((seed, out.clone()))
        return out

    return fn


def _plain_batch(seen):
    """The same shift as :func:`_plain` on a batch dict's ``image``: the
    ``fn(seed, batch)`` form of a reservoir's ``augment``."""
    fn = _plain(seen)
    return lambda seed, batch: {**batch, "image": fn(seed, batch["image"])}


def _state(seed=0):
    model = CubeRegressor(features=FEATURES, dtype=torch.float32)
    return S.make_train_state(model.init_params(seed), device="cpu")


def _batch(b=4, seed=1):
    rng = np.random.default_rng(seed)
    return {"image": torch.from_numpy(
                rng.integers(0, 256, (b, *SHAPE), dtype=np.uint8)),
            "xy": torch.from_numpy(
                rng.uniform(0, 48, (b, 8, 2)).astype(np.float32))}


class _Capture:
    def __init__(self):
        self.msgs = []

    def publish(self, **msg):
        self.msgs.append(dict(msg, btid=0, _seq=len(self.msgs)))


def _packed_groups(n=2, chunk=2, batch=2):
    """``n`` packed chunk groups of a cube producer's tile-delta stream
    (tile (16, 32): the decode of K1's layout)."""
    from blendjax_torch.producer import CubeScene, TileBatchPublisher

    scene = CubeScene(shape=SHAPE[:2], seed=3)
    cap = _Capture()
    tp = TileBatchPublisher(cap, scene.background_image(), batch,
                            tile=(16, 32), alpha_slice=False, capacity=3)
    buf = np.empty(SHAPE, np.uint8)
    for f in range(1, n * chunk * batch + 1):
        scene.step(f)
        scene.render(out=buf)
        tp.add(buf, xy=scene.camera.world_to_pixel(
            scene.corners_world()).astype(np.float32), frameid=np.int64(f))
    groups = list(StreamDataPipeline(iter(cap.msgs), batch_size=batch,
                                     device="cpu", chunk=chunk,
                                     emit_packed=True))
    assert len(groups) == n
    return groups


def _reservoir(augment):
    res = SampleReservoir(8, augment=augment, rng=BASE, device="cpu")
    res.insert(_batch(8, seed=5))
    return res


_IDX = (np.array([0, 3, 5, 6]), np.array([7, 1, 1, 2]))


def _run(builder, augment, wrap):
    """Two calls of ``builder``'s step over ``augment`` on a fresh state,
    through ``wrap(step, state)`` (None: the eager step). Returns the
    losses, the state and the wrapper."""
    state = _state()
    if builder == "echo":
        res = _reservoir(None)
        res.augment = augment
        step = S.make_echo_fused_step(res.draw, precision="f32")
        calls = [res.draw_token(i) for i in _IDX]
    elif builder == "fused":
        step = S.make_fused_tile_step(augment=augment, augment_rng=BASE,
                                      precision="f32")
        calls = _packed_groups()
    else:
        make = (S.make_chunked_supervised_step if builder == "chunked"
                else S.make_supervised_step)
        step = make(augment=augment, augment_rng=BASE, precision="f32")
        calls = [_batch(seed=s) for s in (1, 2)]
        if builder == "chunked":
            calls = [{k: torch.stack([a[k], b[k]]) for k in a}
                     for a, b in zip(calls, [_batch(seed=s) for s in (3, 4)])]
    wrapped = step if wrap is None else wrap(step, state, calls[0])
    losses = [wrapped(state, dict(c))[1]["loss"] for c in calls]
    return losses, state, wrapped


def _captured(step, state, example):
    return aot.CapturedStep(step)


def _aot(step, state, example):
    return aot.build_aot_step(step, state, example)


WRAPS = {"supervised": _captured, "chunked": _captured, "fused": _captured,
         "aot": _aot, "echo": _captured}


def _builder(case):
    return "supervised" if case == "aot" else case


def _expected_seeds(case):
    if case == "echo":
        return [A.fold_seed(BASE, c) for c in (0, 1)]
    updates = 4 if case in ("chunked", "fused") else 2
    return [A.fold_seed(BASE, n) for n in range(updates)]


def _same_run(a, b):
    (la, sa, _), (lb, sb, _) = a, b
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)
    assert sa.step == sb.step
    for p, q in zip(sa.model.parameters(), sb.model.parameters()):
        assert torch.equal(p, q)


@pytest.mark.parametrize("case", list(WRAPS))
def test_a_plain_augment_runs_eagerly_with_each_updates_seed(card, case):
    """Over a plain ``fn``, two calls of the captured wrapper on a card
    state see the eager step's seeds, update by update (draw by draw),
    give its losses and parameters, count ``eager_calls == 2`` and try no
    capture."""
    aug = _plain_batch if case == "echo" else _plain
    eager_seen, seen = [], []
    eager = _run(_builder(case), aug(eager_seen), None)
    got = _run(_builder(case), aug(seen), WRAPS[case])
    assert [s for s, _ in eager_seen] == _expected_seeds(case)
    assert [s for s, _ in seen] == [s for s, _ in eager_seen]
    for (_, x), (_, y) in zip(seen, eager_seen):
        assert torch.equal(x, y)
    _same_run(got, eager)
    wrapper = got[2]
    assert wrapper.eager_calls == 2 and wrapper.graph_replays == 0
    assert card == []


@pytest.mark.parametrize("case", list(WRAPS))
def test_a_seeded_augment_still_captures(card, case):
    """A ``SeededAugment`` (``make_augment``, the echo default) goes
    through the capture as before: one graph per signature, two replays,
    no eager call, and the eager step's losses and parameters."""
    aug = (default_echo_augment(points_key="xy") if case == "echo"
           else A.make_augment(A.color_jitter))
    eager = _run(_builder(case), aug, None)
    got = _run(_builder(case), aug, WRAPS[case])
    _same_run(got, eager)
    wrapper = got[2]
    assert wrapper.eager_calls == 0 and wrapper.graph_replays == 2
    assert len(card) == len(wrapper.signatures) >= 1


def test_a_fresh_batch_through_the_echo_step_still_captures(card):
    """The echo step's fresh batches carry no augmentation: over a plain
    reservoir ``augment`` they are captured and replayed, while its draws
    run eagerly."""
    seen = []
    res = _reservoir(None)
    res.augment = _plain_batch(seen)
    state = _state()
    step = aot.CapturedStep(S.make_echo_fused_step(res.draw, precision="f32"))
    fresh = {**_batch(), "_meta": {"btid": 0}}
    step(state, fresh)
    step(state, res.draw_token(_IDX[0]))
    step(state, fresh)
    assert step.graph_replays == 2 and step.eager_calls == 1
    assert len(card) == 1 and "_echo_idx" not in card[0]
    assert [s for s, _ in seen] == [A.fold_seed(BASE, 0)]


def test_prepare_captures_nothing_for_a_plain_augment(card):
    """``CapturedStep.prepare`` skips a batch whose step is not
    capturable, and captures a seeded one."""
    state = _state()
    plain = aot.CapturedStep(S.make_supervised_step(augment=_plain([])))
    plain.prepare(state, _batch())
    seeded = aot.CapturedStep(S.make_supervised_step(
        augment=A.make_augment(A.color_jitter)))
    seeded.prepare(state, _batch())
    assert plain.signatures == () and len(seeded.signatures) == 1
    assert len(card) == 1 and state.step == 0


def test_the_hooks_answer_by_augment_and_batch():
    """``step.capturable``: False for a plain ``fn`` on every builder,
    True without an augmentation or over a ``SeededAugment``; the echo
    step answers for draws over a plain reservoir only, and a draw
    function that is no reservoir's keeps capturing."""
    state = _state()
    batch = _batch()
    seeded = A.make_augment(A.color_jitter)
    for make in (S.make_supervised_step, S.make_chunked_supervised_step,
                 S.make_fused_tile_step):
        assert make().capturable(state, batch)
        assert make(augment=seeded).capturable(state, batch)
        assert not make(augment=_plain([])).capturable(state, batch)
    res = _reservoir(_plain_batch([]))
    token = res.draw_token(_IDX[0])
    echo = S.make_echo_fused_step(res.draw)
    assert not echo.capturable(state, token)
    assert echo.capturable(state, batch)
    res.augment = default_echo_augment()
    assert echo.capturable(state, token)
    foreign = S.make_echo_fused_step(lambda buffers, idx, counter: batch)
    assert foreign.capturable(state, token)
    assert res.host_seeded is False and _reservoir(_plain_batch([])).host_seeded


def test_the_mesh_steps_inherit_the_hook(monkeypatch):
    """The mesh step builders return the inner builders' steps, hook
    included: a plain ``fn`` (a draw over a plain reservoir) is not
    capturable there either. The mesh's own checks are stubbed: the hook
    reads the augmentation alone."""
    from blendjax_torch.parallel import sharding as SH
    from blendjax_torch.train import mesh_driver as MD

    monkeypatch.setattr(MD, "_check_axis", lambda mesh, axis: None)
    monkeypatch.setattr(MD, "_state_shardings", lambda *a: None)
    monkeypatch.setattr(SH, "batch_sharding", lambda mesh, axis: None)
    state, batch = _state(), _batch()
    for make in (MD.make_mesh_supervised_step, MD.make_mesh_fused_step):
        assert not make(state, None, augment=_plain([])).capturable(state,
                                                                     batch)
        assert make(state, None, augment=A.make_augment(
            A.color_jitter)).capturable(state, batch)
    res = _reservoir(_plain_batch([]))
    token = res.draw_token(_IDX[0])
    res.sharding = object()  # as a ring sharded over the batch axes
    echo = MD.make_mesh_echo_fused_step(state, None, res)
    assert not echo.capturable(state, token) and echo.capturable(state, batch)


def test_a_plain_augment_augments_each_update_as_the_jax_step(card):
    """The same numpy batch through two updates of the JAX package's
    jitted step and of the port's captured wrapper, each over a
    key-dependent shift: the JAX package augments the two updates
    differently, and so does the port, each update as its eager step
    does."""
    import jax
    import jax.numpy as jnp

    from blendjax.models import CubeRegressor as JaxCube
    from blendjax.train import make_supervised_step as jax_supervised_step
    from blendjax.train import make_train_state as jax_state

    batch = {k: v.numpy() for k, v in _batch().items()}
    jax_seen = []

    def jfn(key, images):
        shift = jax.random.randint(key, (), 1, 64).astype(images.dtype)
        out = images + shift
        jax.debug.callback(lambda x: jax_seen.append(np.asarray(x)), out)
        return out

    jm = JaxCube(features=FEATURES, dtype=jnp.float32)
    jstate = jax_state(jm, jnp.zeros((1, *SHAPE), jnp.uint8))
    jstep = jax_supervised_step(augment=jfn, augment_rng=jax.random.key(BASE))
    for _ in range(2):
        jstate, metrics = jstep(jstate, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
        jax.block_until_ready(metrics["loss"])
    jax.effects_barrier()
    assert len(jax_seen) == 2
    assert not np.array_equal(jax_seen[0], jax_seen[1])

    def two_updates(step, state):
        return [step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
                for _ in range(2)]

    eager_seen, seen = [], []
    two_updates(S.make_supervised_step(augment=_plain(eager_seen)), _state())
    wrapper = aot.CapturedStep(S.make_supervised_step(augment=_plain(seen)))
    two_updates(wrapper, _state())
    assert len(seen) == len(eager_seen) == 2
    assert not torch.equal(seen[0][1], seen[1][1])
    for (_, x), (_, y) in zip(seen, eager_seen):
        assert torch.equal(x, y)
    assert wrapper.eager_calls == 2 and card == []
