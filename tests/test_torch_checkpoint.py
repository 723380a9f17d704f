"""Checkpoints of blendjax_torch against the JAX package on the CPU.

- The session codec: the port's msgpack bytes equal the JAX package's for
  the same document, and each package decodes the other's (ndarrays,
  128-bit PCG64 words, nested dicts); pickle-needing values and reserved
  keys are refused.
- The snapshot manager: round trip, retention (``keep``), the sweep of
  ``.tmp-`` stages, an empty directory restoring ``None``, and the pending
  snapshot replaced under backpressure.
- Across frameworks: a CubeRegressor train state written by the JAX
  package's ``SnapshotManager`` is restored by the port and one AdamW
  update on each side agrees; a port snapshot is read by the JAX
  package's ``SnapshotManager.restore`` and one update agrees again. The
  restored leaves are equal exactly (the same bytes under the same
  names); after the update, losses rtol 1e-5 and parameters and moments
  rtol 1e-4 / atol 1e-6 (float32 on both sides, TF32 off).
- The driver: ``checkpoint_every`` keeps one step call per step, the
  session carries the driver's counters, and ``build(resume=True)`` and an
  in-place restore write into the existing tensors.
"""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blendjax.checkpoint import SnapshotManager as JSnapshotManager
from blendjax.checkpoint import format as jfmt
from blendjax.models import CubeRegressor as JaxCube
from blendjax.train import make_supervised_step as jax_supervised_step
from blendjax.train import make_train_state as jax_state
from blendjax_torch.checkpoint import (
    SnapshotManager,
    collect_session,
    committed_steps,
    pack_session,
    restore_session,
    unpack_session,
)
from blendjax_torch.models import CubeRegressor
from blendjax_torch.train import CheckpointManager, TrainDriver
from blendjax_torch.train import steps as S
from blendjax_torch.weights import (
    from_flax,
    load_train_state_leaves,
    train_state_leaves,
)

FEATURES = (8, 16)
SHAPE = (32, 48, 4)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _bounded(fn, timeout=60.0):
    """Run ``fn`` (a wait on the snapshot writer) on a thread and fail the
    test, instead of hanging it, when it has not returned in ``timeout``."""
    t = threading.Thread(target=fn, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"{fn} did not return in {timeout} s"


def _batch(seed, b=4):
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 256, (b, *SHAPE), dtype=np.uint8),
            "xy": rng.uniform(0, 48, (b, 8, 2)).astype(np.float32)}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _jax_pair(seed=0):
    jm = JaxCube(features=FEATURES, dtype=jnp.float32)
    jst = jax_state(jm, jnp.zeros((1, *SHAPE), jnp.uint8),
                    rng=jax.random.key(seed))
    tm = CubeRegressor(features=FEATURES, dtype=torch.float32)
    tm.load_state_dict(from_flax(jax.tree.map(np.asarray, jst.params)))
    return jst, S.make_train_state(tm, device="cpu")


def _jax_leaves(jst) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(jst)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _port_leaves(state) -> dict:
    return {k: (v.detach().contiguous().numpy()
                if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in train_state_leaves(state).items()}


def _close_leaves(port, jax_side, rtol=1e-4, atol=1e-6):
    assert sorted(port) == sorted(jax_side)
    for k, v in port.items():
        np.testing.assert_allclose(v, jax_side[k], rtol=rtol, atol=atol,
                                   err_msg=k)


# -- the session codec --------------------------------------------------------------


def _document():
    rng = np.random.default_rng(3)
    rng.random(5)
    return {
        "_version": 1,
        "echo": {
            "use": np.arange(6, dtype=np.int64),
            "filled": np.array([True, False, True]),
            "age_s": np.linspace(0, 1, 4),
            "rng": rng.bit_generator.state,
            "steps": 12, "fresh": np.int64(9), "ratio": np.float32(0.5),
            "none": None, "name": "x", "raw": b"\x00\x01",
        },
        "driver": {"steps": 3, "losses": [0.5, 0.25]},
    }


def test_the_session_codec_matches_the_jax_package():
    """The same document packs to the same bytes in both packages, each
    package decodes the other's, and the PCG64 state (128-bit words)
    restores a generator that continues bitwise."""
    doc = _document()
    raw = pack_session(doc)
    assert raw == jfmt.pack_session(doc)
    for back in (unpack_session(raw), jfmt.unpack_session(raw)):
        np.testing.assert_array_equal(back["echo"]["use"], doc["echo"]["use"])
        assert back["echo"]["use"].flags.writeable
        assert back["echo"]["rng"] == doc["echo"]["rng"]
        assert back["driver"] == doc["driver"]
        g = np.random.default_rng()
        g.bit_generator.state = back["echo"]["rng"]
        h = np.random.default_rng(3)
        h.random(5)
        np.testing.assert_array_equal(g.random(4), h.random(4))
    t = {"buf": torch.arange(6, dtype=torch.int32).reshape(2, 3)}
    np.testing.assert_array_equal(
        jfmt.unpack_session(pack_session(t))["buf"],
        t["buf"].numpy())


@pytest.mark.parametrize("bad,err", [
    ({"x": object()}, TypeError), ({"x": {"__nd__": 1}}, ValueError),
    ({"x": np.array([object()])}, TypeError), ({(1, 2): 1}, TypeError),
])
def test_the_session_codec_refuses_what_needs_pickle(bad, err):
    with pytest.raises(err):
        pack_session(bad)


def test_collect_and_restore_session():
    class Comp:
        def __init__(self):
            self.d = None

        def state_dict(self):
            return {"n": 4}

        def load_state_dict(self, d):
            self.d = d

    s = collect_session(a=Comp(), b={"k": 1}, c=None)
    assert s["a"] == {"n": 4} and s["b"] == {"k": 1} and "c" not in s
    comp = Comp()
    assert restore_session(s, a=comp, z=None) == ["a"] and comp.d == {"n": 4}
    with pytest.raises(ValueError, match="no state"):
        restore_session(s, strict=True, missing=Comp())
    with pytest.raises(ValueError, match="version"):
        restore_session({"_version": 99})


# -- the snapshot manager ------------------------------------------------------------


def test_snapshot_round_trip_retention_and_sweep(tmp_path):
    """Arrays, tensors and scalars come back equal; keep=2 retains the two
    newest steps; a .tmp- stage left by a killed writer is swept at start
    and never counts as committed; an empty directory restores None."""
    d = str(tmp_path / "ck")
    assert SnapshotManager(str(tmp_path / "empty")).restore() is None
    mgr = SnapshotManager(d, keep=2)
    for step in (1, 2, 3):
        state = {".w": torch.full((2, 3), float(step)),
                 ".n": np.arange(step, dtype=np.int32), ".s": step}
        mgr.save(step, state, session={"k": step})
    assert mgr.steps() == [2, 3] == committed_steps(d)
    r = mgr.restore()
    assert r.step == 3 and r.session == {"k": 3} and not r.resharded
    np.testing.assert_array_equal(r.state[".w"], np.full((2, 3), 3.0,
                                                         np.float32))
    assert r.state[".s"] == 3
    assert mgr.restore(step=2).state[".n"].tolist() == [0, 1]
    with pytest.raises(ValueError, match="does not cover"):
        mgr.restore({".missing": None})
    mgr.close()
    os.makedirs(os.path.join(d, ".tmp-00000004-1"))
    os.makedirs(os.path.join(d, "step-00000005"))  # no manifest: not one
    assert committed_steps(d) == [2, 3]
    SnapshotManager(d)
    assert not os.path.exists(os.path.join(d, ".tmp-00000004-1"))
    # the JAX package reads the port's directory as its own
    assert JSnapshotManager(d).latest_step() == 3


def test_snapshot_backpressure_replaces_the_pending_one(tmp_path,
                                                        monkeypatch):
    """With the writer held inside a write, a second and a third save
    replace each other in the one pending slot (skipped == 1), and only
    the newest lands; the clones were taken at enqueue, so later in-place
    updates of the live tensors do not reach the files."""
    from blendjax_torch.checkpoint import format as fmt

    mgr = SnapshotManager(str(tmp_path), keep=5)
    gate, entered = threading.Event(), threading.Event()
    real = fmt.write_state

    def slow(directory, state):
        entered.set()
        assert gate.wait(timeout=30)
        return real(directory, state)

    monkeypatch.setattr(fmt, "write_state", slow)
    live = torch.zeros(4)
    mgr.save_async(1, {".w": live})
    assert entered.wait(timeout=30)
    live += 2
    mgr.save_async(2, {".w": live})
    live += 1
    mgr.save_async(3, {".w": live})
    live += 100  # after the enqueue: never written
    assert mgr.skipped == 1
    gate.set()
    _bounded(mgr.wait)
    assert mgr.steps() == [1, 3] and mgr.last_error is None
    assert mgr.restore(step=1).state[".w"].tolist() == [0.0] * 4
    assert mgr.restore(step=3).state[".w"].tolist() == [3.0] * 4
    assert len(mgr.save_ms) == 2 and mgr.bytes > 0
    mgr.close()


# -- across frameworks ---------------------------------------------------------------


def test_the_leaf_paths_are_the_jax_train_states():
    """train_state_leaves names exactly the leaves the JAX package's
    snapshot writes for the flax TrainState of the same model, with the
    same shapes and dtypes; before any update the values equal."""
    jst, state = _jax_pair()
    port, want = _port_leaves(state), _jax_leaves(jst)
    assert list(port) == list(want)
    for k in want:
        assert port[k].shape == want[k].shape, k
        np.testing.assert_array_equal(port[k], want[k], err_msg=k)
    assert port[".opt_state[0].count"].dtype == np.int32


def test_a_jax_snapshot_restores_into_the_port(tmp_path):
    """The JAX package trains 2 updates and snapshots; the port restores
    the snapshot into a fresh state (different init) and both take one
    more update on the same batch."""
    jst, _ = _jax_pair(seed=0)
    jstep = jax_supervised_step(precision="f32", donate=False)
    for i in range(2):
        jst, _ = jstep(jst, _j(_batch(10 + i)))
    with JSnapshotManager(str(tmp_path)) as jm:
        jm.save(2, jst, session={"driver": {"steps": 2}})
    _, state = _jax_pair(seed=5)
    r = SnapshotManager(str(tmp_path)).restore(train_state_leaves(state))
    assert r.step == 2 and r.session["driver"] == {"steps": 2}
    load_train_state_leaves(state, r.state)
    assert state.step == 2
    _close_leaves(_port_leaves(state), _jax_leaves(jst), rtol=0, atol=0)
    batch = _batch(20)
    jst, jm_ = jstep(jst, _j(batch))
    _, m = S.make_supervised_step(precision="f32")(state, _t(batch))
    assert float(m["loss"]) == pytest.approx(float(jm_["loss"]), rel=1e-5)
    _close_leaves(_port_leaves(state), _jax_leaves(jst))


def test_a_port_snapshot_restores_into_the_jax_package(tmp_path):
    """The port trains 2 updates through a driver with checkpoint_every=2;
    the JAX package's SnapshotManager.restore reads the snapshot onto a
    fresh flax state, and one more update agrees on both sides."""
    jst, state = _jax_pair(seed=0)
    mgr = SnapshotManager(str(tmp_path))
    drv = TrainDriver(S.make_supervised_step(precision="f32"), state,
                      checkpoint=mgr, checkpoint_every=2, sync_every=1)
    for i in range(2):
        drv.submit(_t(_batch(10 + i)))
    _bounded(mgr.wait)
    assert drv.dispatches == drv.steps == 2 and drv.checkpoints == 1
    fresh, _ = _jax_pair(seed=7)
    r = JSnapshotManager(str(tmp_path)).restore(fresh)
    assert r.step == 2 and r.session["driver"]["steps"] == 2
    assert int(r.state.step) == 2
    _close_leaves(_port_leaves(state), _jax_leaves(r.state), rtol=0, atol=0)
    jstep = jax_supervised_step(precision="f32", donate=False)
    batch = _batch(20)
    jst2, jm_ = jstep(r.state, _j(batch))
    _, m = S.make_supervised_step(precision="f32")(state, _t(batch))
    assert float(m["loss"]) == pytest.approx(float(jm_["loss"]), rel=1e-5)
    _close_leaves(_port_leaves(state), _jax_leaves(jst2))
    mgr.close()


def test_restore_writes_into_the_existing_tensors(tmp_path):
    """CheckpointManager (the port's stand-in for the orbax wrapper) saves
    a state after 3 updates; restoring into a state that has already
    stepped keeps every parameter's and moment's storage (a captured
    graph replays on those addresses), writes the one count into every
    parameter's step, and the two states then train identically."""
    _, a = _jax_pair(seed=0)
    step = S.make_supervised_step(precision="f32")
    for i in range(3):
        step(a, _t(_batch(i)))
    cm = CheckpointManager(str(tmp_path))
    assert cm.restore(a) is None or cm.latest_step() is None
    cm.save(3, a)
    assert cm.latest_step() == 3
    _, b = _jax_pair(seed=9)
    step(b, _t(_batch(7)))
    ptrs = [p.data_ptr() for p in b.model.parameters()]
    moments = [(b.optimizer.state[p]["exp_avg"].data_ptr(),
                b.optimizer.state[p]["exp_avg_sq"].data_ptr(),
                b.optimizer.state[p]["step"].data_ptr())
               for p in b.model.parameters()]
    assert cm.restore(b) is b
    assert [p.data_ptr() for p in b.model.parameters()] == ptrs
    assert [(b.optimizer.state[p]["exp_avg"].data_ptr(),
             b.optimizer.state[p]["exp_avg_sq"].data_ptr(),
             b.optimizer.state[p]["step"].data_ptr())
            for p in b.model.parameters()] == moments
    assert b.step == 3
    assert all(float(b.optimizer.state[p]["step"]) == 3.0
               for p in b.model.parameters())
    for x, y in ((a, b),):
        la, lb = step(x, _t(_batch(30)))[1], step(y, _t(_batch(30)))[1]
        assert torch.equal(la["loss"], lb["loss"])
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(pa, pb)
    cm.close()


def test_a_fresh_optimizer_restores_as_adamw_would_make_it(tmp_path):
    """Restoring into a state whose AdamW has not stepped creates its
    entries (moments and a step per parameter) and then trains exactly
    as the saved state does."""
    _, a = _jax_pair(seed=0)
    step = S.make_supervised_step(precision="f32")
    for i in range(2):
        step(a, _t(_batch(i)))
    mgr = SnapshotManager(str(tmp_path))
    mgr.save(2, train_state_leaves(a))
    _, b = _jax_pair(seed=4)
    assert not b.optimizer.state
    load_train_state_leaves(b, mgr.restore(train_state_leaves(b)).state)
    la = step(a, _t(_batch(9)))[1]["loss"]
    lb = step(b, _t(_batch(9)))[1]["loss"]
    assert torch.equal(la, lb)
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(pa, pb)


def test_build_resume_restores_before_capture_and_loads_the_counters(
        tmp_path):
    """TrainDriver.build(resume=True, checkpoint=mgr) restores the newest
    snapshot into the new state before the step set is built, loads the
    driver's counters and leaves the session on resumed_session; it then
    continues the uninterrupted run's losses exactly (the CPU runs every
    step eagerly)."""
    example = _t(_batch(0))
    mgr = SnapshotManager(str(tmp_path))
    a = TrainDriver.build(CubeRegressor(features=FEATURES,
                                        dtype=torch.float32),
                          example, rng=3, device="cpu", precision="f32",
                          checkpoint=mgr, checkpoint_every=3, sync_every=1,
                          session_state=lambda: {"extra": {"k": 1}})
    for i in range(6):
        a.submit(_t(_batch(40 + i)))
    a.drain()
    _bounded(mgr.wait)
    assert mgr.steps() == [3, 6] and a.dispatches == a.steps == 6
    # B resumes at step 3 from A's snapshot of step 3
    b_mgr = SnapshotManager(str(tmp_path / "b"))
    r = mgr.restore(step=3)
    b_mgr.save(3, r.state, session=r.session)
    b = TrainDriver.build(CubeRegressor(features=FEATURES,
                                        dtype=torch.float32),
                          example, rng=11, device="cpu", precision="f32",
                          resume=True, checkpoint=b_mgr, sync_every=1)
    assert b.steps == 3 and b.state.step == 3
    assert b.resumed_session["extra"] == {"k": 1}
    assert b.losses == a.losses[:3]
    for i in range(3, 6):
        b.submit(_t(_batch(40 + i)))
    b.drain()
    assert b.losses[:6] == a.losses[:6]
    for pa, pb in zip(a.state.model.parameters(), b.state.model.parameters()):
        assert torch.equal(pa, pb)
    mgr.close()
    b_mgr.close()


def test_other_models_snapshot_under_their_own_names(tmp_path):
    """A model without a flax mapping (StreamFormer) snapshots under its
    own parameter names, untransposed: the port restores it in place and
    trains on exactly as the saved state does."""
    from blendjax_torch.models import StreamFormer
    from blendjax_torch.train import corner_loss

    def loss(model, batch):
        return corner_loss(model(batch["image"]).reshape(-1, 8, 2),
                           batch["xy"], image_shape=(32, 64))

    def state(seed):
        m = StreamFormer(patch=8, dim=32, depth=1, num_heads=4,
                         num_outputs=16, dtype=torch.float32,
                         attn_backend="xla", image_shape=(32, 64))
        return S.make_train_state(m.init_params(seed), device="cpu")

    rng = np.random.default_rng(2)
    batches = [{"image": torch.from_numpy(rng.integers(0, 256, (2, 32, 64, 4),
                                                       dtype=np.uint8)),
                "xy": torch.from_numpy(rng.uniform(0, 32, (2, 8, 2))
                                       .astype(np.float32))}
               for _ in range(3)]
    step = S.make_supervised_step(loss_fn=loss, precision="f32")
    a = state(0)
    for b in batches[:2]:
        step(a, b)
    leaves = train_state_leaves(a)
    assert ".params['pos_embed']" in leaves
    mgr = SnapshotManager(str(tmp_path))
    mgr.save(2, leaves)
    b_ = state(5)
    load_train_state_leaves(b_, mgr.restore(train_state_leaves(b_)).state)
    la = step(a, batches[2])[1]["loss"]
    lb = step(b_, batches[2])[1]["loss"]
    assert torch.equal(la, lb) and b_.step == 3
    for p, q in zip(a.model.parameters(), b_.model.parameters()):
        assert torch.equal(p, q)
    mgr.close()


# -- the session of a mesh's ranks ----------------------------------------------


class _Agreement:
    """What ``gather_session`` reads of a ``StepAgreement``: this rank, the
    ranks, and a gather that hands back every rank's object."""

    def __init__(self, rank, sessions):
        self.rank, self.ranks, self.sessions = rank, [0, 1], sessions

    def gather_objects(self, obj):
        # this rank's object as it crosses; the others' as given
        return [obj if r == self.rank else s
                for r, s in enumerate(self.sessions)]


def test_a_mesh_session_keeps_rank_0s_components_where_one_card_does():
    """Rank 0 gets every rank's session, its own at the top and the
    others' under ``mesh`` (without the shared driver slice); the others
    get ``None``. Each rank takes its slice back, a rank the snapshot did
    not have keeps the shared slices alone, and both packages'
    ``restore_session(strict=False)`` pass the extra key by."""
    from blendjax.checkpoint import restore_session as jax_restore
    from blendjax.obs.lineage import FrameLineage as JaxLineage
    from blendjax_torch.checkpoint import (
        MESH_KEY,
        gather_session,
        rank_session,
        restore_session,
    )
    from blendjax_torch.obs.lineage import FrameLineage

    lineages = []
    for r in range(2):
        lin = FrameLineage()
        lin.register(f"p{r}")
        lineages.append(lin)
    sessions = [collect_session(lineage=lin) for lin in lineages]
    for s in sessions:
        s["driver"] = {"steps": 7}
        s["echo"] = {"ring": np.arange(4), "fill": 3}
    sessions[0]["echo"]["ring"] = torch.arange(4)
    assert gather_session(sessions[1], _Agreement(1, sessions)) is None
    merged = gather_session(sessions[0], _Agreement(0, sessions))
    assert merged[MESH_KEY]["world_size"] == 2
    (other,) = merged[MESH_KEY]["ranks"]
    assert "driver" not in other and set(other) == {"lineage", "echo"}
    assert isinstance(merged["echo"]["ring"], np.ndarray)  # host copies
    raw = unpack_session(pack_session(merged))  # pickle-free
    zero, world = rank_session(raw, 0)
    assert world == 2 and MESH_KEY not in zero
    one, _ = rank_session(raw, 1)
    assert one["driver"] == {"steps": 7}
    assert one["lineage"] == lineages[1].state_dict()
    assert set(rank_session(raw, 2)[0]) == {"driver", "_version",
                                            "_wall_time"}
    assert restore_session(raw, lineage=FrameLineage()) == ["lineage"]
    assert jax_restore(raw, lineage=JaxLineage()) == ["lineage"]
    # a one-card session is rank 0's slice of itself
    assert rank_session(sessions[0], 0) == (sessions[0], 1)


def test_a_read_only_manager_restores_and_never_writes(tmp_path):
    """A mesh rank other than 0 restores through a read-only manager, which
    leaves the writer's interrupted stages alone and refuses to save."""
    d = str(tmp_path / "ck")
    with SnapshotManager(d) as mgr:
        mgr.save(3, {"w": np.arange(4, dtype=np.float32)})
    stage = os.path.join(d, ".tmp-00000006-1")
    os.makedirs(stage)
    ro = SnapshotManager(d, read_only=True)
    assert os.path.isdir(stage)
    assert ro.restore().step == 3
    with pytest.raises(RuntimeError, match="read-only"):
        ro.save_async(6, {"w": np.zeros(4, np.float32)})

