"""Captured mesh steps on a CUDA card: an NCCL group of world size 1.

- Split states: a StreamFormer on ``{"data": 1, "fsdp": 1}``, ``{"data":
  1, "tp": 1}`` and (with experts) ``{"data": 1, "expert": 1}``, built by
  ``MeshTrainDriver.build`` with and without ``aot=True`` from one seed:
  one graph replay per step call, the losses and this rank's shards
  bit-equal to the eager build's (cuDNN deterministic), and the graph
  holding an all-gather on the fsdp layout.
- Sequence parallelism: the same StreamFormer on ``{"data": 1, "seq": 1}``
  with Ulysses and with ring attention, captured and eager: bit-equal
  losses and parameters, the collectives equal by kind and axis (the
  Ulysses graph holding its all-to-alls), and the flash kernels' launches
  and Ulysses' flash calls equal, counted through the replays.
- Sharded draws: the DQN learner step and the echo fused step over a ring
  sharded on ``{"data": 1}`` (the device-side gather and its all-reduce
  over one rank), eager and through ``CapturedStep(step, mesh=mesh)``:
  one replay per step call, no eager call, the losses, the parameters
  (the DQN target and priorities too) bit-equal, and the collectives
  equal by kind and axis.

Every test here is ``cuda``-marked and skips without a card. The file
imports no JAX, so it runs on a machine without it:
``python -m pytest --noconftest -m cuda tests/test_torch_mesh_aot_card.py``.
"""

import numpy as np
import pytest
import torch

FORMER = dict(patch=8, dim=64, depth=2, num_heads=2, num_outputs=16)
LAYOUTS = {"fsdp": ({"data": 1, "fsdp": 1}, {}),
           "tp": ({"data": 1, "tp": 1}, {}),
           "expert": ({"data": 1, "expert": 1}, {"num_experts": 4}),
           "ulysses": ({"data": 1, "seq": 1},
                       {"use_ring": True, "sp_mode": "ulysses"}),
           "ring": ({"data": 1, "seq": 1},
                    {"use_ring": True, "sp_mode": "ring"})}
SPLIT = ("fsdp", "tp", "expert")
SEQ = ("ulysses", "ring")
STEPS = 4


@pytest.fixture(scope="module")
def nccl_group(tmp_path_factory):
    """An NCCL process group of world size 1 on the card (closed after
    the module), cuDNN deterministic for the module's runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the GPU machine)")
    import torch.distributed as dist

    from blendjax_torch.parallel.mesh import init_group

    opened = init_group("cuda", store_dir=str(tmp_path_factory.mktemp("pg")))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield str(dist.get_backend())
    torch.backends.cudnn.deterministic = deterministic
    if opened:
        dist.destroy_process_group()


def _loss(model, batch):
    from blendjax_torch.train import corner_loss

    return corner_loss(model(batch["image"]).reshape(-1, 8, 2), batch["xy"],
                       image_shape=tuple(batch["image"].shape[1:3]))


def _batches(n=STEPS, batch=8, hw=32, seed=5):
    rng = np.random.default_rng(seed)
    return [{"image": torch.from_numpy(rng.integers(
                 0, 255, (batch, hw, hw, 4), np.uint8)).cuda(),
             "xy": torch.from_numpy((rng.random((batch, 8, 2)) * hw)
                                    .astype(np.float32)).cuda()}
            for _ in range(n)]


def _run(axes, extra, aot):
    from blendjax_torch.kernels import reset_launch_counts
    from blendjax_torch.models import StreamFormer
    from blendjax_torch.parallel import create_mesh, ulysses
    from blendjax_torch.parallel.collectives import (
        collective_counts,
        tally_diff,
    )
    from blendjax_torch.train import MeshTrainDriver

    mesh = create_mesh(axes, devices="cuda")
    if "sp_mode" in extra:
        extra = {**extra, "mesh": mesh}
    model = StreamFormer(**FORMER, **extra, attn_backend="flash",
                         image_shape=(32, 32)).init_params(0)
    batches = _batches()
    drv = MeshTrainDriver.build(model, mesh, loss_fn=_loss, aot=aot,
                                aot_batch=batches[0] if aot else None,
                                sync_every=1, inflight=1)
    reset_launch_counts()
    ulysses.reset_counts()
    before = collective_counts()  # an eager call's, or what replays add
    for b in batches:
        drv.submit(b)
    drv.finish()
    torch.cuda.synchronize()
    return drv, tally_diff(collective_counts(), before)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", SPLIT)
def test_captured_split_step_is_bit_equal_to_the_eager_step(nccl_group,
                                                            layout):
    assert nccl_group == "nccl"
    axes, extra = LAYOUTS[layout]
    eager, eager_tally = _run(axes, extra, aot=False)
    graph, graph_tally = _run(axes, extra, aot=True)
    step = graph.step
    assert graph.state.shards is not None
    assert step.graph_replays == STEPS and step.aot_fallbacks == 0
    np.testing.assert_array_equal(np.asarray(graph.losses),
                                  np.asarray(eager.losses))
    for a, b in zip(eager.state.shards.shards, graph.state.shards.shards):
        assert torch.equal(a, b)
    assert graph_tally["per_kind"] == eager_tally["per_kind"]
    assert graph_tally["per_axis"] == eager_tally["per_axis"]
    if layout == "fsdp":
        assert any(g.collectives["per_kind"]["all-gather"] > 0
                   for g in step._graphs.values() if g is not None)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", SEQ)
def test_captured_sequence_parallel_step_is_bit_equal_to_the_eager_step(
        nccl_group, mode):
    """``{"data": 1, "seq": 1}``, Ulysses or ring: one replay per step
    call, losses and parameters bit-equal, the collectives equal by kind
    and axis (all-to-alls inside the Ulysses graph), and the flash
    kernels' launches and Ulysses' flash calls counted through the
    replays equal to the eager run's."""
    from blendjax_torch.kernels import launch_counts
    from blendjax_torch.parallel import ulysses

    assert nccl_group == "nccl"
    axes, extra = LAYOUTS[mode]
    eager, eager_tally = _run(axes, extra, aot=False)
    eager_k, eager_u = launch_counts(), ulysses.flash_calls
    graph, graph_tally = _run(axes, extra, aot=True)
    graph_k, graph_u = launch_counts(), ulysses.flash_calls
    step = graph.step
    assert step.graph_replays == STEPS and step.aot_fallbacks == 0
    np.testing.assert_array_equal(np.asarray(graph.losses),
                                  np.asarray(eager.losses))
    for a, b in zip(eager.state.model.parameters(),
                    graph.state.model.parameters()):
        assert torch.equal(a, b)
    assert graph_tally["per_kind"] == eager_tally["per_kind"]
    assert graph_tally["per_axis"] == eager_tally["per_axis"]
    assert graph_tally["per_axis"].get("seq", 0) > 0
    assert graph_k == eager_k and graph_u == eager_u
    flash = [graph_k[k] for k in ("flash_attention_fwd",
                                  "flash_attention_bwd_dkv",
                                  "flash_attention_bwd_dq")]
    if mode == "ulysses":
        assert graph_tally["per_kind"]["all-to-all"] > 0
        assert any(g.collectives["per_kind"]["all-to-all"] > 0
                   for g in step._graphs.values() if g is not None)
        assert flash == [FORMER["depth"] * STEPS] * 3 == [graph_u] * 3
    else:
        assert flash == [0, 0, 0] and graph_u == 0


def _rl_rows(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return {"obs": rng.normal(size=(n, 4)).astype(np.float32),
            "action": rng.integers(0, 3, n).astype(np.int32),
            "reward": rng.normal(size=n).astype(np.float32),
            "done": rng.random(n) < 0.1,
            "next_obs": rng.normal(size=(n, 4)).astype(np.float32)}


def _dqn_run(captured):
    from blendjax_torch.models import QNetwork
    from blendjax_torch.parallel import create_mesh
    from blendjax_torch.parallel.collectives import (
        collective_counts,
        tally_diff,
    )
    from blendjax_torch.rl import (
        TrajectoryReservoir,
        make_dqn_step,
        make_rl_train_state,
        mesh_rl_step_kwargs,
    )
    from blendjax_torch.train import CapturedStep

    mesh = create_mesh({"data": 1}, devices="cuda")
    res = TrajectoryReservoir(128, rng=2, prioritized=True, mesh=mesh)
    res.insert(_rl_rows())
    state = make_rl_train_state(QNetwork(hidden=(32, 32), n_actions=3)
                                .init_params(1), mesh=mesh)
    step = make_dqn_step(res, gamma=0.98, **mesh_rl_step_kwargs(state, mesh))
    if captured:
        step = CapturedStep(step, mesh=mesh)
    before, losses = collective_counts(), []
    for _ in range(STEPS):
        token = res.draw_token(*res.compose(16))
        losses.append(step(state, token)[1]["loss"])
    torch.cuda.synchronize()
    return (step, state, res, torch.stack(losses),
            tally_diff(collective_counts(), before))


def _echo_run(captured):
    from blendjax_torch.data import SampleReservoir
    from blendjax_torch.data.echo import default_echo_augment
    from blendjax_torch.models import CubeRegressor
    from blendjax_torch.parallel import create_mesh, ring_sharding
    from blendjax_torch.parallel.collectives import (
        collective_counts,
        tally_diff,
    )
    from blendjax_torch.train import (
        CapturedStep,
        make_mesh_echo_fused_step,
        make_train_state,
    )

    mesh = create_mesh({"data": 1}, devices="cuda")
    res = SampleReservoir(32, augment=default_echo_augment(points_key="xy"),
                          rng=3, sharding=ring_sharding(mesh))
    for b in _batches(n=4, seed=7):
        res.insert(b)
    state = make_train_state(CubeRegressor(features=(8, 16)).init_params(0),
                             mesh=mesh)
    step = make_mesh_echo_fused_step(state, mesh, res)
    if captured:
        step = CapturedStep(step, mesh=mesh)
    rng = np.random.default_rng(9)
    before, losses = collective_counts(), []
    for _ in range(STEPS):
        token = res.draw_token(rng.integers(0, res.size, 8))
        losses.append(step(state, token)[1]["loss"])
    torch.cuda.synchronize()
    return (step, state, res, torch.stack(losses),
            tally_diff(collective_counts(), before))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dqn", "echo"])
def test_captured_step_over_a_sharded_ring_is_bit_equal_to_the_eager_step(
        nccl_group, kind):
    """The DQN learner step and the echo fused step over a ring sharded on
    ``{"data": 1}``: the captured run one replay per step call and no
    eager call, its losses and parameters (the DQN target and priorities
    too) bit-equal to the eager run's, the collectives equal by kind and
    axis, the gather's all-reduce inside the graph."""
    assert nccl_group == "nccl"
    run = _dqn_run if kind == "dqn" else _echo_run
    _s, eager_state, eager_res, eager_losses, eager_tally = run(False)
    step, state, res, losses, tally = run(True)
    assert step.graph_replays == STEPS and step.eager_calls == 0
    assert torch.equal(losses, eager_losses)
    for a, b in zip(eager_state.model.parameters(),
                    state.model.parameters()):
        assert torch.equal(a, b)
    if kind == "dqn":
        for a, b in zip(eager_state.target.parameters(),
                        state.target.parameters()):
            assert torch.equal(a, b)
        assert torch.equal(eager_res._priorities, res._priorities)
    assert tally["per_kind"] == eager_tally["per_kind"]
    assert tally["per_axis"] == eager_tally["per_axis"]
    assert tally["per_kind"]["all-reduce"] > 0
    assert all(g.collectives["per_kind"]["all-reduce"] > 0
               for g in step._graphs.values())
