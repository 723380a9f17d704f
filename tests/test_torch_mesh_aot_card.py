"""Captured steps on split states on a CUDA card: an NCCL group of world
size 1, a StreamFormer on ``{"data": 1, "fsdp": 1}``, ``{"data": 1, "tp":
1}`` and (with experts) ``{"data": 1, "expert": 1}``, built by
``MeshTrainDriver.build`` with and without ``aot=True`` from one seed:
one graph replay per step call, the losses and this rank's shards
bit-equal to the eager build's (cuDNN deterministic), and the graph
holding an all-gather on the fsdp layout.

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
           "expert": ({"data": 1, "expert": 1}, {"num_experts": 4})}
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
    from blendjax_torch.models import StreamFormer
    from blendjax_torch.parallel import create_mesh
    from blendjax_torch.parallel.collectives import (
        collective_counts,
        tally_diff,
    )
    from blendjax_torch.train import MeshTrainDriver

    mesh = create_mesh(axes, devices="cuda")
    model = StreamFormer(**FORMER, **extra, attn_backend="flash",
                         image_shape=(32, 32)).init_params(0)
    batches = _batches()
    drv = MeshTrainDriver.build(model, mesh, loss_fn=_loss, aot=aot,
                                aot_batch=batches[0] if aot else None,
                                sync_every=1, inflight=1)
    before = collective_counts()  # an eager call's, or what replays add
    for b in batches:
        drv.submit(b)
    drv.finish()
    torch.cuda.synchronize()
    return drv, tally_diff(collective_counts(), before)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", list(LAYOUTS))
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
