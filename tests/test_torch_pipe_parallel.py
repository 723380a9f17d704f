"""Pipeline and expert parallelism of the port against the JAX package's
(CPU): ``blendjax_torch.parallel.pipeline_apply`` at worlds 2 and 4 over
gloo against ``blendjax.parallel.pipeline_apply`` on the virtual CPU
devices and against the stages applied one after another, and a MoE
StreamFormer on ``data`` and ``data x expert`` meshes against the JAX
package's meshes of the same axes.

The rank bodies are ``torch_dist_ranks.py``'s (no JAX import: ``spawn``
re-imports it); one module fixture starts both worlds at once. Bars: the
JAX pipeline tests' (forward rtol/atol 2e-5, gradients rtol 2e-4 / atol
2e-5) against the JAX package; ``F32_EXACT_ATOL`` against the port's own
sequential application; ``CROSS_LAYOUT_ATOL`` for the expert layout
(``tests/test_mesh_driver.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_ranks as W
from blendjax.data import StreamDataPipeline as JaxPipeline
from blendjax.models import StreamFormer as JaxFormer
from blendjax.parallel import create_mesh as jax_create_mesh
from blendjax.parallel import pipeline_apply as jax_pipeline_apply
from blendjax.parallel import stack_stage_params as jax_stack
from blendjax.train import MeshTrainDriver as JaxMeshDriver
from blendjax_torch.testing.equivalence import TOL_GRAD, TOL_LOSS

F32_EXACT_ATOL = 5e-6
CROSS_LAYOUT_ATOL = 5e-5


def _jax_stage(params, x):
    return jax.nn.gelu(x @ params["w"] + params["b"])


@functools.lru_cache(maxsize=None)
def _jax_pipeline(axes: tuple, n_stages: int):
    """The JAX package's pipeline on ``axes`` ((name, size) pairs): outputs
    and the gradients of mean(y^2) over the whole batch."""
    mesh = jax_create_mesh(dict(axes), devices=jax.devices()[
        :int(np.prod([s for _, s in axes]))])
    stages, x = W.pipe_inputs(n_stages)
    stacked = jax_stack([{k: jnp.asarray(v) for k, v in s.items()}
                         for s in stages])

    def loss(p, x):
        y = jax_pipeline_apply(_jax_stage, p, x, mesh)
        return jnp.mean(y ** 2), y

    # one compiled program for the output and both gradients
    (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(stacked, jnp.asarray(x))
    return {"y": np.asarray(y), "dx": np.asarray(gx),
            "dw": np.asarray(gp["w"]), "db": np.asarray(gp["b"])}


@functools.lru_cache(maxsize=None)
def _former_params(overflow: bool = False):
    """Seeded MoE StreamFormer parameters; ``overflow`` biases block 0's
    router towards expert 0, so that most tokens queue for it and overflow
    its capacity (cf 1.25: 40 of the 128 tokens of a global batch, 20 of a
    rank's 64)."""
    jm = JaxFormer(**W.FORMER_MOE, dtype=jnp.float32, attn_backend="xla")
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.zeros((1, 32, 32, 4), jnp.uint8)))
    rng = np.random.default_rng(0)

    def fill(path, s):
        if jax.tree_util.keystr(path).endswith("['scale']"):
            return np.ones(s.shape, np.float32)  # LayerNorm: the identity
        if len(s.shape) == 1:
            return (rng.normal(size=s.shape) * 0.1).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes["params"])
    if overflow:
        params["block0"]["MoEMLP_0"]["router"]["bias"] = np.array(
            [4.0, 0.0, 0.0, 0.0], np.float32)
    return params


def _jax_loss(state, p, batch):
    from blendjax.train import corner_loss

    pred = state.apply_fn({"params": p}, batch["image"])
    return corner_loss(pred.reshape(-1, 8, 2), batch["xy"],
                       image_shape=batch["image"].shape[1:3])


@functools.lru_cache(maxsize=None)
def _jax_expert_losses(axes: tuple = (("data", 2), ("expert", 2)),
                       overflow: bool = False):
    mesh = jax_create_mesh(dict(axes), devices=jax.devices()[
        :int(np.prod([s for _, s in axes]))])
    drv = JaxMeshDriver.build(
        JaxFormer(**W.FORMER_MOE, dtype=jnp.float32, attn_backend="xla"),
        mesh, np.zeros((8, 32, 32, 4), np.uint8), loss_fn=_jax_loss,
        sync_every=1, inflight=1)
    params = jax.tree.map(lambda a, v: jax.device_put(jnp.asarray(v),
                                                      a.sharding),
                          drv.state.params, _former_params(overflow))
    drv.state = drv.state.replace(params=params,
                                  opt_state=drv.state.tx.init(params))
    specs = [str(v.sharding.spec) for v in
             jax.tree_util.tree_leaves(drv.state.params)]
    with JaxPipeline(iter(W.former_messages()), batch_size=8,
                     mesh=mesh) as pipe:
        for sb in pipe:
            drv.submit(sb)
    drv.finish()
    return np.asarray(drv.losses), specs


# the overflow cases: (world, case, mesh axes)
OVERFLOW = [
    (2, "expert:data2overflow", (("data", 2),)),
    (4, "expert:data2xexpert2overflow", (("data", 2), ("expert", 2))),
]


@functools.lru_cache(maxsize=None)
def _jax_first_aux(overflow: bool):
    """The JAX package's aux loss on the first recorded batch (all its
    rows) and block 0's router-kernel gradient of it."""
    from blendjax.models.moe import apply_with_aux as jax_apply_with_aux

    jm = JaxFormer(**W.FORMER_MOE, dtype=jnp.float32, attn_backend="xla")
    images = jnp.asarray(W.former_messages()[0]["image"])

    def aux(p):
        return jax_apply_with_aux(jm, {"params": p}, images,
                                  aux_weight=1.0)[1]

    params = jax.tree.map(jnp.asarray, _former_params(overflow))
    value, grads = jax.jit(jax.value_and_grad(aux))(params)
    return float(value), np.asarray(grads["block0"]["MoEMLP_0"]["router"]
                                    ["kernel"])


def _cases(world):
    overflow = [(case, {"params_np": _former_params(True),
                        "axes": dict(axes)})
                for w, case, axes in OVERFLOW if w == world]
    if world == 2:
        return [
            ("pipeline:pipe2", {"axes": {"pipe": 2}, "n_stages": 2}),
            ("pipeline:degenerate", {"axes": {"data": 2}, "n_stages": 3}),
            ("pipeline_mismatch", {"axes": {"pipe": 2}, "n_stages": 4}),
            ("pipeline_blocks", {"axes": {"pipe": 2}}),
        ] + overflow
    return [
        ("pipeline:pipe4", {"axes": {"pipe": 4}, "n_stages": 4}),
        ("pipeline:pipe2xdata2", {"axes": {"pipe": 2, "data": 2},
                                  "n_stages": 2}),
        ("expert", {"params_np": _former_params(),
                    "axes": {"data": 2, "expert": 2}}),
    ] + overflow


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both worlds' ranks, while this process computes the JAX package's
    side (the ranks are other processes)."""
    import threading

    cases = {w: _cases(w) for w in (2, 4)}
    out: dict = {}

    def run():
        try:
            out["ranks"] = W.run_worlds(
                cases, str(tmp_path_factory.mktemp("ranks")))
        except BaseException as e:  # raised below, in the test
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    _jax_pipeline((("pipe", 2),), 2)
    _jax_pipeline((("pipe", 4),), 4)
    _jax_pipeline((("pipe", 2), ("data", 2)), 2)
    _jax_expert_losses()
    for _w, _case, axes in OVERFLOW:
        _jax_expert_losses(axes, overflow=True)
    _jax_first_aux(True)
    t.join(200.0)
    assert not t.is_alive(), "the ranks did not finish"
    if "error" in out:
        raise out["error"]
    return out["ranks"]


def _result(ranks, world, name):
    per_rank = [r[name] for r in ranks[world]]
    for r in per_rank:
        if isinstance(r, dict) and "error" in r:
            pytest.fail(r["error"])
    return per_rank


# -- pipeline parallelism -------------------------------------------------------------


@pytest.mark.parametrize("world,case,axes", [
    (2, "pipeline:pipe2", (("pipe", 2),)),
    (4, "pipeline:pipe4", (("pipe", 4),)),
])
def test_pipeline_matches_the_jax_pipeline_and_sequential(ranks, world, case,
                                                          axes):
    """Every rank's replicated output, the input gradient and the stacked
    parameters' gradients (summed over the pipe axis) against the JAX
    package's pipeline and against the port's stages in sequence."""
    want = _jax_pipeline(axes, world)
    for per in _result(ranks, world, case):
        pipe, seq = per["pipe"], per["sequential"]
        np.testing.assert_allclose(pipe["y"], want["y"], rtol=2e-5, atol=2e-5)
        for k in ("dx", "dw", "db"):
            np.testing.assert_allclose(pipe[k], want[k], rtol=2e-4,
                                       atol=2e-5, err_msg=k)
        for k in ("y", "dx", "dw", "db"):
            np.testing.assert_allclose(pipe[k], seq[k], rtol=0,
                                       atol=F32_EXACT_ATOL, err_msg=k)


def test_pipeline_composes_with_a_data_axis(ranks):
    """pipe x data: each rank passes its rows of the microbatch dim, the
    pipeline runs over its pipe group, and the rows put together are the
    JAX package's pipe x data result (the loss a mean over all rows)."""
    want = _jax_pipeline((("pipe", 2), ("data", 2)), 2)
    per = _result(ranks, 4, "pipeline:pipe2xdata2")
    by_rows = {}
    for r in per:
        di, nd = r["where"]
        by_rows.setdefault(di, r["pipe"])
        np.testing.assert_allclose(r["pipe"]["y"], by_rows[di]["y"],
                                   rtol=0, atol=0)
    y = np.concatenate([by_rows[d]["y"] for d in range(2)], axis=1)
    np.testing.assert_allclose(y, want["y"], rtol=2e-5, atol=2e-5)
    # each rank's loss is its rows' mean: the global mean's gradient is the
    # mean over the data ranks
    dx = np.concatenate([by_rows[d]["dx"] for d in range(2)], axis=1) / 2
    np.testing.assert_allclose(dx, want["dx"], rtol=2e-4, atol=2e-5)
    for k in ("dw", "db"):
        g = (by_rows[0][k] + by_rows[1][k]) / 2
        np.testing.assert_allclose(g, want[k], rtol=2e-4, atol=2e-5,
                                   err_msg=k)


def test_pipeline_without_a_pipe_axis_runs_the_stages_in_sequence(ranks):
    """A mesh without the axis applies the 3 stages one after another on
    each rank, as the reference's degenerate path does."""
    stages, x = W.pipe_inputs(3)
    want = x
    for s in stages:
        want = np.asarray(_jax_stage({k: jnp.asarray(v) for k, v in
                                      s.items()}, jnp.asarray(want)))
    for per in _result(ranks, 2, "pipeline:degenerate"):
        di, nd = per["where"]  # a data axis: this rank's rows
        rows = want.shape[1] // nd
        for name in ("pipe", "sequential"):
            np.testing.assert_allclose(per[name]["y"],
                                       want[:, di * rows:(di + 1) * rows],
                                       rtol=2e-5, atol=2e-5)


def test_a_stage_count_other_than_the_axis_size_raises(ranks):
    for msg in _result(ranks, 2, "pipeline_mismatch"):
        assert msg is not None and "leading dim 4" in msg and "2 stages" in msg


def test_streamformer_blocks_pipeline_through_functional_call(ranks):
    """The documented recipe: one StreamFormer Block per stage through
    ``torch.func.functional_call`` over the stacked block parameters; the
    output, the input gradient and each block's own gradient (through
    ``torch.stack``) against the blocks in sequence."""
    for per in _result(ranks, 2, "pipeline_blocks"):
        assert per["dy"] <= F32_EXACT_ATOL
        assert per["dx"] <= F32_EXACT_ATOL
        assert per["dparams"] <= F32_EXACT_ATOL


# -- expert parallelism ----------------------------------------------------------------


def test_expert_layout_trains_the_jax_data_expert_losses(ranks):
    """A MoE StreamFormer on data2 x expert2: ``expert_*`` sharded over
    ``expert`` (each rank holds 2 of the 4 experts between steps), losses
    of the JAX package's {"data": 2, "expert": 2} mesh within the
    cross-layout bar, and ``aot=True`` refused."""
    want, jax_specs = _jax_expert_losses()
    assert any("expert" in s for s in jax_specs)
    for per in _result(ranks, 4, "expert"):
        np.testing.assert_allclose(per["losses"], want, rtol=0,
                                   atol=CROSS_LAYOUT_ATOL)
        assert per["losses"].shape == want.shape == (4,)
        assert any("expert" in s for s in per["specs"]), per["specs"]
        assert per["expert_local"] and all(
            shape[0] == 2 for shape in per["expert_local"])
        assert per["layout"] == "data×expert"
        assert per["refused"] is not None and "expert" in per["refused"]


@pytest.mark.parametrize("world,case,axes", OVERFLOW,
                         ids=["data2", "data2xexpert2"])
def test_expert_routing_is_the_global_batchs_when_tokens_overflow(
        ranks, world, case, axes):
    """Most tokens routed to one expert, past its capacity: the mesh step
    routes the global batch (global capacity, queue positions counting the
    ranks before), so its losses are the JAX package's, whose GSPMD jit
    routes the global batch; each rank routing its own tokens alone would
    keep other tokens, and its first loss falls outside the bar (by more
    than twice it)."""
    want, _specs = _jax_expert_losses(axes, overflow=True)
    for per in _result(ranks, world, case):
        np.testing.assert_allclose(per["losses"], want, rtol=0,
                                   atol=CROSS_LAYOUT_ATOL)
        assert abs(per["local_first_loss"] - want[0]) > 2 * CROSS_LAYOUT_ATOL


@pytest.mark.parametrize("world,case,axes", OVERFLOW,
                         ids=["data2", "data2xexpert2"])
def test_expert_aux_loss_is_the_global_batchs(ranks, world, case, axes):
    """``apply_with_aux`` on a mesh: the load-balancing loss of the global
    batch, and its router gradient averaged over the ranks (as the mesh
    step averages gradients) the JAX package's on the whole batch, within
    the f32 bars of ``blendjax_torch.testing.equivalence`` (``TOL_LOSS``
    1e-5 / ``TOL_GRAD`` 1e-4, the JAX package's)."""
    want, want_grad = _jax_first_aux(True)
    for per in _result(ranks, world, case):
        assert abs(per["aux"] - want) <= TOL_LOSS
        np.testing.assert_allclose(per["aux_router_grad"], want_grad,
                                   rtol=0, atol=TOL_GRAD)
