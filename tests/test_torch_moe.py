"""Mixture of experts and remat: blendjax_torch.models.MoEMLP and the MoE /
remat StreamFormer against the JAX package's flax modules (CPU, f32).

The same numpy inputs, made from seeds, go to both sides; flax weights go
across through ``blendjax_torch.weights``. Bars: the JAX package's
equivalence contract (``blendjax/testing/equivalence.py``), ``tol_loss``
1e-5 on outputs, losses and the aux loss, ``tol_grad`` 1e-4 on gradients
(relative); routing decisions identical where the top two router
probabilities differ by at least ``MARGIN``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blendjax.models import MoEMLP as JaxMoE
from blendjax.models import StreamFormer as JaxFormer
from blendjax.models import apply_with_aux as jax_apply_with_aux
from blendjax_torch.models import MoEMLP, StreamFormer, apply_with_aux
from blendjax_torch.weights import (
    flax_params,
    load_train_state_leaves,
    streamformer_from_flax,
    train_state_leaves,
)

TOL_LOSS = 1e-5
TOL_GRAD = 1e-4
MARGIN = 1e-3
B, T, C, E = 2, 16, 32, 4
SMALL = dict(patch=8, dim=32, depth=2, num_heads=4, num_outputs=16)
SHAPE = (32, 64, 4)


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


def _moe_pair(x, capacity_factor=1.25, seed=0, mlp_ratio=4):
    """A flax MoEMLP (f32) and the port's with the same weights."""
    jm = JaxMoE(num_experts=E, mlp_ratio=mlp_ratio,
                capacity_factor=capacity_factor, dtype=jnp.float32)
    variables = jm.init(jax.random.key(seed), x)
    p = jax.tree.map(np.asarray, variables["params"])
    tm = MoEMLP(x.shape[-1], E, mlp_ratio=mlp_ratio,
                capacity_factor=capacity_factor, dtype=torch.float32)
    sd = {"router.weight": torch.from_numpy(p["router"]["kernel"].T.copy()),
          "router.bias": torch.from_numpy(p["router"]["bias"].copy())}
    for k in ("expert_wi", "expert_bi", "expert_wo", "expert_bo"):
        sd[k] = torch.from_numpy(p[k].copy())
    tm.load_state_dict(sd)
    return jm, variables, tm


def _x(seed=0, shape=(B, T, C)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _margined_tokens(n, seed=3, capacity_factor=1.25):
    """``n`` tokens whose top two router probabilities (under the seed-0
    flax router) differ by at least MARGIN: routing there cannot flip on
    last-bit differences."""
    probe = _x(seed, (1, 8 * n, C))
    jm, variables, _ = _moe_pair(probe, capacity_factor)
    k = np.asarray(variables["params"]["router"]["kernel"])
    b = np.asarray(variables["params"]["router"]["bias"])
    logits = probe[0] @ k + b
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    top2 = np.sort(p, axis=-1)[:, -2:]
    ok = np.flatnonzero(top2[:, 1] - top2[:, 0] >= MARGIN)
    assert len(ok) >= n
    return probe[0][ok[:n]].reshape(B, n // B, C)


def _jax_routing(variables, x, capacity_factor):
    """The reference's routing from the flax router's own logits
    (``capture_intermediates``): expert per token and the kept mask."""
    jm = JaxMoE(num_experts=E, capacity_factor=capacity_factor,
                dtype=jnp.float32)
    _, state = jm.apply(variables, x, capture_intermediates=True,
                        mutable=["intermediates"])
    logits = np.asarray(state["intermediates"]["router"]["__call__"][0])
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    idx = np.argmax(probs, axis=-1)
    onehot = np.eye(E, dtype=np.float32)[idx]
    pos = np.cumsum(onehot, axis=0) * onehot - 1.0
    n = x.shape[0] * x.shape[1]
    cap = max(1, int(capacity_factor * n / E))
    keep = ((pos >= 0) & (pos < cap)).any(axis=-1)
    return idx, keep


# -- MoEMLP -----------------------------------------------------------------------


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5, float(E)],
                         ids=["default", "overflow", "ample"])
def test_moe_output_aux_and_grads_match_flax(capacity_factor):
    """Output, aux loss and the gradient of every leaf of mean(out^2) +
    aux against the JAX module, at the default capacity, one that drops
    tokens and one that keeps them all."""
    x = _x(1)
    jm, variables, tm = _moe_pair(x, capacity_factor)

    def jloss(p):
        out, aux = jax_apply_with_aux(jm, {"params": p}, x, aux_weight=1.0)
        return jnp.mean(out ** 2) + aux, (out, aux)

    (jl, (jout, jaux)), jg = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(variables["params"])
    out, aux = apply_with_aux(tm, torch.from_numpy(x), aux_weight=1.0)
    loss = (out ** 2).mean() + aux
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=TOL_LOSS, atol=TOL_LOSS)
    assert aux.item() == pytest.approx(float(jaux), rel=TOL_LOSS)
    assert float(tm.aux_loss) == pytest.approx(float(jaux), rel=TOL_LOSS)
    assert loss.item() == pytest.approx(float(jl), rel=TOL_LOSS)
    g = jax.tree.map(np.asarray, jg)
    pairs = [(tm.router.weight.grad.T, g["router"]["kernel"]),
             (tm.router.bias.grad, g["router"]["bias"])]
    pairs += [(getattr(tm, k).grad, g[k]) for k in
              ("expert_wi", "expert_bi", "expert_wo", "expert_bo")]
    for got, want in pairs:
        scale = max(float(np.abs(want).max()), 1e-6)
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL_GRAD,
                                   atol=TOL_GRAD * scale)
    kept = _jax_routing(variables, x, capacity_factor)[1]
    if capacity_factor == 0.5:
        assert not kept.all()  # tokens overflow their experts
    if capacity_factor == float(E):
        assert kept.all()


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_routing_is_identical_on_margined_inputs(capacity_factor):
    """On tokens whose top two router probabilities differ by MARGIN, the
    port routes each token to the reference's expert and keeps or drops
    it as the reference does."""
    x = _margined_tokens(32)
    _jm, variables, tm = _moe_pair(x, capacity_factor)
    want_idx, want_keep = _jax_routing(variables, x, capacity_factor)
    _p, idx, _g, dispatch, _oh = tm.route(torch.from_numpy(x.reshape(-1, C)))
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(
        dispatch.sum(dim=(1, 2)).numpy() > 0, want_keep)


def test_ample_capacity_is_per_token_gated_expert_mlp():
    """With capacity for every token, each output row is its gate times its
    expert's MLP of that token alone (dispatch and combine are pure
    routing)."""
    x = _x(2)
    _jm, _v, tm = _moe_pair(x, capacity_factor=float(E))
    toks = torch.from_numpy(x.reshape(-1, C))
    probs, idx, gate, _d, _oh = tm.route(toks)
    want = []
    for n in range(toks.shape[0]):
        e = int(idx[n])
        h = torch.nn.functional.gelu(toks[n] @ tm.expert_wi[e]
                                     + tm.expert_bi[e], approximate="tanh")
        want.append(gate[n] * (h @ tm.expert_wo[e] + tm.expert_bo[e]))
    got = tm(torch.from_numpy(x)).reshape(-1, C)
    torch.testing.assert_close(got, torch.stack(want), rtol=1e-5, atol=1e-5)


def test_apply_with_aux_changes_the_router_gradient():
    """The aux term reaches the router's gradient (balancing pressure); a
    plain call leaves only the buffer value, which carries no gradient."""
    x = torch.from_numpy(_x(4))
    _jm, _v, tm = _moe_pair(_x(4))
    out, aux = apply_with_aux(tm, x)
    assert aux.item() > 0.0
    ((out ** 2).mean() + aux).backward()
    g_aux = tm.router.weight.grad.clone()
    tm.zero_grad()
    (tm(x) ** 2).mean().backward()
    assert not torch.allclose(g_aux, tm.router.weight.grad)
    assert not tm.aux_loss.requires_grad and tm._aux is None


# -- the MoE StreamFormer -----------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _former_params(num_experts=2, seed=0):
    """MoE StreamFormer weights from numpy through the flax tree's shapes
    (``jax.eval_shape``: flax's eager init of this model costs seconds)."""
    jm = JaxFormer(**SMALL, num_experts=num_experts, dtype=jnp.float32,
                   attn_backend="xla")
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.zeros((1, *SHAPE), jnp.uint8)))
    rng = np.random.default_rng(seed)

    def fill(s):
        if len(s.shape) == 1:
            return (rng.normal(size=s.shape) * 0.02).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree.map(fill, shapes)


def _former_pair(num_experts=2, seed=0):
    jm = JaxFormer(**SMALL, num_experts=num_experts, dtype=jnp.float32,
                   attn_backend="xla")
    params = jax.tree.map(jnp.asarray, _former_params(num_experts, seed))
    tm = StreamFormer(**SMALL, num_experts=num_experts, dtype=torch.float32,
                      attn_backend="flash", image_shape=SHAPE[:2])
    tm.load_state_dict(streamformer_from_flax(
        jax.tree.map(np.asarray, params["params"])))
    return jm, params, tm


def test_moe_streamformer_forward_and_names_match_flax():
    jm, params, tm = _former_pair()
    imgs = np.random.default_rng(5).integers(0, 256, (3, *SHAPE), np.uint8)
    want = np.asarray(jax.jit(jm.apply)(params, imgs))
    got = tm(torch.from_numpy(imgs)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=TOL_LOSS, atol=TOL_LOSS)
    flat = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    assert [path for path, _p, _l in flax_params(tm)] == [
        jax.tree_util.keystr(k) for k, _ in flat]
    assert hasattr(tm.blocks[0], "moe") and not hasattr(tm.blocks[1], "moe")


def test_moe_streamformer_fused_step_losses_match_jax():
    """Two calls of each package's fused step on one recorded chunk group
    (2 updates each): the four f32 losses agree to TOL_GRAD; neither side
    adds the aux loss (flax's sow is a no-op in the supervised steps)."""
    from test_torch_model import _recorded_superbatch

    from blendjax import ops as JOPS
    from blendjax.train import make_fused_tile_step as jax_fused
    from blendjax.train import make_train_state as jax_state
    from blendjax_torch.ops import tiles as T
    from blendjax_torch.train import make_fused_tile_step, make_train_state

    ref, packed, spec, geom = _recorded_superbatch(SHAPE)
    jm, params, tm = _former_pair()
    jst = jax_state(jm, jnp.zeros((1, *SHAPE), jnp.uint8))
    jst = jst.replace(params=params["params"],
                      opt_state=jst.tx.init(params["params"]))
    jstep = jax_fused(jloss, precision="f32", donate=False)
    jbatch = {"_packed": jnp.asarray(packed),
              "_refs": {"image": JOPS.tiles.tile_ref(ref, (16, 32))},
              "_spec": spec, "_names": ("image",), "_geoms": (geom,),
              "_rle": ()}
    state = make_train_state(tm, device="cpu")
    step = make_fused_tile_step(tloss)
    tbatch = {"_packed": torch.from_numpy(packed),
              "_refs": {"image": T.tile_ref(torch.from_numpy(ref), (16, 32))},
              "_spec": spec, "_names": ("image",), "_geoms": (geom,),
              "_rle": ()}
    want, got = [], []
    for _ in range(2):
        jst, jm_ = jstep(jst, jbatch)
        want.extend(np.asarray(jm_["loss"]).tolist())
        state, m = step(state, tbatch)
        got.extend(m["loss"].tolist())
    assert len(got) == 4 and state.step == 4
    np.testing.assert_allclose(got, want, rtol=TOL_GRAD)
    assert got[-1] < got[0]


def jloss(state, p, batch):
    """The bench's StreamFormer loss, JAX side."""
    from blendjax.train import corner_loss

    pred = state.apply_fn({"params": p}, batch["image"])
    return corner_loss(pred.reshape(-1, 8, 2), batch["xy"],
                       image_shape=batch["image"].shape[1:3])


def tloss(model, batch):
    """The bench's StreamFormer loss, the port's."""
    from blendjax_torch.train import corner_loss

    return corner_loss(model(batch["image"]).reshape(-1, 8, 2), batch["xy"],
                       image_shape=tuple(batch["image"].shape[1:3]))


def _jax_leaves(jst) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(jst)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _port_leaves(state) -> dict:
    return {k: (v.detach().contiguous().numpy()
                if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in train_state_leaves(state).items()}


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_a_moe_snapshot_restores_across_the_packages(tmp_path, direction):
    """A MoE StreamFormer train state after one update, written by one
    package's SnapshotManager and restored by the other's: every leaf
    (the MoE router and expert weights, their Adam moments) bit-equal."""
    from blendjax.checkpoint import SnapshotManager as JSnapshotManager
    from blendjax.train import make_supervised_step as jax_supervised
    from blendjax.train import make_train_state as jax_state
    from blendjax_torch.checkpoint import SnapshotManager
    from blendjax_torch.train import make_supervised_step, make_train_state

    jm, params, tm = _former_pair()
    rng = np.random.default_rng(9)
    batch = {"image": rng.integers(0, 256, (2, *SHAPE), np.uint8),
             "xy": rng.uniform(0, 32, (2, 8, 2)).astype(np.float32)}
    jst = jax_state(jm, jnp.zeros((1, *SHAPE), jnp.uint8))
    jst = jst.replace(params=params["params"],
                      opt_state=jst.tx.init(params["params"]))
    state = make_train_state(tm, device="cpu")
    if direction == "jax_to_port":
        jst, _ = jax_supervised(loss_fn=jloss, precision="f32",
                                donate=False)(
            jst, {k: jnp.asarray(v) for k, v in batch.items()})
        with JSnapshotManager(str(tmp_path)) as mgr:
            mgr.save(1, jst)
        r = SnapshotManager(str(tmp_path)).restore(train_state_leaves(state))
        load_train_state_leaves(state, r.state)
        got, want = _port_leaves(state), _jax_leaves(jst)
    else:
        make_supervised_step(tloss, precision="f32")(
            state, {k: torch.from_numpy(v) for k, v in batch.items()})
        mgr = SnapshotManager(str(tmp_path))
        mgr.save(1, train_state_leaves(state))
        mgr.wait()
        mgr.close()
        r = JSnapshotManager(str(tmp_path)).restore(jst)
        got, want = _port_leaves(state), _jax_leaves(r.state)
    assert sorted(got) == sorted(want)
    assert any("MoEMLP_0']['expert_wi" in k for k in got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -- remat ------------------------------------------------------------------------


@pytest.mark.parametrize("num_experts", [0, 2], ids=["dense", "moe"])
def test_remat_gradients_equal_the_plain_blocks(num_experts):
    """remat=True recomputes each block in the backward pass: the loss and
    every gradient equal remat=False's, under the same parameter names
    (the counterpart of the JAX package's remat test)."""
    imgs = torch.from_numpy(np.random.default_rng(0).integers(
        0, 255, (2, *SHAPE), np.uint8))
    kw = dict(SMALL, dtype=torch.float32, attn_backend="flash",
              image_shape=SHAPE[:2], num_experts=num_experts)
    base = StreamFormer(**kw).init_params(0)
    rmt = StreamFormer(remat=True, **kw)
    assert ([n for n, _ in rmt.named_parameters()]
            == [n for n, _ in base.named_parameters()])
    rmt.load_state_dict(base.state_dict())
    losses = []
    for model in (base, rmt):
        loss = (model(imgs) ** 2).mean()
        loss.backward()
        losses.append(loss.item())
    assert losses[0] == losses[1]
    for (name, p), q in zip(base.named_parameters(), rmt.parameters()):
        torch.testing.assert_close(q.grad, p.grad, rtol=0, atol=0, msg=name)
