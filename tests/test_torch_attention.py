"""Local attention parity: blendjax_torch.ops.attention and the flash
kernels' plain versions against the JAX package's ``reference_attention``.

Inputs are numpy N(0, 1) draws from a seed, handed to both sides.
Tolerances: f32 forward 1e-5 absolute (sums taken in another order);
bf16 forward 2 bf16 ulps at the output's largest magnitude (the two
sides round the scores' exponentials and the output at different
places); the plain backward against ``jax.grad`` at rtol 1e-5. The
``cuda``-marked tests hold the CUDA kernels against their plain versions
on a card and skip here. JAX is imported inside the helpers that use it,
so the card tests also run where only PyTorch is installed.
"""

import numpy as np
import pytest
import torch

from blendjax_torch.kernels import attention as K
from blendjax_torch.ops import attention as A

SHAPES = [((2, 16, 3, 8), 16), ((2, 8, 3, 8), 24), ((1, 24, 2, 16), 8)]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """At most two torch threads: the suite runs six workers on eight
    cores beside timing-sensitive tests of the JAX package."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _qkv(qshape, tk, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    b, _, h, d = qshape
    q = rng.standard_normal(qshape).astype(np.float32)
    k = rng.standard_normal((b, tk, h, d)).astype(np.float32)
    v = rng.standard_normal((b, tk, h, d)).astype(np.float32)
    return q, k, v


def _jax_attention(q, k, v, causal, bf16=False):
    import jax.numpy as jnp

    from blendjax.parallel.ring import reference_attention

    cast = (lambda a: jnp.asarray(a, jnp.bfloat16)) if bf16 else jnp.asarray
    out = reference_attention(cast(q), cast(k), cast(v), causal=causal)
    return np.asarray(out.astype(jnp.float32))


def _jax_grads(q, k, v, do, causal):
    import jax
    import jax.numpy as jnp

    from blendjax.parallel.ring import reference_attention

    def f(q, k, v):
        return jnp.sum(reference_attention(q, k, v, causal=causal) * do)

    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _bf16_bar(want):
    """2 bf16 ulps (8 significant bits) at the largest output magnitude."""
    top = float(np.abs(want).max())
    return 2 * 2.0 ** (np.floor(np.log2(top)) - 7)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(a).to(dtype)


@pytest.mark.parametrize("backend", ["reference", "xla", "flash", "auto"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("qshape,tk", SHAPES)
def test_forward_matches_jax_reference(backend, dtype, causal, qshape, tk):
    q, k, v = _qkv(qshape, tk)
    bf16 = dtype == "bf16"
    want = _jax_attention(q, k, v, causal, bf16=bf16)
    tdt = torch.bfloat16 if bf16 else torch.float32
    tq, tk_, tv = (_t(a, tdt) for a in (q, k, v))
    if backend == "reference":
        got = A.reference_attention(tq, tk_, tv, causal=causal)
    else:
        got = A.local_attention(tq, tk_, tv, causal=causal, backend=backend)
    assert got.dtype == tdt and tuple(got.shape) == qshape
    got = got.float().numpy()
    if bf16:
        assert np.abs(got - want).max() <= _bf16_bar(want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("qshape,tk", SHAPES)
def test_plain_backward_matches_jax_grad(causal, qshape, tk):
    q, k, v = _qkv(qshape, tk, seed=1)
    do = np.random.default_rng(2).standard_normal(qshape).astype(np.float32)
    want = _jax_grads(q, k, v, do, causal)
    tq, tk_, tv = (_t(a).requires_grad_() for a in (q, k, v))
    K.flash_attention(tq, tk_, tv, causal=causal).backward(_t(do))
    for got, w in zip((tq.grad, tk_.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())


def test_backward_runs_the_written_out_plain_backward(monkeypatch):
    """On CPU tensors the autograd backward calls the two plain backward
    functions, once each, and nothing differentiates the plain forward."""
    calls = []
    for name in ("flash_attention_bwd_dkv_plain", "flash_attention_bwd_dq_plain"):
        real = getattr(K, name)
        monkeypatch.setattr(
            K, name, lambda *a, _n=name, _r=real: calls.append(_n) or _r(*a))
    q, k, v = (_t(a).requires_grad_() for a in _qkv((1, 8, 2, 8), 8))
    out = K.flash_attention(q, k, v)
    assert out.grad_fn.name() == "FlashAttentionBackward"
    out.sum().backward()
    assert sorted(calls) == ["flash_attention_bwd_dkv_plain",
                             "flash_attention_bwd_dq_plain"]


def test_plain_forward_statistics_are_the_log_sum_exp():
    q, k, v = (_t(a) for a in _qkv((2, 12, 2, 8), 20, seed=3))
    for causal in (False, True):
        o, lse = K.flash_attention_fwd_plain(q, k, v, causal=causal)
        s = K._scores(q, k, causal, 8 ** -0.5)
        assert lse.shape == (2, 2, 12) and lse.dtype == torch.float32
        torch.testing.assert_close(lse, torch.logsumexp(s, dim=-1),
                                   rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(o, A.reference_attention(q, k, v, causal),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("wrapper", ["fwd", "bwd_dkv", "bwd_dq"])
def test_cpu_wrappers_are_their_plain_versions(wrapper):
    q, k, v = (_t(a) for a in _qkv((2, 10, 2, 16), 14, seed=4))
    do = _t(np.random.default_rng(5).standard_normal((2, 10, 2, 16))
            .astype(np.float32))
    o, lse = K.flash_attention_fwd_plain(q, k, v)
    di = K.attention_delta(o, do)
    args = (q, k, v) if wrapper == "fwd" else (q, k, v, do, lse, di)
    fn = getattr(K, f"flash_attention_{wrapper}")
    before = fn.launches
    got = fn(*args, causal=True)
    want = getattr(K, f"flash_attention_{wrapper}_plain")(*args, causal=True)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, w)
    assert fn.launches == before  # the plain version is not a launch


def test_unknown_backend_rejected():
    q, k, v = (_t(a) for a in _qkv((1, 8, 2, 8), 8))
    with pytest.raises(ValueError, match="unknown attention backend"):
        A.local_attention(q, k, v, backend="turbo")


class _Fake:
    """Shape, dtype, device, strides and base address of a tensor, for the
    eligibility rules (contiguous at a 256-byte aligned address unless
    told otherwise)."""

    def __init__(self, shape, dtype=torch.bfloat16, device="cuda",
                 strides=None, ptr=1 << 20):
        self.shape = tuple(shape)
        self.ndim = len(shape)
        self.dtype = dtype
        self.device = torch.device(device)
        if strides is None:
            strides = [1] * len(shape)
            for i in range(len(shape) - 2, -1, -1):
                strides[i] = strides[i + 1] * shape[i + 1]
        self._strides = tuple(strides)
        self._ptr = ptr

    def stride(self, dim):
        return self._strides[dim]

    def data_ptr(self):
        return self._ptr


@pytest.mark.parametrize("shape,dtype,device,ok", [
    ((8, 768, 4, 128), torch.bfloat16, "cuda", True),
    ((8, 700, 4, 64), torch.float32, "cuda", True),   # ragged T
    ((2, 1, 2, 8), torch.bfloat16, "cuda", True),
    ((8, 768, 4, 128), torch.bfloat16, "cpu", False),  # plain version instead
    ((8, 768, 4, 128), torch.float16, "cuda", False),
    ((8, 768, 4, 136), torch.bfloat16, "cuda", False),  # head dim > 128
    ((8, 768, 4, 12), torch.bfloat16, "cuda", False),   # not a multiple of 8
    ((8, 768, 128), torch.bfloat16, "cuda", False),
])
def test_flash_supported_is_the_kernels_limits(shape, dtype, device, ok):
    assert A.flash_supported(_Fake(shape, dtype, device)) is ok


# the qkv projection's (B, T, 3, H, D) buffer viewed as q, k, v: element
# strides (T*3*H*D, 3*H*D, D, 1), k and v offset by H*D elements
_QKV = (8 * 768 * 3 * 4 * 128, 3 * 4 * 128, 128, 1)


@pytest.mark.parametrize("shape,dtype,strides,ptr,variant", [
    ((8, 768, 4, 128), torch.bfloat16, None, 1 << 20, "sm90"),
    ((8, 768, 4, 128), torch.bfloat16, _QKV, (1 << 20) + 2 * 512, "sm90"),
    ((8, 768, 4, 64), torch.bfloat16, None, 1 << 20, "sm90"),
    ((8, 700, 4, 128), torch.bfloat16, None, 1 << 20, "sm90"),  # ragged T
    ((8, 768, 4, 128), torch.float32, None, 1 << 20, "simple"),  # parity path
    ((8, 768, 4, 128), torch.float16, None, 1 << 20, "simple"),
    ((8, 768, 4, 32), torch.bfloat16, None, 1 << 20, "simple"),   # head dim
    ((8, 768, 4, 96), torch.bfloat16, None, 1 << 20, "simple"),
    ((8, 768, 4, 120), torch.bfloat16, None, 1 << 20, "simple"),
    ((8, 768, 4, 128), torch.bfloat16, None, (1 << 20) + 2, "simple"),  # base
    ((8, 768, 4, 128), torch.bfloat16, None, (1 << 20) + 8, "simple"),
    # a t stride of 516 elements (1032 bytes) is not a multiple of 16 bytes
    ((8, 768, 4, 128), torch.bfloat16, (768 * 516, 516, 128, 1), 1 << 20,
     "simple"),
    ((8, 768, 4, 128), torch.bfloat16, (768 * 516, 512, 129, 1), 1 << 20,
     "simple"),  # h stride
    ((8, 768, 4, 128), torch.bfloat16, (768 * 1024, 1024, 256, 2), 1 << 20,
     "simple"),  # d stride 2
    ((8, 768, 4, 128), torch.bfloat16, (0, 512, 128, 1), 1 << 20,
     "simple"),  # a broadcast batch
])
def test_fwd_variant_is_a_fixed_rule(shape, dtype, strides, ptr, variant):
    """bf16 q, k, v with head dim 64 or 128 that TMA can address take the
    sm90 forward; f32, other head dims and unaligned views the simple one."""
    t = _Fake(shape, dtype, strides=strides, ptr=ptr)
    assert K.fwd_variant(t, t, t) == variant
    ok = _Fake(shape, torch.bfloat16)
    if variant == "simple" and shape[-1] in K.SM90_HEAD_DIMS:
        # one ineligible tensor of the three is enough
        assert K.fwd_variant(ok, ok, t) == "simple"
        assert K.fwd_variant(t, ok, ok) == "simple"


@pytest.mark.parametrize("scale,variant", [
    (None, "sm90"), (0.5, "sm90"), (0.0, "simple"), (-0.5, "simple"),
    (float("nan"), "simple"),
])
def test_fwd_variant_takes_only_a_positive_scale_to_sm90(scale, variant):
    """The sm90 forward takes the row max before scaling, which holds only
    for a positive scale: any other goes to the simple kernel."""
    t = _Fake((8, 768, 4, 128))
    assert K.fwd_variant(t, t, t, scale) == variant


# (q, k, v) views of one qkv buffer and a contiguous do: the main path's
_DO = (8 * 768 * 4 * 128, 4 * 128, 128, 1)


@pytest.mark.parametrize("qkv_shape,do_strides,dtype,ptr,variant", [
    ((8, 768, 4, 128), _DO, torch.bfloat16, 1 << 20, "sm90"),
    ((8, 768, 4, 64), None, torch.bfloat16, 1 << 20, "sm90"),
    ((8, 700, 4, 128), None, torch.bfloat16, 1 << 20, "sm90"),  # ragged T
    ((8, 768, 4, 128), None, torch.float32, 1 << 20, "simple"),  # parity path
    ((8, 768, 4, 96), None, torch.bfloat16, 1 << 20, "simple"),  # head dim
    ((8, 768, 4, 128), None, torch.bfloat16, (1 << 20) + 2, "simple"),  # base
    # a do whose t stride of 516 elements (1032 bytes) is not a multiple of
    # 16 bytes
    ((8, 768, 4, 128), (768 * 516, 516, 128, 1), torch.bfloat16, 1 << 20,
     "simple"),
])
def test_bwd_variant_is_a_fixed_rule(qkv_shape, do_strides, dtype, ptr,
                                     variant):
    """bf16 q, k, v and do with head dim 64 or 128 that TMA can address take
    the sm90 backward; f32, other head dims and unaligned views the simple
    one. One ineligible tensor of the four is enough."""
    ok = _Fake(qkv_shape, torch.bfloat16)
    strides = _QKV if qkv_shape == (8, 768, 4, 128) and do_strides else None
    qkv = _Fake(qkv_shape, dtype, strides=strides, ptr=ptr)
    if do_strides is None:
        assert K.bwd_variant(qkv, qkv, qkv, qkv) == variant
        if variant == "simple":
            assert K.bwd_variant(ok, ok, qkv, ok) == "simple"
    else:
        do = _Fake(qkv_shape, dtype, strides=do_strides, ptr=ptr)
        assert K.bwd_variant(qkv, qkv, qkv, do) == variant
        assert K.bwd_variant(ok, ok, ok, do) == variant


@pytest.mark.parametrize("scale", [None, 0.5, -0.5, 0.0])
def test_bwd_variant_asks_nothing_of_the_scale(scale):
    """exp(s * scale - lse) holds for any scale: a scale the sm90 forward
    refuses still takes the sm90 backward."""
    t = _Fake((8, 768, 4, 128))
    assert K.bwd_variant(t, t, t, t) == "sm90"
    assert K.fwd_variant(t, t, t, scale) == ("sm90" if scale is None or scale > 0
                                             else "simple")


def test_flash_supported_checks_kv_too():
    q = _Fake((8, 256, 4, 128))
    assert A.flash_supported(q, _Fake((8, 768, 4, 128)))  # Tq != Tkv
    assert not A.flash_supported(q, _Fake((8, 768, 4, 64)))
    assert not A.flash_supported(q, _Fake((8, 768, 4, 128), torch.float32))


def test_explicit_flash_on_an_ineligible_device_tensor_raises(monkeypatch):
    """A non-CPU tensor the kernel cannot take raises ValueError and never
    runs the xla path (meta tensors stand in for a card here)."""
    def no_xla(*a, **kw):
        raise AssertionError("flash request quietly ran xla")

    monkeypatch.setattr(A, "reference_attention", no_xla)
    q = torch.empty((2, 64, 2, 12), device="meta")  # head dim 12
    with pytest.raises(ValueError, match="flash attention backend"):
        A.local_attention(q, q, q, backend="flash")


@pytest.mark.parametrize("shape", [
    (4, 3072, 4, 128),   # the bench longseq shape: under the budget
    (1, 16384, 4, 128),  # the JAX module docstring's example: over it
    (8, 768, 4, 128),    # the StreamFormer slice
])
def test_residual_bytes_and_auto_rule_agree_with_jax(shape):
    """Same bytes and threshold as the JAX package; given tensors each
    kernel takes, auto picks flash exactly where the JAX rule would."""
    from blendjax.ops import attention as JA

    class Q:
        ndim = 4

        def __init__(self):
            self.shape = shape

    assert A.FLASH_RESIDUAL_BYTES == JA.FLASH_RESIDUAL_BYTES
    assert A.scores_residual_bytes(_Fake(shape)) == JA.scores_residual_bytes(Q())
    over = JA.scores_residual_bytes(Q()) > JA.FLASH_RESIDUAL_BYTES
    assert A.auto_picks_flash(_Fake(shape)) is over
    assert A.auto_picks_flash(_Fake(shape, device="cpu")) is False
    if shape == (8, 768, 4, 128):
        assert not over  # why the slice names flash explicitly


def test_auto_on_cpu_resolves_to_xla(monkeypatch):
    def no_flash(*a, **kw):
        raise AssertionError("auto took flash on the CPU")

    monkeypatch.setattr(K, "flash_attention", no_flash)
    q, k, v = (_t(a) for a in _qkv((1, 8, 2, 8), 8))
    A.local_attention(q, k, v, backend="auto")


def test_flash_block_sizes_are_the_kernels_tiles():
    """Each kernel's edges are its variant's: for sm90, 192 q rows (three
    consumer warpgroups of 64) and 64-row k stages forward, and 64
    resident rows over 64-row stages in both backward kernels; for simple,
    64 x 64 forward and dQ, 64 kv rows over 32-row q steps in dK/dV."""
    bs = A.flash_block_sizes(700, 768)
    assert A.FLASH_BLOCK == bs["block_q"] == K.FWD_BLOCKS["sm90"][0] == 192
    assert bs["grid_fwd"] == 4 and bs["grid_dkv"] == 12 and bs["grid_dq"] == 11
    assert (bs["block_k"], bs["block_k_dkv"], bs["block_q_dkv"]) == (64, 64, 64)
    assert (bs["block_q_dq"], bs["block_k_dq"]) == (64, 64)
    simple = A.flash_block_sizes(700, 768, "simple")
    assert (simple["block_q"], simple["block_k"], simple["grid_fwd"]) == (64, 64, 11)
    assert (simple["block_k_dkv"], simple["block_q_dkv"], simple["grid_dkv"]) == (64, 32, 12)
    assert (simple["block_q_dq"], simple["block_k_dq"], simple["grid_dq"]) == (64, 64, 11)
    backward = [key for key in bs if "dkv" in key or "dq" in key]
    assert len(backward) == 6
    assert all(v <= A.FLASH_BLOCK for key in backward
               for v in (bs[key], simple[key]) if key.startswith("block"))


def test_wrappers_reject_mismatched_inputs():
    q, k, v = (_t(a) for a in _qkv((2, 8, 2, 8), 8))
    with pytest.raises(ValueError, match="disagree"):
        K.flash_attention_fwd(q, k[:, :, :1], v)
    with pytest.raises(RuntimeError, match="no attention kernel"):
        K.flash_attention_fwd(*(t.to("meta") for t in (q, k, v)))
    o, lse = K.flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="lse must be"):
        K.flash_attention_bwd_dq(q, k, v, o, lse[:, :1], lse)


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,tq,tk,h,d,dtype,causal", [
    (2, 256, 256, 4, 128, torch.bfloat16, False),
    (2, 256, 256, 4, 128, torch.bfloat16, True),
    (2, 128, 384, 2, 128, torch.bfloat16, True),
    (2, 200, 200, 2, 64, torch.bfloat16, False),
    (2, 130, 70, 2, 32, torch.float32, True),
    # the sm90 forward: a ragged last q block and k tile, more k tiles than
    # pipeline stages, Tq > Tk under the causal mask, one row
    (2, 700, 700, 4, 128, torch.bfloat16, True),
    (1, 200, 1000, 2, 64, torch.bfloat16, False),
    (2, 300, 100, 2, 128, torch.bfloat16, True),
    (1, 1, 65, 1, 128, torch.bfloat16, False),
    (2, 100, 100, 2, 32, torch.bfloat16, False),  # head dim 32: simple
])
def test_kernels_match_plain_versions_on_card(cuda_card, b, tq, tk, h, d,
                                              dtype, causal):
    gen = torch.Generator(device="cuda").manual_seed(0)
    # q, k, v as views of one (B, T, 3, H, D) buffer, as the model makes them
    qkv = torch.randn((b, max(tq, tk), 3, h, d), generator=gen,
                      device=cuda_card).to(dtype)
    q, k, v = qkv[:, :tq, 0], qkv[:, :tk, 1], qkv[:, :tk, 2]
    do = torch.randn((b, tq, h, d), generator=gen, device=cuda_card).to(dtype)
    want_variant = ("sm90" if dtype == torch.bfloat16 and d in K.SM90_HEAD_DIMS
                    else "simple")
    assert K.fwd_variant(q, k, v) == want_variant
    before = dict(K.flash_attention_fwd.launches_by_variant)
    o, lse = K.flash_attention_fwd(q, k, v, causal)
    after = K.flash_attention_fwd.launches_by_variant
    assert after[want_variant] == before[want_variant] + 1
    o_ref, lse_ref = K.flash_attention_fwd_plain(q, k, v, causal)
    fwd_tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert (o.float() - o_ref.float()).abs().max() <= fwd_tol
    assert (lse - lse_ref).abs().max() <= 1e-3
    di = K.attention_delta(o, do)
    assert K.bwd_variant(q, k, v, do) == want_variant
    before = [dict(fn.launches_by_variant) for fn in (
        K.flash_attention_bwd_dkv, K.flash_attention_bwd_dq)]
    got = (*K.flash_attention_bwd_dkv(q, k, v, do, lse, di, causal),
           K.flash_attention_bwd_dq(q, k, v, do, lse, di, causal))
    for fn, was in zip((K.flash_attention_bwd_dkv, K.flash_attention_bwd_dq),
                       before):
        assert fn.launches_by_variant[want_variant] == was[want_variant] + 1
    want = (*K.flash_attention_bwd_dkv_plain(q, k, v, do, lse, di, causal),
            K.flash_attention_bwd_dq_plain(q, k, v, do, lse, di, causal))
    rel = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for g, w in zip(got, want):
        top = w.float().abs().max()
        assert (g.float() - w.float()).abs().max() <= rel * top


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["unaligned base", "negative scale"])
def test_what_sm90_cannot_take_runs_the_simple_forward_on_card(cuda_card,
                                                               case):
    """A bf16 head-dim-128 view whose base is not 16-byte aligned cannot be
    a TMA tensor map, and a negative scale breaks the sm90 kernel's row max
    over the unscaled scores: the simple kernel takes both, with the plain
    version's result. The negative scale spans scores far beyond exp's f32
    range (~88), where a max over unscaled scores would overflow."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    buf = torch.randn((2, 256, 4, 129), generator=gen,
                      device=cuda_card).to(torch.bfloat16)
    if case == "unaligned base":
        q = k = v = buf[..., 1:]
        scale = None
    else:
        q = k = v = buf[..., :128].contiguous()
        scale = -2.0
    assert K.fwd_variant(q, k, v, scale) == "simple"
    before = K.flash_attention_fwd.launches_by_variant["simple"]
    o, lse = K.flash_attention_fwd(q, k, v, True, scale)
    assert K.flash_attention_fwd.launches_by_variant["simple"] == before + 1
    o_ref, lse_ref = K.flash_attention_fwd_plain(q, k, v, True, scale)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    assert (o.float() - o_ref.float()).abs().max() <= 2e-2
    assert (lse - lse_ref).abs().max() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("d,causal", [(128, False), (128, True), (64, True)])
def test_backward_kernels_are_deterministic_on_card(cuda_card, d, causal):
    """Two calls of each sm90 backward kernel on the same inputs give
    bit-identical dk, dv and dq: each output row is summed by one block in
    a fixed order, with no atomics."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    qkv = torch.randn((2, 700, 3, 4, d), generator=gen,
                      device=cuda_card).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = torch.randn((2, 700, 4, d), generator=gen,
                     device=cuda_card).to(torch.bfloat16)
    assert K.bwd_variant(q, k, v, do) == "sm90"
    o, lse = K.flash_attention_fwd(q, k, v, causal)
    di = K.attention_delta(o, do)
    first = (*K.flash_attention_bwd_dkv(q, k, v, do, lse, di, causal),
             K.flash_attention_bwd_dq(q, k, v, do, lse, di, causal))
    second = (*K.flash_attention_bwd_dkv(q, k, v, do, lse, di, causal),
              K.flash_attention_bwd_dq(q, k, v, do, lse, di, causal))
    for a, b in zip(first, second):
        assert torch.equal(a, b)
