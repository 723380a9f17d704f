"""Flash-attention kernels K4a-c: wrappers, plain versions, launch counts
and the autograd function.

``csrc/flash_fwd_sm90.cu`` and ``csrc/flash_attention.cu`` replace the
three Pallas TPU kernels that ``blendjax/ops/attention.py:157`` reaches in
``jax/experimental/pallas/ops/tpu/flash_attention.py`` (JAX 0.9.0):

- :func:`flash_attention_fwd` (K4a, forward ``pallas_call`` at :758):
  ``o`` and the row log-sum-exp ``lse`` (the JAX kernel's ``m`` and ``l``
  in one array). It has two variants, picked by the fixed rule
  :func:`fwd_variant`: ``"sm90"`` (``flash_fwd_sm90.cu``: TMA, ``wgmma``,
  warp specialisation) for bf16 inputs with head dim 64 or 128 that TMA
  can address and a positive scale, ``"simple"`` (``flash_attention.cu``:
  ``mma.sync``) for the rest (f32, other head dims, unaligned views, a
  scale <= 0). The rule is not a
  retry: a failed build or launch of the variant it picks raises;
- :func:`flash_attention_bwd_dkv` (K4b, :1121): ``dk`` and ``dv``;
- :func:`flash_attention_bwd_dq` (K4c, :1456): ``dq``. Both backward
  kernels have two variants, picked by the fixed rule :func:`bwd_variant`:
  ``"sm90"`` (``flash_bwd_sm90.cu``, on the forward's design) for bf16
  inputs with head dim 64 or 128 that TMA can address, whatever the scale,
  ``"simple"`` (``flash_attention.cu``) for the rest. As for the forward, a
  failed build or launch of the variant the rule picks raises.

Tensors keep the JAX layout: ``q`` (B, Tq, H, D), ``k``/``v`` (B, Tk, H, D),
read through their strides (a unit stride over D); ``lse`` and ``di`` are
(B, H, Tq) f32. ``di = rowsum(o * do)`` is plain torch (:func:`attention_delta`),
as the JAX library computes it outside its kernels (``flash_attention.py:274``).

Each wrapper launches its kernel for CUDA tensors and adds one to its
``launches`` count (its ``work(q, k, causal)`` declares the launch's FLOPs
and bytes, :func:`blendjax_torch.kernels.work.attention_work`); for CPU tensors it returns its plain PyTorch version
(``*_plain``), which repeats the kernel's arithmetic: operands in the
input dtype with products summed in f32 (a product of two bf16 values is
exact in f32, so the plain version upcasts), the softmax in f32, and
``p``/``ds`` cast to the input dtype before the second products. Any
other device raises; there is no fallback from a failed build or launch.
"""

from __future__ import annotations

import ctypes

import torch

from blendjax_torch.kernels.build import entry, load
from blendjax_torch.kernels.counting import count_launch
from blendjax_torch.kernels.decode import _raise_on, _stream
from blendjax_torch.kernels.work import attention_work

# The kernels' own tile edges (compile-time constants of the CUDA sources),
# by variant. The forward's: (q rows per block, k rows per loop step); the
# sm90 block is three consumer warpgroups of 64 q rows (chosen by
# measurement on an H100, PERF.md). dK/dV: (kv rows per block, q rows per
# loop step); dQ: (q rows per block, k rows per loop step); an sm90
# backward block's two consumer warpgroups share its 64 rows and split the
# loop steps (the dK/dV grid holds a dk and a dv block per 64 kv rows).
FWD_BLOCKS = {"sm90": (192, 64), "simple": (64, 64)}
DKV_BLOCKS = {"sm90": (64, 64), "simple": (64, 32)}
DQ_BLOCKS = {"sm90": (64, 64), "simple": (64, 64)}
SM90_HEAD_DIMS = (64, 128)
MAX_HEAD_DIM = 128
HEAD_DIM_MULTIPLE = 8
KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def default_scale(q, scale=None) -> float:
    return float(q.shape[-1] ** -0.5 if scale is None else scale)


def causal_mask(tq: int, tk: int, device):
    """(Tq, Tk) True where row attends col: col <= row (top-left aligned)."""
    return (torch.arange(tq, device=device)[:, None]
            >= torch.arange(tk, device=device)[None, :])


def _scores(q, k, causal: bool, scale: float):
    """f32 scores (B, H, Tq, Tk) of (B, T, H, D) inputs; masked entries -inf."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        s = s.masked_fill(~causal_mask(q.shape[1], k.shape[1], q.device),
                          float("-inf"))
    return s


def flash_attention_fwd_plain(q, k, v, causal=False, scale=None):
    """Plain K4a: ``(o, lse)`` with ``o = sum_j cast(exp(s - m)) v / l``
    (the kernel normalises after the second product) and
    ``lse = m + log(l)`` (B, H, Tq) f32."""
    scale = default_scale(q, scale)
    s = _scores(q, k, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)  # noqa: E741
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = (o / l.permute(0, 2, 1, 3)).to(v.dtype)
    return o, (m + torch.log(l)).squeeze(-1)


def _probs_and_ds(q, k, v, do, lse, di, causal, scale):
    """The backward's shared half: p = exp(s - lse) and
    ds = p * (do v^T - di) * scale, both (B, H, Tq, Tk) f32."""
    p = torch.exp(_scores(q, k, causal, scale) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - di[..., None]) * scale


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, di, causal=False,
                                  scale=None):
    """Plain K4b: ``dv = cast(p)^T do``, ``dk = cast(ds)^T q``."""
    scale = default_scale(q, scale)
    p, ds = _probs_and_ds(q, k, v, do, lse, di, causal, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(do.dtype).float(), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq_plain(q, k, v, do, lse, di, causal=False,
                                 scale=None):
    """Plain K4c: ``dq = cast(ds) k``."""
    scale = default_scale(q, scale)
    _, ds = _probs_and_ds(q, k, v, do, lse, di, causal, scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype)


def attention_delta(o, do):
    """di = rowsum(o * do) in f32, (B, H, Tq) (plain torch, both devices)."""
    return (o.float() * do.float()).sum(dim=-1).permute(0, 2, 1).contiguous()


def _check_inputs(q, k, v, *rest) -> str:
    """Shapes for both devices; dtype, head dim and strides for the kernel.
    Returns ``"cpu"`` or ``"cuda"``."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be (B, T, H, D)")
    b, tq, h, d = q.shape
    if tuple(k.shape) != tuple(v.shape) or (k.shape[0], k.shape[2],
                                            k.shape[3]) != (b, h, d):
        raise ValueError(
            f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
            "disagree on (B, H, D) or k != v"
        )
    if tq < 1 or k.shape[1] < 1:
        raise ValueError("attention over an empty sequence")
    tensors = (q, k, v, *rest)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs span devices {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return "cpu"
    if device.type != "cuda":
        raise RuntimeError(f"no attention kernel for device {device}")
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"the flash kernel takes bf16 or f32 q, k, v of one dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not (HEAD_DIM_MULTIPLE <= d <= MAX_HEAD_DIM and d % HEAD_DIM_MULTIPLE == 0):
        raise ValueError(
            f"the flash kernel takes head dims that are multiples of "
            f"{HEAD_DIM_MULTIPLE} up to {MAX_HEAD_DIM}, got {d}"
        )
    for t in (q, k, v, *rest[:1]):  # do shares q's layout rules
        if t.stride(-1) != 1:
            raise ValueError("the flash kernel needs a unit stride over D")
    return "cuda"


def _strides(*tensors):
    """The 12 (b, t, h) element strides of q, k, v, do for the C side."""
    vals = []
    for t in tensors:
        vals += [t.stride(0), t.stride(1), t.stride(2)]
    vals += [0] * (12 - len(vals))
    return (ctypes.c_int64 * 12)(*vals)


def _vec16(*tensors) -> bool:
    """Whether every row of every tensor can be read in 16-byte vectors."""
    for t in tensors:
        size = t.element_size()
        if t.data_ptr() % 16 or (t.shape[-1] * size) % 16:
            return False
        if any((t.stride(i) * size) % 16 for i in range(3)):
            return False
    return True


def _tma_ready(*tensors) -> bool:
    """Whether the sm90 kernels can take these tensors: bf16 with head dim
    64 or 128 that TMA can address (a unit stride over D, positive (b, t,
    h) strides that are multiples of 16 bytes, 16-byte aligned bases)."""
    if tensors[0].shape[-1] not in SM90_HEAD_DIMS:
        return False
    for t in tensors:
        if t.dtype != torch.bfloat16 or t.stride(-1) != 1 or t.data_ptr() % 16:
            return False
        if any(t.stride(i) < 1 or (t.stride(i) * 2) % 16 for i in range(3)):
            return False
    return True


def fwd_variant(q, k, v, scale=None) -> str:
    """The forward kernel that takes these CUDA tensors: ``"sm90"`` for
    bf16 q, k and v with head dim 64 or 128 that TMA can address (a unit
    stride over D, positive (b, t, h) strides that are multiples of 16
    bytes, 16-byte aligned base addresses) and a positive scale (the sm90
    kernel takes the row max before scaling), ``"simple"`` otherwise."""
    if not default_scale(q, scale) > 0:
        return "simple"
    return "sm90" if _tma_ready(q, k, v) else "simple"


def bwd_variant(q, k, v, do) -> str:
    """The backward kernels (K4b and K4c) that take these CUDA tensors:
    ``"sm90"`` for bf16 q, k, v and do with head dim 64 or 128 that TMA can
    address (the forward's conditions on q, k and v, applied to do too),
    ``"simple"`` otherwise, f32 included. Unlike :func:`fwd_variant` the
    rule asks nothing of the scale: the backward recomputes
    ``p = exp(s * scale - lse)`` from the forward's row statistics, which
    holds for any scale, so no row max is taken."""
    return "sm90" if _tma_ready(q, k, v, do) else "simple"


_ARGS = {
    "bjt_flash_fwd": [ctypes.c_void_p] * 5,
    "bjt_flash_bwd_dkv": [ctypes.c_void_p] * 8,
    "bjt_flash_bwd_dq": [ctypes.c_void_p] * 7,
}


def _launch(name: str, pointers, strides, q, k, causal, scale, vec) -> None:
    lib = load("flash_attention")
    fn = entry(lib, name, _ARGS[name] + [ctypes.c_void_p] + [ctypes.c_int] * 8
               + [ctypes.c_float, ctypes.c_void_p])
    b, tq, h, d = q.shape
    code = fn(
        *pointers, strides, b, h, tq, k.shape[1], d, int(bool(causal)),
        KERNEL_DTYPES[q.dtype], int(vec), float(scale), _stream(q.device),
    )
    _raise_on(lib, "bjt_flash_error", code, name)


def _launch_sm90_bwd(name: str, pointers, q, k, v, do, causal, scale) -> None:
    lib = load("flash_bwd_sm90")
    fn = entry(lib, name, [ctypes.c_void_p] * (len(pointers) + 1)
               + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
    b, tq, h, d = q.shape
    code = fn(
        *pointers, _strides(q, k, v, do), b, h, tq, k.shape[1], d,
        int(bool(causal)), float(scale), _stream(q.device),
    )
    _raise_on(lib, "bjt_flash_bwd_sm90_error", code, name)


def _launch_sm90(q, k, v, o, lse, causal, scale) -> None:
    lib = load("flash_fwd_sm90")
    fn = entry(lib, "bjt_flash_fwd_sm90",
               [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
               + [ctypes.c_float, ctypes.c_void_p])
    b, tq, h, d = q.shape
    code = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        _strides(q, k, v), b, h, tq, k.shape[1], d, int(bool(causal)),
        float(scale), _stream(q.device),
    )
    _raise_on(lib, "bjt_flash_fwd_sm90_error", code, "bjt_flash_fwd_sm90")


def flash_attention_fwd(q, k, v, causal=False, scale=None):
    """K4a: ``(o (B, Tq, H, D) in q's dtype, lse (B, H, Tq) f32)``, through
    the variant :func:`fwd_variant` names."""
    if _check_inputs(q, k, v) == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, scale)
    scale = default_scale(q, scale)
    b, tq, h, d = q.shape
    o = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    variant = fwd_variant(q, k, v, scale)
    if variant == "sm90":
        _launch_sm90(q, k, v, o, lse, causal, scale)
    else:
        _launch(
            "bjt_flash_fwd",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr()),
            _strides(q, k, v), q, k, causal, scale, _vec16(q, k, v),
        )
    count_launch(flash_attention_fwd, variant,
                 lambda: flash_attention_fwd.work(q, k, causal))
    return o, lse


def _work(name: str):
    """``work(q, k, causal)``: one launch's ``(flops, bytes)``."""
    return lambda q, k, causal=False: attention_work(
        q.shape[0], q.shape[1], k.shape[1], q.shape[2], q.shape[3],
        q.element_size(), bool(causal))[name]


flash_attention_fwd.launches = 0
flash_attention_fwd.work = _work("flash_attention_fwd")
flash_attention_fwd.launches_by_variant = {"sm90": 0, "simple": 0}


def _check_stats(q, lse, di):
    b, tq, h, _ = q.shape
    for name, t in (("lse", lse), ("di", di)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (b, h, tq)
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous (B, H, Tq) f32")


def _launch_bwd(name: str, outputs, q, k, v, do, lse, di, causal,
                scale) -> str:
    """Launch backward kernel ``name`` (``"bjt_flash_bwd_dkv"`` or
    ``"bjt_flash_bwd_dq"``) through the variant :func:`bwd_variant` names;
    returns that variant."""
    pointers = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), di.data_ptr(), *(t.data_ptr() for t in outputs))
    variant = bwd_variant(q, k, v, do)
    if variant == "sm90":
        _launch_sm90_bwd(f"{name}_sm90", pointers, q, k, v, do, causal, scale)
    else:
        _launch(name, pointers, _strides(q, k, v, do), q, k, causal, scale,
                _vec16(q, k, v, do))
    return variant


def flash_attention_bwd_dkv(q, k, v, do, lse, di, causal=False, scale=None):
    """K4b: ``(dk, dv)``, (B, Tk, H, D) in the input dtype, through the
    variant :func:`bwd_variant` names."""
    if tuple(do.shape) != tuple(q.shape) or do.dtype != q.dtype:
        raise ValueError("do must match q's shape and dtype")
    _check_stats(q, lse, di)
    if _check_inputs(q, k, v, do, lse, di) == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, do, lse, di, causal,
                                             scale)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    variant = _launch_bwd("bjt_flash_bwd_dkv", (dk, dv), q, k, v, do, lse, di,
                          causal, default_scale(q, scale))
    count_launch(flash_attention_bwd_dkv, variant,
                 lambda: flash_attention_bwd_dkv.work(q, k, causal))
    return dk, dv


flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dkv.work = _work("flash_attention_bwd_dkv")
flash_attention_bwd_dkv.launches_by_variant = {"sm90": 0, "simple": 0}


def flash_attention_bwd_dq(q, k, v, do, lse, di, causal=False, scale=None):
    """K4c: ``dq`` (B, Tq, H, D) in the input dtype, through the variant
    :func:`bwd_variant` names."""
    if tuple(do.shape) != tuple(q.shape) or do.dtype != q.dtype:
        raise ValueError("do must match q's shape and dtype")
    _check_stats(q, lse, di)
    if _check_inputs(q, k, v, do, lse, di) == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, do, lse, di, causal,
                                            scale)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    variant = _launch_bwd("bjt_flash_bwd_dq", (dq,), q, k, v, do, lse, di,
                          causal, default_scale(q, scale))
    count_launch(flash_attention_bwd_dq, variant,
                 lambda: flash_attention_bwd_dq.work(q, k, causal))
    return dq


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.work = _work("flash_attention_bwd_dq")
flash_attention_bwd_dq.launches_by_variant = {"sm90": 0, "simple": 0}


class FlashAttention(torch.autograd.Function):
    """``o = softmax(q k^T * scale) v`` through K4a; the backward runs
    K4b and K4c (for CPU tensors: the plain backward written out from the
    same formulas, not autograd through the plain forward)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        di = attention_delta(o, do)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, di, ctx.causal,
                                         ctx.scale)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, di, ctx.causal,
                                    ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, scale=None):
    """Differentiable flash attention over (B, T, H, D) tensors."""
    return FlashAttention.apply(q, k, v, bool(causal), default_scale(q, scale))
