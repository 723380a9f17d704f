"""Local (single-device) attention backends (port of
``blendjax/ops/attention.py`` and of ``reference_attention`` from
``blendjax/parallel/ring.py``).

Two exact backends behind :func:`local_attention`, over (B, T, H, D):

- ``xla``: :func:`reference_attention`, plain PyTorch that materialises
  the (B, H, Tq, Tk) f32 scores (the name is the JAX package's);
- ``flash``: the hand-written CUDA kernels K4a-c
  (:mod:`blendjax_torch.kernels.attention`) inside a
  ``torch.autograd.Function``; the scores never reach device memory.

``auto`` keeps the JAX package's memory rule unchanged: ``xla`` until one
call's saved f32 score residual would exceed :data:`FLASH_RESIDUAL_BYTES`,
``flash`` beyond. Its threshold was set on a TPU and is not retuned for
an 80 GB card here; at the StreamFormer slice's shape (T=768) ``auto``
resolves to ``xla``, so that slice names ``flash`` explicitly.

Two things differ from the JAX package, on purpose:

- :func:`flash_supported` tests the port kernel's own limits instead of
  "TPU and T % 128": CUDA tensors, bf16 or f32, a head dim that is a
  multiple of 8 up to 128. Any T is taken: ragged tiles are masked inside
  the kernel. :data:`FLASH_BLOCK` and :func:`flash_block_sizes` are the
  kernels' own tile edges (those of one of their two variants,
  :func:`~blendjax_torch.kernels.attention.fwd_variant` and
  :func:`~blendjax_torch.kernels.attention.bwd_variant`).
- ``backend="flash"`` on CPU tensors runs the kernels' plain versions
  (the same autograd function), as every kernel wrapper of the port does.
  On a CUDA tensor the kernel cannot take it raises ``ValueError`` and
  never runs ``xla`` quietly.
"""

from __future__ import annotations

import torch

from blendjax_torch.kernels import attention as K

NEG_INF = -1e30

# Per-call score-residual budget (bytes of f32 probabilities saved for the
# backward) above which ``auto`` takes the flash kernel: the JAX package's
# value, unchanged.
FLASH_RESIDUAL_BYTES = 2 << 30
# The largest tile edge of any kernel: the sm90 forward's q tile (the
# others are 32 to 128 rows).
FLASH_BLOCK = K.FWD_BLOCKS["sm90"][0]


def flash_block_sizes(t_q: int, t_kv: int, variant: str = "sm90") -> dict:
    """The kernels' tile edges for a (t_q, t_kv) call, and the grid each
    launches, those of ``variant`` (the name
    :func:`~blendjax_torch.kernels.attention.fwd_variant` and
    :func:`~blendjax_torch.kernels.attention.bwd_variant` give: ``"sm90"``
    on the bf16 main path, or ``"simple"``). Edges are fixed; a ragged last
    tile is masked in the kernel."""
    cdiv = lambda a, b: -(-int(a) // b)  # noqa: E731
    block_q, block_k = K.FWD_BLOCKS[variant]
    block_k_dkv, block_q_dkv = K.DKV_BLOCKS[variant]
    block_q_dq, block_k_dq = K.DQ_BLOCKS[variant]
    return {
        "block_q": block_q, "block_k": block_k,
        "block_k_dkv": block_k_dkv, "block_q_dkv": block_q_dkv,
        "block_q_dq": block_q_dq, "block_k_dq": block_k_dq,
        "grid_fwd": cdiv(t_q, block_q),
        "grid_dkv": cdiv(t_kv, block_k_dkv),
        "grid_dq": cdiv(t_q, block_q_dq),
    }


def reference_attention(q, k, v, causal: bool = False, scale=None):
    """Exact attention over (B, T, H, D), the JAX package's mixed precision:
    both products take their operands in the input dtype and sum in f32
    (the operands are upcast: a product of two bf16 values is exact in
    f32), the softmax runs in f32, ``p`` is cast to ``v.dtype`` before the
    second product and the output is cast to ``v.dtype``."""
    d = q.shape[-1]
    scale = scale if scale is not None else d**-0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = K.causal_mask(q.shape[1], k.shape[1], q.device)
        s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum(
        "bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float()
    ).to(v.dtype)


def scores_residual_bytes(q, k=None) -> int:
    """Bytes of f32 attention probabilities one ``xla`` call saves for its
    backward: ``B * H * Tq * Tk * 4``."""
    b, tq, h, _ = q.shape
    tk = q.shape[1] if k is None else k.shape[1]
    return b * h * tq * tk * 4


def flash_supported(q, k=None) -> bool:
    """Whether the CUDA kernel can take these (B, T, H, D) inputs: CUDA
    tensors of bf16 or f32 (k of the same), a head dim that is a multiple
    of 8 up to 128, non-empty sequences. Any T."""
    if q.ndim != 4 or q.device.type != "cuda":
        return False
    if q.dtype not in K.KERNEL_DTYPES or q.shape[1] < 1:
        return False
    d = q.shape[-1]
    if not (K.HEAD_DIM_MULTIPLE <= d <= K.MAX_HEAD_DIM
            and d % K.HEAD_DIM_MULTIPLE == 0):
        return False
    return k is None or (
        k.ndim == 4 and k.device == q.device and k.dtype == q.dtype
        and k.shape[1] >= 1 and (k.shape[0], k.shape[2], k.shape[3])
        == (q.shape[0], q.shape[2], d)
    )


def auto_picks_flash(q, k=None) -> bool:
    """The ``auto`` policy, exposed so callers can report which backend a
    shape resolves to."""
    return (
        flash_supported(q, k)
        and scores_residual_bytes(q, k) > FLASH_RESIDUAL_BYTES
    )


def local_attention(q, k, v, causal: bool = False, scale=None,
                    backend: str = "auto"):
    """Exact multi-head attention over (B, T, H, D) tensors.

    ``backend``: ``"xla"`` | ``"flash"`` | ``"auto"``. ``"flash"`` on a
    CUDA tensor the kernel cannot take raises instead of running ``xla``;
    on CPU tensors it runs the kernels' plain versions."""
    if backend not in ("auto", "flash", "xla"):
        raise ValueError(f"unknown attention backend {backend!r}")
    on_cpu = q.device.type == "cpu"
    if backend == "flash" and not on_cpu and not flash_supported(q, k):
        raise ValueError(
            "flash attention backend requested but unsupported here: the "
            "kernel takes CUDA bf16/f32 tensors with a head dim that is a "
            f"multiple of {K.HEAD_DIM_MULTIPLE} up to {K.MAX_HEAD_DIM} (got "
            f"{q.device.type} {q.dtype}, q {tuple(q.shape)}, kv "
            f"{tuple(k.shape)})"
        )
    use_flash = backend == "flash" or (
        backend == "auto" and auto_picks_flash(q, k)
    )
    if not use_flash:
        return reference_attention(q, k, v, causal=causal, scale=scale)
    return K.flash_attention(q, k, v, causal=causal, scale=scale)
