"""StreamFormer: a compact vision transformer over image streams (port of
``blendjax/models/transformer.py``, the local dense path).

Takes the streamed frames as they arrive, NHWC uint8 (B, H, W, C), and
returns (B, num_outputs) f32. Behaviours of the flax original kept on
purpose:

- flax ``LayerNorm(dtype=float32)``: epsilon 1e-6 (torch's default is
  1e-5), the variance taken as E[x^2] - E[x]^2 in f32, and an f32 result
  even for a bf16 residual stream;
- ``nn.gelu`` is the tanh form;
- the ``qkv`` projection is a ``DenseGeneral`` with kernel (C, 3, H, D):
  its output reshapes to (B, T, 3, H, D) and q, k, v are the strided views
  ``[:, :, i]`` in that order, which the flash kernel reads without a copy;
- the patch embedding is a ``'SAME'`` convolution with stride = kernel =
  patch (:func:`~blendjax_torch.models.cnn.same_pads`);
- ``pos_embed`` (1, T, C) is cast to the compute dtype before the add, and
  the final LayerNorm, the mean over tokens and the head run in f32.

The token count T is fixed by ``image_shape`` at construction (flax takes
it from the example input at ``init``). Sequence parallelism (ring,
ulysses, a mesh), mixture-of-experts blocks and ``remat`` wait for the
multi-GPU slice (ROADMAP Queue A item 5) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from blendjax_torch.models.cnn import lecun_normal_, same_pads
from blendjax_torch.ops.attention import local_attention
from blendjax_torch.ops.image import maybe_normalize_uint8
from blendjax_torch.precision import default_compute_dtype

LATER_SLICE = (
    "waits for the multi-GPU slice of the port (ROADMAP Queue A item 5); only "
    "the local, dense StreamFormer path is ported"
)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=jnp.float32)``: f32 statistics with the
    fast variance, epsilon 1e-6, f32 output."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = float(eps)
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        x = x.float()
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x * x).mean(dim=-1, keepdim=True) - mean * mean).clamp(min=0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


def _dense(layer: nn.Linear, x, dtype):
    """A flax ``Dense`` with ``dtype``: input and f32 parameters cast."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class MultiHeadAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, dtype=None,
                 causal: bool = False, attn_backend: str = "auto"):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} must divide into {num_heads} heads")
        self.num_heads = int(num_heads)
        self.dtype = dtype
        self.causal = bool(causal)
        self.attn_backend = attn_backend
        self.qkv = nn.Linear(dim, 3 * dim)  # DenseGeneral (C, 3, H, D)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        dtype = default_compute_dtype(self.dtype)
        b, t, c = x.shape
        h = self.num_heads
        qkv = _dense(self.qkv, x, dtype).reshape(b, t, 3, h, c // h)
        q, k, v = (qkv[:, :, i] for i in range(3))  # (B, T, H, D) views
        o = local_attention(q, k, v, causal=self.causal,
                            backend=self.attn_backend)
        return _dense(self.proj, o.to(dtype).reshape(b, t, c), dtype)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4,
                 dtype=None, causal: bool = False, attn_backend: str = "auto"):
        super().__init__()
        self.dtype = dtype
        self.norm1 = LayerNorm(dim)
        self.attn = MultiHeadAttention(dim, num_heads, dtype=dtype,
                                       causal=causal, attn_backend=attn_backend)
        self.norm2 = LayerNorm(dim)
        self.fc1 = nn.Linear(dim, dim * mlp_ratio)
        self.fc2 = nn.Linear(dim * mlp_ratio, dim)

    def forward(self, x):
        dtype = default_compute_dtype(self.dtype)
        x = x + self.attn(self.norm1(x))
        y = F.gelu(_dense(self.fc1, self.norm2(x), dtype), approximate="tanh")
        return x + _dense(self.fc2, y, dtype)


class StreamFormer(nn.Module):
    """Patchify -> transformer blocks -> head; ``num_outputs=16`` regresses
    the 8 cube corners, so it trains on the same stream as
    :class:`~blendjax_torch.models.CubeRegressor`."""

    def __init__(self, patch: int = 16, dim: int = 256, depth: int = 4,
                 num_heads: int = 8, num_outputs: int = 16, dtype=None,
                 attn_backend: str = "auto", image_shape=(480, 640),
                 in_channels: int = 4, use_ring: bool = False, mesh=None,
                 sp_mode: str = "ring", num_experts: int = 0,
                 remat: bool = False):
        super().__init__()
        for name, asked in (("use_ring", use_ring), ("mesh", mesh is not None),
                            ("sp_mode='ulysses'", sp_mode == "ulysses"),
                            ("num_experts > 0", num_experts > 0),
                            ("remat", remat)):
            if asked:
                raise NotImplementedError(f"StreamFormer {name} {LATER_SLICE}")
        if sp_mode != "ring":
            raise ValueError(f"unknown sp_mode {sp_mode!r}; use 'ring' or 'ulysses'")
        self.patch = int(patch)
        self.dtype = dtype
        self.image_shape = tuple(int(s) for s in image_shape)
        self.grid = tuple(-(-s // self.patch) for s in self.image_shape)
        self.patch_embed = nn.Conv2d(in_channels, dim, patch, stride=patch)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, self.grid[0] * self.grid[1], dim)
        )
        self.blocks = nn.ModuleList(
            Block(dim, num_heads, dtype=dtype, attn_backend=attn_backend)
            for _ in range(depth)
        )
        self.norm = LayerNorm(dim)
        self.head = nn.Linear(dim, num_outputs)

    @property
    def tokens(self) -> int:
        return self.grid[0] * self.grid[1]

    def init_params(self, seed: int = 0) -> "StreamFormer":
        """flax's default initialisation, from an explicit generator:
        LeCun-normal kernels (truncated; the qkv fan-in is C), zero biases,
        ``pos_embed`` normal(0.02), LayerNorm scale 1 and bias 0."""
        gen = torch.Generator().manual_seed(int(seed))
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, (nn.Linear, nn.Conv2d)):
                    lecun_normal_(mod.weight, gen)
                    mod.bias.zero_()
                elif isinstance(mod, LayerNorm):
                    mod.weight.fill_(1.0)
                    mod.bias.zero_()
            pos = torch.empty(self.pos_embed.shape)
            nn.init.normal_(pos, std=0.02, generator=gen)
            self.pos_embed.copy_(pos)
        return self

    def forward(self, images):
        """``images``: (B, H, W, C) uint8 (or float in [0, 1])."""
        dtype = default_compute_dtype(self.dtype)
        x = maybe_normalize_uint8(images, dtype).permute(0, 3, 1, 2)
        top, bottom = same_pads(x.shape[2], self.patch, self.patch)
        left, right = same_pads(x.shape[3], self.patch, self.patch)
        x = F.conv2d(
            F.pad(x, (left, right, top, bottom)),
            self.patch_embed.weight.to(dtype), self.patch_embed.bias.to(dtype),
            stride=self.patch,
        )
        b, c, hh, ww = x.shape
        x = x.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        x = x + self.pos_embed.to(dtype)
        for block in self.blocks:
            x = block(x)
        x = self.norm(x).mean(dim=1)
        return _dense(self.head, x, torch.float32)
