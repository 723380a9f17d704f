"""StreamFormer: a compact vision transformer over image streams (port of
``blendjax/models/transformer.py``).

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
it from the example input at ``init``).

Sequence parallelism (``use_ring=True`` or ``sp_mode="ulysses"``, with a
``mesh`` from :func:`blendjax_torch.parallel.create_mesh`): every rank of
the ``seq`` axis runs the model on the same rows (its batch rows), so all
but attention is computed whole on each; attention takes this rank's
sequence block of q, k, v
(:func:`~blendjax_torch.parallel.collectives.scatter_to_axis`, whose
backward all-gathers the block gradients), runs
:func:`~blendjax_torch.parallel.ulysses_attention` or
:func:`~blendjax_torch.parallel.ring_attention` over the axis, and
all-gathers the output blocks (whose backward keeps this rank's block).
Without a ``seq`` axis on the mesh both fall back as the JAX package's do
(Ulysses to the local attention, ring to exact plain attention).

Tensor parallelism (a train state sharded over ``tp`` by
``StreamFormer.partition_rules()``, :class:`~blendjax_torch.parallel.ShardedParams`):
each rank of the ``tp`` axis holds its block of the split kernels and
computes with it in place, the Megatron split the JAX package's GSPMD jit
compiles (``blendjax_torch/docs/mesh-split.md``). ``qkv`` is column-split
by heads (each rank runs attention, K4a-c on the card, on its ``H / tp``
heads; its bias, split on the head dim by the generic rule, reaches the
heads by one all-to-all), ``proj`` row-split and summed over ``tp``; the
MLP's ``fc1`` column-split (its bias sliced at use) and ``fc2`` row-split
and summed; the patch embedding and ``pos_embed`` column-split on the
channels and all-gathered; the head column-split and its outputs
all-gathered. The residual stream stays whole on every rank. A head
count ``tp`` does not divide raises ``ValueError``.

Mixture of experts (``num_experts > 0``): block ``i`` with
``i % moe_every == 0`` takes a :class:`~blendjax_torch.models.moe.MoEMLP`
in place of its dense MLP (flax path ``block{i}/MoEMLP_0``). ``remat=True``
runs each block under ``torch.utils.checkpoint.checkpoint(...,
use_reentrant=False)``: its activations are recomputed in the backward
pass (attention's forward kernel runs twice per block and update), and
the parameter names do not change, as the reference's explicit
``block{i}`` names promise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from blendjax_torch.models.cnn import lecun_normal_, same_pads
from blendjax_torch.models.moe import MoEMLP
from blendjax_torch.ops.attention import local_attention
from blendjax_torch.ops.image import maybe_normalize_uint8
from blendjax_torch.parallel.sharding import split_of
from blendjax_torch.parallel.tensor import (
    column_bias,
    enter,
    gather_columns,
    row_sum,
)
from blendjax_torch.precision import default_compute_dtype

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
    #: the kernels it computes with split over ``tp`` in place, by flax
    #: dim: qkv (C, 3, H, D) by heads, its bias (3, H, D) by heads or D
    #: (the generic rule's), proj (H*D, C) by its rows; qkv and proj go
    #: together
    SPLIT_PARAMS = {"tp": {"qkv.weight": (2,), "qkv.bias": (1, 2),
                           "proj.weight": (0,)}}
    SPLIT_GROUPS = (("qkv.weight", "proj.weight"),)

    def __init__(self, dim: int, num_heads: int, dtype=None,
                 causal: bool = False, attn_backend: str = "auto",
                 use_ring: bool = False, mesh=None, seq_axis: str = "seq",
                 batch_axis: str = "data", sp_mode: str = "ring"):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} must divide into {num_heads} heads")
        if sp_mode not in ("ring", "ulysses"):
            raise ValueError(
                f"unknown sp_mode {sp_mode!r}; use 'ring' or 'ulysses'")
        # use_ring gates sequence parallelism; asking for the non-default
        # strategy enables it too
        self.use_sp = bool(use_ring) or sp_mode == "ulysses"
        if self.use_sp and mesh is None:
            raise ValueError("sequence parallelism needs a mesh")
        self.num_heads = int(num_heads)
        self.dtype = dtype
        self.causal = bool(causal)
        self.attn_backend = attn_backend
        self.mesh = mesh
        self.seq_axis = seq_axis
        self.batch_axis = batch_axis
        self.sp_mode = sp_mode
        self.qkv = nn.Linear(dim, 3 * dim)  # DenseGeneral (C, 3, H, D)
        self.proj = nn.Linear(dim, dim)

    def _sequence_parallel(self, q, k, v):
        from blendjax_torch.parallel import (
            all_gather,
            ring_attention,
            scatter_to_axis,
            ulysses_attention,
        )
        from blendjax_torch.parallel.mesh import mesh_shape

        mesh, axis = self.mesh, self.seq_axis
        n = mesh_shape(mesh).get(axis, 1)
        if axis in mesh_shape(mesh):
            if q.shape[1] % n:
                raise ValueError(
                    f"{q.shape[1]} tokens do not split over the {n}-way "
                    f"{axis!r} axis")
            q, k, v = (scatter_to_axis(x, mesh, axis, dim=1)
                       for x in (q, k, v))
        if self.sp_mode == "ulysses":
            o = ulysses_attention(q, k, v, mesh, axis=axis,
                                  causal=self.causal,
                                  batch_axis=self.batch_axis,
                                  backend=self.attn_backend)
        else:
            o = ring_attention(q, k, v, mesh, axis=axis, causal=self.causal,
                               batch_axis=self.batch_axis)
        if axis in mesh_shape(mesh):
            o = all_gather(o, mesh, axis, dim=1)
        return o

    def check_split(self, found: dict) -> None:
        """A ``tp`` axis the rules put on the attention must divide the
        head count (``ValueError``)."""
        for _dim, _axis, ways in found.values():
            if self.num_heads % ways:
                raise ValueError(
                    f"{self.num_heads} attention heads do not split over "
                    f"the {ways}-way tensor-parallel axis: tp must divide "
                    "the head count")

    def _split_qkv_bias(self, res, d: int):
        """This rank's heads' (3 * H/tp * D,) qkv bias: the generic rule
        splits the bias on D, so one all-to-all moves it onto the heads
        (as the JAX package's compiled step does); a replicated bias is
        sliced."""
        from blendjax_torch.parallel.collectives import all_to_all

        h = self.num_heads
        bias = self.qkv.bias
        sb = split_of(self, "qkv.bias")
        if sb is None:
            return column_bias(bias.reshape(3, h, d), res, dim=1).reshape(-1)
        if sb.flax_dim == 1:  # already this rank's heads
            return bias
        if sb.flax_dim != 2:
            raise ValueError(f"qkv bias split on dim {sb.flax_dim}")
        return all_to_all(bias.reshape(3, h, d // sb.ways), res.mesh,
                          res.axis, split_dim=1, concat_dim=2).reshape(-1)

    def forward(self, x):
        dtype = default_compute_dtype(self.dtype)
        b, t, c = x.shape
        h = self.num_heads
        res = split_of(self, "qkv.weight")
        if res is None:
            qkv = _dense(self.qkv, x, dtype).reshape(b, t, 3, h, c // h)
        else:  # this rank's heads
            h //= res.ways
            qkv = F.linear(enter(x.to(dtype), res),
                           self.qkv.weight.to(dtype),
                           self._split_qkv_bias(res, c // self.num_heads)
                           .to(dtype)).reshape(b, t, 3, h, -1)
        q, k, v = (qkv[:, :, i] for i in range(3))  # (B, T, H, D) views
        if self.use_sp:
            o = self._sequence_parallel(q, k, v)
        else:
            o = local_attention(q, k, v, causal=self.causal,
                                backend=self.attn_backend)
        o = o.to(dtype).reshape(b, t, -1)
        if res is None:
            return _dense(self.proj, o, dtype)
        y = row_sum(F.linear(o, self.proj.weight.to(dtype)), res)
        return y + self.proj.bias.to(dtype)


class Block(nn.Module):
    """LayerNorm, attention, LayerNorm, then a dense MLP or, with
    ``num_experts > 0``, a Switch mixture of experts (``self.moe``)."""

    #: the MLP kernels it computes with split over ``tp`` in place:
    #: fc1 (C, 4C) by its outputs, fc2 (4C, C) by its rows, together
    SPLIT_PARAMS = {"tp": {"fc1.weight": (1,), "fc2.weight": (0,)}}
    SPLIT_GROUPS = (("fc1.weight", "fc2.weight"),)

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4,
                 dtype=None, causal: bool = False, attn_backend: str = "auto",
                 num_experts: int = 0, **sp):
        super().__init__()
        self.dtype = dtype
        self.norm1 = LayerNorm(dim)
        self.attn = MultiHeadAttention(dim, num_heads, dtype=dtype,
                                       causal=causal, attn_backend=attn_backend,
                                       **sp)
        self.norm2 = LayerNorm(dim)
        if num_experts > 0:
            self.moe = MoEMLP(dim, num_experts, mlp_ratio=mlp_ratio,
                              dtype=dtype)
        else:
            self.fc1 = nn.Linear(dim, dim * mlp_ratio)
            self.fc2 = nn.Linear(dim * mlp_ratio, dim)

    def forward(self, x):
        dtype = default_compute_dtype(self.dtype)
        x = x + self.attn(self.norm1(x))
        if hasattr(self, "moe"):
            return x + self.moe(self.norm2(x))
        res = split_of(self, "fc1.weight")
        if res is None:
            y = F.gelu(_dense(self.fc1, self.norm2(x), dtype),
                       approximate="tanh")
            return x + _dense(self.fc2, y, dtype)
        y = F.gelu(F.linear(
            enter(self.norm2(x).to(dtype), res), self.fc1.weight.to(dtype),
            column_bias(self.fc1.bias, res).to(dtype)), approximate="tanh")
        y = row_sum(F.linear(y, self.fc2.weight.to(dtype)), res)
        return x + (y + self.fc2.bias.to(dtype))


class StreamFormer(nn.Module):
    """Patchify -> transformer blocks -> head; ``num_outputs=16`` regresses
    the 8 cube corners, so it trains on the same stream as
    :class:`~blendjax_torch.models.CubeRegressor`."""

    #: the embedding and head kernels it computes with split over ``tp``
    #: in place, by their output channels
    SPLIT_PARAMS = {"tp": {"patch_embed.weight": (3,), "pos_embed": (2,),
                           "head.weight": (1,)}}

    def __init__(self, patch: int = 16, dim: int = 256, depth: int = 4,
                 num_heads: int = 8, num_outputs: int = 16, dtype=None,
                 attn_backend: str = "auto", image_shape=(480, 640),
                 in_channels: int = 4, use_ring: bool = False, mesh=None,
                 seq_axis: str = "seq", batch_axis: str = "data",
                 sp_mode: str = "ring", num_experts: int = 0,
                 moe_every: int = 2, remat: bool = False):
        super().__init__()
        if sp_mode not in ("ring", "ulysses"):
            raise ValueError(f"unknown sp_mode {sp_mode!r}; use 'ring' or 'ulysses'")
        if mesh is not None:
            from blendjax_torch.parallel.mesh import check_mesh

            check_mesh(mesh)
        sp = dict(use_ring=use_ring, mesh=mesh, seq_axis=seq_axis,
                  batch_axis=batch_axis, sp_mode=sp_mode)
        self.patch = int(patch)
        self.dtype = dtype
        self.image_shape = tuple(int(s) for s in image_shape)
        self.grid = tuple(-(-s // self.patch) for s in self.image_shape)
        self.patch_embed = nn.Conv2d(in_channels, dim, patch, stride=patch)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, self.grid[0] * self.grid[1], dim)
        )
        self.num_experts = int(num_experts)
        self.moe_every = max(1, int(moe_every))
        self.remat = bool(remat)
        self.blocks = nn.ModuleList(
            Block(dim, num_heads, dtype=dtype, attn_backend=attn_backend,
                  num_experts=(self.num_experts if self.num_experts > 0
                               and i % self.moe_every == 0 else 0), **sp)
            for i in range(depth)
        )
        self.norm = LayerNorm(dim)
        self.head = nn.Linear(dim, num_outputs)

    def partition_rules(self) -> tuple:
        """The Megatron-style tensor-parallel layout of this parameter tree
        (the JAX package's): :data:`~blendjax_torch.parallel.DEFAULT_TP_RULES`
        plus the output head column-split over ``tp``, on the flax paths
        of :func:`blendjax_torch.weights.flax_params`."""
        from blendjax_torch.parallel.sharding import (
            DEFAULT_TP_RULES,
            PartitionRule,
        )

        return DEFAULT_TP_RULES + (
            PartitionRule(r"^Dense_0/kernel$", ("tp",)),  # output head
        )

    @property
    def tokens(self) -> int:
        return self.grid[0] * self.grid[1]

    def init_params(self, seed: int = 0) -> "StreamFormer":
        """flax's default initialisation, from an explicit generator:
        LeCun-normal kernels (truncated; the qkv fan-in is C, an expert
        kernel's E x its input dim), zero biases, ``pos_embed``
        normal(0.02), LayerNorm scale 1 and bias 0."""
        gen = torch.Generator().manual_seed(int(seed))
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, (nn.Linear, nn.Conv2d)):
                    lecun_normal_(mod.weight, gen)
                    mod.bias.zero_()
                elif isinstance(mod, LayerNorm):
                    mod.weight.fill_(1.0)
                    mod.bias.zero_()
                elif isinstance(mod, MoEMLP):
                    # flax's fan-in of an (E, in, out) kernel is E * in
                    for w in (mod.expert_wi, mod.expert_wo):
                        lecun_normal_(w.permute(2, 0, 1), gen)
                    mod.expert_bi.zero_()
                    mod.expert_bo.zero_()
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
        res = split_of(self, "patch_embed.weight")  # this rank's channels
        x = F.conv2d(
            F.pad(x, (left, right, top, bottom)),
            self.patch_embed.weight.to(dtype),
            column_bias(self.patch_embed.bias, res).to(dtype),
            stride=self.patch,
        )
        b, c, hh, ww = x.shape
        x = x.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        pos, pres = self.pos_embed, split_of(self, "pos_embed")
        if res is None and pres is not None:
            pos = gather_columns(pos, pres)
        elif res is not None:
            pos = column_bias(pos, res, pres, dim=2)
        x = gather_columns(x + pos.to(dtype), res)
        for block in self.blocks:
            if self.remat and torch.is_grad_enabled():
                # the blocks draw no random numbers: no RNG state to keep
                # (saving it would read the generator inside a capture)
                x = checkpoint(block, x, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = block(x)
        x = self.norm(x).mean(dim=1)
        res = split_of(self, "head.weight")  # this rank's outputs
        if res is None:
            return _dense(self.head, x, torch.float32)
        out = F.linear(enter(x, res), self.head.weight.float(),
                       column_bias(self.head.bias, res).float())
        return gather_columns(out, res)
