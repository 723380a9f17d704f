"""Plain reference of the ViT family: ViT (Dosovitskiy et al.,
arXiv:2010.11929) as the port's ``StreamFormer`` departs from it.

Patch embedding (a stride = kernel = patch convolution, 'SAME' padded),
learned position embeddings, pre-norm blocks (LayerNorm eps 1e-6,
multi-head self-attention over all tokens, LayerNorm, an MLP of
``mlp_ratio * dim`` with tanh GELU), a final LayerNorm, the mean over
tokens (no class token) and a linear head. Frames arrive as uint8 and
are divided by 255. Parameter names are the port's, so one seeded
initialisation fills both.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.common import Products, same_pads


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, ratio: int):
        super().__init__()
        self.heads = heads
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = nn.Module()
        self.attn.qkv = nn.Linear(dim, 3 * dim)
        self.attn.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.fc1 = nn.Linear(dim, ratio * dim)
        self.fc2 = nn.Linear(ratio * dim, dim)

    def forward(self, x, p: Products):
        b, t, c = x.shape
        h = self.heads
        qkv = p.linear(self.norm1(x), self.attn.qkv).reshape(b, t, 3, h, c // h)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (B,H,T,D)
        s = p.matmul(q, k.transpose(-1, -2)) * (c // h) ** -0.5
        o = p.matmul(s.softmax(dim=-1), v)
        x = x + p.linear(o.transpose(1, 2).reshape(b, t, c), self.attn.proj)
        y = F.gelu(p.linear(self.norm2(x), self.fc1), approximate="tanh")
        return x + p.linear(y, self.fc2)


class Model(nn.Module):
    def __init__(self, model: dict, shape, products: Products):
        super().__init__()
        self.patch = model["patch"]
        dim = model["dim"]
        self.grid = [-(-int(s) // self.patch) for s in shape]
        self.products = products
        self.patch_embed = nn.Conv2d(model["in_channels"], dim, self.patch,
                                     stride=self.patch)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, self.grid[0] * self.grid[1], dim))
        self.blocks = nn.ModuleList(
            Block(dim, model["num_heads"], model.get("mlp_ratio", 4))
            for _ in range(model["depth"]))
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.head = nn.Linear(dim, model["num_outputs"])

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) uint8 -> (B, 8, 2) corner pixels."""
        p = self.products
        x = (frames.float() / 255.0).permute(0, 3, 1, 2)
        top, bottom = same_pads(x.shape[2], self.patch, self.patch)
        left, right = same_pads(x.shape[3], self.patch, self.patch)
        x = p.conv(F.pad(x, (left, right, top, bottom)), self.patch_embed,
                   self.patch)
        x = x.flatten(2).transpose(1, 2) + self.pos_embed
        for block in self.blocks:
            x = block(x, p)
        out = self.head(self.norm(x).mean(dim=1))  # the head stays f32
        return out.reshape(-1, 8, 2)
