"""What every plain reference model shares: the precision of its products,
the corner loss and AdamW, in plain PyTorch.

The reference runs in float32 with TF32 off (:func:`exact_matmuls`). Its
control is the same reference one precision step below the
configuration's bf16 products, in the usual float8 training recipe
(:class:`Products`): each product that the program computes in bf16
takes both forward operands in float8 e4m3 and, in the backward pass,
the gradient of its output in float8 e5m2, each with one scale per tensor
(its largest magnitude at the format's largest finite value), the product
itself in f32.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0  # the largest finite float8 e4m3 value
E5M2_MAX = 57344.0  # and e5m2's


@contextlib.contextmanager
def exact_matmuls():
    """float32 products in float32: TF32 off for matmuls and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _round(x: torch.Tensor, dtype, largest: float) -> torch.Tensor:
    """``x`` rounded to ``dtype`` under one scale per tensor, back in f32."""
    scale = largest / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).float() / scale


class _E4M3(torch.autograd.Function):
    """Forward operand in e4m3; its gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, grad):
        return grad


class _E5M2Grad(torch.autograd.Function):
    """Identity forward; the gradient arriving here in e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, torch.float8_e5m2, E5M2_MAX)


class Products:
    """The products the configuration computes in bf16: ``"f32"`` as they
    are, ``"fp8"`` (the control) with float8 operands forward (e4m3) and
    backward (e5m2)."""

    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"unknown reference precision {precision!r}")
        self.fp8 = precision == "fp8"

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """A forward operand."""
        return _E4M3.apply(x) if self.fp8 else x

    def out(self, y: torch.Tensor) -> torch.Tensor:
        """A product's output, whose gradient the backward products take."""
        return _E5M2Grad.apply(y) if self.fp8 else y

    def matmul(self, a, b) -> torch.Tensor:
        return self.out(self(a) @ self(b))

    def linear(self, x, layer) -> torch.Tensor:
        return self.out(F.linear(self(x), self(layer.weight), layer.bias))

    def conv(self, x, layer, stride: int) -> torch.Tensor:
        return self.out(F.conv2d(self(x), self(layer.weight), layer.bias,
                                 stride=stride))


def same_pads(size: int, kernel: int, stride: int) -> tuple:
    """(before, after) padding of a 'SAME' convolution along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def corner_loss(pred: torch.Tensor, xy: torch.Tensor, h: int, w: int):
    """Mean squared error of the predicted corners (B, 8, 2) in pixels,
    each coordinate divided by the frame's width or height first."""
    scale = torch.tensor([1.0 / w, 1.0 / h], device=pred.device)
    return ((pred * scale - xy * scale) ** 2).mean()


class AdamW:
    """Decoupled weight decay Adam (Loshchilov and Hutter), written out:
    ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``,
    ``p *= 1 - lr wd``, ``p -= lr (m / (1 - b1^t)) / (sqrt(v / (1 -
    b2^t)) + eps)``."""

    def __init__(self, params: dict, lr: float, betas, eps: float,
                 weight_decay: float):
        self.params = params
        self.lr, self.eps, self.wd = float(lr), float(eps), float(weight_decay)
        self.b1, self.b2 = (float(b) for b in betas)
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.mul_(1.0 - self.lr * self.wd)
            denom = (self.v[k] / c2).sqrt_().add_(self.eps)
            p.addcdiv_(self.m[k] / c1, denom, value=-self.lr)
