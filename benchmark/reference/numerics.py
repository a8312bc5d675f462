"""How the plain reference computes its products.

``Numerics()`` is the reference itself: every product in float32 with TF32
off. ``Numerics(fp8=True)`` is the control: the same model with both
operands of every product (linear, convolution, attention scores and
values) rounded to float8 e4m3 under a per-tensor scale first, as an fp8
GEMM takes them, and accumulated in float32. It is the precision below the
bfloat16 the configurations state. The rounding is in the forward only:
a gradient passes through it unrounded (straight through), and the
backward of each product takes the rounded operands its forward took.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


class _RoundE4M3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        scale = x.abs().amax().float().clamp_min(1e-12) / E4M3_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale

    @staticmethod
    def backward(ctx, grad):
        return grad


def to_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under the per-tensor scale amax / 448,
    returned in float32; its gradient passes through unrounded."""
    return _RoundE4M3.apply(x)


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32 (no TF32) inside, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Numerics:
    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def _q(self, x: torch.Tensor) -> torch.Tensor:
        return to_e4m3(x) if self.fp8 else x

    def linear(self, x, weight, bias=None):
        return F.linear(self._q(x), self._q(weight), bias)

    def conv(self, x, conv: torch.nn.Conv2d):
        return F.conv2d(self._q(x), self._q(conv.weight), conv.bias, conv.stride, conv.padding)

    def matmul(self, a, b):
        return self._q(a) @ self._q(b)
