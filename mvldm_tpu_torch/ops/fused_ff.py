"""Fused LayerNorm -> GEGLU feed-forward -> residual:
y = x + W2 (h * gelu_erf(g)) + b2 with [h | g] = LN(x) W1 + b1.

Counterpart of ``mvldm_tpu/ops/fused_ff.py``.

* :func:`fused_ln_geglu_ff_reference` — plain PyTorch, mirroring ``_ff_jnp``:
  f32 LayerNorm (eps 1e-6), LN(x) and act rounded to the input dtype before
  each product, products accumulated in f32, exact-erf GELU.
* :func:`fused_ln_geglu_ff` — CPU tensors take the plain version; CUDA
  tensors take the two kernels of ``csrc/fused_ln_geglu_ff.cu`` (LN + W1
  GEMM with the GEGLU epilogue, then W2 with the bias + residual epilogue),
  or raise; f32 ones the f32 route (``ops/f32_route.fused_ln_geglu_ff_f32``).
  ``fused_ln_geglu_ff.launches`` counts calls that launched the bf16 kernels.
  Differentiable: the backward recomputes through the decomposed path (the
  JAX ``_ff_bwd``); no kernel is involved there.

The JAX gate C * itemsize <= 1280 applies (``fused_attn.use_fused``, used by
``models/layers.ff_block``); at C = 1280 both packages take the decomposed
path.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..utils.profiling import span
from . import _build
from .f32_route import fused_ln_geglu_ff_f32
from .fused_attn import (
    _layer_norm,
    _recompute_grads,
    _torch_layout,
    _vec,
    check_kernel_channels,
)

_SIGNATURES = {
    "mvldm_ff_geglu": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
    + [ctypes.c_float, ctypes.c_void_p],
    "mvldm_ff_out": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
}


def fused_ln_geglu_ff_reference(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                eps: float = 1e-6) -> torch.Tensor:
    """Plain version on (..., L, C) tokens; w1: (C, 8C), w2: (4C, C)."""
    dtype = x.dtype
    xf = x.float()
    xn = _layer_norm(x, ln_scale, ln_bias, eps).to(dtype)
    h = xn.float() @ w1.to(dtype).float() + b1.float()
    a, gate = h.chunk(2, dim=-1)
    act = (a * F.gelu(gate)).to(dtype)
    o = act.float() @ w2.to(dtype).float() + b2.float()
    return (xf + o).to(dtype)


def ln_geglu_ff_decomposed(x, ln_scale, ln_bias, w1, b1, w2, b2,
                           eps: float = 1e-6) -> torch.Tensor:
    """``_ff_jnp``'s counterpart in x's dtype: LayerNorm with f32
    statistics, both products (biases in their epilogue) in that dtype on
    cuBLAS, GEGLU and the residual add in f32. torch rounds each product's
    output to x's dtype where JAX keeps f32, one rounding step more. The
    function the fused block's backward differentiates, and the path
    ``models/layers.ff_block`` takes above the channel gate."""
    dtype = x.dtype
    xn = F.layer_norm(x, (x.shape[-1],), ln_scale.to(dtype), ln_bias.to(dtype), eps)
    h, gate = F.linear(xn, w1.t().to(dtype), b1.to(dtype)).float().chunk(2, dim=-1)
    act = (h * F.gelu(gate)).to(dtype)
    return (x.float() + F.linear(act, w2.t().to(dtype), b2.to(dtype)).float()).to(dtype)


class _FusedLnGegluFF(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w1, b1, w2, b2, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, ln_scale, ln_bias, w1, b1, w2, b2)
        if x.device.type == "cpu":
            return fused_ln_geglu_ff_reference(x, ln_scale, ln_bias, w1, b1, w2, b2, eps)
        return _on_card(x)(x, ln_scale, ln_bias, w1, b1, w2, b2, eps)

    @staticmethod
    def backward(ctx, g):
        eps = ctx.eps
        grads = _recompute_grads(lambda *a: ln_geglu_ff_decomposed(*a, eps), ctx, g)
        return (*grads, None)


@span("ops.fused_ln_geglu_ff")
def fused_ln_geglu_ff(x, ln_scale, ln_bias, w1, b1, w2, b2,
                      eps: float = 1e-6) -> torch.Tensor:
    """x: (..., L, C) -> x + FF(LN(x)), differentiable. w1: (C, 8C), w2:
    (4C, C) in the JAX layout; on the card, transposes of contiguous torch
    Linear weights."""
    args = (x, ln_scale, ln_bias, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _FusedLnGegluFF.apply(*args, eps)
    if x.device.type == "cpu":
        return fused_ln_geglu_ff_reference(*args, eps)
    return _on_card(x)(*args, eps)


def _on_card(x: torch.Tensor):
    """The kernels for ``x``'s dtype on the card: f32 the f32 route
    (``ops/f32_route.py``), every other dtype the bf16 kernels, which refuse
    what they do not take."""
    return fused_ln_geglu_ff_f32 if x.dtype == torch.float32 else _fused_ff_cuda


def _launch_geglu(lib, x, g, b, w1, b1, act, eps: float) -> None:
    """``lib``'s LN + W1 GEMM with the GEGLU epilogue on the current stream
    (no checks, no count): x (..., C) -> act (M, 4C); ``lib`` is a build of
    ``csrc/fused_ln_geglu_ff.cu``."""
    c = x.shape[-1]
    _build.check(lib.mvldm_ff_geglu(
        _build.ptr(x), _build.ptr(g), _build.ptr(b), _build.ptr(w1),
        _build.ptr(b1), _build.ptr(act), act.shape[0], c, act.shape[1], float(eps),
        _build.stream_ptr(x.device)), "mvldm_ff_geglu")


def _launch_ff_out(lib, act, w2, b2, x, y) -> None:
    """``lib``'s W2 GEMM with the + b2 + x epilogue on the current stream."""
    _build.check(lib.mvldm_ff_out(
        _build.ptr(act), _build.ptr(w2), _build.ptr(b2), _build.ptr(x),
        _build.ptr(y), act.shape[0], x.shape[-1], act.shape[1],
        _build.stream_ptr(x.device)), "mvldm_ff_out")


def _fused_ff_cuda(x, ln_scale, ln_bias, w1, b1, w2, b2, eps: float) -> torch.Tensor:
    """The two launches of ``csrc/fused_ln_geglu_ff.cu``."""
    c = x.shape[-1]
    f = 4 * c
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError("fused_ln_geglu_ff: x must be contiguous bfloat16")
    check_kernel_channels(c, "fused_ln_geglu_ff")
    for name, w in (("w1", w1), ("w2", w2)):
        if w.device != x.device:
            raise ValueError(f"fused_ln_geglu_ff: {name} not on {x.device}")
    w1 = _torch_layout(w1, c, 2 * f, "w1")
    w2 = _torch_layout(w2, f, c, "w2")
    g = _vec(ln_scale, c, x.device, "ln_scale")
    b = _vec(ln_bias, c, x.device, "ln_bias")
    b1_32 = _vec(b1, 2 * f, x.device, "b1")
    b2_32 = _vec(b2, c, x.device, "b2")
    lib = _build.load("fused_ln_geglu_ff", _SIGNATURES)
    act = torch.empty((x.numel() // c, f), dtype=x.dtype, device=x.device)
    _launch_geglu(lib, x, g, b, w1, b1_32, act, eps)
    y = torch.empty_like(x)
    _launch_ff_out(lib, act, w2, b2_32, x, y)
    fused_ln_geglu_ff.launches += 1
    return y


fused_ln_geglu_ff.launches = 0
