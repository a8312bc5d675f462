"""Fused LayerNorm -> multi-head self-attention -> output projection ->
residual: y = x + W_o MHA(LN(x)) + b_o.

Counterpart of ``mvldm_tpu/ops/fused_attn.py``. The weights are the
unpadded (C, H*D) q/k/v and (H*D, C) output projections; the TPU's 128-lane
``pad_heads`` layout is not carried over.

* :func:`fused_ln_self_attention_reference` — plain PyTorch, mirroring the
  JAX decomposed path ``_attn_jnp``: f32 LayerNorm (eps 1e-6) rounded to the
  input dtype, bias-free q/k/v projections in that dtype, f32-softmax
  attention, the output projection accumulated in f32, + b_o + x.
* :func:`fused_ln_self_attention` — CPU tensors take the plain version; CUDA
  tensors take the kernels of ``csrc/fused_ln_attn.cu`` (LN + QKV GEMM with
  the scale folded into q, then the flash kernel, then the out-projection
  with the bias + residual epilogue), or raise; f32 ones the f32 route
  (``ops/f32_route.fused_ln_self_attention_f32``).
  ``fused_ln_self_attention.launches`` counts calls that launched the bf16
  kernels.
  Differentiable: the backward recomputes through the decomposed path
  (the JAX ``_attn_bwd``), whose attention core is ``attention``'s
  autograd Function, so on the card its backward is the flash backward
  kernels.

``MAX_FUSED_CHANNEL_BYTES`` is the JAX package's gate (C * itemsize <= 1280),
kept so both packages take the same path per layer (see
``models/layers.self_attn_block``). It is a fact of the TPU's 16 MB VMEM;
on Hopper the LN-prologue GEMM keeps a 128-row block of LN(x) in shared
memory, so the kernels take C <= ``MAX_KERNEL_CHANNELS`` (the same 640) and
a CUDA call above it raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..utils.profiling import span
from . import _build
from .attention import _launch_flash, attention, attention_reference
from .f32_route import fused_ln_self_attention_f32

MAX_FUSED_CHANNEL_BYTES = 640 * 2
MAX_KERNEL_CHANNELS = 640  # csrc/gemm_tile.cuh kMaxLnK: 128 rows of LN(x) resident

_SIGNATURES = {
    "mvldm_ln_qkv": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p],
    "mvldm_attn_out_proj": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
    + [ctypes.c_void_p],
}


def use_fused(c: int, dtype: torch.dtype) -> bool:
    """The JAX package's VMEM gate on channel bytes."""
    return c * dtype.itemsize <= MAX_FUSED_CHANNEL_BYTES


def _layer_norm(x: torch.Tensor, scale, bias, eps: float) -> torch.Tensor:
    """LayerNorm in f32 (biased variance), f32 result."""
    return F.layer_norm(x.float(), (x.shape[-1],), scale.float(), bias.float(), eps)


def fused_ln_self_attention_reference(x, ln_scale, ln_bias, wq, wk, wv, wo, bo,
                                      num_heads: int, head_dim: int,
                                      eps: float = 1e-6) -> torch.Tensor:
    """Plain version on (..., L, C) tokens; mirrors ``_attn_jnp``."""
    shape = x.shape
    dtype = x.dtype
    x3 = x.reshape(-1, shape[-2], shape[-1])
    n, l, _ = x3.shape
    xf = x3.float()
    xn = _layer_norm(x3, ln_scale, ln_bias, eps).to(dtype)

    def heads(w):
        return (xn @ w.to(dtype)).reshape(n, l, num_heads, head_dim).transpose(1, 2)

    o = attention_reference(heads(wq), heads(wk), heads(wv),
                            scale=1.0 / head_dim ** 0.5)
    o = o.transpose(1, 2).reshape(n, l, num_heads * head_dim)
    y = o.float() @ wo.to(dtype).float() + bo.float()
    return (xf + y).to(dtype).reshape(shape)


def _torch_layout(w: torch.Tensor, rows: int, cols: int, name: str) -> torch.Tensor:
    """The kernels read a (rows, cols) operand from its transpose stored
    row-major, the layout of a torch Linear weight (``linear.weight.t()``)."""
    if w.shape != (rows, cols) or w.dtype != torch.bfloat16:
        raise ValueError(f"{name}: expected bf16 ({rows}, {cols}), got {w.dtype} {tuple(w.shape)}")
    if not w.t().is_contiguous():
        raise ValueError(f"{name}: expected the transpose of a contiguous tensor "
                         "(a torch Linear weight's .t())")
    return w


def _vec(t: torch.Tensor, n: int, device, name: str) -> torch.Tensor:
    if t.shape != (n,) or t.device != device:
        raise ValueError(f"{name}: expected ({n},) on {device}")
    return t.float().contiguous()


def _attn_decomposed(x, ln_scale, ln_bias, wq, wk, wv, wo, bo, num_heads: int,
                     head_dim: int, eps: float) -> torch.Tensor:
    """The function the backward differentiates, ``_attn_jnp``'s
    counterpart: products in x's dtype (on the card, bf16 cuBLAS), the
    attention core through the differentiable dispatcher."""
    shape = x.shape
    dtype = x.dtype
    x3 = x.reshape(-1, shape[-2], shape[-1])
    n, l, _ = x3.shape
    xn = _layer_norm(x3, ln_scale, ln_bias, eps).to(dtype)

    def heads(w):
        h = (xn @ w.to(dtype)).reshape(n, l, num_heads, head_dim)
        return h.transpose(1, 2).contiguous()

    o = attention(heads(wq), heads(wk), heads(wv), scale=1.0 / head_dim ** 0.5)
    o = o.transpose(1, 2).reshape(n, l, num_heads * head_dim)
    y = (o @ wo.to(dtype)).float() + bo.float()
    return (x3.float() + y).to(dtype).reshape(shape)


def _recompute_grads(fn, ctx, g):
    """Gradients of ``fn(*saved)`` for the inputs that need them, by
    recomputing ``fn`` under autograd (the JAX ``jax.vjp`` of the decomposed
    path)."""
    inputs = [t.detach().requires_grad_(need)
              for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
    with torch.enable_grad():
        y = fn(*inputs)
    wanted = [t for t in inputs if t.requires_grad]
    grads = iter(torch.autograd.grad(y, wanted, g, allow_unused=True))
    return tuple(next(grads) if t.requires_grad else None for t in inputs)


class _FusedLnSelfAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, wq, wk, wv, wo, bo, num_heads,
                head_dim, eps):
        ctx.cfg = (num_heads, head_dim, eps)
        ctx.save_for_backward(x, ln_scale, ln_bias, wq, wk, wv, wo, bo)
        if x.device.type == "cpu":
            return fused_ln_self_attention_reference(
                x, ln_scale, ln_bias, wq, wk, wv, wo, bo, num_heads, head_dim, eps)
        return _on_card(x)(x, ln_scale, ln_bias, wq, wk, wv, wo, bo,
                           num_heads, head_dim, eps)

    @staticmethod
    def backward(ctx, g):
        num_heads, head_dim, eps = ctx.cfg
        grads = _recompute_grads(
            lambda *a: _attn_decomposed(*a, num_heads, head_dim, eps), ctx, g)
        return (*grads, None, None, None)


@span("ops.fused_ln_self_attention")
def fused_ln_self_attention(x, ln_scale, ln_bias, wq, wk, wv, wo, bo,
                            num_heads: int, head_dim: int,
                            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., L, C) -> x + W_o MHA(LN(x)) + b_o, differentiable.

    wq/wk/wv: (C, H*D) and wo: (H*D, C) in the JAX layout. On the card they
    must be the transposes of contiguous torch Linear weights."""
    args = (x, ln_scale, ln_bias, wq, wk, wv, wo, bo)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _FusedLnSelfAttention.apply(*args, num_heads, head_dim, eps)
    if x.device.type == "cpu":
        return fused_ln_self_attention_reference(*args, num_heads, head_dim, eps)
    return _on_card(x)(*args, num_heads, head_dim, eps)


def _on_card(x: torch.Tensor):
    """The kernels for ``x``'s dtype on the card: f32 the f32 route
    (``ops/f32_route.py``), every other dtype the bf16 kernels, which refuse
    what they do not take. A choice by dtype; nothing is caught to fall
    back."""
    return fused_ln_self_attention_f32 if x.dtype == torch.float32 else _fused_attn_cuda


def check_kernel_channels(c: int, what: str) -> None:
    """The LN-prologue kernels take C % 8 == 0 and C <= MAX_KERNEL_CHANNELS."""
    if c % 8 or c > MAX_KERNEL_CHANNELS:
        raise ValueError(f"{what}: the kernels take C % 8 == 0 and C <= "
                         f"{MAX_KERNEL_CHANNELS} (got C = {c})")


def _launch_ln_qkv(lib, x, g, b, wq, wk, wv, q, k, v, eps: float) -> None:
    """``lib``'s LN + QKV GEMM on the current stream (no checks, no count):
    x (N, L, C) -> q, k, v (N, H, L, D), the softmax scale folded into q;
    ``lib`` is a build of ``csrc/fused_ln_attn.cu``."""
    n, heads, l, d = q.shape
    c = x.shape[-1]
    _build.check(lib.mvldm_ln_qkv(
        _build.ptr(x), _build.ptr(g), _build.ptr(b), _build.ptr(wq),
        _build.ptr(wk), _build.ptr(wv), _build.ptr(q), _build.ptr(k),
        _build.ptr(v), n * l, c, heads * d, heads, l, d, float(eps),
        1.0 / d ** 0.5, _build.stream_ptr(x.device)), "mvldm_ln_qkv")


def _launch_out_proj(lib, o, wo, bo, x, y) -> None:
    """``lib``'s head-merging output projection with the + b_o + x
    epilogue on the current stream: o (N, H, L, D) -> y (N, L, C)."""
    n, heads, l, d = o.shape
    c = x.shape[-1]
    _build.check(lib.mvldm_attn_out_proj(
        _build.ptr(o), _build.ptr(wo), _build.ptr(bo), _build.ptr(x),
        _build.ptr(y), n * l, c, heads * d, heads, l, d, _build.stream_ptr(x.device)),
        "mvldm_attn_out_proj")


def _fused_attn_cuda(x, ln_scale, ln_bias, wq, wk, wv, wo, bo, num_heads: int,
                     head_dim: int, eps: float) -> torch.Tensor:
    """The three launches of ``csrc/fused_ln_attn.cu`` and the flash core."""
    shape = x.shape
    c = shape[-1]
    l = shape[-2]
    hd = num_heads * head_dim
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError("fused_ln_self_attention: x must be contiguous bfloat16")
    check_kernel_channels(c, "fused_ln_self_attention")
    if head_dim % 8:
        raise ValueError("fused_ln_self_attention: head_dim must be a multiple of 8")
    for name, w in (("wq", wq), ("wk", wk), ("wv", wv), ("wo", wo)):
        if w.device != x.device:
            raise ValueError(f"fused_ln_self_attention: {name} not on {x.device}")
    wq, wk, wv = (_torch_layout(w, c, hd, n) for w, n in ((wq, "wq"), (wk, "wk"), (wv, "wv")))
    wo = _torch_layout(wo, hd, c, "wo")
    g = _vec(ln_scale, c, x.device, "ln_scale")
    b = _vec(ln_bias, c, x.device, "ln_bias")
    bo32 = _vec(bo, c, x.device, "bo")
    n = x.numel() // (c * l)
    lib = _build.load("fused_ln_attn", _SIGNATURES)
    q = torch.empty((n, num_heads, l, head_dim), dtype=x.dtype, device=x.device)
    k = torch.empty_like(q)
    v = torch.empty_like(q)
    _launch_ln_qkv(lib, x, g, b, wq, wk, wv, q, k, v, eps)
    o = torch.empty_like(q)
    _launch_flash(q, k, v, None, o, 1.0)  # scale already folded into q
    y = torch.empty_like(x)
    _launch_out_proj(lib, o, wo, bo32, x, y)
    fused_ln_self_attention.launches += 1
    return y


fused_ln_self_attention.launches = 0
