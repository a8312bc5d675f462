"""The f32 route of the main path's kernels: f32 tensors on the card.

The JAX package runs its Pallas kernels in f32 too, and f32 is its default
precision (``trainer.precision: null``). The bf16 kernels take bf16 only, so
the dispatchers (``attention``, ``fused_ln_self_attention``,
``fused_ln_geglu_ff`` and their autograd Functions) hand f32 tensors on the
card to the wrappers here, which launch the hand-written kernels of
``csrc/f32_route.cu`` (the forward at head dims up to 160 and the backward
on the tensor cores as split TF32, three TF32 products for each f32 one;
the forward at head dims 161-512, LayerNorm, GEMM and GEGLU on FFMA);
bf16 goes to the bf16 kernels as before. The choice is by dtype, made before any launch;
nothing is caught to fall back.

* :func:`flash_attention_f32` — forward, optional f32 lse; head dims up to
  512, multiples of 4.
* :func:`flash_attention_bwd_f32` — dQ (with delta) then dK / dV / dbias;
  head dims up to 160, multiples of 4.
* :func:`fused_ln_self_attention_f32` — LayerNorm, the q/k/v projections
  written head-split, the flash forward, the head-merging output projection
  with + b_o + x.
* :func:`fused_ln_geglu_ff_f32` — LayerNorm, W1 + b1, GEGLU, W2 + b2 + x.

Each counts its calls in ``<wrapper>.launches``. Weights are in the JAX
layout ((C, H*D) etc.), as transposes of contiguous torch Linear weights.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "mvldm_f32_flash_fwd": [_P] * 6 + [_I] * 5 + [_F, _P],
    "mvldm_f32_flash_fwd_smem": [_I, _I, _P],
    "mvldm_f32_flash_bwd_dq": [_P] * 9 + [_I] * 5 + [_F, _P],
    "mvldm_f32_flash_bwd_dkv": [_P] * 10 + [_I] * 5 + [_F, _P],
    "mvldm_f32_flash_bwd_smem": [_I, _P, _P],
    "mvldm_f32_layer_norm": [_P] * 4 + [_I] * 2 + [_F, _P],
    "mvldm_f32_gemm": [_P] * 5 + [_I] * 7 + [_P],
    "mvldm_f32_geglu": [_P] * 2 + [ctypes.c_longlong, _I, _P],
}
MAX_FWD_HEAD_DIM = 512
MAX_BWD_HEAD_DIM = 160


def _lib():
    return _build.load("f32_route", _SIGNATURES)


def _optr(t: Optional[torch.Tensor]):
    return None if t is None else _build.ptr(t)


def _check(what: str, ref: torch.Tensor, **tensors) -> None:
    """f32, contiguous, 16-byte aligned, on ``ref``'s CUDA device."""
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != ref.device:
            raise ValueError(f"{what}: {name} must be on {ref.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and 16-byte aligned")


def _check_qkv(what: str, q, k, v, bias, max_d: int) -> None:
    _check(what, q, q=q, k=k, v=v)
    if q.dim() != 4:
        raise ValueError(f"{what}: q must be (B, H, L, D)")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.dim() != 4 or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"{what}: shapes {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if d % 4 or d > max_d:
        raise ValueError(f"{what}: head dim {d} must be a multiple of 4, <= {max_d}")
    if bias is not None:
        _check(what, q, bias=bias)
        if bias.shape != (b, k.shape[2]):
            raise ValueError(f"{what}: bias must be (B, Lk), got {tuple(bias.shape)}")


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def _launch_fwd(q, k, v, bias, out, lse, scale: float, lib=None) -> None:
    """The forward kernel of ``lib`` (a build of ``csrc/f32_route.cu``, this
    tree's by default) on checked inputs, writing ``out`` and, if not None,
    ``lse``."""
    b, h, lq, d = q.shape
    _build.check((lib or _lib()).mvldm_f32_flash_fwd(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _optr(bias), _build.ptr(out), _optr(lse),
        b, h, lq, k.shape[2], d, float(scale), _build.stream_ptr(q.device)),
        f"mvldm_f32_flash_fwd (head dim {d})")


def flash_attention_f32(q, k, v, bias=None, scale=None, return_lse: bool = False):
    """softmax(scale q k^T + bias) v in f32 on the card: q (B, H, Lq, D), k/v
    (B, H, Lk, D), bias optional (B, Lk), all contiguous f32. With
    ``return_lse`` returns (out, lse), lse (B, H, Lq) of the scaled, biased
    logits."""
    what = "flash_attention_f32"
    _check_qkv(what, q, k, v, bias, MAX_FWD_HEAD_DIM)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device) if return_lse else None
    _launch_fwd(q, k, v, bias, out, lse, _scale(q, scale))
    flash_attention_f32.launches += 1
    return (out, lse) if return_lse else out


def _launch_bwd_dq(lib, q, k, v, out, lse, g, bias, dq, delta, scale: float) -> None:
    """The dQ kernel of ``lib`` (a build of ``csrc/f32_route.cu``) on
    checked inputs, writing ``dq`` and ``delta``."""
    b, h, lq, d = q.shape
    _build.check(lib.mvldm_f32_flash_bwd_dq(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out), _build.ptr(g),
        _build.ptr(lse), _optr(bias), _build.ptr(delta), _build.ptr(dq), b, h, lq, k.shape[2],
        d, float(scale), _build.stream_ptr(q.device)), f"mvldm_f32_flash_bwd_dq (head dim {d})")


def _launch_bwd_dkv(lib, q, k, v, g, lse, delta, bias, dk, dv, dbias, scale: float) -> None:
    """The dK/dV kernel of ``lib`` on checked inputs and the dQ kernel's
    ``delta``, writing ``dk``, ``dv`` and (if not None) the per-head
    ``dbias``."""
    b, h, lq, d = q.shape
    _build.check(lib.mvldm_f32_flash_bwd_dkv(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(g), _build.ptr(lse),
        _build.ptr(delta), _optr(bias), _build.ptr(dk), _build.ptr(dv), _optr(dbias),
        b, h, lq, k.shape[2], d, float(scale), _build.stream_ptr(q.device)),
        f"mvldm_f32_flash_bwd_dkv (head dim {d})")


def _launch_bwd(lib, q, k, v, bias, out, lse, g, scale: float, need_dbias: bool):
    """Both backward kernels of ``lib`` on checked inputs: (dq, dk, dv,
    dbias), dbias per head (B, H, Lk) or None."""
    dq, delta = torch.empty_like(q), torch.empty_like(lse)
    _launch_bwd_dq(lib, q, k, v, out, lse, g, bias, dq, delta, scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dbias = (torch.empty(k.shape[:3], dtype=torch.float32, device=q.device)
             if bias is not None and need_dbias else None)
    _launch_bwd_dkv(lib, q, k, v, g, lse, delta, bias, dk, dv, dbias, scale)
    return dq, dk, dv, dbias


def fwd_smem_bytes(lq: int, d: int) -> int:
    """The dynamic shared memory (bytes) of the forward's instance for ``lq``
    queries of head dim ``d`` (builds the library)."""
    smem = ctypes.c_int()
    _build.check(_lib().mvldm_f32_flash_fwd_smem(lq, d, ctypes.byref(smem)),
                 f"mvldm_f32_flash_fwd_smem (Lq {lq}, head dim {d})")
    return smem.value


def bwd_smem_bytes(d: int) -> dict:
    """The dynamic shared memory (bytes) of the backward kernels' instance
    for head dim ``d``: {"dq": ..., "dkv": ...} (builds the library)."""
    dq, dkv = ctypes.c_int(), ctypes.c_int()
    _build.check(_lib().mvldm_f32_flash_bwd_smem(d, ctypes.byref(dq), ctypes.byref(dkv)),
                 f"mvldm_f32_flash_bwd_smem (head dim {d})")
    return {"dq": dq.value, "dkv": dkv.value}


def flash_attention_bwd_f32(q, k, v, bias, out, lse, g, scale=None, need_dbias: bool = True):
    """Both backward kernels in f32: (dq, dk, dv, dbias), dbias (B, Lk)
    summed over heads (None without a bias or when not asked for)."""
    what = "flash_attention_bwd_f32"
    _check_qkv(what, q, k, v, bias, MAX_BWD_HEAD_DIM)
    _check(what, q, out=out, lse=lse, g=g)
    if out.shape != q.shape or g.shape != q.shape or lse.shape != q.shape[:3]:
        raise ValueError(f"{what}: out / g must be like q and lse (B, H, Lq)")
    dq, dk, dv, dbias = _launch_bwd(_lib(), q, k, v, bias, out, lse, g, _scale(q, scale),
                                    need_dbias)
    flash_attention_bwd_f32.launches += 1
    return dq, dk, dv, None if dbias is None else dbias.sum(dim=1)


def _linear_t(w: torch.Tensor, rows: int, cols: int, name: str, what: str) -> torch.Tensor:
    """A (rows, cols) operand given as the transpose of a contiguous torch
    Linear weight: returns that weight, (cols, rows) row-major."""
    if w.shape != (rows, cols) or w.dtype != torch.float32:
        raise ValueError(f"{what}: {name}: expected f32 ({rows}, {cols}), "
                         f"got {w.dtype} {tuple(w.shape)}")
    if not w.t().is_contiguous():
        raise ValueError(f"{what}: {name}: expected the transpose of a contiguous tensor "
                         "(a torch Linear weight's .t())")
    return w.t()


def _vec(t: torch.Tensor, n: int, device, name: str, what: str) -> torch.Tensor:
    if t.shape != (n,) or t.device != device:
        raise ValueError(f"{what}: {name}: expected ({n},) on {device}")
    return t.float().contiguous()


def _layer_norm(lib, x, g, b, y, eps: float) -> None:
    c = x.shape[-1]
    _build.check(lib.mvldm_f32_layer_norm(
        _build.ptr(x), _build.ptr(g), _build.ptr(b), _build.ptr(y), x.numel() // c, c,
        float(eps), _build.stream_ptr(x.device)), "mvldm_f32_layer_norm")


def _gemm(lib, a, w, out, bias=None, res=None, a_heads: int = 0, out_heads: int = 0,
          l: int = 0, d: int = 0) -> None:
    """out (M, N) = a (M, K) w^T (+ bias) (+ res); w (N, K) row-major. With
    ``a_heads`` / ``out_heads`` that operand is (M / l, heads, l, d)."""
    n, k = w.shape
    if any(t is not None and t.data_ptr() % 16 for t in (a, w, out, bias, res)):
        raise ValueError("mvldm_f32_gemm: operands must be 16-byte aligned")
    _build.check(lib.mvldm_f32_gemm(
        _build.ptr(a), _build.ptr(w), _optr(bias), _optr(res), _build.ptr(out),
        a.numel() // k, n, k, a_heads, out_heads, l, d, _build.stream_ptr(a.device)),
        "mvldm_f32_gemm")


def _check_block(what: str, x, weights) -> int:
    _check(what, x, x=x)
    c = x.shape[-1]
    if c % 4:
        raise ValueError(f"{what}: C must be a multiple of 4, got {c}")
    for name, w in weights:
        if w.device != x.device:
            raise ValueError(f"{what}: {name} not on {x.device}")
    return c


def fused_ln_self_attention_f32(x, ln_scale, ln_bias, wq, wk, wv, wo, bo, num_heads: int,
                                head_dim: int, eps: float = 1e-6) -> torch.Tensor:
    """x (..., L, C) -> x + W_o MHA(LN(x)) + b_o in f32 on the card."""
    what = "fused_ln_self_attention_f32"
    c = _check_block(what, x, (("wq", wq), ("wk", wk), ("wv", wv), ("wo", wo)))
    hd = num_heads * head_dim
    if head_dim % 4 or head_dim > MAX_FWD_HEAD_DIM:
        raise ValueError(f"{what}: head_dim {head_dim} must be a multiple of 4, <= 512")
    ws = [_linear_t(w, c, hd, name, what) for w, name in ((wq, "wq"), (wk, "wk"), (wv, "wv"))]
    wo_t = _linear_t(wo, hd, c, "wo", what)
    g = _vec(ln_scale, c, x.device, "ln_scale", what)
    b = _vec(ln_bias, c, x.device, "ln_bias", what)
    bo32 = _vec(bo, c, x.device, "bo", what)
    l = x.shape[-2]
    n = x.numel() // (c * l)
    lib = _lib()
    xn = torch.empty_like(x)
    _layer_norm(lib, x, g, b, xn, eps)
    q, k, v = (torch.empty((n, num_heads, l, head_dim), dtype=x.dtype, device=x.device)
               for _ in range(3))
    for w, out in zip(ws, (q, k, v)):
        _gemm(lib, xn, w, out, out_heads=num_heads, l=l, d=head_dim)
    o = torch.empty_like(q)
    _launch_fwd(q, k, v, None, o, None, 1.0 / math.sqrt(head_dim))
    y = torch.empty_like(x)
    _gemm(lib, o, wo_t, y, bias=bo32, res=x, a_heads=num_heads, l=l, d=head_dim)
    fused_ln_self_attention_f32.launches += 1
    return y


def fused_ln_geglu_ff_f32(x, ln_scale, ln_bias, w1, b1, w2, b2,
                          eps: float = 1e-6) -> torch.Tensor:
    """x (..., C) -> x + W2 (h * gelu_erf(g)) + b2, [h | g] = LN(x) W1 + b1,
    in f32 on the card; w1 (C, 8C), w2 (4C, C)."""
    what = "fused_ln_geglu_ff_f32"
    c = _check_block(what, x, (("w1", w1), ("w2", w2)))
    f = 4 * c
    w1_t = _linear_t(w1, c, 2 * f, "w1", what)
    w2_t = _linear_t(w2, f, c, "w2", what)
    g = _vec(ln_scale, c, x.device, "ln_scale", what)
    b = _vec(ln_bias, c, x.device, "ln_bias", what)
    b1_32 = _vec(b1, 2 * f, x.device, "b1", what)
    b2_32 = _vec(b2, c, x.device, "b2", what)
    m = x.numel() // c
    lib = _lib()
    xn = torch.empty_like(x)
    _layer_norm(lib, x, g, b, xn, eps)
    h = torch.empty((m, 2 * f), dtype=x.dtype, device=x.device)
    _gemm(lib, xn, w1_t, h, bias=b1_32)
    act = torch.empty((m, f), dtype=x.dtype, device=x.device)
    _build.check(lib.mvldm_f32_geglu(_build.ptr(h), _build.ptr(act), m, f,
                                     _build.stream_ptr(x.device)), "mvldm_f32_geglu")
    y = torch.empty_like(x)
    _gemm(lib, act, w2_t, y, bias=b2_32, res=x)
    fused_ln_geglu_ff_f32.launches += 1
    return y


flash_attention_f32.launches = 0
flash_attention_bwd_f32.launches = 0
fused_ln_self_attention_f32.launches = 0
fused_ln_geglu_ff_f32.launches = 0
KERNELS = (flash_attention_f32, flash_attention_bwd_f32, fused_ln_self_attention_f32,
           fused_ln_geglu_ff_f32)
