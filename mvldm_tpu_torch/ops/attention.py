"""Multi-head attention: plain versions, CUDA kernel wrappers, autograd.

Counterpart of ``mvldm_tpu/ops/attention.py``.

* :func:`attention_reference` — plain PyTorch, the counterpart of
  ``mha_reference``: f32 softmax statistics whatever the input dtype, and an
  optional additive (B, Lk) key bias broadcast over heads and queries.
  :func:`attention_reference_lse` also returns the f32 row log-sum-exp.
* :func:`attention_bwd_reference` — plain PyTorch backward, the port of the
  JAX package's query-chunked XLA backward (``_attention_bwd``, chunks of
  1024 queries, f32, exact).
* :func:`flash_attention` — the hand-written Hopper forward in
  ``csrc/flash_attn_fwd.cu`` (replaces the TPU's ``_flash_kernel``): bf16
  q/k/v on the card, online softmax in f32, ragged lengths masked in the
  kernel; with ``return_lse`` it also writes the f32 (B, H, Lq) row
  log-sum-exp.
* :func:`flash_attention_bwd_dq` / :func:`flash_attention_bwd_dkv` — the
  hand-written backward kernels of ``csrc/flash_attn_bwd.cu`` (replace
  ``_flash_bwd_dq_kernel`` / ``_flash_bwd_dkv_kernel``);
  :func:`flash_attention_bwd` runs both.
* :func:`attention` — the differentiable dispatcher (the counterpart of the
  JAX custom VJP): CPU tensors take the plain versions, CUDA tensors the
  kernels for their dtype: f32 the f32 route (``ops/f32_route.py``), any
  other dtype the bf16 kernels above, which raise on what they do not take.
* :func:`text_cross_attention` — the same dispatcher on text keys, the
  entry of the text cross-attention (no counterpart in the JAX package).

Each kernel wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ..utils.profiling import span
from . import _build
from .f32_route import flash_attention_bwd_f32, flash_attention_f32

NEG_INF = -1e30  # large finite negative; -inf breaks exp(m_prev - m_new) warm-up
BWD_CHUNK = 1024  # query rows per chunk of the plain backward (JAX ``_BWD_CHUNK``)

_FWD_SIGNATURES = {
    "mvldm_flash_attn_fwd": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_void_p],
}
_BWD_SIGNATURES = {
    "mvldm_flash_attn_bwd_dq": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_void_p],
    "mvldm_flash_attn_bwd_dkv": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_void_p],
}


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def _logits(q, k, bias, scale: float) -> torch.Tensor:
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()[:, None, None, :]
    return s


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain attention. q/k/v: (B, H, Lq/Lk, D); bias: (B, Lk) additive."""
    p = torch.softmax(_logits(q, k, bias, _scale(q, scale)), dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)


def attention_reference_lse(q, k, v, bias=None, scale=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain attention and the f32 (B, H, Lq) row log-sum-exp of the scaled
    and biased logits (the JAX kernel's ``return_lse`` output, squeezed)."""
    s = _logits(q, k, bias, _scale(q, scale))
    lse = torch.logsumexp(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", torch.exp(s - lse[..., None]), v.float())
    return out.to(q.dtype), lse


def attention_bwd_reference(q, k, v, bias, g, scale=None, chunk: int = BWD_CHUNK):
    """Plain backward of :func:`attention_reference`: (dq, dk, dv, dbias),
    dbias (B, Lk) summed over heads and queries, None without a bias.

    The port of the JAX package's XLA backward: softmax recomputed per chunk
    of ``chunk`` query rows in f32 (the statistics are per row, so chunking
    is exact); dk, dv and dbias accumulate over chunks in f32."""
    scale = _scale(q, scale)
    kf, vf = k.float(), v.float()
    bf = None if bias is None else bias.float()[:, None, None, :]
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    db = None if bias is None else torch.zeros(bias.shape, dtype=torch.float32,
                                               device=bias.device)
    dqs = []
    for c0 in range(0, q.shape[2], chunk):
        qc = q[:, :, c0:c0 + chunk].float()
        gc = g[:, :, c0:c0 + chunk].float()
        s = torch.einsum("bhqd,bhkd->bhqk", qc, kf) * scale
        if bf is not None:
            s = s + bf
        p = torch.softmax(s, dim=-1)
        dv += torch.einsum("bhqk,bhqd->bhkd", p, gc)
        dp = torch.einsum("bhqd,bhkd->bhqk", gc, vf)
        ds = p * (dp - (dp * p).sum(-1, keepdim=True))
        dqs.append(torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale)
        dk += torch.einsum("bhqk,bhqd->bhkd", ds, qc) * scale
        if db is not None:
            db += ds.sum(dim=(1, 2))
    dq = torch.cat(dqs, dim=2)
    dbias = None if db is None else db.to(bias.dtype)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


def _check_cuda(what: str, ref: torch.Tensor, **tensors) -> None:
    """bf16, contiguous, 4-D, on ``ref``'s CUDA device."""
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != ref.device:
            raise ValueError(f"{what}: {name} must be on {ref.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{what}: {name} must be bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.dim() != 4:
            raise ValueError(f"{what}: {name} must be (B, H, L, D)")


def _check_cuda_qkv(q, k, v, bias, what: str = "flash_attention"):
    _check_cuda(what, q, q=q, k=k, v=v)
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"{what}: shapes {q.shape} {k.shape} {v.shape}")
    if d % 8 != 0:
        raise ValueError(f"{what}: head dim {d} is not a multiple of 8")
    if bias is not None:
        if bias.device != q.device or bias.dtype != torch.float32:
            raise TypeError(f"{what}: bias must be float32 on q's device")
        if bias.shape != (b, k.shape[2]) or not bias.is_contiguous():
            raise ValueError(f"{what}: bias must be contiguous (B, Lk), got {tuple(bias.shape)}")


def _f32_rows(t: torch.Tensor, q: torch.Tensor, name: str, what: str) -> None:
    if t.dtype != torch.float32 or t.device != q.device or not t.is_contiguous():
        raise TypeError(f"{what}: {name} must be contiguous float32 on {q.device}")
    if t.shape != q.shape[:3]:
        raise ValueError(f"{what}: {name} must be (B, H, Lq), got {tuple(t.shape)}")


def _optr(t: Optional[torch.Tensor]):
    return None if t is None else _build.ptr(t)


def _launch_flash(q, k, v, bias, out, scale: float, lse=None, lib=None) -> None:
    """Launch the forward kernel on the current stream (no checks, no
    count); ``lib`` is a build of ``csrc/flash_attn_fwd.cu``, this tree's
    by default."""
    lib = lib or _build.load("flash_attn_fwd", _FWD_SIGNATURES)
    b, h, lq, d = q.shape
    err = lib.mvldm_flash_attn_fwd(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _optr(bias),
        _build.ptr(out), _optr(lse), b, h, lq, k.shape[2], d, float(scale),
        _build.stream_ptr(q.device),
    )
    _build.check(err, f"mvldm_flash_attn_fwd (head dim {d})")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """Hopper flash attention forward. q: (B, H, Lq, D); k/v: (B, H, Lk, D),
    bf16, contiguous, on one CUDA device; bias: optional f32 (B, Lk). With
    ``return_lse`` returns (out, lse), lse f32 (B, H, Lq); head dims up to
    160 only (the VAE's 512-wide head is forward-only)."""
    _check_cuda_qkv(q, k, v, bias)
    if return_lse and q.shape[-1] > 160:
        raise ValueError(f"flash_attention: no lse output at head dim {q.shape[-1]}")
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device) if return_lse else None
    _launch_flash(q, k, v, bias, out, _scale(q, scale), lse)
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0


def _check_bwd(q, k, v, bias, lse, g, what):
    _check_cuda_qkv(q, k, v, bias, what)
    _check_cuda(what, q, g=g)
    if g.shape != q.shape:
        raise ValueError(f"{what}: grad shape {tuple(g.shape)} != {tuple(q.shape)}")
    if q.shape[-1] > 160:
        raise ValueError(f"{what}: head dim {q.shape[-1]} > 160")
    _f32_rows(lse, q, "lse", what)


def _launch_bwd_dq(lib, q, k, v, bias, out, lse, g, delta, dq, scale: float) -> None:
    """Launch ``lib``'s dQ entry on the current stream (no checks, no
    count); ``lib`` is a build of ``csrc/flash_attn_bwd.cu``."""
    b, h, lq, d = q.shape
    err = lib.mvldm_flash_attn_bwd_dq(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
        _build.ptr(g), _build.ptr(lse), _optr(bias), _build.ptr(delta),
        _build.ptr(dq), b, h, lq, k.shape[2], d, float(scale),
        _build.stream_ptr(q.device))
    _build.check(err, f"mvldm_flash_attn_bwd_dq (head dim {d})")


def _launch_bwd_dkv(lib, q, k, v, bias, lse, delta, g, dk, dv, dbias, scale: float) -> None:
    """Launch ``lib``'s dK/dV entry on the current stream (no checks, no
    count)."""
    b, h, lq, d = q.shape
    err = lib.mvldm_flash_attn_bwd_dkv(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(g),
        _build.ptr(lse), _build.ptr(delta), _optr(bias), _build.ptr(dk),
        _build.ptr(dv), _optr(dbias), b, h, lq, k.shape[2], d, float(scale),
        _build.stream_ptr(q.device))
    _build.check(err, f"mvldm_flash_attn_bwd_dkv (head dim {d})")


@span("ops.flash_attention_bwd_dq")
def flash_attention_bwd_dq(q, k, v, bias, out, lse, g, scale=None):
    """dQ kernel. Returns (dq, delta): delta = rowsum(g * out), f32
    (B, H, Lq), computed in the kernel's prologue for the dK/dV kernel."""
    what = "flash_attention_bwd_dq"
    _check_bwd(q, k, v, bias, lse, g, what)
    _check_cuda(what, q, out=out)
    if out.shape != q.shape:
        raise ValueError(f"{what}: out shape {tuple(out.shape)} != {tuple(q.shape)}")
    dq = torch.empty_like(q)
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _launch_bwd_dq(_build.load("flash_attn_bwd", _BWD_SIGNATURES), q, k, v, bias, out,
                   lse, g, delta, dq, _scale(q, scale))
    flash_attention_bwd_dq.launches += 1
    return dq, delta


flash_attention_bwd_dq.launches = 0


@span("ops.flash_attention_bwd_dkv")
def flash_attention_bwd_dkv(q, k, v, bias, lse, delta, g, scale=None,
                            need_dbias: bool = True):
    """dK / dV / dbias kernel. Returns (dk, dv, dbias); dbias is the f32
    (B, H, Lk) per-head key-bias gradient, None without a bias or when not
    asked for."""
    what = "flash_attention_bwd_dkv"
    _check_bwd(q, k, v, bias, lse, g, what)
    _f32_rows(delta, q, "delta", what)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    dbias = None
    if bias is not None and need_dbias:
        dbias = torch.empty(k.shape[:3], dtype=torch.float32, device=q.device)
    _launch_bwd_dkv(_build.load("flash_attn_bwd", _BWD_SIGNATURES), q, k, v, bias, lse,
                    delta, g, dk, dv, dbias, _scale(q, scale))
    flash_attention_bwd_dkv.launches += 1
    return dk, dv, dbias


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, bias, out, lse, g, scale=None,
                        need_dbias: bool = True):
    """Both backward kernels: (dq, dk, dv, dbias), dbias f32 (B, Lk) summed
    over heads (None without a bias or when not asked for)."""
    dq, delta = flash_attention_bwd_dq(q, k, v, bias, out, lse, g, scale)
    dk, dv, db = flash_attention_bwd_dkv(q, k, v, bias, lse, delta, g, scale,
                                         need_dbias)
    return dq, dk, dv, None if db is None else db.sum(dim=1)


def _fwd_kernel(q: torch.Tensor):
    """The forward kernel wrapper for ``q``'s dtype on the card: f32 takes
    the f32 route, every other dtype the bf16 kernel, which refuses what it
    does not take. A choice by dtype; nothing is caught to fall back."""
    return flash_attention_f32 if q.dtype == torch.float32 else flash_attention


def _bwd_kernels(q: torch.Tensor):
    """The backward kernels' wrapper for ``q``'s dtype (see :func:`_fwd_kernel`)."""
    return flash_attention_bwd_f32 if q.dtype == torch.float32 else flash_attention_bwd


class _Attention(torch.autograd.Function):
    """Forward saves (q, k, v, bias, out, lse); backward runs the two
    backward kernels for the dtype on the card and the chunked plain
    backward on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        if q.device.type == "cpu":
            out = attention_reference(q, k, v, bias, scale)
            lse = None
        else:
            out, lse = _fwd_kernel(q)(q, k, v, bias, scale, return_lse=True)
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, bias, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out, lse = ctx.saved_tensors
        need_dbias = ctx.needs_input_grad[3]
        if q.device.type == "cpu":
            dq, dk, dv, db = attention_bwd_reference(q, k, v, bias, g, ctx.scale)
        else:
            dq, dk, dv, db = _bwd_kernels(q)(
                q, k, v, bias, out, lse, g.contiguous(), ctx.scale, need_dbias)
        return dq, dk, dv, db if need_dbias else None, None


@span("ops.attention")
def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Differentiable MHA: plain versions for CPU tensors, the kernels for
    CUDA ones (f32 the f32 route, other dtypes the bf16 kernels). Without
    gradients to record it runs the forward alone (no lse), as sampling
    does.

    q: (B, H, Lq, D); k/v: (B, H, Lk, D); bias: optional (B, Lk) additive key
    bias (use NEG_INF to mask)."""
    scale = _scale(q, scale)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, bias)):
        return _Attention.apply(q, k, v, bias, scale)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, bias, scale)
    return _fwd_kernel(q)(q, k, v, bias, scale)


@span("ops.text_cross_attention")
def text_cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Image-token queries onto a text's tokens, (B, H, Lq, D) x (B, H, Lt,
    D): :func:`attention` without a bias, its entry of its own so that the
    text cross-attention (MVDream's attn2, Lt = 77: on the card the flash
    forward on a ragged key tail) is told apart from self-attention."""
    return attention(q, k, v)
