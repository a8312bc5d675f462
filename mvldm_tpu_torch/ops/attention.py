"""Multi-head attention: plain version, CUDA kernel wrapper, dispatcher.

Counterpart of ``mvldm_tpu/ops/attention.py`` (forward only; the backward
kernels come with training).

* :func:`attention_reference` — plain PyTorch, the counterpart of
  ``mha_reference``: f32 softmax statistics whatever the input dtype, and an
  optional additive (B, Lk) key bias broadcast over heads and queries.
* :func:`flash_attention` — the hand-written Hopper kernel in
  ``csrc/flash_attn_fwd.cu`` (replaces the TPU's ``_flash_kernel``):
  bf16 q/k/v on the card, online softmax in f32, ragged lengths masked in
  the kernel. ``flash_attention.launches`` counts its launches.
* :func:`attention` — a CPU tensor goes to the plain version, a CUDA tensor
  to the kernel (which raises on what it does not take).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

NEG_INF = -1e30  # large finite negative; -inf breaks exp(m_prev - m_new) warm-up

_SIGNATURES = {
    "mvldm_flash_attn_fwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_void_p],
}


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain attention. q/k/v: (B, H, Lq/Lk, D); bias: (B, Lk) additive."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)


def _check_cuda_qkv(q, k, v, bias):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention: {name} must be bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be (B, H, L, D)")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"flash_attention: shapes {q.shape} {k.shape} {v.shape}")
    if d % 8 != 0:
        raise ValueError(f"flash_attention: head dim {d} is not a multiple of 8")
    if bias is not None:
        if bias.device != q.device or bias.dtype != torch.float32:
            raise TypeError("flash_attention: bias must be float32 on q's device")
        if bias.shape != (b, k.shape[2]) or not bias.is_contiguous():
            raise ValueError(f"flash_attention: bias must be contiguous (B, Lk), got {tuple(bias.shape)}")


def _launch_flash(q, k, v, bias, out, scale: float) -> None:
    """Launch the kernel on the current stream (no checks, no count)."""
    lib = _build.load("flash_attn_fwd", _SIGNATURES)
    b, h, lq, d = q.shape
    err = lib.mvldm_flash_attn_fwd(
        _build.ptr(q), _build.ptr(k), _build.ptr(v),
        None if bias is None else _build.ptr(bias), _build.ptr(out),
        b, h, lq, k.shape[2], d, float(scale), _build.stream_ptr(q.device),
    )
    _build.check(err, f"mvldm_flash_attn_fwd (head dim {d})")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Hopper flash attention forward. q: (B, H, Lq, D); k/v: (B, H, Lk, D),
    bf16, contiguous, on one CUDA device; bias: optional f32 (B, Lk)."""
    _check_cuda_qkv(q, k, v, bias)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    out = torch.empty_like(q)
    _launch_flash(q, k, v, bias, out, scale)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """MHA dispatch: plain version for CPU tensors, the kernel for CUDA ones.

    q: (B, H, Lq, D); k/v: (B, H, Lk, D); bias: optional (B, Lk) additive key
    bias (use NEG_INF to mask)."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, bias, scale)
    return flash_attention(q, k, v, bias, scale)
