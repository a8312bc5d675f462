"""Peaks of the card and the least time a call can take: a frozen copy of
the arithmetic of ``mvldm_tpu_torch/tools/measure.py`` (``PEAK_BF16_FLOPS``,
``PEAK_BYTES``, the bound), with the operations and bytes of each hand
kernel's entry point counted from its call's shapes. Inputs are read once
and outputs written once, whatever a kernel reads again.
"""

from __future__ import annotations

from typing import Dict, Sequence

PEAK_BF16_FLOPS = 989e12  # one H100 SXM, dense bf16, at its 700 W limit
PEAK_BYTES = 3.35e12      # HBM3
BF16, F32 = 2, 4


def bound_s(flops: float, nbytes: float) -> float:
    """The larger of flops / peak and bytes / peak bandwidth, in seconds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


def _numel(shape: Sequence[int]) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def flash_forward(q, k, bias: bool) -> Dict[str, float]:
    """softmax(Q K^T + bias) V over (B, H, L, D), with or without an f32
    (B, Lk) key bias: two products."""
    b, h, lq, d = q
    lk = k[2]
    flops = 4.0 * b * h * lq * lk * d
    nbytes = BF16 * (2 * _numel(q) + 2 * _numel(k)) + (F32 * b * lk if bias else 0)
    return {"flops": flops, "nbytes": nbytes}


def flash_backward(q, k, bias: bool) -> Dict[str, float]:
    """dQ, dK, dV (and the key bias's gradient) from Q, K, V, O, dO and the
    row lse: S once, then dP, dV, dK, dQ, five products in all (the dQ and
    the dK/dV kernels together)."""
    b, h, lq, d = q
    lk = k[2]
    flops = 10.0 * b * h * lq * lk * d
    nbytes = (BF16 * (4 * _numel(q) + 4 * _numel(k)) + F32 * b * h * lq
              + (2 * F32 * b * h * lk if bias else 0))
    return {"flops": flops, "nbytes": nbytes}


def ln_self_attention(x, heads: int, head_dim: int) -> Dict[str, float]:
    """x + W_o MHA(LN(x)) + b_o over (..., L, C) tokens."""
    c, l = x[-1], x[-2]
    n = _numel(x[:-2])
    inner = heads * head_dim
    m = n * l
    flops = 2.0 * m * c * 3 * inner + 4.0 * n * heads * l * l * head_dim + 2.0 * m * inner * c
    nbytes = BF16 * (2 * m * c + 4 * c * inner + 3 * c)
    return {"flops": flops, "nbytes": nbytes}


def ln_geglu_ff(x, width: int) -> Dict[str, float]:
    """x + W2 (a * gelu(gate)) + b2, [a, gate] = W1 LN(x) + b1, inner
    width ``width`` (4C)."""
    c = x[-1]
    m = _numel(x[:-1])
    flops = 2.0 * m * c * 2 * width + 2.0 * m * width * c
    nbytes = BF16 * (2 * m * c + 3 * c * width + 2 * width + 3 * c)
    return {"flops": flops, "nbytes": nbytes}
