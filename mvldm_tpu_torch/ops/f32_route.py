"""The f32 route of the main path's kernels: f32 tensors on the card.

The JAX package runs its Pallas kernels in f32 too, and f32 is its default
precision (``trainer.precision: null``). The bf16 kernels take bf16 only, so
the dispatchers (``attention``, ``fused_ln_self_attention``,
``fused_ln_geglu_ff`` and their autograd Functions) hand f32 tensors on the
card to the wrappers here, which launch the hand-written kernels of
``csrc/f32_route.cu``: every product on the tensor cores as split TF32,
three TF32 products for each f32 one (the flash forward up to head dim 160,
the backward, and the GEMM tile of ``csrc/f32_gemm_tile.cuh``); LayerNorm,
GEGLU and the attention row pass are plain SIMT passes. bf16 goes to the
bf16 kernels as before. The choice is by dtype, made before any launch;
nothing is caught to fall back.

* :func:`flash_attention_f32` — forward, optional f32 lse; head dims up to
  512, multiples of 4. Up to 160 one flash kernel; past it (the VAE's 512)
  :func:`attention_route_f32`, three launches a chunk of heads with the
  scores in a scratch of at most SCORES_CAP_BYTES.
* :func:`flash_attention_bwd_f32` — dQ (with delta) then dK / dV / dbias;
  head dims up to 160, multiples of 4.
* :func:`fused_ln_self_attention_f32` — LayerNorm, the q/k/v projections
  written head-split, the flash forward, the head-merging output projection
  with + b_o + x.
* :func:`fused_ln_geglu_ff_f32` — LayerNorm, W1 + b1, GEGLU, W2 + b2 + x.
* :func:`gemm_f32` — the GEMM tile alone; every f32 product of the
  wrappers above past the flash kernels launches it. Plain version
  :func:`gemm_f32_reference`.
* :func:`attention_rows_f32` — the route's row pass (lse, P = exp(S - lse)
  in place). Plain version :func:`attention_rows_reference`.

Each counts its calls in ``<wrapper>.launches``; ``gemm_f32`` and
``attention_rows_f32`` count every launch of their kernel, whichever
wrapper makes it. Weights are in the JAX layout ((C, H*D) etc.), as
transposes of contiguous torch Linear weights.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Tuple

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
    "mvldm_f32_gemm_batched": [_P] * 4 + [_I] * 7 + [ctypes.c_longlong] * 3 + [_I] * 4
    + [_F, _P],
    "mvldm_f32_gemm_smem": [_P],
    "mvldm_f32_attn_rows": [_P] * 2 + [_I] * 4 + [ctypes.c_longlong] * 2 + [_P],
    "mvldm_f32_geglu": [_P] * 2 + [ctypes.c_longlong, _I, _P],
}
MAX_FWD_HEAD_DIM = 512
MAX_FLASH_HEAD_DIM = 160  # the flash forward's; past it the scores go through memory
MAX_BWD_HEAD_DIM = 160
# The route's scratch of scores past MAX_FLASH_HEAD_DIM: one 4096 x 4096 head
# (a 512 px image's VAE attention) or twelve of the 256 px VAE's 1024 x 1024
# heads in one chunk; larger heads are split by query rows.
SCORES_CAP_BYTES = 64 << 20


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
    """The forward of ``lib`` (a build of ``csrc/f32_route.cu``, this
    tree's by default) on checked inputs, writing ``out`` and, if not None,
    ``lse``: its flash kernel up to MAX_FLASH_HEAD_DIM, else
    :func:`attention_route_f32` on its GEMM tile and row pass."""
    lib = lib or _lib()
    b, h, lq, d = q.shape
    if d > MAX_FLASH_HEAD_DIM:
        attention_route_f32(q, k, v, bias, scale, out, lse, RouteLaunches(lib))
        return
    _build.check(lib.mvldm_f32_flash_fwd(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _optr(bias), _build.ptr(out), _optr(lse),
        b, h, lq, k.shape[2], d, float(scale), _build.stream_ptr(q.device)),
        f"mvldm_f32_flash_fwd (head dim {d})")


# ------------------------------------------- the forward past the flash kernel

def _ceil4(n: int) -> int:
    return (n + 3) // 4 * 4


def attention_chunks(bh: int, lq: int, lk: int,
                     cap_bytes: int = SCORES_CAP_BYTES) -> List[Tuple[int, int, int, int]]:
    """The chunks (z0, heads, r0, rows) in which :func:`attention_route_f32`
    covers ``bh`` heads of ``lq`` query rows: each chunk's scores, rows x
    ceil4(lk) f32 a head, within ``cap_bytes``. Whole heads over the fewest
    chunks that fit, ceil(bh / chunks) a chunk; a head larger than the cap
    alone goes by query rows, split the same way."""
    row_bytes = 4 * _ceil4(lk)
    head_bytes = lq * row_bytes
    if head_bytes <= cap_bytes:
        per = min(bh, cap_bytes // head_bytes, 65535)
        n = -(-bh // per)
        per = -(-bh // n)
        return [(z, min(per, bh - z), 0, lq) for z in range(0, bh, per)]
    rows = max(1, cap_bytes // row_bytes)
    n = -(-lq // rows)
    rows = -(-lq // n)
    return [(z, 1, r, min(rows, lq - r)) for z in range(bh) for r in range(0, lq, rows)]


class RouteLaunches:
    """The three launches of a chunk of :func:`attention_route_f32` on the
    card, from ``lib`` (a build of ``csrc/f32_route.cu``). Each takes
    (heads, rows, ...) views of the route's tensors: q (Z, R, D) and k, v
    (Z, Lk, D), rows of one stride apart; s (Z, R, ceil4(Lk)) scores, lse
    (Z, R), out (Z, R, D)."""

    def __init__(self, lib):
        self.lib = lib

    def scores(self, q, k, bias, s, z0: int, heads: int, scale: float) -> None:
        """s[..., :Lk] = scale q k^T + bias[(z0 + z) // heads]."""
        z, r, d = q.shape
        lk = k.shape[1]
        _launch_gemm_batched(self.lib, q, k, s, z, r, lk, d, q.stride(1), k.stride(1),
                             s.stride(1), q.stride(0), k.stride(0), s.stride(0), False, bias,
                             heads, z0, lk, scale)

    def rows(self, s, lse, lk: int) -> None:
        """lse = logsumexp(s[..., :Lk]), s[..., :Lk] = exp(s - lse) in place."""
        _launch_rows(self.lib, s, lse, lk)

    def pv(self, s, v, out) -> None:
        """out = s[..., :Lk] v."""
        z, r, d = out.shape
        lk = v.shape[1]
        _launch_gemm_batched(self.lib, s, v, out, z, r, d, lk, s.stride(1), v.stride(1),
                             out.stride(1), s.stride(0), v.stride(0), out.stride(0), True, None,
                             1, 0, 0, 1.0)


class PlainRouteLaunches:
    """:class:`RouteLaunches`' plain versions in PyTorch, for the CPU tests
    of :func:`attention_route_f32`."""

    def scores(self, q, k, bias, s, z0: int, heads: int, scale: float) -> None:
        lk = k.shape[1]
        x = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
        if bias is not None:
            rows = torch.arange(z0, z0 + q.shape[0], device=bias.device) // heads
            x = x + bias.float()[rows][:, None, :]
        s[..., :lk] = x

    def rows(self, s, lse, lk: int) -> None:
        attention_rows_reference(s, lse, lk)

    def pv(self, s, v, out) -> None:
        out.copy_(torch.matmul(s[..., :v.shape[1]], v.float()))


def attention_route_f32(q, k, v, bias, scale: float, out, lse, launches,
                        cap_bytes: int = SCORES_CAP_BYTES) -> None:
    """softmax(scale q k^T + bias) v into ``out`` and, if not None, its lse
    into ``lse``, with the scores through device memory: for each chunk of
    :func:`attention_chunks`, S = scale Q K^T + bias into a scratch, the row
    pass (lse, P = exp(S - lse) in place), O = P V, each by ``launches``
    (:class:`RouteLaunches` on the card; the CPU tests pass
    :class:`PlainRouteLaunches`). q (B, H, Lq, D), k / v (B, H, Lk, D),
    bias (B, Lk) or None, out like q, lse (B, H, Lq)."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    q3, k3, v3 = (t.reshape(b * h, -1, d) for t in (q, k, v))
    o3 = out.view(b * h, lq, d)
    if lse is None:
        lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    l2 = lse.view(b * h, lq)
    chunks = attention_chunks(b * h, lq, lk, cap_bytes)
    lds = _ceil4(lk)
    scratch = torch.empty(max(n * r for _, n, _, r in chunks) * lds, dtype=torch.float32,
                          device=q.device)
    for z0, n, r0, r in chunks:
        s = scratch[:n * r * lds].view(n, r, lds)
        heads = slice(z0, z0 + n)
        launches.scores(q3[heads, r0:r0 + r], k3[heads], bias, s, z0, h, scale)
        launches.rows(s, l2[heads, r0:r0 + r], lk)
        launches.pv(s, v3[heads], o3[heads, r0:r0 + r])


def attention_rows_reference(s, lse, lk: int) -> None:
    """The plain row pass: lse = logsumexp(s[..., :lk]) and s[..., :lk] =
    exp(s - lse) in place, in f32; s (Z, R, >= lk), lse (Z, R)."""
    x = s[..., :lk]
    m = torch.logsumexp(x, dim=-1)
    lse.copy_(m)
    x.copy_(torch.exp(x - m[..., None]))


def attention_rows_f32(s, lse, lk: int) -> None:
    """The row pass on the card (``csrc/f32_route.cu``, ``attn_rows_f32``):
    s (Z, R, ceil4(lk)) f32 scores, contiguous; writes lse (Z, R) and P =
    exp(s - lse) over the first ``lk`` columns in place."""
    what = "attention_rows_f32"
    _check(what, s, s=s, lse=lse)
    if s.dim() != 3 or s.shape[2] != _ceil4(lk) or lse.shape != s.shape[:2]:
        raise ValueError(f"{what}: s {tuple(s.shape)}, lse {tuple(lse.shape)}, lk {lk}")
    _launch_rows(_lib(), s, lse, lk)


def _launch_rows(lib, s, lse, lk: int) -> None:
    """``lib``'s row pass on (Z, R, lds) scores s, rows one stride apart,
    and lse (Z, R); counted in ``attention_rows_f32.launches``."""
    z, r, lds = s.shape
    _build.check(lib.mvldm_f32_attn_rows(
        _build.ptr(s), _build.ptr(lse), z, r, lk, s.stride(1), s.stride(0), lse.stride(0),
        _build.stream_ptr(s.device)), "mvldm_f32_attn_rows")
    attention_rows_f32.launches += 1


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
    ``a_heads`` / ``out_heads`` that operand is (M / l, heads, l, d).
    Counted in ``gemm_f32.launches``."""
    n, k = w.shape
    if any(t is not None and t.data_ptr() % 16 for t in (a, w, out, bias, res)):
        raise ValueError("mvldm_f32_gemm: operands must be 16-byte aligned")
    _build.check(lib.mvldm_f32_gemm(
        _build.ptr(a), _build.ptr(w), _optr(bias), _optr(res), _build.ptr(out),
        a.numel() // k, n, k, a_heads, out_heads, l, d, _build.stream_ptr(a.device)),
        "mvldm_f32_gemm")
    gemm_f32.launches += 1


def _launch_gemm_batched(lib, a, b, out, batch: int, m: int, n: int, k: int, lda: int,
                         ldb: int, ldo: int, sa: int, sb: int, so: int, b_kn: bool, bias,
                         bias_div: int, bias_z0: int, bias_ld: int, alpha: float) -> None:
    """``lib``'s batched GEMM entry (see ``mvldm_f32_gemm_batched``) on
    the data of a, b, out at the given rows and strides (in floats);
    counted in ``gemm_f32.launches``."""
    _build.check(lib.mvldm_f32_gemm_batched(
        _build.ptr(a), _build.ptr(b), _optr(bias), _build.ptr(out), batch, m, n, k, lda, ldb,
        ldo, sa, sb, so, int(b_kn), bias_div, bias_z0, bias_ld, float(alpha),
        _build.stream_ptr(a.device)), f"mvldm_f32_gemm_batched ({batch} x {m}x{n}x{k})")
    gemm_f32.launches += 1


def gemm_f32_reference(a, b, bias=None, res=None, b_kn: bool = False, alpha: float = 1.0,
                       out_heads: int = 0, l: int = 0) -> torch.Tensor:
    """The plain version of :func:`gemm_f32` in f32 (in float64 for float64
    inputs): alpha a b^T, or alpha a b with ``b_kn``, + bias (broadcast over
    rows) + res. a (M, K), (Z, M, K) or (N', H, L, D) read as (N' L, H D);
    with ``out_heads`` the (M, N) output is returned as (M / l, out_heads,
    l, N / out_heads)."""
    dt = torch.float64 if a.dtype == torch.float64 else torch.float32
    x = a.to(dt)
    if a.dim() == 4:
        n_, h, l_, d = a.shape
        x = x.transpose(1, 2).reshape(n_ * l_, h * d)
    y = torch.matmul(x, b.to(dt) if b_kn else b.to(dt).transpose(-1, -2)) * alpha
    if bias is not None:
        y = y + bias.to(dt).unsqueeze(-2)
    if res is not None:
        y = y + res.to(dt)
    if out_heads:
        m, n = y.shape
        y = y.reshape(m // l, l, out_heads, n // out_heads).transpose(1, 2).contiguous()
    return y


def gemm_f32(a, b, bias=None, res=None, b_kn: bool = False, alpha: float = 1.0,
             out_heads: int = 0, l: int = 0) -> torch.Tensor:
    """The split-TF32 GEMM tile on the card (``csrc/f32_gemm_tile.cuh``),
    the function of :func:`gemm_f32_reference`, all tensors contiguous f32.

    * a (M, K) or (Z, M, K), b (N, K) or (K, N) with ``b_kn``, or a batch
      of those (Z, ...), bias (N,) or (Z, N): ``mvldm_f32_gemm_batched``;
      K % 4 == 0 (16-byte rows), and N % 4 == 0 with ``b_kn``. (The
      attention route gives that entry rows padded to a multiple of 4 and
      any K.)
    * a (N', H, L, D) (the attention output), or ``out_heads`` (with ``l``),
      or a residual res (M, N): ``mvldm_f32_gemm`` (b (N, K), alpha 1,
      N and K multiples of 4, the heads' D shared by a and out)."""
    what = "gemm_f32"
    extra = {name: t for name, t in (("bias", bias), ("res", res)) if t is not None}
    _check(what, a, a=a, b=b, **extra)
    lib = _lib()
    if a.dim() == 4 or out_heads or res is not None:
        if b_kn or alpha != 1.0 or b.dim() != 2 or a.dim() not in (2, 4):
            raise ValueError(f"{what}: head layouts and residuals take a 2-D (N, K) b, "
                             "alpha 1, no batch")
        n, k = b.shape
        a_heads, d = (a.shape[1], a.shape[3]) if a.dim() == 4 else (0, 0)
        if a.dim() == 4:
            l = a.shape[2]
        m = a.numel() // k
        if out_heads:
            if n % out_heads or (d and d != n // out_heads) or l <= 0 or m % l:
                raise ValueError(f"{what}: out_heads {out_heads}, l {l} for ({m}, {n})")
            d = n // out_heads
            out = torch.empty((m // l, out_heads, l, d), dtype=torch.float32, device=a.device)
        else:
            out = torch.empty((m, n), dtype=torch.float32, device=a.device)
        if (a.dim() == 2 and a.shape[1] != k) or (a.dim() == 4 and a_heads * d != k):
            raise ValueError(f"{what}: a {tuple(a.shape)} against b {tuple(b.shape)}")
        if res is not None and res.shape != (m, n):
            raise ValueError(f"{what}: res must be ({m}, {n})")
        if bias is not None and bias.shape != (n,):
            raise ValueError(f"{what}: bias must be ({n},)")
        _gemm(lib, a, b, out, bias, res, a_heads, out_heads, l, d)
        return out
    batched = a.dim() == 3
    a3 = a if batched else a[None]
    b3 = b if b.dim() == 3 else b[None]
    z, m, k = a3.shape
    n = b3.shape[2] if b_kn else b3.shape[1]
    if b3.shape[0] != z or (b3.shape[1] if b_kn else b3.shape[2]) != k or b.dim() != a.dim():
        raise ValueError(f"{what}: a {tuple(a.shape)} against b {tuple(b.shape)}")
    if bias is not None and bias.shape not in ((n,), (z, n)):
        raise ValueError(f"{what}: bias must be ({n},) or ({z}, {n})")
    if k % 4 or (b_kn and n % 4):
        raise ValueError(f"{what}: K (and N with b_kn) must be multiples of 4, got {k}, {n}")
    out = torch.empty((z, m, n), dtype=torch.float32, device=a.device)
    _launch_gemm_batched(lib, a3, b3, out, z, m, n, k, k, n if b_kn else k, n, m * k,
                         b3[0].numel(), m * n, b_kn, bias,
                         1 if bias is None or bias.dim() == 2 else z, 0, n, alpha)
    return out if batched else out[0]


def gemm_smem_bytes() -> int:
    """The GEMM tile's dynamic shared memory (bytes; builds the library)."""
    smem = ctypes.c_int()
    _build.check(_lib().mvldm_f32_gemm_smem(ctypes.byref(smem)), "mvldm_f32_gemm_smem")
    return smem.value


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
gemm_f32.launches = 0
attention_rows_f32.launches = 0
KERNELS = (flash_attention_f32, flash_attention_bwd_f32, fused_ln_self_attention_f32,
           fused_ln_geglu_ff_f32, gemm_f32, attention_rows_f32)
