"""Device timing, lower bounds and error records on one NVIDIA H100,
shared by ``chip_smoke.py``, :mod:`mvldm_tpu_torch.tools.bench_attn_micro`
and :mod:`mvldm_tpu_torch.tools.kernel_compare`.

Peaks are the H100 SXM's published dense rates at its full 700 W power
limit; a card set below it runs slower, so every time is reported beside
the card's name and power limit (:func:`card_line`).
"""

from __future__ import annotations

import contextlib
import subprocess
from typing import Callable, List, Optional, Tuple

import torch

PEAK_BF16_FLOPS = 989e12  # bf16 tensor cores (mma / wgmma)
PEAK_FP32_FLOPS = 67e12   # f32 FFMA outside the tensor cores
PEAK_TF32_FLOPS = 494.7e12  # TF32 tensor cores (wgmma); an f32 product as split TF32 takes three
PEAK_BYTES = 3.35e12      # HBM3
EXP2_PER_CLOCK_PER_SM = 16  # MUFU ex2 (CUDA arithmetic-throughput table, sm_90)
TARGET_MS = 50.0  # device time a replay of an unsized timing fills


@contextlib.contextmanager
def no_tf32():
    """Full f32 in cuBLAS and cuDNN for the block (TF32 off for both), the
    flags as they were after it."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def card_line() -> str:
    """The card as ``nvidia-smi --query-gpu=name,power.limit`` names it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sm_clock_mhz() -> float:
    """The card's current SM clock in MHz (``nvidia-smi --query-gpu=clocks.sm``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0])


def sm_count() -> int:
    """The card's number of SMs."""
    return torch.cuda.get_device_properties(0).multi_processor_count


def exp_floor_ms(n_exp: float, sm_mhz: float, n_sms: int) -> float:
    """The least time in ms for ``n_exp`` exp2 on the card's special-function
    units at ``sm_mhz``: EXP2_PER_CLOCK_PER_SM per clock on each of ``n_sms``
    SMs (:func:`sm_count`)."""
    return n_exp / (EXP2_PER_CLOCK_PER_SM * n_sms * sm_mhz * 1e6) * 1e3


def time_ms(fn: Callable[[], object], iters: Optional[int] = None) -> float:
    """Device time of one call: ``iters`` calls captured in one CUDA graph
    and replayed between two events, so the host's dispatch (Python checks,
    allocation, ctypes) stays out of the time. Without ``iters``, as many
    calls as fill about TARGET_MS by one eager call's time (3 to 200)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if iters is None:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        iters = int(min(200, max(3, TARGET_MS / max(start.elapsed_time(end), 1e-3))))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    torch.cuda.empty_cache()
    return start.elapsed_time(end) / iters


def event_ms(fn: Callable[[], object], iters: int) -> float:
    """Device time of one call from two CUDA events around ``iters`` eager
    calls, for calls that record an autograd graph (the library backward);
    host dispatch is inside the time wherever the device outruns it."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def own_error(out, ref) -> float:
    """A kernel's own error against its f32 plain version: the largest
    ``|out - ref|`` less half a bf16 step of ``out`` (a bf16 output cannot
    come closer than that; nothing is taken off an f32 output)."""
    o = out.float()
    err = (o - ref).abs()
    if out.dtype != torch.float32:
        _, e = torch.frexp(o)
        err = err - torch.where(o == 0, torch.zeros_like(o),
                                torch.ldexp(torch.ones_like(o), e - 9))
    return err.clamp_min(0).max().item()


def error_record(out, ref, residual=None) -> dict:
    """A kernel output against its f32 plain version: the largest absolute
    error, the own error (:func:`own_error`), the rms of what the kernel
    computes (``ref``, or ``ref - residual`` for a residual block) and the
    own error over that rms."""
    own = own_error(out, ref)
    delta = ref if residual is None else ref - residual.float()
    rms = delta.square().mean().sqrt().item()
    return dict(max_abs_err=(out.float() - ref).abs().max().item(), kernel_err=own,
                rms_computed=rms, err_over_rms=own / rms)


def sdpa_bwd_ms(q, k, v, bias, g, iters: int) -> float:
    """scaled_dot_product_attention's backward on (B, H, L, D) inputs with
    output gradient ``g`` and an optional (B, Lk) float bias as its mask:
    its forward + backward less its forward, by :func:`event_ms`."""
    import torch.nn.functional as F

    mask = None if bias is None else bias[:, None, None, :].to(q.dtype)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

    def fwd():
        return F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)

    return (event_ms(lambda: torch.autograd.grad(fwd(), (qg, kg, vg), g), iters)
            - event_ms(fwd, iters))


def device_kernels(fn: Callable[[], object]) -> List[str]:
    """The names of the device kernels that one call of ``fn`` launches
    (torch.profiler, after one call outside it)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def sdpa_backend(fn: Callable[[], object]) -> dict:
    """The backend that a scaled_dot_product_attention call ``fn`` ran
    (flash, efficient, cudnn, or math where none of those kernels ran),
    named from its device kernels (:func:`device_kernels`); "not recorded"
    where the profiler recorded no device kernel at all."""
    names = device_kernels(fn)
    if not names:
        return dict(backend="not recorded", kernels=[])
    low = " ".join(names).lower()
    backend = next((b for key, b in (("flash", "flash"), ("cudnn", "cudnn"), ("fmha", "efficient"),
                                     ("efficient", "efficient")) if key in low), "math")
    return dict(backend=backend, kernels=[n[:100] for n in names])


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(flops: float, moved: int, peak_flops: float = PEAK_BF16_FLOPS
          ) -> Tuple[float, str]:
    """The least time in ms the card could take: the larger of ``flops`` at
    ``peak_flops`` and ``moved`` bytes at the HBM rate, and which one it is
    ("operations" or "bytes")."""
    t_ops, t_bytes = flops / peak_flops * 1e3, moved / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def f32_bounds(flops: float, moved: int) -> dict:
    """Bounds of f32 products of ``flops`` moving ``moved`` bytes:
    ``bound_ms`` / ``bound_by`` with f32 accuracy on the tensor cores
    (three TF32 products for each, at PEAK_TF32_FLOPS), and
    ``ffma_bound_ms`` for the same products on FFMA (PEAK_FP32_FLOPS)."""
    bound_ms, bound_by = bound(3 * flops, moved, PEAK_TF32_FLOPS)
    return dict(bound_ms=bound_ms, bound_by=bound_by,
                ffma_bound_ms=bound(flops, moved, PEAK_FP32_FLOPS)[0])


def f32_gemm_bounds(m: int, n: int, k: int, moved: int) -> dict:
    """:func:`f32_bounds` of an f32 GEMM (M, K) x (K, N), 2 M N K flops:
    three TF32 products of them at PEAK_TF32_FLOPS, or the bytes, with
    ``ffma_bound_ms`` beside it."""
    return f32_bounds(2.0 * m * n * k, moved)


def f32_fwd_bounds(b: int, h: int, lq: int, lk: int, d: int, moved: int) -> dict:
    """:func:`f32_bounds` of the f32 attention forward (S = Q K^T and O = P
    V: two Lq x Lk x D products) on (B, H, Lq, Lk, D)."""
    return f32_bounds(4.0 * b * h * lq * lk * d, moved)


def f32_bwd_bounds(b: int, h: int, lq: int, lk: int, d: int, moved: int) -> dict:
    """:func:`f32_bounds` of the f32 attention backward (dQ, dK, dV: five Lq
    x Lk x D products) on (B, H, Lq, Lk, D)."""
    return f32_bounds(10.0 * b * h * lq * lk * d, moved)
