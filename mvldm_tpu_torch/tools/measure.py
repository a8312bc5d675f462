"""Device timing and lower bounds on one NVIDIA H100, shared by
``chip_smoke.py`` and :mod:`mvldm_tpu_torch.tools.bench_attn_micro`.

Peaks are the H100 SXM's published dense rates at its full 700 W power
limit; a card set below it runs slower, so every time is reported beside
the card's name and power limit (:func:`card_line`).
"""

from __future__ import annotations

import subprocess
from typing import Callable, Optional, Tuple

import torch

PEAK_BF16_FLOPS = 989e12  # bf16 tensor cores (mma / wgmma)
PEAK_TF32_FLOPS = 495e12  # TF32 tensor cores
PEAK_FP32_FLOPS = 67e12   # f32 FFMA outside the tensor cores
PEAK_BYTES = 3.35e12      # HBM3
TARGET_MS = 50.0  # device time a replay of an unsized timing fills


def card_line() -> str:
    """The card as ``nvidia-smi --query-gpu=name,power.limit`` names it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(flops: float, moved: int, peak_flops: float = PEAK_BF16_FLOPS
          ) -> Tuple[float, str]:
    """The least time in ms the card could take: the larger of ``flops`` at
    ``peak_flops`` and ``moved`` bytes at the HBM rate, and which one it is
    ("operations" or "bytes")."""
    t_ops, t_bytes = flops / peak_flops * 1e3, moved / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
