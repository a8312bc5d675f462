"""Smoke test of the PyTorch/CUDA port (mvldm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no final result line):

1. device and build: the card's name and power limit; the CUDA kernels are
   compiled from mvldm_tpu_torch/csrc with nvcc (one process per source).
2. one phase per kernel at the main path's shapes: the kernel against its
   plain PyTorch version computed in f32 on the same bf16 inputs (see
   ``check``), device times of both (CUDA graph replay between CUDA
   events), the lower bound max(flops / 989 TFLOP/s,
   bytes / 3.35 TB/s) of an H100 SXM, and for attention the time of
   torch's scaled_dot_product_attention as a yardstick.
3. the main path: build_flagship("cuda") (the 0.93B SD2.1 multi-view UNet
   and the SD2.1 VAE, bf16, seeded random weights) and anchored sampling of
   one synthetic scene (1 context + 16 target frames at 256 px, 25 DDIM
   steps, CFG 3.0). Every kernel's launch count must rise in this run.
4. a profile of one anchor-launch denoise step: device time by kernel
   group and the device's idle share within the profiled window
   (torch.profiler).
5. full-width UNet parity: one batched-CFG UNet forward (2 rows x 5 views,
   32x32 latents, view mask) on the card in bf16 with the kernels against
   the host CPU in f32 with the plain versions.

Every result is one JSON line. The last two lines are the card as
``nvidia-smi`` names it and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 bandwidth
# A kernel's own error, as a share of the rms of what it computes (see check).
KERNEL_REL_LIMIT = 0.05
UNET_REL_L2_BOUND = 3e-2
N_TARGET = 16


def emit(**record) -> None:
    print(json.dumps(record), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int) -> float:
    """Device time of one call: ``iters`` calls captured in one CUDA graph
    and replayed between two events, so the host's dispatch (Python checks,
    allocation, ctypes) stays out of the time."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    torch.cuda.empty_cache()
    return start.elapsed_time(end) / iters


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(flops: float, moved: int):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, moved / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def check(out, ref, what: str, residual=None) -> dict:
    """Hold a bf16 kernel output against its f32 plain version.

    A bf16 output cannot come closer to the f32 value than half a bf16 step
    of itself, so that step is taken off each element's error; what is left
    is the kernel's own error, which must stay within KERNEL_REL_LIMIT of
    the rms of what the kernel computes: the output for attention, and
    ``out - x`` for a residual block, whose x (~1) would otherwise hide an
    error as large as the block's own contribution (~0.1)."""
    o = out.float()
    _, e = torch.frexp(o)
    half_step = torch.where(o == 0, torch.zeros_like(o),
                            torch.ldexp(torch.ones_like(o), e - 9))
    err = (o - ref).abs()
    own = (err - half_step).clamp_min(0).max().item()
    delta = ref if residual is None else ref - residual.float()
    rms = delta.square().mean().sqrt().item()
    rec = dict(max_abs_err=err.max().item(), kernel_err=own,
               kernel_err_limit=KERNEL_REL_LIMIT * rms, rms_computed=rms)
    if not torch.isfinite(o).all() or not own <= KERNEL_REL_LIMIT * rms:
        fail(f"{what}: kernel error {own:.4g} (max abs {rec['max_abs_err']:.4g}) "
             f"outside {KERNEL_REL_LIMIT} x rms {rms:.4g}")
    return rec


# --------------------------------------------------------------- kernels

def attention_phase(card: str, gen) -> dict:
    import torch.nn.functional as F

    from mvldm_tpu_torch.ops.attention import attention_reference, flash_attention

    # (label, B, H, L, D, bias): B counts batch rows (2 = batched CFG).
    cases = [
        ("joint 32x32 anchor (C=320)", 2, 8, 5 * 1024, 40, True),
        ("joint 16x16 anchor (C=640)", 2, 8, 5 * 256, 80, True),
        ("joint 8x8 anchor (C=1280)", 2, 8, 5 * 64, 160, True),
        ("joint 4x4 anchor (C=1280)", 2, 8, 5 * 16, 160, True),
        ("joint 32x32 fill (C=320)", 4, 8, 5 * 1024, 40, False),
        ("SD attn1 8x8 (C=1280)", 20, 20, 64, 64, False),
        ("SD attn1 4x4 (C=1280)", 20, 20, 16, 64, False),
        ("per-frame attn2 8x8 (C=1280)", 20, 8, 64, 160, False),
        ("VAE mid-block 32x32", 12, 1, 1024, 512, False),
    ]
    headline = None
    max_err = 0.0
    for label, b, h, l, d, with_bias in cases:
        q, k, v = (torch.randn((b, h, l, d), generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))
        bias = None
        if with_bias:
            # Batched CFG: row 1 masks its context view out of the keys.
            bias = torch.zeros((b, l), device="cuda")
            bias[1:, : l // 5] = -1e30
        out = flash_attention(q, k, v, bias)
        ref = attention_reference(q.float(), k.float(), v.float(), bias)
        acc = check(out, ref, f"flash_attention {label}")
        max_err = max(max_err, acc["max_abs_err"])
        iters = 20 if l >= 1024 else 100
        ms = time_ms(lambda: flash_attention(q, k, v, bias), iters)
        plain_ms = time_ms(lambda: attention_reference(q, k, v, bias), 3)
        mask = None if bias is None else bias[:, None, None, :].to(q.dtype)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
                         iters)
        bound_ms, bound_by = bound(4.0 * b * h * l * l * d, nbytes(q, k, v, bias, out))
        rec = dict(phase="kernel", kernel="flash_attention", shape=label,
                   B=b, H=h, L=l, D=d, bias=with_bias, **acc, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                   bound_by=bound_by, card=card)
        emit(**rec)
        headline = headline or rec
        del q, k, v, out, ref
        torch.cuda.empty_cache()
    return dict(headline, max_abs_err=max_err)


def _linear_t(gen, out_f: int, in_f: int):
    """A torch-Linear-layout bf16 weight, returned as its (in, out) view."""
    w = torch.randn((out_f, in_f), generator=gen, device="cuda") * in_f ** -0.5
    return w.to(torch.bfloat16).t()


def fused_attn_phase(card: str, gen) -> dict:
    from mvldm_tpu_torch.ops.fused_attn import (
        fused_ln_self_attention,
        fused_ln_self_attention_reference,
    )

    # (label, N frames, L, C, heads, head_dim); N = 2 CFG rows x 5 views.
    cases = [
        ("SD attn1 32x32 (C=320)", 10, 1024, 320, 5, 64),
        ("cross-view attn2 32x32 (C=320)", 10, 1024, 320, 8, 40),
        ("SD attn1 16x16 (C=640)", 10, 256, 640, 10, 64),
        ("cross-view attn2 16x16 (C=640)", 10, 256, 640, 8, 80),
    ]
    headline = None
    max_err = 0.0
    for label, n, l, c, heads, d in cases:
        hd = heads * d
        x = torch.randn((n, l, c), generator=gen, device="cuda", dtype=torch.bfloat16)
        g = torch.rand(c, generator=gen, device="cuda") + 0.5
        b = torch.randn(c, generator=gen, device="cuda") * 0.1
        wq, wk, wv = (_linear_t(gen, hd, c) for _ in range(3))
        wo = _linear_t(gen, c, hd)
        bo = torch.randn(c, generator=gen, device="cuda") * 0.1
        args = (x, g, b, wq, wk, wv, wo, bo, heads, d)
        out = fused_ln_self_attention(*args)
        ref = fused_ln_self_attention_reference(
            x.float(), g, b, wq.float(), wk.float(), wv.float(), wo.float(), bo, heads, d)
        acc = check(out, ref, f"fused_ln_self_attention {label}", residual=x)
        max_err = max(max_err, acc["max_abs_err"])
        ms = time_ms(lambda: fused_ln_self_attention(*args), 20)
        plain_ms = time_ms(lambda: fused_ln_self_attention_reference(*args), 3)
        m = n * l
        flops = 2.0 * m * c * 3 * hd + 4.0 * n * heads * l * l * d + 2.0 * m * hd * c
        bound_ms, bound_by = bound(flops, nbytes(x, g, b, wq, wk, wv, wo, bo, out))
        rec = dict(phase="kernel", kernel="fused_ln_self_attention", shape=label,
                   N=n, L=l, C=c, H=heads, D=d, **acc, ms=ms, plain_ms=plain_ms,
                   library_ms=None, bound_ms=bound_ms, bound_by=bound_by, card=card)
        emit(**rec)
        headline = headline or rec
    return dict(headline, max_abs_err=max_err)


def fused_ff_phase(card: str, gen) -> dict:
    from mvldm_tpu_torch.ops.fused_ff import fused_ln_geglu_ff, fused_ln_geglu_ff_reference

    cases = [("FF 32x32 (C=320)", 10, 1024, 320), ("FF 16x16 (C=640)", 10, 256, 640)]
    headline = None
    max_err = 0.0
    for label, n, l, c in cases:
        x = torch.randn((n, l, c), generator=gen, device="cuda", dtype=torch.bfloat16)
        g = torch.rand(c, generator=gen, device="cuda") + 0.5
        b = torch.randn(c, generator=gen, device="cuda") * 0.1
        w1 = _linear_t(gen, 8 * c, c)
        b1 = torch.randn(8 * c, generator=gen, device="cuda") * 0.1
        w2 = _linear_t(gen, c, 4 * c)
        b2 = torch.randn(c, generator=gen, device="cuda") * 0.1
        args = (x, g, b, w1, b1, w2, b2)
        out = fused_ln_geglu_ff(*args)
        ref = fused_ln_geglu_ff_reference(x.float(), g, b, w1.float(), b1, w2.float(), b2)
        acc = check(out, ref, f"fused_ln_geglu_ff {label}", residual=x)
        max_err = max(max_err, acc["max_abs_err"])
        ms = time_ms(lambda: fused_ln_geglu_ff(*args), 20)
        plain_ms = time_ms(lambda: fused_ln_geglu_ff_reference(*args), 3)
        bound_ms, bound_by = bound(24.0 * n * l * c * c, nbytes(x, g, b, w1, b1, w2, b2, out))
        rec = dict(phase="kernel", kernel="fused_ln_geglu_ff", shape=label, N=n, L=l,
                   C=c, **acc, ms=ms, plain_ms=plain_ms,
                   library_ms=None, bound_ms=bound_ms, bound_by=bound_by, card=card)
        emit(**rec)
        headline = headline or rec
    return dict(headline, max_abs_err=max_err)


# ------------------------------------------------------------- main path

def make_scene(n_frames: int, hw: int):
    """One context + ``n_frames`` targets on a forward-translating camera
    path with random pixels (the repository's benchmark scene)."""
    from mvldm_tpu_torch.diffusion.video_sampling import SceneViews

    rng = np.random.default_rng(0)
    n = n_frames + 1
    images = rng.uniform(size=(n, hw, hw, 3)).astype(np.float32)
    extr = np.repeat(np.eye(4, dtype=np.float32)[None], n, axis=0)
    extr[:, 0, 3] = np.linspace(0, 2, n)
    extr[:, 2, 3] = np.linspace(0, 0.5, n)
    intr = np.repeat(np.eye(3, dtype=np.float32)[None], n, axis=0)
    intr[:, 0, 0] = 0.9
    intr[:, 1, 1] = 1.6
    intr[:, 0, 2] = intr[:, 1, 2] = 0.5
    ctx = SceneViews(images[:1], extr[:1], intr[:1], np.arange(1))
    tgt = SceneViews(images[1:], extr[1:], intr[1:], np.arange(1, n))
    return ctx, tgt


def main_path_phase(card: str, kernels) -> "object":
    from mvldm_tpu_torch.builder import IMAGE_HW, build_flagship
    from mvldm_tpu_torch.diffusion.video_sampling import VideoSampler

    t0 = time.perf_counter()
    engine = build_flagship("cuda")
    torch.cuda.synchronize()
    emit(phase="build_flagship", seconds=time.perf_counter() - t0,
         unet_params=sum(p.numel() for p in engine.unet.parameters()), card=card)
    sampler = VideoSampler(engine, num_anchors_views=4)
    ctx, tgt = make_scene(N_TARGET, IMAGE_HW)

    for fn in kernels:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    frames = sampler.sample_anchored(ctx, tgt, torch.Generator("cuda").manual_seed(1))
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernels}

    if sorted(frames) != list(range(1, N_TARGET + 1)):
        fail(f"anchored sampling returned frames {sorted(frames)}")
    for f, img in frames.items():
        if img.dtype != np.uint8 or img.shape != (IMAGE_HW, IMAGE_HW, 3):
            fail(f"frame {f}: {img.dtype} {img.shape}")
        if img.min() == img.max():
            fail(f"frame {f} is constant ({img.min()})")
    idle = [name for name, n in launches.items() if n == 0]
    if idle:
        fail(f"kernels never launched on the main path: {idle}")

    t0 = time.perf_counter()
    sampler.sample_anchored(ctx, tgt, torch.Generator("cuda").manual_seed(2))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    emit(phase="main_path", what="anchored sampling, 1 context + 16 targets, 256 px, "
         "25 DDIM steps, CFG 3.0, bf16", frames=len(frames),
         first_pass_s=cold_s, second_pass_s=warm_s,
         frames_per_s=N_TARGET / warm_s, launches=launches,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
         frame_mean=float(np.mean([img.mean() for img in frames.values()])),
         card=card)
    return engine, launches


def profile_phase(card: str, engine) -> None:
    """Device time by kernel for one denoise step at the anchor launch's
    shape (batched CFG: 2 rows x 5 views at 32x32 latents)."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator("cuda").manual_seed(4)
    ctx = torch.randn((1, 1, 32, 32, 4), generator=gen, device="cuda")
    x_t = torch.randn((1, 4, 32, 32, 4), generator=gen, device="cuda")
    extr = torch.eye(4, device="cuda").repeat(1, 5, 1, 1)
    extr[:, :, 0, 3] = torch.linspace(0, 1, 5, device="cuda")
    intr = torch.eye(3, device="cuda").repeat(1, 5, 1, 1)
    intr[:, :, :2, 2] = 0.5
    rays = engine.ray_encode(extr, intr, (32, 32))
    step = lambda: engine.denoise_step(x_t, 500, ctx, rays)  # noqa: E731
    n_steps = 3
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        step()
    torch.cuda.synchronize()
    wall_off_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    by_kernel = {}
    for evt in device:
        ms = (evt.time_range.end - evt.time_range.start) / 1e3 / n_steps
        by_kernel[evt.key] = by_kernel.get(evt.key, 0.0) + ms

    def group(name: str) -> str:
        n = name.lower()
        if "flash_fwd" in n:
            return "flash_attention kernel"
        if "gemm_kernel" in n and "gemm_tile" in n:
            return "fused LN+attn / LN+FF GEMM kernels"
        if "conv" in n or "implicit" in n or "winograd" in n or "nchw" in n or "nhwc" in n:
            return "convolution (cuDNN)"
        if any(w in n for w in ("gemm", "xmma", "cutlass", "matmul", "nvjet")):
            return "matmul (cuBLAS)"
        if "norm" in n:
            return "GroupNorm / LayerNorm"
        return "elementwise / copies / other"

    if not by_kernel:
        fail("torch.profiler recorded no device time")
    groups = {}
    for name, ms in by_kernel.items():
        groups[group(name)] = groups.get(group(name), 0.0) + ms
    busy = sum(by_kernel.values())
    span_ms = (max(e.time_range.end for e in device)
               - min(e.time_range.start for e in device)) / 1e3 / n_steps
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    emit(phase="profile", what="one anchor-launch denoise step (2 rows x 5 views, "
         "32x32 latents, batched CFG), mean of 3; idle_share = 1 - busy / span "
         "over the profiled window's device events (the profiler's own host "
         "cost widens the gaps); wall_ms in that window, wall_profiler_off_ms "
         "in a window of its own", wall_ms=wall_ms, wall_profiler_off_ms=wall_off_ms,
         device_span_ms=span_ms, device_busy_ms=busy, idle_share=1.0 - busy / span_ms,
         device_kernels_per_step=len(device) / n_steps,
         by_group_ms=dict(sorted(groups.items(), key=lambda kv: -kv[1])),
         top_kernels_ms=[[k[:80], v] for k, v in top], card=card)


def unet_parity_phase(card: str, engine) -> None:
    from mvldm_tpu_torch.builder import build_flagship

    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    cpu_engine = build_flagship("cpu", torch.float32)
    b, v, hw = 2, 5, 32
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((b, v, hw, hw, 11), generator=gen)
    t = torch.tensor([[0, 500, 500, 500, 500]] * b)
    mask = torch.tensor([[True] * v, [False] + [True] * (v - 1)])
    with torch.inference_mode():
        gpu = engine.unet(x.cuda(), t.cuda(), view_mask=mask.cuda()).float().cpu()
        cpu = cpu_engine.unet(x, t, view_mask=mask)
    rel = (torch.linalg.norm(gpu - cpu) / torch.linalg.norm(cpu)).item()
    emit(phase="unet_parity", what="batched-CFG UNet forward, 2 rows x 5 views, "
         "32x32 latents, view mask: card bf16 kernels vs host f32 plain",
         rel_l2=rel, bound=UNET_REL_L2_BOUND, cpu_side_s=time.perf_counter() - t0,
         finite=bool(torch.isfinite(gpu).all()), card=card)
    if not torch.isfinite(gpu).all() or not rel <= UNET_REL_L2_BOUND:
        fail(f"UNet parity rel L2 {rel:.4g} > {UNET_REL_L2_BOUND}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    from mvldm_tpu_torch.ops import _build
    from mvldm_tpu_torch.ops.attention import flash_attention
    from mvldm_tpu_torch.ops.fused_attn import fused_ln_self_attention
    from mvldm_tpu_torch.ops.fused_ff import fused_ln_geglu_ff

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    t_start = time.perf_counter()
    logs = _build.build()
    emit(phase="build", seconds=time.perf_counter() - t_start,
         per_source_s={k: s for k, (s, _) in logs.items()}, card=card)

    gen = torch.Generator("cuda").manual_seed(0)
    results = {
        "flash_attention": attention_phase(card, gen),
        "fused_ln_self_attention": fused_attn_phase(card, gen),
        "fused_ln_geglu_ff": fused_ff_phase(card, gen),
    }
    kernels = (flash_attention, fused_ln_self_attention, fused_ln_geglu_ff)
    engine, launches = main_path_phase(card, kernels)
    profile_phase(card, engine)
    unet_parity_phase(card, engine)

    meta = {
        "flash_attention": ("mvldm_tpu_torch/csrc/flash_attn_fwd.cu",
                            "mvldm_tpu/ops/attention.py:76"),
        "fused_ln_self_attention": ("mvldm_tpu_torch/csrc/fused_ln_attn.cu",
                                    "mvldm_tpu/ops/fused_attn.py:65"),
        "fused_ln_geglu_ff": ("mvldm_tpu_torch/csrc/fused_ln_geglu_ff.cu",
                              "mvldm_tpu/ops/fused_ff.py:75"),
    }
    emit(kernels=[
        dict(name=name, route="cuda", source=meta[name][0], replaces=meta[name][1],
             launches=launches[name], max_abs_err=r["max_abs_err"], ms=r["ms"],
             plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
             library_ms=r["library_ms"], timed_shape=r["shape"])
        for name, r in results.items()
    ])
    emit(phase="total", seconds=time.perf_counter() - t_start, card=card)
    print(card, flush=True)
    emit(ok=True, device={"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
