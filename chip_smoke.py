"""Smoke test of the PyTorch/CUDA port (mvldm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no final result line):

1. device and build: the card's name and power limit; the CUDA kernels are
   compiled from mvldm_tpu_torch/csrc with nvcc (one process per source,
   all started together).
2. one phase per kernel of sampling and training at the main paths'
   shapes: the kernel against its plain PyTorch version computed in f32 on
   the same bf16 inputs (see ``check``), device times of both (CUDA graph
   replay between CUDA events), the lower bound max(flops / 989 TFLOP/s,
   bytes / 3.35 TB/s) of an H100 SXM, and for attention the time of
   torch's scaled_dot_product_attention (its backward for the backward
   kernels) as a yardstick. The backward phase covers every attention
   shape of a training step and also holds the forward's lse output.
3. the microbenchmark path (mvldm_tpu_torch.tools.bench_attn_micro):
   every section (matmul exp flash fullk floor) at the tool's shapes, as
   ``python -m mvldm_tpu_torch.tools.bench_attn_micro`` runs them, with
   launch counters. Each probe call's kernel output is held against the
   plain version on the same inputs (attention two batch rows at a time),
   and the call reports device times of kernel, plain version and library
   call (cuBLAS, SDPA, torch.exp) and the bound at its route's peak (bf16
   989, TF32 495, FP32 FFMA 67 TFLOP/s), one JSON line per probe call.
   Every probe kernel's launch count must rise in this run. Then flash and
   fullk at a ragged L = 1000 against their plain versions.
4. the sampling path: build_flagship("cuda") (the 0.93B SD2.1 multi-view
   UNet and the SD2.1 VAE, bf16, seeded random weights) and anchored
   sampling of one synthetic scene (1 context + 16 target frames at 256 px,
   25 DDIM steps, CFG 3.0). Every forward kernel's launch count must rise
   in this run.
5. a profile of one anchor-launch denoise step: device time by kernel
   group and the device's idle share within the profiled window
   (torch.profiler).
6. full-width UNet parity: one batched-CFG UNet forward (2 rows x 5 views,
   32x32 latents, view mask) on the card in bf16 with the kernels against
   the host CPU in f32 with the plain versions.
7. train-step parity: loss and UNet gradient of one training step at batch
   1 with injected draws, the card (bf16, kernels) against the host CPU
   (f32, plain versions).
8. the training path: build_flagship_train("cuda") and the baseline
   optimizer (AdamW, lr 2e-5, LinearLR from 5e-4 over 200 steps, clip 0.1,
   bf16 first moment) at batch 2 (2 context + 3 target views at 256 px,
   images through the frozen VAE): 1 warm-up step, 5 timed steps with the
   launch counts of all five kernels, which must each rise, and one step
   with block remat for its peak memory.
9. a profile of one training step: device time by kernel group, the flash
   backward on its own, and the idle share.

Every result is one JSON line. The last two lines are the card as
``nvidia-smi`` names it and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from mvldm_tpu_torch.tools.measure import bound, card_line, event_ms, nbytes, time_ms

# A kernel's own error, as a share of the rms of what it computes (see check).
KERNEL_REL_LIMIT = 0.05
UNET_REL_L2_BOUND = 3e-2
TRAIN_LOSS_REL_BOUND = 3e-2
TRAIN_GRAD_REL_L2_BOUND = 1e-1
N_TARGET = 16
TRAIN_BATCH = 2
TRAIN_STEPS = 5


def emit(**record) -> None:
    print(json.dumps(record), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(out, ref, what: str, residual=None) -> dict:
    """Hold a bf16 kernel output against its f32 plain version.

    A bf16 output cannot come closer to the f32 value than half a bf16 step
    of itself, so that step is taken off each element's error (none from
    an f32 output); what is left
    is the kernel's own error, which must stay within KERNEL_REL_LIMIT of
    the rms of what the kernel computes: the output for attention, and
    ``out - x`` for a residual block, whose x (~1) would otherwise hide an
    error as large as the block's own contribution (~0.1)."""
    o = out.float()
    _, e = torch.frexp(o)
    half_step = torch.where(o == 0, torch.zeros_like(o),
                            torch.ldexp(torch.ones_like(o), e - 9))
    if out.dtype == torch.float32:  # the lse and dbias outputs
        half_step = torch.zeros_like(o)
    err = (o - ref).abs()
    own = (err - half_step).clamp_min(0).max().item()
    delta = ref if residual is None else ref - residual.float()
    rms = delta.square().mean().sqrt().item()
    rec = dict(max_abs_err=err.max().item(), kernel_err=own,
               kernel_err_limit=KERNEL_REL_LIMIT * rms, rms_computed=rms,
               err_over_rms=own / rms)
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


def flash_bwd_phase(card: str, gen) -> dict:
    """The forward's lse and both backward kernels at every attention shape
    of a training step (batch 2 x 5 views), against the plain chunked
    backward; times of each kernel, of the plain backward and of
    scaled_dot_product_attention's backward (its forward + backward less
    its forward, with the same float mask)."""
    import torch.nn.functional as F

    from mvldm_tpu_torch.ops.attention import (
        attention_bwd_reference,
        attention_reference_lse,
        flash_attention,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
    )

    # (label, B, H, L, D, bias): B = 2 examples for the joint attention,
    # 2 x 5 frames for the per-frame ones.
    cases = [
        ("joint 32x32 (C=320)", 2, 8, 5 * 1024, 40, True),
        ("joint 16x16 (C=640)", 2, 8, 5 * 256, 80, True),
        ("joint 8x8 (C=1280)", 2, 8, 5 * 64, 160, True),
        ("joint 4x4 (C=1280)", 2, 8, 5 * 16, 160, True),
        ("SD attn1 32x32 (C=320)", 10, 5, 1024, 64, False),
        ("SD attn1 16x16 (C=640)", 10, 10, 256, 64, False),
        ("SD attn1 8x8 (C=1280)", 10, 20, 64, 64, False),
        ("SD attn1 4x4 (C=1280)", 10, 20, 16, 64, False),
        ("per-frame attn2 32x32 (C=320)", 10, 8, 1024, 40, False),
        ("per-frame attn2 16x16 (C=640)", 10, 8, 256, 80, False),
        ("per-frame attn2 8x8 (C=1280)", 10, 8, 64, 160, False),
        ("per-frame attn2 4x4 (C=1280)", 10, 8, 16, 160, False),
    ]
    out_recs = {}
    max_err = {"flash_attention_bwd_dq": 0.0, "flash_attention_bwd_dkv": 0.0}
    for label, b, h, l, d, with_bias in cases:
        q, k, v, g = (torch.randn((b, h, l, d), generator=gen, device="cuda",
                                  dtype=torch.bfloat16) for _ in range(4))
        bias = None
        if with_bias:
            # An unconditional row masks its context view out of the keys.
            bias = torch.zeros((b, l), device="cuda")
            bias[1:, : l // 5] = -1e30
        out, lse = flash_attention(q, k, v, bias, return_lse=True)
        _, ref_lse = attention_reference_lse(q.float(), k.float(), v.float(), bias)
        acc = {"lse": check(lse, ref_lse, f"flash_attention lse {label}")}
        dq, delta = flash_attention_bwd_dq(q, k, v, bias, out, lse, g)
        dk, dv, dbias = flash_attention_bwd_dkv(q, k, v, bias, lse, delta, g)
        ref = attention_bwd_reference(q.float(), k.float(), v.float(), bias, g.float())
        for name, got, want in (("dq", dq, ref[0]), ("dk", dk, ref[1]), ("dv", dv, ref[2]),
                                ("dbias", None if dbias is None else dbias.sum(1), ref[3])):
            if want is not None:
                acc[name] = check(got, want, f"flash_attention_bwd {name} {label}")
        del ref
        max_err["flash_attention_bwd_dq"] = max(max_err["flash_attention_bwd_dq"],
                                                acc["dq"]["max_abs_err"])
        max_err["flash_attention_bwd_dkv"] = max(
            max_err["flash_attention_bwd_dkv"],
            *(acc[n]["max_abs_err"] for n in ("dk", "dv", "dbias") if n in acc))
        iters = 10 if l >= 1024 else 50
        dq_ms = time_ms(lambda: flash_attention_bwd_dq(q, k, v, bias, out, lse, g), iters)
        dkv_ms = time_ms(lambda: flash_attention_bwd_dkv(q, k, v, bias, lse, delta, g), iters)
        plain_ms = time_ms(lambda: attention_bwd_reference(q, k, v, bias, g), 3)
        mask = None if bias is None else bias[:, None, None, :].to(q.dtype)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

        def lib_fwd():
            return F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)

        lib_ms = (event_ms(lambda: torch.autograd.grad(lib_fwd(), (qg, kg, vg), g), iters)
                  - event_ms(lib_fwd, iters))
        work = b * h * l * l * d
        dq_bound = bound(6.0 * work, nbytes(q, k, v, out, g, lse, bias, dq, delta))
        dkv_bound = bound(8.0 * work, nbytes(q, k, v, g, lse, delta, bias, dk, dv, dbias))
        bwd_bound = bound(10.0 * work, nbytes(q, k, v, out, g, lse, bias, dq, dk, dv, dbias))
        rec = dict(phase="kernel", kernel="flash_attention_bwd", shape=label, B=b, H=h, L=l,
                   D=d, bias=with_bias, **{f"{n}_check": a for n, a in acc.items()},
                   dq_ms=dq_ms, dkv_ms=dkv_ms, bwd_ms=dq_ms + dkv_ms, plain_ms=plain_ms,
                   library_ms=lib_ms, dq_bound_ms=dq_bound[0], dq_bound_by=dq_bound[1],
                   dkv_bound_ms=dkv_bound[0], dkv_bound_by=dkv_bound[1],
                   bwd_bound_ms=bwd_bound[0], bwd_bound_by=bwd_bound[1], card=card)
        emit(**rec)
        if not out_recs:
            common = dict(shape=label, plain_ms=plain_ms, library_ms=lib_ms)
            out_recs["flash_attention_bwd_dq"] = dict(
                common, ms=dq_ms, bound_ms=dq_bound[0], bound_by=dq_bound[1])
            out_recs["flash_attention_bwd_dkv"] = dict(
                common, ms=dkv_ms, bound_ms=dkv_bound[0], bound_by=dkv_bound[1])
        del q, k, v, g, out, lse, dq, dk, dv, dbias, qg, kg, vg
        torch.cuda.empty_cache()
    return {name: dict(rec, max_abs_err=max_err[name]) for name, rec in out_recs.items()}


# ------------------------------------------------ attention microbenchmark

# Where the four probe kernels stand and what they replace; the kernels line
# takes each probe's first case of the run.
MICRO_META = {
    "matmul": ("mvldm_tpu_torch/csrc/micro_matmul.cu", "tools/bench_attn_micro.py:59"),
    "fullk": ("mvldm_tpu_torch/csrc/micro_attn.cu", "tools/bench_attn_micro.py:91"),
    "flash": ("mvldm_tpu_torch/csrc/micro_attn.cu", "tools/bench_attn_micro.py:163"),
    "exp": ("mvldm_tpu_torch/csrc/micro_exp.cu", "tools/bench_attn_micro.py:249"),
}
MICRO_PLAIN_ROWS = 2  # batch rows per call of an attention probe's plain version
MICRO_RAGGED_L = 1000  # not a multiple of the kernels' 64-row tiles


def _jsonable(v):
    return v if v is None or isinstance(v, (bool, int, float, str)) else str(v)


def _plain_by_rows(plain, *inputs):
    """An attention probe's plain version over MICRO_PLAIN_ROWS batch rows at
    a time (its f32 score matrix at b = 16, L = 5120 would take 13.4 GB);
    the matmul and exp plain versions in one call."""
    if inputs[0].dim() != 4:
        return plain(*inputs)
    return torch.cat([plain(*(t[i:i + MICRO_PLAIN_ROWS] for t in inputs))
                      for i in range(0, inputs[0].shape[0], MICRO_PLAIN_ROWS)])


def micro_check(case, out) -> dict:
    """A probe kernel's output against its plain version on the same inputs:
    bf16 outputs by ``check`` against the plain version on f32 inputs; the
    f32 matmul within relative L2 1e-5 of the product in float64, exp within
    1e-6 relative of exp in float64. Adds the plain version's device time."""
    what = f"micro probe on {[(tuple(t.shape), str(t.dtype)) for t in case.inputs]}"
    if out.dtype == torch.float32:
        x64 = [t.double() for t in case.inputs]
        if len(x64) == 2:  # matmul
            ref = x64[0] @ x64[1]
            err = (torch.linalg.norm(out.double() - ref) / torch.linalg.norm(ref)).item()
            limit = 1e-5
        else:
            ref = torch.exp(x64[0])
            err, limit = ((out.double() - ref).abs() / ref).max().item(), 1e-6
        acc = dict(max_abs_err=(out.double() - ref).abs().max().item(), kernel_err=err,
                   kernel_err_limit=limit)
        if not torch.isfinite(out).all() or not err <= limit:
            fail(f"{what}: f32 error {err:.4g} > {limit}")
    else:
        ref = _plain_by_rows(case.plain, *(t.float() for t in case.inputs))
        acc = check(out, ref, what)
    del out, ref
    acc["plain_ms"] = time_ms(lambda: _plain_by_rows(case.plain, *case.inputs), 3)
    return acc


def micro_phase(card: str):
    """Every section of the tool at its shapes with the launch counters set
    to 0, each probe's kernel output held against its plain version on the
    same inputs as it runs; then the ragged-L checks. Returns the kernels
    line's records and the launch counts."""
    from mvldm_tpu_torch.tools import bench_attn_micro as micro

    for fn in micro.KERNELS:
        fn.launches = 0
    t0 = time.perf_counter()
    results = micro.run(micro.SECTIONS, check=micro_check)
    seconds = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in micro.KERNELS}
    for r in results:
        emit(phase="micro", **{k: _jsonable(v) for k, v in r.items() if k != "case"},
             case={k: _jsonable(v) for k, v in r["case"].items()}, card=card)
    emit(phase="micro_run", what="python -m mvldm_tpu_torch.tools.bench_attn_micro "
         "matmul exp flash fullk floor", probe_calls=len(results), seconds=seconds,
         launches=launches, card=card)
    idle = [name for name, n in launches.items() if n == 0]
    if idle:
        fail(f"probe kernels never launched on the microbenchmark path: {idle}")

    shape = (2, 8, MICRO_RAGGED_L, 40)
    ragged = [(f"flash dot={dt}", micro.flash_case(*shape, dt))
              for dt in (torch.float32, torch.bfloat16)]
    ragged += [(f"fullk do_max={m}", micro.fullk_case(*shape, m)) for m in (True, False, "none")]
    for label, case in ragged:
        emit(phase="micro_ragged", probe=label, shape=shape,
             **micro_check(case, case.kernel(*case.inputs)), card=card)

    records = {}
    for name in MICRO_META:
        mine = [r for r in results if r["probe"] == name]
        records[name] = dict(mine[0], shape={k: _jsonable(v) for k, v in mine[0]["case"].items()},
                             max_abs_err=max(r["max_abs_err"] for r in mine))
    return records, launches


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

    emit(phase="profile", what="one anchor-launch denoise step (2 rows x 5 views, "
         "32x32 latents, batched CFG), mean of 3; idle_share = 1 - busy / span "
         "over the profiled window's device events (the profiler's own host "
         "cost widens the gaps); wall_ms in that window, wall_profiler_off_ms "
         "in a window of its own", wall_ms=wall_ms, wall_profiler_off_ms=wall_off_ms,
         **device_breakdown(prof, n_steps), card=card)


def kernel_group(name: str) -> str:
    n = name.lower()
    if "flash_bwd" in n:
        return "flash attention backward kernels (dQ, dK/dV)"
    if "flash_fwd" in n:
        return "flash_attention kernel"
    if "gemm_kernel" in n and "gemm_tile" in n:
        return "fused LN+attn / LN+FF GEMM kernels"
    if "multi_tensor" in n:
        return "optimizer (multi-tensor foreach)"
    if "normtwo" in n:
        return "gradient global norm (reductions)"
    if "conv" in n or "implicit" in n or "winograd" in n or "nchw" in n or "nhwc" in n:
        return "convolution (cuDNN)"
    if any(w in n for w in ("gemm", "xmma", "cutlass", "matmul", "nvjet")):
        return "matmul (cuBLAS)"
    if "norm" in n:
        return "GroupNorm / LayerNorm"
    return "elementwise / copies / other"


def device_breakdown(prof, n_steps: int) -> dict:
    """Device ms per step by kernel group, busy and span of the profiled
    window's device events, and the idle share 1 - busy / span."""
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device:
        fail("torch.profiler recorded no device time")
    by_kernel = {}
    for evt in device:
        ms = (evt.time_range.end - evt.time_range.start) / 1e3 / n_steps
        by_kernel[evt.key] = by_kernel.get(evt.key, 0.0) + ms
    groups = {}
    for name, ms in by_kernel.items():
        groups[kernel_group(name)] = groups.get(kernel_group(name), 0.0) + ms
    busy = sum(by_kernel.values())
    span_ms = (max(e.time_range.end for e in device)
               - min(e.time_range.start for e in device)) / 1e3 / n_steps
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    return dict(device_span_ms=span_ms, device_busy_ms=busy, idle_share=1.0 - busy / span_ms,
                device_kernels_per_step=len(device) / n_steps,
                by_group_ms=dict(sorted(groups.items(), key=lambda kv: -kv[1])),
                top_kernels_ms=[[k[:80], v] for k, v in top])


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
    return cpu_engine


# -------------------------------------------------------------- training

def train_parity_phase(card: str, engine, cpu_engine) -> None:
    """Loss and UNet gradient of one training step at batch 1 (2 context + 3
    target views at 256 px) with the same injected draws: the card (bf16,
    kernels) against the host CPU (f32, plain versions), same weights."""
    from mvldm_tpu_torch.builder import make_train_batch
    from mvldm_tpu_torch.diffusion.engine import TrainDraws

    batch = make_train_batch(1)
    draws = TrainDraws.draw(1, 5, 2, (32, 32, 4), 1000, torch.Generator().manual_seed(7))
    t0 = time.perf_counter()

    def loss_and_grads(engine):
        loss, _ = engine.training_loss(batch, 2, draws)
        loss.backward()
        grads = {n: (p.grad.float().cpu() if p.grad is not None else torch.zeros(p.shape))
                 for n, p in engine.unet.named_parameters()}
        for p in engine.unet.parameters():
            p.grad = None
        return loss.item(), grads

    gpu_loss, gpu = loss_and_grads(engine)
    cpu_loss, cpu = loss_and_grads(cpu_engine)
    loss_rel = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    num = sum((gpu[n] - cpu[n]).square().sum().item() for n in cpu)
    den = sum(cpu[n].square().sum().item() for n in cpu)
    rel = (num / den) ** 0.5
    per_tensor = sorted(
        ((torch.linalg.norm(gpu[n] - cpu[n]) / torch.linalg.norm(cpu[n])).item(), n)
        for n in cpu if torch.linalg.norm(cpu[n]) > 0)
    finite = all(torch.isfinite(gpu[n]).all() for n in gpu) and np.isfinite(gpu_loss)
    emit(phase="train_parity", what="one training step at batch 1 (2 ctx + 3 tgt, 256 px, "
         "injected draws): loss and flattened UNet gradient, card bf16 kernels vs host f32 "
         "plain", gpu_loss=gpu_loss, cpu_loss=cpu_loss, loss_rel_err=loss_rel,
         loss_bound=TRAIN_LOSS_REL_BOUND, grad_rel_l2=rel, grad_bound=TRAIN_GRAD_REL_L2_BOUND,
         worst_tensors=[[n, r] for r, n in per_tensor[::-1][:5]],
         n_zero_grad_tensors=len(cpu) - len(per_tensor), finite=bool(finite),
         seconds=time.perf_counter() - t0, card=card)
    if not finite or not loss_rel <= TRAIN_LOSS_REL_BOUND or not rel <= TRAIN_GRAD_REL_L2_BOUND:
        fail(f"train parity: loss rel {loss_rel:.4g}, grad rel L2 {rel:.4g}")


def train_phase(card: str, engine, kernels):
    """The training path at batch 2 with the baseline optimizer: 1 warm-up
    step, TRAIN_STEPS timed steps with launch counters, then one step with
    block remat for its peak memory. Returns what the profile phase reuses."""
    from mvldm_tpu_torch.builder import make_train_batch
    from mvldm_tpu_torch.training import (
        LRSchedulerCfg,
        OptimizerCfg,
        build_lr_schedule,
        build_optimizer,
        make_train_step,
    )
    from mvldm_tpu_torch.training.trainer import TrainState, master_params

    tx = build_optimizer(
        OptimizerCfg("AdamW", 2e-5, {"mu_dtype": "bfloat16"}),
        build_lr_schedule(2e-5, LRSchedulerCfg("LinearLR", {"start_factor": 5e-4,
                                                            "total_iters": 200})),
        gradient_clip_val=0.1)
    params = master_params(engine.unet)
    state = TrainState(params=params, opt_state=tx.init(params), ema_params=None, step=0)
    step = make_train_step(engine, tx, num_context_views=2)
    batch = make_train_batch(TRAIN_BATCH)
    gen = torch.Generator("cuda").manual_seed(5)

    t0 = time.perf_counter()
    state, metrics = step(state, batch, generator=gen)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    losses = [metrics["loss/diffusion"]]

    for fn in kernels:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, metrics = step(state, batch, generator=gen)
        losses.append(metrics["loss/diffusion"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernels}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(x) for x in losses]

    engine.unet.remat = True
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, metrics = step(state, batch, generator=gen)
    torch.cuda.synchronize()
    remat_s = time.perf_counter() - t0
    remat_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses.append(float(metrics["loss/diffusion"]))

    # Peak of the loss and its backward alone, above the memory held before
    # it (weights, masters, moments): the activations remat trades for time.
    activations = {}
    for remat in (False, True):
        engine.unet.remat = remat
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        engine.training_loss(batch, 2, generator=gen)[0].backward()
        torch.cuda.synchronize()
        activations[f"remat_{remat}"] = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
        for p in engine.unet.parameters():
            p.grad = None
    engine.unet.remat = False

    emit(phase="train", what=f"training steps at batch {TRAIN_BATCH} (2 ctx + 3 tgt, 256 px, "
         "images through the frozen VAE), AdamW lr 2e-5 LinearLR(5e-4, 200) clip 0.1 bf16 mu, "
         "bf16 UNet with f32 masters; losses: warm-up, timed steps, remat step",
         warmup_s=warm_s, steps=TRAIN_STEPS, steps_per_s=TRAIN_STEPS / dt,
         step_ms=dt * 1e3 / TRAIN_STEPS, peak_memory_gb=peak, losses=losses,
         grad_norm_last=metrics["grad_norm"],
         launches_per_step={k: v / TRAIN_STEPS for k, v in launches.items()},
         remat_step_s=remat_s, remat_peak_memory_gb=remat_peak,
         loss_backward_peak_above_held_gb=activations, card=card)
    if not all(np.isfinite(x) for x in losses):
        fail(f"non-finite training loss: {losses}")
    idle = [name for name, n in launches.items() if n == 0]
    if idle:
        fail(f"kernels never launched on the training path: {idle}")
    return state, step, batch, gen, launches


def train_profile_phase(card: str, state, step, batch, gen) -> None:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch, generator=gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    emit(phase="train_profile", what=f"one training step at batch {TRAIN_BATCH}, "
         "optimizer included; idle_share = 1 - busy / span over the profiled window's "
         "device events", wall_ms=wall_ms, **device_breakdown(prof, 1), card=card)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    from mvldm_tpu_torch.builder import build_flagship_train
    from mvldm_tpu_torch.ops import _build
    from mvldm_tpu_torch.ops.attention import (
        flash_attention,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
    )
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
        **flash_bwd_phase(card, gen),
    }
    micro_records, micro_launches = micro_phase(card)
    forward = (flash_attention, fused_ln_self_attention, fused_ln_geglu_ff)
    engine, sampling_launches = main_path_phase(card, forward)
    profile_phase(card, engine)
    cpu_engine = unet_parity_phase(card, engine)
    del engine
    torch.cuda.empty_cache()

    engine = build_flagship_train("cuda")
    train_parity_phase(card, engine, cpu_engine)
    del cpu_engine
    state, step, batch, train_gen, train_launches = train_phase(
        card, engine, forward + (flash_attention_bwd_dq, flash_attention_bwd_dkv))
    train_profile_phase(card, state, step, batch, train_gen)

    meta = {
        "flash_attention": ("mvldm_tpu_torch/csrc/flash_attn_fwd.cu",
                            "mvldm_tpu/ops/attention.py:76"),
        "flash_attention_bwd_dq": ("mvldm_tpu_torch/csrc/flash_attn_bwd.cu",
                                   "mvldm_tpu/ops/attention.py:282"),
        "flash_attention_bwd_dkv": ("mvldm_tpu_torch/csrc/flash_attn_bwd.cu",
                                    "mvldm_tpu/ops/attention.py:324"),
        "fused_ln_self_attention": ("mvldm_tpu_torch/csrc/fused_ln_attn.cu",
                                    "mvldm_tpu/ops/fused_attn.py:65"),
        "fused_ln_geglu_ff": ("mvldm_tpu_torch/csrc/fused_ln_geglu_ff.cu",
                              "mvldm_tpu/ops/fused_ff.py:75"),
    }
    emit(kernels=[
        dict(name=name, route="cuda", source=meta[name][0], replaces=meta[name][1],
             launches=sampling_launches.get(name, 0) + train_launches[name],
             launches_by_path={"sampling": sampling_launches.get(name, 0),
                               "training": train_launches[name]},
             max_abs_err=r["max_abs_err"], ms=r["ms"],
             plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
             library_ms=r["library_ms"], timed_shape=r["shape"])
        for name, r in results.items()
    ] + [
        dict(name=f"bench_attn_micro.{name}", route="cuda", source=MICRO_META[name][0],
             replaces=MICRO_META[name][1], launches=micro_launches[name],
             launches_by_path={"micro": micro_launches[name]},
             max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
             bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
             timed_shape=r["shape"])
        for name, r in micro_records.items()
    ])
    emit(phase="total", seconds=time.perf_counter() - t_start, card=card)
    print(card, flush=True)
    emit(ok=True, device={"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
