"""Smoke test of the PyTorch/CUDA port (mvldm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no final result line):

1. device and build: the card's name and power limit; the CUDA kernels are
   compiled from mvldm_tpu_torch/csrc with nvcc (one process per source,
   all started together), with ptxas's registers and spills for every
   kernel; the f32 route's split-TF32 instances (the forward's nine, the
   backward's ten and the GEMM tile's two) and the matmul probe's f32
   instance of that tile must show HGMMA on TF32 operands, and no HMMA, in
   the libraries' SASS (cuobjdump), and none of the FFMA bodies they
   replaced (flash_fwd_f32, gemm_f32, matmul_f32_kernel) may be left.
2. one phase per kernel of sampling and training at the main paths'
   shapes: the kernel against its plain PyTorch version computed in f32 on
   the same bf16 inputs (see ``check``), device times of both (CUDA graph
   replay between CUDA events), the lower bound max(flops / 989 TFLOP/s,
   bytes / 3.35 TB/s) of an H100 SXM, and for attention the time of
   torch's scaled_dot_product_attention (its backward for the backward
   kernels) as a yardstick. Each forward line and each backward shape's
   line carries the kernel's exp floor (its B H Lq Lk exp2 at 16 a clock on
   each of the card's SMs) beside its bound; the backward phase covers
   every attention shape of a training step and also holds the forward's
   lse output. Each fused block's line also carries the decomposed cuBLAS
   path's time on the same inputs (``decomposed_ms``; no single PyTorch
   call computes the fused function) and each of its GEMM launches on its
   own: own error, device time, bound and the cuBLAS product of the same
   operands.
3. the microbenchmark path (mvldm_tpu_torch.tools.bench_attn_micro):
   every section (matmul exp flash fullk floor) at the tool's shapes, as
   ``python -m mvldm_tpu_torch.tools.bench_attn_micro`` runs them, with
   launch counters. Each probe call's kernel output is held against the
   plain version on the same inputs (attention two batch rows at a time),
   and the call reports device times of kernel, plain version and library
   call (cuBLAS, SDPA, torch.exp; for the f32-dot flash also SDPA on f32
   copies of its inputs, the same function, with the backend it ran), the
   bound at the route's peak (bf16 989 TFLOP/s, or three TF32 products at
   494.7 for the f32 matmul, the FFMA bound beside it, or the bytes; for
   fullk with the max also the products its two passes run)
   and, for flash and fullk, the exp floor, one JSON line per probe call.
   The f32-dot flash's own error must also stay within
   bench_attn_micro.F32_FLASH_REL_LIMIT of the rms. Every probe kernel's
   launch count must rise in this run. Then flash and fullk at a ragged
   L = 1000 against their plain versions.
4. the sampling path: build_flagship("cuda") (the 0.93B SD2.1 multi-view
   UNet and the SD2.1 VAE, bf16, seeded random weights) and anchored
   sampling of one synthetic scene (1 context + 16 target frames at 256 px,
   25 DDIM steps, CFG 3.0). Every forward kernel's launch count must be
   what a scene takes (SCENE_LAUNCHES), and no f32-route kernel may launch.
5. a profile of one anchor-launch denoise step: device time by kernel
   group and the device's idle share within the profiled window
   (torch.profiler).
6. full-width UNet parity: one batched-CFG UNet forward (2 rows x 5 views,
   32x32 latents, view mask) on the card in bf16 with the kernels against
   the host CPU in f32 with the plain versions.
7. the f32 route (mvldm_tpu_torch.ops.f32_route, csrc/f32_route.cu, every
   product split TF32 on wgmma): each of its wrappers at the f32 UNet's
   shapes against its plain version in f32 (relative L2 within
   F32_KERNEL_REL_L2), with device times; the forward (the flash kernel up
   to D = 160, past it the GEMM tile's route: S, the row pass, P V), out
   and lse, at every sampling shape, with SDPA in f32 and its backend, the
   bound at three TF32 products for each f32 one (494.7 TFLOP/s), the FFMA
   bound beside it and the instance's shared memory; the backward at the
   joint 32x32, 16x16 and 8x8 shapes, with SDPA's f32 backward and its
   backend and both bounds; the fused blocks with both bounds and each of
   their GEMM launches alone beside cuBLAS f32 (TF32 off); the GEMM tile
   and the row pass on their own; then the seeded flagship built in f32 on
   the card runs the UNet parity forward against the host's f32 output
   (F32_REL_L2_BOUND): every f32 forward kernel of the UNet must launch
   and no bf16 kernel may.
8. train-step parity: loss and UNet gradient of one training step at batch
   1 with injected draws, the card (bf16, kernels) against the host CPU
   (f32, plain versions); then the same step on the f32 engine against the
   same host step (F32_REL_L2_BOUND), every f32 kernel launched and no
   bf16 one.
9. the training path: build_flagship_train("cuda") and the baseline
   optimizer (AdamW, lr 2e-5, LinearLR from 5e-4 over 200 steps, clip 0.1,
   bf16 first moment) at batch 2 (2 context + 3 target views at 256 px,
   images through the frozen VAE): 1 warm-up step, 5 timed steps with the
   launch counts of all five kernels, which must each rise (and no
   f32-route kernel), and one step with block remat for its peak memory.
10. a profile of one training step: device time by kernel group, the flash
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

from mvldm_tpu_torch.tools.bench_attn_micro import plain_by_rows
from mvldm_tpu_torch.tools.measure import (
    bound,
    card_line,
    error_record,
    exp_floor_ms,
    nbytes,
    sdpa_bwd_ms,
    sm_clock_mhz,
    sm_count,
    time_ms,
)

# A kernel's own error, as a share of the rms of what it computes (see check).
KERNEL_REL_LIMIT = 0.05
UNET_REL_L2_BOUND = 3e-2
# The f32 route on the card against the host's f32: the same f32 arithmetic
# (TF32 off) summed in another order; a wrong term reads O(1e-2) or more. A
# kernel on its own sums a few hundred terms (~1e-6); the UNet forward, and
# a training step's loss and gradient, ~70 residual blocks.
F32_KERNEL_REL_L2 = 1e-5
F32_REL_L2_BOUND = 1e-3
# Forward-kernel launches of one 16-frame scene (one anchor launch, two fill
# launches), as the bf16 sampling path has taken them since the fused blocks
# and the forward were ported.
SCENE_LAUNCHES = {"flash_attention": 1706, "fused_ln_self_attention": 800,
                  "fused_ln_geglu_ff": 800}
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
    rec = error_record(out, ref, residual)
    own, rms = rec["kernel_err"], rec["rms_computed"]
    rec["kernel_err_limit"] = KERNEL_REL_LIMIT * rms
    if not torch.isfinite(out.float()).all() or not own <= KERNEL_REL_LIMIT * rms:
        fail(f"{what}: kernel error {own:.4g} (max abs {rec['max_abs_err']:.4g}) "
             f"outside {KERNEL_REL_LIMIT} x rms {rms:.4g}")
    return rec


def _counts(kernels) -> dict:
    """Each kernel wrapper's launch count."""
    return {fn.__name__: fn.launches for fn in kernels}


# --------------------------------------------------------------- kernels

def attention_phase(card: str, gen) -> dict:
    import torch.nn.functional as F

    from mvldm_tpu_torch.ops.attention import attention_reference, flash_attention
    from mvldm_tpu_torch.tools.kernel_compare import SAMPLING_SHAPES, attn_inputs

    n_sms = sm_count()
    headline = None
    max_err = 0.0
    for label, b, h, l, d, with_bias in SAMPLING_SHAPES:
        q, k, v, bias = attn_inputs(gen, b, h, l, d, with_bias)
        out = flash_attention(q, k, v, bias)
        ref = attention_reference(q.float(), k.float(), v.float(), bias)
        acc = check(out, ref, f"flash_attention {label}")
        max_err = max(max_err, acc["max_abs_err"])
        iters = 20 if l >= 1024 else 100
        ms = time_ms(lambda: flash_attention(q, k, v, bias), iters)
        sm_mhz = sm_clock_mhz()
        plain_ms = time_ms(lambda: attention_reference(q, k, v, bias), 3)
        mask = None if bias is None else bias[:, None, None, :].to(q.dtype)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
                         iters)
        bound_ms, bound_by = bound(4.0 * b * h * l * l * d, nbytes(q, k, v, bias, out))
        rec = dict(phase="kernel", kernel="flash_attention", shape=label,
                   B=b, H=h, L=l, D=d, bias=with_bias, **acc, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                   bound_by=bound_by, sm_mhz=sm_mhz, n_sms=n_sms,
                   exp_floor_ms=exp_floor_ms(b * h * l * l, sm_mhz, n_sms), card=card)
        emit(**rec)
        headline = headline or rec
        del q, k, v, out, ref
        torch.cuda.empty_cache()
    return dict(headline, max_abs_err=max_err)


def gemm_launches(calls) -> list:
    """Each GEMM launch of a fused block on its own (kernel_compare's
    GemmCall): this tree's kernel held against its plain version, its
    device time, its bound and the cuBLAS product of the same operands."""
    from mvldm_tpu_torch.ops import _build
    from mvldm_tpu_torch.tools.kernel_compare import SIGNATURES, gemm_error

    recs = []
    for call in calls:
        lib = _build.load(call.source, SIGNATURES[call.source])
        call.run(lib)
        err = gemm_error(call)
        if not err <= KERNEL_REL_LIMIT or not all(torch.isfinite(o.float()).all()
                                                  for o in call.outs):
            fail(f"{call.entry} {call.shape}: own error over rms {err:.4g}")
        bound_ms, bound_by = bound(call.flops, call.moved)
        recs.append(dict(entry=call.entry, ms=time_ms(lambda: call.run(lib)),
                         cublas_ms=time_ms(call.library), bound_ms=bound_ms,
                         bound_by=bound_by, err_over_rms=err))
    return recs


def fused_attn_phase(card: str, gen) -> dict:
    from mvldm_tpu_torch.ops.fused_attn import (
        _attn_decomposed,
        fused_ln_self_attention,
        fused_ln_self_attention_reference,
    )
    from mvldm_tpu_torch.tools.kernel_compare import (
        ATTN_BLOCK_SHAPES,
        attn_block_gemms,
        attn_block_inputs,
    )

    headline = None
    max_err = 0.0
    for label, n, l, c, heads, d in ATTN_BLOCK_SHAPES:
        hd = heads * d
        inputs = attn_block_inputs(gen, n, l, c, heads, d)
        x, g, b, wq, wk, wv, wo, bo = inputs
        args = (*inputs, heads, d)
        out = fused_ln_self_attention(*args)
        ref = fused_ln_self_attention_reference(
            x.float(), g, b, wq.float(), wk.float(), wv.float(), wo.float(), bo, heads, d)
        acc = check(out, ref, f"fused_ln_self_attention {label}", residual=x)
        max_err = max(max_err, acc["max_abs_err"])
        ms = time_ms(lambda: fused_ln_self_attention(*args), 20)
        plain_ms = time_ms(lambda: fused_ln_self_attention_reference(*args), 3)
        decomposed_ms = time_ms(lambda: _attn_decomposed(*args, 1e-6), 20)
        m = n * l
        flops = 2.0 * m * c * 3 * hd + 4.0 * n * heads * l * l * d + 2.0 * m * hd * c
        bound_ms, bound_by = bound(flops, nbytes(x, g, b, wq, wk, wv, wo, bo, out))
        rec = dict(phase="kernel", kernel="fused_ln_self_attention", shape=label,
                   N=n, L=l, C=c, H=heads, D=d, **acc, ms=ms, plain_ms=plain_ms,
                   library_ms=None, decomposed_ms=decomposed_ms, bound_ms=bound_ms,
                   bound_by=bound_by,
                   gemm_launches=gemm_launches(attn_block_gemms(label, *args, gen)),
                   card=card)
        emit(**rec)
        headline = headline or rec
    return dict(headline, max_abs_err=max_err)


def fused_ff_phase(card: str, gen) -> dict:
    from mvldm_tpu_torch.ops.fused_ff import (
        fused_ln_geglu_ff,
        fused_ln_geglu_ff_reference,
        ln_geglu_ff_decomposed,
    )
    from mvldm_tpu_torch.tools.kernel_compare import (
        FF_BLOCK_SHAPES,
        ff_block_gemms,
        ff_block_inputs,
    )

    headline = None
    max_err = 0.0
    for label, n, l, c in FF_BLOCK_SHAPES:
        args = ff_block_inputs(gen, n, l, c)
        x, g, b, w1, b1, w2, b2 = args
        out = fused_ln_geglu_ff(*args)
        ref = fused_ln_geglu_ff_reference(x.float(), g, b, w1.float(), b1, w2.float(), b2)
        acc = check(out, ref, f"fused_ln_geglu_ff {label}", residual=x)
        max_err = max(max_err, acc["max_abs_err"])
        ms = time_ms(lambda: fused_ln_geglu_ff(*args), 20)
        plain_ms = time_ms(lambda: fused_ln_geglu_ff_reference(*args), 3)
        decomposed_ms = time_ms(lambda: ln_geglu_ff_decomposed(*args), 20)
        bound_ms, bound_by = bound(24.0 * n * l * c * c, nbytes(x, g, b, w1, b1, w2, b2, out))
        rec = dict(phase="kernel", kernel="fused_ln_geglu_ff", shape=label, N=n, L=l,
                   C=c, **acc, ms=ms, plain_ms=plain_ms, library_ms=None,
                   decomposed_ms=decomposed_ms, bound_ms=bound_ms, bound_by=bound_by,
                   gemm_launches=gemm_launches(ff_block_gemms(label, *args, gen)),
                   card=card)
        emit(**rec)
        headline = headline or rec
    return dict(headline, max_abs_err=max_err)


def flash_bwd_phase(card: str, gen) -> dict:
    """The forward's lse and both backward kernels at every attention shape
    of a training step (batch 2 x 5 views), against the plain chunked
    backward; times of each kernel, of the plain backward and of
    scaled_dot_product_attention's backward (its forward + backward less
    its forward, with the same float mask). Beside each kernel's bound, its
    exp floor: the B H Lq Lk exp2 that each kernel takes (both rebuild P)
    at 16 a clock on each of the card's SMs, at the SM clock read just
    after its timing."""
    from mvldm_tpu_torch.ops.attention import (
        attention_bwd_reference,
        attention_reference_lse,
        flash_attention,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
    )
    from mvldm_tpu_torch.tools.kernel_compare import TRAIN_SHAPES, train_inputs

    n_sms = sm_count()
    out_recs = {}
    max_err = {"flash_attention_bwd_dq": 0.0, "flash_attention_bwd_dkv": 0.0}
    for label, b, h, l, d, with_bias in TRAIN_SHAPES:
        q, k, v, g, bias = train_inputs(gen, b, h, l, d, with_bias)
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
        sm_mhz = sm_clock_mhz()
        exp_ms = exp_floor_ms(b * h * l * l, sm_mhz, n_sms)
        plain_ms = time_ms(lambda: attention_bwd_reference(q, k, v, bias, g), 3)
        lib_ms = sdpa_bwd_ms(q, k, v, bias, g, iters)
        work = b * h * l * l * d
        dq_bound = bound(6.0 * work, nbytes(q, k, v, out, g, lse, bias, dq, delta))
        dkv_bound = bound(8.0 * work, nbytes(q, k, v, g, lse, delta, bias, dk, dv, dbias))
        bwd_bound = bound(10.0 * work, nbytes(q, k, v, out, g, lse, bias, dq, dk, dv, dbias))
        rec = dict(phase="kernel", kernel="flash_attention_bwd", shape=label, B=b, H=h, L=l,
                   D=d, bias=with_bias, **{f"{n}_check": a for n, a in acc.items()},
                   dq_ms=dq_ms, dkv_ms=dkv_ms, bwd_ms=dq_ms + dkv_ms, plain_ms=plain_ms,
                   library_ms=lib_ms, dq_bound_ms=dq_bound[0], dq_bound_by=dq_bound[1],
                   dkv_bound_ms=dkv_bound[0], dkv_bound_by=dkv_bound[1],
                   bwd_bound_ms=bwd_bound[0], bwd_bound_by=bwd_bound[1], sm_mhz=sm_mhz,
                   n_sms=n_sms, dq_exp_floor_ms=exp_ms, dkv_exp_floor_ms=exp_ms, card=card)
        emit(**rec)
        if not out_recs:
            common = dict(shape=label, plain_ms=plain_ms, library_ms=lib_ms)
            out_recs["flash_attention_bwd_dq"] = dict(
                common, ms=dq_ms, bound_ms=dq_bound[0], bound_by=dq_bound[1])
            out_recs["flash_attention_bwd_dkv"] = dict(
                common, ms=dkv_ms, bound_ms=dkv_bound[0], bound_by=dkv_bound[1])
        del q, k, v, g, out, lse, dq, dk, dv, dbias
        torch.cuda.empty_cache()
    return {name: dict(rec, max_abs_err=max_err[name]) for name, rec in out_recs.items()}


# ----------------------------------------------------- the f32 route

def _f32_check(got, want, what: str) -> dict:
    """An f32 route kernel against its plain version in f32: relative L2
    within F32_KERNEL_REL_L2."""
    from mvldm_tpu_torch.tools.kernel_compare import rel_l2

    rel = rel_l2(got, want)
    if not torch.isfinite(got).all() or not rel <= F32_KERNEL_REL_L2:
        fail(f"{what}: f32 relative L2 {rel:.4g} > {F32_KERNEL_REL_L2}")
    return dict(max_abs_err=(got - want).abs().max().item(), rel_l2=rel,
                rel_l2_limit=F32_KERNEL_REL_L2)


def f32_kernels_phase(card: str, gen) -> dict:
    """The f32 route's four wrappers (csrc/f32_route.cu) at the f32 UNet's
    shapes against their plain versions in f32, with device times, the
    bound or the bytes, and the library call. The forward (split TF32 on
    the tensor cores up to D = 160, FFMA at the VAE's 512) runs, out and
    lse, at every sampling shape, one line each, with SDPA in f32 and its
    backend, its bound at three TF32 products for each f32 one (494.7
    TFLOP/s), the FFMA bound beside it (``ffma_bound_ms``) and the
    instance's shared memory; the kernels line takes the joint 32x32 one.
    The backward (split TF32) runs at the joint 32x32, 16x16 and 8x8
    shapes, one line each, with SDPA's f32 backward and its backend and
    both bounds; the kernels line takes the 32x32 one. The fused blocks
    (C = 320, the widest that take the fused path in f32; FFMA GEMMs, bound
    at 67 TFLOP/s) have no library call (their decomposed path beside
    them)."""
    from mvldm_tpu_torch.ops.attention import (
        attention_bwd_reference,
        attention_reference,
        attention_reference_lse,
    )
    from mvldm_tpu_torch.ops.f32_route import (
        MAX_FLASH_HEAD_DIM,
        bwd_smem_bytes,
        flash_attention_bwd_f32,
        flash_attention_f32,
        fused_ln_geglu_ff_f32,
        fused_ln_self_attention_f32,
        fwd_smem_bytes,
    )
    from mvldm_tpu_torch.ops.fused_attn import _attn_decomposed, fused_ln_self_attention_reference
    from mvldm_tpu_torch.ops.fused_ff import fused_ln_geglu_ff_reference, ln_geglu_ff_decomposed
    from mvldm_tpu_torch.tools.kernel_compare import (
        ATTN_BLOCK_SHAPES,
        F32_BWD_SHAPES,
        FF_BLOCK_SHAPES,
        SAMPLING_SHAPES,
        attn_block_inputs,
        f32_block_gemms,
        f32_train_inputs,
        ff_block_inputs,
        sdpa_f32,
        sdpa_f32_bwd,
    )
    from mvldm_tpu_torch.tools.kernel_compare import _f32 as f32
    from mvldm_tpu_torch.tools.measure import f32_bounds, f32_bwd_bounds, f32_fwd_bounds

    recs = {}
    fwd = []
    for label, b, h, l, d, with_bias in SAMPLING_SHAPES:
        q, k, v, _, bias = f32_train_inputs(gen, b, h, l, d, with_bias)
        out, lse = flash_attention_f32(q, k, v, bias, return_lse=True)
        ref, ref_lse = attention_reference_lse(q, k, v, bias)
        acc = _f32_check(out, ref, f"flash_attention_f32 {label}")
        acc["lse"] = _f32_check(lse, ref_lse, f"flash_attention_f32 lse {label}")
        del ref, ref_lse
        iters = 10 if l >= 1024 else 50
        rec = dict(shape=label, B=b, H=h, L=l, D=d, bias=with_bias, **acc,
                   ms=time_ms(lambda: flash_attention_f32(q, k, v, bias), iters),
                   plain_ms=time_ms(lambda: attention_reference(q, k, v, bias), 3),
                   **sdpa_f32(q, k, v, bias, iters),
                   **f32_fwd_bounds(b, h, l, l, d, nbytes(q, k, v, bias, out)),
                   kernel_route=("split TF32 flash (flash_fwd_tf32)" if d <= MAX_FLASH_HEAD_DIM
                                 else "split TF32 GEMM tile (gemm_tf32x3): S = scale Q K^T + "
                                 "bias, the row pass (attn_rows_f32), O = P V; scores "
                                 "through device memory"),
                   smem_bytes=fwd_smem_bytes(l, d),
                   smem_instance=("flash_fwd_tf32" if d <= MAX_FLASH_HEAD_DIM
                                  else "gemm_tf32x3 (csrc/f32_gemm_tile.cuh)"))
        rec["library_ms"] = rec["sdpa_f32_ms"]
        emit(phase="f32_fwd", kernel="flash_attention_f32", **rec, card=card)
        fwd.append(rec)
        del q, k, v, bias, out, lse
        torch.cuda.empty_cache()
    recs["flash_attention_f32"] = dict(fwd[0], max_abs_err=max(r["max_abs_err"] for r in fwd))
    bwd = []
    for label, b, h, l, d, with_bias in F32_BWD_SHAPES[:3]:
        q, k, v, g, bias = f32_train_inputs(gen, b, h, l, d, with_bias)
        out, lse = flash_attention_f32(q, k, v, bias, return_lse=True)
        got = flash_attention_bwd_f32(q, k, v, bias, out, lse, g)
        want = attention_bwd_reference(q, k, v, bias, g)
        checks = {n: _f32_check(x, y, f"flash_attention_bwd_f32 {n} {label}")
                  for n, x, y in zip(("dq", "dk", "dv", "dbias"), got, want)}
        iters = 5 if l >= 1024 else 20
        rec = dict(shape=label, B=b, H=h, L=l, D=d,
                   max_abs_err=max(c["max_abs_err"] for c in checks.values()), **checks,
                   ms=time_ms(lambda: flash_attention_bwd_f32(q, k, v, bias, out, lse, g),
                              iters),
                   plain_ms=time_ms(lambda: attention_bwd_reference(q, k, v, bias, g), 3),
                   **sdpa_f32_bwd(q, k, v, bias, g, iters),
                   **f32_bwd_bounds(b, h, l, l, d, nbytes(q, k, v, out, g, lse, bias, *got)))
        rec["library_ms"] = rec["sdpa_f32_bwd_ms"]
        rec["smem_bytes"] = bwd_smem_bytes(d)
        emit(phase="f32_bwd", kernel="flash_attention_bwd_f32", route="f32", **rec, card=card)
        bwd.append(rec)
        del q, k, v, g, out, lse, got, want
        torch.cuda.empty_cache()
    recs["flash_attention_bwd_f32"] = dict(bwd[0], max_abs_err=max(r["max_abs_err"]
                                                                   for r in bwd))

    label, n, l, c, heads, d = ATTN_BLOCK_SHAPES[0]
    args = (*(f32(t) for t in attn_block_inputs(gen, n, l, c, heads, d)), heads, d)
    x = args[0]
    out = fused_ln_self_attention_f32(*args)
    hd = heads * d
    recs["fused_ln_self_attention_f32"] = dict(
        shape=label, **_f32_check(out - x, fused_ln_self_attention_reference(*args) - x,
                                  f"fused_ln_self_attention_f32 {label}"),
        ms=time_ms(lambda: fused_ln_self_attention_f32(*args)),
        plain_ms=time_ms(lambda: fused_ln_self_attention_reference(*args), 3),
        library_ms=None, decomposed_ms=time_ms(lambda: _attn_decomposed(*args, 1e-6)),
        **f32_bounds(8.0 * n * l * c * hd + 4.0 * n * heads * l * l * d,
                     nbytes(*args[:8], out)),
        gemm_launches=f32_gemm_launches(f32_block_gemms(gen, "attn", label, (n, l, c, heads, d))))
    label, n, l, c = FF_BLOCK_SHAPES[0]
    args = tuple(f32(t) for t in ff_block_inputs(gen, n, l, c))
    x = args[0]
    out = fused_ln_geglu_ff_f32(*args)
    ff_gemms = f32_gemm_launches(f32_block_gemms(gen, "ff", label, (n, l, c)))
    recs["fused_ln_geglu_ff_f32"] = dict(
        shape=label, **_f32_check(out - x, fused_ln_geglu_ff_reference(*args) - x,
                                  f"fused_ln_geglu_ff_f32 {label}"),
        ms=time_ms(lambda: fused_ln_geglu_ff_f32(*args)),
        plain_ms=time_ms(lambda: fused_ln_geglu_ff_reference(*args), 3),
        library_ms=None, decomposed_ms=time_ms(lambda: ln_geglu_ff_decomposed(*args)),
        **f32_bounds(24.0 * n * l * c * c, nbytes(*args, out)), gemm_launches=ff_gemms)
    w1 = ff_gemms[0]  # the GEMM tile's line: its widest launch, W1 + b1 at C = 320
    recs["gemm_f32"] = dict(
        shape=f"{label} {w1['entry']} {w1['shape']}", ms=w1["ms"], plain_ms=w1["plain_ms"],
        library_ms=w1["cublas_f32_ms"], library="cuBLAS f32 (TF32 off), F.linear",
        bound_ms=w1["bound_ms"], bound_by=w1["bound_by"], ffma_bound_ms=w1["ffma_bound_ms"],
        rel_l2=w1["rel_l2"], max_abs_err=max(r["max_abs_err"] for r in ff_gemms
                                             + recs["fused_ln_self_attention_f32"]
                                             ["gemm_launches"]))
    recs["attention_rows_f32"] = attention_rows_record(gen)
    for name, rec in recs.items():
        emit(phase="kernel", kernel=name, route="f32", **rec, card=card)
    return recs


def f32_gemm_launches(calls) -> list:
    """Each f32 GEMM launch of a fused block on its own (kernel_compare's
    f32_block_gemms): this tree's kernel within F32_KERNEL_REL_L2 of the
    product in float64, its device time, the plain version's (the product
    in f32 by PyTorch, bias and residual added apart), both bounds and
    cuBLAS f32 (TF32 off) on the same operands."""
    from mvldm_tpu_torch.ops import _build
    from mvldm_tpu_torch.tools.kernel_compare import SIGNATURES, rel_l2
    from mvldm_tpu_torch.tools.measure import f32_gemm_bounds, no_tf32

    recs = []
    for call in calls:
        lib = _build.load(call.source, SIGNATURES[call.source])
        call.run(lib)
        out, ref = call.outs[0], call.refs[0]
        err = rel_l2(out, ref)
        if not torch.isfinite(out).all() or not err <= F32_KERNEL_REL_L2:
            fail(f"{call.entry} {call.shape}: f32 relative L2 {err:.4g} > {F32_KERNEL_REL_L2}")
        m, n, k = call.mnk
        with no_tf32():
            cublas_ms = time_ms(call.library)
            plain_ms = time_ms(call.plain, 3)
        recs.append(dict(entry=call.entry, shape=call.shape, M=m, N=n, K=k, rel_l2=err,
                         max_abs_err=(out.double() - ref).abs().max().item(),
                         ms=time_ms(lambda: call.run(lib)), plain_ms=plain_ms,
                         cublas_f32_ms=cublas_ms, **f32_gemm_bounds(m, n, k, call.moved)))
    return recs


def attention_rows_record(gen) -> dict:
    """The route's row pass on its own at the VAE's scores (12 heads of
    1024 x 1024, S = Q K^T / sqrt(512) of seeded f32 q, k): lse and P within
    F32_KERNEL_REL_L2 of the plain version, device times of both, the byte
    bound (S read, P and lse written). No single PyTorch call computes
    both the lse and P, so no library time."""
    from mvldm_tpu_torch.ops.f32_route import attention_rows_f32, attention_rows_reference

    z, l, d = 12, 1024, 512
    q, k = (torch.randn((z, l, d), generator=gen, device="cuda") for _ in range(2))
    s = torch.matmul(q, k.transpose(1, 2)) * d ** -0.5
    lse, ref_lse, ref = (torch.empty((z, l), device="cuda"), torch.empty((z, l), device="cuda"),
                         s.clone())
    work = s.clone()
    attention_rows_f32(work, lse, l)
    attention_rows_reference(ref, ref_lse, l)
    acc = _f32_check(work, ref, "attention_rows_f32 P")
    acc["lse"] = _f32_check(lse, ref_lse, "attention_rows_f32 lse")
    bound_ms, bound_by = bound(0.0, 2 * nbytes(s) + nbytes(lse))
    return dict(shape=f"VAE mid-block scores ({z}, {l}, {l})", **acc,
                ms=time_ms(lambda: attention_rows_f32(work, lse, l)),
                plain_ms=time_ms(lambda: attention_rows_reference(ref, ref_lse, l), 3),
                library_ms=None, bound_ms=bound_ms, bound_by=bound_by)


# ------------------------------------------------ attention microbenchmark

# Where the four probe kernels stand and what they replace (the matmul
# probe's bf16 and f32 routes apart: two tiles); the kernels line takes each
# one's first case of the run.
MICRO_META = {
    "matmul": ("mvldm_tpu_torch/csrc/micro_matmul.cu", "tools/bench_attn_micro.py:59"),
    "matmul_f32": ("mvldm_tpu_torch/csrc/micro_matmul.cu (+ f32_gemm_tile.cuh)",
                   "tools/bench_attn_micro.py:59 (f32)"),
    "fullk": ("mvldm_tpu_torch/csrc/micro_attn.cu", "tools/bench_attn_micro.py:91"),
    "flash": ("mvldm_tpu_torch/csrc/micro_attn.cu", "tools/bench_attn_micro.py:163"),
    "exp": ("mvldm_tpu_torch/csrc/micro_exp.cu", "tools/bench_attn_micro.py:249"),
}
MICRO_PLAIN_ROWS = 2  # batch rows per call of an attention probe's plain version
MICRO_RAGGED_L = 1000  # not a multiple of the kernels' 64-row tiles


def _jsonable(v):
    return v if v is None or isinstance(v, (bool, int, float, str, dict, list)) else str(v)


def _plain_by_rows(plain, *inputs):
    """An attention probe's plain version over MICRO_PLAIN_ROWS batch rows at
    a time (bench_attn_micro.plain_by_rows)."""
    return plain_by_rows(plain, *inputs, rows=MICRO_PLAIN_ROWS)


def micro_check(case, out) -> dict:
    """A probe kernel's output against its plain version on the same inputs:
    bf16 outputs by ``check`` against the plain version on f32 inputs, the
    f32-dot flash also within its case's ``rel_limit``; the f32 matmul
    within relative L2 1e-5 of the product in float64, exp within 1e-6
    relative of exp in float64. Adds the plain version's device time."""
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
        if case.rel_limit is not None:  # the f32-dot flash: the precision its split p is for
            acc["err_over_rms_limit"] = case.rel_limit
            if not acc["err_over_rms"] <= case.rel_limit:
                fail(f"{what}: kernel error over rms {acc['err_over_rms']:.4g} "
                     f"> {case.rel_limit}")
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
    micro.matmul.f32_launches = 0
    t0 = time.perf_counter()
    results = micro.run(micro.SECTIONS, check=micro_check)
    seconds = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in micro.KERNELS}
    launches["matmul_f32"] = micro.matmul.f32_launches
    launches["matmul"] -= launches["matmul_f32"]
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
        probe, _, f32 = name.partition("_")
        mine = [r for r in results if r["probe"] == probe
                and (probe != "matmul" or (r["dtype"] == "float32") == bool(f32))]
        records[name] = dict(mine[0], shape={k: _jsonable(v) for k, v in mine[0]["case"].items()},
                             max_abs_err=max(r["max_abs_err"] for r in mine))
    return records, launches


def micro_kernel_record(name: str, r: dict, launches: int) -> dict:
    """A probe kernel's entry of the kernels line: its first case of the run
    and the bound (the exp floor and the route's own products stay on the
    micro lines). The f32-dot flash's library_ms is SDPA on f32 copies (the
    same function), with the bf16 SDPA beside it."""
    rec = dict(name=f"bench_attn_micro.{name}", route="cuda", source=MICRO_META[name][0],
               replaces=MICRO_META[name][1], launches=launches,
               launches_by_path={"micro": launches}, max_abs_err=r["max_abs_err"], ms=r["ms"],
               plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
               kernel_route=r["route"], library_ms=r["library_ms"], timed_shape=r["shape"])
    if "library_f32_ms" in r:
        rec.update(library_ms=r["library_f32_ms"], library_backend=r["library_f32_backend"],
                   library_bf16_ms=r["library_ms"])
    if name == "matmul_f32":  # cuBLAS f32 with TF32 off; the FFMA bound beside the 3xTF32 one
        rec.update(library="cuBLAS f32 (TF32 off)", ffma_bound_ms=r["ffma_bound_ms"])
    return rec


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


def main_path_phase(card: str, kernels, f32_kernels) -> "object":
    from mvldm_tpu_torch.builder import IMAGE_HW, build_flagship
    from mvldm_tpu_torch.diffusion.video_sampling import VideoSampler

    t0 = time.perf_counter()
    engine = build_flagship("cuda")
    torch.cuda.synchronize()
    emit(phase="build_flagship", seconds=time.perf_counter() - t0,
         unet_params=sum(p.numel() for p in engine.unet.parameters()), card=card)
    sampler = VideoSampler(engine, num_anchors_views=4)
    ctx, tgt = make_scene(N_TARGET, IMAGE_HW)

    for fn in kernels + f32_kernels:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    frames = sampler.sample_anchored(ctx, tgt, torch.Generator("cuda").manual_seed(1))
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches, f32_launches = _counts(kernels), _counts(f32_kernels)

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
    if launches != SCENE_LAUNCHES:
        fail(f"a scene launched {launches}, not {SCENE_LAUNCHES}")
    if any(f32_launches.values()):
        fail(f"the bf16 sampling path launched f32 kernels: {f32_launches}")

    t0 = time.perf_counter()
    sampler.sample_anchored(ctx, tgt, torch.Generator("cuda").manual_seed(2))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    emit(phase="main_path", what="anchored sampling, 1 context + 16 targets, 256 px, "
         "25 DDIM steps, CFG 3.0, bf16", frames=len(frames),
         first_pass_s=cold_s, second_pass_s=warm_s,
         frames_per_s=N_TARGET / warm_s, launches=launches, f32_launches=f32_launches,
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
    return cpu_engine, (x, t, mask), cpu


def f32_phase(card: str, inputs, cpu_out, kernels, f32_kernels):
    """An f32 model on the card: the seeded flagship built in f32 there
    (the host's weights), TF32 off for cuBLAS and cuDNN, the UNet parity
    forward against the host's f32 output (relative L2 within
    F32_REL_L2_BOUND; TF32 is off for the whole script, see main). Every f32
    forward kernel must launch and no bf16 kernel may. Returns the f32
    engine and the f32 launch counts."""
    from mvldm_tpu_torch.builder import build_flagship

    x, t, mask = inputs
    t0 = time.perf_counter()
    engine = build_flagship("cuda", torch.float32)
    for fn in kernels + f32_kernels:
        fn.launches = 0
    with torch.inference_mode():
        t1 = time.perf_counter()
        gpu = engine.unet(x.cuda(), t.cuda(), view_mask=mask.cuda())
        torch.cuda.synchronize()
        forward_s = time.perf_counter() - t1
    gpu = gpu.cpu()
    launches, f32_launches = _counts(kernels), _counts(f32_kernels)
    rel = (torch.linalg.norm(gpu - cpu_out) / torch.linalg.norm(cpu_out)).item()
    finite = bool(torch.isfinite(gpu).all())
    emit(phase="f32", what="the UNet parity forward in f32 on the card (seeded f32 weights, "
         "TF32 off, the f32 route's kernels) vs host f32 plain", dtype=str(gpu.dtype),
         rel_l2=rel, bound=F32_REL_L2_BOUND, finite=finite, f32_launches=f32_launches,
         bf16_launches=launches, forward_s=forward_s, seconds=time.perf_counter() - t0,
         card=card)
    if not finite or not rel <= F32_REL_L2_BOUND:
        fail(f"f32 UNet on the card: rel L2 {rel:.4g} > {F32_REL_L2_BOUND}")
    if any(launches.values()):
        fail(f"bf16 kernels launched on the f32 model: {launches}")
    # The UNet has no head dim past 160: the row pass runs in the f32 step's
    # VAE encode (train_parity_f32).
    idle = [name for name, n in f32_launches.items()
            if n == 0 and "bwd" not in name and name != "attention_rows_f32"]
    if idle:
        fail(f"f32 forward kernels never launched on the f32 model: {idle}")
    return engine, f32_launches


# -------------------------------------------------------------- training

def train_parity_phase(card: str, engine, cpu_engine, f32_engine, kernels, f32_kernels):
    """Loss and UNet gradient of one training step at batch 1 (2 context + 3
    target views at 256 px) with the same injected draws: the card (bf16,
    kernels) against the host CPU (f32, plain versions), same weights; then
    the f32 engine on the card (the f32 route's kernels, TF32 off) against
    the same host step within F32_REL_L2_BOUND, with every f32 kernel
    launched and no bf16 one. Returns the f32 step's launch counts."""
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

    t0 = time.perf_counter()
    f32_engine.vae.requires_grad_(False)
    for fn in kernels + f32_kernels:
        fn.launches = 0
    f32_loss, f32 = loss_and_grads(f32_engine)
    launches, f32_launches = _counts(kernels), _counts(f32_kernels)
    loss_rel = abs(f32_loss - cpu_loss) / abs(cpu_loss)
    num = sum((f32[n] - cpu[n]).square().sum().item() for n in cpu)
    rel = (num / den) ** 0.5
    finite = all(torch.isfinite(f32[n]).all() for n in f32) and np.isfinite(f32_loss)
    emit(phase="train_parity_f32", what="the same training step in f32 on the card (the f32 "
         "route's kernels, TF32 off) vs host f32 plain", gpu_loss=f32_loss, cpu_loss=cpu_loss,
         loss_rel_err=loss_rel, grad_rel_l2=rel, bound=F32_REL_L2_BOUND, finite=bool(finite),
         f32_launches=f32_launches, bf16_launches=launches,
         seconds=time.perf_counter() - t0, card=card)
    if not finite or not loss_rel <= F32_REL_L2_BOUND or not rel <= F32_REL_L2_BOUND:
        fail(f"f32 train parity: loss rel {loss_rel:.4g}, grad rel L2 {rel:.4g}")
    if any(launches.values()):
        fail(f"bf16 kernels launched on the f32 training step: {launches}")
    idle = [name for name, n in f32_launches.items() if n == 0]
    if idle:
        fail(f"f32 kernels never launched on the f32 training step: {idle}")
    return f32_launches


def train_phase(card: str, engine, kernels, f32_kernels):
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

    for fn in kernels + f32_kernels:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, metrics = step(state, batch, generator=gen)
        losses.append(metrics["loss/diffusion"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches, f32_launches = _counts(kernels), _counts(f32_kernels)
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
         f32_launches=f32_launches,
         remat_step_s=remat_s, remat_peak_memory_gb=remat_peak,
         loss_backward_peak_above_held_gb=activations, card=card)
    if not all(np.isfinite(x) for x in losses):
        fail(f"non-finite training loss: {losses}")
    idle = [name for name, n in launches.items() if n == 0]
    if idle:
        fail(f"kernels never launched on the training path: {idle}")
    if any(f32_launches.values()):
        fail(f"the bf16 training path launched f32 kernels: {f32_launches}")
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


# The split-TF32 instances: in f32_route.cu the forward at D <= 160
# (head-dim instance, warpgroups a block), both backward kernels (head-dim
# instance) and the GEMM tile (B (N, K) and (K, N)); in micro_matmul.cu the
# tile for the probe's (K, N) B. The FFMA bodies they replaced must be gone.
SPLIT_TF32_INSTANCES = {
    "f32_route": (
        [f"flash_fwd_tf32<{dn}, {wgs}>" for dn in (16, 40, 64, 80) for wgs in (1, 2)]
        + ["flash_fwd_tf32<160, 1>"]
        + [f"{name}<{dn}>" for name in ("flash_bwd_dq_f32", "flash_bwd_dkv_f32")
           for dn in (16, 40, 64, 80, 160)]
        + ["gemm_tf32x3<0>", "gemm_tf32x3<1>"]),
    "micro_matmul": ["gemm_tf32x3<1>"],
}
FFMA_BODIES = ("flash_fwd_f32", "gemm_f32", "matmul_f32_kernel")


def sass_phase(card: str) -> None:
    """The split-TF32 instances in the built libraries' SASS (cuobjdump):
    each must be there and run its products as HGMMA on TF32 operands, and
    none as HMMA; no FFMA body of the f32 route or the probe is left."""
    from mvldm_tpu_torch.ops import _build

    for source, instances in SPLIT_TF32_INSTANCES.items():
        report = _build.sass_report(source)
        found = {k: v for k, v in report.items()
                 if k.startswith(("flash_fwd_tf32", "flash_bwd_dq_f32", "flash_bwd_dkv_f32",
                                  "gemm_tf32x3"))}
        emit(phase="sass", source=f"mvldm_tpu_torch/csrc/{source}.cu", kernels=found, card=card)
        missing = [k for k in instances if k not in found]
        bad = [k for k, v in found.items()
               if v["HMMA"] or not any(f.endswith("TF32") for f in v["HGMMA forms"])]
        left = [k for k in report if k.split("<")[0] in FFMA_BODIES]
        if missing or bad or left:
            fail(f"{source}: split-TF32 instances missing {missing} or without TF32 HGMMA "
                 f"(or with HMMA) {bad}; FFMA bodies left {left}")


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
    from mvldm_tpu_torch.ops.f32_route import KERNELS as F32_KERNELS
    from mvldm_tpu_torch.ops.fused_attn import fused_ln_self_attention
    from mvldm_tpu_torch.ops.fused_ff import fused_ln_geglu_ff

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    t_start = time.perf_counter()
    logs = _build.build()
    emit(phase="build", seconds=time.perf_counter() - t_start,
         per_source_s={k: s for k, (s, _) in logs.items()},
         ptxas={k: _build.ptxas_report(log) for k, (_, log) in logs.items()}, card=card)
    sass_phase(card)

    gen = torch.Generator("cuda").manual_seed(0)
    results = {
        "flash_attention": attention_phase(card, gen),
        "fused_ln_self_attention": fused_attn_phase(card, gen),
        "fused_ln_geglu_ff": fused_ff_phase(card, gen),
        **flash_bwd_phase(card, gen),
    }
    micro_records, micro_launches = micro_phase(card)
    forward = (flash_attention, fused_ln_self_attention, fused_ln_geglu_ff)
    backward = (flash_attention_bwd_dq, flash_attention_bwd_dkv)
    engine, sampling_launches = main_path_phase(card, forward, F32_KERNELS)
    profile_phase(card, engine)
    cpu_engine, unet_inputs, cpu_out = unet_parity_phase(card, engine)
    del engine
    torch.cuda.empty_cache()
    f32_results = f32_kernels_phase(card, gen)
    f32_engine, f32_forward_launches = f32_phase(card, unet_inputs, cpu_out,
                                                 forward + backward, F32_KERNELS)

    engine = build_flagship_train("cuda")
    f32_step_launches = train_parity_phase(card, engine, cpu_engine, f32_engine,
                                           forward + backward, F32_KERNELS)
    del cpu_engine, f32_engine
    torch.cuda.empty_cache()
    state, step, batch, train_gen, train_launches = train_phase(
        card, engine, forward + backward, F32_KERNELS)
    train_profile_phase(card, state, step, batch, train_gen)

    f32_meta = {
        "flash_attention_f32": "mvldm_tpu/ops/attention.py:76",
        "flash_attention_bwd_f32": "mvldm_tpu/ops/attention.py:282, :324",
        "fused_ln_self_attention_f32": "mvldm_tpu/ops/fused_attn.py:65",
        "fused_ln_geglu_ff_f32": "mvldm_tpu/ops/fused_ff.py:75",
        "gemm_f32": ("the products of mvldm_tpu/ops/fused_attn.py:65, "
                     "mvldm_tpu/ops/fused_ff.py:75 and, past head dim 160, "
                     "mvldm_tpu/ops/attention.py:76"),
        "attention_rows_f32": "the softmax of mvldm_tpu/ops/attention.py:76 past head dim 160",
    }
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
        dict(name=name, route="cuda",
             source="mvldm_tpu_torch/csrc/f32_route.cu" + (
                 " (+ f32_gemm_tile.cuh)" if name != "attention_rows_f32" else ""),
             replaces=f32_meta[name],
             launches=f32_forward_launches[name] + f32_step_launches[name],
             launches_by_path={"f32_forward": f32_forward_launches[name],
                               "f32_train_step": f32_step_launches[name]},
             max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
             bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
             timed_shape=r["shape"])
        for name, r in f32_results.items()
    ] + [micro_kernel_record(name, r, micro_launches[name])
         for name, r in micro_records.items()])
    emit(phase="total", seconds=time.perf_counter() - t_start, card=card)
    print(card, flush=True)
    emit(ok=True, device={"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
