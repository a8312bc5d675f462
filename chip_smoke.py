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
   shapes (MVDream's text-to-multiview shapes among them: the flash
   forward's text attention onto 77 keys and joint attentions, the fused
   blocks on 4 views' joint sequences): the kernel against its plain
   PyTorch version computed in f32 on
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
   backward on its own, and the idle share. Then fused_adamw: the
   optimizer's fused kernels (ops/fused_adamw.py) at the baseline's AdamW
   (f32 moments, clip 0.1, accumulation 2) on the trained f32 masters (686
   tensors, 0.93B parameters) with seeded bf16 gradients, two accumulation
   cycles (the first clipped, the second not) on the fused route and on the
   foreach chain from the same masters and gradients: masters, moments and
   accumulators equal bit for bit after every micro-step, 1 accumulate
   launch a micro-step and 1 update launch an applying one; each kernel's
   device time against its bytes' bound, and each route's whole apply.
11. cli: the sampling CLI (``python -m mvldm_tpu_torch.scripts.generate_mvldm``,
   through ``generate_mvldm.main`` on the card) at ``+experiment=baseline``
   (bf16, seeded weights, 25 steps) on a synthetic RE10K test stage the
   phase writes (2 scenes of 24 JPEG frames at 360x640): (a) anchored, both
   scenes in one dispatch, 8 frames each; (b) autoregressive, 7 frames of
   one scene chosen by hash; (c) (b) with the latent feedthrough; (d) DDPM
   with 10 steps, anchored, 4 frames; (e) the standard cross-view block,
   anchored, 4 frames. Each run: its wall time and frames, the JAX CLI's
   output tree (uint8 PNGs that are not constant, GIF, MP4s that parse),
   the forward kernels' launches equal to its plan's (CLI_LAUNCHES) and no
   f32-route launch. Beside it, each fatal: the scene-batched dispatches at
   S = 1 equal to the single-scene ones bit for bit and S = 2 against two
   S = 1 loops (SCENE_BATCH_REL_L2_BOUND), right after phase 6; one DDPM
   step in f32 on the card against float64 on the host
   (DDPM_STEP_REL_BOUND); (e)'s UNet in bf16 on the card against the host
   in f32 (UNET_REL_L2_BOUND). It runs after phase 6, before phase 7.
12. cli_train: the training CLI (``python -m mvldm_tpu_torch.scripts.main``,
   through ``main.main`` on the card) at ``+experiment=baseline`` (batch 6,
   2 context + 3 target views, accumulation 2, bf16-mixed, seeded weights)
   on a synthetic RE10K train and test stage it writes (2 scenes each of
   TRAIN_FRAMES JPEG frames at 360x640, room for the baseline sampler's 50
   to 180 frames between context views): (f) ``mode=train`` for 4 steps,
   validation and checkpoints every 2 (val batch 2, both checkpoints kept):
   finite losses in metrics.jsonl, two optimizer updates that moved the
   masters, ``checkpoints/step_000000002`` and ``..04``, ``val/step_2`` and
   ``val/step_4`` with cameras.png, distributions.png and a grid a scene;
   (g) (f) again to 6 steps, resuming at 4; (h) ``mode=val`` on that
   directory, its weights read by ``restore_partial`` alone, into ``val/``;
   (i) ``+experiment=tpu_fast`` for 4 steps: remat, mu and nu stored in
   bf16, a peak below (f)'s. Each run: wall time, peak memory, launches
   equal to its plan's (TRAIN_CLI_LAUNCHES: the optimizer's fused kernels
   on AdamW with f32 moments, none under tpu_fast) and no f32-route launch.
13. cli_train_variants, on cli_train's synthetic train stage: (j)
   ``precompute_latents`` (``python -m mvldm_tpu_torch.scripts.precompute_latents``)
   in f32 with the port's seeded VAE, 2 scenes x TRAIN_FRAMES frames x 2
   flips in launches of 32: the cache's layout, the f32 route's launches
   against their plan (vae_encode_f32_plan) and no bf16 launch, four
   frames against the host's f32 encode (PRECOMPUTE_REL_L2); (k)
   ``+experiment=tpu_fast dataset.latent_cache=<(j)>``, 4 steps, whose plan
   has no VAE-encoder launch; (l) ``optimizer.name=Adafactor``, 2 steps;
   (m) ``trainer.remat_policy=dots``, 2 steps, then one step's loss and
   backward at batch 6 under full remat, dots and no remat with the same
   draws: dots's peak strictly between, its loss and gradient against full
   remat's within TRAIN_LOSS_REL_BOUND and TRAIN_GRAD_REL_L2_BOUND. Each CLI
   run: launches its plan's, finite losses, the saved optimizer state.
14. eval: (n) ``generate_gt``, ``generate_gt_image_directory``,
   ``compute_metrics`` (three forms) and ``compute_fid`` (three forms) on
   the card over cli run (a)'s renders, with seeded synthetic LPIPS / DISTS
   and Inception weights in the real layouts and ``--allow-init-vae``: the
   JSON trees' keys, no bf16 launch, the f32 VAE encodes' launches against
   their plan, and the metrics and FID features against the port's CPU
   run on the same images (EVAL_PSNR_SSIM_REL, EVAL_FEATURE_REL).
15. cli_parallel, multi-rank training and the last modules: (o) the
   training CLI at ``+experiment=baseline`` (batch 6, accumulation 2, a
   seeded train stream), 2 steps with no process group, then under each
   ``trainer.strategy`` (data_parallel, data_parallel_zero1,
   data_parallel_fsdp, data_model with num_model=1) with the
   ``MVLDM_COORDINATOR`` triplet at world 1 over NCCL: the logged loss and
   grad norm and the saved masters, EMA and moments against the run with
   no process group (the WORLD1_* bounds), launches equal to
   PARALLEL_CLI_LAUNCHES; (p) two ranks sharing the card over gloo with
   CUDA tensors (``python3 chip_smoke.py --rank-job``): a ``data_parallel``
   step at batch 2 a rank and a ``data_model`` step with 2 model ranks,
   each rank's loss and global gradient against one card's on the same
   examples and draws (TRAIN_LOSS_REL_BOUND, TRAIN_GRAD_REL_L2_BOUND), each
   rank's peak memory, every training kernel launched on each rank; (q)
   ``mode=test`` on two such ranks: the ranks' scenes disjoint and
   together the stage's; (r) ``utils.ckpt_manifest``'s census equal to
   ``assets/mvldm_1.0_manifest.json``, ``scripts.verify_parity`` smoke at
   ``+experiment=baseline`` (f32) writing a finite fixture and its fixture
   mode passing. It runs last.
16. t2mv: MVDream's text-to-multiview path (``models/mvdream.py``, built
   from the benchmark's ``mvdream-sd21-4view`` configuration with seeded
   weights, bf16): one ``DiffusionEngine.text_to_multiview`` dispatch of
   4 prompts x 4 views at 256 px (50 DDIM steps, one batched-CFG UNet call
   of 8 rows a step) from zeroed launch counters, its frames uint8 and not
   constant, every forward kernel's launches exactly T2MV_LAUNCHES and no
   f32-route launch; a second dispatch timed; then one batched-CFG UNet
   forward (1 prompt: 2 rows x 4 views, 32x32 latents, text and cameras)
   on the card in bf16 against the host in f32 (UNET_REL_L2_BOUND). It
   runs after phase 6, before phase 11.

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
# Forward-kernel launches of each run of the cli phase, as the sampling CLI's
# launch plan takes them (tests/test_torch_port_launch_plan.py counts them
# again on the meta device): (a) anchored, 2 scenes x 8 frames in one
# dispatch, as one 16-frame scene; (b) autoregressive, windows of 4 and 3;
# (c) (b) with the context encoded once; (d) DDPM, 10 steps, 4 frames; (e)
# the standard cross-view block, 4 frames.
CLI_LAUNCHES = {
    "anchored": {"flash_attention": 1706, "fused_ln_self_attention": 800,
                 "fused_ln_geglu_ff": 800},
    "autoregressive": {"flash_attention": 854, "fused_ln_self_attention": 400,
                       "fused_ln_geglu_ff": 400},
    "autoregressive_feedthrough": {"flash_attention": 853, "fused_ln_self_attention": 400,
                                   "fused_ln_geglu_ff": 400},
    "ddpm": {"flash_attention": 344, "fused_ln_self_attention": 160, "fused_ln_geglu_ff": 160},
    "standard": {"flash_attention": 604, "fused_ln_self_attention": 200,
                 "fused_ln_geglu_ff": 200},
}
CLI_FRAMES = 24  # frames a synthetic scene of the cli phase holds
# MVDream's text-to-multiview dispatch (the t2mv phase): the configuration
# it builds, and the forward-kernel launches of one dispatch of 4 prompts x
# 4 views, 50 steps (tests/test_torch_port_launch_plan.py counts them again
# on the meta device): a step runs 16 text attentions, 6 joint attentions
# at C = 1280 on the flash forward and 10 fused blocks of each kind; the
# decode adds the VAE's mid-block attention.
MVDREAM_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchmark",
                              "configs", "mvdream-sd21-4view.json")
T2MV_PROMPTS, T2MV_VIEWS = 4, 4
T2MV_LAUNCHES = {"flash_attention": 1101, "fused_ln_self_attention": 500,
                 "fused_ln_geglu_ff": 500}
# Kernel launches of each run of the cli_train phase, as the training CLI's
# launch plan takes them (tests/test_torch_port_launch_plan.py counts them
# again on the meta device): a training step at batch 6 launches 26 / 8 / 8
# forward and 25 / 25 backward kernels (43 / 16 / 16 forward under remat);
# a validation scene (1 + 3 views, 70 DDIM steps) 1192 / 560 / 560.
_TRAIN_STEP = (26, 8, 8, 25, 25)
_TRAIN_STEP_REMAT = (43, 16, 16, 25, 25)
# From the latent cache a step runs no VAE encode: its D = 512 flash launch
# drops out (remat under tpu_fast).
_TRAIN_STEP_REMAT_CACHED = (42, 16, 16, 25, 25)
_VAL_SCENE = (1192, 560, 560, 0, 0)
TRAIN_KERNELS = ("flash_attention", "fused_ln_self_attention", "fused_ln_geglu_ff",
                 "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
# The optimizer's fused kernels (ops/fused_adamw.py), as the launch counts
# name them: at accumulation 2, one accumulate launch a step and one update
# launch every second, on AdamW with f32 moments; bf16 moments (tpu_fast)
# and Adafactor take the foreach chain and launch neither.
OPTIM_KERNELS = ("fused_adamw_accumulate", "fused_adamw_update")


def _plan(steps: int, step: tuple, scenes: int, fused: bool = True) -> dict:
    plan = {k: steps * a + scenes * b for k, a, b in zip(TRAIN_KERNELS, step, _VAL_SCENE)}
    plan.update(zip(OPTIM_KERNELS, (steps, steps // 2) if fused else (0, 0)))
    return plan


TRAIN_CLI_LAUNCHES = {
    "train": _plan(4, _TRAIN_STEP, 2 * 2),        # (f): hooks at steps 2 and 4, 2 scenes each
    "train_resume": _plan(2, _TRAIN_STEP, 2),     # (g): steps 5-6, a hook at step 6
    "val": _plan(0, _TRAIN_STEP, 2),              # (h): one val batch of 2 scenes
    "train_tpu_fast": _plan(4, _TRAIN_STEP_REMAT, 0, fused=False),  # (i): remat, no hook
    "train_latent_cache": _plan(4, _TRAIN_STEP_REMAT_CACHED, 0, fused=False),  # (k): the cache
    "train_adafactor": _plan(2, _TRAIN_STEP, 0, fused=False),  # (l): a baseline step's kernels
    # (m): "dots" keeps the 2-D products; the hand kernels launch outside the
    # dispatcher, so their outputs are recomputed as under full remat.
    "train_remat_dots": _plan(2, _TRAIN_STEP_REMAT, 0),
}
# Frames of a synthetic scene of the cli_train phase: the baseline's bounded
# sampler places 50 to 180 frames between the context views.
TRAIN_FRAMES = 181
# One DDPM ancestral step in f32 on the card against float64 on the host.
DDPM_STEP_REL_BOUND = 1e-6
TRAIN_LOSS_REL_BOUND = 3e-2
TRAIN_GRAD_REL_L2_BOUND = 1e-1
# The evaluation metrics on the card (f32, TF32 off) against the port's CPU
# run on the same images: PSNR and SSIM are sums of squares, the perceptual
# distances and the FID features deep f32 networks (~1e-6 seen in the CPU
# tests against JAX).
EVAL_PSNR_SSIM_REL = 1e-4
# The cache's float16 moments from the card's f32 encode against the host's
# f32 encode: float16 storage alone is ~2.8e-4 relative (rms of a rounding
# to 11 bits); a wrong term reads O(1).
PRECOMPUTE_REL_L2 = 1e-3
EVAL_FEATURE_REL = 1e-3
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


def _kernel_name(fn) -> str:
    """A kernel wrapper's name in the launch counts (OPTIM_KERNELS for the
    optimizer's)."""
    if fn.__module__.endswith(".fused_adamw"):
        return f"fused_adamw_{fn.__name__}"
    return fn.__name__


def _counts(kernels) -> dict:
    """Each kernel wrapper's launch count."""
    return {_kernel_name(fn): fn.launches for fn in kernels}


# --------------------------------------------------------------- kernels

def attention_phase(card: str, gen) -> dict:
    import torch.nn.functional as F

    from mvldm_tpu_torch.ops.attention import attention_reference, flash_attention
    from mvldm_tpu_torch.tools.kernel_compare import (
        SAMPLING_SHAPES,
        T2MV_FLASH_SHAPES,
        attn_inputs,
    )

    n_sms = sm_count()
    headline = None
    max_err = 0.0
    cases = ([(label, b, h, l, l, d, bias) for label, b, h, l, d, bias in SAMPLING_SHAPES]
             + [(*shape, False) for shape in T2MV_FLASH_SHAPES])
    for label, b, h, l, lk, d, with_bias in cases:
        q, k, v, bias = attn_inputs(gen, b, h, l, d, with_bias, lk)
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
        bound_ms, bound_by = bound(4.0 * b * h * l * lk * d, nbytes(q, k, v, bias, out))
        rec = dict(phase="kernel", kernel="flash_attention", shape=label,
                   B=b, H=h, L=l, Lk=lk, D=d, bias=with_bias, **acc, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                   bound_by=bound_by, sm_mhz=sm_mhz, n_sms=n_sms,
                   exp_floor_ms=exp_floor_ms(b * h * l * lk, sm_mhz, n_sms), card=card)
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
        T2MV_ATTN_BLOCK_SHAPES,
        attn_block_gemms,
        attn_block_inputs,
    )

    headline = None
    max_err = 0.0
    for label, n, l, c, heads, d in ATTN_BLOCK_SHAPES + T2MV_ATTN_BLOCK_SHAPES:
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
        T2MV_FF_BLOCK_SHAPES,
        ff_block_gemms,
        ff_block_inputs,
    )

    headline = None
    max_err = 0.0
    for label, n, l, c in FF_BLOCK_SHAPES + T2MV_FF_BLOCK_SHAPES:
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


# ------------------------------------------------------------------- cli

def make_frame(i: int, h: int = 360, w: int = 640) -> bytes:
    """A deterministic colorful frame, JPEG-encoded (the generator of
    tests/synthetic_data.py)."""
    import io

    from PIL import Image

    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    img = np.stack([((xx + 5 * i) % 256), ((yy + 3 * i) % 256),
                    ((xx // 2 + yy // 2 + 7 * i) % 256)], axis=-1).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def make_cameras(n: int) -> np.ndarray:
    """(n, 18) rows fx fy cx cy 0 0 + w2c(3x4): a camera sliding along +x
    and turning slowly (the generator of tests/synthetic_data.py)."""
    rows = np.zeros((n, 18), dtype=np.float32)
    for i in range(n):
        theta = 0.02 * i
        c, s = np.cos(theta), np.sin(theta)
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float32)
        t_c2w = np.array([0.08 * i, 0.01 * i, 0.02 * i], dtype=np.float32)
        rows[i, :4] = [0.9, 1.6, 0.5, 0.5]
        rows[i, 6:] = np.concatenate([rot.T, (-rot.T @ t_c2w)[:, None]], axis=1).reshape(-1)
    return rows


def write_cli_dataset(root) -> list:
    """A synthetic RE10K test stage: 2 scenes of CLI_FRAMES JPEG frames at
    360x640 in one chunk, written by the port's ``save_chunk``."""
    from mvldm_tpu_torch.data.chunk_reader import save_chunk

    stage = root / "test"
    stage.mkdir(parents=True)
    keys = [f"scenetest{s:04d}" for s in range(2)]
    save_chunk([{"key": key, "cameras": make_cameras(CLI_FRAMES),
                 "images": [make_frame(i + 100 * s) for i in range(CLI_FRAMES)]}
                for s, key in enumerate(keys)], stage / "000000.torch")
    (stage / "index.json").write_text(json.dumps({k: "000000.torch" for k in keys}))
    return keys


def check_cli_tree(scene_dir, n_frames: int, what: str) -> dict:
    """The JAX CLI's output tree for one scene: ``color/`` with a uint8
    256 px PNG for each sampled frame (targets 0..n-1), ``context/`` with
    the context pair (frames 0 and 23), ``sampled.gif`` and the 25 / 10 fps
    MP4s, which must parse."""
    from PIL import Image

    from mvldm_tpu_torch.utils.mp4 import parse_boxes

    colors = sorted(p.name for p in (scene_dir / "color").glob("*.png"))
    if colors != [f"{i:06d}.png" for i in range(n_frames)]:
        fail(f"{what}: color/ holds {colors}")
    context = sorted(p.name for p in (scene_dir / "context").glob("*.png"))
    if context != [f"{0:06d}.png", f"{CLI_FRAMES - 1:06d}.png"]:
        fail(f"{what}: context/ holds {context}")
    means = []
    for name in colors:
        img = np.asarray(Image.open(scene_dir / "color" / name))
        if img.dtype != np.uint8 or img.shape != (256, 256, 3) or img.min() == img.max():
            fail(f"{what}: frame {name} is {img.dtype} {img.shape}, range "
                 f"{img.min()}..{img.max()}")
        means.append(float(img.mean()))
    if not (scene_dir / "sampled.gif").is_file():
        fail(f"{what}: no sampled.gif")
    for name in ("sampled_fps_25.mp4", "sampled_fps_10.mp4"):
        boxes = [k.decode() for k, _ in parse_boxes((scene_dir / name).read_bytes())]
        if boxes != ["ftyp", "mdat", "moov"]:
            fail(f"{what}: {name} boxes {boxes}")
    return {"frames": len(colors), "frame_mean": float(np.mean(means))}


def cli_phase(card: str, kernels, f32_kernels) -> dict:
    """The sampling CLI, ``python -m mvldm_tpu_torch.scripts.generate_mvldm``
    as a user runs it (``generate_mvldm.main``, on the card), at
    ``+experiment=baseline`` (the 0.93B UNet, the SD2.1 VAE, 256 px, bf16,
    seeded weights) with 25 steps, on a synthetic RE10K test stage written
    here: (a) anchored, both scenes in one dispatch, 8 frames each; (b)
    autoregressive, 7 frames (windows of 4 and 3) of one scene chosen by
    hash; (c) (b) with the latent feedthrough; (d) DDPM with 10 steps,
    anchored, 4 frames; (e) the standard cross-view block, anchored, 4
    frames. Each run's forward-kernel launches must be CLI_LAUNCHES's, with
    no f32-route launch, and its output tree the JAX CLI's. Returns each
    run's launch counts."""
    import shutil
    from pathlib import Path

    from mvldm_tpu_torch.scripts import generate_mvldm

    root = Path(__file__).resolve().parent / "build" / "cli_smoke"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    keys = write_cli_dataset(root / "data")
    data_s = time.perf_counter() - t0
    common = ["+experiment=baseline", f"dataset.root={root / 'data'}",
              "model.scheduler.num_inference_steps=25", "trainer.limit_test_batches=2",
              "dataset.view_sampler.max_distance_between_context_views=23"]
    anchored4 = ["test.sampling_mode=anchored", "test.limit_frames=4", f"scene_id={keys[0]}"]
    autoregressive = ["test.sampling_mode=autoregressive", "test.limit_frames=7",
                      f"scene_id={keys[1]}"]
    runs = {
        "anchored": (["test.sampling_mode=anchored", "test.limit_frames=8",
                      "test.scene_batch=2"], keys, 8),
        "autoregressive": (autoregressive, keys[1:], 7),
        "autoregressive_feedthrough": (autoregressive + ["test.ar_latent_feedthrough=true"],
                                       keys[1:], 7),
        "ddpm": (["model/scheduler=ddpm", "model.scheduler.num_inference_steps=10"]
                 + anchored4, keys[:1], 4),
        "standard": (["model/denoiser/multi_view_attention=standard"] + anchored4,
                     keys[:1], 4),
    }
    from mvldm_tpu_torch.builder import build_engine
    from mvldm_tpu_torch.config import compose, load_typed_root_config

    t0 = time.perf_counter()
    build_engine(load_typed_root_config(compose(common)), "cuda")
    torch.cuda.synchronize()
    emit(phase="cli_engine_build", what="build_engine at +experiment=baseline on the card "
         "(seeded weights drawn on the host), the part of each cli run's wall time before "
         "its data and sampling", seconds=time.perf_counter() - t0, data_s=data_s, card=card)
    by_run = {}
    for name, (extra, scenes, n_frames) in runs.items():
        out = root / "runs" / name
        argv = common + extra + [f"output_dir={out}"]
        for fn in kernels + f32_kernels:
            fn.launches = 0
        t0 = time.perf_counter()
        generate_mvldm.main(argv)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches, f32_launches = _counts(kernels), _counts(f32_kernels)
        written = sorted(p.name for p in (out / "video").iterdir())
        if written != sorted(scenes):
            fail(f"cli {name}: scenes written {written}, not {sorted(scenes)}")
        trees = {key: check_cli_tree(out / "video" / key, n_frames, f"cli {name} {key}")
                 for key in scenes}
        frames = sum(t["frames"] for t in trees.values())
        emit(phase="cli", run=name, argv=" ".join(argv),
             what="generate_mvldm.main on the card, wall time of the call (engine build "
             "with seeded weights on the host, data, sampling, PNG / GIF / MP4 export)",
             wall_s=wall_s, frames=frames, frames_per_s=frames / wall_s, scenes=trees,
             launches=launches, expected_launches=CLI_LAUNCHES[name],
             f32_launches=f32_launches, card=card)
        if launches != CLI_LAUNCHES[name]:
            fail(f"cli {name}: launched {launches}, not {CLI_LAUNCHES[name]}")
        if any(f32_launches.values()):
            fail(f"cli {name}: the bf16 CLI launched f32 kernels: {f32_launches}")
        by_run[name] = launches
    return by_run


def ddpm_step_check(card: str) -> None:
    """One DDPM ancestral step (the config's scheduler at 10 steps) in f32
    on the card against the same step in float64 on the host, on the same
    prediction, sample and noise, at the first, a middle and the last
    timestep."""
    from mvldm_tpu_torch.config import compose, load_typed_root_config
    from mvldm_tpu_torch.diffusion.schedulers import get_scheduler

    cfg = load_typed_root_config(compose(["+experiment=baseline", "model/scheduler=ddpm",
                                          "model.scheduler.num_inference_steps=10"]))
    sched = get_scheduler(cfg.model.scheduler)
    gen = torch.Generator("cuda").manual_seed(8)
    shape = (2, 4, 32, 32, 4)
    pred, x, noise = (torch.randn(shape, generator=gen, device="cuda") for _ in range(3))
    rels = {}
    for t in (int(sched.timesteps()[0]), 500, 0):
        card_out = sched.step(pred, t, x, noise).double().cpu()
        host = sched.step(pred.double().cpu(), t, x.double().cpu(), noise.double().cpu())
        rels[t] = (torch.linalg.norm(card_out - host) / torch.linalg.norm(host)).item()
    emit(phase="cli_ddpm_step", what="DDPM ancestral step, f32 on the card vs float64 on "
         "the host, same prediction, sample and noise (2 x 4 x 32 x 32 x 4)",
         rel_l2_by_t=rels, bound=DDPM_STEP_REL_BOUND, card=card)
    if not all(r <= DDPM_STEP_REL_BOUND for r in rels.values()):
        fail(f"DDPM step on the card: rel L2 {rels} > {DDPM_STEP_REL_BOUND}")


def standard_unet_parity(card: str, inputs) -> None:
    """The UNet of run (e), ``multi_view_attention: standard``, at the UNet
    parity phase's inputs: the card in bf16 (kernels) against the host in
    f32 (plain versions), the same seeded weights."""
    from mvldm_tpu_torch.builder import build_engine
    from mvldm_tpu_torch.config import compose, load_typed_root_config

    cfg = load_typed_root_config(compose(["+experiment=baseline",
                                          "model/denoiser/multi_view_attention=standard"]))
    t0 = time.perf_counter()
    x, t, mask = inputs
    with torch.inference_mode():
        gpu = build_engine(cfg, "cuda").unet(x.cuda(), t.cuda(), view_mask=mask.cuda())
        gpu = gpu.float().cpu()
        cpu = build_engine(cfg, "cpu", torch.float32).unet(x, t, view_mask=mask)
    rel = (torch.linalg.norm(gpu - cpu) / torch.linalg.norm(cpu)).item()
    finite = bool(torch.isfinite(gpu).all())
    emit(phase="cli_standard_parity", what="UNet with the standard cross-view block, 2 rows x "
         "5 views, 32x32 latents, view mask: card bf16 kernels vs host f32 plain",
         rel_l2=rel, bound=UNET_REL_L2_BOUND, finite=finite, rms_host=cpu.square().mean().sqrt()
         .item(), seconds=time.perf_counter() - t0, card=card)
    if not finite or not rel <= UNET_REL_L2_BOUND:
        fail(f"standard-block UNet parity rel L2 {rel:.4g} > {UNET_REL_L2_BOUND}")


# Two scenes in one dispatch against each alone (trouble of batch-dependent
# convolution algorithms): relative L2 of the sampled latents after the
# 25-step loop, bf16.
SCENE_BATCH_REL_L2_BOUND = 3e-2


def scene_batch_checks(card: str, engine) -> None:
    """``dispatch_anchored_many`` / ``dispatch_autoregressive_many`` at S = 1
    against the single-scene dispatch with the same seed: equal bit for bit.
    Then the sampling loop at S = 2 against each scene alone with the same
    context latents and noise, within SCENE_BATCH_REL_L2_BOUND."""
    from mvldm_tpu_torch.builder import IMAGE_HW
    from mvldm_tpu_torch.diffusion.video_sampling import VideoSampler

    sampler = VideoSampler(engine)
    ctx, tgt = make_scene(8, IMAGE_HW)
    record = {}
    for mode, limit in (("anchored", 8), ("autoregressive", 7)):
        single = getattr(sampler, f"sample_{mode}")(
            ctx, tgt, torch.Generator("cuda").manual_seed(6), limit_frames=limit)
        [many] = getattr(sampler, f"sample_{mode}_many")(
            [(ctx, tgt)], torch.Generator("cuda").manual_seed(6), limit_frames=limit)
        equal = sorted(single) == sorted(many) and all(
            np.array_equal(single[f], many[f]) for f in single)
        record[mode] = {"frames": len(single), "bitwise_equal": bool(equal)}
        if not equal:
            fail(f"{mode}: dispatch_{mode}_many at S = 1 differs from the single-scene dispatch")

    gen = torch.Generator("cuda").manual_seed(9)
    ctx_lat = torch.randn((2, 1, 32, 32, 4), generator=gen, device="cuda")
    noise = torch.randn((2, 4, 32, 32, 4), generator=gen, device="cuda")
    extr = torch.eye(4, device="cuda").repeat(2, 5, 1, 1)
    extr[:, :, 0, 3] = torch.linspace(0, 1, 5, device="cuda")
    extr[1, :, 2, 3] = 0.3
    intr = torch.eye(3, device="cuda").repeat(2, 5, 1, 1)
    intr[:, :, :2, 2] = 0.5
    both = engine.sample_latents(ctx_lat, extr, intr, 4, initial_noise=noise)
    rels = []
    for i in range(2):
        alone = engine.sample_latents(ctx_lat[i:i + 1], extr[i:i + 1], intr[i:i + 1], 4,
                                      initial_noise=noise[i:i + 1])
        rels.append((torch.linalg.norm(both[i:i + 1] - alone)
                     / torch.linalg.norm(alone)).item())
    record["s2_vs_s1_rel_l2"] = rels
    record["s2_vs_s1_bitwise_equal"] = [r == 0.0 for r in rels]
    emit(phase="cli_scene_batch", what="S = 1 scene-batched dispatch vs single-scene dispatch "
         "(same seed, bitwise), and the 25-step loop at S = 2 vs each scene alone (same "
         "latents and noise, relative L2)", **record, bound=SCENE_BATCH_REL_L2_BOUND, card=card)
    if not all(r <= SCENE_BATCH_REL_L2_BOUND for r in rels):
        fail(f"S = 2 against S = 1: rel L2 {rels} > {SCENE_BATCH_REL_L2_BOUND}")


# ------------------------------------------------------------------ t2mv

def build_mvdream(device, dtype: torch.dtype = torch.bfloat16, steps=None):
    """MVDream's engine (MVDREAM_CONFIG's ``model``, ``steps`` DDIM steps
    when given) through ``builder.build_engine``: seeded weights on
    ``device`` in ``dtype``, shapes only on the meta device."""
    from mvldm_tpu_torch.builder import build_engine
    from mvldm_tpu_torch.config import RootCfg, from_dict

    with open(MVDREAM_CONFIG) as f:
        model = json.load(f)["model"]
    if steps is not None:
        model["scheduler"]["num_inference_steps"] = steps
    return build_engine(from_dict(RootCfg, {"model": model}), device, dtype)


def t2mv_inputs(p: int, device, seed: int = 0):
    """P prompts' (77, 1024) text tokens, the empty prompt's, (P, 4, 16)
    cameras and (P, 4, 32, 32, 4) initial noise, seeded, on ``device``."""
    gen = torch.Generator().manual_seed(seed)
    text = torch.randn((p, 77, 1024), generator=gen)
    empty = torch.randn((77, 1024), generator=gen)
    cameras = torch.randn((p, T2MV_VIEWS, 16), generator=gen)
    noise = torch.randn((p, T2MV_VIEWS, 32, 32, 4), generator=gen)
    return tuple(t.to(device) for t in (text, empty, cameras, noise))


def t2mv_phase(card: str, kernels, f32_kernels) -> dict:
    """MVDream's text-to-multiview dispatch with launch counters, a timed
    second one, and the UNet's batched-CFG forward against the host."""
    engine = build_mvdream("cuda")
    for fn in kernels + f32_kernels:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    frames = engine.gather_frames(engine.text_to_multiview(*t2mv_inputs(T2MV_PROMPTS, "cpu")))
    cold_s = time.perf_counter() - t0
    launches, f32_launches = _counts(kernels), _counts(f32_kernels)
    if frames.dtype != np.uint8 or frames.shape != (T2MV_PROMPTS, T2MV_VIEWS, 256, 256, 3):
        fail(f"text_to_multiview returned {frames.dtype} {frames.shape}")
    if any(f.min() == f.max() for f in frames.reshape(-1, 256, 256, 3)):
        fail("text_to_multiview returned a constant frame")
    if launches != T2MV_LAUNCHES:
        fail(f"a t2mv dispatch launched {launches}, not {T2MV_LAUNCHES}")
    if any(f32_launches.values()):
        fail(f"the bf16 t2mv path launched f32 kernels: {f32_launches}")
    t0 = time.perf_counter()
    engine.gather_frames(engine.text_to_multiview(*t2mv_inputs(T2MV_PROMPTS, "cpu", 1)))
    warm_s = time.perf_counter() - t0
    emit(phase="t2mv", what="MVDream text_to_multiview, 4 prompts x 4 views, 256 px, 50 DDIM "
         "steps, batched CFG 10, bf16, seeded weights", first_pass_s=cold_s,
         second_pass_s=warm_s, frames_per_s=T2MV_PROMPTS * T2MV_VIEWS / warm_s,
         launches=launches, f32_launches=f32_launches,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
         frame_mean=float(frames.mean()), card=card)

    t0 = time.perf_counter()
    cpu_engine = build_mvdream("cpu", torch.float32)
    text, empty, cameras, noise = t2mv_inputs(1, "cpu", 2)
    x = torch.cat([noise, noise])
    t = torch.full((2, T2MV_VIEWS), 500)
    context = torch.cat([text, empty[None]])
    cameras = torch.cat([cameras, cameras])
    with torch.inference_mode():
        gpu = engine.unet(x.cuda(), t.cuda(), context.cuda(), cameras.cuda()).float().cpu()
        cpu = cpu_engine.unet(x, t, context, cameras)
    rel = (torch.linalg.norm(gpu - cpu) / torch.linalg.norm(cpu)).item()
    emit(phase="t2mv_unet_parity", what="MVDream batched-CFG UNet forward, 2 rows x 4 views, "
         "32x32 latents, 77 text tokens, cameras: card bf16 kernels vs host f32 plain",
         rel_l2=rel, bound=UNET_REL_L2_BOUND, cpu_side_s=time.perf_counter() - t0,
         finite=bool(torch.isfinite(gpu).all()), card=card)
    if not torch.isfinite(gpu).all() or not rel <= UNET_REL_L2_BOUND:
        fail(f"MVDream UNet parity rel L2 {rel:.4g} > {UNET_REL_L2_BOUND}")
    return launches


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


# ------------------------------------------------------------- cli_train

def write_train_dataset(root) -> dict:
    """A synthetic RE10K train and test stage, 2 scenes of TRAIN_FRAMES
    JPEG frames at 360x640 each (one chunk a stage), written by the port's
    ``save_chunk``; the val loader reads the test stage."""
    from mvldm_tpu_torch.data.chunk_reader import save_chunk

    frames = [make_frame(i) for i in range(TRAIN_FRAMES + 100)]
    keys = {}
    for stage in ("train", "test"):
        (root / stage).mkdir(parents=True)
        keys[stage] = [f"scene{stage}{s:04d}" for s in range(2)]
        save_chunk([{"key": key, "cameras": make_cameras(TRAIN_FRAMES),
                     "images": frames[100 * s:100 * s + TRAIN_FRAMES]}
                    for s, key in enumerate(keys[stage])], root / stage / "000000.torch")
        (root / stage / "index.json").write_text(
            json.dumps({k: "000000.torch" for k in keys[stage]}))
    return keys


def check_val_dir(val_dir, scenes, what: str) -> None:
    """cameras.png, distributions.png and one comparison grid a scene."""
    from PIL import Image

    names = sorted(p.name for p in val_dir.glob("*.png"))
    want = sorted(["cameras.png", "distributions.png"] + [f"{k}.png" for k in scenes])
    if names != want:
        fail(f"{what}: {val_dir} holds {names}, not {want}")
    for name in names:
        img = np.asarray(Image.open(val_dir / name))
        if img.dtype != np.uint8 or img.ndim != 3 or img.min() == img.max():
            fail(f"{what}: {name} is {img.dtype} {img.shape}, range {img.min()}..{img.max()}")


def saved_state(run_dir, step: int) -> dict:
    """The saved train state of ``step``, memory-mapped on the host."""
    path = run_dir / "checkpoints" / f"step_{step:09d}" / "state.pt"
    if not path.is_file():
        fail(f"no checkpoint {path}")
    return torch.load(path, map_location="cpu", mmap=True, weights_only=True)


def off_bf16_share(params: dict) -> float:
    """Share of master elements off the bf16 grid (low 16 bits set): the
    masters start as the bf16 module's weights, so an update moves them
    off it."""
    off = sum(int(((p.view(torch.int32) & 0xFFFF) != 0).sum()) for p in params.values())
    return off / sum(p.numel() for p in params.values())


def changed_share(a: dict, b: dict) -> float:
    return sum(int((a[k] != b[k]).sum()) for k in a) / sum(p.numel() for p in a.values())


def cli_train_phase(card: str, kernels, f32_kernels) -> dict:
    """The training CLI, ``python -m mvldm_tpu_torch.scripts.main`` as a
    user runs it (``main.main``, on the card), at ``+experiment=baseline``
    (the 0.93B UNet, the SD2.1 VAE, 256 px, batch 6 of 2 context + 3 target
    views, accumulation 2, bf16-mixed, seeded weights) on a synthetic RE10K
    train and test stage written here: (f) 4 steps, validation and a
    checkpoint every 2 (val batch 2); (g) (f) again to 6 steps, resuming at
    4; (h) ``mode=val`` on that directory; (i) ``+experiment=tpu_fast``
    (remat, bf16 moments by stochastic rounding), 4 steps. Each run's
    launches must be TRAIN_CLI_LAUNCHES's, with no f32-route launch; its
    losses finite, its checkpoints and validation grids where the JAX CLI
    writes them. Returns each run's launch counts."""
    import shutil
    from pathlib import Path

    from mvldm_tpu_torch.scripts import main as main_script
    from mvldm_tpu_torch.training.checkpoint import CheckpointManager

    root = Path(__file__).resolve().parent / "build" / "cli_train_smoke"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    keys = write_train_dataset(root / "data")
    data_s = time.perf_counter() - t0
    run_dir = root / "runs" / "baseline"
    common = ["+experiment=baseline", f"dataset.root={root / 'data'}",
              f"output_dir={run_dir}"]
    train = ["mode=train", "trainer.val_check_interval=2",
             "checkpointing.every_n_train_steps=2", "data_loader.val.batch_size=2",
             "checkpointing.save_top_k=2"]
    fast_dir = root / "runs" / "tpu_fast"
    runs = {
        "train": common + train + ["trainer.max_steps=4"],
        "train_resume": common + train + ["trainer.max_steps=6"],
        "val": common + ["mode=val", "data_loader.val.batch_size=2"],
        "train_tpu_fast": ["+experiment=baseline", "+experiment=tpu_fast", "mode=train",
                           "trainer.max_steps=4", f"dataset.root={root / 'data'}",
                           f"output_dir={fast_dir}"],
    }
    partial_restores = []
    restore_partial = CheckpointManager.restore_partial

    def counted_restore_partial(self, step, keys_):
        partial_restores.append((step, list(keys_)))
        return restore_partial(self, step, keys_)

    CheckpointManager.restore_partial = counted_restore_partial
    by_run, peaks = {}, {}
    try:
        for name, argv in runs.items():
            if name == "train_tpu_fast":
                shutil.rmtree(run_dir)  # (h) has read it; free its checkpoints' disk
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            held = torch.cuda.memory_allocated() / 2 ** 30
            torch.cuda.reset_peak_memory_stats()
            for fn in kernels + f32_kernels:
                fn.launches = 0
            t0 = time.perf_counter()
            main_script.main(argv)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches, f32_launches = _counts(kernels), _counts(f32_kernels)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            peaks[name] = peak
            out = fast_dir if name == "train_tpu_fast" else run_dir
            rec = dict(phase="cli_train", run=name, argv=" ".join(argv),
                       what="scripts.main.main on the card, wall time of the call (engine "
                       "build with seeded weights on the host, data, steps, checkpoints, "
                       "validation sampling and its PNGs)",
                       wall_s=wall_s, peak_memory_gb=peak, held_before_gb=held,
                       launches=launches, expected_launches=TRAIN_CLI_LAUNCHES[name],
                       f32_launches=f32_launches, card=card)
            if name != "val":
                log = [json.loads(line) for line in
                       (out / "metrics.jsonl").read_text().splitlines()]
                rec["metrics"] = log
                rec["steps_per_s"] = log[-1]["steps_per_sec"]
                losses = [r["loss/diffusion"] for r in log]
                if not losses or not all(np.isfinite(x) for x in losses):
                    fail(f"cli_train {name}: losses {losses}")
            checks = cli_train_checks(name, out, keys, partial_restores)
            emit(**rec, **checks)
            if launches != TRAIN_CLI_LAUNCHES[name]:
                fail(f"cli_train {name}: launched {launches}, not {TRAIN_CLI_LAUNCHES[name]}")
            if any(f32_launches.values()):
                fail(f"cli_train {name}: the bf16 CLI launched f32 kernels: {f32_launches}")
            by_run[name] = launches
    finally:
        CheckpointManager.restore_partial = restore_partial
    if not peaks["train_tpu_fast"] < peaks["train"]:
        fail(f"cli_train: tpu_fast peak {peaks['train_tpu_fast']:.3f} GiB not below the "
             f"baseline's {peaks['train']:.3f} GiB")
    emit(phase="cli_train_data", what="writing the synthetic train and test stages",
         seconds=data_s, frames_per_scene=TRAIN_FRAMES, card=card)
    return by_run


def cli_train_checks(name: str, out, keys: dict, partial_restores: list) -> dict:
    """The output tree and saved states of one cli_train run (see
    :func:`cli_train_phase`); fatal on a mismatch."""
    scenes = keys["test"]
    ckpts = sorted(p.name for p in (out / "checkpoints").glob("step_*"))
    if name == "train":
        if ckpts != ["step_000000002", "step_000000004"]:
            fail(f"cli_train {name}: checkpoints {ckpts}")
        s2, s4 = saved_state(out, 2), saved_state(out, 4)
        counts = (s2["opt_state"]["count"], s4["opt_state"]["count"])
        if (s2["step"], s4["step"]) != (2, 4) or counts != (1, 2):
            fail(f"cli_train {name}: steps {s2['step']}, {s4['step']}, updates {counts}")
        moved, changed = off_bf16_share(s2["params"]), changed_share(s2["params"], s4["params"])
        if not moved > 0 or not changed > 0:
            fail(f"cli_train {name}: masters unchanged (off the init {moved}, step 2 -> 4 "
                 f"{changed})")
        for step in (2, 4):
            check_val_dir(out / "val" / f"step_{step}", scenes, f"cli_train {name}")
        return {"updates": counts, "masters_off_init_share": moved,
                "masters_changed_2_to_4_share": changed}
    if name == "train_resume":
        log = (out / "metrics.jsonl").read_text().splitlines()
        s6 = saved_state(out, 6)
        if ckpts != ["step_000000004", "step_000000006"] or s6["step"] != 6 \
                or s6["opt_state"]["count"] != 3 or json.loads(log[-1])["step"] != 6:
            fail(f"cli_train {name}: checkpoints {ckpts}, step {s6['step']}, "
                 f"updates {s6['opt_state']['count']}")
        check_val_dir(out / "val" / "step_6", scenes, f"cli_train {name}")
        return {"updates": s6["opt_state"]["count"], "checkpoints": ckpts}
    if name == "val":
        if partial_restores != [(6, ["params"])]:
            fail(f"cli_train {name}: restore_partial calls {partial_restores}")
        check_val_dir(out / "val", scenes, f"cli_train {name}")
        return {"restore_partial": partial_restores}
    s4 = saved_state(out, 4)
    dtypes = {m: sorted({str(t.dtype) for t in s4["opt_state"][m].values()}) for m in ("mu", "nu")}
    if dtypes != {"mu": ["torch.bfloat16"], "nu": ["torch.bfloat16"]} \
            or s4["opt_state"]["count"] != 2:
        fail(f"cli_train {name}: moments {dtypes}, updates {s4['opt_state']['count']}")
    from mvldm_tpu_torch.config import compose, load_typed_root_config

    remat = load_typed_root_config(compose(["+experiment=baseline", "+experiment=tpu_fast"]
                                           )).trainer.remat
    if not remat:
        fail(f"cli_train {name}: trainer.remat is {remat}")
    return {"moment_dtypes": dtypes, "remat": remat, "updates": s4["opt_state"]["count"]}


# ------------------------------------------------- training variants, eval

def vae_encode_f32_plan(batches) -> dict:
    """f32-route launches of VAE encodes at 256 px, one call a batch size in
    ``batches``: the mid block's one-head D = 512 attention over 1024 tokens
    goes past the flash kernel (``attention_route_f32``): for each chunk of
    heads the route's chunking takes, two GEMM-tile launches (S, P V) and a
    row pass."""
    from mvldm_tpu_torch.ops.f32_route import attention_chunks

    plan = {"flash_attention_f32": 0, "flash_attention_bwd_f32": 0,
            "fused_ln_self_attention_f32": 0, "fused_ln_geglu_ff_f32": 0,
            "gemm_f32": 0, "attention_rows_f32": 0}
    for b in batches:
        n = len(attention_chunks(b, 1024, 1024))
        plan["flash_attention_f32"] += 1
        plan["gemm_f32"] += 2 * n
        plan["attention_rows_f32"] += n
    return plan


def cached_moments_error(got, want) -> dict:
    """The cache's float16 moments ``got`` against the host's f32 encode
    ``want``: relative L2, and the largest difference in float16 steps of
    the value (the step floored at that of 1/64 of the rms)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    rms = np.sqrt(np.mean(want ** 2))
    step = np.spacing(np.maximum(np.abs(want), rms / 64).astype(np.float16)).astype(np.float32)
    return {"rel_l2": float(np.linalg.norm(got - want) / np.linalg.norm(want)),
            "max_f16_steps": float(np.max(np.abs(got - want) / step))}


def run_counted(kernels, f32_kernels, fn, *args, **kwargs) -> dict:
    """``fn(*args, **kwargs)`` with every launch count set to 0 before it:
    its wall time, peak device memory, and the counts after it."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels + f32_kernels:
        k.launches = 0
    t0 = time.perf_counter()
    fn(*args, **kwargs)
    torch.cuda.synchronize()
    return {"wall_s": time.perf_counter() - t0,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": _counts(kernels), "f32_launches": _counts(f32_kernels)}


def precompute_phase(card: str, data, cache, kernels, f32_kernels) -> dict:
    """(j) ``precompute_latents`` in f32 (TF32 off, the f32 route) with the
    port's seeded VAE on cli_train's synthetic train stage: 2 scenes of
    TRAIN_FRAMES frames, both flips, in launches of 32 frames. The cache's
    layout, its f32-route launches against their plan (no bf16 launch),
    and two frames of each flip against the same f32 encode on the host
    (relative L2 within PRECOMPUTE_REL_L2)."""
    from mvldm_tpu_torch.data.latent_cache import LatentCacheReader
    from mvldm_tpu_torch.scripts import precompute_latents

    argv = [f"dataset.root={data}", f"out={cache}", "allow_init_vae=true"]
    r = run_counted(kernels, f32_kernels, precompute_latents.main, argv)
    per_scene = -(-TRAIN_FRAMES // 32)
    plan = vae_encode_f32_plan([32] * (2 * 2 * per_scene))
    meta = json.loads((cache / "train" / "meta.json").read_text())
    chunk = np.load(cache / "train" / "000000.npz")
    shapes = {k: list(chunk[k].shape) for k in chunk.files}
    if meta != {"image_shape": [256, 256], "latent_channels": 4, "n_flips": 2,
                "vae_fingerprint": "random-init(seed=0, mvldm_tpu_torch) dtype:float32"} \
            or shapes != {f"scenetrain{s:04d}": [TRAIN_FRAMES, 2, 32, 32, 8] for s in range(2)} \
            or not all(np.isfinite(chunk[k]).all() and chunk[k].dtype == np.float16
                       for k in chunk.files):
        fail(f"precompute: meta {meta}, arrays {shapes}")

    # The host's f32 encode of frames 0 and 180 of the first scene, both
    # flips, through the same pixels (the crop shim of the dataset's path).
    from mvldm_tpu_torch.data.chunk_reader import convert_poses, decode_jpeg_bytes, load_chunk
    from mvldm_tpu_torch.data.shims import rescale_and_crop

    cfg = precompute_latents.load_precompute_cfg(argv)
    vae = precompute_latents.build_vae(cfg, "cpu", torch.float32)
    example = load_chunk(data / "train" / "000000.torch")[0]
    idx = [0, TRAIN_FRAMES - 1]
    _, intr = convert_poses(example["cameras"])
    pixels, _ = rescale_and_crop(np.stack([decode_jpeg_bytes(example["images"][i]) for i in idx]),
                                 intr[idx], (256, 256))
    reader = LatentCacheReader(cache, "train", image_shape=(256, 256))
    errors = {}
    for flip in (False, True):
        x = torch.from_numpy(pixels[:, :, ::-1].copy() if flip else pixels) * 2.0 - 1.0
        with torch.no_grad():
            dist = vae.encode(x)
        want = torch.cat([dist.mean, dist.logvar], -1).numpy()
        errors[f"flip_{flip}"] = cached_moments_error(
            reader.lookup("000000", example["key"], np.array(idx), flip), want)
    emit(phase="precompute_latents", run="j", argv=" ".join(argv),
         what="precompute_latents.main on the card: the port's seeded SD2.1 VAE in f32 (TF32 "
         "off), 2 scenes x 181 frames x 2 flips = 724 encodes in launches of 32, wall time "
         "of the call (JPEG decode, LANCZOS crop, encode, npz write)",
         encodes=2 * 2 * TRAIN_FRAMES, **r, expected_f32_launches=plan, meta=meta,
         card_vs_host=errors, bound_rel_l2=PRECOMPUTE_REL_L2, card=card)
    if r["f32_launches"] != plan or any(r["launches"].values()):
        fail(f"precompute: f32 launches {r['f32_launches']} (plan {plan}), bf16 {r['launches']}")
    if not all(e["rel_l2"] <= PRECOMPUTE_REL_L2 for e in errors.values()):
        fail(f"precompute: the card's moments against the host's: {errors}")
    return r["f32_launches"]


def saved_opt_checks(run_dir, step: int) -> dict:
    """The saved state of ``step``: its update count, the share of masters
    moved off the bf16 init, and each optimizer tree's dtypes."""
    s = saved_state(run_dir, step)
    return {"step": s["step"], "updates": s["opt_state"]["count"],
            "masters_off_init_share": off_bf16_share(s["params"]),
            "opt_state": {k: sorted({str(t.dtype) for t in v.values()})
                          for k, v in s["opt_state"].items() if isinstance(v, dict)}}


def train_variant_runs(card: str, data, cache, runs_dir, kernels, f32_kernels) -> dict:
    """(k) ``+experiment=baseline +experiment=tpu_fast`` from the latent
    cache of (j), 4 steps at batch 6; (l) ``optimizer.name=Adafactor``, 2
    steps (one update: accumulation 2); (m) ``trainer.remat=true
    trainer.remat_policy=dots``, 2 steps. Each run's launches its plan's
    (TRAIN_CLI_LAUNCHES), no f32-route launch, finite losses, the saved
    state's optimizer and moved masters."""
    import shutil

    from mvldm_tpu_torch.scripts import main as main_script

    common = ["+experiment=baseline", "mode=train", f"dataset.root={data}"]
    runs = {
        "train_latent_cache": ["+experiment=tpu_fast", "trainer.max_steps=4",
                               f"dataset.latent_cache={cache}"],
        "train_adafactor": ["optimizer.name=Adafactor", "trainer.max_steps=2"],
        "train_remat_dots": ["trainer.remat=true", "trainer.remat_policy=dots",
                             "trainer.max_steps=2"],
    }
    by_run = {}
    for name, extra in runs.items():
        out = runs_dir / name
        argv = common + extra + [f"output_dir={out}"]
        r = run_counted(kernels, f32_kernels, main_script.main, argv)
        log = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
        losses = [x["loss/diffusion"] for x in log]
        steps = 4 if name == "train_latent_cache" else 2
        state = saved_opt_checks(out, steps)
        emit(phase="cli_train_variants", run=name, argv=" ".join(argv),
             what="scripts.main.main on the card at batch 6, wall time of the call (engine "
             "build, data, steps, the final checkpoint)", **r,
             expected_launches=TRAIN_CLI_LAUNCHES[name], losses=losses,
             steps_per_s=log[-1]["steps_per_sec"], saved=state, card=card)
        shutil.rmtree(out)
        if r["launches"] != TRAIN_CLI_LAUNCHES[name] or any(r["f32_launches"].values()):
            fail(f"{name}: launched {r['launches']} (plan {TRAIN_CLI_LAUNCHES[name]}), "
                 f"f32 {r['f32_launches']}")
        if not losses or not all(np.isfinite(x) for x in losses):
            fail(f"{name}: losses {losses}")
        f32, bf16 = ["torch.float32"], ["torch.bfloat16"]
        want = {"train_latent_cache": {"acc": f32, "mu": bf16, "nu": bf16},
                "train_adafactor": {"acc": f32, "v": f32, "v_col": f32, "v_row": f32},
                "train_remat_dots": {"acc": f32, "mu": f32, "nu": f32}}[name]
        if state["opt_state"] != want or not state["masters_off_init_share"] > 0 \
                or state["updates"] != steps // 2:  # accumulation 2
            fail(f"{name}: saved state {state}")
        by_run[name] = r["launches"]
    return by_run


def remat_policy_compare(card: str) -> dict:
    """(m) beside full remat and no remat: one training step's loss and
    backward at batch 6 (2 + 4 views) with the same draws under each
    policy; the peak device memory above what was held before it; loss and
    UNet gradient of "dots" and of no remat against full remat's."""
    from mvldm_tpu_torch.builder import build_flagship_train, make_train_batch

    engine = build_flagship_train("cuda")
    batch = make_train_batch(6)
    named = [(n, p) for n, p in engine.unet.named_parameters() if p.requires_grad]
    out = {}
    for name, remat, policy in (("full", True, None), ("dots", True, "dots"),
                                ("none", False, None)):
        engine.unet.remat, engine.unet.remat_policy = remat, policy
        for _, p in named:
            p.grad = None
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, _ = engine.training_loss(batch, 2, generator=torch.Generator("cuda").manual_seed(9))
        loss.backward()
        torch.cuda.synchronize()
        rec = {"s": time.perf_counter() - t0,
               "peak_above_held_gb": (torch.cuda.max_memory_allocated() - held) / 2 ** 30,
               "loss": float(loss.detach())}
        grad = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).float().flatten()
                          for _, p in named])
        if name == "full":
            ref_loss, ref_grad = rec["loss"], grad
        else:
            rec["loss_rel_vs_full"] = abs(rec["loss"] - ref_loss) / abs(ref_loss)
            rec["grad_rel_l2_vs_full"] = float((grad - ref_grad).norm() / ref_grad.norm())
        del grad
        out[name] = rec
    del engine, ref_grad
    for _, p in named:
        p.grad = None
    torch.cuda.empty_cache()
    emit(phase="remat_policy", what="one training step's loss and backward at batch 6 "
         "(2 ctx + 3 tgt views, 256 px) on the seeded flagship, same draws, under full remat, "
         "remat_policy=dots and no remat: seconds, peak memory above the memory held before "
         "it, loss and UNet gradient against full remat's", **out,
         bounds={"loss_rel": TRAIN_LOSS_REL_BOUND, "grad_rel_l2": TRAIN_GRAD_REL_L2_BOUND},
         card=card)
    peaks = {k: v["peak_above_held_gb"] for k, v in out.items()}
    if not peaks["full"] < peaks["dots"] < peaks["none"]:
        fail(f"remat_policy: peaks {peaks} not full < dots < none")
    for name in ("dots", "none"):
        if not (out[name]["loss_rel_vs_full"] <= TRAIN_LOSS_REL_BOUND
                and out[name]["grad_rel_l2_vs_full"] <= TRAIN_GRAD_REL_L2_BOUND):
            fail(f"remat_policy {name}: {out[name]}")
    return out


def cli_variants_phase(card: str, kernels, f32_kernels):
    """(j)-(m) on cli_train's synthetic stage: see :func:`precompute_phase`,
    :func:`train_variant_runs` and :func:`remat_policy_compare`."""
    import shutil
    from pathlib import Path

    root = Path(__file__).resolve().parent / "build" / "cli_train_smoke"
    shutil.rmtree(root / "runs", ignore_errors=True)  # cli_train's checkpoints
    cache = root / "latents"
    shutil.rmtree(cache, ignore_errors=True)
    f32_launches = precompute_phase(card, root / "data", cache, kernels, f32_kernels)
    by_run = train_variant_runs(card, root / "data", cache, root / "runs", kernels, f32_kernels)
    remat_policy_compare(card)
    return by_run, f32_launches


def write_metric_weights(root) -> tuple:
    """Seeded synthetic weights in the real layouts: ``lpips_vgg.npz`` (VGG16
    HWIO kernels He-scaled so the signal survives 13 layers, the LPIPS heads,
    DISTS alpha / beta) and ``inception_fid.npz`` (the FID InceptionV3
    state dict census, He-scaled convs, BN statistics near identity)."""
    from mvldm_tpu_torch.evaluation.inception import expected_state_keys
    from mvldm_tpu_torch.evaluation.metrics import VGG_LAYERS

    rng = np.random.default_rng(0)
    vgg, cin = {}, 3
    for block, (ch, n_convs) in enumerate(VGG_LAYERS):
        for c in range(n_convs):
            name = f"conv{block + 1}_{c + 1}"
            vgg[f"{name}_kernel"] = rng.normal(0, np.sqrt(2 / (9 * cin)),
                                               (3, 3, cin, ch)).astype(np.float32)
            vgg[f"{name}_bias"] = (0.01 * rng.normal(size=ch)).astype(np.float32)
            cin = ch
    for i, ch in enumerate((64, 128, 256, 512, 512)):
        vgg[f"lin{i}"] = np.abs(rng.normal(size=ch)).astype(np.float32)
    n = 3 + 64 + 128 + 256 + 512 + 512
    vgg["dists_alpha"] = np.abs(rng.normal(size=n)).astype(np.float32)
    vgg["dists_beta"] = np.abs(rng.normal(size=n)).astype(np.float32)
    inc = {}
    for key, shape in expected_state_keys().items():
        if key.endswith("conv.weight"):
            inc[key] = rng.normal(0, np.sqrt(2 / np.prod(shape[1:])), shape).astype(np.float32)
        elif key.endswith("bn.weight"):
            inc[key] = (1 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        elif key.endswith("bn.bias"):
            inc[key] = (0.05 * rng.normal(size=shape)).astype(np.float32)
        elif key.endswith("running_mean"):
            inc[key] = (0.01 * rng.normal(size=shape)).astype(np.float32)
        else:
            inc[key] = (np.abs(1 + 0.1 * rng.normal(size=shape)) + 0.1).astype(np.float32)
    np.savez(root / "lpips_vgg.npz", **vgg)
    np.savez(root / "inception_fid.npz", **inc)
    return root / "lpips_vgg.npz", root / "inception_fid.npz"


def _rel(got, want) -> float:
    return abs(got - want) / max(abs(want), 1e-12)


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def eval_phase(card: str, kernels, f32_kernels) -> dict:
    """(n) The evaluation CLIs on the card over cli run (a)'s output:
    ``generate_gt`` and ``generate_gt_image_directory`` on the same test
    stage; ``compute_metrics`` (directory form with LPIPS, DISTS and
    Inception weights; with the VAE-feature fallback; Hydra over the test
    datamodule with the VGG FID) and ``compute_fid`` (Inception; VGG
    through Hydra; the VAE fallback), on seeded synthetic weights in the
    real layouts and ``--allow-init-vae``. Each JSON tree's keys; the
    metrics against the port's CPU run on the same images (PSNR, SSIM
    within EVAL_PSNR_SSIM_REL, the rest and the FID features within
    EVAL_FEATURE_REL); the f32 VAE encodes through the f32 route (launches
    against their plan), no bf16 launch anywhere."""
    import shutil
    from pathlib import Path

    from mvldm_tpu_torch.evaluation.fid import (
        resolve_vae_params,
        vae_feature_extractor,
        vgg_feature_extractor,
    )
    from mvldm_tpu_torch.evaluation.inception import inception_feature_extractor
    from mvldm_tpu_torch.evaluation.metric_computer import (
        EvaluationCfg,
        MethodCfg,
        MetricComputer,
    )
    from mvldm_tpu_torch.scripts import (
        compute_fid,
        compute_metrics,
        generate_gt,
        generate_gt_image_directory,
    )
    from mvldm_tpu_torch.utils.image_io import load_image

    here = Path(__file__).resolve().parent / "build"
    data, video = here / "cli_smoke" / "data", here / "cli_smoke" / "runs" / "anchored" / "video"
    root = here / "eval_smoke"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    test_args = ["+experiment=baseline", f"dataset.root={data}", "trainer.limit_test_batches=2",
                 "dataset.view_sampler.max_distance_between_context_views=23",
                 "test.limit_frames=8"]
    rec = {}
    rec["generate_gt"] = run_counted(kernels, f32_kernels, generate_gt.main,
                                     test_args + [f"output_dir={root / 'gt'}"])
    rec["generate_gt_image_directory"] = run_counted(
        kernels, f32_kernels, generate_gt_image_directory.main,
        test_args + [f"output_dir={root / 'gt_images'}"])
    scenes = sorted(p.name for p in video.iterdir() if p.is_dir())
    gt_names = {s: sorted(p.name for p in (root / "gt" / s).glob("*.png")) for s in scenes}
    color = {s: sorted(p.name for p in (video / s / "color").glob("*.png")) for s in scenes}
    flat = sorted(p.name for p in (root / "gt_images").glob("*.png"))
    if gt_names != color or flat != sorted(f"{s}_{n}" for s in scenes for n in gt_names[s]):
        fail(f"eval: GT {gt_names} / {flat}, renders {color}")
    index = root / "eval_index.json"
    index.write_text(json.dumps({s: {"context": [0, CLI_FRAMES - 1],
                                     "target": [int(n[:-4]) for n in gt_names[s]]}
                                 for s in scenes}))
    w_vgg, w_inc = write_metric_weights(root)
    absent = root / "absent.npz"
    method = f"a={video}"
    hydra = ["+evaluation=re10k_video", f"dataset.root={data}",
             f"dataset.view_sampler.index_path={index}",
             f"evaluation.methods=[{{name: a, key: a, path: {video}}}]",
             "limit_test_batches=2", f"fid_gt_dir={root / 'gt_images'}",
             f"lpips_weights={w_vgg}", f"inception_weights={absent}"]
    runs = {
        "compute_metrics": (compute_metrics.main, [
            "--gt-dir", str(root / "gt"), "--method", method, "--output",
            str(root / "metrics.json"), "--lpips-weights", str(w_vgg),
            "--inception-weights", str(w_inc)], None),
        "compute_metrics_vaefeat": (compute_metrics.main, [
            "--gt-dir", str(root / "gt"), "--method", method, "--output",
            str(root / "metrics_vaefeat.json"), "--lpips-weights", str(absent),
            "--allow-init-vae"], [8] * 4),  # a scene's 8 targets and 8 renders, 2 scenes
        "compute_metrics_hydra": (compute_metrics.main, hydra + [
            f"output_metrics_path={root / 'hydra_metrics.json'}",
            f"per_scene_metrics_path={root / 'hydra_per_scene.json'}"], None),
        "compute_fid": (compute_fid.main, [
            "--dir-a", str(video), "--dir-b", str(root / "gt_images"), "--output",
            str(root / "fid.json"), "--inception-weights", str(w_inc)], None),
        "compute_fid_hydra": (compute_fid.main, hydra + [
            f"output_fid_path={root / 'hydra_fid.json'}"], None),
        "compute_fid_vaefeat": (compute_fid.main, [
            "--dir-a", str(video), "--dir-b", str(root / "gt_images"), "--output",
            str(root / "fid_vaefeat.json"), "--lpips-weights", str(absent),
            "--inception-weights", str(absent), "--allow-init-vae"], [16, 4, 16]),
    }
    f32_total = dict.fromkeys((k.__name__ for k in f32_kernels), 0)
    for name, (fn, argv, encodes) in runs.items():
        r = run_counted(kernels, f32_kernels, fn, argv)
        plan = vae_encode_f32_plan(encodes or [])
        r["expected_f32_launches"] = plan
        rec[name] = r
        if any(r["launches"].values()) or r["f32_launches"] != plan:
            fail(f"eval {name}: bf16 {r['launches']}, f32 {r['f32_launches']} (plan {plan})")
        for k, v in r["f32_launches"].items():
            f32_total[k] += v
    out = {k: json.loads((root / f).read_text()) for k, f in (
        ("metrics", "metrics.json"), ("metrics_vaefeat", "metrics_vaefeat.json"),
        ("hydra_metrics", "hydra_metrics.json"), ("hydra_per_scene", "hydra_per_scene.json"),
        ("fid", "fid.json"), ("hydra_fid", "hydra_fid.json"),
        ("fid_vaefeat", "fid_vaefeat.json"))}
    keys = {k: sorted(v["a"]) if "a" in v else sorted(v) for k, v in out.items()}
    want_keys = {
        "metrics": ["dists", "lpips", "num_scenes", "psnr", "ssim"],
        "metrics_vaefeat": ["lpips_vaefeat_randominit", "num_scenes", "psnr", "ssim"],
        "hydra_metrics": ["dists", "fid_vgg", "lpips", "num_scenes", "psnr", "ssim"],
        "hydra_per_scene": ["dists", "fid_vgg", "lpips", "psnr", "ssim"],
        "fid": ["extractor", "fid", "kid", "num_a", "num_b"],
        "hydra_fid": ["fid_vgg_a", "kid_vgg_a"],
        "fid_vaefeat": ["extractor", "fid", "kid", "num_a", "num_b"],
    }
    if keys != want_keys or sorted(out["hydra_per_scene"]["psnr"]) != scenes \
            or out["fid"]["extractor"] != "inception" or out["metrics"]["a"]["num_scenes"] != 2:
        fail(f"eval: JSON keys {keys}")

    # The port's CPU run on the same images.
    t0 = time.perf_counter()
    cfg = EvaluationCfg(methods=[MethodCfg("a", "a", video)])
    cpu = MetricComputer(cfg, root / "gt", w_vgg, inception_weights=w_inc).compute()["a"]
    vae_cpu, _ = resolve_vae_params(allow_init_vae=True)
    cpu_vae = MetricComputer(cfg, root / "gt", absent, vae=vae_cpu,
                             vae_feature_key="vaefeat_randominit").compute()["a"]
    gts = np.stack([load_image(p) for p in sorted((root / "gt_images").glob("*.png"))])
    vae_card, _ = resolve_vae_params(allow_init_vae=True, device="cuda")
    features = {}
    for name, card_fn, cpu_fn in (
            ("inception", inception_feature_extractor(w_inc, "cuda"),
             inception_feature_extractor(w_inc)),
            ("vgg", vgg_feature_extractor(w_vgg, "cuda"), vgg_feature_extractor(w_vgg)),
            ("vaefeat", vae_feature_extractor(vae_card), vae_feature_extractor(vae_cpu))):
        features[name] = _rel_l2(card_fn(gts), cpu_fn(gts))
    cpu_s = time.perf_counter() - t0
    card_metrics = {**out["metrics"]["a"], **out["metrics_vaefeat"]["a"]}
    host = {**cpu, **cpu_vae}
    errs = {k: _rel(card_metrics[k], host[k]) for k in
            ("psnr", "ssim", "lpips", "dists", "lpips_vaefeat_randominit")}
    emit(phase="eval", what="the evaluation CLIs on the card over cli run (a)'s 2 x 8 frames "
         "(256 px) against generate_gt's trees, seeded synthetic LPIPS/DISTS VGG and "
         "Inception weights in the real layouts, the port's seed-0 VAE (--allow-init-vae, "
         "f32, TF32 off); wall time of each call", runs=rec, results=out,
         card_vs_cpu_rel=errs, feature_rel_l2_card_vs_cpu=features, cpu_check_s=cpu_s,
         scipy=__import__("scipy").__version__,
         bounds={"psnr_ssim_rel": EVAL_PSNR_SSIM_REL, "feature_rel": EVAL_FEATURE_REL},
         card=card)
    if not (errs["psnr"] <= EVAL_PSNR_SSIM_REL and errs["ssim"] <= EVAL_PSNR_SSIM_REL
            and all(errs[k] <= EVAL_FEATURE_REL for k in ("lpips", "dists",
                                                          "lpips_vaefeat_randominit"))
            and all(v <= EVAL_FEATURE_REL for v in features.values())):
        fail(f"eval: card against host {errs}, features {features}")
    if not all(np.isfinite(v) for d in out.values() for v in d.values() if isinstance(v, float)):
        fail(f"eval: non-finite results {out}")
    return f32_total


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


def fused_adamw_phase(card: str, masters: dict) -> tuple:
    """The optimizer's fused kernels (ops/fused_adamw.py) on ``masters``,
    the baseline UNet's f32 masters, at the baseline's optimizer (built
    from ``+experiment=baseline`` as ``scripts.main`` builds it: AdamW with
    f32 moments, clip 0.1, accumulation 2), with seeded bf16 gradients: two
    accumulation cycles, the first clipped (gradient norm ~0.2), the second
    not (~0.02). The fused route and the foreach chain run from the same
    masters and gradients; after every micro-step masters, moments and
    accumulators must be equal bit for bit, and the fused route must have
    launched 1 accumulate a micro-step and 1 update an applying one (the
    counters zeroed just before the run). Then each kernel's device time
    (CUDA graph replay) against the bound of its bytes at the HBM rate, and
    each route's whole ``apply`` between CUDA events. Returns each kernel's
    record and its launches."""
    from mvldm_tpu_torch.config import compose, load_typed_root_config
    from mvldm_tpu_torch.ops import fused_adamw
    from mvldm_tpu_torch.scripts.main import base_lr
    from mvldm_tpu_torch.training import build_lr_schedule, build_optimizer, optim
    from mvldm_tpu_torch.training.optim import global_norm_tensor

    cfg = load_typed_root_config(compose(["+experiment=baseline"]))
    routes = ("fused", "foreach")
    schedule = build_lr_schedule(base_lr(cfg), cfg.optimizer.scheduler)
    tx = {r: build_optimizer(cfg.optimizer, schedule,
                             gradient_clip_val=cfg.trainer.gradient_clip_val,
                             accumulate_grad_batches=cfg.trainer.accumulate_grad_batches)
          for r in routes}
    tx["foreach"].fused_step = lambda *args: None  # the chain, as off the fused route
    params = {r: {k: p.clone() for k, p in masters.items()} for r in routes}
    state = {r: tx[r].init(params[r]) for r in routes}
    n_params = sum(p.numel() for p in masters.values())
    gen = torch.Generator("cuda").manual_seed(17)
    launches, mismatched, norms, apply_ms = [], [], [], {r: [] for r in routes}
    accumulate, update = fused_adamw.accumulate, fused_adamw.update

    def recorded_norm(tensors):  # the clip's norm on the fused route, kept to read after
        norms.append(global_norm_tensor(tensors))
        return norms[-1]

    accumulate.launches = update.launches = 0
    for micro in range(4):
        scale = 1e-5 if micro < 2 else 1e-6
        grads = {k: torch.randn(p.shape, generator=gen, device="cuda", dtype=torch.bfloat16)
                 .mul_(scale) for k, p in masters.items()}
        for r in routes:
            if r == "fused":
                before = (accumulate.launches, update.launches)
                if tx[r].fused_step(params[r], grads, state[r]) is None:
                    fail("fused_adamw: the baseline optimizer's state is off the fused route")
                optim.global_norm_tensor = recorded_norm
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                applied = tx[r].apply(params[r], grads, state[r])
            finally:
                optim.global_norm_tensor = global_norm_tensor
            end.record()
            torch.cuda.synchronize()
            apply_ms[r].append(start.elapsed_time(end))
            if r == "fused":
                launches.append((accumulate.launches - before[0], update.launches - before[1]))
        differ = torch.zeros((), dtype=torch.int64, device="cuda")
        for key in ("params", "mu", "nu", "acc"):
            a = params["fused"] if key == "params" else state["fused"][key]
            b = params["foreach"] if key == "params" else state["foreach"][key]
            for k in masters:
                differ += (a[k].view(torch.int32) != b[k].view(torch.int32)).sum()
        mismatched.append(int(differ))
        if applied != bool(micro % 2):
            fail(f"fused_adamw: micro-step {micro} applied {applied}")
    total = (accumulate.launches, update.launches)
    norms = [float(n) for n in norms]

    # Device time of each kernel on the fused state (its values no longer matter).
    step = tx["fused"].fused_step(params["fused"], grads, state["fused"])
    hyper = tx["fused"].hyper(state["fused"]["count"], torch.float32)
    norm = global_norm_tensor(list(state["fused"]["acc"].values()))
    timed = {"accumulate_first": (lambda: accumulate(step, 0), 6),
             "accumulate": (lambda: accumulate(step, 1), 10),
             "update": (lambda: update(step, hyper, norm), 32)}
    ms = {name: time_ms(fn) for name, (fn, _) in timed.items()}
    bounds = {name: bound(0.0, per * n_params) for name, (_, per) in timed.items()}
    shape = f"{len(masters)} tensors, {n_params} f32 parameters, bf16 gradients"
    emit(phase="fused_adamw", what="the baseline optimizer (AdamW, f32 moments, clip 0.1, "
         "accumulation 2) on the trained masters with seeded bf16 gradients, 2 cycles: the "
         "fused route against the foreach chain after every micro-step; launches (accumulate, "
         "update) a micro-step; each kernel's device time (CUDA graph replay) and the bound "
         "of its bytes (6 / 10 / 32 a parameter); each route's whole apply (CUDA events)",
         shape=shape, launches_per_micro_step=launches, launches=total,
         mismatched_elements=mismatched, clip_norms=norms, clip=tx["fused"].clip,
         ms=ms, bound_ms={k: b[0] for k, b in bounds.items()},
         bound_share={k: bounds[k][0] / ms[k] for k in ms}, apply_ms=apply_ms, card=card)
    if any(mismatched):
        fail(f"fused_adamw: the fused route differs from the foreach chain: {mismatched}")
    if launches != [(1, 0), (1, 1), (1, 0), (1, 1)]:
        fail(f"fused_adamw: launches (accumulate, update) a micro-step {launches}")
    if len(norms) != 2 or not norms[0] >= tx["fused"].clip > norms[1]:
        fail(f"fused_adamw: clip norms {norms}, not one clipped and one not")
    # plain_ms: the chain's whole apply in the second cycle (the first warms the allocator).
    common = dict(max_abs_err=0.0, library_ms=None, timed_shape=shape, bound_by="bytes")
    results = {
        "fused_adamw_accumulate": dict(
            common, ms=ms["accumulate"], ms_first=ms["accumulate_first"],
            bound_ms=bounds["accumulate"][0], bound_ms_first=bounds["accumulate_first"][0],
            plain_ms=apply_ms["foreach"][2]),
        "fused_adamw_update": dict(
            common, ms=ms["update"], bound_ms=bounds["update"][0],
            plain_ms=apply_ms["foreach"][3]),
    }
    return results, dict(zip(OPTIM_KERNELS, total))


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


# ------------------------------------------------------- multi-rank (cli_parallel)

PARALLEL_STRATEGIES = ("data_parallel", "data_parallel_zero1", "data_parallel_fsdp",
                       "data_model")
# (o): two baseline steps at batch 6 (one update: accumulation 2), no hook.
PARALLEL_CLI_LAUNCHES = _plan(2, _TRAIN_STEP, 0)
# (o) at world 1 against the run with no process group, on the same seeded
# data stream. Every collective of a world of one is an identity, so the
# loss (a forward on the same weights, data and draws) must agree to
# WORLD1_LOSS_REL (0 expected). The backward may not repeat itself bit for
# bit (cuDNN picks weight-gradient algorithms that accumulate in no fixed
# order), so the gradient norm is held to WORLD1_NORM_REL and the moments
# to WORLD1_MOMENT_REL relative L2: a collective that counted a leaf twice
# or dropped it reads O(1). The masters move by ~1e-8 at step 1's LinearLR
# factor (5e-4 of 2e-5), so they are held to one f32 ulp of an O(1) weight.
WORLD1_LOSS_REL = 1e-6
WORLD1_NORM_REL = 1e-3
WORLD1_MOMENT_REL = 1e-2
WORLD1_MASTER_ABS = 1.2e-7
# (p): the time limit of a two-rank run, and the rank processes' command.
RANK_TIMEOUT_S = 600


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _tree_diff(got: dict, want: dict) -> dict:
    """Bitwise equality, relative L2 and largest absolute difference of two
    dicts of tensors."""
    num = den = 0.0
    worst, bitwise = 0.0, True
    for k, w in want.items():
        g, w = got[k].to("cuda"), w.to("cuda")  # one leaf at a time on the card
        bitwise = bitwise and torch.equal(g, w)
        g, w = g.float(), w.float()
        num += (g - w).square().sum().item()
        den += w.square().sum().item()
        worst = max(worst, (g - w).abs().max().item())
    return {"bitwise": bitwise, "rel_l2": (num / den) ** 0.5 if den else num ** 0.5,
            "max_abs": worst}


def parallel_world1_runs(card: str, data, runs_dir, kernels, f32_kernels) -> dict:
    """(o) ``scripts.main mode=train +experiment=baseline`` (batch 6,
    accumulation 2), 2 steps, with no process group, then under each
    strategy with the env triplet at world 1 over NCCL (``data_model`` with
    ``trainer.num_model=1``): the logged loss and grad norm and the saved
    masters, EMA and moments against the run without one (the WORLD1_*
    bounds), launches equal to PARALLEL_CLI_LAUNCHES. The train stream is
    seeded (``data_loader.train.seed=0``) so that every run reads the same
    batches."""
    import shutil

    from mvldm_tpu_torch.scripts import main as main_script

    common = ["+experiment=baseline", "mode=train", f"dataset.root={data}",
              "trainer.max_steps=2", "data_loader.train.seed=0"]
    ref_dir = runs_dir / "single"
    r = run_counted(kernels, f32_kernels, main_script.main, common + [f"output_dir={ref_dir}"])
    ref_log = json.loads((ref_dir / "metrics.jsonl").read_text().splitlines()[-1])
    ref = saved_state(ref_dir, 2)
    emit(phase="cli_parallel", run="o_no_process_group", **r,
         expected_launches=PARALLEL_CLI_LAUNCHES, loss=ref_log["loss/diffusion"],
         grad_norm=ref_log["grad_norm"], card=card)
    by_run = {"o_no_process_group": r["launches"]}
    for name in PARALLEL_STRATEGIES:
        out = runs_dir / name
        env = {"MVLDM_COORDINATOR": f"localhost:{_free_port()}", "MVLDM_NUM_PROCESSES": "1",
               "MVLDM_PROCESS_ID": "0"}
        os.environ.update(env)
        try:
            r = run_counted(kernels, f32_kernels, main_script.main,
                            common + [f"output_dir={out}", f"trainer.strategy={name}",
                                      "trainer.num_model=1"])
        finally:
            for k in env:
                os.environ.pop(k)
        log = json.loads((out / "metrics.jsonl").read_text().splitlines()[-1])
        state = saved_state(out, 2)
        diffs = {key: _tree_diff(state[key], ref[key]) for key in ("params", "ema_params")
                 if ref[key] is not None}
        diffs.update({m: _tree_diff(state["opt_state"][m], ref["opt_state"][m])
                      for m in ("mu", "nu")})
        loss_rel = abs(log["loss/diffusion"] - ref_log["loss/diffusion"]) / abs(
            ref_log["loss/diffusion"])
        norm_rel = abs(log["grad_norm"] - ref_log["grad_norm"]) / ref_log["grad_norm"]
        emit(phase="cli_parallel", run=f"o_{name}", argv=" ".join(common + [
            f"trainer.strategy={name}"]), what="scripts.main.main under the env triplet at "
             "world 1 (NCCL), wall time of the call", **r,
             expected_launches=PARALLEL_CLI_LAUNCHES, nccl_version=list(torch.cuda.nccl.version()),
             loss=log["loss/diffusion"], loss_rel=loss_rel, grad_norm_rel=norm_rel,
             vs_no_process_group=diffs, bounds={"loss_rel": WORLD1_LOSS_REL,
                                                "grad_norm_rel": WORLD1_NORM_REL,
                                                "moment_rel_l2": WORLD1_MOMENT_REL,
                                                "master_abs": WORLD1_MASTER_ABS}, card=card)
        shutil.rmtree(out)
        if r["launches"] != PARALLEL_CLI_LAUNCHES or any(r["f32_launches"].values()):
            fail(f"cli_parallel {name}: launched {r['launches']} (plan "
                 f"{PARALLEL_CLI_LAUNCHES}), f32 {r['f32_launches']}")
        masters_off = max(d["max_abs"] for k, d in diffs.items() if k.endswith("params"))
        if not (loss_rel <= WORLD1_LOSS_REL and norm_rel <= WORLD1_NORM_REL
                and diffs["mu"]["rel_l2"] <= WORLD1_MOMENT_REL
                and diffs["nu"]["rel_l2"] <= WORLD1_MOMENT_REL
                and masters_off <= WORLD1_MASTER_ABS):
            fail(f"cli_parallel {name}: against the run without a process group: loss "
                 f"{loss_rel:.3g}, grad norm {norm_rel:.3g}, {diffs}")
        by_run[f"o_{name}"] = r["launches"]
    shutil.rmtree(ref_dir)
    return by_run


def launch_ranks(job: dict, tag: str, world: int = 2) -> list:
    """``python3 chip_smoke.py --rank-job <job>`` on ``world`` ranks that
    share the card over gloo (NCCL refuses two ranks on one device), killed
    after RANK_TIMEOUT_S; returns each rank's result dict and output."""
    import subprocess
    from pathlib import Path

    root = Path(__file__).resolve().parent / "build" / "cli_parallel" / tag
    root.mkdir(parents=True, exist_ok=True)
    (root / "job.json").write_text(json.dumps(dict(job, out=str(root))))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    port = _free_port()
    procs = []
    try:
        for r in range(world):
            env = dict(os.environ, MVLDM_COORDINATOR=f"localhost:{port}",
                       MVLDM_NUM_PROCESSES=str(world), MVLDM_PROCESS_ID=str(r),
                       MVLDM_BACKEND="gloo")
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--rank-job",
                 str(root / "job.json")], env=env, cwd=Path(__file__).resolve().parent,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        deadline = time.monotonic() + RANK_TIMEOUT_S
        logs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0] for p in procs]
    except subprocess.TimeoutExpired:
        fail(f"{tag}: the ranks did not end within {RANK_TIMEOUT_S} s")
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            fail(f"{tag}: rank {r} exited {p.returncode}:\n{log[-6000:]}")
    return [dict(json.loads((root / f"rank{r}.json").read_text()), log=logs[r])
            for r in range(world)]


def _counted_kernels():
    from mvldm_tpu_torch.ops.attention import (
        flash_attention,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
    )
    from mvldm_tpu_torch.ops.f32_route import KERNELS as F32_KERNELS
    from mvldm_tpu_torch.ops.fused_attn import fused_ln_self_attention
    from mvldm_tpu_torch.ops.fused_ff import fused_ln_geglu_ff

    return (flash_attention, fused_ln_self_attention, fused_ln_geglu_ff,
            flash_attention_bwd_dq, flash_attention_bwd_dkv), tuple(F32_KERNELS)


def rank_step_job(job: dict, rank: int) -> dict:
    """One flagship training step (bf16, seeded weights, the baseline AdamW)
    under ``job["strategy"]`` on this rank's ``job["batch"]`` examples of
    ``make_train_batch``, with the draws of its data rank's generator
    (``step_seed(0, 0, data_rank)``). Rank 0 first runs the same loss and
    backward on one card over every data rank's examples and draws, then
    holds the strategy's loss and global gradient against it."""
    from mvldm_tpu_torch.builder import build_flagship_train, make_train_batch
    from mvldm_tpu_torch.diffusion.engine import Batch, TrainDraws
    from mvldm_tpu_torch.parallel.mesh import make_mesh
    from mvldm_tpu_torch.training import (
        LRSchedulerCfg,
        OptimizerCfg,
        build_lr_schedule,
        build_optimizer,
    )
    from mvldm_tpu_torch.training.strategy import Strategy, step_seed
    from mvldm_tpu_torch.training.trainer import TrainState, make_train_step, master_params

    kernels, f32_kernels = _counted_kernels()
    engine = build_flagship_train("cuda")
    mesh = make_mesh(num_model=job["num_model"])
    b, nd = job["batch"], mesh.num_data
    full = make_train_batch(b * nd)
    draws = [TrainDraws.draw(b, 5, 2, (32, 32, 4), 1000,
                             torch.Generator().manual_seed(step_seed(0, 0, d)))
             for d in range(nd)]
    out = {}
    if rank == 0:
        cat = TrainDraws(**{f: torch.cat([getattr(d, f) for d in draws])
                            for f in TrainDraws.__dataclass_fields__})
        loss, _ = engine.training_loss(full, 2, cat)
        loss.backward()
        ref = {n: (p.grad.float() if p.grad is not None else torch.zeros(p.shape, device="cuda"))
               for n, p in engine.unet.named_parameters()}
        out["one_card_loss"] = loss.item()
        for p in engine.unet.parameters():
            p.grad = None
        del loss
    tx = build_optimizer(
        OptimizerCfg("AdamW", 2e-5, {"mu_dtype": "bfloat16"}),
        build_lr_schedule(2e-5, LRSchedulerCfg("LinearLR", {"start_factor": 5e-4,
                                                            "total_iters": 200})),
        gradient_clip_val=0.1)
    strategy = Strategy(job["strategy"], mesh, engine.unet, tx)
    params = strategy.store(master_params(engine.unet))
    state = TrainState(params=params, opt_state=tx.init(strategy.optimizer_params(params)),
                       ema_params=None, step=0)
    seen = {}
    apply = tx.apply

    def recording_apply(params_, grads, opt_state, noise=None, **callbacks):
        if rank == 0:
            whole = strategy.whole(grads, sliced=True)
            num = sum((whole[n] - ref[n]).square().sum().item() for n in ref)
            den = sum(ref[n].square().sum().item() for n in ref)
            seen["grad_rel_l2"] = (num / den) ** 0.5
            seen["finite"] = all(bool(torch.isfinite(g).all()) for g in whole.values())
        else:
            strategy.whole(grads, sliced=True)  # the gather is collective
        return apply(params_, grads, opt_state, noise, **callbacks)

    tx.apply = recording_apply
    step = make_train_step(engine, tx, 2, strategy=strategy)
    rows = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
    batch = Batch(**{f: getattr(full, f)[rows] if getattr(full, f) is not None else None
                     for f in ("images", "extrinsics", "intrinsics", "is_target",
                               "latent_moments")})
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    for k in kernels + f32_kernels:
        k.launches = 0
    t0 = time.perf_counter()
    state, metrics = step(state, batch, draws[mesh.data_rank])
    torch.cuda.synchronize()
    out.update(wall_s=time.perf_counter() - t0, held_before_gb=held,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches=_counts(kernels), f32_launches=_counts(f32_kernels),
               loss=float(metrics["loss/diffusion"]), grad_norm=float(metrics["grad_norm"]),
               sliced_leaves=len(strategy.sliced), **seen)
    return out


def rank_cli_job(job: dict, rank: int) -> dict:
    """``scripts.main.main(job["argv"])`` in this rank's process group, with
    the kernels' launches."""
    from mvldm_tpu_torch.scripts import main as main_script

    kernels, f32_kernels = _counted_kernels()
    for k in kernels + f32_kernels:
        k.launches = 0
    t0 = time.perf_counter()
    main_script.main(job["argv"])
    torch.cuda.synchronize()
    return {"wall_s": time.perf_counter() - t0, "launches": _counts(kernels),
            "f32_launches": _counts(f32_kernels),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30}


def rank_job_main(path: str) -> int:
    """The entry of one rank of :func:`launch_ranks`: the process group from
    the env triplet (gloo, CUDA tensors), one job, its result JSON."""
    from pathlib import Path

    from mvldm_tpu_torch.parallel.distributed import (
        maybe_initialize_distributed,
        shutdown_distributed,
    )

    job = json.loads(Path(path).read_text())
    rank = int(os.environ["MVLDM_PROCESS_ID"])
    if job["kind"] == "cli":  # main() starts and ends the process group itself
        out = rank_cli_job(job, rank)
    else:
        maybe_initialize_distributed(device="cuda")
        try:
            out = rank_step_job(job, rank)
        finally:
            shutdown_distributed()
    out["backend"] = os.environ.get("MVLDM_BACKEND")
    (Path(job["out"]) / f"rank{rank}.json").write_text(json.dumps(out))
    return 0


def parallel_two_rank_steps(card: str) -> dict:
    """(p) two ranks sharing the card over gloo (CUDA tensors): a
    ``data_parallel`` step at batch 2 a rank, and a ``data_model`` step with
    ``num_model=2`` (the flash kernels on 4 of 8 heads, the per-frame blocks
    on half the frames) at batch 2; rank 0 holds each step's loss and global
    gradient against one card's on the same examples and draws
    (TRAIN_LOSS_REL_BOUND, TRAIN_GRAD_REL_L2_BOUND), and every kernel of a
    training step must launch on each rank."""
    by_run = {}
    for name, nm in (("data_parallel", 1), ("data_model", 2)):
        ranks = launch_ranks(dict(kind="step", strategy=name, num_model=nm, batch=2),
                             f"p_{name}")
        r0 = ranks[0]
        loss_rel = abs(r0["loss"] - r0["one_card_loss"]) / abs(r0["one_card_loss"])
        for r, res in enumerate(ranks):
            emit(phase="cli_parallel", run=f"p_{name}", rank=r,
                 what="one flagship training step (bf16) on 2 ranks sharing the card over "
                 "gloo with CUDA tensors, batch 2 a rank", **{k: v for k, v in res.items()
                                                             if k != "log"}, card=card)
        if not (loss_rel <= TRAIN_LOSS_REL_BOUND and r0["finite"]
                and r0["grad_rel_l2"] <= TRAIN_GRAD_REL_L2_BOUND):
            fail(f"p_{name}: loss rel {loss_rel:.4g}, grad rel L2 {r0['grad_rel_l2']:.4g} "
                 "against one card")
        for r, res in enumerate(ranks):
            idle = [k for k in TRAIN_KERNELS if res["launches"][k] == 0]
            if idle or any(res["f32_launches"].values()):
                fail(f"p_{name} rank {r}: kernels not launched {idle}, f32 "
                     f"{res['f32_launches']}")
        emit(phase="cli_parallel", run=f"p_{name}", loss_rel=loss_rel,
             grad_rel_l2=r0["grad_rel_l2"], loss_bound=TRAIN_LOSS_REL_BOUND,
             grad_bound=TRAIN_GRAD_REL_L2_BOUND, card=card)
        by_run[f"p_{name}"] = {k: sum(res["launches"][k] for res in ranks)
                               for k in TRAIN_KERNELS}
    return by_run


def write_striped_test_stage(root) -> list:
    """A synthetic RE10K test stage of two chunks, one scene of TRAIN_FRAMES
    frames each (the loader stripes the test stage by chunk; the baseline's
    test sampler needs that many frames between the context views)."""
    from mvldm_tpu_torch.data.chunk_reader import save_chunk

    stage = root / "test"
    stage.mkdir(parents=True)
    keys = [f"scenetest{s:04d}" for s in range(2)]
    frames = [make_frame(i) for i in range(TRAIN_FRAMES + 100)]
    for s, key in enumerate(keys):
        save_chunk([{"key": key, "cameras": make_cameras(TRAIN_FRAMES),
                     "images": frames[100 * s:100 * s + TRAIN_FRAMES]}],
                   stage / f"{s:06d}.torch")
    (stage / "index.json").write_text(json.dumps({k: f"{s:06d}.torch"
                                                  for s, k in enumerate(keys)}))
    return keys


def parallel_test_mode(card: str) -> dict:
    """(q) ``scripts.main mode=test +experiment=baseline`` (anchored, 4
    frames a scene) on two ranks sharing the card over gloo: each rank
    samples its stripe, the ranks' scenes are disjoint and together every
    scene of the stage, each directory holds its frames and exports."""
    import shutil
    from pathlib import Path

    root = Path(__file__).resolve().parent / "build" / "cli_parallel" / "q_data"
    shutil.rmtree(root, ignore_errors=True)
    keys = write_striped_test_stage(root / "data")
    out = root / "out"
    argv = ["+experiment=baseline", "mode=test", f"dataset.root={root / 'data'}",
            f"output_dir={out}", "test.sampling_mode=anchored", "test.limit_frames=4",
            "trainer.limit_test_batches=null"]
    ranks = launch_ranks(dict(kind="cli", argv=argv), "q_test")
    sampled = [sorted(line.split()[2].rstrip(";") for line in res["log"].splitlines()
                      if line.startswith("scene = ")) for res in ranks]
    on_disk = sorted(p.name for p in (out / "video").iterdir())
    for r, res in enumerate(ranks):
        emit(phase="cli_parallel", run="q_test", rank=r, argv=" ".join(argv), scenes=sampled[r],
             **{k: v for k, v in res.items() if k != "log"}, card=card)
    flat = sum(sampled, [])
    if sorted(flat) != sorted(keys) or len(set(flat)) != len(flat) or on_disk != sorted(keys):
        fail(f"q_test: ranks sampled {sampled}, directories {on_disk}, stage {keys}")
    for scene in on_disk:
        d = out / "video" / scene
        colors = sorted(x.name for x in (d / "color").glob("*.png"))
        exports = [n for n in ("sampled.gif", "sampled_fps_25.mp4", "sampled_fps_10.mp4")
                   if (d / n).is_file()]
        if len(colors) != 4 or len(exports) != 3:
            fail(f"q_test {scene}: color/ {colors}, exports {exports}")
    shutil.rmtree(root)
    return {"q_test": {k: sum(res["launches"][k] for res in ranks) for k in TRAIN_KERNELS}}


def tools_phase(card: str, kernels, f32_kernels) -> dict:
    """(r) ``utils.ckpt_manifest``'s census of the baseline equal to the
    committed manifest; ``scripts.verify_parity`` smoke at
    ``+experiment=baseline`` (f32, TF32 off, 25 DDIM steps, 2 context + 3
    target views at 256 px) writes a finite fixture, and fixture mode on it
    passes. Returns the f32 launches of the two runs."""
    import shutil
    from pathlib import Path

    import numpy as np

    from mvldm_tpu_torch.scripts import verify_parity
    from mvldm_tpu_torch.utils import ckpt_manifest

    repo = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    census = ckpt_manifest.generate_manifest()
    committed = json.loads((repo / ckpt_manifest.DEFAULT_MANIFEST).read_text())
    same = json.loads(json.dumps(census)) == committed
    emit(phase="cli_parallel", run="r_ckpt_manifest", seconds=time.perf_counter() - t0,
         required=len(census["required"]), ignored=len(census["ignored"]),
         equals_committed=same, card=card)
    if not same:
        fail("ckpt_manifest: the census differs from assets/mvldm_1.0_manifest.json")
    out = repo / "build" / "cli_parallel" / "r_parity"
    shutil.rmtree(out, ignore_errors=True)
    smoke = run_counted(kernels, f32_kernels, verify_parity.main, [f"out={out}"])
    fx = np.load(out / "torch_fixture.npz")
    finite = all(np.isfinite(fx[k]).all() for k in fx.files)
    reports = []
    fixture = run_counted(kernels, f32_kernels,
                          lambda argv: reports.append(verify_parity.main(argv)),
                          [f"out={out}", f"fixtures={out / 'torch_fixture.npz'}"])
    report = reports[0]
    emit(phase="cli_parallel", run="r_verify_parity", smoke=smoke, fixture=fixture,
         finite=bool(finite), shapes={k: list(fx[k].shape) for k in fx.files},
         worst_rel_max=report["worst_rel_max"], passed=report["pass"], card=card)
    shutil.rmtree(out)
    if not finite or not report["pass"]:
        fail(f"verify_parity: finite {finite}, report {report}")
    if any(smoke["launches"].values()) or any(fixture["launches"].values()):
        fail("verify_parity: bf16 kernels launched in the f32 harness")
    return {k: smoke["f32_launches"][k] + fixture["f32_launches"][k]
            for k in smoke["f32_launches"]}


def cli_parallel_phase(card: str, kernels, f32_kernels):
    """(o)-(r): see :func:`parallel_world1_runs`, :func:`parallel_two_rank_steps`,
    :func:`parallel_test_mode` and :func:`tools_phase`. Returns the bf16
    launches of each run (the ranks' summed) and the f32 launches of (r)."""
    import shutil
    from pathlib import Path

    root = Path(__file__).resolve().parent / "build" / "cli_train_smoke"
    runs = root / "parallel_runs"
    shutil.rmtree(runs, ignore_errors=True)
    t0 = time.perf_counter()
    by_run = parallel_world1_runs(card, root / "data", runs, kernels, f32_kernels)
    by_run.update(parallel_two_rank_steps(card))
    by_run.update(parallel_test_mode(card))
    f32 = tools_phase(card, kernels, f32_kernels)
    emit(phase="cli_parallel", run="total", seconds=time.perf_counter() - t0, card=card)
    return by_run, f32


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    from mvldm_tpu_torch.builder import build_flagship_train
    from mvldm_tpu_torch.ops import _build, fused_adamw
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
    scene_batch_checks(card, engine)
    del engine
    torch.cuda.empty_cache()
    t2mv_launches = t2mv_phase(card, forward, F32_KERNELS)
    torch.cuda.empty_cache()
    cli_launches = cli_phase(card, forward, F32_KERNELS)
    ddpm_step_check(card)
    standard_unet_parity(card, unet_inputs)
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
    masters = state.params
    del engine, state, step, batch, train_gen
    torch.cuda.empty_cache()
    optim_results, optim_launches = fused_adamw_phase(card, masters)
    del masters
    torch.cuda.empty_cache()
    training = forward + backward + (fused_adamw.accumulate, fused_adamw.update)
    cli_train_launches = cli_train_phase(card, training, F32_KERNELS)
    variant_launches, precompute_f32 = cli_variants_phase(card, training, F32_KERNELS)
    eval_f32 = eval_phase(card, forward + backward, F32_KERNELS)
    parallel_launches, parity_f32 = cli_parallel_phase(card, training, F32_KERNELS)

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
    def bf16_paths(name: str) -> dict:
        return {"sampling": sampling_launches.get(name, 0), "training": train_launches[name],
                "t2mv": t2mv_launches.get(name, 0),
                **{f"cli_{run}": counts.get(name, 0) for run, counts in cli_launches.items()},
                **{f"cli_{run}": counts[name] for run, counts in cli_train_launches.items()},
                **{f"cli_{run}": counts[name] for run, counts in variant_launches.items()},
                **{f"cli_parallel_{run}": counts.get(name, 0)
                   for run, counts in parallel_launches.items()}}

    def optim_paths(name: str) -> dict:
        return {"fused_adamw": optim_launches[name],
                **{f"cli_{run}": counts[name] for run, counts in cli_train_launches.items()},
                **{f"cli_{run}": counts[name] for run, counts in variant_launches.items()},
                **{f"cli_parallel_{run}": counts.get(name, 0)
                   for run, counts in parallel_launches.items()}}

    def f32_paths(name: str) -> dict:
        return {"f32_forward": f32_forward_launches[name],
                "f32_train_step": f32_step_launches[name],
                "precompute_latents": precompute_f32[name], "eval": eval_f32[name],
                "verify_parity": parity_f32[name]}

    emit(kernels=[
        dict(name=name, route="cuda", source=meta[name][0], replaces=meta[name][1],
             launches=sum(bf16_paths(name).values()), launches_by_path=bf16_paths(name),
             max_abs_err=r["max_abs_err"], ms=r["ms"],
             plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
             library_ms=r["library_ms"], timed_shape=r["shape"])
        for name, r in results.items()
    ] + [
        dict(name=name, route="cuda",
             source="mvldm_tpu_torch/csrc/f32_route.cu" + (
                 " (+ f32_gemm_tile.cuh)" if name != "attention_rows_f32" else ""),
             replaces=f32_meta[name],
             launches=sum(f32_paths(name).values()), launches_by_path=f32_paths(name),
             max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
             bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
             timed_shape=r["shape"])
        for name, r in f32_results.items()
    ] + [
        dict(name=name, route="cuda", source="mvldm_tpu_torch/csrc/fused_adamw.cu",
             replaces=("none: the optax chain of mvldm_tpu/training/optim.py, which XLA "
                       "fuses (plain_ms: the foreach chain's whole apply of that micro-step)"),
             launches=sum(optim_paths(name).values()), launches_by_path=optim_paths(name), **r)
        for name, r in optim_results.items()
    ] + [micro_kernel_record(name, r, micro_launches[name])
         for name, r in micro_records.items()])
    emit(phase="total", seconds=time.perf_counter() - t_start, card=card)
    print(card, flush=True)
    emit(ok=True, device={"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-job"]:
        sys.exit(rank_job_main(sys.argv[2]))
    sys.exit(main())
