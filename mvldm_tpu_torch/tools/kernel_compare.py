"""Time this tree's build of one kernel source against another checkout's,
in turns, on one NVIDIA GPU.

    python -m mvldm_tpu_torch.tools.kernel_compare --other DIR
        [--kernel bwd|fwd|gemm|micro|f32bwd|f32fwd|f32gemm|exp] [--rounds N]
        [--only TEXT]

DIR is another checkout of this repository, for example the parent commit
unpacked with ``git archive`` into an ignored directory such as
``build/parent``. The sources of the chosen kernel are built from DIR's
``mvldm_tpu_torch/csrc/`` with this tree's nvcc flags into
``build/compare/``; the two builds share the C interface, so one launch
helper drives both. At every shape the two run on the same inputs, each is
checked against the plain version (own error past half a bf16 step, over
the rms of what it computes, as ``chip_smoke.py`` does), then both are timed
in turns (this, other, other, this, ``--rounds`` times, by CUDA-graph
replay). One JSON line per shape and launch, then the card as
``nvidia-smi`` names it.

* ``bwd`` (default): the flash backward (``flash_attn_bwd.cu``, dQ and
  dK/dV) at every attention shape of a training step
  (:data:`TRAIN_SHAPES`), SDPA's backward beside it;
* ``fwd``: the flash forward (``flash_attn_fwd.cu``) at every shape of
  ``chip_smoke.py``'s attention phase (:data:`SAMPLING_SHAPES`,
  :data:`T2MV_FLASH_SHAPES`) and the forward of every training shape
  (with the lse), SDPA's forward and the exp floor beside it;
* ``gemm``: each of the five GEMM entries of ``fused_ln_attn.cu``,
  ``fused_ln_geglu_ff.cu`` and ``micro_matmul.cu`` (the GEMM tile of
  ``gemm_tile.cuh``) at the shapes of the fused blocks
  (:data:`ATTN_BLOCK_SHAPES`, :data:`FF_BLOCK_SHAPES`, MVDream's
  :data:`T2MV_ATTN_BLOCK_SHAPES`, :data:`T2MV_FF_BLOCK_SHAPES`) and of
  the matmul probe (:data:`MATMUL_SHAPES`), the cuBLAS product beside it;
* ``micro``: the microbenchmark's attention probes (``micro_attn.cu``),
  the f32-dot flash and fullk in its modes, at every such case of the TPU
  tool's sections (:data:`MICRO_CASES`), SDPA (for the f32-dot flash also
  SDPA on f32 copies), the route's bound and the exp floor beside them;
* ``f32bwd``: the f32 route's backward (``f32_route.cu``, dQ and dK/dV in
  f32) at every attention shape of a training step (:data:`F32_BWD_SHAPES`),
  each build held within relative L2 of the plain backward in f32 (TF32
  off), SDPA's f32 backward and its backend, the 3xTF32 and FFMA bounds
  beside it;
* ``f32fwd``: the f32 route's forward (``f32_route.cu``) at every forward
  shape of sampling and training (:func:`fwd_shapes`, the fill and the
  D = 512 VAE included) in f32, each build's relative L2 for out and lse
  against the plain version in f32 (TF32 off), SDPA in f32 and its
  backend, the 3xTF32 and FFMA bounds, the instance's shared memory (past
  head dim 160 this tree runs the GEMM-tile route; a build whose flash
  entry still takes those head dims runs that entry);
* ``f32gemm``: every f32 GEMM launch of the fused blocks
  (``f32_route.cu``'s ``mvldm_f32_gemm``: one of the three q/k/v
  projections, the output projection, W1 + b1 and W2 + b2 + x at
  :data:`ATTN_BLOCK_SHAPES` and :data:`FF_BLOCK_SHAPES`, C = 320 and 640)
  and the matmul probe's f32 route (``micro_matmul.cu``) at
  :data:`MATMUL_SHAPES`, each build's relative L2 against the product in
  float64, cuBLAS f32 with TF32 off, the 3xTF32 and FFMA bounds, each
  build's registers and spills (ptxas) and this tree's shared memory;
* ``exp``: the exp probe (``micro_exp.cu``) at :data:`EXP_SHAPES`, each
  build within 1e-6 relative of exp in float64, ``torch.exp`` and the
  byte bound beside it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..ops import _build
from ..ops import attention as attn
from ..ops import f32_route, fused_attn, fused_ff
from . import bench_attn_micro as micro
from . import measure

# (label, B, H, L, D, bias): every attention of a training step at batch 2
# (2 context + 3 target views): the joint attention over B = 2 examples, the
# per-frame ones over 2 x 5 frames.
TRAIN_SHAPES = [
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

# (label, B, H, L, D, bias): the flash forward's shapes in anchored
# sampling; B counts batch rows (2 = batched CFG, 4 = two fill groups).
SAMPLING_SHAPES = [
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

# (label, N frames, L, C, heads, head_dim) of the fused LN + self-attention
# block and (label, N, L, C) of the fused LN + GEGLU FF, N = 2 CFG rows x 5
# views; (M, K) of the matmul probe (its B is K x K).
ATTN_BLOCK_SHAPES = [
    ("SD attn1 32x32 (C=320)", 10, 1024, 320, 5, 64),
    ("cross-view attn2 32x32 (C=320)", 10, 1024, 320, 8, 40),
    ("SD attn1 16x16 (C=640)", 10, 256, 640, 10, 64),
    ("cross-view attn2 16x16 (C=640)", 10, 256, 640, 8, 80),
]
FF_BLOCK_SHAPES = [("FF 32x32 (C=320)", 10, 1024, 320), ("FF 16x16 (C=640)", 10, 256, 640)]

# MVDream's text-to-multiview step (``models/mvdream.py``: 4 prompts with
# batched CFG, 8 rows of 4 views at 32x32 latents, heads of D = 64), whose
# SD blocks run on each row's 4 views as one sequence: (label, B, H, Lq, Lk,
# D) of the flash forward, no bias (the text attn2 onto 77 tokens at every
# level, a ragged key tail, and the joint attn1 of the C = 1280 blocks,
# which take the decomposed path); the fused blocks' joint shapes as above.
T2MV_FLASH_SHAPES = [
    ("MVDream text attn2 32x32 (C=320)", 8, 5, 4 * 1024, 77, 64),
    ("MVDream text attn2 16x16 (C=640)", 8, 10, 4 * 256, 77, 64),
    ("MVDream text attn2 8x8 (C=1280)", 8, 20, 4 * 64, 77, 64),
    ("MVDream text attn2 4x4 (C=1280)", 8, 20, 4 * 16, 77, 64),
    ("MVDream joint attn1 8x8 (C=1280)", 8, 20, 4 * 64, 4 * 64, 64),
    ("MVDream joint attn1 4x4 (C=1280)", 8, 20, 4 * 16, 4 * 16, 64),
]
T2MV_ATTN_BLOCK_SHAPES = [
    ("MVDream joint attn1 32x32 (C=320)", 8, 4 * 1024, 320, 5, 64),
    ("MVDream joint attn1 16x16 (C=640)", 8, 4 * 256, 640, 10, 64),
]
T2MV_FF_BLOCK_SHAPES = [("MVDream FF 32x32 (C=320)", 8, 4 * 1024, 320),
                        ("MVDream FF 16x16 (C=640)", 8, 4 * 256, 640)]
MATMUL_SHAPES = [(4096, 1024), (8192, 512)]

# (label, probe, case kwargs): every f32-dot flash and fullk case of the TPU
# tool's flash, fullk and floor sections, once each.
_F32 = torch.float32
MICRO_CASES = [
    ("flash f32 16x8x5120x40", "flash", dict(b=16, h=8, l=5120, d=40, dot_dtype=_F32)),
    ("flash f32 16x8x1280x80", "flash", dict(b=16, h=8, l=1280, d=80, dot_dtype=_F32)),
    ("flash f32 16x8x320x160", "flash", dict(b=16, h=8, l=320, d=160, dot_dtype=_F32)),
    ("flash f32 80x8x1024x40", "flash", dict(b=80, h=8, l=1024, d=40, dot_dtype=_F32)),
    ("fullk max 16x8x5120x40", "fullk", dict(b=16, h=8, l=5120, d=40, do_max=True)),
    ("fullk nomax 16x8x5120x40", "fullk", dict(b=16, h=8, l=5120, d=40, do_max=False)),
    ("fullk none 16x8x5120x40", "fullk", dict(b=16, h=8, l=5120, d=40, do_max="none")),
    ("fullk max 16x8x1280x80", "fullk", dict(b=16, h=8, l=1280, d=80, do_max=True)),
    ("fullk max 80x8x1024x40", "fullk", dict(b=80, h=8, l=1024, d=40, do_max=True)),
]

# The f32 UNet (the configs' default precision) runs the same attentions in
# a training step, through the f32 route.
F32_BWD_SHAPES = TRAIN_SHAPES

# The exp probe's (l, l) tile (the TPU tool's l = 1024) and one of 64 MB,
# past the 50 MB L2.
EXP_SHAPES = [(1024, 1024), (4096, 4096)]

SOURCES = {"bwd": ("flash_attn_bwd",), "fwd": ("flash_attn_fwd",),
           "gemm": ("fused_ln_attn", "fused_ln_geglu_ff", "micro_matmul"),
           "micro": ("micro_attn",), "f32bwd": ("f32_route",), "f32fwd": ("f32_route",),
           "f32gemm": ("f32_route", "micro_matmul"), "exp": ("micro_exp",)}
SIGNATURES = {"flash_attn_bwd": attn._BWD_SIGNATURES, "flash_attn_fwd": attn._FWD_SIGNATURES,
              "fused_ln_attn": fused_attn._SIGNATURES, "fused_ln_geglu_ff": fused_ff._SIGNATURES,
              "micro_matmul": micro._MATMUL_SIG, "micro_attn": micro._ATTN_SIG,
              "micro_exp": micro._EXP_SIG, "f32_route": f32_route._SIGNATURES}
# The entries the comparison calls in another checkout's build, where that
# source holds entries this tree added since (f32_route.cu's smem queries),
# and those it declares only where that build has them (the forward's route
# past head dim 160).
OTHER_ENTRIES = {"f32_route": ("mvldm_f32_flash_fwd", "mvldm_f32_flash_bwd_dq",
                               "mvldm_f32_flash_bwd_dkv", "mvldm_f32_gemm")}
OPTIONAL_ENTRIES = {"f32_route": ("mvldm_f32_gemm_batched", "mvldm_f32_attn_rows")}
# nvcc's log of each build made by this process: {"this" | "other": {source: log}}.
BUILD_LOGS: Dict[str, Dict[str, str]] = {"this": {}, "other": {}}


def attn_inputs(gen, b, h, l, d, with_bias, lk=None):
    """Seeded bf16 q (L rows) and k, v (``lk`` rows, L when None) on the
    card; with a bias, the unconditional rows (all but the first) mask
    their context view (the first fifth of the keys) out, as batched CFG
    does."""
    lk = l if lk is None else lk
    q, k, v = (torch.randn((b, h, n, d), generator=gen, device="cuda",
                           dtype=torch.bfloat16) for n in (l, lk, lk))
    bias = None
    if with_bias:
        bias = torch.zeros((b, lk), device="cuda")
        bias[1:, : lk // 5] = attn.NEG_INF
    return q, k, v, bias


def train_inputs(gen, b, h, l, d, with_bias):
    """:func:`attn_inputs` and a seeded bf16 output gradient g."""
    q, k, v, bias = attn_inputs(gen, b, h, l, d, with_bias)
    g = torch.randn((b, h, l, d), generator=gen, device="cuda", dtype=torch.bfloat16)
    return q, k, v, g, bias


def build_other(checkout: Path, names: Sequence[str]) -> Dict[str, ctypes.CDLL]:
    """``csrc/<name>.cu`` of another checkout for each of ``names``, built
    with this tree's flags (its own headers beside it) into
    ``build/compare/``, one nvcc per source, all started together."""
    out_dir = _build.BUILD_DIR.parent / "compare"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = checkout / "mvldm_tpu_torch" / "csrc" / f"{name}.cu"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src.parent), "-o",
               str(out_dir / f"lib{name}_other.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name}.cu of {checkout} failed:\n{log}")
        BUILD_LOGS["other"][name] = log
    libs = {n: _build.open_lib(out_dir / f"lib{n}_other.so", other_signatures(n)) for n in names}
    for n, lib in libs.items():
        for fn in OPTIONAL_ENTRIES.get(n, ()):
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = SIGNATURES[n][fn]
                getattr(lib, fn).restype = ctypes.c_int
    return libs


def other_signatures(name: str) -> Dict[str, list]:
    """The C entries of ``name`` declared in another checkout's build."""
    keep = OTHER_ENTRIES.get(name, SIGNATURES[name])
    return {fn: args for fn, args in SIGNATURES[name].items() if fn in keep}


def load_libs(kernel: str, other: Path) -> Dict[str, Dict[str, ctypes.CDLL]]:
    """{"this": {source: lib}, "other": {source: lib}} for ``kernel``."""
    names = SOURCES[kernel]
    _build.build(names)
    BUILD_LOGS["this"].update({n: _build.build_log(n) for n in names})
    return {"this": {n: _build.load(n, SIGNATURES[n]) for n in names},
            "other": build_other(other, names)}


def in_turns(fns: Dict[str, Callable[[], object]], rounds: int, iters: Optional[int]):
    """Device ms of each of ``fns`` ("this", "other"), timed this, other,
    other, this, ``rounds`` times: {name: [ms, ...]}."""
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name in ("this", "other", "other", "this"):
            times[name].append(measure.time_ms(fns[name], iters))
    return times


def _mean(xs: Sequence[float]) -> float:
    return sum(xs) / len(xs)


# ------------------------------------------------------------------ bwd

def run_bwd(lib, q, k, v, bias, out, lse, g):
    """Both kernels of ``lib``: (dq, dk, dv, dbias summed over heads)."""
    scale = attn._scale(q, None)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    dbias = None if bias is None else torch.empty(k.shape[:3], dtype=torch.float32,
                                                  device=q.device)
    attn._launch_bwd_dq(lib, q, k, v, bias, out, lse, g, delta, dq, scale)
    attn._launch_bwd_dkv(lib, q, k, v, bias, lse, delta, g, dk, dv, dbias, scale)
    return dq, dk, dv, None if dbias is None else dbias.sum(1), delta


def time_kernels(lib, q, k, v, bias, out, lse, g, iters):
    """(dQ ms, dK/dV ms) of ``lib`` by graph replay."""
    scale = attn._scale(q, None)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    dbias = None if bias is None else torch.empty(k.shape[:3], dtype=torch.float32,
                                                  device=q.device)
    dq_ms = measure.time_ms(
        lambda: attn._launch_bwd_dq(lib, q, k, v, bias, out, lse, g, delta, dq, scale), iters)
    dkv_ms = measure.time_ms(
        lambda: attn._launch_bwd_dkv(lib, q, k, v, bias, lse, delta, g, dk, dv, dbias, scale),
        iters)
    return dq_ms, dkv_ms


def compare_bwd(libs, args, card: str) -> None:
    libs = {name: ls["flash_attn_bwd"] for name, ls in libs.items()}
    n_sms = measure.sm_count()
    gen = torch.Generator("cuda").manual_seed(0)
    for label, b, h, l, d, with_bias in TRAIN_SHAPES:
        if args.only and not any(text in label for text in args.only):
            continue
        q, k, v, g, bias = train_inputs(gen, b, h, l, d, with_bias)
        out, lse = attn.flash_attention(q, k, v, bias, return_lse=True)
        ref = attn.attention_bwd_reference(q.float(), k.float(), v.float(), bias, g.float())
        errs = {}
        for name, lib in libs.items():
            got = run_bwd(lib, q, k, v, bias, out, lse, g)
            errs[name] = max(measure.error_record(x, r)["err_over_rms"]
                             for x, r in zip(got[:4], ref) if r is not None)
        del ref
        iters = 10 if l >= 1024 else 50
        times = {name: [] for name in libs}
        for _ in range(args.rounds):
            for name in ("this", "other", "other", "this"):
                times[name].append(time_kernels(libs[name], q, k, v, bias, out, lse, g, iters))
        mhz = measure.sm_clock_mhz()
        rec = dict(kernel="bwd", shape=label, B=b, H=h, L=l, D=d, bias=with_bias, sm_mhz=mhz,
                   exp_floor_ms=measure.exp_floor_ms(b * h * l * l, mhz, n_sms),
                   sdpa_bwd_ms=measure.sdpa_bwd_ms(q, k, v, bias, g, iters), card=card)
        for name, ts in times.items():
            dq_ms = _mean([t[0] for t in ts])
            dkv_ms = _mean([t[1] for t in ts])
            rec[name] = dict(dq_ms=dq_ms, dkv_ms=dkv_ms, bwd_ms=dq_ms + dkv_ms,
                             err_over_rms=errs[name], turns=[list(t) for t in ts])
        rec["this_over_other"] = rec["this"]["bwd_ms"] / rec["other"]["bwd_ms"]
        print(json.dumps(rec), flush=True)
        del q, k, v, g, bias, out, lse
        torch.cuda.empty_cache()


# --------------------------------------------------------------- f32bwd

def f32_train_inputs(gen, b, h, l, d, with_bias):
    """:func:`train_inputs` as f32 copies (the bias is f32 already)."""
    q, k, v, g, bias = train_inputs(gen, b, h, l, d, with_bias)
    return q.float(), k.float(), v.float(), g.float(), bias


def rel_l2(got, want) -> float:
    """Relative L2 of ``got`` against ``want``, in float64."""
    return (torch.linalg.norm(got.double() - want.double())
            / torch.linalg.norm(want.double())).item()


def sdpa_f32_bwd(q, k, v, bias, g, iters: int) -> dict:
    """SDPA's backward on these f32 inputs, TF32 off: its time
    (:func:`measure.sdpa_bwd_ms`) and the backend it ran."""
    mask = None if bias is None else bias[:, None, None, :]
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

    def fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
        return torch.autograd.grad(out, (qg, kg, vg), g)

    with measure.no_tf32():
        return dict(sdpa_f32_bwd_ms=measure.sdpa_bwd_ms(q, k, v, bias, g, iters),
                    sdpa_f32_bwd_backend=measure.sdpa_backend(fwd_bwd))


def time_f32_kernels(lib, q, k, v, bias, out, lse, g, iters):
    """(dQ ms, dK/dV ms) of ``lib``'s f32 backward by graph replay."""
    scale = attn._scale(q, None)
    dq, delta = torch.empty_like(q), torch.empty_like(lse)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dbias = None if bias is None else torch.empty(k.shape[:3], device=q.device)
    dq_ms = measure.time_ms(lambda: f32_route._launch_bwd_dq(
        lib, q, k, v, out, lse, g, bias, dq, delta, scale), iters)
    dkv_ms = measure.time_ms(lambda: f32_route._launch_bwd_dkv(
        lib, q, k, v, g, lse, delta, bias, dk, dv, dbias, scale), iters)
    return dq_ms, dkv_ms


def compare_f32bwd(libs, args, card: str) -> None:
    libs = {name: ls["f32_route"] for name, ls in libs.items()}
    gen = torch.Generator("cuda").manual_seed(0)
    for label, b, h, l, d, with_bias in F32_BWD_SHAPES:
        if args.only and not any(text in label for text in args.only):
            continue
        q, k, v, g, bias = f32_train_inputs(gen, b, h, l, d, with_bias)
        out, lse = f32_route.flash_attention_f32(q, k, v, bias, return_lse=True)
        scale = attn._scale(q, None)
        with measure.no_tf32():
            ref = attn.attention_bwd_reference(q, k, v, bias, g)
        errs = {}
        for name, lib in libs.items():
            got = f32_route._launch_bwd(lib, q, k, v, bias, out, lse, g, scale, True)
            got = (*got[:3], None if got[3] is None else got[3].sum(1))
            errs[name] = {n: rel_l2(x, r) for n, x, r in zip(("dq", "dk", "dv", "dbias"), got, ref)
                          if r is not None}
        del ref
        iters = 5 if l >= 1024 else 50
        times = {name: [] for name in libs}
        for _ in range(args.rounds):
            for name in ("this", "other", "other", "this"):
                times[name].append(time_f32_kernels(libs[name], q, k, v, bias, out, lse, g,
                                                    iters))
        moved = measure.nbytes(q, k, v, out, g, lse, bias, *got)
        rec = dict(kernel="f32bwd", shape=label, B=b, H=h, L=l, D=d, bias=with_bias,
                   **measure.f32_bwd_bounds(b, h, l, l, d, moved),
                   **sdpa_f32_bwd(q, k, v, bias, g, iters), card=card)
        for name, ts in times.items():
            dq_ms, dkv_ms = _mean([t[0] for t in ts]), _mean([t[1] for t in ts])
            rec[name] = dict(ms=dq_ms + dkv_ms, dq_ms=dq_ms, dkv_ms=dkv_ms, rel_l2=errs[name],
                             turns=[list(t) for t in ts])
        rec["this_over_other"] = rec["this"]["ms"] / rec["other"]["ms"]
        rec["this_over_sdpa"] = rec["this"]["ms"] / rec["sdpa_f32_bwd_ms"]
        print(json.dumps(rec), flush=True)
        del q, k, v, g, bias, out, lse
        torch.cuda.empty_cache()


# --------------------------------------------------------------- f32fwd

def sdpa_f32(q, k, v, bias, iters: int) -> dict:
    """SDPA's forward on these f32 inputs, TF32 off: its device time and
    the backend it ran."""
    mask = None if bias is None else bias[:, None, None, :]

    def fwd():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

    with measure.no_tf32():
        return dict(sdpa_f32_ms=measure.time_ms(fwd, iters),
                    sdpa_f32_backend=measure.sdpa_backend(fwd))


def f32_fwd(lib, q, k, v, bias, out, lse, scale: float) -> None:
    """The f32 forward of ``lib``: this tree's (:func:`f32_route._launch_fwd`,
    the route past head dim 160), or, for a build without the route's
    entries, its flash entry at every head dim (which took up to 512)."""
    if q.shape[-1] <= f32_route.MAX_FLASH_HEAD_DIM or hasattr(lib, "mvldm_f32_attn_rows"):
        f32_route._launch_fwd(q, k, v, bias, out, lse, scale, lib)
        return
    b, h, lq, d = q.shape
    _build.check(lib.mvldm_f32_flash_fwd(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), f32_route._optr(bias), _build.ptr(out),
        f32_route._optr(lse), b, h, lq, k.shape[2], d, float(scale),
        _build.stream_ptr(q.device)), f"mvldm_f32_flash_fwd (head dim {d})")


def f32_fwd_errors(lib, q, k, v, bias, ref_out, ref_lse) -> dict:
    """Relative L2 of ``lib``'s f32 forward, out and lse, against the plain
    version's."""
    out, lse = torch.empty_like(q), torch.empty(q.shape[:3], device=q.device)
    f32_fwd(lib, q, k, v, bias, out, lse, attn._scale(q, None))
    return dict(out=rel_l2(out, ref_out), lse=rel_l2(lse, ref_lse))


def compare_f32fwd(libs, args, card: str) -> None:
    libs = {name: ls["f32_route"] for name, ls in libs.items()}
    gen = torch.Generator("cuda").manual_seed(0)
    for label, b, h, l, d, with_bias, with_lse in fwd_shapes():
        if args.only and not any(text in label for text in args.only):
            continue
        q, k, v, bias = attn_inputs(gen, b, h, l, d, with_bias)
        q, k, v = q.float(), k.float(), v.float()
        with measure.no_tf32():
            ref_out, ref_lse = attn.attention_reference_lse(q, k, v, bias)
        errs = {name: f32_fwd_errors(lib, q, k, v, bias, ref_out, ref_lse)
                for name, lib in libs.items()}
        del ref_out, ref_lse
        scale = attn._scale(q, None)
        out = torch.empty_like(q)
        lse = torch.empty(q.shape[:3], device="cuda") if with_lse else None
        iters = 10 if l >= 1024 else 50
        times = in_turns({name: (lambda lib=lib: f32_fwd(lib, q, k, v, bias, out, lse, scale))
                          for name, lib in libs.items()}, args.rounds, iters)
        rec = dict(kernel="f32fwd", shape=label, B=b, H=h, L=l, D=d, bias=with_bias,
                   lse=with_lse, smem_bytes=f32_route.fwd_smem_bytes(l, d),
                   **measure.f32_fwd_bounds(b, h, l, l, d, measure.nbytes(q, k, v, bias, out, lse)),
                   **sdpa_f32(q, k, v, bias, iters), card=card)
        for name, ts in times.items():
            rec[name] = dict(ms=_mean(ts), rel_l2=errs[name], turns=ts)
        rec["this_over_other"] = rec["this"]["ms"] / rec["other"]["ms"]
        rec["this_over_sdpa"] = rec["this"]["ms"] / rec["sdpa_f32_ms"]
        rec["this_share_of_bound"] = rec["bound_ms"] / rec["this"]["ms"]
        print(json.dumps(rec), flush=True)
        del q, k, v, bias, out, lse
        torch.cuda.empty_cache()


# ------------------------------------------------------------------ exp

def compare_exp(libs, args, card: str) -> None:
    libs = {name: ls["micro_exp"] for name, ls in libs.items()}
    gen = torch.Generator("cuda").manual_seed(0)
    for shape in EXP_SHAPES:
        label = "x".join(map(str, shape))
        if args.only and not any(text in label for text in args.only):
            continue
        x = torch.randn(shape, generator=gen, device="cuda")
        out = torch.empty_like(x)
        ref = torch.exp(x.double())
        errs = {}
        for name, lib in libs.items():
            micro._launch_exp(lib, x, out)
            errs[name] = ((out.double() - ref) / ref).abs().max().item()
        del ref
        times = in_turns({name: (lambda lib=lib: micro._launch_exp(lib, x, out))
                          for name, lib in libs.items()}, args.rounds, None)
        bound_ms, bound_by = measure.bound(0.0, measure.nbytes(x, out))
        rec = dict(kernel="exp", shape=label, bound_ms=bound_ms, bound_by=bound_by,
                   torch_exp_ms=measure.time_ms(lambda: torch.exp(x)), card=card)
        for name, ts in times.items():
            rec[name] = dict(ms=_mean(ts), max_rel_err=errs[name], turns=ts)
        rec["this_over_other"] = rec["this"]["ms"] / rec["other"]["ms"]
        rec["this_over_torch"] = rec["this"]["ms"] / rec["torch_exp_ms"]
        print(json.dumps(rec), flush=True)
        del x, out
        torch.cuda.empty_cache()


# ------------------------------------------------------------------ fwd

def fwd_shapes():
    """(label, B, H, L, D, bias, with_lse): the sampling shapes, then the
    forward of every training shape (which writes the lse)."""
    return ([(label, *shape, False) for label, *shape in SAMPLING_SHAPES]
            + [(f"train {label}", *shape, True) for label, *shape in TRAIN_SHAPES])


def fwd_cases():
    """(label, B, H, Lq, Lk, D, bias, with_lse): :func:`fwd_shapes`, then
    MVDream's (:data:`T2MV_FLASH_SHAPES`, no lse)."""
    return ([(label, b, h, l, l, d, bias, lse) for label, b, h, l, d, bias, lse in fwd_shapes()]
            + [(*shape, False, False) for shape in T2MV_FLASH_SHAPES])


def compare_fwd(libs, args, card: str) -> None:
    libs = {name: ls["flash_attn_fwd"] for name, ls in libs.items()}
    n_sms = measure.sm_count()
    gen = torch.Generator("cuda").manual_seed(0)
    for label, b, h, l, lk, d, with_bias, with_lse in fwd_cases():
        if args.only and not any(text in label for text in args.only):
            continue
        q, k, v, bias = attn_inputs(gen, b, h, l, d, with_bias, lk)
        scale = attn._scale(q, None)
        out = torch.empty_like(q)
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device="cuda") if with_lse else None
        ref_out, ref_lse = attn.attention_reference_lse(q.float(), k.float(), v.float(), bias)
        errs = {}
        for name, lib in libs.items():
            attn._launch_flash(q, k, v, bias, out, scale, lse, lib=lib)
            errs[name] = measure.error_record(out, ref_out)["err_over_rms"]
            if with_lse:
                errs[name] = max(errs[name], measure.error_record(lse, ref_lse)["err_over_rms"])
        del ref_out, ref_lse
        iters = 20 if l >= 1024 else 100
        times = in_turns({name: (lambda lib=lib: attn._launch_flash(q, k, v, bias, out, scale,
                                                                    lse, lib=lib))
                          for name, lib in libs.items()}, args.rounds, iters)
        mask = None if bias is None else bias[:, None, None, :].to(q.dtype)
        sdpa_ms = measure.time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask), iters)
        mhz = measure.sm_clock_mhz()
        rec = dict(kernel="fwd", shape=label, B=b, H=h, L=l, Lk=lk, D=d, bias=with_bias,
                   lse=with_lse, sm_mhz=mhz,
                   exp_floor_ms=measure.exp_floor_ms(b * h * l * lk, mhz, n_sms),
                   bound_ms=measure.bound(4.0 * b * h * l * lk * d,
                                          measure.nbytes(q, k, v, bias, out, lse))[0],
                   sdpa_ms=sdpa_ms, card=card)
        for name, ts in times.items():
            rec[name] = dict(ms=_mean(ts), err_over_rms=errs[name], turns=ts)
        rec["this_over_other"] = rec["this"]["ms"] / rec["other"]["ms"]
        rec["this_over_sdpa"] = rec["this"]["ms"] / sdpa_ms
        print(json.dumps(rec), flush=True)
        del q, k, v, bias, out, lse
        torch.cuda.empty_cache()


# ----------------------------------------------------------------- gemm

class GemmCall(NamedTuple):
    """One launch of a GEMM entry at one shape: ``run(lib)`` launches the
    entry of ``lib`` (a build of ``csrc/<source>.cu``) into ``outs``,
    ``refs`` are the plain version's f32 outputs on the same inputs (with
    ``residual`` taken off before the rms, for the residual epilogues),
    ``library`` is the cuBLAS product of the same operands, and ``flops``
    and ``moved`` give the bound."""
    entry: str
    source: str
    shape: str
    run: Callable[[ctypes.CDLL], None]
    outs: List[torch.Tensor]
    refs: List[torch.Tensor]
    residual: Optional[torch.Tensor]
    library: Callable[[], object]
    flops: float
    moved: int
    plain: Optional[Callable[[], object]] = None  # the f32 calls' plain version
    mnk: Optional[Tuple[int, int, int]] = None    # and their (M, N, K)


def _bf16(gen, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)


def _vec(gen, n, scale=0.1, shift=0.0):
    return torch.randn(n, generator=gen, device="cuda") * scale + shift


def block_weights(gen, out_f: int, in_f: int):
    """A torch-Linear-layout bf16 weight (out, in) with std in_f ** -0.5;
    the fused blocks take its (in, out) view."""
    return (torch.randn((out_f, in_f), generator=gen, device="cuda") * in_f ** -0.5
            ).to(torch.bfloat16)


def _ln_bf16(x, g, b, eps=1e-6):
    return fused_attn._layer_norm(x, g, b, eps).to(torch.bfloat16).float()


def attn_block_gemms(label, x, g, b, wq, wk, wv, wo, bo, heads, d, gen) -> List[GemmCall]:
    """The two GEMM launches of the fused LN + self-attention block on x
    (N, L, C) with JAX-layout weights (torch-Linear transposes): the LN +
    QKV GEMM, and the output projection on a seeded o (N, H, L, D)."""
    n, l, c = x.shape
    hd = heads * d
    q, k, v = (torch.empty((n, heads, l, d), dtype=x.dtype, device="cuda") for _ in range(3))
    scale = d ** -0.5
    xn = _ln_bf16(x, g, b)

    def heads_of(y):
        return y.reshape(n, l, heads, d).transpose(1, 2)

    refs = [heads_of(xn @ wq.float()) * scale, heads_of(xn @ wk.float()),
            heads_of(xn @ wv.float())]
    xn16, wqkv = xn.to(x.dtype).reshape(-1, c), torch.cat([wq, wk, wv], dim=1)
    qkv = [GemmCall("mvldm_ln_qkv", "fused_ln_attn", label,
                    lambda lib: fused_attn._launch_ln_qkv(lib, x, g, b, wq, wk, wv, q, k, v, 1e-6),
                    [q, k, v], refs, None,
                    lambda: xn16 @ wqkv,
                    2.0 * n * l * c * 3 * hd, measure.nbytes(x, g, b, wq, wk, wv, q, k, v))]
    o = _bf16(gen, n, heads, l, d)
    y = torch.empty_like(x)
    om = o.transpose(1, 2).reshape(n * l, hd)
    ref = (om.float() @ wo.float() + bo).reshape(x.shape) + x.float()
    bo16 = bo.to(x.dtype)
    proj = GemmCall("mvldm_attn_out_proj", "fused_ln_attn", label,
                    lambda lib: fused_attn._launch_out_proj(lib, o, wo, bo, x, y),
                    [y], [ref], x, lambda: F.linear(om, wo.t(), bo16),
                    2.0 * n * l * hd * c, measure.nbytes(o, wo, bo, x, y))
    return qkv + [proj]


def ff_block_gemms(label, x, g, b, w1, b1, w2, b2, gen) -> List[GemmCall]:
    """The two GEMM launches of the fused LN + GEGLU FF block on x (N, L, C)
    with JAX-layout weights: LN + W1 with the GEGLU epilogue, and W2 with
    the residual epilogue on a seeded activation."""
    n, l, c = x.shape
    f = 4 * c
    m = n * l
    act = torch.empty((m, f), dtype=x.dtype, device="cuda")
    hg = _ln_bf16(x, g, b).reshape(m, c) @ w1.float() + b1
    ref_act = hg[:, :f] * F.gelu(hg[:, f:])
    xn16, b1_16 = _ln_bf16(x, g, b).to(x.dtype).reshape(m, c), b1.to(x.dtype)
    geglu = GemmCall("mvldm_ff_geglu", "fused_ln_geglu_ff", label,
                     lambda lib: fused_ff._launch_geglu(lib, x, g, b, w1, b1, act, 1e-6),
                     [act], [ref_act], None, lambda: F.linear(xn16, w1.t(), b1_16),
                     2.0 * m * c * 2 * f, measure.nbytes(x, g, b, w1, b1, act))
    a2 = _bf16(gen, m, f, scale=0.5)
    y = torch.empty_like(x)
    ref = (a2.float() @ w2.float() + b2).reshape(x.shape) + x.float()
    out = GemmCall("mvldm_ff_out", "fused_ln_geglu_ff", label,
                   lambda lib: fused_ff._launch_ff_out(lib, a2, w2, b2, x, y),
                   [y], [ref], x, lambda b2_16=b2.to(x.dtype): F.linear(a2, w2.t(), b2_16),
                   2.0 * m * f * c, measure.nbytes(a2, w2, b2, x, y))
    return [geglu, out]


def matmul_gemm(m: int, k: int, gen) -> GemmCall:
    a, bm = _bf16(gen, m, k), _bf16(gen, k, k)
    out = torch.empty((m, k), dtype=torch.bfloat16, device="cuda")
    return GemmCall("mvldm_micro_matmul", "micro_matmul", f"matmul {m}x{k}x{k} bf16",
                    lambda lib: micro._launch_matmul(lib, a, bm, out), [out],
                    [a.float() @ bm.float()], None, lambda: torch.matmul(a, bm),
                    2.0 * m * k * k, measure.nbytes(a, bm, out))


def attn_block_inputs(gen, n, l, c, heads, d):
    """x, LN scale and bias, wq, wk, wv, wo (JAX layouts), bo."""
    hd = heads * d
    x = _bf16(gen, n, l, c)
    g = torch.rand(c, generator=gen, device="cuda") + 0.5
    b = _vec(gen, c)
    wq, wk, wv = (block_weights(gen, hd, c).t() for _ in range(3))
    wo = block_weights(gen, c, hd).t()
    return x, g, b, wq, wk, wv, wo, _vec(gen, c)


def ff_block_inputs(gen, n, l, c):
    """x, LN scale and bias, w1, b1, w2, b2 (JAX layouts)."""
    x = _bf16(gen, n, l, c)
    g = torch.rand(c, generator=gen, device="cuda") + 0.5
    b = _vec(gen, c)
    w1 = block_weights(gen, 8 * c, c).t()
    b1 = _vec(gen, 8 * c)
    w2 = block_weights(gen, c, 4 * c).t()
    return x, g, b, w1, b1, w2, _vec(gen, c)


def gemm_calls(gen):
    """Every GEMM launch at every shape of the fused blocks (MVDream's
    included) and the probe."""
    for label, n, l, c, heads, d in ATTN_BLOCK_SHAPES + T2MV_ATTN_BLOCK_SHAPES:
        yield from attn_block_gemms(label, *attn_block_inputs(gen, n, l, c, heads, d), heads, d,
                                    gen)
    for label, n, l, c in FF_BLOCK_SHAPES + T2MV_FF_BLOCK_SHAPES:
        yield from ff_block_gemms(label, *ff_block_inputs(gen, n, l, c), gen)
    for m, k in MATMUL_SHAPES:
        yield matmul_gemm(m, k, gen)


def gemm_error(call: GemmCall) -> float:
    """The worst own error over rms of ``call``'s outputs (as just run)."""
    return max(measure.error_record(out, ref, call.residual)["err_over_rms"]
               for out, ref in zip(call.outs, call.refs))


def compare_gemm(libs, args, card: str) -> None:
    gen = torch.Generator("cuda").manual_seed(0)
    for call in gemm_calls(gen):
        label = f"{call.entry} {call.shape}"
        if args.only and not any(text in label for text in args.only):
            continue
        errs = {}
        for name, ls in libs.items():
            call.run(ls[call.source])
            errs[name] = gemm_error(call)
        times = in_turns({name: (lambda lib=ls[call.source]: call.run(lib))
                          for name, ls in libs.items()}, args.rounds, None)
        bound_ms, bound_by = measure.bound(call.flops, call.moved)
        rec = dict(kernel="gemm", entry=call.entry, shape=call.shape, bound_ms=bound_ms,
                   bound_by=bound_by, cublas_ms=measure.time_ms(call.library), card=card)
        for name, ts in times.items():
            rec[name] = dict(ms=_mean(ts), err_over_rms=errs[name], turns=ts)
        rec["this_over_other"] = rec["this"]["ms"] / rec["other"]["ms"]
        print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()


# -------------------------------------------------------------- f32gemm

def _f32(t):
    """An f32 copy that keeps a transposed weight transposed."""
    return t.t().float().t() if t.dim() == 2 and not t.is_contiguous() else t.float()


def _f32_gemm_call(label, what, run, out, ref_args, ref_kw, library, moved,
                   source="f32_route", entry="mvldm_f32_gemm") -> GemmCall:
    """An f32 GEMM launch: ``run(lib)`` writes ``out``; its function is
    :func:`f32_route.gemm_f32_reference` of ``ref_args`` and ``ref_kw``
    (``refs``: in float64; ``plain``: the plain version in f32)."""
    ref = f32_route.gemm_f32_reference(*(t if t is None else t.double() for t in ref_args),
                                       **ref_kw)
    b = ref_args[1]
    n, k = (b.shape[1], b.shape[0]) if ref_kw.get("b_kn") else b.shape
    m = ref.numel() // n
    return GemmCall(entry, source, f"{label} {what}", run, [out], [ref], None, library,
                    2.0 * m * n * k, moved,
                    lambda: f32_route.gemm_f32_reference(*ref_args, **ref_kw), (m, n, k))


def f32_block_gemms(gen, kind: str, label: str, shape) -> List[GemmCall]:
    """The f32 route's GEMM launches of one fused block (kind "attn": one of
    the three q/k/v projections, written head-split, and the head-merging
    output projection + b_o + x; "ff": W1 + b1 and W2 + b2 + x) on f32
    copies of the block's seeded inputs, each with the cuBLAS product of the
    same operands."""
    def ln(x, g, b):
        return fused_attn._layer_norm(x, g, b, 1e-6).reshape(-1, x.shape[-1])

    calls = []
    if kind == "attn":
        n, l, c, heads, d = shape
        x, g, b, wq, _, _, wo, bo = (_f32(t) for t in attn_block_inputs(gen, n, l, c, heads, d))
        m, hd = n * l, heads * d
        xn, wq_l, wo_l = ln(x, g, b), wq.t(), wo.t()
        q = torch.empty((n, heads, l, d), device="cuda")
        calls.append(_f32_gemm_call(
            label, "q/k/v projection (each of 3)",
            lambda lib: f32_route._gemm(lib, xn, wq_l, q, out_heads=heads, l=l, d=d), q,
            (xn, wq_l), dict(out_heads=heads, l=l), lambda: F.linear(xn, wq_l),
            measure.nbytes(xn, wq_l, q)))
        o = torch.randn((n, heads, l, d), generator=gen, device="cuda")
        om = o.transpose(1, 2).reshape(m, hd)
        x2, y = x.reshape(m, c), torch.empty((m, c), device="cuda")
        calls.append(_f32_gemm_call(
            label, "output projection + b_o + x",
            lambda lib: f32_route._gemm(lib, o, wo_l, y, bo, x2, a_heads=heads, l=l, d=d), y,
            (o, wo_l, bo, x2), {}, lambda: F.linear(om, wo_l, bo),
            measure.nbytes(o, wo_l, bo, x2, y)))
    else:
        n, l, c = shape
        x, g, b, w1, b1, w2, b2 = (_f32(t) for t in ff_block_inputs(gen, n, l, c))
        m, f = n * l, 4 * c
        xn, w1_l, w2_l = ln(x, g, b), w1.t(), w2.t()
        h = torch.empty((m, 2 * f), device="cuda")
        calls.append(_f32_gemm_call(
            label, "W1 + b1", lambda lib: f32_route._gemm(lib, xn, w1_l, h, b1), h,
            (xn, w1_l, b1), {}, lambda: F.linear(xn, w1_l, b1), measure.nbytes(xn, w1_l, b1, h)))
        act = torch.randn((m, f), generator=gen, device="cuda") * 0.5
        x2, y = x.reshape(m, c), torch.empty((m, c), device="cuda")
        calls.append(_f32_gemm_call(
            label, "W2 + b2 + x", lambda lib: f32_route._gemm(lib, act, w2_l, y, b2, x2), y,
            (act, w2_l, b2, x2), {}, lambda: F.linear(act, w2_l, b2),
            measure.nbytes(act, w2_l, b2, x2, y)))
    return calls


def f32_matmul_call(m: int, k: int, gen) -> GemmCall:
    """The matmul probe's f32 route at (m, k) @ (k, k)."""
    a = torch.randn((m, k), generator=gen, device="cuda")
    bm = torch.randn((k, k), generator=gen, device="cuda")
    out = torch.empty((m, k), device="cuda")
    return _f32_gemm_call(f"matmul {m}x{k}x{k}", "f32",
                          lambda lib: micro._launch_matmul(lib, a, bm, out), out, (a, bm),
                          dict(b_kn=True), lambda: torch.matmul(a, bm),
                          measure.nbytes(a, bm, out), "micro_matmul", "mvldm_micro_matmul")


def f32_gemm_calls(gen):
    """Every f32 GEMM launch at every fused-block shape and the probe's f32
    cases."""
    for label, n, l, c, heads, d in ATTN_BLOCK_SHAPES:
        yield from f32_block_gemms(gen, "attn", label, (n, l, c, heads, d))
    for label, n, l, c in FF_BLOCK_SHAPES:
        yield from f32_block_gemms(gen, "ff", label, (n, l, c))
    for m, k in MATMUL_SHAPES:
        yield f32_matmul_call(m, k, gen)


def gemm_instances(log: Optional[str]) -> list:
    """The f32 GEMM instances of an nvcc log (ptxas's registers and
    spills): the split-TF32 tile's and the FFMA bodies it replaced."""
    if log is None:
        return []
    return [r for r in _build.ptxas_report(log)
            if r["kernel"].startswith(("gemm_tf32x3", "gemm_f32", "matmul_f32"))]


def compare_f32gemm(libs, args, card: str) -> None:
    gen = torch.Generator("cuda").manual_seed(0)
    smem = f32_route.gemm_smem_bytes()
    for call in f32_gemm_calls(gen):
        label = f"{call.entry} {call.shape}"
        if args.only and not any(text in label for text in args.only):
            continue
        errs = {}
        for name, ls in libs.items():
            call.run(ls[call.source])
            errs[name] = rel_l2(call.outs[0], call.refs[0])
        times = in_turns({name: (lambda lib=ls[call.source]: call.run(lib))
                          for name, ls in libs.items()}, args.rounds, None)
        with measure.no_tf32():
            cublas_ms = measure.time_ms(call.library)
        m, n, k = call.mnk
        rec = dict(kernel="f32gemm", entry=call.entry, shape=call.shape, M=m, N=n, K=k,
                   **measure.f32_gemm_bounds(m, n, k, call.moved), cublas_f32_ms=cublas_ms,
                   cublas_precision="f32, TF32 off", smem_bytes=smem, card=card)
        for name, ts in times.items():
            rec[name] = dict(ms=_mean(ts), rel_l2=errs[name], turns=ts,
                             ptxas=gemm_instances(BUILD_LOGS[name].get(call.source)))
        rec["this_over_other"] = rec["this"]["ms"] / rec["other"]["ms"]
        rec["this_over_cublas"] = rec["this"]["ms"] / cublas_ms
        rec["this_share_of_bound"] = rec["bound_ms"] / rec["this"]["ms"]
        print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- micro

def micro_kernel(lib, probe: str, kw: dict) -> Callable[..., torch.Tensor]:
    """The probe kernel of ``lib`` (a build of ``csrc/micro_attn.cu``) for a
    :data:`MICRO_CASES` case, taking (q, k, v)."""
    scale = 1.0 / kw["d"] ** 0.5
    if probe == "flash":
        return lambda q, k, v: micro._launch_attn("mvldm_micro_flash_tf32", q, k, v, scale,
                                                  lib=lib)
    mode = micro.FULLK_MODES[kw["do_max"]]
    return lambda q, k, v: micro._launch_attn("mvldm_micro_fullk", q, k, v, scale, mode, lib=lib)


def compare_micro(libs, args, card: str) -> None:
    libs = {name: ls["micro_attn"] for name, ls in libs.items()}
    n_sms = measure.sm_count()
    for label, probe, kw in MICRO_CASES:
        if args.only and not any(text in label for text in args.only):
            continue
        case = micro.CASES[probe](**kw)
        kernels = {name: micro_kernel(lib, probe, kw) for name, lib in libs.items()}
        ref = micro.plain_by_rows(case.plain, *(t.float() for t in case.inputs))
        errs = {name: measure.error_record(fn(*case.inputs), ref)["err_over_rms"]
                for name, fn in kernels.items()}
        del ref
        times = in_turns({name: (lambda fn=fn: fn(*case.inputs)) for name, fn in kernels.items()},
                         args.rounds, None)
        rec = dict(kernel="micro", case=label, probe=probe,
                   **{k: str(v) if isinstance(v, torch.dtype) else v for k, v in kw.items()},
                   **micro.bounds(case.work, measure.sm_clock_mhz(), n_sms))
        with measure.no_tf32():
            rec["sdpa_ms"] = None if case.library is None else measure.time_ms(
                lambda: case.library(*case.inputs))
            if case.library_f32 is not None:
                rec["sdpa_f32_ms"] = measure.time_ms(case.library_f32)
                rec["sdpa_f32_backend"] = measure.sdpa_backend(case.library_f32)
        rec["card"] = card
        for name, ts in times.items():
            rec[name] = dict(ms=_mean(ts), err_over_rms=errs[name], turns=ts)
        rec["this_over_other"] = rec["this"]["ms"] / rec["other"]["ms"]
        print(json.dumps(rec), flush=True)
        del case, kernels
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path, help="another checkout's root")
    ap.add_argument("--kernel", choices=sorted(SOURCES), default="bwd",
                    help="which kernel's sources to compare (default: bwd)")
    ap.add_argument("--rounds", type=int, default=2, help="turn pairs per shape")
    ap.add_argument("--only", action="append", default=[],
                    help="time only the shapes whose label contains TEXT (repeatable)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_compare: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = measure.card_line()
    libs = load_libs(args.kernel, args.other)
    {"bwd": compare_bwd, "fwd": compare_fwd, "gemm": compare_gemm, "micro": compare_micro,
     "f32bwd": compare_f32bwd, "f32fwd": compare_f32fwd, "f32gemm": compare_f32gemm,
     "exp": compare_exp}[args.kernel](
        libs, args, card)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
