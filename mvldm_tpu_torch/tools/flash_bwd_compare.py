"""Time this tree's flash-attention backward kernels against another
checkout's, in turns, on one NVIDIA GPU.

    python -m mvldm_tpu_torch.tools.flash_bwd_compare --other DIR [--rounds N] [--only TEXT]

DIR is another checkout of this repository, for example the parent commit
unpacked with ``git archive`` into an ignored directory such as
``build/parent``. Its ``mvldm_tpu_torch/csrc/flash_attn_bwd.cu`` is built
with this tree's nvcc flags into ``build/compare/``; the two builds share
the C interface, so one launch helper drives both. At every attention shape
of a training step (:data:`TRAIN_SHAPES`) the two run on the same inputs,
each checked against the plain backward (own error past half a bf16 step,
over the rms of what it computes, as ``chip_smoke.py`` does), then timed
in turns (this, other, other, this, ``--rounds`` times; dQ and dK/dV each by
CUDA-graph replay), with SDPA's backward on the same inputs beside them.
One JSON line per shape, then the card as ``nvidia-smi`` names it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import _build
from ..ops import attention as attn
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


def train_inputs(gen, b, h, l, d, with_bias):
    """Seeded bf16 q, k, v, g on the card; with a bias, an unconditional
    row masks its context view (the first fifth of the keys) out."""
    q, k, v, g = (torch.randn((b, h, l, d), generator=gen, device="cuda",
                              dtype=torch.bfloat16) for _ in range(4))
    bias = None
    if with_bias:
        bias = torch.zeros((b, l), device="cuda")
        bias[1:, : l // 5] = attn.NEG_INF
    return q, k, v, g, bias


def build_other(checkout: Path) -> ctypes.CDLL:
    src = checkout / "mvldm_tpu_torch" / "csrc" / "flash_attn_bwd.cu"
    out = _build.BUILD_DIR.parent / "compare" / "libflash_attn_bwd_other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src.parent), "-o", str(out),
                    str(src)], check=True, capture_output=True, text=True)
    return _build.open_lib(out, attn._BWD_SIGNATURES)


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path, help="another checkout's root")
    ap.add_argument("--rounds", type=int, default=2, help="turn pairs per shape")
    ap.add_argument("--only", action="append", default=[],
                    help="time only the shapes whose label contains TEXT (repeatable)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_bwd_compare: no CUDA device", file=sys.stderr)
        return 2
    card = measure.card_line()
    n_sms = measure.sm_count()
    libs = {"this": _build.load("flash_attn_bwd", attn._BWD_SIGNATURES),
            "other": build_other(args.other)}
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
        rec = dict(shape=label, B=b, H=h, L=l, D=d, bias=with_bias, sm_mhz=mhz,
                   exp_floor_ms=measure.exp_floor_ms(b * h * l * l, mhz, n_sms),
                   sdpa_bwd_ms=measure.sdpa_bwd_ms(q, k, v, bias, g, iters), card=card)
        for name, ts in times.items():
            dq_ms = sum(t[0] for t in ts) / len(ts)
            dkv_ms = sum(t[1] for t in ts) / len(ts)
            rec[name] = dict(dq_ms=dq_ms, dkv_ms=dkv_ms, bwd_ms=dq_ms + dkv_ms,
                             err_over_rms=errs[name], turns=[list(t) for t in ts])
        rec["this_over_other"] = rec["this"]["bwd_ms"] / rec["other"]["bwd_ms"]
        print(json.dumps(rec), flush=True)
        del q, k, v, g, bias, out, lse
        torch.cuda.empty_cache()
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
