"""The readings that the limits of ``limits/<cell>.json`` are set from.

    python3 benchmark/control.py --workload <name> --program 12 --control 3 \\
        [--fault half_batch] [--seconds S] [--first-seed N]

* ``--program N``: the program's own readings on N seeds, each a short
  run of the cell at its own size (a window of ``--seconds``, one scene or
  a few requests; a training cell's readings come from set-up);
* ``--control N``: the control's readings on N seeds: the plain reference
  computed in fp8 (``reference/numerics.py``) in the program's place,
  judged by the float32 reference exactly as a run's output is;
* ``--fault half_batch`` (training): the float32 reference in the
  program's place with half of each micro-batch left out, the mean taken
  over the rest.

Each kind of traffic takes its control's and faults' readings from its
module's ``control(config, mix, seed, device, fault)`` (``kinds/<kind>.py``;
``fault`` is ``--fault`` or None): the sampling kinds from
:func:`control_sampling`, ``train`` from :func:`control_training`.

One JSON line a reading goes to standard output. The benchmark's own runs
never run this. Needs a CUDA device, as the cells do.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

import numpy as np
import torch

from benchmark import check, harness, program, traffic
from benchmark.reference import sampling
from benchmark.reference.numerics import no_tf32


def _draws_for(plan: List[sampling.Launch], hw: int, latent: int, num_anchors: int,
               gen: torch.Generator, device) -> List[torch.Tensor]:
    """Draws of the program's shapes for every launch of ``plan``: the
    posterior eps of its encoded context, then its initial noise."""
    out = []
    hl = hw // 8
    for launch in plan:
        n_ctx = 1 + num_anchors if launch.kind == "fill" else len(launch.context[0])
        out.append(torch.randn((n_ctx, hl, hl, latent), generator=gen, device=device))
        out.append(torch.randn((len(launch.rows), len(launch.rows[0]), hl, hl, latent),
                               generator=gen, device=device))
    return out


def control_sampling(config: Dict, mix: Dict, seed: int, device,
                     fault: Optional[str] = None) -> Dict[str, float]:
    """The fp8 reference serves the sampled launch rows of one scene (or
    the check's requests); the float32 reference judges them. A sampling
    cell has no planted fault besides the fp8 control."""
    if fault not in (None, "fp8"):
        raise ValueError(f"a {mix['kind']} cell has no planted fault {fault!r}")
    ref = check.reference_model(config, seed, device)
    low = check.reference_model(config, seed, device, fp8=True)
    ddim = sampling.DDIM.from_cfg(config["model"]["scheduler"])
    cfg_scale = config["model"]["cfg_scale"]
    latent = config["model"]["autoencoder"]["kwargs"]["latent_channels"]
    gen = traffic.rng(seed, check.SAMPLE_STREAM)
    tgen = torch.Generator(device).manual_seed(seed)
    if mix["kind"] == "scenes":
        sizes = [mix["targets"]]
    else:
        sizes = sorted(mix["targets"])[-1:] + list(
            gen.choice(mix["targets"], mix["check"]["requests"] - 1))
    worst = 0.0
    with torch.no_grad(), no_tf32():
        for j, n_t in enumerate(sizes):
            views = traffic.make_scene(n_t, mix["hw"], mix["path"], traffic.rng(seed, j))
            plan = check.plan_of(mix, n_t)
            served = program.Served(views, {}, _draws_for(plan, mix["hw"], latent,
                                                         mix["num_anchors_views"], tgen, device))
            made: Dict[int, np.ndarray] = {}
            for i, r in check.sample_rows(mix, plan, gen):
                got = check.launch_row(low, ddim, cfg_scale, served, plan, i, r, made.__getitem__)
                want = check.launch_row(ref, ddim, cfg_scale, served, plan, i, r,
                                        made.__getitem__)
                made.update(got)
                worst = max([worst] + [check.frame_rms(got[p], want[p]) for p in want])
    return {"frame_rms": worst}


def train_draws(mix: Dict, config: Dict, n: int, gen: torch.Generator, device) -> List[Dict]:
    b, v_c = mix["batch_size"], mix["context_views"]
    v, hl = v_c + mix["target_views"], mix["hw"] // 8
    c = config["model"]["autoencoder"]["kwargs"]["latent_channels"]
    steps = config["model"]["scheduler"]["num_train_timesteps"]
    out = []
    for _ in range(n):
        out.append({
            "n_ctx": torch.randint(1, v_c + 1, (b,), generator=gen, device=device),
            "perm_scores": torch.rand((b, v_c), generator=gen, device=device),
            "use_relative": torch.rand((b,), generator=gen, device=device) < 0.5,
            "posterior_eps": torch.randn((b, v, hl, hl, c), generator=gen, device=device),
            "noise": torch.randn((b, v, hl, hl, c), generator=gen, device=device),
            "t": torch.randint(0, steps, (b,), generator=gen, device=device),
            "unconditional": torch.rand((b,), generator=gen, device=device) < 0.1,
        })
    return out


def control_training(config: Dict, mix: Dict, seed: int, device,
                     fault: Optional[str] = None) -> Dict[str, float]:
    """The fp8 reference (``fault`` None or ``fp8``) or the float32 one with
    half of each micro-batch left out (``half_batch``) trains in the
    program's place; the float32 reference judges it."""
    fault = fault or "fp8"
    n = mix["check_updates"] * config["trainer"]["accumulate_grad_batches"]
    draws = train_draws(mix, config, n, torch.Generator(device).manual_seed(seed), device)
    want = check.reference_training(config, mix, seed, device, draws)
    check.free()
    got = check.reference_training(config, mix, seed, device, draws, fp8=(fault == "fp8"),
                                   half_batch=(fault == "half_batch"))
    return check.compare_training(got, want, config["trainer"]["accumulate_grad_batches"])


def readings(config: Dict, mix: Dict, seed: int, device,
             fault: Optional[str] = None) -> Dict[str, float]:
    """The control's or a planted fault's readings on one seed, from the
    kind's own ``control``."""
    return harness.load_kind(mix["kind"]).control(config, mix, seed, device, fault)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--program", type=int, default=0)
    parser.add_argument("--control", type=int, default=0)
    parser.add_argument("--fault", default=None)
    parser.add_argument("--seconds", type=float, default=0.0)
    parser.add_argument("--first-seed", type=int, default=2 ** 31 + 1000)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    spec = harness.load_spec()
    cell, entry = harness.cell_of(spec, args.workload)
    config = json.loads((harness.ROOT / entry["file"]).read_text())
    mix = traffic.load(cell["traffic"])
    limits = {k: math.inf for k in ("frame_rms", "loss_rel", "grad_leaf", "change_leaf")}
    seeds = [args.first_seed + 7919 * i for i in range(max(args.program, args.control))]

    def emit(what, seed, readings, t0):
        print(json.dumps({"workload": args.workload, "what": what, "seed": seed,
                          "readings": readings, "s": time.perf_counter() - t0}), flush=True)

    for seed in seeds[:args.program]:
        t0 = time.perf_counter()
        line, _ = harness.run_cell(args.workload, seed, args.seconds, False, spec=spec,
                                   limits=limits)
        out = json.loads(line)
        emit("program", seed, {k: v["value"] for k, v in out["checks"].items()}
             | {"metrics": {k: v["value"] for k, v in out["metrics"].items()}}, t0)
        check.free()
    for seed in seeds[:args.control]:
        t0 = time.perf_counter()
        emit(args.fault or "control_fp8", seed, readings(config, mix, seed, "cuda", args.fault),
             t0)
        check.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
