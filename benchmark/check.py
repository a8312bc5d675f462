"""The check that decides ``correct``: what the timed path produced, held
against the plain reference (``reference/``), which imports nothing of the
program and makes its own weights again from the seed.

* ``scenes`` and ``requests``: a sample drawn from the seed of what the
  window served. For a scene: its first launch (the anchors, from the
  context alone) and ``check.fill_rows`` fill groups; for requests,
  ``check.requests`` of them, the largest always among them. The reference
  reruns each sampled launch row with the draws the program took and
  compares the frames it returned. A fill group starts from the anchor
  frame the program returned: the reference follows the program from its
  own state there, and the first launch checks the anchors themselves.
  The number compared is the worst frame's RMS difference in 8-bit levels
  (``frame_rms``). A frame missing or of another shape reads infinite.
* ``train``: the reference follows the first ``check_updates`` updates
  on the same batches and draws. Compared: the loss of each micro-step
  before the first update (``loss_rel``), the worst leaf's gap in the first update's gradient
  norm (``grad_leaf``) and in its change over those updates
  (``change_leaf``), each leaf's gap over the larger of its reference norm
  and the median leaf's; leaves whose reference gradient is under a
  thousandth of the median leaf's are left out of both.
"""

from __future__ import annotations

import gc
import math
from typing import Dict, List

import numpy as np
import torch

from . import traffic, weights
from .program import dtype_of
from .reference import reference_of, sampling, training
from .reference.numerics import Numerics, no_tf32

# The stream of the run's seed that draws the check's sample.
SAMPLE_STREAM = 3 << 20
LEAF_FLOOR = 1e-3


def reference_model(config: Dict, seed: int, device, fp8: bool = False) -> torch.nn.Module:
    """The configuration's reference (``reference_of``) in float32 with the
    benchmark's seeded weights (as served: rounded to the configuration's
    type)."""
    with torch.device("meta"):
        model = reference_of(config).Model(config["model"], Numerics(fp8))
    model = model.to_empty(device=device)
    made = weights.make(weights.spec(model.named_parameters()), seed, device, dtype_of(config))
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(made.pop(name).float())
    return model


def frame_rms(got: np.ndarray, want: np.ndarray) -> float:
    if got is None or got.shape != want.shape or got.dtype != np.uint8:
        return math.inf
    return float(np.sqrt(np.mean((got.astype(np.float64) - want.astype(np.float64)) ** 2)))


def plan_of(mix: Dict, n_t: int) -> List[sampling.Launch]:
    if mix["sampler"] == "anchored":
        return sampling.anchored_plan(n_t, mix["num_anchors_views"], mix["group_size"],
                                      mix["max_parallel_groups"], mix.get("scene_batch", 1))
    return sampling.first_window_plan(n_t, mix["num_anchors_views"])


def sample_rows(mix: Dict, plan: List[sampling.Launch], gen: np.random.Generator):
    """(launch, row) pairs to check: every anchor launch, and fill rows
    drawn from the seed."""
    rows = [(i, 0) for i, launch in enumerate(plan) if launch.kind == "anchor"]
    fills = [(i, r) for i, launch in enumerate(plan) if launch.kind == "fill"
             for r in range(len(launch.rows))]
    k = min(mix["check"].get("fill_rows", 0), len(fills))
    rows += [fills[j] for j in sorted(gen.choice(len(fills), k, replace=False))] if k else []
    return rows


def launch_row(model: torch.nn.Module, ddim, cfg_scale: float, served, plan, i: int, r: int,
               frame_of) -> Dict[int, np.ndarray]:
    """The reference's frames of row ``r`` of launch ``i`` of a served scene
    (target position -> uint8 frame), its context taken from the inputs
    and, for a generated frame, from ``frame_of(position)``."""
    launch = plan[i]
    dev = next(model.parameters()).device
    views = served.views
    ctx_pos = launch.context[r]
    ctx = np.stack([(np.clip(views.images[0], 0, 1) * 255 + 0.5).astype(np.uint8) if p < 0
                    else frame_of(p) for p in ctx_pos])
    cam = [0 if p < 0 else p + 1 for p in ctx_pos] + [p + 1 for p in launch.rows[r]]
    extr = torch.from_numpy(views.extrinsics[cam][None]).to(dev)
    intr = torch.from_numpy(views.intrinsics[cam][None]).to(dev)
    encode_eps, initial = served.draws[2 * i], served.draws[2 * i + 1]
    if launch.kind == "fill":
        # The program encodes the scene's context table once a fill
        # launch: the context frame, then each anchor in plan order,
        # padded by repeating the last.
        anchors = [p for launch_ in plan if launch_.kind == "anchor"
                   for row in launch_.rows for p in row[:launch_.real[0]]]
        slots = [0 if p < 0 else 1 + anchors.index(p) for p in ctx_pos]
        eps = encode_eps[slots]
    else:
        eps = encode_eps
    out = sampling.sample_launch(model, ddim, cfg_scale, torch.from_numpy(ctx[None]).to(dev),
                                 extr, intr, launch.rel_index, eps.to(dev),
                                 initial[r:r + 1].to(dev))[0].cpu().numpy()
    return {p: out[j] for j, p in enumerate(launch.rows[r][:launch.real[r]])}


def check_sampling(run, config: Dict, mix: Dict, seed: int, device) -> Dict[str, float]:
    gen = traffic.rng(seed, SAMPLE_STREAM)
    served = run.items
    if run.kind == "scenes":
        picked = [served[int(gen.integers(len(served)))]]
    else:
        k = min(mix["check"]["requests"], len(served))
        largest = max(range(len(served)), key=lambda j: (len(served[j].frames), -j))
        others = [j for j in range(len(served)) if j != largest]
        picked = [served[largest]] + [served[j] for j in gen.choice(others, k - 1, replace=False)]
    model = reference_model(config, seed, device)
    ddim = sampling.DDIM.from_cfg(config["model"]["scheduler"])
    cfg_scale = config["model"]["cfg_scale"]
    worst = 0.0
    with torch.no_grad(), no_tf32():
        for s in picked:
            n_t = len(s.views.images) - 1
            plan = plan_of(mix, n_t)
            if sorted(s.frames) != list(range(1, n_t + 1)):
                return {"frame_rms": math.inf}

            def frame_of(p, s=s):
                return s.frames[p + 1]

            for i, r in sample_rows(mix, plan, gen):
                want = launch_row(model, ddim, cfg_scale, s, plan, i, r, frame_of)
                for p, frame in want.items():
                    worst = max(worst, frame_rms(s.frames.get(p + 1), frame))
    return {"frame_rms": worst}


def leaf_gaps(got: Dict[str, float], want: Dict[str, float], keep: List[str]) -> float:
    """The worst leaf's |got - want| over the larger of its reference norm
    and the median leaf's."""
    med = float(np.median([want[k] for k in keep]))

    def gap(k):
        scale = max(want[k], med)
        if scale == 0:
            return 0.0 if got[k] == 0 else math.inf
        return abs(got[k] - want[k]) / scale

    return max(gap(k) for k in keep)


def reference_training(config: Dict, mix: Dict, seed: int, device, draws: List[Dict],
                       fp8: bool = False, half_batch: bool = False) -> training.TrainRecord:
    """The reference's first updates on the run's batches and draws: the
    losses, the first update's gradient norms and each leaf's change."""
    model = reference_model(config, seed, device, fp8)
    model.autoencoder.requires_grad_(False)
    ddim = sampling.DDIM.from_cfg(config["model"]["scheduler"])
    opt = config["optimizer"]
    sched = opt["scheduler"]["kwargs"]
    trainer = config["trainer"]
    params = dict(model.denoiser.named_parameters())
    # The weights as served: a copy in the configuration's type is exact.
    initial = {k: p.detach().to(dtype_of(config), copy=True) for k, p in params.items()}
    adam = training.AdamW({k: p.data for k, p in params.items()},
                          training.linear_lr(opt["lr"], sched["start_factor"], sched["total_iters"]),
                          clip=trainer["gradient_clip_val"],
                          every_k=trainer["accumulate_grad_batches"])
    losses, grad_norms = [], {}
    b = mix["batch_size"]
    with no_tf32():
        for i, d in enumerate(draws):
            tb = traffic.make_train_batch(mix, seed, i)
            rows = slice(0, b // 2) if half_batch else slice(0, b)
            loss = training.loss(model, ddim, torch.from_numpy(tb.images[rows]),
                                 torch.from_numpy(tb.extrinsics[rows]),
                                 torch.from_numpy(tb.intrinsics[rows]), tb.num_context,
                                 {k: v[rows] for k, v in d.items()}, config["model"]["cfg_train"])
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            losses.append(loss.item())
            adam.step({k: torch.zeros_like(p) if g is None else g
                       for (k, p), g in zip(params.items(), grads)})
            del grads, loss
            if i == trainer["accumulate_grad_batches"] - 1:
                grad_norms = training.first_gradient_norms(adam.mu, adam.b1)
    change = training.change_norms(adam.params, initial)
    return training.TrainRecord(losses, grad_norms, change)


def check_training(run, config: Dict, mix: Dict, seed: int, device) -> Dict[str, float]:
    prog, draws = run.items[0]
    return compare_training(prog, reference_training(config, mix, seed, device, draws),
                            config["trainer"]["accumulate_grad_batches"])


def compare_training(prog, ref, first: int) -> Dict[str, float]:
    """``loss_rel`` over the ``first`` micro-steps, those before the first
    update: after it the program's bfloat16 weights, rounded from its
    float32 masters, do not yet show the warm-up's updates of ~1e-7 that
    the reference's float32 weights take (see PERF.md)."""
    med = float(np.median(list(ref.grad_norms.values())))
    keep = [k for k, g in ref.grad_norms.items() if g >= LEAF_FLOOR * med]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(prog.losses[:first], ref.losses[:first]))
    if len(prog.losses) != len(ref.losses):
        loss_rel = math.inf
    return {"loss_rel": loss_rel,
            "grad_leaf": leaf_gaps(prog.grad_norms, ref.grad_norms, keep),
            "change_leaf": leaf_gaps(prog.change_norms, ref.change_norms, keep)}


def free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def judge(readings: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, value, limit)]) for a finished run's readings."""
    rows = [(k, readings[k], limits[k]) for k in readings if k in limits]
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return correct, rows
