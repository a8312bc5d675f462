"""Traffic kind ``train``: the training step of ``run_train`` on one card.

The first ``check_updates`` optimizer updates run in set-up, through the
window's own step and feed, and are read for the check; then the window
runs micro-steps, each on a new seeded host batch, and closes at the first
even count of micro-steps after ``seconds``, so that applying and
accumulating micro-steps come equally.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from .. import check as checks, control as controls, program, traffic, weights
from ..reference.training import TrainRecord

check = checks.check_training  # the kind's check of ``correct``
control = controls.control_training  # the control's and faults' readings
UNIT = "micro-steps"
PROFILED = 4  # micro-steps in a traced run's profiled part


def flops(counter, run: program.Run, config: Dict, mix: Dict) -> float:
    """Model FLOPs of the window's micro-steps (``run.work``: one (batch,
    views, hw) a micro-step)."""
    return sum(counter.train_step(b, v, hw) for b, v, hw in run.work)


def drive(system: program.System, mix: Dict, config: Dict, shapes: Dict, seed: int,
          seconds: float, trace: bool, t_start: float,
          step_hook: Optional[Callable] = None) -> program.Run:
    from mvldm_tpu_torch.config import OptimizerCfg, from_dict
    from mvldm_tpu_torch.diffusion.engine import Batch, TrainDraws
    from mvldm_tpu_torch.training import build_lr_schedule, build_optimizer, make_train_step
    from mvldm_tpu_torch.training.trainer import TrainState, master_params

    engine = system.engine
    engine.vae.requires_grad_(False)
    ocfg = from_dict(OptimizerCfg, config["optimizer"], "optimizer")
    trainer = config["trainer"]
    every_k = trainer["accumulate_grad_batches"]
    tx = build_optimizer(ocfg, build_lr_schedule(ocfg.lr, ocfg.scheduler),
                         gradient_clip_val=trainer["gradient_clip_val"],
                         accumulate_grad_batches=every_k)
    params = master_params(engine.unet)
    state = TrainState(params=params, opt_state=tx.init(params), ema_params=None, step=0)
    step = make_train_step(engine, tx, num_context_views=mix["context_views"])
    if step_hook is not None:
        step = step_hook(step)
    gen = torch.Generator(system.device).manual_seed(seed)
    b, v_c = mix["batch_size"], mix["context_views"]
    v, hw = v_c + mix["target_views"], mix["hw"]
    is_target = torch.tensor([[False] * v_c + [True] * mix["target_views"]] * b)

    def micro(i: int):
        tb = traffic.make_train_batch(mix, seed, i)
        batch = Batch(images=torch.from_numpy(tb.images), extrinsics=torch.from_numpy(tb.extrinsics),
                      intrinsics=torch.from_numpy(tb.intrinsics), is_target=is_target)
        d = TrainDraws.draw(b, v, v_c, (hw // 8, hw // 8, system.latent_channels),
                            engine.scheduler.num_train_timesteps, gen)
        _, metrics = step(state, batch, d)
        return d, metrics

    # Set-up: the first updates, read for the check.
    n_check = mix["check_updates"] * every_k
    losses, kept, grad_norms = [], [], {}
    for i in range(n_check):
        d, metrics = micro(i)
        losses.append(float(metrics["loss/diffusion"]))
        kept.append({k: getattr(d, k) for k in d.__dataclass_fields__})
        if i == every_k - 1:
            b1 = tx.b1
            grad_norms = {k: float(torch.linalg.vector_norm(m.double())) / (1 - b1)
                          for k, m in state.opt_state["mu"].items()}
    change = _change_norms(state.params, shapes, seed, system.device, program.dtype_of(config))
    program.sync(system.device)
    run = program.Run("train", UNIT)
    run.items.append((TrainRecord(losses, grad_norms, change), kept))
    run.setup_s = time.perf_counter() - t_start
    setup_peak = program.peak(system.device)
    program.reset_peak(system.device)

    t0 = time.perf_counter()
    i = n_check
    while True:
        micro(i)
        i += 1
        if time.perf_counter() - t0 >= seconds and (i - n_check) % 2 == 0:
            break
    program.sync(system.device)
    steps = i - n_check
    run.window_s = time.perf_counter() - t0
    run.peak_bytes = max(setup_peak, program.peak(system.device))
    run.e2e = {"train_samples_per_s": steps * b / run.window_s,
               "peak_mem_gib": program.peak(system.device) / program.GIB}
    run.attempted = run.done = steps
    run.work = [(b, v, hw)] * steps
    if trace:
        start = i
        def some_steps():
            for j in range(PROFILED):
                micro(start + j)
            return PROFILED

        run.profiled = program.profiled(some_steps, engine, tx)
    return run


def _change_norms(params: Dict[str, torch.Tensor], shapes: Dict, seed: int, device,
                  dtype) -> Dict[str, float]:
    """Each master's distance from the seeded weights it started from,
    made again from the seed."""
    initial = weights.make(shapes, seed, device, dtype)
    out = {k: float(torch.linalg.vector_norm(p.double() - initial["denoiser." + k].double()))
           for k, p in params.items()}
    del initial
    return out
