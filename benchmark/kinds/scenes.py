"""Traffic kind ``scenes``: video scenes in a closed loop, one client.

Scene k + 1 is dispatched before scene k is gathered, as ``main mode=test``
does. Once ``seconds`` have passed no scene is dispatched any more: the
scene in flight is gathered and counted, and the window closes when it
has come back. So the window holds the work of exactly the scenes it
counts, and the rate is their frames over all its time.
"""

from __future__ import annotations

import time
from typing import Dict, List

from .. import check as checks, control as controls, program, traffic

check = checks.check_sampling  # the kind's check of ``correct``
control = controls.control_sampling  # the control's and faults' readings
flops = program.sampling_flops  # the kind's model FLOPs
UNIT = "frames"


def drive(system: program.System, mix: Dict, config: Dict, shapes: Dict, seed: int,
          seconds: float, trace: bool, t_start: float) -> program.Run:
    from mvldm_tpu_torch.diffusion.video_sampling import VideoSampler

    draws, dispatch, gen = program.sampler(system, mix, seed)
    n_t, hw, sb = mix["targets"], mix["hw"], mix["scene_batch"]

    def views(i):
        return traffic.make_scene(n_t, hw, mix["path"], traffic.rng(seed, i))

    def start(first: int):
        batch = [views(first + j) for j in range(sb)]
        mark = len(draws.log)
        return batch, mark, dispatch([program.scene_views(v) for v in batch], gen)

    def finish(started) -> List[program.Served]:
        batch, mark, pending = started
        frames = VideoSampler.gather_many(pending, sb)
        return [program.Served(v, f, draws.log[mark:]) for v, f in zip(batch, frames)]

    run = program.Run("scenes", UNIT)
    finish(start(-sb))  # warm-up: every launch shape of a scene
    program.sync(system.device)
    draws.log.clear()
    draws.shapes.clear()
    run.setup_s = time.perf_counter() - t_start
    setup_peak = program.peak(system.device)
    program.reset_peak(system.device)

    t0 = time.perf_counter()
    k = 0
    started = start(0)
    while started is not None:
        nxt = start((k + 1) * sb) if time.perf_counter() - t0 < seconds else None
        run.items.extend(finish(started))
        k += 1
        started = nxt
    run.window_s = time.perf_counter() - t0
    run.peak_bytes = max(setup_peak, program.peak(system.device))
    run.e2e = {"frames_per_s": k * sb * n_t / run.window_s,
               "peak_mem_gib": program.peak(system.device) / program.GIB}
    run.attempted = k * sb
    run.done = k * sb * n_t
    run.work = list(draws.shapes)
    if trace:
        def one_scene():
            finish(start(10 ** 6))
            return n_t * sb

        run.profiled = program.profiled(one_scene, system.engine)
    return run
