"""Traffic kind ``requests``: novel-view requests in a closed loop, one
client. Each request is sent when the last has returned its frames to the
host; its latency runs from the call to uint8 frames on the host. The
window closes when the first request to end after ``seconds`` has ended.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np

from .. import check as checks, control as controls, program, traffic

check = checks.check_sampling  # the kind's check of ``correct``
control = controls.control_sampling  # the control's and faults' readings
flops = program.sampling_flops  # the kind's model FLOPs
UNIT = "requests"
PROFILED = 8  # requests in a traced run's profiled part


def drive(system: program.System, mix: Dict, config: Dict, shapes: Dict, seed: int,
          seconds: float, trace: bool, t_start: float) -> program.Run:
    from mvldm_tpu_torch.diffusion.video_sampling import VideoSampler

    draws, dispatch, gen = program.sampler(system, mix, seed)
    hw = mix["hw"]
    sizes = traffic.request_sizes(mix, seed, 4096)

    def serve(i: int, n_t: int) -> program.Served:
        v = traffic.make_scene(n_t, hw, mix["path"], traffic.rng(seed, i))
        mark = len(draws.log)
        t = time.perf_counter()
        frames = VideoSampler.gather_many(dispatch([program.scene_views(v)], gen), 1)[0]
        return program.Served(v, frames, draws.log[mark:], time.perf_counter() - t)

    run = program.Run("requests", UNIT)
    for j, n_t in enumerate(sorted(set(mix["targets"]))):  # warm-up: every size once
        serve(-1 - j, n_t)
    program.sync(system.device)
    draws.log.clear()
    draws.shapes.clear()
    run.setup_s = time.perf_counter() - t_start
    setup_peak = program.peak(system.device)
    program.reset_peak(system.device)

    t0 = time.perf_counter()
    i = 0
    while True:
        run.items.append(serve(i, sizes[i]))
        i += 1
        now = time.perf_counter()
        if now - t0 >= seconds:
            break
    run.window_s = now - t0
    run.peak_bytes = max(setup_peak, program.peak(system.device))
    lat = np.array([s.latency_s for s in run.items])
    run.e2e = {"request_p90_s": float(np.percentile(lat, 90)),
               "peak_mem_gib": program.peak(system.device) / program.GIB}
    run.attempted = run.done = i
    run.work = list(draws.shapes)
    if trace:
        def some_requests():
            for j in range(PROFILED):
                serve(10 ** 6 + j, sizes[j])
            return PROFILED

        run.profiled = program.profiled(some_requests, system.engine)
    return run
