"""Traffic kind ``t2mv``: MVDream's text-to-multiview requests in a closed
loop, one client. A dispatch is ``prompts`` prompts x ``views`` orbit views
at ``hw`` px through ``DiffusionEngine.text_to_multiview``: DDIM with
batched guidance, then the VAE decode, its uint8 frames gathered to the
host.

Each prompt's text tokens, (``text_tokens``, context_dim), are N(0, 1),
drawn in the text tower's place (its output is layer-normed), and the
run has one empty prompt's. A dispatch's draws come from a generator of
its own on the device, seeded from the run's seed and the dispatch's
index, so the check makes the program's draws again and the window keeps
nothing on the device. The cameras are MVDream's orbit
(``camera_utils.get_camera``): ``views`` azimuths evenly apart from a
start drawn in [0, 360) degrees, an elevation drawn from
``elevation_deg`` a prompt, radius 1, OpenGL axes turned to Blender's,
each 4 x 4 camera-to-world matrix flattened to 16, made on the host.

As in ``scenes``, dispatch k + 1 is made before dispatch k is gathered;
once ``seconds`` have passed none is made any more, the one in flight is
gathered and counted, and the window closes when it has come back.

The check reruns ``check.prompts`` prompts of the window, each in a
prompt slot of its own (all of them where ``check.prompts`` is
``prompts``), each slot's dispatch drawn from the seed, in the reference
(``reference/mvdream.py``, one batch for all of them) on the program's
draws and compares the frames: ``frame_rms``, the worst frame's RMS gap
in 8-bit levels. The control's readings: the fp8 reference, or a planted
fault (``per_frame_attn1``, ``no_text``, ``no_camera``), in the program's
place, judged by the float32 reference.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import check as checks, program, traffic
from ..reference import mvdream
from ..reference.numerics import no_tf32
from ..trace import Spans, reduce, start_profile, stop_profile

UNIT = "frames"
DRAW_STREAM = 5 << 20  # a dispatch's device draws
CAMERA_STREAM = 6 << 20  # a dispatch's cameras
EMPTY = -1  # the draw index of the run's empty-prompt tokens
FAULTS = {"per_frame_attn1": "joint_views", "no_text": "use_text", "no_camera": "use_camera"}


@dataclass
class Served:
    """One dispatch: its index (its draws and cameras) and its frames on
    the host, (prompts, views, hw, hw, 3) uint8."""

    index: int
    frames: np.ndarray


def generator(seed: int, index: int, device) -> torch.Generator:
    """The device generator of dispatch ``index`` (``EMPTY``: the run's
    empty prompt)."""
    sub = int(traffic.rng(seed, DRAW_STREAM, index).integers(1 << 62))
    return torch.Generator(device).manual_seed(sub)


def draws(mix: Dict, config: Dict, seed: int, index: int, device):
    """Dispatch ``index``'s text tokens (P, Lt, c_ctx) and initial noise
    (P, V, hw / 8, hw / 8, c), in that order from its generator."""
    gen = generator(seed, index, device)
    d = config["model"]["denoiser"]
    p, v, hl = mix["prompts"], mix["views"], mix["hw"] // 8
    latent = config["model"]["autoencoder"]["kwargs"]["latent_channels"]
    text = torch.randn((p, mix["text_tokens"], d["context_dim"]), generator=gen, device=device)
    noise = torch.randn((p, v, hl, hl, latent), generator=gen, device=device)
    return text, noise


def empty_text(mix: Dict, config: Dict, seed: int, device) -> torch.Tensor:
    gen = generator(seed, EMPTY, device)
    return torch.randn((mix["text_tokens"], config["model"]["denoiser"]["context_dim"]),
                       generator=gen, device=device)


def camera_to_world(elevation: float, azimuth: float) -> np.ndarray:
    """MVDream's ``create_camera_to_world_matrix`` then
    ``convert_opengl_to_blender``: a camera at radius 1 looking at the
    origin, in degrees."""
    el, az = np.radians(elevation), np.radians(azimuth)
    pos = np.array([np.cos(el) * np.sin(az), np.sin(el), np.cos(el) * np.cos(az)])
    forward = -pos / np.linalg.norm(pos)
    right = np.cross(forward, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, forward)
    up /= np.linalg.norm(up)
    c2w = np.eye(4)
    c2w[:3, :3] = np.stack([right, up, -forward]).T
    c2w[:3, 3] = pos
    flip_yz = np.array([[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.float64)
    return flip_yz @ c2w


def cameras(mix: Dict, seed: int, index: int) -> np.ndarray:
    """Dispatch ``index``'s (P, V, 16) float32 orbit cameras."""
    gen = traffic.rng(seed, CAMERA_STREAM, index)
    lo, hi = mix["elevation_deg"]
    out = np.empty((mix["prompts"], mix["views"], 16), dtype=np.float32)
    for p in range(mix["prompts"]):
        start, elevation = gen.uniform(0.0, 360.0), gen.uniform(lo, hi)
        for j in range(mix["views"]):
            out[p, j] = camera_to_world(elevation, start + 360.0 * j / mix["views"]).reshape(16)
    return out


def flops(counter, run: program.Run, config: Dict, mix: Dict) -> float:
    """Model FLOPs of the window's dispatches (``run.work``: one (prompts,
    views) a dispatch): each step one UNet forward over the prompts' and
    the empty prompt's rows (the text keys and values projected once a
    row), then the decode of every frame; no text tower."""
    steps = config["model"]["scheduler"]["num_inference_steps"]
    lat = mix["hw"] // 8
    return sum(steps * counter.unet(2 * p, v, lat) + counter.decode(p * v, mix["hw"])
               for p, v in run.work)


def drive(system: program.System, mix: Dict, config: Dict, shapes: Dict, seed: int,
          seconds: float, trace: bool, t_start: float) -> program.Run:
    engine, dev = system.engine, system.device
    p, v = mix["prompts"], mix["views"]
    empty = empty_text(mix, config, seed, dev)

    def start(i: int):
        text, noise = draws(mix, config, seed, i, dev)
        return i, engine.text_to_multiview(text, empty, torch.from_numpy(cameras(mix, seed, i)),
                                           noise)

    def finish(started) -> Served:
        i, frames = started
        return Served(i, engine.gather_frames(frames))

    run = program.Run("t2mv", UNIT)
    finish(start(-2))  # warm-up: the one launch shape
    program.sync(dev)
    run.setup_s = time.perf_counter() - t_start
    setup_peak = program.peak(dev)
    program.reset_peak(dev)

    t0 = time.perf_counter()
    k = 0
    started = start(0)
    while started is not None:
        nxt = start(k + 1) if time.perf_counter() - t0 < seconds else None
        run.items.append(finish(started))
        k += 1
        started = nxt
    run.window_s = time.perf_counter() - t0
    run.peak_bytes = max(setup_peak, program.peak(dev))
    run.e2e = {"frames_per_s": k * p * v / run.window_s,
               "peak_mem_gib": program.peak(dev) / program.GIB}
    run.attempted = k
    run.done = k * p * v
    run.work = [(p, v)] * k
    if trace:
        def one_dispatch():
            finish(start(10 ** 6))
            return p * v

        run.profiled = profiled(one_dispatch, engine)
    return run


def profiled(part, engine) -> Dict:
    """``program.profiled`` with two ranges more: ``t2mv_denoise_step``
    around the engine's ``text_denoise_step`` and ``text_cross_attention``
    around the text cross-attention's core (``layers.text_cross_attention``,
    with the shapes its reader needs)."""
    import mvldm_tpu_torch.models.layers as layers

    def xattn_shapes(q, k, v):
        return (tuple(q.shape), tuple(k.shape), False)

    spans = Spans()
    program.install_spans(spans, engine)
    spans.wrap(engine, "text_denoise_step", "t2mv_denoise_step")
    spans.wrap(layers, "text_cross_attention", "text_cross_attention", xattn_shapes)
    try:
        torch.cuda.synchronize()
        prof = start_profile()
        spans.recording = True
        t0 = time.perf_counter()
        done = part()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        spans.recording = False
        events = stop_profile(prof)
    finally:
        spans.restore()
    out = reduce(events)
    out.update(window_s=wall, done=done, calls=dict(spans.calls))
    return out


def picked(run: program.Run, mix: Dict, seed: int) -> List[tuple]:
    """(dispatch, prompt) pairs the check reruns, drawn from the seed: the
    prompt slots, ``check.prompts`` of them, all different, each with a
    dispatch of the window."""
    gen = traffic.rng(seed, checks.SAMPLE_STREAM)
    slots = gen.choice(mix["prompts"], min(mix["check"]["prompts"], mix["prompts"]),
                       replace=False)
    return sorted((run.items[int(gen.integers(len(run.items)))].index, int(r)) for r in slots)


def reference_frames(model, config: Dict, mix: Dict, seed: int, pairs: List[tuple],
                     device) -> Dict[tuple, np.ndarray]:
    """The reference's (views, hw, hw, 3) frames of each (dispatch, prompt),
    all pairs sampled as one batch."""
    pairs = sorted(pairs)
    ddim = mvdream.DDIM.from_cfg(config["model"]["scheduler"])
    empty = empty_text(mix, config, seed, device)
    text, noise, cams = [], [], []
    for i in sorted({i for i, _ in pairs}):
        rows = [r for j, r in pairs if j == i]
        t, n = draws(mix, config, seed, i, device)
        text.append(t[rows])
        noise.append(n[rows])
        cams.append(torch.from_numpy(cameras(mix, seed, i)[rows]))
    frames = mvdream.sample(model, ddim, config["model"]["cfg_scale"], torch.cat(text), empty,
                            torch.cat(cams).to(device), torch.cat(noise)).cpu().numpy()
    return {pair: frames[j] for j, pair in enumerate(pairs)}


def worst(got: Dict[tuple, np.ndarray], want: Dict[tuple, np.ndarray]) -> float:
    out = 0.0
    for key, frames in want.items():
        have = got.get(key)
        if have is None or have.shape != frames.shape:
            return math.inf
        out = max([out] + [checks.frame_rms(have[j], frames[j]) for j in range(len(frames))])
    return out


def check(run: program.Run, config: Dict, mix: Dict, seed: int, device) -> Dict[str, float]:
    pairs = picked(run, mix, seed)
    served = {s.index: s.frames for s in run.items}
    got = {(i, r): served[i][r] for i, r in pairs}
    model = checks.reference_model(config, seed, device)
    with torch.no_grad(), no_tf32():
        want = reference_frames(model, config, mix, seed, pairs, device)
    return {"frame_rms": worst(got, want)}


def control(config: Dict, mix: Dict, seed: int, device,
            fault: Optional[str] = None) -> Dict[str, float]:
    """The fp8 reference (``fault`` None or ``fp8``) or the float32 one with
    a part switched off (``FAULTS``) serves the first ``check.prompts``
    prompt slots of dispatch 0; the float32 reference judges them."""
    fault = fault or "fp8"
    if fault != "fp8" and fault not in FAULTS:
        raise ValueError(f"a t2mv cell has no planted fault {fault!r}")
    pairs = [(0, r) for r in range(min(mix["check"]["prompts"], mix["prompts"]))]
    ref = checks.reference_model(config, seed, device)
    low = checks.reference_model(config, seed, device, fp8=(fault == "fp8"))
    if fault in FAULTS:
        low.denoiser.faults[FAULTS[fault]] = False
    with torch.no_grad(), no_tf32():
        got = reference_frames(low, config, mix, seed, pairs, device)
        want = reference_frames(ref, config, mix, seed, pairs, device)
    return {"frame_rms": worst(got, want)}
