"""The system under test, ``mvldm_tpu_torch``, and what the loops that
drive it share.

:class:`System` builds the program's engine the way its builder does
(modules on the meta device, materialised on the card) and loads the
benchmark's seeded weights into it. Each kind of traffic has its loop in
``kinds/<kind>.py``: it warms every shape its traffic uses inside
set-up, then measures for the run's seconds, and returns a :class:`Run`
with the end-to-end numbers and what the check of ``correct`` needs: the
inputs, the draws the program took from the run's generator, and its
outputs.

With ``trace`` a run goes on, after its measured window, with the spans of
``trace.py`` installed and the profiler on for a short profiled part
(:func:`profiled`).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from . import traffic, weights
from .trace import Spans, reduce, start_profile, stop_profile

GIB = float(1 << 30)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def dtype_of(config: Dict) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[config["dtype"]]


class System:
    """The program's engine on ``device`` with the seeded weights."""

    def __init__(self, config: Dict, shapes: Dict, seed: int, device):
        from mvldm_tpu_torch.builder import MVLDM
        from mvldm_tpu_torch.config import from_dict
        from mvldm_tpu_torch.diffusion.engine import DiffusionEngine, ModelCfg
        from mvldm_tpu_torch.diffusion.schedulers import get_scheduler

        self.device = torch.device(device)
        if self.device.type == "cuda":
            from mvldm_tpu_torch.ops import _build

            # The bf16 path's kernels, built at once (a no-op once built).
            _build.build([n for n in _build.SOURCES
                          if not n.startswith("micro") and n != "f32_route"])
        model_cfg = from_dict(ModelCfg, config["model"], "model")
        with torch.device("meta"):
            holder = MVLDM(model_cfg)
        holder = holder.to(dtype_of(config)).to_empty(device=self.device)
        named = dict(holder.named_parameters())
        if set(named) != set(shapes):
            raise ValueError("the program's parameters are not the published ones: "
                             f"{sorted(set(named) ^ set(shapes))[:8]}")
        made = weights.make(shapes, seed, self.device, dtype_of(config))
        with torch.no_grad():
            for name, p in named.items():
                p.copy_(made.pop(name))
        self.engine = DiffusionEngine(model_cfg, holder.eval().denoiser, holder.autoencoder,
                                      get_scheduler(model_cfg.scheduler))
        self.latent_channels = model_cfg.autoencoder.kwargs.latent_channels


class DrawLog:
    """Takes the sampling draws (the VAE posterior's eps, each launch's
    initial noise) from the run's generator in the program's own order and
    hands them to the program, keeping each, with its call's shape."""

    def __init__(self, engine, latent_channels: int):
        self.log: List[torch.Tensor] = []
        self.shapes: List[tuple] = []
        encode, sample = engine.encode_images, engine.sample_latents

        def encode_images(images, generator=None, noise=None):
            if noise is None:
                b, v, h, w, _ = images.shape
                noise = torch.randn((b * v, h // 8, w // 8, latent_channels),
                                    generator=generator, device=generator.device)
            self.log.append(noise)
            return encode(images, generator, noise)

        def sample_latents(context_latents, extrinsics, intrinsics, num_target_views,
                           generator=None, initial_noise=None, step_noise=None):
            b, v_c, hl, wl, c = context_latents.shape
            if initial_noise is None:
                initial_noise = torch.randn((b, num_target_views, hl, wl, c),
                                            generator=generator, device=generator.device)
            self.log.append(initial_noise)
            self.shapes.append((b, v_c, num_target_views))
            return sample(context_latents, extrinsics, intrinsics, num_target_views,
                          generator, initial_noise, step_noise)

        engine.encode_images = encode_images
        engine.sample_latents = sample_latents


@dataclass
class Run:
    kind: str
    unit: str  # what ``done`` counts: frames, requests, micro-steps
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    done: int = 0  # the units the window completed
    e2e: Dict[str, float] = field(default_factory=dict)
    peak_bytes: int = 0
    items: List[Any] = field(default_factory=list)  # what the check compares
    work: List[tuple] = field(default_factory=list)  # launch shapes / steps of the window
    profiled: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Served:
    """One scene or request: its views, what the program returned, and its
    draws (index range into the DrawLog)."""

    views: traffic.Views
    frames: Dict[int, np.ndarray]
    draws: List[torch.Tensor]
    latency_s: float = 0.0


def scene_views(views: traffic.Views):
    from mvldm_tpu_torch.diffusion.video_sampling import SceneViews

    n = len(views.images)
    ctx = SceneViews(views.images[:1], views.extrinsics[:1], views.intrinsics[:1], np.arange(1))
    tgt = SceneViews(views.images[1:], views.extrinsics[1:], views.intrinsics[1:],
                     np.arange(1, n))
    return ctx, tgt


def install_spans(spans: Spans, engine, tx=None) -> None:
    """Ranges around the engine instance's entry points, the optimizer's
    apply and the ``ops`` entry points that ``models/`` call, with the
    shapes the kernel readers need."""
    import mvldm_tpu_torch.models.layers as layers
    import mvldm_tpu_torch.models.standard_transformer as standard
    import mvldm_tpu_torch.ops.attention as ops_attention

    def attn_shapes(q, k, v, bias=None, scale=None):
        return (tuple(q.shape), tuple(k.shape), bias is not None)

    def fused_attn_shapes(x, *args, **kwargs):
        return (tuple(x.shape), args[7], args[8])

    def fused_ff_shapes(x, ln_scale, ln_bias, w1, *args, **kwargs):
        return (tuple(x.shape), w1.shape[1] // 2)

    def bwd_shapes(q, k, *args, **kwargs):
        return (tuple(q.shape), tuple(k.shape), args[1] is not None)

    spans.wrap(engine, "denoise_step", "denoise_step", lambda x_t, *a, **k: tuple(x_t.shape))
    spans.wrap(engine, "encode_images", "encode_images")
    spans.wrap(engine, "decode_latents", "decode_latents")
    spans.wrap(engine, "training_loss", "training_loss")
    if tx is not None:
        spans.wrap(tx, "apply", "optimizer_apply")
    for module in (layers, standard):
        spans.wrap(module, "attention", "attention", attn_shapes)
    spans.wrap(layers, "fused_ln_self_attention", "fused_ln_self_attention", fused_attn_shapes)
    spans.wrap(layers, "fused_ln_geglu_ff", "fused_ln_geglu_ff", fused_ff_shapes)
    spans.wrap(ops_attention, "flash_attention_bwd_dq", "flash_bwd_dq", bwd_shapes)
    spans.wrap(ops_attention, "flash_attention_bwd_dkv", "flash_bwd_dkv")


def profiled(part: Callable[[], int], engine, tx=None) -> Dict[str, Any]:
    """Run ``part`` (returns the units it completed) with the spans and the
    profiler on; the reduction of its events and its wall time."""
    spans = Spans()
    install_spans(spans, engine, tx)
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


def sampler(system: System, mix: Dict, seed: int):
    """The draw log, the mix's dispatch entry of a ``VideoSampler`` on the
    engine, and the run's generator."""
    from mvldm_tpu_torch.diffusion.video_sampling import VideoSampler

    draws = DrawLog(system.engine, system.latent_channels)
    video = VideoSampler(system.engine, num_anchors_views=mix["num_anchors_views"],
                         group_size=mix["group_size"],
                         max_parallel_groups=mix["max_parallel_groups"])
    dispatch = {"anchored": video.dispatch_anchored_many,
                "autoregressive": video.dispatch_autoregressive_many}[mix["sampler"]]
    return draws, dispatch, torch.Generator(system.device).manual_seed(seed)


def sampling_flops(counter, run: Run, config: Dict, mix: Dict) -> float:
    """Model FLOPs of the sampling launches a window ran (``run.work``:
    one (rows, context views, target views) a launch)."""
    steps = config["model"]["scheduler"]["num_inference_steps"]
    return sum(counter.launch(b, v_c, v_t, mix["hw"], steps) for b, v_c, v_t in run.work)
