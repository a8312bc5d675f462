"""Diffusion engine (counterpart of ``mvldm_tpu/diffusion/engine.py``): ray
channels, VAE encode / decode, the training loss, one CFG denoise step, the
DDIM or ancestral DDPM loop, and the full encode -> sample -> decode
pipeline.

The modules own their parameters; random draws come from a caller's
``torch.Generator`` (or are passed in, as the parity tests do: a training
step's draws are one :class:`TrainDraws`). Tensors are in the JAX layout,
(b, v, h, w, c). The sampling methods run under ``inference_mode``; the
training loss runs with autograd, the frozen VAE encode under ``no_grad``.

CFG runs in one of three modes, numerically the same function:
"sequential" (conditional forward on ctx+tgt, unconditional on the targets
alone, the reference's form), "batched" (one forward with 2b rows, the
unconditional row's context views masked out of the joint attention), and
"auto" (batched when b <= 2, the JAX package's threshold, kept for parity).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..geometry.camera_utils import absolute_to_relative_camera
from ..geometry.projection import get_world_rays, sample_image_grid
from ..models.encodings import positional_encoding, srt_ray_encode
from ..models.mvdream import MVDreamUNetCfg
from ..models.unet import MultiViewUNet, MultiViewUNetCfg
from ..models.vae import AutoencoderCfg, AutoencoderKL, DiagonalGaussian
from ..utils.profiling import span, sync
from .schedulers import DDPMScheduler, Scheduler, SchedulerCfg

VAE_SCALE = 0.18215  # SD VAE latent scaling


@dataclass
class RayEncodingsCfg:
    num_origin_octaves: int = 10
    num_direction_octaves: int = 8


@dataclass
class ModelCfg:
    """The JAX package's ``ModelCfg`` (same fields, same names; the configs
    set them all). ``ema`` / ``use_ema_sampling`` choose the EMA weights for
    sampling; ``use_ddim_scheduler`` and the xformers switch are read by
    nothing, there as here."""

    denoiser: Union[MultiViewUNetCfg, MVDreamUNetCfg] = field(
        default_factory=MultiViewUNetCfg)
    scheduler: Optional[SchedulerCfg] = None
    autoencoder: AutoencoderCfg = field(default_factory=AutoencoderCfg)
    ray_encodings: RayEncodingsCfg = field(default_factory=RayEncodingsCfg)
    use_cfg: bool = False
    cfg_scale: float = 3.0
    cfg_train: bool = True
    use_ray_encoding: bool = True
    srt_ray_encoding: bool = False
    use_ddim_scheduler: bool = False
    use_plucker: bool = False
    ema: bool = False
    use_ema_sampling: bool = False
    enable_xformers_memory_efficient_attention: bool = False


def ray_channel_count(cfg: ModelCfg) -> int:
    if cfg.srt_ray_encoding:
        return 2 * (cfg.ray_encodings.num_origin_octaves * 3
                    + cfg.ray_encodings.num_direction_octaves * 3)
    if cfg.use_ray_encoding:
        return 6 * (cfg.ray_encodings.num_origin_octaves
                    + cfg.ray_encodings.num_direction_octaves)
    return 3 + 3


def unet_in_channels(cfg: ModelCfg) -> int:
    """latent + ray channels + 1 mask channel."""
    return cfg.autoencoder.kwargs.latent_channels + ray_channel_count(cfg) + 1


def randn(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """N(0, 1) f32 drawn on the generator's device, moved to ``device``."""
    gdev = generator.device if generator is not None else "cpu"
    return torch.randn(shape, generator=generator, device=gdev).to(device)


@dataclass
class Batch:
    """A flattened multi-view batch: all views concatenated (context first).

    images: (b, v, h, w, 3) in [0, 1]; extrinsics: (b, v, 4, 4) c2w;
    intrinsics: (b, v, 3, 3) normalised; is_target: (b, v) bool.
    latent_moments: optional (b, v, h/8, w/8, 2c) VAE posterior moments; when
    set, the loss samples latents from them instead of encoding ``images``
    (which may then be None)."""

    images: Optional[torch.Tensor]
    extrinsics: torch.Tensor
    intrinsics: torch.Tensor
    is_target: torch.Tensor
    latent_moments: Optional[torch.Tensor] = None


@dataclass
class TrainDraws:
    """Every random draw of one training step, in the order of the JAX
    loss's keys: the context count and the permutation scores that pick the
    kept context views, absolute vs relative poses, the VAE posterior's eps,
    the noise, the timestep and CFG dropout. Tests rebuild them from the JAX
    keys; :meth:`draw` takes them from a ``torch.Generator``."""

    n_ctx: torch.Tensor          # (b,) int64 in [1, v_c]
    perm_scores: torch.Tensor    # (b, v_c) f32, U[0, 1)
    use_relative: torch.Tensor   # (b,) bool, p = 0.5
    posterior_eps: torch.Tensor  # (b, v, hl, wl, c_latent) f32, N(0, 1)
    noise: torch.Tensor          # (b, v, hl, wl, c_latent) f32, N(0, 1)
    t: torch.Tensor              # (b,) int64 in [0, num_train_timesteps)
    unconditional: torch.Tensor  # (b,) bool, p = 0.1

    @classmethod
    def draw(cls, b: int, v: int, v_c: int, latent_shape: Tuple[int, int, int],
             num_train_timesteps: int,
             generator: Optional[torch.Generator] = None) -> "TrainDraws":
        gen = generator
        dev = gen.device if gen is not None else "cpu"

        def uniform(*shape):
            return torch.rand(shape, generator=gen, device=dev)

        def normal(*shape):
            return torch.randn(shape, generator=gen, device=dev)

        return cls(
            n_ctx=torch.randint(1, v_c + 1, (b,), generator=gen, device=dev),
            perm_scores=uniform(b, v_c),
            use_relative=uniform(b) < 0.5,
            posterior_eps=normal(b, v, *latent_shape),
            noise=normal(b, v, *latent_shape),
            t=torch.randint(0, num_train_timesteps, (b,), generator=gen, device=dev),
            unconditional=uniform(b) < 0.1,
        )

    def to(self, device) -> "TrainDraws":
        return TrainDraws(**{k: getattr(self, k).to(device)
                             for k in self.__dataclass_fields__})


class DiffusionEngine:
    def __init__(self, model_cfg: ModelCfg, unet: MultiViewUNet,
                 vae: AutoencoderKL, scheduler: Scheduler,
                 cfg_mode: str = "auto"):
        if cfg_mode not in ("sequential", "batched", "auto"):
            raise ValueError(f"cfg_mode {cfg_mode!r}")
        self.cfg = model_cfg
        self.unet = unet
        self.vae = vae
        self.scheduler = scheduler
        self.cfg_mode = cfg_mode

    @property
    def device(self) -> torch.device:
        return self.unet.unet.conv_in.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.unet.unet.conv_in.weight.dtype

    def _resolve_cfg_mode(self, b: int) -> str:
        if self.cfg_mode != "auto":
            return self.cfg_mode
        return "batched" if b <= 2 else "sequential"

    # ------------------------------------------------------------------ VAE

    @torch.inference_mode()
    def encode_images(self, images: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(b, v, h, w, 3) in [0, 1] -> (b, v, h/8, w/8, 4) scaled latents,
        sampled from the posterior with ``noise`` or the generator."""
        return self._encode(images, generator, noise)

    @span("engine.encode")
    def _encode(self, images: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, v, h, w, c = images.shape
        flat = images.reshape(b * v, h, w, c).to(self.device) * 2.0 - 1.0
        dist = self.vae.encode(flat)
        if noise is None:
            noise = randn(dist.mean.shape, generator, self.device)
        else:
            noise = noise.reshape(dist.mean.shape).to(self.device)
        latents = dist.sample(noise=noise) * VAE_SCALE
        return latents.reshape(b, v, h // 8, w // 8, -1)

    @span("engine.decode")
    @torch.inference_mode()
    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """(b, v, h, w, 4) scaled latents -> (b, v, 8h, 8w, 3) in [0, 1]."""
        b, v, h, w, c = latents.shape
        flat = latents.reshape(b * v, h, w, c) / VAE_SCALE
        images = self.vae.decode(flat).reshape(b, v, h * 8, w * 8, -1)
        return torch.clamp(images / 2.0 + 0.5, 0.0, 1.0)

    # ----------------------------------------------------------------- rays

    @span("engine.ray_encode")
    def ray_encode(self, extrinsics: torch.Tensor, intrinsics: torch.Tensor,
                   latent_hw: Tuple[int, int]) -> torch.Tensor:
        """Per-view ray channels at latent resolution -> (b, v, h, w, c_ray)."""
        hl, wl = latent_hw
        extrinsics = extrinsics.to(self.device, torch.float32)
        intrinsics = intrinsics.to(self.device, torch.float32)
        xy, _ = sample_image_grid((hl, wl), device=self.device)
        xy = xy.reshape(1, 1, hl * wl, 2)
        with sync("world_rays"):
            origins, directions = get_world_rays(
                xy, extrinsics[:, :, None], intrinsics[:, :, None])
        if self.cfg.use_plucker:
            origins = torch.cross(origins, directions, dim=-1)
        rc = self.cfg.ray_encodings
        if self.cfg.srt_ray_encoding:
            enc = srt_ray_encode(origins, directions, rc.num_origin_octaves,
                                 rc.num_direction_octaves)
        elif self.cfg.use_ray_encoding:
            parts = []
            if rc.num_origin_octaves > 0:
                parts.append(positional_encoding(origins, rc.num_origin_octaves))
            if rc.num_direction_octaves > 0:
                parts.append(positional_encoding(directions, rc.num_direction_octaves))
            enc = torch.cat(parts, dim=-1)
        else:
            enc = torch.cat([origins, directions], dim=-1)
        b, v = extrinsics.shape[:2]
        return enc.reshape(b, v, hl, wl, -1).to(self.dtype)

    # ------------------------------------------------------------- training

    @span("engine.training_loss")
    def training_loss(self, batch: Batch, num_context_views: int,
                      draws: Optional[TrainDraws] = None,
                      generator: Optional[torch.Generator] = None,
                      count_reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Noise-prediction MSE over the target views, in f32 (the JAX
        ``training_loss``). The first ``num_context_views`` views are the
        nominal context, of which a random non-empty subset stays context;
        ``draws`` (or ``generator``) supplies every random draw. Under data
        parallelism ``count_reduce`` sums the target-view count over the
        data ranks, so each rank's loss is its share of the global batch's
        mean, as the JAX loss over a data-sharded batch is."""
        cfg = self.cfg
        dev = self.device
        b, v = batch.extrinsics.shape[:2]
        v_c = num_context_views
        if batch.latent_moments is not None:
            hl, wl = batch.latent_moments.shape[2:4]
        else:
            hl, wl = batch.images.shape[2] // 8, batch.images.shape[3] // 8
        if draws is None:
            draws = TrainDraws.draw(
                b, v, v_c, (hl, wl, cfg.autoencoder.kwargs.latent_channels),
                self.scheduler.num_train_timesteps, generator)
        d = draws.to(dev)

        # Context count: the views of the first n_ctx ranks of a random
        # permutation of the context slots stay context.
        ctx_rank = torch.argsort(torch.argsort(d.perm_scores, dim=-1), dim=-1)
        ctx_keep = ctx_rank < d.n_ctx[:, None]
        is_target = torch.cat(
            [~ctx_keep, torch.ones((b, v - v_c), dtype=torch.bool, device=dev)], dim=1)

        # Absolute vs relative poses; the reference view is a kept context slot.
        extrinsics = batch.extrinsics.to(dev, torch.float32)
        rel_index = torch.where(ctx_keep, d.perm_scores, torch.inf).argmin(dim=-1)
        with sync("relative_pose"):
            relative = absolute_to_relative_camera(extrinsics, rel_index)
        extrinsics = torch.where(d.use_relative[:, None, None, None], relative, extrinsics)

        # Frozen VAE: no gradient, and no inference-mode tensors in the graph.
        with torch.no_grad():
            if batch.latent_moments is not None:
                moments = batch.latent_moments.to(dev, self.dtype)
                dist = DiagonalGaussian(moments.reshape(b * v, hl, wl, -1))
                z = dist.sample(noise=d.posterior_eps.reshape(dist.mean.shape))
                latents = (z * VAE_SCALE).reshape(b, v, hl, wl, -1)
            else:
                latents = self._encode(batch.images, noise=d.posterior_eps)

        noise = d.noise.to(latents.dtype)
        noisy = self.scheduler.add_noise(
            latents.reshape(b, -1), noise.reshape(b, -1), d.t).reshape(latents.shape)
        latents_in = torch.where(is_target[:, :, None, None, None], noisy, latents)

        unconditional = d.unconditional & cfg.cfg_train
        view_mask = is_target | ~unconditional[:, None]

        rays = self.ray_encode(extrinsics, batch.intrinsics, (hl, wl))
        mask_ch = is_target.to(self.dtype)[:, :, None, None, None].expand(b, v, hl, wl, 1)
        inputs = torch.cat([latents_in.to(self.dtype), mask_ch, rays], dim=-1)
        timesteps = torch.where(is_target, d.t[:, None], 0)
        pred = self._unet("train", inputs, timesteps, view_mask)

        per_view = ((pred.float() - noise.float()) ** 2).mean(dim=(2, 3, 4))
        count = is_target.sum()
        if count_reduce is not None:
            count = count_reduce(count)
        loss = (per_view * is_target).sum() / count.clamp_min(1)
        return loss, {"loss/diffusion": loss}

    # ------------------------------------------------------------- sampling

    def _unet(self, branch: str, inputs: torch.Tensor, timesteps: torch.Tensor,
              view_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One UNet call, spanned with its CFG branch."""
        with span("engine.unet", {"branch": branch}):
            return self.unet(inputs, timesteps, view_mask=view_mask)

    def _unet_inputs(self, context_latents: torch.Tensor, x_t: torch.Tensor,
                     rays: torch.Tensor) -> torch.Tensor:
        """[latents | mask | rays] for ctx + tgt views."""
        b, v_c = context_latents.shape[:2]
        v_t = x_t.shape[1]
        hl, wl = x_t.shape[2:4]
        lat = torch.cat([context_latents.to(x_t.dtype), x_t], dim=1)
        mask = torch.cat([
            torch.zeros((b, v_c, hl, wl, 1), dtype=lat.dtype, device=lat.device),
            torch.ones((b, v_t, hl, wl, 1), dtype=lat.dtype, device=lat.device),
        ], dim=1)
        return torch.cat([lat.to(self.dtype), mask.to(self.dtype), rays], dim=-1)

    @span("engine.denoise_step")
    @torch.inference_mode()
    def denoise_step(self, x_t: torch.Tensor, ts: int,
                     context_latents: torch.Tensor, rays: torch.Tensor,
                     step_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One CFG denoise step; returns x_{t-1} in f32. ``step_noise`` is
        DDPM's ancestral N(0, 1) draw (DDIM takes none)."""
        cfg = self.cfg
        b, v_c = context_latents.shape[:2]
        v_t = x_t.shape[1]
        dev = x_t.device
        inputs = self._unet_inputs(
            context_latents, self.scheduler.scale_model_input(x_t, ts), rays)
        timesteps = torch.cat([
            torch.zeros((b, v_c), dtype=torch.int64, device=dev),
            torch.full((b, v_t), int(ts), dtype=torch.int64, device=dev),
        ], dim=1)
        if cfg.use_cfg and self._resolve_cfg_mode(b) == "batched":
            ones = torch.ones((b, v_c + v_t), dtype=torch.bool, device=dev)
            uncond_mask = ones.clone()
            uncond_mask[:, :v_c] = False
            pred = self._unet("batched", torch.cat([inputs, inputs]),
                              torch.cat([timesteps, timesteps]),
                              torch.cat([ones, uncond_mask]))
            pred_cond, pred_uncond = pred[:b, v_c:], pred[b:, v_c:]
            pred_out = pred_uncond + cfg.cfg_scale * (pred_cond - pred_uncond)
        elif cfg.use_cfg:
            pred_cond = self._unet("cond", inputs, timesteps)
            pred_uncond = self._unet("uncond", inputs[:, v_c:], timesteps[:, v_c:])
            pred_out = pred_uncond + cfg.cfg_scale * (pred_cond[:, v_c:] - pred_uncond)
        else:
            pred_out = self._unet("cond", inputs, timesteps)[:, v_c:]
        if isinstance(self.scheduler, DDPMScheduler):
            return self.scheduler.step(pred_out.float(), ts, x_t.float(), noise=step_noise)
        return self.scheduler.step(pred_out.float(), ts, x_t.float())

    @span("engine.sample_latents")
    @torch.inference_mode()
    def sample_latents(self, context_latents: torch.Tensor,
                       extrinsics: torch.Tensor, intrinsics: torch.Tensor,
                       num_target_views: int,
                       generator: Optional[torch.Generator] = None,
                       initial_noise: Optional[torch.Tensor] = None,
                       step_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The sampling loop. ``extrinsics`` / ``intrinsics`` cover ctx + tgt
        views in order; ``initial_noise`` (b, v_t, hl, wl, 4) replaces the
        N(0, 1) draw and, for DDPM, ``step_noise`` (steps, b, v_t, hl, wl,
        4) the per-step draws, which otherwise come from ``generator`` after
        the initial noise, one a step. Returns (b, v_t, hl, wl, 4) scaled
        latents in f32."""
        b, v_c, hl, wl, c = context_latents.shape
        shape = (b, num_target_views, hl, wl, c)
        context_latents = context_latents.to(self.device)
        if initial_noise is None:
            initial_noise = randn(shape, generator, self.device)
        x_t = initial_noise.to(self.device, torch.float32) * self.scheduler.init_noise_sigma
        rays = self.ray_encode(extrinsics, intrinsics, (hl, wl))
        ancestral = isinstance(self.scheduler, DDPMScheduler)
        for i, ts in enumerate(self.scheduler.timesteps()):
            noise = None
            if ancestral:
                noise = (randn(shape, generator, self.device) if step_noise is None
                         else step_noise[i].to(self.device))
            x_t = self.denoise_step(x_t, int(ts), context_latents, rays, noise)
        return x_t

    @torch.inference_mode()
    def sample(self, context_images: torch.Tensor, extrinsics: torch.Tensor,
               intrinsics: torch.Tensor, num_target_views: int,
               generator: Optional[torch.Generator] = None,
               initial_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Encode the context, run the sampling loop, decode the targets.
        Returns (b, v_t, H, W, 3) images in [0, 1]."""
        context_latents = self.encode_images(context_images, generator)
        latents = self.sample_latents(context_latents, extrinsics, intrinsics,
                                      num_target_views, generator, initial_noise)
        return self.decode_latents(latents)

    # -------------------------------------------------------- text to views

    @torch.inference_mode()
    def text_to_multiview(self, text: torch.Tensor, empty_text: torch.Tensor,
                          cameras: torch.Tensor, initial_noise: torch.Tensor) -> torch.Tensor:
        """MVDream's text-to-multiview sampling (its ``t2i``): P prompts'
        text tokens (P, Lt, c_ctx), the empty prompt's (Lt, c_ctx), each
        prompt's V cameras (P, V, camera_dim: flattened camera-to-world
        matrices) and the initial noise (P, V, h, w, c) -> (P, V, 8h, 8w, 3)
        uint8 frames on the device, truncated as ``VideoSampler``
        quantizes; :meth:`gather_frames` brings them to the host.

        DDIM (eta 0) over the scheduler's timesteps with guidance
        (``use_cfg``): a step is one UNet call of 2P rows, the prompts' and
        then the empty prompt's, as MVDream's DDIM sampler batches it. The
        inputs are uploaded once (``sync.t2mv_upload``); no step holds the
        host."""
        if not self.cfg.use_cfg:
            raise ValueError("text_to_multiview samples with guidance (use_cfg)")
        p, v = cameras.shape[:2]
        steps = self.scheduler.timesteps()
        with span("engine.t2mv", {"prompts": p, "views": v, "steps": len(steps)}):
            with sync("t2mv_upload"):
                text, empty_text, cameras, noise = (
                    t.to(self.device) for t in (text, empty_text, cameras, initial_noise))
            x_t = noise.float() * self.scheduler.init_noise_sigma
            context = torch.cat([text, empty_text.expand(p, -1, -1)])
            cameras = torch.cat([cameras, cameras])
            for ts in steps:
                x_t = self.text_denoise_step(x_t, int(ts), context, cameras)
            return (self.decode_latents(x_t) * 255.0).to(torch.uint8)

    @torch.inference_mode()
    def text_denoise_step(self, x_t: torch.Tensor, ts: int, context: torch.Tensor,
                          cameras: torch.Tensor) -> torch.Tensor:
        """One step of :meth:`text_to_multiview`: x_t (P, V, h, w, c) f32 ->
        x_{t-1} in f32. ``context`` and ``cameras`` hold 2P rows, the
        prompts' first; guidance is combined in f32."""
        p = x_t.shape[0]
        inputs = self.scheduler.scale_model_input(x_t, ts).to(self.dtype)
        inputs = torch.cat([inputs, inputs])
        timesteps = torch.full(inputs.shape[:2], ts, dtype=torch.int64, device=x_t.device)
        with span("engine.unet", {"branch": "batched"}):
            eps = self.unet(inputs, timesteps, context, cameras).float()
        eps = eps[p:] + self.cfg.cfg_scale * (eps[:p] - eps[p:])
        return self.scheduler.step(eps, ts, x_t.float())

    @staticmethod
    def gather_frames(frames: torch.Tensor) -> np.ndarray:
        """:meth:`text_to_multiview`'s frames on the host (``sync.t2mv_gather``)."""
        with sync("t2mv_gather"):
            return frames.cpu().numpy()
