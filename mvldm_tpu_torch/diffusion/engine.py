"""Diffusion engine, sampling half (counterpart of
``mvldm_tpu/diffusion/engine.py``): ray channels, VAE encode / decode, one
CFG denoise step, the DDIM loop, and the full encode -> sample -> decode
pipeline. The training loss comes with a later slice.

The modules own their parameters; random draws come from a caller's
``torch.Generator`` (or are passed in, as the parity tests do). Tensors are
in the JAX layout, (b, v, h, w, c).

CFG runs in one of three modes, numerically the same function:
"sequential" (conditional forward on ctx+tgt, unconditional on the targets
alone, the reference's form), "batched" (one forward with 2b rows, the
unconditional row's context views masked out of the joint attention), and
"auto" (batched when b <= 2, the JAX package's threshold, kept for parity).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch

from ..geometry.projection import get_world_rays, sample_image_grid
from ..models.encodings import positional_encoding, srt_ray_encode
from ..models.unet import MultiViewUNet, MultiViewUNetCfg
from ..models.vae import AutoencoderCfg, AutoencoderKL
from .schedulers import DDIMScheduler

VAE_SCALE = 0.18215  # SD VAE latent scaling


@dataclass
class RayEncodingsCfg:
    num_origin_octaves: int = 10
    num_direction_octaves: int = 8


@dataclass
class ModelCfg:
    """The sampling fields of the JAX package's ``ModelCfg`` (same names)."""

    denoiser: MultiViewUNetCfg = field(default_factory=MultiViewUNetCfg)
    autoencoder: AutoencoderCfg = field(default_factory=AutoencoderCfg)
    ray_encodings: RayEncodingsCfg = field(default_factory=RayEncodingsCfg)
    use_cfg: bool = False
    cfg_scale: float = 3.0
    use_ray_encoding: bool = True
    srt_ray_encoding: bool = False
    use_plucker: bool = False


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


class DiffusionEngine:
    def __init__(self, model_cfg: ModelCfg, unet: MultiViewUNet,
                 vae: AutoencoderKL, scheduler: DDIMScheduler,
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
        b, v, h, w, c = images.shape
        flat = images.reshape(b * v, h, w, c).to(self.device) * 2.0 - 1.0
        dist = self.vae.encode(flat)
        if noise is None:
            noise = randn(dist.mean.shape, generator, self.device)
        else:
            noise = noise.reshape(dist.mean.shape).to(self.device)
        latents = dist.sample(noise=noise) * VAE_SCALE
        return latents.reshape(b, v, h // 8, w // 8, -1)

    @torch.inference_mode()
    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """(b, v, h, w, 4) scaled latents -> (b, v, 8h, 8w, 3) in [0, 1]."""
        b, v, h, w, c = latents.shape
        flat = latents.reshape(b * v, h, w, c) / VAE_SCALE
        images = self.vae.decode(flat).reshape(b, v, h * 8, w * 8, -1)
        return torch.clamp(images / 2.0 + 0.5, 0.0, 1.0)

    # ----------------------------------------------------------------- rays

    def ray_encode(self, extrinsics: torch.Tensor, intrinsics: torch.Tensor,
                   latent_hw: Tuple[int, int]) -> torch.Tensor:
        """Per-view ray channels at latent resolution -> (b, v, h, w, c_ray)."""
        hl, wl = latent_hw
        extrinsics = extrinsics.to(self.device, torch.float32)
        intrinsics = intrinsics.to(self.device, torch.float32)
        xy, _ = sample_image_grid((hl, wl), device=self.device)
        xy = xy.reshape(1, 1, hl * wl, 2)
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

    # ------------------------------------------------------------- sampling

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

    @torch.inference_mode()
    def denoise_step(self, x_t: torch.Tensor, ts: int,
                     context_latents: torch.Tensor,
                     rays: torch.Tensor) -> torch.Tensor:
        """One CFG denoise step; returns x_{t-1} in f32."""
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
            pred = self.unet(torch.cat([inputs, inputs]),
                             torch.cat([timesteps, timesteps]),
                             view_mask=torch.cat([ones, uncond_mask]))
            pred_cond, pred_uncond = pred[:b, v_c:], pred[b:, v_c:]
            pred_out = pred_uncond + cfg.cfg_scale * (pred_cond - pred_uncond)
        elif cfg.use_cfg:
            pred_cond = self.unet(inputs, timesteps)
            pred_uncond = self.unet(inputs[:, v_c:], timesteps[:, v_c:])
            pred_out = pred_uncond + cfg.cfg_scale * (pred_cond[:, v_c:] - pred_uncond)
        else:
            pred_out = self.unet(inputs, timesteps)[:, v_c:]
        return self.scheduler.step(pred_out.float(), ts, x_t.float())

    @torch.inference_mode()
    def sample_latents(self, context_latents: torch.Tensor,
                       extrinsics: torch.Tensor, intrinsics: torch.Tensor,
                       num_target_views: int,
                       generator: Optional[torch.Generator] = None,
                       initial_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """DDIM loop. ``extrinsics`` / ``intrinsics`` cover ctx + tgt views in
        order; ``initial_noise`` (b, v_t, hl, wl, 4) replaces the N(0, 1)
        draw. Returns (b, v_t, hl, wl, 4) scaled latents in f32."""
        b, v_c, hl, wl, c = context_latents.shape
        context_latents = context_latents.to(self.device)
        if initial_noise is None:
            initial_noise = randn((b, num_target_views, hl, wl, c), generator,
                                  self.device)
        x_t = initial_noise.to(self.device, torch.float32) * self.scheduler.init_noise_sigma
        rays = self.ray_encode(extrinsics, intrinsics, (hl, wl))
        for ts in self.scheduler.timesteps():
            x_t = self.denoise_step(x_t, int(ts), context_latents, rays)
        return x_t

    @torch.inference_mode()
    def sample(self, context_images: torch.Tensor, extrinsics: torch.Tensor,
               intrinsics: torch.Tensor, num_target_views: int,
               generator: Optional[torch.Generator] = None,
               initial_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Encode the context, run DDIM, decode the targets.
        Returns (b, v_t, H, W, 3) images in [0, 1]."""
        context_latents = self.encode_images(context_images, generator)
        latents = self.sample_latents(context_latents, extrinsics, intrinsics,
                                      num_target_views, generator, initial_noise)
        return self.decode_latents(latents)
