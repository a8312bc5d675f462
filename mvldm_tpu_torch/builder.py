"""The flagship configuration with seeded random weights (counterpart of
``build_flagship`` in the repository's ``bench.py``): the SD2.1 multi-view
UNet (0.93B parameters) with 8-head cross-view blocks, the SD2.1 VAE, raw
3+3 ray channels (11 UNet input channels), CFG 3.0 and 25 DDIM steps;
:func:`build_flagship_train` is the same model for training and
:func:`make_train_batch` the repository's synthetic training batch.

Released weights are not part of the repository, so the weights are drawn
from a seeded ``torch.Generator`` on the host (the same values on every
device and dtype): linear and conv weights N(0, 1/fan_in), biases zero,
norm scales one. Every cross-view block's ``proj_out`` is random too; its
reference zero init would make each cross-view block an identity and leave
the joint-attention kernel without effect on the output.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from .diffusion.engine import Batch, DiffusionEngine, ModelCfg, unet_in_channels
from .diffusion.schedulers import DDIMScheduler, DDIMSchedulerKwargs
from .models.mv_attention import SpatialTransformer3DCfg
from .models.unet import MultiViewUNet, MultiViewUNetCfg
from .models.vae import AutoencoderCfg, AutoencoderKL, AutoencoderKLCfg

NUM_STEPS = 25
IMAGE_HW = 256


class MVLDM(nn.Module):
    """Holder with the reference Lightning checkpoint's module tree:
    ``denoiser`` (UNet + cross-view blocks) and ``autoencoder``."""

    def __init__(self, model_cfg: ModelCfg):
        super().__init__()
        self.denoiser = MultiViewUNet(model_cfg.denoiser,
                                      in_channels=unet_in_channels(model_cfg),
                                      out_channels=4)
        self.autoencoder = AutoencoderKL(model_cfg.autoencoder.kwargs)


def flagship_model_cfg() -> ModelCfg:
    return ModelCfg(
        denoiser=MultiViewUNetCfg(
            multi_view_attention=SpatialTransformer3DCfg(num_heads=8)),
        autoencoder=AutoencoderCfg(kwargs=AutoencoderKLCfg()),
        use_cfg=True,
        cfg_scale=3.0,
        use_ray_encoding=False,  # live baseline: raw 3+3 ray channels
    )


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> None:
    """Seeded random weights, drawn on the host in a fixed parameter order."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in sorted(model.named_parameters()):
        if name.endswith("bias"):
            p.zero_()
        elif p.dim() == 1:  # GroupNorm / LayerNorm scale
            p.fill_(1.0)
        else:
            fan_in = p[0].numel()
            p.copy_(torch.randn(p.shape, generator=gen) / fan_in ** 0.5)


def build_flagship(device="cuda", dtype: torch.dtype = torch.bfloat16,
                   seed: int = 0, cfg_mode: str = "auto") -> DiffusionEngine:
    """The flagship engine on ``device`` in ``dtype`` with seeded weights."""
    model_cfg = flagship_model_cfg()
    model = MVLDM(model_cfg)
    init_weights(model, seed)
    model = model.to(device=device, dtype=dtype).eval()
    scheduler = DDIMScheduler.create(
        DDIMSchedulerKwargs(clip_sample=False, prediction_type="epsilon"),
        num_inference_steps=NUM_STEPS,
    )
    return DiffusionEngine(model_cfg, model.denoiser, model.autoencoder,
                           scheduler, cfg_mode=cfg_mode)


def build_flagship_train(device="cuda", seed: int = 0, remat: bool = False
                         ) -> DiffusionEngine:
    """The seeded flagship of :func:`build_flagship`, for training: the UNet
    computes in bf16 (its f32 masters live in the train state) and
    rematerialises its blocks under ``remat``; the VAE is frozen."""
    engine = build_flagship(device, torch.bfloat16, seed)
    engine.unet.remat = remat
    engine.vae.requires_grad_(False)
    return engine


def make_train_batch(b: int, v: int = 5) -> Batch:
    """The synthetic flagship training batch of ``bench.py``: 2 context +
    ``v - 2`` target views of uniform random pixels at 256 px, cameras
    translating along x, on the host."""
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.uniform(size=(b, v, IMAGE_HW, IMAGE_HW, 3)).astype(np.float32))
    extr = torch.eye(4).repeat(b, v, 1, 1)
    extr[:, :, 0, 3] = torch.linspace(0, 1, v)
    intr = torch.eye(3).repeat(b, v, 1, 1)
    intr[:, :, 0, 2] = intr[:, :, 1, 2] = 0.5
    is_target = torch.tensor([[False, False] + [True] * (v - 2)] * b)
    return Batch(images=images, extrinsics=extr, intrinsics=intr, is_target=is_target)
