"""Model and engine construction (counterpart of ``mvldm_tpu/builder.py``
and of ``build_flagship`` in the repository's ``bench.py``).

:func:`build_engine` builds the engine a typed ``RootCfg`` describes, on a
device, with the seeded weights of :func:`init_params`;
:func:`load_pretrained` then loads a reference Lightning ``.ckpt`` by
``load_state_dict`` (the port's modules carry its key names).

:func:`build_flagship` is the flagship written in code: the SD2.1
multi-view UNet (0.93B parameters) with 8-head cross-view blocks, the SD2.1
VAE, raw 3+3 ray channels (11 UNet input channels), CFG 3.0 and 25 DDIM
steps, the model ``+experiment=baseline`` builds;
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

import re
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from .diffusion.engine import Batch, DiffusionEngine, ModelCfg, unet_in_channels
from .diffusion.schedulers import DDIMScheduler, DDIMSchedulerKwargs, get_scheduler
from .models.mv_attention import SpatialTransformer3DCfg
from .models.unet import MultiViewUNet, MultiViewUNetCfg
from .models.vae import AutoencoderCfg, AutoencoderKL, AutoencoderKLCfg

NUM_STEPS = 25
IMAGE_HW = 256


class MVLDM(nn.Module):
    """Holder with the reference Lightning checkpoint's module tree:
    ``denoiser`` (UNet + cross-view blocks) and ``autoencoder``."""

    def __init__(self, model_cfg: ModelCfg, remat: bool = False,
                 remat_policy: Optional[str] = None):
        super().__init__()
        self.denoiser = MultiViewUNet(model_cfg.denoiser,
                                      in_channels=unet_in_channels(model_cfg),
                                      out_channels=4, remat=remat,
                                      remat_policy=remat_policy)
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
def init_params(model: nn.Module, seed: int) -> None:
    """The port's seeded initialisation, in place: random weights drawn on
    the host in a fixed parameter order, whatever the model's device."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in sorted(model.named_parameters()):
        if name.endswith("bias"):
            p.zero_()
        elif p.dim() == 1:  # GroupNorm / LayerNorm scale
            p.fill_(1.0)
        else:
            fan_in = p[0].numel()
            p.copy_(torch.randn(p.shape, generator=gen) / fan_in ** 0.5)


def resolve_dtype(precision) -> torch.dtype:
    """The reference's Lightning precision tokens as torch dtypes; the
    16-bit ones map to bf16, as in the JAX package."""
    if precision in (None, "32", "32-true", 32):
        return torch.float32
    if precision in ("bf16", "bf16-mixed", "bf16-true", "16-mixed", "16", "16-true", 16):
        return torch.bfloat16
    if precision in ("64", "64-true", 64):
        return torch.float64
    raise ValueError(f"Unknown precision: {precision}")


def build_engine(cfg, device="cuda", dtype: Optional[torch.dtype] = None
                 ) -> DiffusionEngine:
    """The engine of ``cfg`` (a typed ``RootCfg``) on ``device`` in ``dtype``
    (``trainer.precision``'s when None). The modules are made on the meta
    device and materialised on ``device`` with :func:`init_params`' seeded
    weights (seed ``cfg.seed``, 0 when null); on the meta device they stay
    shapes only."""
    dtype = dtype or resolve_dtype(cfg.trainer.precision)
    with torch.device("meta"):
        model = MVLDM(cfg.model, cfg.trainer.remat, cfg.trainer.remat_policy)
    if torch.device(device).type != "meta":
        model = model.to_empty(device=device)
        init_params(model, cfg.seed or 0)
    model = model.to(dtype).eval()
    return DiffusionEngine(cfg.model, model.denoiser, model.autoencoder,
                           get_scheduler(cfg.model.scheduler))


# Up-block SD attentions of the reference checkpoint: the live model skips
# them (``MultiViewUNetCfg.up_block_attention``), so the port has none.
UNUSED_KEYS = re.compile(r"^denoiser\.unet\.up_blocks\.\d+\.attentions\.")


def load_pretrained(cfg, engine: DiffusionEngine) -> None:
    """Overlay a reference Lightning ``.ckpt`` named by
    ``checkpointing.load`` on the engine's weights (the JAX package's
    warm start): the keys it holds replace the seeded weights, keys it
    lacks keep them. The file is unpickled in full, as the JAX package
    does: load only checkpoints you trust."""
    load = cfg.checkpointing.load
    if not (load and str(load).endswith(".ckpt")):
        return
    load_reference_ckpt(load, denoiser=engine.unet, autoencoder=engine.vae)


def load_reference_ckpt(load, **modules: nn.Module) -> None:
    """Load the tensors of a reference ``.ckpt`` under each name's prefix
    (``denoiser.``, ``autoencoder.``) into the module of that name; keys the
    modules lack are refused, keys the file lacks keep their weights."""
    ckpt = torch.load(load, map_location="cpu", weights_only=False)
    prefixes = tuple(f"{name}." for name in modules)
    state_dict = {k: v for k, v in ckpt.get("state_dict", ckpt).items()
                  if k.startswith(prefixes) and not UNUSED_KEYS.match(k)}
    holder = nn.Module()
    for name, module in modules.items():
        setattr(holder, name, module)
    missing, unexpected = holder.load_state_dict(state_dict, strict=False)
    if unexpected:
        raise ValueError(f"{load}: keys the model does not have: {unexpected[:8]}")
    print(f"Loaded {len(state_dict)} tensors from {load}"
          + (f"; {len(missing)} keys kept their seeded init" if missing else ""))


def build_flagship(device="cuda", dtype: torch.dtype = torch.bfloat16,
                   seed: int = 0, cfg_mode: str = "auto") -> DiffusionEngine:
    """The flagship engine on ``device`` in ``dtype`` with seeded weights."""
    model_cfg = flagship_model_cfg()
    model = MVLDM(model_cfg)
    init_params(model, seed)
    model = model.to(device=device, dtype=dtype).eval()
    scheduler = DDIMScheduler.create(
        DDIMSchedulerKwargs(clip_sample=False, prediction_type="epsilon"),
        num_inference_steps=NUM_STEPS,
    )
    return DiffusionEngine(model_cfg, model.denoiser, model.autoencoder,
                           scheduler, cfg_mode=cfg_mode)


def build_flagship_train(device="cuda", seed: int = 0, remat: bool = False,
                         remat_policy: Optional[str] = None) -> DiffusionEngine:
    """The seeded flagship of :func:`build_flagship`, for training: the UNet
    computes in bf16 (its f32 masters live in the train state) and
    rematerialises its blocks under ``remat`` (with ``remat_policy``); the
    VAE is frozen."""
    engine = build_flagship(device, torch.bfloat16, seed)
    engine.unet.remat, engine.unet.remat_policy = remat, remat_policy
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
