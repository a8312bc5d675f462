"""MVDream's multi-view UNet (Shi et al., "MVDream: Multi-view Diffusion for
3D Generation", arXiv:2308.16512; ``bytedance/MVDream``,
``mvdream/configs/sd-v2-base.yaml``): the SD2.1-base UNet whose 16
spatial transformers (2 down and 3 up at each attention resolution, and
the mid block's) attend jointly over all views' tokens, with live text
cross-attention and a camera MLP added to the timestep embedding.

It has no counterpart in the JAX package. It is the port's other UNet's
SD2.1 backbone (``unet.sd_unet`` and ``unet.SDUNet``: MV-LDM's
``layers.ResnetBlock``, ``layers.Transformer2D`` and the fused kernels of
``ops/``) under diffusers' parameter names, ``unet.*``, with no cross-view
blocks; MVDream's own modules map onto it one to one:

* ``time_embed.{0,2}`` -> ``unet.time_embedding.linear_{1,2}``;
  ``camera_embed.{0,2}`` -> ``unet.camera_embedding.linear_{1,2}``
  (Linear(16, 4C) -> SiLU -> Linear(4C, 4C) on the flattened 4 x 4
  camera-to-world matrix, added to the timestep embedding);
* ``input_blocks`` / ``middle_block`` / ``output_blocks`` ->
  ``unet.down_blocks`` / ``unet.mid_block`` / ``unet.up_blocks`` of the
  SD2.1 topology, with an attention at each level whose downsampling
  factor is in ``attention_resolutions``;
* ``SpatialTransformer3D`` -> ``Transformer2D`` with ``num_views``:
  the tokens of a prompt's views are laid out as one sequence,
  ``(b v) l c -> b (v l) c``, for the whole block. attn1 is then joint over
  the views; attn2 (onto the prompt's text tokens, given once a prompt)
  and the feed-forward act on each token alone, so the layout changes
  nothing for them.

LayerNorms take PyTorch's default eps, 1e-5, as ``nn.LayerNorm`` does in
MVDream; GroupNorms 32 groups, eps 1e-5 (1e-6 in the transformers).

The public forward takes (b, v, h, w, c) latents, (b,) or (b, v)
timesteps, (b, Lt, context_dim) text tokens and (b, v, camera_dim)
cameras, and returns (b, v, h, w, out_channels).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Transformer2D
from .unet import SDUNet, _container, sd_unet

GROUPS = 32  # ldm's ``normalization``: GroupNorm32(32, channels)
NORM_EPS = 1e-5  # GroupNorm32's and nn.LayerNorm's default


@dataclass
class MVDreamUNetCfg:
    """The ``unet_config.params`` of MVDream's ``sd-v2-base.yaml`` that
    shape the network; the ``name`` tells it from ``mv_unet``."""

    name: Literal["mvdream"] = "mvdream"
    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    attention_resolutions: Tuple[int, ...] = (4, 2, 1)
    num_res_blocks: int = 2
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_head_channels: int = 64
    transformer_depth: int = 1
    context_dim: int = 1024
    use_linear_in_transformer: bool = True
    camera_dim: int = 16


class MVDreamUNet(SDUNet):
    """The denoiser: latents (b, v, h, w, in_channels), timesteps (b,) or
    (b, v), text tokens (b, Lt, context_dim), cameras (b, v, camera_dim)."""

    def __init__(self, cfg: MVDreamUNetCfg):
        super().__init__()
        if not cfg.use_linear_in_transformer:
            raise ValueError("MVDreamUNet: only use_linear_in_transformer=True (SD2.1) is built")
        self.cfg = cfg
        ch = [cfg.model_channels * m for m in cfg.channel_mult]
        temb = cfg.model_channels * 4
        d = cfg.num_head_channels
        heads = [c // d if (1 << i) in cfg.attention_resolutions else None
                 for i, c in enumerate(ch)]
        self.unet = sd_unet(
            ch, cfg.num_res_blocks, GROUPS, NORM_EPS, cfg.in_channels, cfg.out_channels,
            heads, heads[::-1], ch[-1] // d,
            lambda c, h: Transformer2D(c, h, d, cfg.context_dim, GROUPS, cfg.transformer_depth,
                                       ln_eps=NORM_EPS),
            camera_embedding=_container(linear_1=nn.Linear(cfg.camera_dim, temb),
                                        linear_2=nn.Linear(temb, temb)))

    def forward(self, latents: torch.Tensor, timestep: torch.Tensor,
                context: torch.Tensor, camera: torch.Tensor) -> torch.Tensor:
        b, v = latents.shape[:2]
        cam = self.unet.camera_embedding
        camera = camera.reshape(b * v, -1).to(self.unet.conv_in.weight.dtype)
        temb = self._time_embedding(timestep, b, v) + cam.linear_2(F.silu(cam.linear_1(camera)))
        context = context.to(self.unet.conv_in.weight.dtype)
        return self._backbone(latents, temb, (context, v))
