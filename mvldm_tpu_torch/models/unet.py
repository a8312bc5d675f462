"""Multi-view UNet (counterpart of ``mvldm_tpu/models/unet.py``): the SD2.1
``UNet2DConditionModel`` topology with cross-view attention after each
stage whose feature map is at most ``cross_view_max_size`` square: a
``SpatialTransformer3D``, or a ``StandardTransformer`` when
``multi_view_attention.name`` is "standard".

Parameter names follow the reference Lightning checkpoint's denoiser:
``unet.*`` (diffusers names) and ``cross_attn_blocks_{encoder,mid,decoder}.*``.
As in the JAX package:

* skips are captured per resnet BEFORE cross-view attention runs;
* up-block SD attentions are skipped (``up_block_attention=False``), the
  live checkpoint's path;
* timesteps may be per view, (b, v); context views get t = 0;
* the text cross-attention receives the live model's all-zero conditioning,
  for which it collapses to a constant;
* ``remat`` (training) recomputes each ResNet, ``Transformer2D`` and
  ``SpatialTransformer3D`` block in the backward instead of keeping its
  activations, the counterpart of ``nn.remat`` around those blocks
  (``torch.utils.checkpoint``, non-reentrant); ``remat_policy="dots"``
  keeps the 2-D products (``aten.mm`` / ``aten.addmm``) and recomputes
  the rest, the counterpart of ``dots_with_no_batch_dims_saveable``.

The public forward keeps the JAX layout: (b, v, h, w, c) in and out.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Literal, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from .layers import (
    Downsample,
    GroupNorm,
    ResnetBlock,
    Transformer2D,
    Upsample,
    timestep_embedding,
)
from .mv_attention import SpatialTransformer3D, SpatialTransformer3DCfg
from .standard_transformer import CrossAttentionCfg, StandardTransformer


@dataclass
class UNetBackboneCfg:
    """SD2.1 UNet topology."""

    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "DownBlock2D",
    )
    mid_block_type: str = "UNetMidBlock2DCrossAttn"
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
    )
    only_cross_attention: bool = False
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    num_attention_heads: Tuple[int, ...] = (5, 10, 20, 20)
    norm_eps: float = 1e-5
    norm_num_groups: int = 32


@dataclass
class MultiViewUNetCfg:
    """Reference ``mvunet.py:31-40``; ``use_ray_encoding`` and
    ``pretrained_from`` are read by nothing, as in the JAX package."""

    name: Literal["mv_unet"] = "mv_unet"
    autoencoder: UNetBackboneCfg = field(default_factory=UNetBackboneCfg)
    multi_view_attention: Union[SpatialTransformer3DCfg, CrossAttentionCfg] = field(
        default_factory=SpatialTransformer3DCfg
    )
    use_ray_encoding: bool = True
    encoder_conditioning: bool = True
    mid_conditioning: bool = True
    decoder_conditioning: bool = True
    pretrained_from: Optional[str] = None
    up_block_attention: bool = False
    cross_view_max_size: int = 32


REMAT_POLICIES = (None, "dots")
# The products that remat_policy="dots" keeps: the 2-D products, which a
# linear layer on (..., k) activations folds into. JAX's
# dots_with_no_batch_dims_saveable keeps the dot_generals without batch
# dimensions; its comment in mvldm_tpu/models/unet.py says "matmul/conv",
# but a convolution is no dot_general there and is recomputed, as here. A
# batched product (aten.bmm, the attention's scores) is recomputed in both,
# and so is every hand kernel: it launches outside the dispatcher, as a
# pallas_call is no dot_general.
_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def _container(**modules) -> nn.Module:
    m = nn.Module()
    for name, mod in modules.items():
        setattr(m, name, mod)
    return m


class MultiViewUNet(nn.Module):
    """The denoiser. Input (b, v, h, w, in_channels); timesteps (b,) or
    (b, v); optional (b, v) bool ``view_mask`` (False = view contributes no
    keys to cross-view attention)."""

    def __init__(self, cfg: MultiViewUNetCfg, in_channels: int = 11,
                 out_channels: int = 4, remat: bool = False,
                 remat_policy: Optional[str] = None):
        super().__init__()
        self.cfg = cfg
        self.remat = remat
        self.remat_policy = remat_policy
        bb = cfg.autoencoder
        ch = bb.block_out_channels
        groups, eps, lpb = bb.norm_num_groups, bb.norm_eps, bb.layers_per_block
        temb = ch[0] * 4
        n = len(ch)

        def sd_attn(c: int, heads: int) -> Transformer2D:
            return Transformer2D(c, heads, c // heads, bb.cross_attention_dim, groups)

        down = []
        cin = ch[0]
        for i, btype in enumerate(bb.down_block_types):
            blk = _container(resnets=nn.ModuleList(
                [ResnetBlock(cin if j == 0 else ch[i], ch[i], temb, groups, eps)
                 for j in range(lpb)]))
            if btype == "CrossAttnDownBlock2D":
                blk.attentions = nn.ModuleList(
                    [sd_attn(ch[i], bb.num_attention_heads[i]) for _ in range(lpb)])
            if i < n - 1:
                blk.downsamplers = nn.ModuleList([Downsample(ch[i])])
            down.append(blk)
            cin = ch[i]

        # Skip channels in capture order, as the forward pushes them.
        skip_ch: List[int] = [ch[0]]
        for i in range(n):
            skip_ch += [ch[i]] * lpb + ([ch[i]] if i < n - 1 else [])
        rev = list(reversed(ch))
        rev_heads = list(reversed(bb.num_attention_heads))
        up = []
        hidden = ch[-1]
        for i, btype in enumerate(bb.up_block_types):
            resnets = []
            for _ in range(lpb + 1):
                resnets.append(ResnetBlock(hidden + skip_ch.pop(), rev[i], temb,
                                           groups, eps))
                hidden = rev[i]
            blk = _container(resnets=nn.ModuleList(resnets))
            if btype == "CrossAttnUpBlock2D" and cfg.up_block_attention:
                blk.attentions = nn.ModuleList(
                    [sd_attn(rev[i], rev_heads[i]) for _ in range(lpb + 1)])
            if i < n - 1:
                blk.upsamplers = nn.ModuleList([Upsample(rev[i])])
            up.append(blk)

        self.unet = _container(
            time_embedding=_container(linear_1=nn.Linear(ch[0], temb),
                                      linear_2=nn.Linear(temb, temb)),
            conv_in=nn.Conv2d(in_channels, ch[0], 3, padding=1),
            down_blocks=nn.ModuleList(down),
            mid_block=_container(
                resnets=nn.ModuleList([ResnetBlock(ch[-1], ch[-1], temb, groups, eps)
                                       for _ in range(2)]),
                attentions=nn.ModuleList([sd_attn(ch[-1], bb.num_attention_heads[-1])]),
            ),
            up_blocks=nn.ModuleList(up),
            conv_norm_out=GroupNorm(groups, ch[0], eps, act="silu"),
            conv_out=nn.Conv2d(ch[0], out_channels, 3, padding=1),
        )

        mv = cfg.multi_view_attention

        def cross(c: int) -> nn.Module:
            if mv.name == "standard":
                return StandardTransformer(mv, c)
            return SpatialTransformer3D(mv, c, groups)

        if cfg.encoder_conditioning:
            self.cross_attn_blocks_encoder = nn.ModuleList([cross(c) for c in ch])
        if cfg.mid_conditioning:
            self.cross_attn_blocks_mid = nn.ModuleList([cross(ch[-1])])
        if cfg.decoder_conditioning:
            self.cross_attn_blocks_decoder = nn.ModuleList([cross(c) for c in rev])

    @property
    def remat_policy(self) -> Optional[str]:
        return self._remat_policy

    @remat_policy.setter
    def remat_policy(self, policy: Optional[str]) -> None:
        if policy not in REMAT_POLICIES:
            raise ValueError(f"Unknown remat_policy {policy!r}; expected one of "
                             f"{REMAT_POLICIES}")
        self._remat_policy = policy

    def _block(self, fn, *args):
        """Run one block, rematerialised in the backward under ``remat``
        (all of it, or all but the 2-D products under ``"dots"``)."""
        if self.remat and torch.is_grad_enabled():
            if self.remat_policy == "dots":
                return checkpoint(fn, *args, use_reentrant=False, context_fn=_dots_context)
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def _cross_view(self, group: str, i: int, x: torch.Tensor, v: int,
                    view_mask: Optional[torch.Tensor]) -> torch.Tensor:
        h, w = x.shape[-2:]
        size = self.cfg.cross_view_max_size
        if h > size or w > size or not hasattr(self, group):
            return x
        return self._block(getattr(self, group)[i].forward_nchw, x, v, view_mask)

    def forward(self, latents: torch.Tensor, timestep: torch.Tensor,
                view_mask: Optional[torch.Tensor] = None,
                cond_state: Optional[torch.Tensor] = None) -> torch.Tensor:
        u = self.unet
        b, v, h0, w0, _ = latents.shape
        bv = b * v
        dtype = u.conv_in.weight.dtype
        if timestep.dim() < 2:
            timestep = timestep[:, None].expand(b, v)
        t_emb = timestep_embedding(timestep.reshape(bv), u.conv_in.out_channels)
        temb = u.time_embedding.linear_1(t_emb.to(dtype))
        temb = u.time_embedding.linear_2(F.silu(temb))

        hidden = latents.reshape(bv, h0, w0, -1).permute(0, 3, 1, 2).to(dtype)
        hidden = u.conv_in(hidden)

        skips = [hidden]
        for i, blk in enumerate(u.down_blocks):
            for j, res in enumerate(blk.resnets):
                hidden = self._block(res, hidden, temb)
                if hasattr(blk, "attentions"):
                    hidden = self._block(blk.attentions[j], hidden, cond_state)
                skips.append(hidden)
            hidden = self._cross_view("cross_attn_blocks_encoder", i, hidden, v, view_mask)
            if hasattr(blk, "downsamplers"):
                hidden = blk.downsamplers[0](hidden)
                skips.append(hidden)

        mid = u.mid_block
        hidden = self._block(mid.resnets[0], hidden, temb)
        hidden = self._block(mid.attentions[0], hidden, cond_state)
        hidden = self._block(mid.resnets[1], hidden, temb)
        hidden = self._cross_view("cross_attn_blocks_mid", 0, hidden, v, view_mask)

        for i, blk in enumerate(u.up_blocks):
            for j, res in enumerate(blk.resnets):
                hidden = self._block(res, torch.cat([hidden, skips.pop()], dim=1), temb)
                if hasattr(blk, "attentions"):
                    hidden = self._block(blk.attentions[j], hidden, cond_state)
            hidden = self._cross_view("cross_attn_blocks_decoder", i, hidden, v, view_mask)
            if hasattr(blk, "upsamplers"):
                hidden = blk.upsamplers[0](hidden)

        hidden = u.conv_out(u.conv_norm_out(hidden))
        return hidden.permute(0, 2, 3, 1).reshape(b, v, h0, w0, -1)
