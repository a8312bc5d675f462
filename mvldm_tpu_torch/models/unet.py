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

The public forward keeps the JAX layout: (b, v, h, w, c) in and out. Inside,
the feature maps are (b * v, c, h, w) tensors laid out channels-last (NHWC)
from the input to the output, so the layout changes are views: cuDNN runs
its NHWC convolutions with no transposes, and GroupNorm takes its kernel
(``ops/group_norm.py``). The SD2.1 backbone, :func:`sd_unet` and
:class:`SDUNet`'s forward, is shared with MVDream's UNet
(``models/mvdream.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Literal, Optional, Tuple, Union

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


def sd_unet(ch: List[int], lpb: int, groups: int, eps: float, in_channels: int,
            out_channels: int, down_heads: List[Optional[int]],
            up_heads: List[Optional[int]], mid_heads: int,
            attn: Callable[[int, int], nn.Module], **extra: nn.Module) -> nn.Module:
    """The SD2.1 UNet's modules under diffusers' names (``unet.*``): ``ch``
    channels a level, ``lpb`` ResNets a down block and one more an up
    block, a 4 ch[0]-wide time embedding. Level i's down block has an
    attention of ``down_heads[i]`` heads after each ResNet, up block i
    (deepest level first) one of ``up_heads[i]`` (None: no attention),
    the mid block one of ``mid_heads``; ``attn(channels, heads)`` builds
    one. ``extra`` modules are held after ``conv_out``."""
    temb = ch[0] * 4
    n = len(ch)

    down = []
    cin = ch[0]
    for i in range(n):
        blk = _container(resnets=nn.ModuleList(
            [ResnetBlock(cin if j == 0 else ch[i], ch[i], temb, groups, eps)
             for j in range(lpb)]))
        if down_heads[i] is not None:
            blk.attentions = nn.ModuleList([attn(ch[i], down_heads[i]) for _ in range(lpb)])
        if i < n - 1:
            blk.downsamplers = nn.ModuleList([Downsample(ch[i])])
        down.append(blk)
        cin = ch[i]

    # Skip channels in capture order, as the forward pushes them.
    skip_ch: List[int] = [ch[0]]
    for i in range(n):
        skip_ch += [ch[i]] * lpb + ([ch[i]] if i < n - 1 else [])
    rev = list(reversed(ch))
    up = []
    hidden = ch[-1]
    for i in range(n):
        resnets = []
        for _ in range(lpb + 1):
            resnets.append(ResnetBlock(hidden + skip_ch.pop(), rev[i], temb, groups, eps))
            hidden = rev[i]
        blk = _container(resnets=nn.ModuleList(resnets))
        if up_heads[i] is not None:
            blk.attentions = nn.ModuleList([attn(rev[i], up_heads[i]) for _ in range(lpb + 1)])
        if i < n - 1:
            blk.upsamplers = nn.ModuleList([Upsample(rev[i])])
        up.append(blk)

    return _container(
        time_embedding=_container(linear_1=nn.Linear(ch[0], temb),
                                  linear_2=nn.Linear(temb, temb)),
        conv_in=nn.Conv2d(in_channels, ch[0], 3, padding=1),
        down_blocks=nn.ModuleList(down),
        mid_block=_container(
            resnets=nn.ModuleList([ResnetBlock(ch[-1], ch[-1], temb, groups, eps)
                                   for _ in range(2)]),
            attentions=nn.ModuleList([attn(ch[-1], mid_heads)]),
        ),
        up_blocks=nn.ModuleList(up),
        conv_norm_out=GroupNorm(groups, ch[0], eps, act="silu"),
        conv_out=nn.Conv2d(ch[0], out_channels, 3, padding=1),
        **extra,
    )


class SDUNet(nn.Module):
    """The forward of :func:`sd_unet`'s ``self.unet``, shared by
    :class:`MultiViewUNet` and MVDream's UNet. Each ResNet and attention
    runs through :meth:`_block` (the attention with ``attn_args`` after its
    input) and each level's output through :meth:`_cross_view`; here both
    pass through."""

    def _block(self, fn, *args):
        return fn(*args)

    def _cross_view(self, group: str, i: int, x: torch.Tensor, v: int,
                    view_mask: Optional[torch.Tensor]) -> torch.Tensor:
        return x

    def _time_embedding(self, timestep: torch.Tensor, b: int, v: int) -> torch.Tensor:
        """(b * v, 4 ch[0]) from timesteps (b,) or (b, v)."""
        u = self.unet
        if timestep.dim() < 2:
            timestep = timestep[:, None].expand(b, v)
        t_emb = timestep_embedding(timestep.reshape(b * v), u.conv_in.out_channels)
        temb = u.time_embedding.linear_1(t_emb.to(u.conv_in.weight.dtype))
        return u.time_embedding.linear_2(F.silu(temb))

    def _backbone(self, latents: torch.Tensor, temb: torch.Tensor, attn_args: tuple,
                  view_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(b, v, h, w, c_in) latents -> (b, v, h, w, c_out). The feature
        maps stay channels-last: the input's permute is one, every module
        keeps it, and the output's permute is a view."""
        u = self.unet
        b, v, h0, w0, _ = latents.shape
        hidden = latents.reshape(b * v, h0, w0, -1).permute(0, 3, 1, 2)
        hidden = u.conv_in(hidden.to(u.conv_in.weight.dtype))

        skips = [hidden]
        for i, blk in enumerate(u.down_blocks):
            for j, res in enumerate(blk.resnets):
                hidden = self._block(res, hidden, temb)
                if hasattr(blk, "attentions"):
                    hidden = self._block(blk.attentions[j], hidden, *attn_args)
                skips.append(hidden)
            hidden = self._cross_view("cross_attn_blocks_encoder", i, hidden, v, view_mask)
            if hasattr(blk, "downsamplers"):
                hidden = blk.downsamplers[0](hidden)
                skips.append(hidden)

        mid = u.mid_block
        hidden = self._block(mid.resnets[0], hidden, temb)
        hidden = self._block(mid.attentions[0], hidden, *attn_args)
        hidden = self._block(mid.resnets[1], hidden, temb)
        hidden = self._cross_view("cross_attn_blocks_mid", 0, hidden, v, view_mask)

        for i, blk in enumerate(u.up_blocks):
            for j, res in enumerate(blk.resnets):
                hidden = self._block(res, torch.cat([hidden, skips.pop()], dim=1), temb)
                if hasattr(blk, "attentions"):
                    hidden = self._block(blk.attentions[j], hidden, *attn_args)
            hidden = self._cross_view("cross_attn_blocks_decoder", i, hidden, v, view_mask)
            if hasattr(blk, "upsamplers"):
                hidden = blk.upsamplers[0](hidden)

        hidden = u.conv_out(u.conv_norm_out(hidden))
        return hidden.permute(0, 2, 3, 1).reshape(b, v, h0, w0, -1)


class MultiViewUNet(SDUNet):
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
        heads = bb.num_attention_heads
        up_heads = list(reversed(heads))
        groups = bb.norm_num_groups
        self.unet = sd_unet(
            ch, bb.layers_per_block, groups, bb.norm_eps, in_channels, out_channels,
            [h if t == "CrossAttnDownBlock2D" else None
             for h, t in zip(heads, bb.down_block_types)],
            [h if t == "CrossAttnUpBlock2D" and cfg.up_block_attention else None
             for h, t in zip(up_heads, bb.up_block_types)],
            heads[-1],
            lambda c, h: Transformer2D(c, h, c // h, bb.cross_attention_dim, groups))

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
            self.cross_attn_blocks_decoder = nn.ModuleList([cross(c) for c in reversed(ch)])

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
        b, v = latents.shape[:2]
        temb = self._time_embedding(timestep, b, v)
        return self._backbone(latents, temb, (cond_state,), view_mask)
