"""Shared building blocks of the VAE and the UNet (counterpart of
``mvldm_tpu/models/layers.py``).

Modules carry the reference (diffusers) parameter names and torch layouts,
so a reference state dict loads with ``load_state_dict`` as it is. Feature
maps are NCHW inside the modules; normalisation statistics are f32 whatever
the parameter dtype, and results are cast back, as in the JAX package.
GroupNorm and the convolutions stay stock PyTorch (the JAX package leaves
them to XLA); the attention and feed-forward sub-blocks go through
``ops/``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import attention, text_cross_attention
from ..ops.fused_attn import fused_ln_self_attention, use_fused
from ..ops.fused_ff import fused_ln_geglu_ff, ln_geglu_ff_decomposed
from ..parallel.tp import get_model_mesh, view_parallel

LN_EPS = 1e-6  # flax nn.LayerNorm default: MV-LDM's transformer norms


def timestep_embedding(
    timesteps: torch.Tensor,
    dim: int,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    max_period: int = 10000,
) -> torch.Tensor:
    """Sinusoidal timestep features (diffusers ``Timesteps`` semantics with
    the SD2.1 settings: flip_sin_to_cos=True, downscale_freq_shift=0)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device
    )
    exponent = exponent / (half - downscale_freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    sin, cos = torch.sin(emb), torch.cos(emb)
    if flip_sin_to_cos:
        return torch.cat([cos, sin], dim=-1)
    return torch.cat([sin, cos], dim=-1)


class GroupNorm(nn.Module):
    """GroupNorm over NCHW with an optional SiLU. PyTorch accumulates the
    statistics in f32 for bf16 inputs; the SiLU then runs on the normalised
    value rounded to the input dtype (the JAX package applies it before that
    rounding, a difference of one rounding step)."""

    def __init__(self, num_groups: int, num_channels: int, eps: float,
                 act: Optional[str] = None):
        super().__init__()
        self.num_groups, self.eps, self.act = num_groups, eps, act
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.group_norm(x, self.num_groups, self.weight, self.bias, self.eps)
        return F.silu(out) if self.act == "silu" else out


class ResnetBlock(nn.Module):
    """GroupNorm -> SiLU -> Conv3x3 (x2) with residual; optional time
    embedding added after the first conv."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: Optional[int], groups: int, eps: float):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_channels, eps, act="silu")
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        if temb_channels is not None:
            self.time_emb_proj = nn.Linear(temb_channels, out_channels)
        self.norm2 = GroupNorm(groups, out_channels, eps, act="silu")
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor,
                temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(self.norm1(x))
        if hasattr(self, "time_emb_proj"):
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class Downsample(nn.Module):
    """Stride-2 3x3 conv; the VAE encoder pads (0, 1, 0, 1) first."""

    def __init__(self, channels: int, asymmetric_padding: bool = False):
        super().__init__()
        self.asymmetric_padding = asymmetric_padding
        self.conv = nn.Conv2d(channels, channels, 3, stride=2,
                              padding=0 if asymmetric_padding else 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.asymmetric_padding:
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class Upsample(nn.Module):
    """Nearest 2x upsampling, then a 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


def _split_heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, l, inner = t.shape
    return t.reshape(b, l, num_heads, inner // num_heads).transpose(1, 2).contiguous()


def _merge_heads(t: torch.Tensor) -> torch.Tensor:
    b, h, l, d = t.shape
    return t.transpose(1, 2).reshape(b, l, h * d)


class CrossAttention(nn.Module):
    """SD-convention attention: bias-free to_q/to_k/to_v, biased to_out.0.
    ``context=None`` attends over ``x`` itself (with an optional key
    bias); a ``context`` of text tokens goes through
    :func:`text_cross_attention`."""

    def __init__(self, query_dim: int, context_dim: int, num_heads: int,
                 head_dim: int):
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads, self.head_dim = num_heads, head_dim
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                key_bias: Optional[torch.Tensor] = None,
                zero_context: bool = False) -> torch.Tensor:
        if zero_context:
            # The live model feeds all-zero text conditioning to the SD
            # cross-attention. With bias-free k/v projections v == 0, so the
            # attention output is 0 and the block is exactly its to_out bias.
            b, lq, _ = x.shape
            return self.to_out[0].bias.expand(b, lq, -1)
        kv = x if context is None else context
        q = _split_heads(self.to_q(x), self.num_heads)
        k = _split_heads(self.to_k(kv), self.num_heads)
        v = _split_heads(self.to_v(kv), self.num_heads)
        if context is None:
            out = attention(q, k, v, bias=key_bias)
        else:
            out = text_cross_attention(q, k, v)
        return self.to_out[0](_merge_heads(out))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)


class FeedForward(nn.Module):
    """GEGLU feed-forward, mult 4 (parameter holder: ``net.0.proj``,
    ``net.2``); applied through :func:`ff_block`."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList(
            [GEGLU(dim, dim * mult), nn.Identity(), nn.Linear(dim * mult, dim)]
        )


def self_attn_block(x: torch.Tensor, norm: nn.LayerNorm, attn: CrossAttention
                    ) -> torch.Tensor:
    """``x + Attn(LayerNorm(x))`` over (b, l, c) tokens: the fused kernel at
    the JAX package's channel gate, else the decomposed path (separate
    projections around the attention dispatcher)."""
    # Under trainer.strategy=data_model each model rank takes a share of the
    # frames (parallel/tp.view_parallel); a direct call otherwise.
    mesh = get_model_mesh()
    if mesh is not None:
        return view_parallel(lambda x: _self_attn_block(x, norm, attn), x, mesh)
    return _self_attn_block(x, norm, attn)


def _self_attn_block(x: torch.Tensor, norm: nn.LayerNorm, attn: CrossAttention
                     ) -> torch.Tensor:
    c = x.shape[-1]
    wo = attn.to_out[0]
    if use_fused(c, x.dtype):
        return fused_ln_self_attention(
            x, norm.weight, norm.bias, attn.to_q.weight.t(),
            attn.to_k.weight.t(), attn.to_v.weight.t(), wo.weight.t(),
            wo.bias, attn.num_heads, attn.head_dim, eps=norm.eps,
        )
    return x + attn(layer_norm(x, norm))


def ff_block(x: torch.Tensor, norm: nn.LayerNorm, ff: FeedForward
             ) -> torch.Tensor:
    """``x + FeedForward(LayerNorm(x))`` through the fused kernel at the JAX
    package's channel gate, else the decomposed path (the JAX ``_ff_jnp``,
    see ``ops/fused_ff.ln_geglu_ff_decomposed``)."""
    mesh = get_model_mesh()
    if mesh is not None:  # as in self_attn_block
        return view_parallel(lambda x: _ff_block(x, norm, ff), x, mesh)
    return _ff_block(x, norm, ff)


def _ff_block(x: torch.Tensor, norm: nn.LayerNorm, ff: FeedForward) -> torch.Tensor:
    proj, out = ff.net[0].proj, ff.net[2]
    fn = fused_ln_geglu_ff if use_fused(x.shape[-1], x.dtype) else ln_geglu_ff_decomposed
    return fn(x, norm.weight, norm.bias, proj.weight.t(), proj.bias, out.weight.t(),
              out.bias, eps=norm.eps)


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm with f32 statistics, rounded once to the input dtype: the
    JAX package's f32 ``nn.LayerNorm`` followed by its consumer's cast."""
    return F.layer_norm(x, (x.shape[-1],), norm.weight, norm.bias, norm.eps)


class TransformerBlock2D(nn.Module):
    """SD BasicTransformerBlock: self-attn, text cross-attn, GEGLU FF."""

    def __init__(self, dim: int, num_heads: int, head_dim: int,
                 context_dim: int, ln_eps: float = LN_EPS):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=ln_eps)
        self.attn1 = CrossAttention(dim, dim, num_heads, head_dim)
        self.norm2 = nn.LayerNorm(dim, eps=ln_eps)
        self.attn2 = CrossAttention(dim, context_dim, num_heads, head_dim)
        self.norm3 = nn.LayerNorm(dim, eps=ln_eps)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor]) -> torch.Tensor:
        """``context=None`` is the live model's all-zero text conditioning,
        for which attn2 collapses to its exact constant; a (b, Lt, c_ctx)
        ``context`` (MVDream's) is attended."""
        x = self_attn_block(x, self.norm1, self.attn1)
        # Under the zero text context attn2 is a constant; its input is unused.
        h = x if context is None else layer_norm(x, self.norm2)
        x = x + self.attn2(h, context, zero_context=context is None)
        return ff_block(x, self.norm3, self.ff)


class Transformer2D(nn.Module):
    """SD spatial transformer with linear projections (SD2.1): GroupNorm,
    proj_in, transformer blocks over (h*w) tokens, proj_out, residual."""

    def __init__(self, channels: int, num_heads: int, head_dim: int,
                 context_dim: int, groups: int, depth: int = 1,
                 ln_eps: float = LN_EPS):
        super().__init__()
        self.norm = GroupNorm(groups, channels, 1e-6)
        self.proj_in = nn.Linear(channels, channels)
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock2D(channels, num_heads, head_dim, context_dim, ln_eps)
             for _ in range(depth)]
        )
        self.proj_out = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                num_views: int = 1) -> torch.Tensor:
        """x: (b * num_views, c, h, w). With ``num_views`` > 1 the blocks run
        on each row's views as one sequence of num_views * h * w tokens
        (MVDream's joint attn1); ``context`` then holds one text a row."""
        bv, c, h, w = x.shape
        hidden = self.norm(x).permute(0, 2, 3, 1).reshape(bv // num_views, num_views * h * w, c)
        hidden = self.proj_in(hidden)
        for block in self.transformer_blocks:
            hidden = block(hidden, context)
        hidden = self.proj_out(hidden)
        return hidden.reshape(bv, h, w, c).permute(0, 3, 1, 2) + x


class AttnBlockVAE(nn.Module):
    """Single-head spatial self-attention of the VAE mid block."""

    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm(groups, channels, 1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        hidden = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q = self.to_q(hidden)[:, None].contiguous()
        k = self.to_k(hidden)[:, None].contiguous()
        v = self.to_v(hidden)[:, None].contiguous()
        out = self.to_out[0](attention(q, k, v)[:, 0])
        return out.reshape(b, h, w, c).permute(0, 3, 1, 2) + x
