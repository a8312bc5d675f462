"""Cross-view 3D attention block (counterpart of
``mvldm_tpu/models/mv_attention.py``): GroupNorm -> 1x1-conv proj_in ->
[joint self-attention over all views' tokens, per-frame self-attention,
GEGLU FF] -> 1x1-conv proj_out -> residual.

An optional (b, v) boolean ``view_mask`` becomes a (b, v*l) additive key
bias of 0 / NEG_INF on the joint attention, which excludes masked views and
makes single-launch batched CFG exact.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn as nn

from ..ops.attention import NEG_INF
from .layers import (
    LN_EPS,
    CrossAttention,
    FeedForward,
    GroupNorm,
    ff_block,
    layer_norm,
    self_attn_block,
)


@dataclass
class SpatialTransformer3DCfg:
    """The fields of reference ``mvdream/attention.py:23-32`` that the model
    reads."""

    num_heads: int = 8
    num_layers: int = 1
    d_dot: Optional[int] = None  # default d_in // num_heads


def view_key_bias(view_mask: torch.Tensor, tokens_per_view: int) -> torch.Tensor:
    """(b, v) bool -> (b, v*l) f32 additive key bias (0 kept, NEG_INF masked)."""
    bias = torch.where(view_mask, 0.0, NEG_INF).to(torch.float32)
    return bias.repeat_interleave(tokens_per_view, dim=-1).contiguous()


class BasicTransformerBlock3D(nn.Module):
    """attn1 joint over (view * h * w) tokens, attn2 per frame, GEGLU FF."""

    def __init__(self, dim: int, num_heads: int, head_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn1 = CrossAttention(dim, dim, num_heads, head_dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn2 = CrossAttention(dim, dim, num_heads, head_dim)
        self.norm3 = nn.LayerNorm(dim, eps=LN_EPS)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, num_views: int,
                view_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        bv, l, c = x.shape
        joint = x.reshape(bv // num_views, num_views * l, c)
        key_bias = None if view_mask is None else view_key_bias(view_mask, l)
        h = layer_norm(joint, self.norm1)
        joint = joint + self.attn1(h, key_bias=key_bias)
        x = joint.reshape(bv, l, c)
        x = self_attn_block(x, self.norm2, self.attn2)
        return ff_block(x, self.norm3, self.ff)


class SpatialTransformer3D(nn.Module):
    """Cross-view attention over a (b, v, h, w, c) feature map."""

    def __init__(self, cfg: SpatialTransformer3DCfg, channels: int,
                 groups: int = 32):
        super().__init__()
        heads = cfg.num_heads
        head_dim = cfg.d_dot or channels // heads
        self.norm = GroupNorm(groups, channels, 1e-6)
        self.proj_in = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock3D(channels, heads, head_dim)
             for _ in range(cfg.num_layers)]
        )
        # Zero-initialised in the reference, so a fresh block is an identity;
        # loaded or seeded weights replace it.
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward_nchw(self, x: torch.Tensor, num_views: int,
                     view_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (b*v, c, h, w) -> same shape."""
        bv, c, h, w = x.shape
        hidden = self.proj_in(self.norm(x))
        hidden = hidden.permute(0, 2, 3, 1).reshape(bv, h * w, c)
        for block in self.transformer_blocks:
            hidden = block(hidden, num_views, view_mask)
        hidden = hidden.reshape(bv, h, w, c).permute(0, 3, 1, 2)
        return self.proj_out(hidden) + x

    def forward(self, x: torch.Tensor,
                view_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (b, v, h, w, c) -> same shape."""
        b, v, h, w, c = x.shape
        x_in = x.reshape(b * v, h, w, c).permute(0, 3, 1, 2)
        out = self.forward_nchw(x_in, v, view_mask)
        return out.permute(0, 2, 3, 1).reshape(b, v, h, w, c)
