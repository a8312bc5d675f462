"""The alternative cross-view block, ``multi_view_attention: standard``
(counterpart of ``mvldm_tpu/models/standard_transformer.py``): a PreNorm
ViT transformer over all (view * h * w) tokens, with optional conv down /
up-scaling and DETR sine position embeddings.

As in the JAX module, the block is not residual at the module level and
has no zero-initialised projection. Parameter names follow the JAX
module's (``transformer.norm_attn_<i>``, ``transformer.attn_<i>.to_qkv``,
``downscaler``, ``refine_0``, ...), with ``to_out.0`` and ``net.0`` /
``net.2`` where the reference ViT modules have them. The attention runs
through ``ops.attention``: the flash kernel on the card, with the view
mask as its key bias.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import attention
from .layers import LN_EPS, _merge_heads, _split_heads, layer_norm
from .mv_attention import view_key_bias


@dataclass
class CrossAttentionCfg:
    name: Literal["standard"] = "standard"
    num_heads: int = 8
    num_layers: int = 1
    d_dot: Optional[int] = None
    d_mlp: Optional[int] = None
    d_mlp_multiplier: Optional[int] = 1
    downscale: int = 1
    pos_enc: bool = False


def position_embedding_sine(h: int, w: int, num_pos_feats: int,
                            temperature: float = 10000.0) -> np.ndarray:
    """Normalised DETR sine position embedding -> (h, w, 2 * num_pos_feats)
    f32, channels last."""
    scale = 2 * np.pi
    eps = 1e-6
    y_embed = np.cumsum(np.ones((h, w), dtype=np.float32), axis=0)
    x_embed = np.cumsum(np.ones((h, w), dtype=np.float32), axis=1)
    y_embed = y_embed / (y_embed[-1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, -1:] + eps) * scale
    dim_t = np.arange(num_pos_feats, dtype=np.float32)
    dim_t = temperature ** (2 * (dim_t // 2) / num_pos_feats)

    def interleave(pos):
        pos = pos[:, :, None] / dim_t
        return np.stack((np.sin(pos[:, :, 0::2]), np.cos(pos[:, :, 1::2])),
                        axis=3).reshape(h, w, -1)

    return np.concatenate((interleave(y_embed), interleave(x_embed)), axis=-1)


class ViTAttention(nn.Module):
    """Fused bias-free qkv projection, attention, output projection (none
    when one head spans the whole width)."""

    def __init__(self, dim: int, num_heads: int, head_dim: int):
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads = num_heads
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        if not (num_heads == 1 and head_dim == dim):
            self.to_out = nn.ModuleList([nn.Linear(inner, dim)])

    def forward(self, x: torch.Tensor, key_bias: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        q, k, v = (_split_heads(t, self.num_heads) for t in self.to_qkv(x).chunk(3, dim=-1))
        out = _merge_heads(attention(q, k, v, bias=key_bias))
        return self.to_out[0](out) if hasattr(self, "to_out") else out


class ViTFeedForward(nn.Module):
    """Linear -> exact GELU -> Linear."""

    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        self.net = nn.Sequential(nn.Linear(dim, hidden_dim), nn.GELU(),
                                 nn.Linear(hidden_dim, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class ViTTransformer(nn.Module):
    """PreNorm transformer; LayerNorm statistics in f32."""

    def __init__(self, dim: int, depth: int, num_heads: int, head_dim: int,
                 mlp_dim: int):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"norm_attn_{i}", nn.LayerNorm(dim, eps=LN_EPS))
            self.add_module(f"attn_{i}", ViTAttention(dim, num_heads, head_dim))
            self.add_module(f"norm_ff_{i}", nn.LayerNorm(dim, eps=LN_EPS))
            self.add_module(f"ff_{i}", ViTFeedForward(dim, mlp_dim))

    def forward(self, x: torch.Tensor, key_bias: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        for i in range(self.depth):
            attn, ff = getattr(self, f"attn_{i}"), getattr(self, f"ff_{i}")
            x = x + attn(layer_norm(x, getattr(self, f"norm_attn_{i}")), key_bias)
            x = x + ff(layer_norm(x, getattr(self, f"norm_ff_{i}")))
        return x


class StandardTransformer(nn.Module):
    """Cross-view attention over a (b, v, h, w, c) feature map by one joint
    ViT transformer. ``view_mask`` (b, v) keeps masked views' tokens out of
    the keys, as in ``SpatialTransformer3D``."""

    def __init__(self, cfg: CrossAttentionCfg, channels: int):
        super().__init__()
        c, d = channels, cfg.downscale
        self.cfg = cfg
        if d > 1:
            self.downscaler = nn.Conv2d(c, c, d, stride=d)
        self.transformer = ViTTransformer(
            c, cfg.num_layers, cfg.num_heads, cfg.d_dot or c // cfg.num_heads,
            cfg.d_mlp or c * (cfg.d_mlp_multiplier or 1))
        if d > 1:
            self.upscaler = nn.ConvTranspose2d(c, c, d, stride=d)
            self.refine_0 = nn.Conv2d(c, c * 2, 7, padding=3)
            self.refine_1 = nn.Conv2d(c * 2, c, 7, padding=3)

    def forward_nchw(self, x: torch.Tensor, num_views: int,
                     view_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (b*v, c, h, w) -> same shape."""
        bv, c, h, w = x.shape
        if self.cfg.pos_enc:
            pos = torch.from_numpy(position_embedding_sine(h, w, c // 2))
            x = x + pos.to(x.device, x.dtype).permute(2, 0, 1)
        if self.cfg.downscale > 1:
            x = self.downscaler(x)
        hs, ws = x.shape[-2:]
        tokens = x.permute(0, 2, 3, 1).reshape(bv // num_views, num_views * hs * ws, c)
        key_bias = None if view_mask is None else view_key_bias(view_mask, hs * ws)
        tokens = self.transformer(tokens, key_bias)
        x = tokens.reshape(bv, hs, ws, c).permute(0, 3, 1, 2)
        if self.cfg.downscale > 1:
            up = self.upscaler(x)
            x = self.refine_1(F.gelu(self.refine_0(up))) + up
        return x

    def forward(self, x: torch.Tensor,
                view_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (b, v, h, w, c) -> same shape."""
        b, v, h, w, c = x.shape
        out = self.forward_nchw(x.reshape(b * v, h, w, c).permute(0, 3, 1, 2), v, view_mask)
        return out.permute(0, 2, 3, 1).reshape(b, v, h, w, c)
