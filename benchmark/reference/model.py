"""The plain reference model: the SD2.1 multi-view UNet with its cross-view
blocks (``SpatialTransformer3D`` or the standard ViT block) and the SD2.1
KL VAE, in plain PyTorch operations and float32.

It follows the published modules (diffusers' ``UNet2DConditionModel`` and
``AutoencoderKL``; mv-ldm's ``SpatialTransformer3D`` and standard
cross-view attention) and carries their parameter names, so one set of
seeded weights, keyed by name, serves both the program and this model.
It imports nothing of the program. Departures from the published model,
the same in the program:

* the text cross-attention gets the live model's all-zero conditioning;
  with bias-free key and value projections its output is exactly the
  output projection's bias, which is what ``CrossAttention`` returns then;
* up-block SD attentions are left out (``up_block_attention: false``);
* skips are taken per resnet before the cross-view block runs;
* timesteps are per view: context views get t = 0.

Every product goes through a :class:`~benchmark.reference.numerics.Numerics`,
so the same model computes the control in fp8. Feature maps are NCHW; the
public forwards take and return (b, v, h, w, c).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .numerics import Numerics

LN_EPS = 1e-6
NEG_INF = -1e30
# Score elements one block of the plain attention holds when no gradient is
# recorded (float32: 256 MB).
ATTN_BLOCK_ELEMENTS = 1 << 26


def attention(nx: Numerics, q, k, v, bias=None):
    """softmax(q k^T / sqrt(d) + bias) v over (B, H, L, D); ``bias`` is an
    additive (B, Lk) key bias. Without autograd the scores are formed a
    block of rows at a time."""
    scale = 1.0 / math.sqrt(q.shape[-1])

    def block(qb, kb, vb, bb):
        s = nx.matmul(qb * scale, kb.transpose(-1, -2))
        if bb is not None:
            s = s + bb[:, None, None, :]
        return nx.matmul(torch.softmax(s, dim=-1), vb)

    if torch.is_grad_enabled() or q.device.type == "meta":
        return block(q, k, v, bias)
    b, h, lq, _ = q.shape
    lk = k.shape[2]
    rows = max(1, ATTN_BLOCK_ELEMENTS // (h * lk))
    out = torch.empty_like(q)
    for i in range(b):
        bb = None if bias is None else bias[i:i + 1]
        for r in range(0, lq, rows):
            out[i:i + 1, :, r:r + rows] = block(q[i:i + 1, :, r:r + rows], k[i:i + 1],
                                                v[i:i + 1], bb)
    return out


def timestep_embedding(timesteps, dim: int, max_period: int = 10000):
    """Sinusoidal features, cos first (SD2.1: flip_sin_to_cos, shift 0)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                    device=timesteps.device) / half
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)


class GroupNorm(nn.Module):
    def __init__(self, groups: int, channels: int, eps: float, silu: bool = False):
        super().__init__()
        self.groups, self.eps, self.silu = groups, eps, silu
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        out = F.group_norm(x, self.groups, self.weight, self.bias, self.eps)
        return F.silu(out) if self.silu else out


def layer_norm(x, norm: nn.LayerNorm):
    return F.layer_norm(x, (x.shape[-1],), norm.weight, norm.bias, LN_EPS)


class ResnetBlock(nn.Module):
    def __init__(self, nx, cin: int, cout: int, temb: Optional[int], groups: int, eps: float):
        super().__init__()
        self.nx = nx
        self.norm1 = GroupNorm(groups, cin, eps, silu=True)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        if temb is not None:
            self.time_emb_proj = nn.Linear(temb, cout)
        self.norm2 = GroupNorm(groups, cout, eps, silu=True)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.conv_shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, x, temb=None):
        nx = self.nx
        h = nx.conv(self.norm1(x), self.conv1)
        if hasattr(self, "time_emb_proj"):
            p = self.time_emb_proj
            h = h + nx.linear(F.silu(temb), p.weight, p.bias)[:, :, None, None]
        h = nx.conv(self.norm2(h), self.conv2)
        if hasattr(self, "conv_shortcut"):
            x = nx.conv(x, self.conv_shortcut)
        return x + h


class Downsample(nn.Module):
    def __init__(self, nx, channels: int, asymmetric: bool = False):
        super().__init__()
        self.nx, self.asymmetric = nx, asymmetric
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=0 if asymmetric else 1)

    def forward(self, x):
        if self.asymmetric:
            x = F.pad(x, (0, 1, 0, 1))
        return self.nx.conv(x, self.conv)


class Upsample(nn.Module):
    def __init__(self, nx, channels: int):
        super().__init__()
        self.nx = nx
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.nx.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"), self.conv)


def split_heads(t, heads: int):
    b, l, inner = t.shape
    return t.reshape(b, l, heads, inner // heads).transpose(1, 2)


def merge_heads(t):
    b, h, l, d = t.shape
    return t.transpose(1, 2).reshape(b, l, h * d)


class CrossAttention(nn.Module):
    """Bias-free q/k/v projections, biased output projection."""

    def __init__(self, nx, query_dim: int, context_dim: int, heads: int, head_dim: int):
        super().__init__()
        self.nx, self.heads = nx, heads
        inner = heads * head_dim
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def forward(self, x, key_bias=None, zero_context: bool = False):
        out = self.to_out[0]
        if zero_context:
            # Zero text conditioning: v = 0, so the attention is 0 and the
            # block's output is the output projection's bias.
            return out.bias.expand(x.shape[0], x.shape[1], -1)
        nx = self.nx
        q, k, v = (split_heads(nx.linear(x, lin.weight), self.heads)
                   for lin in (self.to_q, self.to_k, self.to_v))
        o = merge_heads(attention(nx, q, k, v, key_bias))
        return nx.linear(o, out.weight, out.bias)


class FeedForward(nn.Module):
    """GEGLU, mult 4: ``net.0.proj`` (to 8C, value then gate) and ``net.2``."""

    def __init__(self, nx, dim: int, mult: int = 4):
        super().__init__()
        self.nx = nx
        geglu = nn.Module()
        geglu.proj = nn.Linear(dim, dim * mult * 2)
        self.net = nn.ModuleList([geglu, nn.Identity(), nn.Linear(dim * mult, dim)])

    def forward(self, x):
        proj, out = self.net[0].proj, self.net[2]
        a, gate = self.nx.linear(x, proj.weight, proj.bias).chunk(2, dim=-1)
        return self.nx.linear(a * F.gelu(gate), out.weight, out.bias)


class TransformerBlock2D(nn.Module):
    def __init__(self, nx, dim: int, heads: int, head_dim: int, context_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn1 = CrossAttention(nx, dim, dim, heads, head_dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn2 = CrossAttention(nx, dim, context_dim, heads, head_dim)
        self.norm3 = nn.LayerNorm(dim, eps=LN_EPS)
        self.ff = FeedForward(nx, dim)

    def forward(self, x):
        x = x + self.attn1(layer_norm(x, self.norm1))
        x = x + self.attn2(x, zero_context=True)
        return x + self.ff(layer_norm(x, self.norm3))


class Transformer2D(nn.Module):
    """SD2.1 spatial transformer with linear projections."""

    def __init__(self, nx, channels: int, heads: int, context_dim: int, groups: int):
        super().__init__()
        self.nx = nx
        self.norm = GroupNorm(groups, channels, 1e-6)
        self.proj_in = nn.Linear(channels, channels)
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock2D(nx, channels, heads, channels // heads, context_dim)])
        self.proj_out = nn.Linear(channels, channels)

    def forward(self, x):
        b, c, h, w = x.shape
        t = self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        t = self.nx.linear(t, self.proj_in.weight, self.proj_in.bias)
        for blk in self.transformer_blocks:
            t = blk(t)
        t = self.nx.linear(t, self.proj_out.weight, self.proj_out.bias)
        return t.reshape(b, h, w, c).permute(0, 3, 1, 2) + x


def view_key_bias(view_mask, tokens_per_view: int):
    """(b, v) bool -> (b, v * l) additive key bias: 0 kept, NEG_INF masked."""
    bias = torch.where(view_mask, 0.0, NEG_INF).to(torch.float32)
    return bias.repeat_interleave(tokens_per_view, dim=-1)


class BasicTransformerBlock3D(nn.Module):
    """attn1 over all views' tokens jointly, attn2 within each view, GEGLU."""

    def __init__(self, nx, dim: int, heads: int, head_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn1 = CrossAttention(nx, dim, dim, heads, head_dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn2 = CrossAttention(nx, dim, dim, heads, head_dim)
        self.norm3 = nn.LayerNorm(dim, eps=LN_EPS)
        self.ff = FeedForward(nx, dim)

    def forward(self, x, num_views: int, view_mask=None):
        bv, l, c = x.shape
        joint = x.reshape(bv // num_views, num_views * l, c)
        bias = None if view_mask is None else view_key_bias(view_mask, l)
        joint = joint + self.attn1(layer_norm(joint, self.norm1), key_bias=bias)
        x = joint.reshape(bv, l, c)
        x = x + self.attn2(layer_norm(x, self.norm2))
        return x + self.ff(layer_norm(x, self.norm3))


class SpatialTransformer3D(nn.Module):
    def __init__(self, nx, mv: Dict, channels: int, groups: int):
        super().__init__()
        self.nx = nx
        heads = mv["num_heads"]
        head_dim = mv.get("d_dot") or channels // heads
        self.norm = GroupNorm(groups, channels, 1e-6)
        self.proj_in = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock3D(nx, channels, heads, head_dim)
             for _ in range(mv.get("num_layers", 1))])
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x, num_views: int, view_mask=None):
        bv, c, h, w = x.shape
        t = self.nx.conv(self.norm(x), self.proj_in).permute(0, 2, 3, 1).reshape(bv, h * w, c)
        for blk in self.transformer_blocks:
            t = blk(t, num_views, view_mask)
        t = t.reshape(bv, h, w, c).permute(0, 3, 1, 2)
        return self.nx.conv(t, self.proj_out) + x


class ViTAttention(nn.Module):
    def __init__(self, nx, dim: int, heads: int, head_dim: int):
        super().__init__()
        self.nx, self.heads = nx, heads
        inner = heads * head_dim
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        if not (heads == 1 and head_dim == dim):
            self.to_out = nn.ModuleList([nn.Linear(inner, dim)])

    def forward(self, x, key_bias=None):
        nx = self.nx
        q, k, v = (split_heads(t, self.heads)
                   for t in nx.linear(x, self.to_qkv.weight).chunk(3, dim=-1))
        o = merge_heads(attention(nx, q, k, v, key_bias))
        if hasattr(self, "to_out"):
            o = nx.linear(o, self.to_out[0].weight, self.to_out[0].bias)
        return o


class StandardTransformer(nn.Module):
    """The standard cross-view block: a PreNorm ViT over all views' tokens
    (exact GELU MLP), not residual at the module level. The configurations
    run it without conv down / up-scaling or position encoding; the
    reference refuses both."""

    def __init__(self, nx, mv: Dict, channels: int):
        super().__init__()
        if mv.get("downscale", 1) != 1 or mv.get("pos_enc"):
            raise ValueError("the reference's standard block has no down-scaling "
                             "or position encoding")
        c = channels
        self.nx, self.depth = nx, mv.get("num_layers", 1)
        heads = mv["num_heads"]
        head_dim = mv.get("d_dot") or c // heads
        mlp = mv.get("d_mlp") or c * (mv.get("d_mlp_multiplier") or 1)
        t = nn.Module()
        for i in range(self.depth):
            t.add_module(f"norm_attn_{i}", nn.LayerNorm(c, eps=LN_EPS))
            t.add_module(f"attn_{i}", ViTAttention(nx, c, heads, head_dim))
            t.add_module(f"norm_ff_{i}", nn.LayerNorm(c, eps=LN_EPS))
            t.add_module(f"ff_{i}", nn.Module())
            getattr(t, f"ff_{i}").net = nn.Sequential(nn.Linear(c, mlp), nn.GELU(),
                                                      nn.Linear(mlp, c))
        self.transformer = t

    def forward(self, x, num_views: int, view_mask=None):
        nx = self.nx
        bv, c, h, w = x.shape
        t = x.permute(0, 2, 3, 1).reshape(bv // num_views, num_views * h * w, c)
        bias = None if view_mask is None else view_key_bias(view_mask, h * w)
        tr = self.transformer
        for i in range(self.depth):
            t = t + getattr(tr, f"attn_{i}")(layer_norm(t, getattr(tr, f"norm_attn_{i}")), bias)
            net = getattr(tr, f"ff_{i}").net
            hid = layer_norm(t, getattr(tr, f"norm_ff_{i}"))
            hid = F.gelu(nx.linear(hid, net[0].weight, net[0].bias))
            t = t + nx.linear(hid, net[2].weight, net[2].bias)
        return t.reshape(bv, h, w, c).permute(0, 3, 1, 2)


def _holder(**modules) -> nn.Module:
    m = nn.Module()
    for name, mod in modules.items():
        setattr(m, name, mod)
    return m


class MultiViewUNet(nn.Module):
    """The denoiser: ``unet.*`` (diffusers names) and
    ``cross_attn_blocks_{encoder,mid,decoder}``, a cross-view block after
    every stage whose map is at most ``cross_view_max_size`` square."""

    def __init__(self, nx: Numerics, denoiser: Dict, in_channels: int, out_channels: int = 4):
        super().__init__()
        self.nx = nx
        bb = denoiser["autoencoder"]
        if denoiser.get("up_block_attention"):
            raise ValueError("the reference leaves the up-block SD attentions out")
        self.cross_view_max_size = denoiser["cross_view_max_size"]
        ch = list(bb["block_out_channels"])
        heads = list(bb["num_attention_heads"])
        groups, eps, lpb = bb["norm_num_groups"], bb["norm_eps"], bb["layers_per_block"]
        ctx_dim = bb["cross_attention_dim"]
        temb = ch[0] * 4
        n = len(ch)

        down, cin = [], ch[0]
        for i, btype in enumerate(bb["down_block_types"]):
            blk = _holder(resnets=nn.ModuleList(
                [ResnetBlock(nx, cin if j == 0 else ch[i], ch[i], temb, groups, eps)
                 for j in range(lpb)]))
            if btype == "CrossAttnDownBlock2D":
                blk.attentions = nn.ModuleList(
                    [Transformer2D(nx, ch[i], heads[i], ctx_dim, groups) for _ in range(lpb)])
            if i < n - 1:
                blk.downsamplers = nn.ModuleList([Downsample(nx, ch[i])])
            down.append(blk)
            cin = ch[i]

        skip_ch: List[int] = [ch[0]]
        for i in range(n):
            skip_ch += [ch[i]] * lpb + ([ch[i]] if i < n - 1 else [])
        rev = ch[::-1]
        up, hidden = [], ch[-1]
        for i in range(n):
            resnets = []
            for _ in range(lpb + 1):
                resnets.append(ResnetBlock(nx, hidden + skip_ch.pop(), rev[i], temb, groups, eps))
                hidden = rev[i]
            blk = _holder(resnets=nn.ModuleList(resnets))
            if i < n - 1:
                blk.upsamplers = nn.ModuleList([Upsample(nx, rev[i])])
            up.append(blk)

        self.unet = _holder(
            time_embedding=_holder(linear_1=nn.Linear(ch[0], temb), linear_2=nn.Linear(temb, temb)),
            conv_in=nn.Conv2d(in_channels, ch[0], 3, padding=1),
            down_blocks=nn.ModuleList(down),
            mid_block=_holder(
                resnets=nn.ModuleList([ResnetBlock(nx, ch[-1], ch[-1], temb, groups, eps)
                                       for _ in range(2)]),
                attentions=nn.ModuleList([Transformer2D(nx, ch[-1], heads[-1], ctx_dim, groups)])),
            up_blocks=nn.ModuleList(up),
            conv_norm_out=GroupNorm(groups, ch[0], eps, silu=True),
            conv_out=nn.Conv2d(ch[0], out_channels, 3, padding=1),
        )
        mv = denoiser["multi_view_attention"]

        def cross(c):
            if mv["name"] == "standard":
                return StandardTransformer(nx, mv, c)
            return SpatialTransformer3D(nx, mv, c, groups)

        if denoiser.get("encoder_conditioning", True):
            self.cross_attn_blocks_encoder = nn.ModuleList([cross(c) for c in ch])
        if denoiser.get("mid_conditioning", True):
            self.cross_attn_blocks_mid = nn.ModuleList([cross(ch[-1])])
        if denoiser.get("decoder_conditioning", True):
            self.cross_attn_blocks_decoder = nn.ModuleList([cross(c) for c in rev])

    def _cross(self, group: str, i: int, x, v: int, view_mask):
        h, w = x.shape[-2:]
        size = self.cross_view_max_size
        if h > size or w > size or not hasattr(self, group):
            return x
        return getattr(self, group)[i](x, v, view_mask)

    def forward(self, latents, timestep, view_mask=None):
        """latents (b, v, h, w, c_in); timestep (b, v) -> (b, v, h, w, 4)."""
        nx, u = self.nx, self.unet
        b, v, h0, w0, _ = latents.shape
        te = u.time_embedding
        t_emb = timestep_embedding(timestep.reshape(b * v), u.conv_in.out_channels)
        temb = nx.linear(t_emb, te.linear_1.weight, te.linear_1.bias)
        temb = nx.linear(F.silu(temb), te.linear_2.weight, te.linear_2.bias)

        hidden = nx.conv(latents.reshape(b * v, h0, w0, -1).permute(0, 3, 1, 2).float(),
                         u.conv_in)
        skips = [hidden]
        for i, blk in enumerate(u.down_blocks):
            for j, res in enumerate(blk.resnets):
                hidden = res(hidden, temb)
                if hasattr(blk, "attentions"):
                    hidden = blk.attentions[j](hidden)
                skips.append(hidden)
            hidden = self._cross("cross_attn_blocks_encoder", i, hidden, v, view_mask)
            if hasattr(blk, "downsamplers"):
                hidden = blk.downsamplers[0](hidden)
                skips.append(hidden)
        mid = u.mid_block
        hidden = mid.resnets[1](mid.attentions[0](mid.resnets[0](hidden, temb)), temb)
        hidden = self._cross("cross_attn_blocks_mid", 0, hidden, v, view_mask)
        for i, blk in enumerate(u.up_blocks):
            for res in blk.resnets:
                hidden = res(torch.cat([hidden, skips.pop()], dim=1), temb)
            hidden = self._cross("cross_attn_blocks_decoder", i, hidden, v, view_mask)
            if hasattr(blk, "upsamplers"):
                hidden = blk.upsamplers[0](hidden)
        hidden = nx.conv(u.conv_norm_out(hidden), u.conv_out)
        return hidden.permute(0, 2, 3, 1).reshape(b, v, h0, w0, -1)


class AttnBlockVAE(nn.Module):
    """The VAE mid block's single-head spatial self-attention."""

    def __init__(self, nx, c: int, groups: int):
        super().__init__()
        self.nx = nx
        self.group_norm = GroupNorm(groups, c, 1e-6)
        self.to_q, self.to_k, self.to_v = (nn.Linear(c, c) for _ in range(3))
        self.to_out = nn.ModuleList([nn.Linear(c, c)])

    def forward(self, x):
        nx = self.nx
        b, c, h, w = x.shape
        t = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q, k, v = (nx.linear(t, lin.weight, lin.bias)[:, None]
                   for lin in (self.to_q, self.to_k, self.to_v))
        o = attention(nx, q, k, v)[:, 0]
        o = nx.linear(o, self.to_out[0].weight, self.to_out[0].bias)
        return o.reshape(b, h, w, c).permute(0, 3, 1, 2) + x


def _mid(nx, c, groups, with_attention):
    m = nn.Module()
    m.resnets = nn.ModuleList([ResnetBlock(nx, c, c, None, groups, 1e-6) for _ in range(2)])
    if with_attention:
        m.attentions = nn.ModuleList([AttnBlockVAE(nx, c, groups)])
    return m


def _run_mid(m, h):
    h = m.resnets[0](h)
    if hasattr(m, "attentions"):
        h = m.attentions[0](h)
    return m.resnets[1](h)


class Encoder(nn.Module):
    def __init__(self, nx, kw: Dict):
        super().__init__()
        self.nx = nx
        ch, g, lpb = list(kw["block_out_channels"]), kw["norm_num_groups"], kw["layers_per_block"]
        self.conv_in = nn.Conv2d(kw["in_channels"], ch[0], 3, padding=1)
        blocks, cin = [], ch[0]
        for i, c in enumerate(ch):
            blk = nn.Module()
            blk.resnets = nn.ModuleList(
                [ResnetBlock(nx, cin if j == 0 else c, c, None, g, 1e-6) for j in range(lpb)])
            if i < len(ch) - 1:
                blk.downsamplers = nn.ModuleList([Downsample(nx, c, asymmetric=True)])
            blocks.append(blk)
            cin = c
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = _mid(nx, ch[-1], g, kw["mid_block_add_attention"])
        self.conv_norm_out = GroupNorm(g, ch[-1], 1e-6, silu=True)
        self.conv_out = nn.Conv2d(ch[-1], 2 * kw["latent_channels"], 3, padding=1)

    def forward(self, x):
        h = self.nx.conv(x, self.conv_in)
        for blk in self.down_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
        return self.nx.conv(self.conv_norm_out(_run_mid(self.mid_block, h)), self.conv_out)


class Decoder(nn.Module):
    def __init__(self, nx, kw: Dict):
        super().__init__()
        self.nx = nx
        rev = list(kw["block_out_channels"])[::-1]
        g, lpb = kw["norm_num_groups"], kw["layers_per_block"]
        self.conv_in = nn.Conv2d(kw["latent_channels"], rev[0], 3, padding=1)
        self.mid_block = _mid(nx, rev[0], g, kw["mid_block_add_attention"])
        blocks, cin = [], rev[0]
        for i, c in enumerate(rev):
            blk = nn.Module()
            blk.resnets = nn.ModuleList(
                [ResnetBlock(nx, cin if j == 0 else c, c, None, g, 1e-6) for j in range(lpb + 1)])
            if i < len(rev) - 1:
                blk.upsamplers = nn.ModuleList([Upsample(nx, c)])
            blocks.append(blk)
            cin = c
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = GroupNorm(g, rev[-1], 1e-6, silu=True)
        self.conv_out = nn.Conv2d(rev[-1], kw["out_channels"], 3, padding=1)

    def forward(self, z):
        h = _run_mid(self.mid_block, self.nx.conv(z, self.conv_in))
        for blk in self.up_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        return self.nx.conv(self.conv_norm_out(h), self.conv_out)


class AutoencoderKL(nn.Module):
    def __init__(self, nx: Numerics, kw: Dict):
        super().__init__()
        self.nx, self.kw = nx, kw
        self.encoder = Encoder(nx, kw)
        self.decoder = Decoder(nx, kw)
        c = kw["latent_channels"]
        if kw["use_quant_conv"]:
            self.quant_conv = nn.Conv2d(2 * c, 2 * c, 1)
        if kw["use_post_quant_conv"]:
            self.post_quant_conv = nn.Conv2d(c, c, 1)

    def moments(self, x):
        """(b, h, w, 3) in [-1, 1] -> (b, h/8, w/8, 2c) posterior mean and logvar."""
        m = self.encoder(x.permute(0, 3, 1, 2).float())
        if hasattr(self, "quant_conv"):
            m = self.nx.conv(m, self.quant_conv)
        return m.permute(0, 2, 3, 1)

    def decode(self, z):
        """(b, h/8, w/8, c) -> (b, h, w, 3) in [-1, 1] (not clamped)."""
        h = z.permute(0, 3, 1, 2).float()
        if hasattr(self, "post_quant_conv"):
            h = self.nx.conv(h, self.post_quant_conv)
        return self.decoder(h).permute(0, 2, 3, 1)


def posterior_sample(moments, eps):
    """mean + exp(logvar / 2) * eps, logvar clamped to [-30, 20]."""
    mean, logvar = moments.chunk(2, dim=-1)
    return mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * eps


class Model(nn.Module):
    """``denoiser`` and ``autoencoder``, the parameter tree the seeded
    weights are keyed by."""

    def __init__(self, model_cfg: Dict, nx: Optional[Numerics] = None):
        super().__init__()
        nx = nx or Numerics()
        self.cfg = model_cfg
        self.denoiser = MultiViewUNet(nx, model_cfg["denoiser"], unet_in_channels(model_cfg))
        self.autoencoder = AutoencoderKL(nx, model_cfg["autoencoder"]["kwargs"])


def unet_in_channels(model_cfg: Dict) -> int:
    """latent + ray channels + the target-mask channel."""
    if model_cfg["use_ray_encoding"] or model_cfg["srt_ray_encoding"]:
        raise ValueError("the reference takes the raw 3 + 3 ray channels only")
    return model_cfg["autoencoder"]["kwargs"]["latent_channels"] + 6 + 1


def unet_inputs(model_cfg: Dict, b: int, v: int, hw: int, backward: bool = False):
    """``(x, t)`` of one denoiser forward on the meta device: latents with
    their ray and mask channels, (b, v, hw, hw, c_in), and every view's
    timestep, (b, v)."""
    x = torch.empty(b, v, hw, hw, unet_in_channels(model_cfg), device="meta",
                    requires_grad=backward)
    t = torch.zeros(b, v, dtype=torch.int64, device="meta")
    return x, t
