"""AutoencoderKL, the SD2.1 VAE (counterpart of
``mvldm_tpu/models/vae.py``). Parameter names are diffusers' (``encoder.*``,
``decoder.*``, ``quant_conv``, ``post_quant_conv``); ``encode`` / ``decode``
keep the JAX layout (b, h, w, c). The 0.18215 latent scale is applied by
the diffusion engine.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch
import torch.nn as nn

from .layers import AttnBlockVAE, Downsample, GroupNorm, ResnetBlock, Upsample


@dataclass
class AutoencoderKLCfg:
    in_channels: int = 3
    out_channels: int = 3
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    use_quant_conv: bool = True
    use_post_quant_conv: bool = True
    mid_block_add_attention: bool = True


@dataclass
class AutoencoderCfg:
    """Registry-level cfg; ``pretrained_from`` is not read (weights come
    from ``checkpointing.load``)."""

    name: str = "kl"
    pretrained_from: Optional[str] = None
    kwargs: AutoencoderKLCfg = field(default_factory=AutoencoderKLCfg)


class DiagonalGaussian:
    """Mean / logvar latent distribution over the last axis of ``moments``
    (diffusers semantics: logvar clamped to [-30, 20])."""

    def __init__(self, moments: torch.Tensor):
        self.mean, logvar = moments.chunk(2, dim=-1)
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)

    def sample(self, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mean + std * eps, eps drawn from ``generator`` unless given."""
        if noise is None:
            noise = torch.randn(self.mean.shape, generator=generator,
                                dtype=torch.float32, device=self.mean.device)
        return self.mean + self.std * noise.to(self.mean.dtype)


def _mid_block(c: int, groups: int, attention: bool) -> nn.Module:
    m = nn.Module()
    m.resnets = nn.ModuleList([ResnetBlock(c, c, None, groups, 1e-6) for _ in range(2)])
    if attention:
        m.attentions = nn.ModuleList([AttnBlockVAE(c, groups)])
    return m


def _run_mid(m: nn.Module, h: torch.Tensor) -> torch.Tensor:
    h = m.resnets[0](h)
    if hasattr(m, "attentions"):
        h = m.attentions[0](h)
    return m.resnets[1](h)


class Encoder(nn.Module):
    def __init__(self, cfg: AutoencoderKLCfg):
        super().__init__()
        ch, g, lpb = cfg.block_out_channels, cfg.norm_num_groups, cfg.layers_per_block
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        blocks = []
        cin = ch[0]
        for i, c in enumerate(ch):
            blk = nn.Module()
            blk.resnets = nn.ModuleList(
                [ResnetBlock(cin if j == 0 else c, c, None, g, 1e-6) for j in range(lpb)])
            if i < len(ch) - 1:
                blk.downsamplers = nn.ModuleList([Downsample(c, asymmetric_padding=True)])
            blocks.append(blk)
            cin = c
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = _mid_block(ch[-1], g, cfg.mid_block_add_attention)
        self.conv_norm_out = GroupNorm(g, ch[-1], 1e-6, act="silu")
        self.conv_out = nn.Conv2d(ch[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for blk in self.down_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
        h = _run_mid(self.mid_block, h)
        return self.conv_out(self.conv_norm_out(h))


class Decoder(nn.Module):
    def __init__(self, cfg: AutoencoderKLCfg):
        super().__init__()
        rev = list(reversed(cfg.block_out_channels))
        g, lpb = cfg.norm_num_groups, cfg.layers_per_block
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = _mid_block(rev[0], g, cfg.mid_block_add_attention)
        blocks = []
        cin = rev[0]
        for i, c in enumerate(rev):
            blk = nn.Module()
            blk.resnets = nn.ModuleList(
                [ResnetBlock(cin if j == 0 else c, c, None, g, 1e-6) for j in range(lpb + 1)])
            if i < len(rev) - 1:
                blk.upsamplers = nn.ModuleList([Upsample(c)])
            blocks.append(blk)
            cin = c
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = GroupNorm(g, rev[-1], 1e-6, act="silu")
        self.conv_out = nn.Conv2d(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = _run_mid(self.mid_block, self.conv_in(z))
        for blk in self.up_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        return self.conv_out(self.conv_norm_out(h))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: AutoencoderKLCfg = None):
        super().__init__()
        self.cfg = cfg = cfg or AutoencoderKLCfg()
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        if cfg.use_quant_conv:
            self.quant_conv = nn.Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)
        if cfg.use_post_quant_conv:
            self.post_quant_conv = nn.Conv2d(cfg.latent_channels, cfg.latent_channels, 1)

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        """x: (b, h, w, 3) in [-1, 1] -> DiagonalGaussian over (b, h/8, w/8, 4)."""
        h = x.permute(0, 3, 1, 2).to(self.encoder.conv_in.weight.dtype)
        moments = self.encoder(h)
        if self.cfg.use_quant_conv:
            moments = self.quant_conv(moments)
        return DiagonalGaussian(moments.permute(0, 2, 3, 1))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z: (b, h/8, w/8, 4) -> (b, h, w, 3) in [-1, 1]."""
        h = z.permute(0, 3, 1, 2).to(self.decoder.conv_in.weight.dtype)
        if self.cfg.use_post_quant_conv:
            h = self.post_quant_conv(h)
        return self.decoder(h).permute(0, 2, 3, 1)
