"""The plain reference of MVDream (Shi et al., "MVDream: Multi-view
Diffusion for 3D Generation", arXiv:2308.16512; ``bytedance/MVDream``,
``mvdream/configs/sd-v2-base.yaml``): the SD2.1-base UNet with a
``SpatialTransformer3D`` at each of its 16 attention sites, a camera MLP
on the timestep embedding, the SD2.1 KL VAE, and its DDIM sampler with
classifier-free guidance, in plain PyTorch operations and float32.

It follows MVDream's ``MultiViewUNetModel`` and ``BasicTransformerBlock3D``
(``ldm/modules/diffusionmodules/openaimodel.py``, ``ldm/modules/attention.py``)
in their published form: rows are (prompt, view) pairs, attn1 rearranges
``(b f) l c -> b (f l) c`` and back, attn2 attends onto the prompt's text
tokens repeated for each view. The text keys and values are projected once
a prompt and then repeated, the same numbers as MVDream's projection of
each view's copy, so that the FLOP count holds only what a program need
run. It carries diffusers' parameter names
(``unet.*``, MVDream's ``camera_embed`` as ``unet.camera_embedding``), so
one set of seeded weights, keyed by name, serves the program and this
model. It imports nothing of the program. Departures from the paper:

* the weights are seeded, not the released ``sd-v2.1-base-4view``;
* the text tokens are drawn from the seed in the OpenCLIP ViT-H/14 text
  tower's place (its vocabulary is not in the repository).

The VAE and the blocks MVDream shares with MV-LDM come from
``reference/model.py``. Every product goes through a
:class:`~benchmark.reference.numerics.Numerics`, so the same model
computes the control in fp8. The planted faults of ``kinds/t2mv.py``'s
control switch parts of the denoiser off (``joint_views``, ``use_text``,
``use_camera``); the reference itself has them all on.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .model import (
    AutoencoderKL,
    Downsample,
    FeedForward,
    GroupNorm,
    ResnetBlock,
    Upsample,
    _holder,
    attention,
    merge_heads,
    split_heads,
    timestep_embedding,
)
from .numerics import Numerics
from .sampling import decode_u8

GROUPS = 32
NORM_EPS = 1e-5  # GroupNorm32 and nn.LayerNorm defaults
TEXT_TOKENS = 77  # OpenCLIP's context length


def layer_norm(x, norm: nn.LayerNorm):
    return F.layer_norm(x, (x.shape[-1],), norm.weight, norm.bias, norm.eps)


class CrossAttention(nn.Module):
    """ldm's ``CrossAttention``: bias-free q / k / v, biased ``to_out.0``;
    keys and values from ``context``, or from ``x`` without one. A
    ``context`` of one row a prompt is projected, then repeated for each of
    the prompt's ``frames`` rows of ``x``."""

    def __init__(self, nx, query_dim: int, context_dim: int, heads: int, head_dim: int):
        super().__init__()
        self.nx, self.heads = nx, heads
        inner = heads * head_dim
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def forward(self, x, context=None, frames: int = 1):
        nx = self.nx
        context = x if context is None else context
        q = split_heads(nx.linear(x, self.to_q.weight), self.heads)
        k = split_heads(nx.linear(context, self.to_k.weight).repeat_interleave(frames, 0),
                        self.heads)
        v = split_heads(nx.linear(context, self.to_v.weight).repeat_interleave(frames, 0),
                        self.heads)
        out = self.to_out[0]
        return nx.linear(merge_heads(attention(nx, q, k, v)), out.weight, out.bias)


class BasicTransformerBlock3D(nn.Module):
    def __init__(self, nx, dim: int, heads: int, head_dim: int, context_dim: int,
                 faults: Dict[str, bool]):
        super().__init__()
        self.faults = faults
        self.norm1 = nn.LayerNorm(dim, eps=NORM_EPS)
        self.attn1 = CrossAttention(nx, dim, dim, heads, head_dim)
        self.norm2 = nn.LayerNorm(dim, eps=NORM_EPS)
        self.attn2 = CrossAttention(nx, dim, context_dim, heads, head_dim)
        self.norm3 = nn.LayerNorm(dim, eps=NORM_EPS)
        self.ff = FeedForward(nx, dim)

    def forward(self, x, context, num_frames: int):
        """x (b f, l, c); context (b, Lt, c_ctx), one prompt a row."""
        bf, l, c = x.shape
        frames = num_frames if self.faults["joint_views"] else 1
        x = x.reshape(bf // frames, frames * l, c)
        x = self.attn1(layer_norm(x, self.norm1)) + x
        x = x.reshape(bf, l, c)
        if self.faults["use_text"]:
            x = self.attn2(layer_norm(x, self.norm2), context, num_frames) + x
        else:  # the text left out: attn2 is its output bias alone
            x = x + self.attn2.to_out[0].bias
        return self.ff(layer_norm(x, self.norm3)) + x


class SpatialTransformer3D(nn.Module):
    """GroupNorm (eps 1e-6), linear ``proj_in``, the blocks, linear
    ``proj_out``, residual (``use_linear_in_transformer``)."""

    def __init__(self, nx, channels: int, head_dim: int, depth: int, context_dim: int,
                 faults: Dict[str, bool]):
        super().__init__()
        self.nx = nx
        self.norm = GroupNorm(GROUPS, channels, 1e-6)
        self.proj_in = nn.Linear(channels, channels)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock3D(nx, channels, channels // head_dim, head_dim, context_dim,
                                     faults) for _ in range(depth)])
        self.proj_out = nn.Linear(channels, channels)

    def forward(self, x, context, num_frames: int):
        b, c, h, w = x.shape
        t = self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        t = self.nx.linear(t, self.proj_in.weight, self.proj_in.bias)
        for blk in self.transformer_blocks:
            t = blk(t, context, num_frames)
        t = self.nx.linear(t, self.proj_out.weight, self.proj_out.bias)
        return t.reshape(b, h, w, c).permute(0, 3, 1, 2) + x


class MultiViewUNetModel(nn.Module):
    """MVDream's denoiser under diffusers' names (``unet.*``)."""

    def __init__(self, nx: Numerics, cfg: Dict):
        super().__init__()
        self.nx = nx
        # Planted faults switch these off (kinds/t2mv.py); the reference has them on.
        self.faults = {"joint_views": True, "use_text": True, "use_camera": True}
        ch = [cfg["model_channels"] * m for m in cfg["channel_mult"]]
        n, lpb = len(ch), cfg["num_res_blocks"]
        temb = cfg["model_channels"] * 4
        attends = [(1 << i) in cfg["attention_resolutions"] for i in range(n)]

        def res(cin, cout):
            return ResnetBlock(nx, cin, cout, temb, GROUPS, NORM_EPS)

        def st(c):
            return SpatialTransformer3D(nx, c, cfg["num_head_channels"],
                                        cfg["transformer_depth"], cfg["context_dim"], self.faults)

        down, cin = [], ch[0]
        for i in range(n):
            blk = _holder(resnets=nn.ModuleList(
                [res(cin if j == 0 else ch[i], ch[i]) for j in range(lpb)]))
            if attends[i]:
                blk.attentions = nn.ModuleList([st(ch[i]) for _ in range(lpb)])
            if i < n - 1:
                blk.downsamplers = nn.ModuleList([Downsample(nx, ch[i])])
            down.append(blk)
            cin = ch[i]
        skip_ch: List[int] = [ch[0]]
        for i in range(n):
            skip_ch += [ch[i]] * lpb + ([ch[i]] if i < n - 1 else [])
        up, hidden = [], ch[-1]
        for i in reversed(range(n)):
            resnets = []
            for _ in range(lpb + 1):
                resnets.append(res(hidden + skip_ch.pop(), ch[i]))
                hidden = ch[i]
            blk = _holder(resnets=nn.ModuleList(resnets))
            if attends[i]:
                blk.attentions = nn.ModuleList([st(ch[i]) for _ in range(lpb + 1)])
            if i > 0:
                blk.upsamplers = nn.ModuleList([Upsample(nx, ch[i])])
            up.append(blk)
        self.unet = _holder(
            time_embedding=_holder(linear_1=nn.Linear(ch[0], temb), linear_2=nn.Linear(temb, temb)),
            camera_embedding=_holder(linear_1=nn.Linear(cfg["camera_dim"], temb),
                                     linear_2=nn.Linear(temb, temb)),
            conv_in=nn.Conv2d(cfg["in_channels"], ch[0], 3, padding=1),
            down_blocks=nn.ModuleList(down),
            mid_block=_holder(resnets=nn.ModuleList([res(ch[-1], ch[-1]) for _ in range(2)]),
                              attentions=nn.ModuleList([st(ch[-1])])),
            up_blocks=nn.ModuleList(up),
            conv_norm_out=GroupNorm(GROUPS, ch[0], NORM_EPS, silu=True),
            conv_out=nn.Conv2d(ch[0], cfg["out_channels"], 3, padding=1),
        )

    def _mlp(self, holder, x):
        nx = self.nx
        h = nx.linear(x, holder.linear_1.weight, holder.linear_1.bias)
        return nx.linear(F.silu(h), holder.linear_2.weight, holder.linear_2.bias)

    def forward(self, latents, timesteps, context, camera):
        """latents (b, f, h, w, c); timesteps (b, f); context (b, Lt,
        c_ctx), one prompt a row; camera (b, f, 16) -> (b, f, h, w, c)."""
        nx, u = self.nx, self.unet
        b, f, h0, w0, _ = latents.shape
        emb = self._mlp(u.time_embedding, timestep_embedding(timesteps.reshape(b * f),
                                                             u.conv_in.out_channels))
        if self.faults["use_camera"]:
            emb = emb + self._mlp(u.camera_embedding, camera.reshape(b * f, -1).float())
        context = context.float()

        h = nx.conv(latents.reshape(b * f, h0, w0, -1).permute(0, 3, 1, 2).float(), u.conv_in)
        hs = [h]
        for blk in u.down_blocks:
            for j, res in enumerate(blk.resnets):
                h = res(h, emb)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[j](h, context, f)
                hs.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
                hs.append(h)
        mid = u.mid_block
        h = mid.resnets[1](mid.attentions[0](mid.resnets[0](h, emb), context, f), emb)
        for blk in u.up_blocks:
            for j, res in enumerate(blk.resnets):
                h = res(torch.cat([h, hs.pop()], dim=1), emb)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[j](h, context, f)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        h = nx.conv(u.conv_norm_out(h), u.conv_out)
        return h.permute(0, 2, 3, 1).reshape(b, f, h0, w0, -1)


class Model(nn.Module):
    """``denoiser`` and ``autoencoder``, the parameter tree the seeded
    weights are keyed by."""

    def __init__(self, model_cfg: Dict, nx: Optional[Numerics] = None):
        super().__init__()
        nx = nx or Numerics()
        self.cfg = model_cfg
        if model_cfg["denoiser"].get("name") != "mvdream":
            raise ValueError("reference/mvdream.py builds the denoiser named 'mvdream'")
        self.denoiser = MultiViewUNetModel(nx, model_cfg["denoiser"])
        self.autoencoder = AutoencoderKL(nx, model_cfg["autoencoder"]["kwargs"])


def unet_inputs(model_cfg: Dict, b: int, v: int, hw: int, backward: bool = False):
    """``(x, t, context, camera)`` of one denoiser forward on the meta
    device: latents (b, v, hw, hw, 4), timesteps (b, v), one prompt's 77
    text tokens a row, (b, 77, context_dim), and each view's flattened
    camera, (b, v, camera_dim)."""
    d = model_cfg["denoiser"]
    x = torch.empty(b, v, hw, hw, d["in_channels"], device="meta", requires_grad=backward)
    t = torch.zeros(b, v, dtype=torch.int64, device="meta")
    context = torch.empty(b, TEXT_TOKENS, d["context_dim"], device="meta")
    camera = torch.empty(b, v, d["camera_dim"], device="meta")
    return x, t, context, camera


# ---------------------------------------------------------------- DDIM

@dataclass
class DDIM:
    """ldm's ``DDIMSampler`` at eta 0 (``make_ddim_timesteps`` "uniform",
    ``make_ddim_sampling_parameters``): S timesteps ``i * (T // S) + 1``
    (ldm's ``range(0, T, T // S) + 1`` where S divides T), alpha_prev of
    the first timestep alphas_cumprod[0]; SD2.1's scaled-linear betas;
    epsilon prediction, no clipping."""

    alphas_cumprod: np.ndarray  # float32 table
    ddim_timesteps: np.ndarray  # ascending

    @classmethod
    def from_cfg(cls, sched: Dict) -> "DDIM":
        kw = sched["kwargs"]
        if (kw["beta_schedule"], kw["prediction_type"], kw["clip_sample"],
                kw["set_alpha_to_one"], kw["steps_offset"]) != (
                    "scaled_linear", "epsilon", False, False, 1):
            raise ValueError(f"the reference DDIM of MVDream does not take {kw}")
        n = kw["num_train_timesteps"]
        betas = np.linspace(kw["beta_start"] ** 0.5, kw["beta_end"] ** 0.5, n,
                            dtype=np.float64) ** 2
        steps = sched["num_inference_steps"]
        return cls(np.cumprod(1.0 - betas).astype(np.float32),
                   np.arange(steps) * (n // steps) + 1)

    def timesteps(self) -> List[int]:
        return [int(t) for t in self.ddim_timesteps[::-1]]

    def step(self, eps: torch.Tensor, t: int, x: torch.Tensor) -> torch.Tensor:
        i = int(np.searchsorted(self.ddim_timesteps, t))
        a_t = float(self.alphas_cumprod[t])
        a_prev = float(self.alphas_cumprod[self.ddim_timesteps[i - 1] if i > 0 else 0])
        x0 = (x - np.sqrt(1.0 - a_t) * eps) / np.sqrt(a_t)
        return np.sqrt(a_prev) * x0 + np.sqrt(1.0 - a_prev) * eps


def sample(model: Model, ddim: DDIM, cfg_scale: float, text: torch.Tensor,
           empty_text: torch.Tensor, cameras: torch.Tensor,
           initial_noise: torch.Tensor) -> torch.Tensor:
    """MVDream's ``t2i``: prompts' text tokens (b, Lt, c_ctx), the empty
    prompt's (Lt, c_ctx), cameras (b, f, 16), initial noise (b, f, h, w, 4)
    -> (b, f, 8h, 8w, 3) uint8, truncated as the program quantizes.
    Guidance in its published form: a conditional and an unconditional
    forward a step."""
    dev = initial_noise.device
    b, f = initial_noise.shape[:2]
    unet = model.denoiser
    text, cameras = text.float().to(dev), cameras.float().to(dev)
    empty = empty_text.float().to(dev).expand(b, -1, -1)
    x = initial_noise.float()
    for t in ddim.timesteps():
        ts = torch.full((b, f), t, dtype=torch.int64, device=dev)
        cond = unet(x, ts, text, cameras)
        uncond = unet(x, ts, empty, cameras)
        x = ddim.step(uncond + cfg_scale * (cond - uncond), t, x)
    return decode_u8(model, x)
