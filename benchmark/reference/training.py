"""The plain reference of a training step: the diffusion loss (frozen VAE
encode, noising, the UNet with CFG dropout, masked MSE over the target
views) and AdamW with global-norm clipping and gradient accumulation, on
float32 parameters, a leaf at a time. Imports nothing of the program.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from .model import Model, posterior_sample
from .sampling import DDIM, VAE_SCALE, rays


f32 = np.float32


def relative_per_example(extrinsics: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """(b, v, 4, 4) poses relative to view ``index[i]`` of each example."""
    ref = extrinsics[torch.arange(extrinsics.shape[0], device=extrinsics.device), index]
    return torch.linalg.inv(ref)[:, None] @ extrinsics


def loss(model: Model, ddim: DDIM, images, extrinsics, intrinsics, num_context: int,
         draws: Dict[str, torch.Tensor], cfg_train: bool = True) -> torch.Tensor:
    """The noise-prediction MSE over target views. ``draws`` holds the
    step's random draws: ``n_ctx`` (b,) how many of the context slots stay
    context, ``perm_scores`` (b, v_c) which ones (the lowest scores) and
    which is the pose reference (the lowest kept), ``use_relative`` (b,),
    ``posterior_eps`` and ``noise`` (b, v, h, w, c), ``t`` (b,),
    ``unconditional`` (b,)."""
    dev = next(model.parameters()).device
    d = {k: v.to(dev) for k, v in draws.items()}
    images = images.to(dev).float()
    b, v = images.shape[:2]
    h, w = images.shape[2] // 8, images.shape[3] // 8
    rank = torch.argsort(torch.argsort(d["perm_scores"], dim=-1), dim=-1)
    keep = rank < d["n_ctx"][:, None]
    is_target = torch.cat([~keep, torch.ones(b, v - num_context, dtype=torch.bool, device=dev)],
                          dim=1)
    extr = extrinsics.to(dev).float()
    ref_view = torch.where(keep, d["perm_scores"], torch.inf).argmin(dim=-1)
    extr = torch.where(d["use_relative"][:, None, None, None],
                       relative_per_example(extr, ref_view), extr)
    with torch.no_grad():
        m = model.autoencoder.moments(images.reshape(b * v, *images.shape[2:]) * 2.0 - 1.0)
        latents = (posterior_sample(m, d["posterior_eps"].reshape(b * v, h, w, -1))
                   * VAE_SCALE).reshape(b, v, h, w, -1)
    noise = d["noise"].float()
    noisy = ddim.add_noise(latents.reshape(b, -1), noise.reshape(b, -1), d["t"]).reshape(
        latents.shape)
    latents_in = torch.where(is_target[:, :, None, None, None], noisy, latents)
    uncond = d["unconditional"] & cfg_train
    view_mask = is_target | ~uncond[:, None]
    mask = is_target.float()[:, :, None, None, None].expand(b, v, h, w, 1)
    inputs = torch.cat([latents_in, mask, rays(extr, intrinsics.to(dev).float(), (h, w))], dim=-1)
    pred = model.denoiser(inputs, torch.where(is_target, d["t"][:, None], 0), view_mask)
    per_view = ((pred - noise) ** 2).mean(dim=(2, 3, 4))
    return (per_view * is_target).sum() / is_target.sum().clamp_min(1)


class AdamW:
    """clip by global norm -> AdamW (decoupled decay) -> apply every
    ``every_k`` micro-steps on the running mean of their gradients; the
    learning rate at update n is ``lr(n)``, n counting applied updates."""

    def __init__(self, params: Dict[str, torch.Tensor], lr, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=0.01, clip=None, every_k=1):
        self.params, self.lr = params, lr
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay
        self.clip, self.every_k = clip, every_k
        self.acc = {k: torch.zeros_like(p) for k, p in params.items()}
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.micro = 0
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> bool:
        """Take one micro-step's gradients; True when an update was applied."""
        n = self.micro
        for k, g in grads.items():
            self.acc[k] += (g.float() - self.acc[k]) / (n + 1)
        self.micro = (n + 1) % self.every_k
        if n != self.every_k - 1:
            return False
        norm = None
        if self.clip is not None:
            norm = float(torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(a) for a in self.acc.values()])))
            norm = norm if norm >= self.clip else None
        t = self.count + 1
        # Scalars in float32, as optax computes them.
        lr = float(f32(self.lr(self.count)))
        bc1 = float(f32(1) - f32(self.b1) ** f32(t))
        bc2 = float(f32(1) - f32(self.b2) ** f32(t))
        for k, p in self.params.items():
            g = self.acc[k] if norm is None else self.acc[k] / norm * self.clip
            self.mu[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.nu[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            u = self.mu[k] / bc1 / ((self.nu[k] / bc2).sqrt() + self.eps) + self.wd * p
            p.sub_(lr * u)
            self.acc[k].zero_()
        self.count = t
        return True


def linear_lr(base: float, start_factor: float, total_iters: int, end_factor: float = 1.0):
    """LinearLR: the factor goes from ``start_factor`` to ``end_factor``
    over ``total_iters`` updates."""
    def lr(n: int) -> float:
        frac = np.clip(f32(n) / f32(total_iters), f32(0), f32(1))
        return float(f32(base) * (f32(start_factor) + (f32(end_factor) - f32(start_factor)) * frac))
    return lr


@dataclass
class TrainRecord:
    """What a training check compares: each micro-step's loss, the first
    update's gradient norm by leaf and each leaf's change over the checked
    updates."""

    losses: List[float]
    grad_norms: Dict[str, float]
    change_norms: Dict[str, float]


def first_gradient_norms(mu: Dict[str, torch.Tensor], b1: float) -> Dict[str, float]:
    """The norms of the gradient the optimizer took at its first update,
    read from its first moment after that update: mu = (1 - b1) g."""
    return {k: float(torch.linalg.vector_norm(m.double())) / (1 - b1) for k, m in mu.items()}


def change_norms(params: Dict[str, torch.Tensor], initial: Dict[str, torch.Tensor]
                 ) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(p.double() - initial[k].double()))
            for k, p in params.items()}
