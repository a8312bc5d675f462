"""The plain reference of anchored video sampling: rays from the cameras,
the DDIM schedule, one launch (encode the context, 25 steps with
classifier-free guidance, decode), and the anchored launch plan.

Guidance runs in its published, sequential form: one forward over context
and targets, one over the targets alone. The program may batch the two;
it is the same function. Imports nothing of the program.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from .model import Model, posterior_sample

VAE_SCALE = 0.18215


# ---------------------------------------------------------------- cameras

def relative_to(extrinsics: torch.Tensor, index: int) -> torch.Tensor:
    """(..., v, 4, 4) camera-to-world poses relative to view ``index``."""
    return torch.linalg.inv(extrinsics[..., [index], :, :]) @ extrinsics


def rays(extrinsics: torch.Tensor, intrinsics: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """(b, v, 4, 4), (b, v, 3, 3) -> (b, v, h, w, 6): world ray origin and
    unit direction through each pixel centre of an h x w grid."""
    h, w = hw
    dev = extrinsics.device
    ys = (torch.arange(h, device=dev, dtype=torch.float32) + 0.5) / h
    xs = (torch.arange(w, device=dev, dtype=torch.float32) + 0.5) / w
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    pix = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1).reshape(1, 1, h * w, 3)
    cam = pix @ torch.linalg.inv(intrinsics).transpose(-1, -2)
    cam = cam / torch.linalg.norm(cam, dim=-1, keepdim=True)
    world = cam @ extrinsics[..., :3, :3].transpose(-1, -2)
    origins = extrinsics[..., None, :3, 3].expand(world.shape)
    b, v = extrinsics.shape[:2]
    return torch.cat([origins, world], dim=-1).reshape(b, v, h, w, 6)


# ---------------------------------------------------------------- DDIM

@dataclass
class DDIM:
    """DDIM with the configurations' settings: linear betas, epsilon
    prediction, no clipping, eta 0, "leading" timesteps, alpha_prev of
    the last step 1."""

    alphas_cumprod: np.ndarray  # float32 table
    num_train: int
    steps: int

    @classmethod
    def from_cfg(cls, sched: Dict) -> "DDIM":
        kw = sched["kwargs"]
        if (kw["beta_schedule"], kw["prediction_type"], kw["clip_sample"],
                kw["set_alpha_to_one"], kw.get("steps_offset", 0)) != (
                    "linear", "epsilon", False, True, 0):
            raise ValueError(f"the reference DDIM does not take {kw}")
        betas = np.linspace(kw["beta_start"], kw["beta_end"], kw["num_train_timesteps"],
                            dtype=np.float64)
        return cls(np.cumprod(1.0 - betas).astype(np.float32), kw["num_train_timesteps"],
                   sched["num_inference_steps"])

    def timesteps(self) -> List[int]:
        ratio = self.num_train // self.steps
        return [i * ratio for i in range(self.steps)][::-1]

    def step(self, eps: torch.Tensor, t: int, x: torch.Tensor) -> torch.Tensor:
        prev = t - self.num_train // self.steps
        a_t = float(self.alphas_cumprod[t])
        a_prev = float(self.alphas_cumprod[prev]) if prev >= 0 else 1.0
        x0 = (x - np.sqrt(1.0 - a_t) * eps) / np.sqrt(a_t)
        return np.sqrt(a_prev) * x0 + np.sqrt(1.0 - a_prev) * eps

    def add_noise(self, x: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        a = torch.as_tensor(self.alphas_cumprod, device=x.device)[t.to(x.device)]
        a = a.reshape(a.shape + (1,) * (x.dim() - 1))
        return torch.sqrt(a) * x + torch.sqrt(1.0 - a) * noise


# ------------------------------------------------------------- one launch

def encode(model: Model, images: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """(b, v, H, W, 3) in [0, 1] -> (b, v, H/8, W/8, 4) scaled latents,
    sampled from the posterior with ``eps``."""
    b, v, h, w, _ = images.shape
    m = model.autoencoder.moments(images.reshape(b * v, h, w, 3).float() * 2.0 - 1.0)
    z = posterior_sample(m, eps.reshape(m.shape[0], h // 8, w // 8, -1).float())
    return (z * VAE_SCALE).reshape(b, v, h // 8, w // 8, -1)


def decode_u8(model: Model, latents: torch.Tensor) -> torch.Tensor:
    """(b, v, h, w, 4) latents -> (b, v, 8h, 8w, 3) uint8, truncated as
    the program quantizes."""
    b, v, h, w, c = latents.shape
    img = model.autoencoder.decode(latents.reshape(b * v, h, w, c) / VAE_SCALE)
    img = torch.clamp(img / 2.0 + 0.5, 0.0, 1.0)
    return (img * 255.0).to(torch.uint8).reshape(b, v, 8 * h, 8 * w, 3)


def sample_launch(model: Model, ddim: DDIM, cfg_scale: float, ctx_u8: torch.Tensor,
                  extrinsics: torch.Tensor, intrinsics: torch.Tensor, rel_index: int,
                  encode_eps: torch.Tensor, initial_noise: torch.Tensor) -> torch.Tensor:
    """One launch: ``ctx_u8`` (b, v_c, H, W, 3) context, cameras (b, v_c +
    v_t) absolute, targets from ``initial_noise`` (b, v_t, h, w, 4) ->
    (b, v_t, H, W, 3) uint8."""
    dev = ctx_u8.device
    b, v_c = ctx_u8.shape[:2]
    v_t = initial_noise.shape[1]
    ctx = encode(model, ctx_u8.float() / 255.0, encode_eps)
    hl, wl = ctx.shape[2:4]
    ray = rays(relative_to(extrinsics.float(), rel_index), intrinsics.float(), (hl, wl))
    mask = torch.cat([torch.zeros(b, v_c, hl, wl, 1, device=dev),
                      torch.ones(b, v_t, hl, wl, 1, device=dev)], dim=1)
    unet = model.denoiser
    x = initial_noise.float().to(dev)
    for t in ddim.timesteps():
        inputs = torch.cat([torch.cat([ctx, x], dim=1), mask, ray], dim=-1)
        ts = torch.cat([torch.zeros(b, v_c, dtype=torch.int64, device=dev),
                        torch.full((b, v_t), t, dtype=torch.int64, device=dev)], dim=1)
        cond = unet(inputs, ts)[:, v_c:]
        uncond = unet(inputs[:, v_c:], ts[:, v_c:])
        x = ddim.step(uncond + cfg_scale * (cond - uncond), t, x)
    return decode_u8(model, x)


# ---------------------------------------------------------- launch plans

@dataclass
class Launch:
    """One launch of a plan: ``rows`` (one per group; an anchor window is
    one row) of target positions, padded to the launch's width by
    repeating the last; ``context`` names each row's context frames: -1
    the scene's context frame, p >= 0 the generated frame at target
    position p; poses relative to context slot ``rel_index``. ``real``
    says how many of each row's columns are real and ``pad_rows`` how many
    rows repeat the last to fill a power-of-two chunk."""

    kind: str
    rows: List[List[int]]
    context: List[List[int]]
    real: List[int]
    rel_index: int


def _pad(pos: List[int], width: int) -> List[int]:
    return list(pos) + [pos[-1]] * (width - len(pos))


def anchored_plan(n_t: int, num_anchors: int = 4, group_size: int = 3,
                  max_parallel_groups: int = 16, scenes: int = 1) -> List[Launch]:
    """The anchored schedule: up to four strided anchors from the context
    alone; further anchors in windows of ``group_size`` from [context,
    the last anchor]; every other frame to its nearest anchor (the
    earlier on a tie), grouped in frame order by ``group_size`` and
    sampled from [context, its anchor], the groups in power-of-two chunks
    of at most ``max_parallel_groups // scenes``."""
    n_anchors = min(num_anchors, n_t)
    stride = max(n_t // n_anchors, 1)
    anchors = [stride * (i + 1) for i in range(n_anchors) if stride * (i + 1) < n_t] or [n_t - 1]
    first = anchors[:4]
    plan = [Launch("anchor", [_pad(first, min(num_anchors, 4))], [[-1]], [len(first)], 0)]
    start = len(first)
    while start < len(anchors):
        window = anchors[start:start + group_size]
        plan.append(Launch("anchor", [_pad(window, group_size)],
                           [[-1, anchors[start - 1]]], [len(window)], 1))
        start += len(window)

    nearest = {p: min(anchors, key=lambda a: (abs(a - p), a)) for p in range(n_t)
               if p not in anchors}
    groups: Dict[int, List[List[int]]] = {a: [] for a in anchors}
    current, current_anchor = [], None
    for p in sorted(nearest):
        if current and (nearest[p] != current_anchor or len(current) == group_size):
            groups[current_anchor].append(current)
            current = []
        current_anchor = nearest[p]
        current.append(p)
    if current:
        groups[current_anchor].append(current)
    jobs = [(a, g) for a in anchors for g in groups[a]]

    cap = max(1, max_parallel_groups // scenes)
    cap = 1 << (cap.bit_length() - 1)
    i = 0
    while i < len(jobs):
        size = cap
        while size > len(jobs) - i and size > 1:
            size //= 2
        chunk = jobs[i:i + size]
        i += len(chunk)
        plan.append(Launch("fill", [_pad(g, group_size) for _, g in chunk],
                           [[-1, a] for a, _ in chunk], [len(g) for _, g in chunk], 1))
    return plan


def first_window_plan(n_t: int, num_anchors: int = 4) -> List[Launch]:
    """A request of at most ``num_anchors`` targets: one launch from the
    context alone, padded to ``num_anchors`` columns."""
    if n_t > num_anchors:
        raise ValueError(f"{n_t} targets do not fit one window of {num_anchors}")
    return [Launch("anchor", [_pad(list(range(n_t)), num_anchors)], [[-1]], [n_t], 0)]
