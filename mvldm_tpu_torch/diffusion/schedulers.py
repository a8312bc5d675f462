"""DDIM scheduler with diffusers semantics (counterpart of the DDIM half of
``mvldm_tpu/diffusion/schedulers.py``; DDPM comes with a later slice).

The live config: 1000 train timesteps, linear betas 1e-4 -> 0.02, epsilon
prediction, ``set_alpha_to_one=True``, ``steps_offset=0``, "leading"
timestep spacing. Tables are f32, as in the JAX package; the sampling loop
passes host-side integer timesteps.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch


@dataclass
class DDIMSchedulerKwargs:
    num_train_timesteps: int = 1000
    beta_start: float = 0.0001
    beta_end: float = 0.02
    beta_schedule: str = "linear"
    trained_betas: Optional[Sequence[float]] = None
    clip_sample: bool = True
    clip_sample_range: float = 1.0
    set_alpha_to_one: bool = True
    steps_offset: int = 0
    prediction_type: str = "epsilon"
    timestep_spacing: str = "leading"


def make_betas(schedule: str, num_train_timesteps: int, beta_start: float,
               beta_end: float,
               trained_betas: Optional[Sequence[float]] = None) -> np.ndarray:
    if trained_betas is not None:
        return np.asarray(trained_betas, dtype=np.float64)
    if schedule == "linear":
        return np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
    if schedule == "scaled_linear":
        return np.linspace(beta_start ** 0.5, beta_end ** 0.5, num_train_timesteps,
                           dtype=np.float64) ** 2
    if schedule == "squaredcos_cap_v2":
        def alpha_bar(t):
            return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

        return np.asarray(
            [min(1 - alpha_bar((i + 1) / num_train_timesteps)
                 / alpha_bar(i / num_train_timesteps), 0.999)
             for i in range(num_train_timesteps)], dtype=np.float64)
    raise NotImplementedError(f"Unknown beta schedule: {schedule}")


def leading_timesteps(num_train_timesteps: int, num_inference_steps: int,
                      steps_offset: int = 0) -> np.ndarray:
    """Descending multiples of ``num_train // num_inference``."""
    if num_inference_steps > num_train_timesteps:
        raise ValueError(
            f"num_inference_steps ({num_inference_steps}) > num_train_timesteps"
            f" ({num_train_timesteps})")
    ratio = num_train_timesteps // num_inference_steps
    steps = (np.arange(0, num_inference_steps) * ratio).round()[::-1].astype(np.int64)
    return steps + steps_offset


@dataclass(frozen=True)
class DDIMScheduler:
    alphas_cumprod: torch.Tensor  # (num_train_timesteps,) f32, on the host
    final_alpha_cumprod: float
    num_train_timesteps: int
    prediction_type: str
    clip_sample: bool
    clip_sample_range: float
    steps_offset: int
    num_inference_steps: int
    init_noise_sigma: float = 1.0

    @classmethod
    def create(cls, kwargs: Optional[DDIMSchedulerKwargs] = None,
               num_inference_steps: int = 50) -> "DDIMScheduler":
        kw = kwargs or DDIMSchedulerKwargs()
        betas = make_betas(kw.beta_schedule, kw.num_train_timesteps,
                           kw.beta_start, kw.beta_end, kw.trained_betas)
        alphas_cumprod = np.cumprod(1.0 - betas)
        final = 1.0 if kw.set_alpha_to_one else float(np.float32(alphas_cumprod[0]))
        return cls(
            alphas_cumprod=torch.tensor(alphas_cumprod, dtype=torch.float32),
            final_alpha_cumprod=final,
            num_train_timesteps=kw.num_train_timesteps,
            prediction_type=kw.prediction_type,
            clip_sample=kw.clip_sample,
            clip_sample_range=kw.clip_sample_range,
            steps_offset=kw.steps_offset,
            num_inference_steps=num_inference_steps,
        )

    def timesteps(self) -> np.ndarray:
        return leading_timesteps(self.num_train_timesteps, self.num_inference_steps,
                                 self.steps_offset)

    def scale_model_input(self, sample: torch.Tensor, timestep: int) -> torch.Tensor:
        return sample  # DDIM does not scale inputs.

    def _alpha(self, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        a = self.alphas_cumprod.to(like.device)[t.to(like.device)]
        return a.reshape(a.shape + (1,) * (like.dim() - a.dim()))

    def add_noise(self, original: torch.Tensor, noise: torch.Tensor,
                  timesteps: torch.Tensor) -> torch.Tensor:
        a = self._alpha(timesteps, original)
        return torch.sqrt(a) * original + torch.sqrt(1.0 - a) * noise

    def step(self, model_output: torch.Tensor, timestep: int,
             sample: torch.Tensor) -> torch.Tensor:
        """One deterministic (eta = 0) reverse DDIM step; returns prev_sample."""
        t = int(timestep)
        prev_t = t - self.num_train_timesteps // self.num_inference_steps
        table = self.alphas_cumprod
        a_t = table[t]
        a_prev = table[prev_t] if prev_t >= 0 else torch.tensor(
            self.final_alpha_cumprod, dtype=torch.float32)
        sqrt_a, sqrt_b = float(torch.sqrt(a_t)), float(torch.sqrt(1.0 - a_t))
        if self.prediction_type == "epsilon":
            pred_x0 = (sample - sqrt_b * model_output) / sqrt_a
            pred_eps = model_output
        elif self.prediction_type == "sample":
            pred_x0 = model_output
            pred_eps = (sample - sqrt_a * pred_x0) / sqrt_b
        elif self.prediction_type == "v_prediction":
            pred_x0 = sqrt_a * sample - sqrt_b * model_output
            pred_eps = sqrt_a * model_output + sqrt_b * sample
        else:
            raise NotImplementedError(f"Unknown prediction type: {self.prediction_type}")
        if self.clip_sample:
            pred_x0 = pred_x0.clamp(-self.clip_sample_range, self.clip_sample_range)
        direction = float(torch.sqrt(1.0 - a_prev)) * pred_eps
        return float(torch.sqrt(a_prev)) * pred_x0 + direction
