"""DDIM and DDPM schedulers with diffusers semantics (counterpart of
``mvldm_tpu/diffusion/schedulers.py``) and the ``get_scheduler`` registry.

The live config: 1000 train timesteps, linear betas 1e-4 -> 0.02, epsilon
prediction, ``set_alpha_to_one=True``, ``steps_offset=0``, "leading"
timestep spacing. Tables are f32, as in the JAX package; the sampling loop
passes host-side integer timesteps. DDPM's ancestral noise is an input of
its ``step``: the engine draws it from the run's generator or takes it
injected.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Literal, Optional, Sequence, Union

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


@dataclass
class DDPMSchedulerKwargs:
    num_train_timesteps: int = 1000
    beta_start: float = 0.0001
    beta_end: float = 0.02
    beta_schedule: str = "linear"
    trained_betas: Optional[Sequence[float]] = None
    variance_type: str = "fixed_small"
    clip_sample: bool = True
    prediction_type: str = "epsilon"
    thresholding: bool = False
    dynamic_thresholding_ratio: float = 0.995
    clip_sample_range: float = 1.0
    sample_max_value: float = 1.0
    timestep_spacing: str = "leading"
    steps_offset: int = 0
    rescale_betas_zero_snr: bool = False


@dataclass
class SchedulerCfg:
    name: Literal["ddim", "ddpm"]
    num_train_timesteps: int
    num_inference_steps: int
    pretrained_from: Optional[str] = None
    kwargs: Any = None


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


def predict_x0_and_eps(sample: torch.Tensor, model_output: torch.Tensor,
                       alpha_prod_t: torch.Tensor, prediction_type: str):
    sqrt_a, sqrt_b = float(torch.sqrt(alpha_prod_t)), float(torch.sqrt(1.0 - alpha_prod_t))
    if prediction_type == "epsilon":
        return (sample - sqrt_b * model_output) / sqrt_a, model_output
    if prediction_type == "sample":
        return model_output, (sample - sqrt_a * model_output) / sqrt_b
    if prediction_type == "v_prediction":
        return (sqrt_a * sample - sqrt_b * model_output,
                sqrt_a * model_output + sqrt_b * sample)
    raise NotImplementedError(f"Unknown prediction type: {prediction_type}")


class _Schedule:
    """What both schedulers share: the leading timesteps, forward noising
    and the velocity target over ``alphas_cumprod``."""

    def with_num_inference_steps(self, num: int):
        return replace(self, num_inference_steps=num)

    def timesteps(self, num_inference_steps: Optional[int] = None) -> np.ndarray:
        return leading_timesteps(self.num_train_timesteps,
                                 num_inference_steps or self.num_inference_steps,
                                 self.steps_offset)

    def scale_model_input(self, sample: torch.Tensor, timestep: int) -> torch.Tensor:
        return sample  # neither scheduler scales inputs

    def _alpha(self, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        a = self.alphas_cumprod.to(like.device)[t.to(like.device)]
        return a.reshape(a.shape + (1,) * (like.dim() - a.dim()))

    def add_noise(self, original: torch.Tensor, noise: torch.Tensor,
                  timesteps: torch.Tensor) -> torch.Tensor:
        a = self._alpha(timesteps, original)
        return torch.sqrt(a) * original + torch.sqrt(1.0 - a) * noise

    def get_velocity(self, sample: torch.Tensor, noise: torch.Tensor,
                     timesteps: torch.Tensor) -> torch.Tensor:
        a = self._alpha(timesteps, sample)
        return torch.sqrt(a) * noise - torch.sqrt(1.0 - a) * sample


@dataclass(frozen=True)
class DDIMScheduler(_Schedule):
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


    def step(self, model_output: torch.Tensor, timestep: int,
             sample: torch.Tensor, eta: float = 0.0,
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One reverse DDIM step; returns prev_sample. With ``eta > 0`` the
        step is stochastic (the JAX ``step``, ``schedulers.py:256-272``):
        std = eta * sqrt((1 - a_prev) / (1 - a_t) * (1 - a_t / a_prev)) in
        f32, the direction shrinks to sqrt(1 - a_prev - std^2), and std *
        ``noise`` is added; ``noise`` (N(0, 1), the sample's shape) is then
        required."""
        t = int(timestep)
        prev_t = t - self.num_train_timesteps // self.num_inference_steps
        table = self.alphas_cumprod
        a_t = table[t]
        a_prev = table[prev_t] if prev_t >= 0 else torch.tensor(
            self.final_alpha_cumprod, dtype=torch.float32)
        pred_x0, pred_eps = predict_x0_and_eps(sample, model_output, a_t,
                                               self.prediction_type)
        if self.clip_sample:
            pred_x0 = pred_x0.clamp(-self.clip_sample_range, self.clip_sample_range)
        if eta > 0.0:
            if noise is None:
                raise ValueError("eta > 0 requires noise")
            variance = (1.0 - a_prev) / (1.0 - a_t) * (1.0 - a_t / a_prev)
            std = eta * torch.sqrt(variance)
            direction = float(torch.sqrt(1.0 - a_prev - std ** 2)) * pred_eps
            return (float(torch.sqrt(a_prev)) * pred_x0 + direction
                    + float(std) * noise.to(pred_x0.dtype))
        direction = float(torch.sqrt(1.0 - a_prev)) * pred_eps
        return float(torch.sqrt(a_prev)) * pred_x0 + direction


@dataclass(frozen=True)
class DDPMScheduler(_Schedule):
    """Ancestral DDPM. ``step`` takes the step's N(0, 1) noise; without it
    the step returns the posterior mean."""

    alphas_cumprod: torch.Tensor  # (num_train_timesteps,) f32, on the host
    betas: torch.Tensor
    alphas: torch.Tensor
    num_train_timesteps: int
    prediction_type: str
    clip_sample: bool
    clip_sample_range: float
    variance_type: str
    steps_offset: int
    num_inference_steps: int
    init_noise_sigma: float = 1.0

    @classmethod
    def create(cls, kwargs: Optional[DDPMSchedulerKwargs] = None,
               num_inference_steps: int = 1000) -> "DDPMScheduler":
        kw = kwargs or DDPMSchedulerKwargs()
        betas = make_betas(kw.beta_schedule, kw.num_train_timesteps,
                           kw.beta_start, kw.beta_end, kw.trained_betas)
        alphas = 1.0 - betas
        return cls(
            alphas_cumprod=torch.tensor(np.cumprod(alphas), dtype=torch.float32),
            betas=torch.tensor(betas, dtype=torch.float32),
            alphas=torch.tensor(alphas, dtype=torch.float32),
            num_train_timesteps=kw.num_train_timesteps,
            prediction_type=kw.prediction_type,
            clip_sample=kw.clip_sample,
            clip_sample_range=kw.clip_sample_range,
            variance_type=kw.variance_type,
            steps_offset=kw.steps_offset,
            num_inference_steps=num_inference_steps,
        )

    def step(self, model_output: torch.Tensor, timestep: int, sample: torch.Tensor,
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One reverse step; returns prev_sample. The coefficients are f32
        scalars on the host, as the JAX step computes them; the arithmetic
        on the tensors runs in their dtype."""
        t = int(timestep)
        prev_t = t - self.num_train_timesteps // self.num_inference_steps
        a_t = self.alphas_cumprod[t]
        a_prev = self.alphas_cumprod[prev_t] if prev_t >= 0 else torch.tensor(1.0)
        beta_prod_t = 1.0 - a_t
        beta_prod_prev = 1.0 - a_prev
        current_alpha = a_t / a_prev
        current_beta = 1.0 - current_alpha

        pred_x0, _ = predict_x0_and_eps(sample, model_output, a_t, self.prediction_type)
        if self.clip_sample:
            pred_x0 = pred_x0.clamp(-self.clip_sample_range, self.clip_sample_range)
        x0_coeff = torch.sqrt(a_prev) * current_beta / beta_prod_t
        sample_coeff = torch.sqrt(current_alpha) * beta_prod_prev / beta_prod_t
        prev_mean = x0_coeff * pred_x0 + sample_coeff * sample

        variance = beta_prod_prev / beta_prod_t * current_beta
        if self.variance_type == "fixed_small":
            variance = variance.clamp(min=1e-20)
        elif self.variance_type == "fixed_small_log":
            variance = torch.exp(0.5 * torch.log(variance.clamp(min=1e-20)))
        elif self.variance_type == "fixed_large":
            variance = current_beta
        else:
            raise NotImplementedError(f"variance_type {self.variance_type}")
        if noise is None:
            return prev_mean
        std = torch.sqrt(variance) if t > 0 else torch.tensor(0.0)
        return prev_mean + std * noise.to(sample.dtype)


Scheduler = Union[DDIMScheduler, DDPMScheduler]


def get_scheduler(cfg: SchedulerCfg) -> Scheduler:
    """The registry of ``mvldm_tpu/diffusion/schedulers.py``;
    ``pretrained_from`` is ignored there too (the kwargs reproduce the SD2.1
    scheduler config)."""
    registry = {"ddim": (DDIMScheduler, DDIMSchedulerKwargs),
                "ddpm": (DDPMScheduler, DDPMSchedulerKwargs)}
    if cfg.name not in registry:
        raise ValueError(f"Unknown scheduler: {cfg.name}")
    sched_cls, kw_cls = registry[cfg.name]
    kw = cfg.kwargs
    if not isinstance(kw, kw_cls):
        kw = kw_cls(**kw) if kw else kw_cls()
    return sched_cls.create(kw, num_inference_steps=cfg.num_inference_steps)
