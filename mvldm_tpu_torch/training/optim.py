"""Optimizers and LR schedules with optax's semantics, on torch tensors
(counterpart of ``mvldm_tpu/training/optim.py``).

The JAX package builds ``clip_by_global_norm -> AdamW | Adam | SGD`` with
optax, optionally wrapped in ``optax.MultiSteps`` for gradient accumulation.
:class:`Optimizer` does the same arithmetic on a dict of f32 master tensors,
updated in place with ``torch._foreach_*`` (multi-tensor kernels on the
card), a group of tensors at a time to bound the temporaries:

* clip: g <- (g / |g|) * max_norm when |g| >= max_norm (global L2 norm);
* AdamW (``optax.adamw``): mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu
  in f32, u = mu_hat / (sqrt(nu_hat) + eps), u += wd * p (decoupled, before
  the LR), p -= lr(count) * u; with ``mu_dtype`` bf16 the first moment is
  stored in bf16 (optax computes ``b1 * mu`` in bf16, b1 included, before
  the f32 add, and so does this);
* Adam: the same without decay; SGD: optional momentum trace;
* accumulation every k micro-steps: the running mean of the gradients
  (``acc + (g - acc) / (n + 1)``) is clipped and applied on the k-th step;
  the LR and Adam counts advance only on applied steps.

``torch.optim.AdamW`` is not used: it has no bf16 first-moment storage and
applies weight decay differently. Adafactor and the stochastic-rounding
low-precision second moment (``scale_by_adam_lp``, ``nu_dtype``) are not
ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch


@dataclass
class OptimizerCfg:
    """The JAX ``config.OptimizerCfg`` fields the builder reads."""

    name: str = "AdamW"
    lr: float = 1e-4
    kwargs: Dict[str, Any] = field(default_factory=dict)


@dataclass
class LRSchedulerCfg:
    name: str = "LinearLR"
    kwargs: Dict[str, Any] = field(default_factory=dict)


def build_lr_schedule(base_lr: float, scheduler_cfg: Optional[LRSchedulerCfg]
                      ) -> Callable[[int], float]:
    """Step -> learning rate, in f32 as optax computes it.

    LinearLR(start_factor, end_factor=1, total_iters): the factor moves
    linearly from start to end over total_iters steps; ConstantLR(factor,
    total_iters): factor before total_iters, then 1; CosineAnnealingLR(T_max,
    eta_min): optax's cosine decay to eta_min, held there after T_max."""
    f32 = np.float32
    if scheduler_cfg is None:
        return lambda step: float(f32(base_lr))
    kwargs = scheduler_cfg.kwargs or {}
    name = scheduler_cfg.name
    if name == "LinearLR":
        start = f32(kwargs.get("start_factor", 1.0 / 3.0))
        end = f32(kwargs.get("end_factor", 1.0))
        total = int(kwargs.get("total_iters", 5))

        def linear(step: int) -> float:
            frac = np.clip(f32(step) / f32(total), f32(0), f32(1))
            return float(f32(base_lr) * (start + (end - start) * frac))

        return linear
    if name == "ConstantLR":
        factor = float(kwargs.get("factor", 1.0 / 3.0))
        total = int(kwargs.get("total_iters", 5))
        return lambda step: float(f32(base_lr) * f32(factor if step < total else 1.0))
    if name == "CosineAnnealingLR":
        t_max = int(kwargs["T_max"])
        alpha = f32(float(kwargs.get("eta_min", 0.0)) / base_lr)

        def cosine(step: int) -> float:
            frac = f32(min(step, t_max)) / f32(t_max)
            decay = f32(0.5) * (f32(1) + f32(math.cos(math.pi * frac)))
            return float(f32(base_lr) * ((f32(1) - alpha) * decay + alpha))

        return cosine
    raise ValueError(f"Unknown LR scheduler: {name}")


_MU_DTYPES = {None: None, "float32": torch.float32, "bfloat16": torch.bfloat16}
# Elements per group of tensors that one round of foreach ops updates: the
# update's f32 temporaries stay near 15 x 128 MB instead of 15 copies of
# every parameter (0.93B parameters: 3.7 GB each).
CHUNK_ELEMENTS = 1 << 25


def _chunks(params: Dict[str, torch.Tensor]) -> List[List[str]]:
    """Parameter names in groups of at most CHUNK_ELEMENTS elements (a
    larger tensor is a group of its own)."""
    chunks: List[List[str]] = [[]]
    size = 0
    for name, p in params.items():
        if chunks[-1] and size + p.numel() > CHUNK_ELEMENTS:
            chunks.append([])
            size = 0
        chunks[-1].append(name)
        size += p.numel()
    return chunks


class Optimizer:
    """clip -> AdamW | Adam | SGD -> every-k accumulation, in place.

    ``init(params)`` builds the state (a dict of ints and tensor dicts that
    ``torch.save`` stores); ``apply(params, grads, state)`` updates the f32
    ``params`` and ``state`` and returns whether an update was applied (False
    on the accumulation micro-steps). ``grads`` may be bf16: each group is
    cast to f32 as it is used."""

    def __init__(self, name: str, lr_schedule: Callable[[int], float], *,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, mu_dtype: Optional[torch.dtype] = None,
                 momentum: float = 0.0, clip: Optional[float] = None,
                 every_k: int = 1):
        if name not in ("AdamW", "Adam", "SGD"):
            raise ValueError(f"Unknown optimizer: {name}")
        self.name, self.lr_schedule = name, lr_schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.mu_dtype, self.momentum = weight_decay, mu_dtype, momentum
        self.clip, self.every_k = clip, every_k

    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        def zeros(dtype=None):
            return {k: torch.zeros_like(p, dtype=dtype or p.dtype) for k, p in params.items()}

        state: Dict[str, Any] = {"count": 0, "mini_step": 0}
        if self.name in ("AdamW", "Adam"):
            state["mu"] = zeros(self.mu_dtype)
            state["nu"] = zeros()
        elif self.momentum:
            state["trace"] = zeros()
        if self.every_k > 1:
            state["acc"] = zeros()
        return state

    def apply(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
              state: Dict[str, Any]) -> bool:
        chunks = _chunks(params)
        if self.every_k > 1:
            n = state["mini_step"]
            for names in chunks:
                acc = [state["acc"][k] for k in names]
                g = [grads[k].float() for k in names]
                # acc + (g - acc) / (n + 1): the running mean, as optax.MultiSteps.
                torch._foreach_add_(acc, torch._foreach_div(torch._foreach_sub(g, acc), n + 1))
            state["mini_step"] = (n + 1) % self.every_k
            if n != self.every_k - 1:
                return False
            grads = state["acc"]
        clip_norm = None
        if self.clip is not None:
            norm = global_norm(list(grads.values()))
            if not norm < self.clip:
                clip_norm = norm
        count = state["count"]
        lr = float(np.float32(self.lr_schedule(count)))
        for names in chunks:
            g = [grads[k].float() for k in names]
            if clip_norm is not None:
                g = torch._foreach_mul(torch._foreach_div(g, clip_norm), self.clip)
            p = [params[k] for k in names]
            if self.name == "SGD":
                upd = g
                if self.momentum:
                    trace = [state["trace"][k] for k in names]
                    upd = torch._foreach_add(g, torch._foreach_mul(trace, self.momentum))
                    torch._foreach_copy_(trace, upd)
            else:
                upd = self._adam(g, p, [state["mu"][k] for k in names],
                                 [state["nu"][k] for k in names], count + 1)
            torch._foreach_add_(p, torch._foreach_mul(upd, -lr))
        if self.every_k > 1:
            for a in state["acc"].values():
                a.zero_()
        state["count"] = count + 1
        return True

    def _adam(self, g, p, mu, nu, count: int) -> List[torch.Tensor]:
        b1, b2 = self.b1, self.b2
        # optax computes b1 * mu in mu's storage dtype, with b1 itself rounded
        # to that dtype (a weakly typed scalar): 0.8984375 for a bf16 mu.
        b1_mu = float(torch.tensor(b1).to(mu[0].dtype)) if mu else b1
        mu32 = torch._foreach_add(torch._foreach_mul(g, 1 - b1), torch._foreach_mul(mu, b1_mu))
        nu32 = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2),
                                  torch._foreach_mul(nu, b2))
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu32, bc2)), self.eps)
        upd = torch._foreach_div(torch._foreach_div(mu32, bc1), denom)
        if self.name == "AdamW" and self.weight_decay:
            upd = torch._foreach_add(upd, torch._foreach_mul(p, self.weight_decay))
        torch._foreach_copy_(mu, mu32)
        torch._foreach_copy_(nu, nu32)
        return upd


def global_norm(tensors: List[torch.Tensor]) -> float:
    """sqrt(sum of squares) over every element of ``tensors``, in f32."""
    norms = torch._foreach_norm(tensors, 2, dtype=torch.float32)
    return float(torch.linalg.vector_norm(torch.stack(norms)))


def build_optimizer(optimizer_cfg: OptimizerCfg, lr_schedule: Callable[[int], float],
                    gradient_clip_val: Optional[float] = None,
                    accumulate_grad_batches: int = 1) -> Optimizer:
    """The JAX ``build_optimizer``'s chain for AdamW (with ``mu_dtype``),
    Adam and SGD."""
    kwargs = optimizer_cfg.kwargs or {}
    name = optimizer_cfg.name
    if kwargs.get("nu_dtype"):
        raise NotImplementedError("nu_dtype (stochastic-rounding second moment) is not ported")
    b1, b2 = kwargs.get("betas", (0.9, 0.999))
    common = dict(clip=gradient_clip_val, every_k=accumulate_grad_batches)
    if name == "AdamW":
        return Optimizer("AdamW", lr_schedule, b1=b1, b2=b2, eps=kwargs.get("eps", 1e-8),
                         weight_decay=kwargs.get("weight_decay", 0.01),
                         mu_dtype=_MU_DTYPES[kwargs.get("mu_dtype")], **common)
    if name == "Adam":
        return Optimizer("Adam", lr_schedule, b1=b1, b2=b2, eps=kwargs.get("eps", 1e-8),
                         **common)
    if name == "SGD":
        return Optimizer("SGD", lr_schedule, momentum=kwargs.get("momentum", 0.0), **common)
    raise ValueError(f"Unknown optimizer: {name}")


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
               decay: float = 0.995) -> None:
    """In place: ema <- decay * ema + (1 - decay) * params."""
    names = list(ema)
    e = [ema[k] for k in names]
    new = torch._foreach_add(torch._foreach_mul(e, decay),
                             torch._foreach_mul([params[k] for k in names], 1.0 - decay))
    torch._foreach_copy_(e, new)
