"""Optimizers and LR schedules with optax's semantics, on torch tensors
(counterpart of ``mvldm_tpu/training/optim.py``).

The JAX package builds ``clip_by_global_norm -> AdamW | Adam | SGD`` with
optax, optionally wrapped in ``optax.MultiSteps`` for gradient accumulation.
:class:`Optimizer` does the same arithmetic on a dict of f32 master tensors,
updated in place with ``torch._foreach_*`` (multi-tensor kernels on the
card), a group of tensors at a time to bound the temporaries, or, for AdamW
and Adam with f32 moments on one card, by the fused kernels of
``ops/fused_adamw.py`` (:meth:`Optimizer.fused_step`):

* clip: g <- (g / |g|) * max_norm when |g| >= max_norm (global L2 norm);
* AdamW (``optax.adamw``): mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu
  in f32, u = mu_hat / (sqrt(nu_hat) + eps), u += wd * p (decoupled, before
  the LR), p -= lr(count) * u; with ``mu_dtype`` bf16 the first moment is
  stored in bf16 (optax computes ``b1 * mu`` in bf16, b1 included, before
  the f32 add, and so does this);
* AdamW with ``nu_dtype`` (the JAX ``adamw_lp`` / ``scale_by_adam_lp``):
  the moments are updated in f32 from their stored values, mu = b1 mu +
  (1 - b1) g and nu = b2 nu + ((1 - b2) g) g, and stored with unbiased
  stochastic rounding (:func:`stochastic_round`) in ``nu_dtype`` and, when
  set, ``mu_dtype``; b1 stays f32 here;
* Adam: the same without decay; SGD: optional momentum trace;
* Adafactor (``optax.adafactor`` of optax 0.2.6, the JAX package's chain):
  the factored second moment of ``scale_by_factored_rms`` (decay
  1 - (count + 1)^-decay_rate; a tensor whose two largest dims are both at
  least 128 keeps a row and a column vector over them, any other a
  full-shape one), ``clip_by_block_rms``, the learning rate,
  ``scale_by_param_block_rms(1e-3)``, optional ``ema(momentum,
  debias=False)``, ``add_decayed_weights`` (after the learning rate), then
  the sign; a tensor at a time (no kernel: the JAX package computes it with
  XLA ops too);
* accumulation every k micro-steps: the running mean of the gradients
  (``acc + (g - acc) / (n + 1)``) is clipped and applied on the k-th step;
  the LR and Adam counts advance only on applied steps.

:class:`SetToZero` is ``optax.set_to_zero()``, the whole chain of a frozen
denoiser. ``torch.optim.AdamW`` is not used: it has no bf16 moment storage
and applies weight decay differently.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import fused_adamw
from ..utils.profiling import span, sync


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
# The seed of the stochastic rounding's draws: step ``count`` and leaf ``i``
# draw from SeedSequence([ROUNDING_SEED, count, i]), as the JAX keys are
# fold_in(fold_in(PRNGKey(0x5EED), count), i).
ROUNDING_SEED = 0x5EED


def stochastic_round(x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Unbiased f32 -> bf16 rounding (the JAX ``stochastic_round``): add
    ``noise``, uniform integers in [0, 2^16), to the 16 mantissa bits that
    bf16 drops, then truncate them. On the int32 view of the bit pattern
    the wrap-around add is the uint32 add, and -65536 is the mask
    0xFFFF0000; a carry into the exponent is the round-up case."""
    rounded = (x.view(torch.int32) + noise) & -65536
    return rounded.view(torch.float32).to(torch.bfloat16)


def rounding_noise(shape, device, count: int, leaf: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (mu, nu) rounding draws of parameter ``leaf`` at update
    ``count``: int32 in [0, 2^16), from a generator seeded per (count,
    leaf), so a chunking of the update draws the same values."""
    seed = np.random.SeedSequence([ROUNDING_SEED, count, leaf]).generate_state(1)[0]
    gen = torch.Generator(device).manual_seed(int(seed))
    return tuple(torch.randint(0, 1 << 16, shape, generator=gen, dtype=torch.int32,
                               device=device) for _ in range(2))
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


def factored_dims(shape, min_dim_size_to_factor: int = 128) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims``: (d1, d0), the second largest and the
    largest dim (``np.argsort`` order on ties), when the second largest is
    at least ``min_dim_size_to_factor``; None otherwise."""
    if len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < min_dim_size_to_factor:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


class Optimizer:
    """clip -> AdamW | Adam | SGD | Adafactor -> every-k accumulation, in place.

    ``init(params)`` builds the state (a dict of ints and tensor dicts that
    ``torch.save`` stores); ``apply(params, grads, state)`` updates the f32
    ``params`` and ``state`` and returns whether an update was applied (False
    on the accumulation micro-steps). ``grads`` may be bf16: each group is
    cast to f32 as it is used. With ``nu_dtype`` the moments are stored by
    stochastic rounding; ``apply``'s ``noise`` (name -> (mu, nu) draws of
    :func:`rounding_noise`'s kind) then replaces the seeded draws.

    A multi-rank strategy (``training/strategy.py``) whose ranks hold
    slices of the state passes ``apply`` two callbacks: ``norm_fn(grads)``,
    the whole gradient's norm from this rank's slices (for the clip), and
    ``noise_fn(name, like, count, leaf)``, the slice's rounding draws. One
    card passes neither.

    The route (the ``route`` arg of the ``optim.*`` spans) is "fused" where
    :meth:`fused_step` gives the kernels of ``ops/fused_adamw.py`` the apply:
    two passes over the state (accumulate; the clip's norm by
    :func:`global_norm_tensor`, left on the card, then the update), with
    the result the foreach chain gives, bit for bit. Everything else takes
    the foreach chain, the kernels' plain path."""

    def __init__(self, name: str, lr_schedule: Callable[[int], float], *,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, mu_dtype: Optional[torch.dtype] = None,
                 nu_dtype: Optional[torch.dtype] = None, momentum: Optional[float] = 0.0,
                 clip: Optional[float] = None, every_k: int = 1,
                 decay_rate: float = 0.8, multiply_by_parameter_scale: bool = True,
                 clipping_threshold: Optional[float] = 1.0):
        if name not in ("AdamW", "Adam", "SGD", "Adafactor"):
            raise ValueError(f"Unknown optimizer: {name}")
        if nu_dtype is not None and name != "AdamW":
            raise ValueError(f"{name} takes no nu_dtype")
        self.name, self.lr_schedule = name, lr_schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.mu_dtype, self.momentum = weight_decay, mu_dtype, momentum
        self.nu_dtype = nu_dtype
        self.clip, self.every_k = clip, every_k
        self.decay_rate, self.clipping_threshold = decay_rate, clipping_threshold
        self.multiply_by_parameter_scale = multiply_by_parameter_scale
        self._plan: Optional[fused_adamw.Plan] = None

    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        def zeros(dtype=None):
            return {k: torch.zeros_like(p, dtype=dtype or p.dtype) for k, p in params.items()}

        state: Dict[str, Any] = {"count": 0, "mini_step": 0}
        if self.name in ("AdamW", "Adam"):
            state["mu"] = zeros(self.mu_dtype)
            state["nu"] = zeros(self.nu_dtype)
        elif self.name == "Adafactor":
            state.update(v_row={}, v_col={}, v={})
            for k, p in params.items():
                dims = factored_dims(p.shape)
                if dims is None:
                    state["v"][k] = torch.zeros_like(p)
                else:
                    d1, d0 = dims
                    state["v_row"][k] = torch.zeros_like(p.select(d0, 0))
                    state["v_col"][k] = torch.zeros_like(p.select(d1, 0))
            if self.momentum is not None:
                state["ema"] = zeros(torch.float32)
        elif self.momentum:
            state["trace"] = zeros()
        if self.every_k > 1:
            state["acc"] = zeros()
        return state

    def apply(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
              state: Dict[str, Any], noise: Optional[Dict[str, Tuple[torch.Tensor,
                                                                     torch.Tensor]]] = None,
              *, norm_fn: Optional[Callable] = None, noise_fn: Optional[Callable] = None
              ) -> bool:
        fused = self.fused_step(params, grads, state)
        route = {"route": "foreach" if fused is None else "fused"}
        if self.every_k > 1:
            n = state["mini_step"]
            with span("optim.accumulate", route):
                if fused is not None:
                    fused_adamw.accumulate(fused, n)
                else:
                    for names in _chunks(params):
                        acc = [state["acc"][k] for k in names]
                        g = [grads[k].float() for k in names]
                        # acc + (g - acc) / (n + 1): the running mean, as optax.MultiSteps.
                        torch._foreach_add_(acc, torch._foreach_div(
                            torch._foreach_sub(g, acc), n + 1))
            state["mini_step"] = (n + 1) % self.every_k
            if n != self.every_k - 1:
                return False
            grads = state["acc"]
        norm = None
        if self.clip is not None:
            with span("optim.clip", route):
                if norm_fn is not None:
                    norm = norm_fn(grads)
                elif fused is not None:
                    norm = global_norm_tensor(list(grads.values()))
                else:
                    norm = global_norm(list(grads.values()))
        with span("optim.update", route):
            if fused is None:
                clip_norm = None if norm is None or norm < self.clip else norm
                self._update(params, grads, state, _chunks(params), clip_norm, noise, noise_fn)
            else:
                fused_adamw.update(fused, self.hyper(state["count"], torch.float32), norm)
                state["count"] += 1
        return True

    def fused_step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                   state: Dict[str, Any]) -> Optional[fused_adamw.Step]:
        """The route rule: this apply's step for the kernels of
        ``ops/fused_adamw.py``, or None for the foreach chain. The kernels
        take AdamW or Adam with f32 moments (``mu_dtype`` None or float32,
        no ``nu_dtype``), masters, moments and accumulators contiguous f32
        on one CUDA device (:func:`fused_adamw.takes_state`, checked when a
        plan is built for a state), and gradients contiguous f32 or bf16
        there (:meth:`fused_adamw.Step.of`); SGD, Adafactor, a bf16 ``mu``,
        ``nu_dtype`` and the CPU take the chain. A state made of other
        tensors than the plan's gets a new plan."""
        if (self.name not in ("AdamW", "Adam") or self.mu_dtype not in (None, torch.float32)
                or self.nu_dtype is not None or not params
                or not next(iter(params.values())).is_cuda):
            return None
        lists = ([params[k] for k in params], [state["mu"][k] for k in params],
                 [state["nu"][k] for k in params],
                 [state["acc"][k] for k in params] if self.every_k > 1 else None)
        if self._plan is None or not self._plan.holds(*lists):
            self._plan = fused_adamw.Plan(*lists) if fused_adamw.takes_state(*lists) else None
        if self._plan is None:
            return None
        return fused_adamw.Step.of(self._plan, [grads[k] for k in params])

    def hyper(self, count: int, mu_dtype: torch.dtype) -> fused_adamw.Hyper:
        """The scalars of update ``count`` (updates applied before it) as the
        foreach chain computes with them. optax computes b1 * mu in mu's
        storage dtype, with b1 itself rounded to that dtype (a weakly typed
        scalar): 0.8984375 for a bf16 mu."""
        f32 = np.float32
        b1 = float(torch.tensor(self.b1).to(mu_dtype))
        return fused_adamw.Hyper(
            b1=float(f32(b1)), one_minus_b1=float(f32(1 - self.b1)), b2=float(f32(self.b2)),
            one_minus_b2=float(f32(1 - self.b2)),
            bc1=float(f32(1) - f32(self.b1) ** f32(count + 1)),
            bc2=float(f32(1) - f32(self.b2) ** f32(count + 1)), eps=float(f32(self.eps)),
            weight_decay=float(f32(self.weight_decay)) if self.name == "AdamW" else 0.0,
            neg_lr=-float(f32(self.lr_schedule(count))), clip=self.clip)

    def _update(self, params, grads, state, chunks: List[List[str]], clip_norm,
                noise, noise_fn: Optional[Callable]) -> None:
        """The update of an applying step, after accumulation and the clip."""
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
            elif self.name == "Adafactor":
                torch._foreach_sub_(p, self._adafactor(names, g, p, state, count, lr))
                continue
            elif self.nu_dtype is not None:
                upd = self._adam_lp(names, g, p, state, count + 1, noise, noise_fn)
            else:
                mu = [state["mu"][k] for k in names]
                upd = self._adam(g, p, mu, [state["nu"][k] for k in names],
                                 self.hyper(count, mu[0].dtype if mu else torch.float32))
            torch._foreach_add_(p, torch._foreach_mul(upd, -lr))
        if self.every_k > 1:
            for a in state["acc"].values():
                a.zero_()
        state["count"] = count + 1

    @staticmethod
    def _adam(g, p, mu, nu, h: fused_adamw.Hyper) -> List[torch.Tensor]:
        mu32 = torch._foreach_add(torch._foreach_mul(g, h.one_minus_b1),
                                  torch._foreach_mul(mu, h.b1))
        nu32 = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g), h.one_minus_b2),
                                  torch._foreach_mul(nu, h.b2))
        denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu32, h.bc2)), h.eps)
        upd = torch._foreach_div(torch._foreach_div(mu32, h.bc1), denom)
        if h.weight_decay:
            upd = torch._foreach_add(upd, torch._foreach_mul(p, h.weight_decay))
        torch._foreach_copy_(mu, mu32)
        torch._foreach_copy_(nu, nu32)
        return upd

    def _adam_lp(self, names: List[str], g, p, state, count: int, noise,
                 noise_fn: Optional[Callable]) -> List[torch.Tensor]:
        """``scale_by_adam_lp`` then the decay: f32 arithmetic on the stored
        moments, the moments stored by stochastic rounding. Leaf ``i`` is
        the parameter's rank in sorted name order (the JAX tree's order for
        a flat tree)."""
        b1, b2 = self.b1, self.b2
        mu = [state["mu"][k] for k in names]
        nu = [state["nu"][k] for k in names]
        mu32 = torch._foreach_add(torch._foreach_mul([m.float() for m in mu], b1),
                                  torch._foreach_mul(g, 1 - b1))
        nu32 = torch._foreach_add(torch._foreach_mul([n.float() for n in nu], b2),
                                  torch._foreach_mul(torch._foreach_mul(g, 1 - b2), g))
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu32, bc2)), self.eps)
        upd = torch._foreach_div(torch._foreach_div(mu32, bc1), denom)
        if self.weight_decay:
            upd = torch._foreach_add(upd, torch._foreach_mul(p, self.weight_decay))
        leaf = {k: i for i, k in enumerate(sorted(state["nu"]))}
        for k, m, n, m32, n32 in zip(names, mu, nu, mu32, nu32):
            if noise is not None:
                draws = noise[k]
            elif noise_fn is not None:
                draws = noise_fn(k, m32, count, leaf[k])
            else:
                draws = rounding_noise(m32.shape, m32.device, count, leaf[k])
            for stored, exact, bits in ((m, m32, draws[0]), (n, n32, draws[1])):
                stored.copy_(stochastic_round(exact, bits) if stored.dtype == torch.bfloat16
                             else exact)
        return upd


    def _adafactor(self, names: List[str], g, p, state, count: int, lr: float
                   ) -> List[torch.Tensor]:
        """optax's adafactor chain on one group, up to its final sign: the
        returned update is subtracted from the parameters. ``count`` is the
        number of updates applied before this one."""
        f32 = np.float32
        decay = f32(1) - f32(count + 1) ** f32(-self.decay_rate)
        keep, take = float(decay), float(f32(1) - decay)
        upd = []
        for k, gk, pk in zip(names, g, p):
            g2 = gk * gk + 1e-30
            dims = factored_dims(gk.shape)
            if dims is None:
                v = state["v"][k]
                v.copy_(v * keep + g2 * take)
                u = gk * v.rsqrt()
            else:
                d1, d0 = dims
                v_row, v_col = state["v_row"][k], state["v_col"][k]
                v_row.copy_(v_row * keep + g2.mean(dim=d0) * take)
                v_col.copy_(v_col * keep + g2.mean(dim=d1) * take)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_factor = (v_row / v_row.mean(dim=reduced_d1, keepdim=True)).rsqrt()
                u = gk * row_factor.unsqueeze(d0) * v_col.rsqrt().unsqueeze(d1)
            if self.clipping_threshold is not None:
                u = u / torch.clamp(u.square().mean().sqrt() / self.clipping_threshold, min=1.0)
            u = u * lr
            if self.multiply_by_parameter_scale:
                rms = pk.square().mean().sqrt()
                u = u * torch.where(rms <= 1e-3, 1e-3, rms)
            upd.append(u)
        if self.momentum is not None:
            ema = [state["ema"][k] for k in names]
            torch._foreach_copy_(ema, torch._foreach_add(torch._foreach_mul(upd, 1 - self.momentum),
                                                         torch._foreach_mul(ema, self.momentum)))
            upd = [e.clone() for e in ema]
        if self.weight_decay:
            upd = torch._foreach_add(upd, torch._foreach_mul(p, self.weight_decay))
        return upd


def global_norm_tensor(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over every element of ``tensors``, in f32, as a
    0-dim tensor on their device."""
    norms = torch._foreach_norm(tensors, 2, dtype=torch.float32)
    return torch.linalg.vector_norm(torch.stack(norms))


def global_norm(tensors: List[torch.Tensor]) -> float:
    """:func:`global_norm_tensor` read on the host."""
    norm = global_norm_tensor(tensors)
    with sync("grad_norm"):
        return float(norm)


def build_optimizer(optimizer_cfg: OptimizerCfg, lr_schedule: Callable[[int], float],
                    gradient_clip_val: Optional[float] = None,
                    accumulate_grad_batches: int = 1) -> Optimizer:
    """The JAX ``build_optimizer``'s chain for AdamW (with ``mu_dtype`` and,
    by stochastic rounding, ``nu_dtype``), Adam, SGD and Adafactor."""
    kwargs = optimizer_cfg.kwargs or {}
    name = optimizer_cfg.name
    b1, b2 = kwargs.get("betas", (0.9, 0.999))
    common = dict(clip=gradient_clip_val, every_k=accumulate_grad_batches)
    if name == "AdamW":
        return Optimizer("AdamW", lr_schedule, b1=b1, b2=b2, eps=kwargs.get("eps", 1e-8),
                         weight_decay=kwargs.get("weight_decay", 0.01),
                         mu_dtype=_MU_DTYPES[kwargs.get("mu_dtype")],
                         nu_dtype=_MU_DTYPES[kwargs.get("nu_dtype")], **common)
    if name == "Adam":
        return Optimizer("Adam", lr_schedule, b1=b1, b2=b2, eps=kwargs.get("eps", 1e-8),
                         **common)
    if name == "SGD":
        return Optimizer("SGD", lr_schedule, momentum=kwargs.get("momentum", 0.0), **common)
    if name == "Adafactor":
        return Optimizer("Adafactor", lr_schedule, momentum=kwargs.get("momentum"),
                         weight_decay=kwargs.get("weight_decay") or 0.0,
                         decay_rate=kwargs.get("decay_rate", 0.8),
                         multiply_by_parameter_scale=kwargs.get("multiply_by_parameter_scale",
                                                                True),
                         clipping_threshold=kwargs.get("clipping_threshold", 1.0), **common)
    raise ValueError(f"Unknown optimizer: {name}")


class SetToZero:
    """``optax.set_to_zero()``: the chain of a frozen denoiser
    (``freeze.denoiser``). No clip, accumulation or moments; every step
    applies a zero update, so the masters stay as they are."""

    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        return {}

    def apply(self, params, grads, state, noise=None, **callbacks) -> bool:
        return True


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
               decay: float = 0.995) -> None:
    """In place: ema <- decay * ema + (1 - decay) * params."""
    names = list(ema)
    e = [ema[k] for k in names]
    new = torch._foreach_add(torch._foreach_mul(e, decay),
                             torch._foreach_mul([params[k] for k in names], 1.0 - decay))
    torch._foreach_copy_(e, new)
