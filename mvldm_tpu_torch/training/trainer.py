"""Train step and host loop (counterpart of
``mvldm_tpu/training/trainer.py``), on one device; the mesh strategies and
the validation hook are not ported yet.

Mixed precision, as the JAX package trains (f32 parameters, bf16
compute): the UNet module runs in its own dtype, bf16 on the card, the same
forward that sampling runs, so the kernels see what they are built for.
``TrainState.params`` holds an f32 master copy of every UNet parameter;
each step hands the module's gradients to the optimizer, which casts them
to f32 a group at a time, updates the masters, and copies the masters back
into the module. The VAE is frozen.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, Optional

import torch
import torch.nn as nn

from ..diffusion.engine import Batch, DiffusionEngine, TrainDraws
from .checkpoint import CheckpointManager
from .optim import Optimizer, ema_update, global_norm


@dataclass
class TrainState:
    params: Dict[str, torch.Tensor]              # f32 masters, by UNet parameter name
    opt_state: Dict[str, Any]
    ema_params: Optional[Dict[str, torch.Tensor]]  # None when EMA is off
    step: int

    def state_dict(self) -> Dict[str, Any]:
        return {"params": self.params, "opt_state": self.opt_state,
                "ema_params": self.ema_params, "step": self.step}


def master_params(module: nn.Module) -> Dict[str, torch.Tensor]:
    """f32 copies of the module's trainable parameters."""
    return {n: p.detach().float().clone() for n, p in module.named_parameters()
            if p.requires_grad}


@torch.no_grad()
def load_params(module: nn.Module, params: Dict[str, torch.Tensor]) -> None:
    """Copy (and cast) ``params`` into the module's parameters of those names."""
    named = dict(module.named_parameters())
    torch._foreach_copy_([named[n] for n in params], list(params.values()))


def _cat(a, b):
    return None if a is None else torch.cat([torch.as_tensor(a), torch.as_tensor(b)], dim=1)


def batch_from_arrays(context_img, target_img, context_extr, target_extr,
                      context_intr, target_intr, context_latents=None,
                      target_latents=None) -> Batch:
    """Concatenate context + target views into the engine's Batch. Pass the
    ``*_latents`` (VAE posterior moments) instead of, or beside, images for
    the latent-cache path."""
    extr = _cat(context_extr, target_extr).float()
    b, v_c = extr.shape[0], torch.as_tensor(context_extr).shape[1]
    is_target = torch.ones((b, extr.shape[1]), dtype=torch.bool)
    is_target[:, :v_c] = False
    images = _cat(context_img, target_img)
    latents = _cat(context_latents, target_latents)
    return Batch(images=None if images is None else images.float(), extrinsics=extr,
                 intrinsics=_cat(context_intr, target_intr).float(), is_target=is_target,
                 latent_moments=None if latents is None else latents.float())


def make_train_step(engine: DiffusionEngine, tx: Optimizer, num_context_views: int,
                    ema_decay: float = 0.995) -> Callable:
    """``step(state, batch, draws=None, generator=None) -> (state, metrics)``:
    loss and gradients of the engine's UNet, one optimizer apply on the
    masters, the EMA only on steps that applied an update. ``state`` is
    updated in place and returned."""
    named = [(n, p) for n, p in engine.unet.named_parameters() if p.requires_grad]

    def train_step(state: TrainState, batch: Batch, draws: Optional[TrainDraws] = None,
                   generator: Optional[torch.Generator] = None):
        for _, p in named:
            p.grad = None
        loss, metrics = engine.training_loss(batch, num_context_views, draws, generator)
        loss.backward()
        # A parameter the loss does not reach (the SD text attention's q/k/v
        # under the zero text context) has a zero gradient, as in JAX. The
        # module's (bf16) gradients go to the optimizer as they are.
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(state.params[n])
                 for n, p in named}
        grad_norm = global_norm(list(grads.values()))
        applied = tx.apply(state.params, grads, state.opt_state)
        del grads
        for _, p in named:
            p.grad = None
        if applied:
            load_params(engine.unet, state.params)
            if state.ema_params is not None:
                ema_update(state.ema_params, state.params, ema_decay)
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = grad_norm
        return state, metrics

    return train_step


class Trainer:
    """Host loop over an iterable of batches in the data loader's dict
    format: ``{"context": {...}, "target": {...}}``, each with ``image``
    (b, v, h, w, 3), ``extrinsics``, ``intrinsics`` and optionally
    ``latent_moments``. Appends one JSON line per ``log_every`` steps to
    ``<run_dir>/metrics.jsonl`` and checkpoints every ``checkpoint_every``
    steps and at the last step."""

    def __init__(self, engine: DiffusionEngine, tx: Optimizer, run_dir, *,
                 max_steps: int, num_context_views: int, checkpoint_every: int = 1000,
                 save_top_k: int = 1, log_every: int = 50, use_ema: bool = False,
                 step_tracker: Any = None, task_steps: Optional[int] = None):
        self.engine, self.tx = engine, tx
        self.run_dir = Path(run_dir)
        self.max_steps, self.num_context_views = max_steps, num_context_views
        self.checkpoint_every, self.log_every = checkpoint_every, log_every
        self.use_ema, self.step_tracker = use_ema, step_tracker
        self.task_steps = task_steps
        self.ckpt = CheckpointManager(self.run_dir / "checkpoints", save_top_k)
        self.metrics_log = self.run_dir / "metrics.jsonl"
        self._train_step = make_train_step(engine, tx, num_context_views)

    def init_state(self) -> TrainState:
        params = master_params(self.engine.unet)
        ema = {n: p.clone() for n, p in params.items()} if self.use_ema else None
        return TrainState(params=params, opt_state=self.tx.init(params), ema_params=ema,
                          step=0)

    def maybe_restore(self, state: TrainState) -> TrainState:
        """Resume from the newest checkpoint, if any, into the module too."""
        latest = self.ckpt.latest_step()
        if latest is None:
            return state
        print(f"Resuming from checkpoint at step {latest}")
        state = TrainState(**self.ckpt.restore(latest, map_location=self.engine.device))
        load_params(self.engine.unet, state.params)
        return state

    def _batch(self, raw: Dict[str, Dict[str, Any]]) -> Batch:
        ctx, tgt = raw["context"], raw["target"]
        lat = "latent_moments" in ctx
        return batch_from_arrays(
            ctx.get("image"), tgt.get("image"), ctx["extrinsics"], tgt["extrinsics"],
            ctx["intrinsics"], tgt["intrinsics"],
            ctx["latent_moments"] if lat else None, tgt["latent_moments"] if lat else None)

    def _log(self, step: int, metrics: Dict[str, Any]) -> None:
        with open(self.metrics_log, "a") as f:
            f.write(json.dumps({"step": step, **{k: float(v) for k, v in metrics.items()}}) + "\n")

    def fit(self, state: TrainState, batches: Iterable[Dict[str, Dict[str, Any]]],
            seed: int = 0) -> TrainState:
        """Train from ``state.step`` to ``max_steps`` (at most ``task_steps``
        more). Step ``s`` draws its randomness from a generator seeded with
        (seed, s), the JAX ``fold_in(rng, step)``, so a resumed run repeats
        the draws of an unbroken one."""
        start = state.step
        end = self.max_steps if self.task_steps is None else min(
            self.max_steps, start + self.task_steps)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        dev = self.engine.device
        t0, window = time.perf_counter(), 0
        for raw in batches:
            step = state.step
            if step >= end:
                break
            if self.step_tracker is not None:
                self.step_tracker.set_step(step)
            gen = torch.Generator(device=dev).manual_seed((seed << 32) + step)
            state, metrics = self._train_step(state, self._batch(raw), generator=gen)
            window += 1
            new_step = step + 1
            if new_step % self.log_every == 0 or new_step == end:
                metrics = {k: float(v) for k, v in metrics.items()}  # syncs the device
                dt = time.perf_counter() - t0
                metrics["steps_per_sec"] = window / dt if dt > 0 else 0.0
                self._log(new_step, metrics)
                print(f"step {new_step}: loss={metrics['loss/diffusion']:.5f} "
                      f"({metrics['steps_per_sec']:.2f} it/s)")
                t0, window = time.perf_counter(), 0
            if new_step % self.checkpoint_every == 0 or new_step == end:
                self.ckpt.save(new_step, state.state_dict())
        return state

