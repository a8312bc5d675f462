"""Train step and host loop (counterpart of
``mvldm_tpu/training/trainer.py``), on one card or, under a
``training/strategy.Strategy``, on each rank of a process group (one
process per card; the JAX mesh plans).

Mixed precision, as the JAX package trains (f32 parameters, bf16
compute): the UNet module runs in its own dtype, bf16 on the card, the same
forward that sampling runs, so the kernels see what they are built for.
``TrainState.params`` holds an f32 master copy of every UNet parameter;
each step hands the module's gradients to the optimizer, which casts them
to f32 a group at a time, updates the masters, and copies the masters back
into the module. The VAE is frozen.

A step's parts are spanned (``utils/profiling.py``): ``train.forward_backward``
(the batch's upload, ``sync.batch_upload``, the loss and its backward),
``train.grad_norm``, ``train.optimizer``, ``train.load_params`` and
``train.ema``; the ``Trainer``'s loop adds ``train.data_wait`` (taking the
next batch), ``train.log``, ``train.checkpoint`` and ``train.val``.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn as nn

from ..diffusion.engine import Batch, DiffusionEngine, TrainDraws
from ..parallel.distributed import is_main_process, sync_processes
from ..utils.profiling import span, start_trace, stop_trace, sync
from .checkpoint import CheckpointManager
from .optim import Optimizer, ema_update, global_norm
from .strategy import Strategy, step_seed


@dataclass
class TrainState:
    # f32 masters, by UNet parameter name (under a strategy, in its stored
    # form: slices of the leaves it splits, see Strategy.store)
    params: Dict[str, torch.Tensor]
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


def upload_batch(batch: Batch, device) -> Batch:
    """``batch`` with its host tensors on ``device``: pageable copies."""
    moved = {}
    for name in ("images", "extrinsics", "intrinsics", "latent_moments"):
        t = getattr(batch, name)
        if t is not None and t.device.type == "cpu":
            with sync("batch_upload"):
                moved[name] = t.to(device)
    return replace(batch, **moved)


def make_train_step(engine: DiffusionEngine, tx: Optimizer, num_context_views: int,
                    ema_decay: float = 0.995, strategy: Optional[Strategy] = None
                    ) -> Callable:
    """``step(state, batch, draws=None, generator=None) -> (state, metrics)``:
    loss and gradients of the engine's UNet, one optimizer apply on the
    masters, the EMA only on steps that applied an update. ``state`` is
    updated in place and returned. Under ``strategy`` the batch and draws
    are this rank's share; the loss, gradient norm and update are the
    global batch's (see ``training/strategy.py``)."""
    named = [(n, p) for n, p in engine.unet.named_parameters() if p.requires_grad]

    def train_step(state: TrainState, batch: Batch, draws: Optional[TrainDraws] = None,
                   generator: Optional[torch.Generator] = None):
        for _, p in named:
            p.grad = None
        if strategy is None:
            with span("train.forward_backward"):
                loss, metrics = engine.training_loss(upload_batch(batch, engine.device),
                                                     num_context_views, draws, generator)
                loss.backward()
            # A parameter the loss does not reach (the SD text attention's
            # q/k/v under the zero text context) has a zero gradient, as in
            # JAX. The module's (bf16) gradients go to the optimizer as they are.
            grads = {n: p.grad if p.grad is not None else torch.zeros_like(state.params[n])
                     for n, p in named}
            with span("train.grad_norm"):
                grad_norm = global_norm(list(grads.values()))
            with span("train.optimizer"):
                applied = tx.apply(state.params, grads, state.opt_state)
        else:
            with span("train.forward_backward"), strategy.compute():
                loss, metrics = engine.training_loss(upload_batch(batch, engine.device),
                                                     num_context_views, draws, generator,
                                                     strategy.count_reduce)
                loss.backward()
            grads = strategy.reduce_grads()
            with span("train.grad_norm"):
                grad_norm = strategy.global_norm(grads)
            metrics = strategy.reduce_metrics(metrics)
            with span("train.optimizer"):
                applied = strategy.apply(tx, state, grads)
        del grads
        for _, p in named:
            p.grad = None
        if applied:
            with span("train.load_params"):
                if strategy is None:
                    load_params(engine.unet, state.params)
                else:
                    strategy.load_module(state.params)
            if state.ema_params is not None:
                with span("train.ema"):
                    ema_update(state.ema_params, state.params, ema_decay)
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = grad_norm
        return state, metrics

    return train_step


class Trainer:
    """Host loop (the JAX ``Trainer``): pulls batches from
    ``data_module.train_dataloader()`` in the data loader's dict format
    (``{"context": {...}, "target": {...}}``, each with ``image`` (b, v, h,
    w, 3), ``extrinsics``, ``intrinsics`` and optionally
    ``latent_moments``), appends one JSON line per ``log_every`` steps to
    ``<run_dir>/metrics.jsonl``, checkpoints every ``checkpoint_every``
    steps and at the last step, and calls ``val_hook(state, step)`` every
    ``val_check_interval`` steps. With ``MVLDM_PROFILE_DIR`` set, steps
    start + 10 to start + 13 are traced there. Under ``strategy`` only rank
    0 writes (``metrics.jsonl``, checkpoints, the validation hook's files),
    with a barrier after each write; a checkpoint holds the whole state,
    gathered first."""

    def __init__(self, engine: DiffusionEngine, tx: Optimizer, data_module, run_dir, *,
                 max_steps: int, num_context_views: int, checkpoint_every: int = 1000,
                 save_top_k: int = 1, log_every: int = 50, use_ema: bool = False,
                 step_tracker: Any = None, val_hook: Optional[Callable] = None,
                 val_check_interval: Optional[int] = None,
                 task_steps: Optional[int] = None, strategy: Optional[Strategy] = None):
        self.engine, self.tx, self.data_module = engine, tx, data_module
        self.run_dir = Path(run_dir)
        self.max_steps, self.num_context_views = max_steps, num_context_views
        self.checkpoint_every, self.log_every = checkpoint_every, log_every
        self.use_ema, self.step_tracker = use_ema, step_tracker
        self.val_hook, self.val_check_interval = val_hook, val_check_interval
        self.task_steps, self.strategy = task_steps, strategy
        self.ckpt = CheckpointManager(self.run_dir / "checkpoints", save_top_k)
        self.metrics_log = self.run_dir / "metrics.jsonl"
        self._train_step = make_train_step(engine, tx, num_context_views, strategy=strategy)

    def init_state(self) -> TrainState:
        params = master_params(self.engine.unet)
        if self.strategy is not None:
            params = self.strategy.store(params)
        seen = params if self.strategy is None else self.strategy.optimizer_params(params)
        ema = {n: p.clone() for n, p in params.items()} if self.use_ema else None
        return TrainState(params=params, opt_state=self.tx.init(seen), ema_params=ema,
                          step=0)

    def maybe_restore(self, state: TrainState) -> TrainState:
        """Resume from the newest checkpoint, if any, into the module too.
        ``state`` is dropped before the saved one is read, so a caller that
        passes its only reference (``maybe_restore(init_state())``) holds
        one state on the device, not two. Under a strategy each rank reads
        the whole saved state (memory-mapped) and keeps its slices."""
        latest = self.ckpt.latest_step()
        if latest is None:
            return state
        if is_main_process():
            print(f"Resuming from checkpoint at step {latest}")
        del state
        if self.strategy is None:
            state = TrainState(**self.ckpt.restore(latest, map_location=self.engine.device))
            load_params(self.engine.unet, state.params)
            return state
        saved = self.ckpt.restore(latest, map_location="cpu", mmap=True)
        state = TrainState(**self.strategy.from_whole(saved, self.engine.device))
        del saved
        self.strategy.load_module(state.params)
        return state

    def _batch(self, raw: Dict[str, Dict[str, Any]]) -> Batch:
        ctx, tgt = raw["context"], raw["target"]
        lat = "latent_moments" in ctx
        return batch_from_arrays(
            ctx.get("image"), tgt.get("image"), ctx["extrinsics"], tgt["extrinsics"],
            ctx["intrinsics"], tgt["intrinsics"],
            ctx["latent_moments"] if lat else None, tgt["latent_moments"] if lat else None)

    def _log(self, step: int, metrics: Dict[str, Any]) -> None:
        if not is_main_process():
            return
        with open(self.metrics_log, "a") as f:
            f.write(json.dumps({"step": step, **{k: float(v) for k, v in metrics.items()}}) + "\n")

    def fit(self, state: TrainState, seed: int = 0) -> TrainState:
        """Train from ``state.step`` to ``max_steps`` (at most ``task_steps``
        more). Step ``s`` draws its randomness from a generator seeded with
        (seed, s), the JAX ``fold_in(rng, step)``, so a resumed run repeats
        the draws of an unbroken one; under a strategy each data rank folds
        its rank in (``strategy.step_seed``). The train loader is infinite and
        decodes in threads: it is closed, with a bounded wait, however the
        loop ends."""
        start = state.step
        end = self.max_steps if self.task_steps is None else min(
            self.max_steps, start + self.task_steps)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        loader = self.data_module.train_dataloader()
        try:
            return self._fit_loop(state, seed, loader, start, end)
        finally:
            loader.close(timeout=60.0)

    def _fit_loop(self, state: TrainState, seed: int, loader, start: int, end: int
                  ) -> TrainState:
        dev = self.engine.device
        t0, window = time.perf_counter(), 0
        profile_dir = os.environ.get("MVLDM_PROFILE_DIR") if is_main_process() else None
        data_rank = self.strategy.mesh.data_rank if self.strategy is not None else 0
        profile_window = (start + 10, start + 13)
        prof = None
        batches = iter(loader)
        try:
            while state.step < end:
                step = state.step
                if profile_dir and step == profile_window[0] and prof is None:
                    prof = start_trace()
                if prof is not None and step == profile_window[1]:
                    out = stop_trace(prof, Path(profile_dir))
                    prof = None
                    print(f"[profile] wrote train-step trace to {out}")
                with span("train.data_wait"):
                    raw = next(batches, None)
                if raw is None:
                    break
                if self.step_tracker is not None:
                    self.step_tracker.set_step(step)
                gen = torch.Generator(device=dev).manual_seed(step_seed(seed, step, data_rank))
                state, metrics = self._train_step(state, self._batch(raw), generator=gen)
                window += 1
                new_step = step + 1
                if new_step % self.log_every == 0 or new_step == end:
                    with span("train.log"):
                        metrics = {k: float(v) for k, v in metrics.items()}  # syncs the device
                        dt = time.perf_counter() - t0
                        metrics["steps_per_sec"] = window / dt if dt > 0 else 0.0
                        self._log(new_step, metrics)
                    if is_main_process():
                        print(f"step {new_step}: loss={metrics['loss/diffusion']:.5f} "
                              f"({metrics['steps_per_sec']:.2f} it/s)")
                    t0, window = time.perf_counter(), 0
                if new_step % self.checkpoint_every == 0 or new_step == end:
                    with span("train.checkpoint"):
                        self._save(new_step, state)
                if (self.val_hook is not None and self.val_check_interval
                        and new_step % self.val_check_interval == 0):
                    with span("train.val"):
                        self._run_val_hook(state, new_step)
        finally:
            if prof is not None:
                stop_trace(prof, Path(profile_dir))
        return state

    def _save(self, step: int, state: TrainState) -> None:
        """One card saves its state as it is. Under a strategy every rank
        gathers the whole state (collective), rank 0 writes it, and the
        ranks meet at a barrier before training on."""
        if self.strategy is None:
            self.ckpt.save(step, state.state_dict())
            return
        whole = self.strategy.whole_state(state)
        if is_main_process():
            self.ckpt.save(step, whole)
        del whole
        sync_processes("checkpoint")

    def _run_val_hook(self, state: TrainState, step: int) -> None:
        """The hook on rank 0 with whole parameters: under a strategy that
        stores slices every rank first gathers the masters and the EMA
        (collective); the other ranks wait at a barrier."""
        if self.strategy is None:
            self.val_hook(state, step)
            return
        sliced = self.strategy.store_sliced
        view = TrainState(params=self.strategy.whole(state.params, sliced),
                          opt_state={},
                          ema_params=self.strategy.whole(state.ema_params, sliced),
                          step=step)
        if is_main_process():
            self.val_hook(view, step)
        del view
        sync_processes("val_hook")
