"""Multi-rank strategies of the train step (the port's counterpart of the
mesh plans of ``mvldm_tpu/training/trainer.py:127-198``).

One process per card. ``trainer.strategy`` names the plan:

* ``data_parallel``: every rank holds the whole state; the gradients are
  summed over the ranks (bucketed ``all_reduce`` in f32) before the
  optimizer.
* ``data_parallel_zero1``: the optimizer moments are split over the data
  ranks by ``parallel/mesh.zero1_shardings``; the gradients of the split
  leaves are reduce-scattered into each rank's slices, each rank updates
  its slice of the f32 masters, and the slices are all-gathered after.
* ``data_parallel_fsdp``: the masters and the EMA are split the same way
  too; the module's bf16 weights, which the forward computes with, are
  all-gathered from the updated slices after each update.
* ``data_model``: the (data, model) grid of ``trainer.num_model`` model
  ranks, tensor parallelism of the joint cross-view attention and view
  parallelism of the per-frame blocks (``parallel/tp.py``); the sharded
  ``to_q`` / ``to_k`` / ``to_v`` / ``to_out`` weights
  (``tensor_parallel_shardings``) keep their masters, moments and EMA as
  model slices and sum their gradients over the data ranks only.

The loss is the global batch's mean in every plan: each rank divides its
sum by the target views of all data ranks (``training_loss``'s
``count_reduce``), so the summed gradient is the one-card gradient of the
concatenated batch, as the JAX loss over a data-sharded batch is. The
gradient norm, and the clip, are those of the whole gradient: sliced
leaves sum their squares over their group, replicated leaves count once.
A checkpoint holds the whole state, gathered before rank 0 writes it, so
it restores under any plan and on one card. AdamW, Adam and SGD are
elementwise and update slices; Adafactor's row, column and block
statistics span whole leaves, and its factored state is small (a row and
a column a matrix), so under a plan that slices leaves it keeps its state
whole on every rank and updates whole leaves: the gradient slices, and
the master slices where they are stored so, are gathered for it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from ..parallel.mesh import Mesh, fsdp_shardings, tensor_parallel_shardings, zero1_shardings
from ..parallel.tp import all_gather, model_parallel, reduce_scatter
from .optim import global_norm, rounding_noise

STRATEGIES = ("data_parallel", "data_parallel_zero1", "data_parallel_fsdp", "data_model")
# Elements of one f32 bucket of the gradient all-reduce (128 MB).
BUCKET_ELEMENTS = 1 << 25


def step_seed(seed: int, step: int, data_rank: int = 0) -> int:
    """The seed of step ``step``'s generator: ``(seed << 32) + step`` on
    data rank 0, the one-card seed, so a world-1 run draws what one card
    draws; other data ranks fold their rank in, so they draw other noise
    (the model ranks of one data rank draw the same)."""
    if data_rank == 0:
        return (seed << 32) + step
    return int(np.random.SeedSequence([seed, step, data_rank]).generate_state(1, np.uint64)[0])


class Strategy:
    """The plan of one strategy over ``mesh`` for the trainable parameters
    of ``module``. Every method that takes or returns state is collective:
    every rank calls it, in the same order."""

    def __init__(self, name: str, mesh: Mesh, module: nn.Module, tx):
        if name not in STRATEGIES:
            raise ValueError(f"Unknown strategy {name!r}; expected one of {STRATEGIES}")
        if name != "data_model" and mesh.num_model != 1:
            raise ValueError(f"{name} takes no model axis (num_model={mesh.num_model})")
        self.name, self.mesh = name, mesh
        self.named = [(n, p) for n, p in module.named_parameters() if p.requires_grad]
        shapes = {n: tuple(p.shape) for n, p in self.named}
        if name == "data_model":
            self.axes = tensor_parallel_shardings(shapes, mesh.num_model)
            self.shard_axis = "model"
        elif name in ("data_parallel_zero1", "data_parallel_fsdp"):
            rule = fsdp_shardings if name == "data_parallel_fsdp" else zero1_shardings
            self.axes = rule(shapes, mesh.num_data)
            self.shard_axis = "data"
        else:
            self.axes = {n: None for n in shapes}
            self.shard_axis = "data"
        # Masters and EMA are stored as slices under FSDP and for the
        # tensor-parallel leaves; ZeRO-1 keeps them whole.
        self.store_sliced = name in ("data_parallel_fsdp", "data_model")
        self.group = mesh.group(self.shard_axis)
        self.parts = mesh.size(self.shard_axis)
        self.index = mesh.index(self.shard_axis)
        self.sliced = [n for n, a in self.axes.items() if a is not None and self.parts > 1]
        # Adafactor updates whole leaves (see the module docstring).
        self.whole_optimizer = bool(self.sliced) and getattr(tx, "name", None) == "Adafactor"

    # ------------------------------------------------------------ slices

    def shard(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole leaf ``t`` (a view)."""
        axis = self.axes[name]
        if axis is None or self.parts == 1:
            return t
        n = t.shape[axis] // self.parts
        return t.narrow(axis, self.index * n, n)

    def gather(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole leaf from every rank's slice ``t``."""
        axis = self.axes[name]
        if axis is None or self.parts == 1:
            return t
        return all_gather(t, self.group, axis)

    def store(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Whole leaves -> the form the state keeps (own memory)."""
        if not self.store_sliced:
            return params
        return {n: self.shard(n, p).clone() for n, p in params.items()}

    def local(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The stored masters -> this rank's slices (views)."""
        if self.store_sliced:
            return params
        return {n: self.shard(n, p) for n, p in params.items()}

    def optimizer_params(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """What the optimizer's ``init`` sees of the stored masters: this
        rank's slices, or whole leaves for Adafactor (collective)."""
        if self.whole_optimizer:
            return self.whole(params, self.store_sliced)
        return self.local(params)

    def apply(self, tx, state, grads: Dict[str, torch.Tensor]) -> bool:
        """One optimizer apply on this rank's slices; for Adafactor on whole
        leaves (the gradient and, where stored sliced, the masters gathered;
        the updated slices copied back)."""
        if not self.whole_optimizer:
            return tx.apply(self.local(state.params), grads, state.opt_state,
                            norm_fn=self.global_norm, noise_fn=self.rounding_noise)
        params = self.whole(state.params, self.store_sliced)
        applied = tx.apply(params, self.whole(grads, sliced=True), state.opt_state)
        if self.store_sliced:
            for n, p in state.params.items():
                p.copy_(self.shard(n, params[n]))
        return applied

    def whole(self, tree: Optional[Dict[str, torch.Tensor]], sliced: bool,
              to_cpu: bool = False) -> Optional[Dict[str, torch.Tensor]]:
        """A dict of leaves in stored form -> whole leaves (collective);
        with ``to_cpu`` each gathered leaf is moved to the host as it comes,
        so no card holds the whole of a split tree. A leaf stored whole is
        returned as it is."""
        if tree is None:
            return None
        out = {}
        for n, t in tree.items():
            full = self.gather(n, t) if sliced else t
            out[n] = full.cpu() if to_cpu and full is not t else full
        return out

    # ------------------------------------------------------------- step

    def compute(self):
        """The context of a step's forward and backward: the published
        model ranks under ``data_model``."""
        return model_parallel(self.mesh if self.name == "data_model" else None)

    def count_reduce(self, count: torch.Tensor) -> torch.Tensor:
        """The target-view count summed over the data ranks."""
        if self.mesh.data_group is None:
            return count
        count = count.clone()
        dist.all_reduce(count, group=self.mesh.data_group)
        return count

    def reduce_metrics(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each rank's share of a mean -> the global mean (summed over the
        data ranks)."""
        if self.mesh.data_group is None or not metrics:
            return metrics
        names = list(metrics)
        vals = torch.stack([metrics[k].detach().float().reshape(()) for k in names])
        dist.all_reduce(vals, group=self.mesh.data_group)
        return {k: vals[i] for i, k in enumerate(names)}

    def reduce_grads(self) -> Dict[str, torch.Tensor]:
        """The module's gradients -> this rank's slices of the global
        gradient, in f32. Replicated leaves: summed over every rank and
        divided by the model ranks (their mean, see ``parallel/tp.py``);
        the tensor-parallel slices: summed over the data ranks; the ZeRO-1
        and FSDP slices: reduce-scattered over the data ranks, a bucket at
        a time, so no rank holds their whole f32 gradient."""
        sliced = set(self.sliced)
        world = dist.group.WORLD if dist.is_initialized() else None
        plain = [(n, p) for n, p in self.named if n not in sliced]
        split = [(n, p) for n, p in self.named if n in sliced]
        out = self._all_reduce(plain, world, self.mesh.num_model)
        if self.name == "data_model":
            out.update(self._all_reduce(split, self.mesh.data_group, 1, take_slice=True))
        else:
            out.update(self._reduce_scatter(split))
        return {n: out[n] for n, _ in self.named}

    @staticmethod
    def _grad(p: nn.Parameter) -> torch.Tensor:
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        p.grad = None
        return g

    def _all_reduce(self, named, group, divide: int, take_slice: bool = False
                    ) -> Dict[str, torch.Tensor]:
        """The leaves' gradients (this rank's slices with ``take_slice``)
        copied into one f32 buffer, all-reduced over ``group`` in buckets
        and divided by ``divide``."""
        if not named:
            return {}
        grads = [self._grad(p) for _, p in named]
        if take_slice:
            grads = [self.shard(n, g) for (n, _), g in zip(named, grads)]
        flat = torch.empty(sum(g.numel() for g in grads), dtype=torch.float32,
                           device=grads[0].device)
        views, off = [], 0
        for g in grads:
            views.append(flat[off:off + g.numel()].view(g.shape))
            views[-1].copy_(g)
            off += g.numel()
        del grads
        if group is not None:
            for start in range(0, flat.numel(), BUCKET_ELEMENTS):
                dist.all_reduce(flat[start:start + BUCKET_ELEMENTS], group=group)
        if divide > 1:
            flat.div_(divide)
        return {n: v for (n, _), v in zip(named, views)}

    def _reduce_scatter(self, named) -> Dict[str, torch.Tensor]:
        """The gradients of leaves split over the data ranks -> this rank's
        slices of their sums. A leaf's gradient, its split axis moved first,
        is viewed as (N, slice) rows, row r rank r's slice; a bucket packs
        the rows of its leaves side by side into an (N, m) f32 buffer,
        which is reduce-scattered; this rank's row, viewed back, holds its
        slices (strided views, :meth:`shard`'s slices)."""
        if not named:
            return {}
        parts = self.parts
        sizes = [p.numel() // parts for _, p in named]
        mine = torch.empty(sum(sizes), dtype=torch.float32, device=named[0][1].device)
        out: Dict[str, torch.Tensor] = {}
        i = off = 0
        while i < len(named):
            j, m = i + 1, sizes[i]
            while j < len(named) and (m + sizes[j]) * parts <= BUCKET_ELEMENTS:
                m += sizes[j]
                j += 1
            buf = torch.empty((parts, m), dtype=torch.float32, device=mine.device)
            col = 0
            for (n, p), size in zip(named[i:j], sizes[i:j]):
                buf[:, col:col + size].copy_(
                    self._grad(p).movedim(self.axes[n], 0).reshape(parts, size))
                col += size
            row = mine[off:off + m]
            reduce_scatter(row, buf, self.group)
            del buf
            col = 0
            for (n, p), size in zip(named[i:j], sizes[i:j]):
                axis = self.axes[n]
                moved = [p.shape[axis] // parts] + [d for a, d in enumerate(p.shape)
                                                    if a != axis]
                out[n] = row[col:col + size].view(moved).movedim(0, axis)
                col += size
            i, off = j, off + m
        return out

    def global_norm(self, grads: Dict[str, torch.Tensor]) -> float:
        """The whole gradient's L2 norm from this rank's slices: sliced
        leaves' squares summed over their group, replicated leaves once.
        With nothing sliced, the one-card formula."""
        sliced = [grads[n] for n in self.sliced if n in grads]
        if not sliced:
            return global_norm(list(grads.values()))
        rest = [g for n, g in grads.items() if n not in set(self.sliced)]

        def squares(ts: List[torch.Tensor]) -> torch.Tensor:
            if not ts:
                return torch.zeros((), dtype=torch.float32, device=sliced[0].device)
            norms = torch._foreach_norm(ts, 2, dtype=torch.float32)
            return torch.stack(norms).square().sum()

        part = squares(sliced)
        dist.all_reduce(part, group=self.group)
        return float((part + squares(rest)).sqrt())

    def rounding_noise(self, name: str, like: torch.Tensor, count: int, leaf: int):
        """The stochastic rounding's draws of this rank's slice: the whole
        leaf's draws (as one card draws them), sliced."""
        shape, axis = list(like.shape), self.axes[name]
        if axis is not None and self.parts > 1:
            shape[axis] *= self.parts
        return tuple(self.shard(name, t) for t in rounding_noise(shape, like.device, count, leaf))

    @torch.no_grad()
    def load_module(self, params: Dict[str, torch.Tensor]) -> None:
        """Copy the updated masters into the module: sliced leaves are
        all-gathered (under ZeRO-1 into the whole master too)."""
        named, sliced = dict(self.named), set(self.sliced)
        for n, p in params.items():
            if n in sliced:
                full = self.gather(n, self.local({n: p})[n])
                if not self.store_sliced and full is not p:
                    p.copy_(full)
                named[n].copy_(full)
            else:
                named[n].copy_(p)

    # ------------------------------------------------------- whole state

    def whole_state(self, state, to_cpu: bool = True) -> Dict[str, Any]:
        """The train state as one card holds it (collective): the leaves
        stored whole as they are, the split ones gathered (to the host with
        ``to_cpu``)."""
        opt = {}
        for k, v in state.opt_state.items():
            if isinstance(v, dict) and v and set(v) <= set(self.axes):
                opt[k] = self.whole(v, not self.whole_optimizer, to_cpu)
            else:
                opt[k] = v
        return {"params": self.whole(state.params, self.store_sliced, to_cpu),
                "opt_state": opt,
                "ema_params": self.whole(state.ema_params, self.store_sliced, to_cpu),
                "step": state.step}

    def from_whole(self, saved: Dict[str, Any], device) -> Dict[str, Any]:
        """A whole saved state -> this rank's stored form on ``device``."""
        def stored(tree, keep_whole: bool):
            if tree is None:
                return None
            return {n: (t if keep_whole else self.shard(n, t)).to(device, copy=True)
                    .contiguous() for n, t in tree.items()}

        opt = {}
        for k, v in saved["opt_state"].items():
            if isinstance(v, dict) and v and set(v) <= set(self.axes):
                opt[k] = stored(v, keep_whole=self.whole_optimizer)
            else:
                opt[k] = v
        return {"params": stored(saved["params"], not self.store_sliced),
                "opt_state": opt,
                "ema_params": stored(saved["ema_params"], not self.store_sliced),
                "step": saved["step"]}
