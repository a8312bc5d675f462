"""Tensor parallelism over the ``model`` ranks (counterpart of
``mvldm_tpu/parallel/tp.py``).

Activation: ``trainer.strategy=data_model`` with ``trainer.num_model=K``.
The trainer publishes its mesh around each step's forward and backward
(:func:`model_parallel`); the modules consult it, and run as on one card
when nothing is published (sampling, the validation hook, every other
strategy).

* The joint cross-view attention (``attn1`` of the cross-view blocks,
  ``models/mv_attention.py``) shards its heads: each model rank projects
  its H/K heads with its rows of ``to_q`` / ``to_k`` / ``to_v``, runs
  ``ops.attention`` on them (on the card the flash kernels,
  ``csrc/flash_attn_fwd.cu`` and ``flash_attn_bwd.cu``), and applies its
  columns of ``to_out``; the Megatron pair of autograd functions closes
  the block: :class:`CopyToModel` before the projections (identity
  forward, all-reduce backward) and :class:`ReduceFromModel` after
  ``to_out`` (all-reduce forward, identity backward).
* The per-frame blocks (``models/layers.self_attn_block`` and
  ``ff_block``; on the card the fused kernels) take a share of the (b v)
  frames each and all-gather the result (:func:`view_parallel`), where K
  divides b v (the JAX ``_batch_axes``); otherwise every model rank runs
  the block whole.

Gradients. Outside the view-parallel blocks every model rank computes the
same values, so a replicated parameter's gradient is the same on each. A
parameter inside a view-parallel block sees only its rank's frames; the
gather's backward scales its slice by K (and the scatter's backward divides
the gathered input gradient by K back), so the mean over the model ranks
of a replicated parameter's gradient is the exact gradient in both cases.
The trainer takes that mean (``training/strategy.py``). The sharded
``to_q`` / ``to_k`` / ``to_v`` / ``to_out`` weights are computed with only
their rank's slice, whose gradient is exact on that rank.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

_MODEL_MESH = None


@contextmanager
def model_parallel(mesh):
    """Publish ``mesh`` (its model group) for the forward and backward run
    inside; None, or a mesh with one model rank, publishes nothing. The
    previous publication is restored after."""
    global _MODEL_MESH
    prev = _MODEL_MESH
    _MODEL_MESH = mesh if mesh is not None and mesh.num_model > 1 else None
    try:
        yield
    finally:
        _MODEL_MESH = prev


def get_model_mesh():
    return _MODEL_MESH


def use_head_sharding(num_heads: int, mesh) -> bool:
    """True when a mesh is published and its model ranks divide the heads."""
    return mesh is not None and num_heads % mesh.num_model == 0


# ------------------------------------------------------------- collectives

def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in group-rank order.
    gloo carries only broadcast and all-reduce for CUDA tensors, so there
    the pieces are summed into a zero buffer instead (exact: each element
    has one nonzero term)."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    r = dist.get_rank(group)
    if t.is_cuda and dist.get_backend(group) == "gloo":
        shape = list(t.shape)
        shape[dim] *= n
        out = t.new_zeros(shape)
        out.narrow(dim, r * t.shape[dim], t.shape[dim]).copy_(t)
        dist.all_reduce(out, group=group)
        return out
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def reduce_scatter(out: torch.Tensor, t: torch.Tensor, group) -> None:
    """Row ``rank`` of the sum over the ranks of the (N, m) ``t`` into
    ``out`` (m,). gloo carries only broadcast and all-reduce for CUDA
    tensors, so there the whole of ``t`` is all-reduced and the row kept."""
    n = 1 if group is None else dist.get_world_size(group)
    if n == 1:
        out.copy_(t[0])
    elif t.is_cuda and dist.get_backend(group) == "gloo":
        dist.all_reduce(t, group=group)
        out.copy_(t[dist.get_rank(group)])
    else:
        dist.reduce_scatter_tensor(out, t.view(-1), group=group)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    t = t.contiguous().clone()
    dist.all_reduce(t, group=group)
    return t


class CopyToModel(torch.autograd.Function):
    """Identity forward; all-reduce (sum) of the gradient over the model
    group backward: the input of the column-sharded projections."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class ReduceFromModel(torch.autograd.Function):
    """All-reduce (sum) over the model group forward; identity backward:
    the output of the row-sharded projection."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterRows(torch.autograd.Function):
    """This rank's share of the leading axis forward; the all-gathered
    gradient over K backward (see the module docstring)."""

    @staticmethod
    def forward(ctx, x, group):
        k, r = dist.get_world_size(group), dist.get_rank(group)
        n = x.shape[0] // k
        ctx.group, ctx.k = group, k
        return x.narrow(0, r * n, n)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.group) / ctx.k, None


class _GatherRows(torch.autograd.Function):
    """All-gather of the leading axis forward; K times this rank's slice of
    the gradient backward (see the module docstring)."""

    @staticmethod
    def forward(ctx, x, group):
        k, r = dist.get_world_size(group), dist.get_rank(group)
        ctx.group, ctx.k, ctx.r, ctx.n = group, k, r, x.shape[0]
        return all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(0, ctx.r * ctx.n, ctx.n) * ctx.k, None


# ------------------------------------------------------------------ paths

def view_parallel(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor, mesh
                  ) -> torch.Tensor:
    """``fn(x)`` for a per-frame block over (b v, l, c) tokens under the
    published ``mesh``: where its K model ranks divide b v, each rank runs
    ``fn`` on its b v / K frames and the results are all-gathered;
    otherwise a direct call. ``fn`` has no cross-frame reduction, so the
    split does not change what it computes."""
    if x.shape[0] % mesh.num_model:
        return fn(x)
    group = mesh.model_group
    return _GatherRows.apply(fn(_ScatterRows.apply(x, group)), group)


def head_sharded_attention(attn, x: torch.Tensor, key_bias: Optional[torch.Tensor],
                           mesh) -> torch.Tensor:
    """A ``models.layers.CrossAttention`` self-attention over ``x`` (b, l,
    c) with its heads split over the model ranks of ``mesh``: this rank's
    rows of ``to_q`` / ``to_k`` /
    ``to_v``, ``ops.attention`` on its H / K heads, its columns of
    ``to_out``, the partial outputs summed over the ranks, then the bias.
    ``key_bias``: (b, l) or None. Requires :func:`use_head_sharding`."""
    from ..models.layers import _merge_heads, _split_heads
    from ..ops.attention import attention

    group, kk, r = mesh.model_group, mesh.num_model, mesh.model_rank
    heads = attn.num_heads // kk
    width = heads * attn.head_dim
    rows = slice(r * width, (r + 1) * width)
    x = CopyToModel.apply(x, group)
    q, k, v = (_split_heads(F.linear(x, lin.weight[rows]), heads)
               for lin in (attn.to_q, attn.to_k, attn.to_v))
    out = attention(q, k, v, bias=key_bias)
    wo = attn.to_out[0]
    y = ReduceFromModel.apply(F.linear(_merge_heads(out), wo.weight[:, rows]), group)
    return y + wo.bias
