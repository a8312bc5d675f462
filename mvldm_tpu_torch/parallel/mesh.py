"""A (data, model) grid of ranks and the sharding rules (counterpart of
``mvldm_tpu/parallel/mesh.py``).

The JAX package builds a ``jax.sharding.Mesh`` of devices and states its
plans as ``NamedSharding``s that XLA turns into collectives. The port runs
one process per card: :func:`make_mesh` arranges the ranks of the process
group row-major in a (data, model) grid, as ``np.reshape(devices, (data,
model))`` does, and builds one process group along each row and column.
The rules below are plain functions from parameter names and shapes to
the torch axis a leaf is split along (None: replicated); the trainer
(``training/strategy.py``) issues the collectives.

Layouts. The port's parameters are torch's: a ``Linear`` weight is (out,
in) where the JAX kernel is (in, out), and a conv weight is (out, in, kh,
kw) where the JAX kernel is (kh, kw, in, out). Each rule is decided on the
JAX layout of the leaf (:func:`jax_axes`), so it picks the same logical
dimension as the JAX package, ties included, and is then mapped back to
the torch axis. The tensor-parallel "columns" of ``to_q`` / ``to_k`` /
``to_v`` (JAX axis 1, the heads' features) are torch axis 0, and the
"rows" of ``to_out`` (JAX axis 0) are torch axis 1.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch.distributed as dist


@dataclass
class Mesh:
    """This process's place in a (data, model) grid of ``num_data x
    num_model`` ranks: rank = data_rank * num_model + model_rank. The
    groups are None where they hold one rank (no collective is needed)."""

    num_data: int
    num_model: int
    rank: int
    data_group: Optional[object]   # the ranks of this rank's column (same model_rank)
    model_group: Optional[object]  # the ranks of this rank's row (same data_rank)

    @property
    def data_rank(self) -> int:
        return self.rank // self.num_model

    @property
    def model_rank(self) -> int:
        return self.rank % self.num_model

    def group(self, axis: str):
        return self.data_group if axis == "data" else self.model_group

    def size(self, axis: str) -> int:
        return self.num_data if axis == "data" else self.num_model

    def index(self, axis: str) -> int:
        return self.data_rank if axis == "data" else self.model_rank


def make_mesh(num_data: Optional[int] = None, num_model: int = 1) -> Mesh:
    """Arrange the process group's ranks as a (data, model) grid. Defaults
    to every rank on the data axis. Raises when the grid does not hold the
    world exactly. Every rank must call it (the groups are collective)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if num_data is None:
        num_data = world // num_model
    if num_data * num_model != world:
        raise ValueError(
            f"Requested a {num_data}(data) x {num_model}(model) mesh but the process "
            f"group holds {world} rank(s). Start num_data x num_model processes "
            "(MVLDM_NUM_PROCESSES, or torchrun's --nproc-per-node with "
            "MVLDM_DISTRIBUTED=1).")
    data_group = model_group = None
    for m in range(num_model):  # columns: same model rank
        ranks = [d * num_model + m for d in range(num_data)]
        g = _new_group(ranks, world)
        if rank in ranks:
            data_group = g
    for d in range(num_data):  # rows: same data rank
        ranks = [d * num_model + m for m in range(num_model)]
        g = _new_group(ranks, world)
        if rank in ranks:
            model_group = g
    return Mesh(num_data, num_model, rank,
                data_group if num_data > 1 else None,
                model_group if num_model > 1 else None)


def _new_group(ranks: Sequence[int], world: int):
    if len(ranks) == 1:
        return None
    if len(ranks) == world:
        return dist.group.WORLD
    return dist.new_group(list(ranks))


# ------------------------------------------------------------------ rules

def jax_axes(name: str, ndim: int) -> Tuple[int, ...]:
    """The JAX axis of each torch axis of parameter ``name``: a 2-D weight
    is a transposed dense kernel, a 4-D weight an OIHW conv kernel (the
    standard block's ``upscaler``, a transposed conv, is (in, out, kh,
    kw)); anything else keeps its axes (``utils/weight_convert``)."""
    if name.endswith("weight") and ndim == 2:
        return (1, 0)
    if name.endswith("weight") and ndim == 4:
        return (2, 3, 0, 1) if "upscaler" in name else (3, 2, 0, 1)
    return tuple(range(ndim))


def _split_axis(name: str, shape: Sequence[int], n: int) -> Optional[int]:
    """The JAX ``zero1_shardings`` rule on one leaf: its largest dimension
    that divides by ``n`` (the last such in the JAX layout on a tie), or
    None when none does, as a torch axis."""
    if not shape:
        return None
    q = jax_axes(name, len(shape))
    jax_shape = [0] * len(shape)
    for t, a in enumerate(q):
        jax_shape[a] = shape[t]
    sizes = [(dim, i) for i, dim in enumerate(jax_shape) if dim % n == 0 and dim >= n]
    if not sizes:
        return None
    _, axis = max(sizes)
    return q.index(axis)


def zero1_shardings(shapes: Mapping[str, Sequence[int]], n: int
                    ) -> Dict[str, Optional[int]]:
    """ZeRO-1: each optimizer-state leaf (the moments have their
    parameter's shape and name) split over the ``n`` data ranks along its
    largest dimension that divides by ``n``; None (replicated) when none
    does."""
    return {k: _split_axis(k, tuple(s), n) for k, s in shapes.items()}


def fsdp_shardings(shapes: Mapping[str, Sequence[int]], n: int
                   ) -> Dict[str, Optional[int]]:
    """FSDP: the same rule on the parameters (masters and EMA too)."""
    return zero1_shardings(shapes, n)


def tensor_parallel_shardings(shapes: Mapping[str, Sequence[int]], num_model: int
                              ) -> Dict[str, Optional[int]]:
    """Megatron over the ``model`` ranks, for the joint cross-view
    attention only (``attn1`` of the cross-view blocks): ``to_q`` /
    ``to_k`` / ``to_v`` split by heads (torch axis 0), ``to_out`` by its
    input features (torch axis 1), each when the size divides by
    ``num_model``; every other leaf (``to_out``'s bias too) is replicated."""
    out: Dict[str, Optional[int]] = {}
    for k, s in shapes.items():
        parts = k.split(".")
        axis = None
        if "cross_attn_blocks" in k and "attn1" in parts and len(s) == 2 \
                and parts[-1] == "weight":
            if any(p in ("to_q", "to_k", "to_v") for p in parts) and s[0] % num_model == 0:
                axis = 0
            elif "to_out" in parts and s[1] % num_model == 0:
                axis = 1
        out[k] = axis
    return out
