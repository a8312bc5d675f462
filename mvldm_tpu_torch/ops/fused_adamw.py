"""Fused AdamW on f32 masters: the accumulation, clip and update of
``training/optim.Optimizer.apply`` in the hand-written multi-tensor kernels
of ``csrc/fused_adamw.cu``, for AdamW and Adam with f32 moments on one card.

No TPU kernel is replaced: the JAX package leaves the optimizer to XLA. The
foreach chain stays the plain path (CPU, and every configuration the
kernels do not take); :meth:`Optimizer.fused_step` chooses.

* :class:`Plan` — the table of one optimizer state (each tensor's master,
  moments, accumulator and size) and the work list the kernels' blocks
  walk, put on the card once.
* :class:`Step` — one apply's view: a plan and this step's gradients,
  checked against it.
* :func:`accumulate` — acc <- acc + (g - acc) / (n + 1) (optax.MultiSteps'
  running mean), acc not read when n is 0.
* :func:`update` — the clip (g / norm * clip when !(norm < clip), the norm
  read on the device), AdamW or Adam, the master write-back and the
  accumulators' zero, one pass.
* :func:`accumulate_reference`, :func:`update_reference` — plain PyTorch,
  a tensor at a time: the kernels' arithmetic in their order with their
  f32 scalars (:class:`Hyper`). The CPU tests hold them bitwise against
  the foreach chain; the card tests hold the kernels bitwise against the
  chain and the plain versions on the card.
* :func:`takes_state`, :meth:`Step.of` — what the kernels take.

Each kernel wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import weakref
from dataclasses import dataclass
from typing import Optional, Sequence, Union

import numpy as np
import torch

from . import _build

CHUNK = 1 << 16  # elements a work item (``kChunk`` in the kernel)
_GRAD_DTYPES = (torch.float32, torch.bfloat16)

_TABLE = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_uint64),
                                                       ctypes.POINTER(ctypes.c_uint8)]
_SIGNATURES = {
    "mvldm_fused_adamw_capacity": [],
    "mvldm_fused_adamw_accumulate": _TABLE + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    "mvldm_fused_adamw_update": _TABLE + [ctypes.c_int] + [ctypes.c_float] * 10
    + [ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_float,
       ctypes.c_void_p],
}

Tensors = Sequence[torch.Tensor]


@dataclass(frozen=True)
class Hyper:
    """An update's scalars, each the f32 value the foreach chain computes
    with (held as a Python float); ``weight_decay`` 0 adds no decay,
    ``clip`` None clips nothing (compared as a double, as the host does)."""

    b1: float
    one_minus_b1: float
    b2: float
    one_minus_b2: float
    bc1: float
    bc2: float
    eps: float
    weight_decay: float
    neg_lr: float
    clip: Optional[float]


def takes_state(masters: Tensors, mu: Tensors, nu: Tensors, acc: Optional[Tensors]) -> bool:
    """Whether the kernels take a state: masters, moments and accumulators
    (None without accumulation) contiguous f32 of the masters' sizes, all on
    one CUDA device."""
    if not masters or not masters[0].is_cuda:
        return False
    device = masters[0].get_device()
    for i, p in enumerate(masters):
        for t in (p, mu[i], nu[i]) if acc is None else (p, mu[i], nu[i], acc[i]):
            if (t.dtype is not torch.float32 or not t.is_contiguous()
                    or t.get_device() != device or t.numel() != p.numel()):
                return False
    return True


def _flat(masters: Tensors, mu: Tensors, nu: Tensors, acc: Optional[Tensors]) -> list:
    return [t for ts in (masters, mu, nu, acc or ()) for t in ts]


class Plan:
    """The kernels' view of one state that :func:`takes_state` took: a table
    of 5 int64 a tensor (master, mu, nu, accumulator or 0, size) and a work
    list of (tensor, chunk of :data:`CHUNK` elements) int32 pairs, sorted by
    tensor. Both are put on the card once, at the first launch, by an
    asynchronous copy from pinned memory (no host sync), and stay there
    while the plan lives. The plan holds its tensors by weak reference:
    :meth:`holds` tells whether a state is still made of them."""

    def __init__(self, masters: Tensors, mu: Tensors, nu: Tensors, acc: Optional[Tensors]):
        self._refs = [weakref.ref(t) for t in _flat(masters, mu, nu, acc)]
        self.device = masters[0].device
        self.sizes = [p.numel() for p in masters]
        self.from_acc = acc is not None
        chunks = -(-np.asarray(self.sizes, np.int64) // CHUNK)
        # offsets[t]: tensor t's first item; a launch over tensors [t0, t1)
        # walks items [offsets[t0], offsets[t1]).
        self.offsets = np.concatenate([[0], np.cumsum(chunks)]).tolist()
        self._host = self._tables = None

    def holds(self, masters: Tensors, mu: Tensors, nu: Tensors, acc: Optional[Tensors]) -> bool:
        """Whether the plan was built on these very tensors (in this order)."""
        flat = _flat(masters, mu, nu, acc)
        return len(flat) == len(self._refs) and all(r() is t for r, t in zip(self._refs, flat))

    def tables(self):
        """(table, work list) on the card."""
        if self._tables is None:
            tensors = [r() for r in self._refs]
            n = len(self.sizes)
            table = np.zeros((n, 5), np.int64)
            for col in range(len(tensors) // n):
                table[:, col] = [t.data_ptr() for t in tensors[col * n:(col + 1) * n]]
            table[:, 4] = self.sizes
            chunks = np.diff(self.offsets)
            first = np.repeat(np.asarray(self.offsets[:-1]), chunks)
            items = np.stack([np.repeat(np.arange(n), chunks),
                              np.arange(self.offsets[-1]) - first], axis=1).astype(np.int32)
            # The pinned copies live as long as the plan, so the asynchronous
            # copies read them as built.
            self._host = (torch.from_numpy(table).pin_memory(),
                          torch.from_numpy(items).pin_memory())
            self._tables = tuple(t.to(self.device, non_blocking=True) for t in self._host)
        return self._tables


class Step:
    """One apply's view for the kernels: a plan and this step's gradients,
    contiguous f32 or bf16 of the plan's sizes on its device (in the
    plan's order)."""

    def __init__(self, plan: Plan, grads: Tensors):
        self.plan, self.grads = plan, grads

    @classmethod
    def of(cls, plan: Plan, grads: Tensors) -> Optional["Step"]:
        """The step of ``grads``, or None where the kernels do not take them."""
        device = plan.device.index
        if len(grads) != len(plan.sizes) or not all(
                g.dtype in _GRAD_DTYPES and g.is_contiguous() and g.get_device() == device
                and g.numel() == n for g, n in zip(grads, plan.sizes)):
            return None
        return cls(plan, grads)


def _lib():
    return _build.load("fused_adamw", _SIGNATURES)


def _rcp(s: float) -> float:
    """1 / s in f32, as PyTorch's CUDA ops divide by a host scalar."""
    return float(np.float32(1) / np.float32(s))


def _groups(lib, step: Step, grads: bool):
    """(item_begin, item_end, tensor_begin, n, pointers, flags) of each
    launch: with ``grads`` groups of at most the kernels' capacity of
    gradients, else one launch over every tensor."""
    plan = step.plan
    n = len(plan.sizes)
    if not grads:
        if plan.offsets[n]:
            yield 0, plan.offsets[n], 0, 0, None, None
        return
    cap = lib.mvldm_fused_adamw_capacity()
    for t0 in range(0, n, cap):
        t1 = min(t0 + cap, n)
        if plan.offsets[t0] == plan.offsets[t1]:
            continue
        group = step.grads[t0:t1]
        yield (plan.offsets[t0], plan.offsets[t1], t0, t1 - t0,
               (ctypes.c_uint64 * (t1 - t0))(*[g.data_ptr() for g in group]),
               (ctypes.c_uint8 * (t1 - t0))(*[g.dtype is torch.bfloat16 for g in group]))


def accumulate(step: Step, n: int) -> None:
    """In place on the plan's accumulators: acc <- acc + (g - acc) / (n + 1),
    ``n`` the micro-steps already accumulated (acc is zero and not read when
    ``n`` is 0: the update leaves it so)."""
    if not step.plan.from_acc:
        raise ValueError("fused_adamw.accumulate: the plan's state has no accumulators")
    lib = _lib()
    stream = _build.stream_ptr(step.plan.device)
    table, items = step.plan.tables()
    for begin, end, t0, count, ptrs, flags in _groups(lib, step, True):
        err = lib.mvldm_fused_adamw_accumulate(
            _build.ptr(table), _build.ptr(items), begin, end, t0, count, ptrs, flags,
            _rcp(n + 1), int(n == 0), stream)
        _build.check(err, "mvldm_fused_adamw_accumulate")
        accumulate.launches += 1


def update(step: Step, hyper: Hyper, norm: Union[torch.Tensor, float, None]) -> None:
    """One clip and AdamW / Adam update in place on the plan's masters and
    moments: from its accumulators, zeroed after, or, for a plan without
    them, from this step's gradients. ``norm`` is the clip's norm: a
    one-element f32 tensor on the card, which the kernel reads, or a host
    float."""
    plan = step.plan
    norm_ptr, norm_val = None, 0.0
    if isinstance(norm, torch.Tensor):
        if norm.dtype is not torch.float32 or norm.numel() != 1 or norm.device != plan.device:
            raise TypeError(f"fused_adamw.update: the norm must be one f32 value on {plan.device}")
        norm_ptr = _build.ptr(norm)
    elif norm is not None:
        norm_val = float(norm)
    if hyper.clip is not None and norm is None:
        raise ValueError("fused_adamw.update: a clip needs the norm")
    lib = _lib()
    stream = _build.stream_ptr(plan.device)
    h = hyper
    clip = 0.0 if h.clip is None else h.clip  # a c_float for the product, a c_double to compare
    table, items = plan.tables()
    for begin, end, t0, count, ptrs, flags in _groups(lib, step, not plan.from_acc):
        err = lib.mvldm_fused_adamw_update(
            _build.ptr(table), _build.ptr(items), begin, end, t0, count, ptrs, flags,
            int(plan.from_acc), h.b1, h.one_minus_b1, h.b2, h.one_minus_b2, _rcp(h.bc1),
            _rcp(h.bc2), h.eps, h.weight_decay, h.neg_lr, clip, clip, int(h.clip is not None),
            int(h.weight_decay != 0), norm_ptr, norm_val, stream)
        _build.check(err, "mvldm_fused_adamw_update")
        update.launches += 1


accumulate.launches = 0
update.launches = 0


# ------------------------------------------------------------ plain versions
# One tensor at a time, each op the foreach chain's in its order with its f32
# scalars. A division by a scalar is PyTorch's: on the card a product with the
# scalar's f32 reciprocal, which the kernels compute, on the CPU a quotient,
# which the CPU's chain computes.

def accumulate_reference(acc: Tensors, grads: Tensors, n: int) -> None:
    """:func:`accumulate`'s arithmetic, in place: acc + (g - acc) / (n + 1)
    in f32, acc taken as +0 when ``n`` is 0."""
    for a, g in zip(acc, grads):
        prev = torch.zeros_like(a) if n == 0 else a
        a.copy_(prev + (g.float() - prev) / (n + 1))


def update_reference(masters: Tensors, mu: Tensors, nu: Tensors, grads: Tensors, hyper: Hyper,
                     norm: Union[torch.Tensor, float, None],
                     acc: Optional[Tensors] = None) -> None:
    """:func:`update`'s arithmetic, in place, from ``grads`` (the
    accumulators, zeroed after, when ``acc`` is given as well). The clip is
    optax's select, g / norm * clip where !(norm < clip) (a NaN norm
    included), with the norm read on the host."""
    h = hyper
    clip = h.clip is not None and not float(norm) < h.clip
    for i, (p, m, v) in enumerate(zip(masters, mu, nu)):
        g = grads[i].float()
        if clip:
            g = g / float(norm) * h.clip
        m_new = g * h.one_minus_b1 + m * h.b1
        v_new = (g * g) * h.one_minus_b2 + v * h.b2
        u = (m_new / h.bc1) / ((v_new / h.bc2).sqrt() + h.eps)
        if h.weight_decay:
            u = u + p * h.weight_decay
        p.copy_(p + u * h.neg_lr)
        m.copy_(m_new)
        v.copy_(v_new)
        if acc is not None:
            acc[i].zero_()
