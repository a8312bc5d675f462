"""GroupNorm over channels-last feature maps, with the ResNet block's
time-embedding add and the SiLU fused: y = act(GroupNorm(x + add[:, :, None,
None])), statistics in f32, the affine map and the SiLU on the f32 value,
rounded once to the input dtype, channels-last out.

No TPU kernel is replaced: the JAX package leaves GroupNorm to XLA, which
fuses the add and the SiLU into its passes (a Pallas GroupNorm measured
slower there, ``mvldm_tpu/models/layers.py``). On the card the stock chain
reads NCHW only, so a channels-last UNet needs this kernel to stay
channels-last (``models/layers.GroupNorm`` chooses).

* :func:`group_norm_nhwc_reference` — plain PyTorch over the (N, HW, G, C/G)
  view of the NHWC tensor, with the mean and rstd (N, G) it normalised by.
* :func:`group_norm_nhwc_backward` — plain PyTorch backward from the saved
  mean and rstd: two per-group sums of the incoming gradient and one
  elementwise expression, in f32 over the same view, a slice of samples at
  a time.
* :func:`group_norm_nhwc` — the differentiable entry: CPU tensors take the
  plain version, others the kernel of ``csrc/group_norm_nhwc.cu``, which
  takes bf16 channels-last input and raises on anything else.
* :func:`takes` — whether the kernel takes an input; :func:`plan` — how it
  cuts a sample (the cluster route, or the two-pass route for a slab larger
  than a cluster's shared memory).

``group_norm_nhwc.launches`` counts the kernel's calls (one a GroupNorm,
whichever route).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

_SIGNATURES = {
    "mvldm_group_norm_nhwc": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
}

MAX_THREADS = 512  # kMaxThreads
MAX_SMEM = 232448  # kMaxSmem: 227 KB of dynamic shared memory a CTA
MAX_CLUSTER = 8  # kMaxCluster: the portable cluster size
ROUNDS = 4  # kRounds: groups a warp reduces across a cluster
STRIPE_BYTES = 32 * 1024  # the least stripe a CTA of a cluster takes
TWO_PASS_STRIPE_BYTES = 64 * 1024  # a CTA's stripe on the two-pass route
BACKWARD_ELEMENTS = 1 << 24  # elements of a slice of the plain backward


class Plan(NamedTuple):
    """``ctas`` stripes of ``pixels`` pixels a sample, ``threads`` a CTA
    (c / 8 vector columns x pixel rows, a multiple of 32); ``two_pass`` for
    a slab larger than a cluster of :data:`MAX_CLUSTER` CTAs holds."""

    two_pass: bool
    ctas: int
    pixels: int
    threads: int


def _spans_two_groups(c: int, groups: int) -> bool:
    """Whether every aligned run of 8 channels lies in at most two groups."""
    cg = c // groups
    return all((8 * v + 7) // cg - 8 * v // cg <= 1 for v in range(c // 8))


@functools.lru_cache(maxsize=None)
def _takes_channels(c: int, groups: int) -> bool:
    """The kernel's conditions on the channels, cached: C a multiple of 8
    and of ``groups``, every 8 channels in at most two groups, a CTA of
    whole warps, at most :data:`ROUNDS` groups a warp."""
    return (c % 8 == 0 and c % groups == 0 and groups <= ROUNDS * (_threads(c) // 32)
            and _spans_two_groups(c, groups))


def _threads(c: int) -> int:
    """c / 8 vector columns x the most pixel rows that keep a CTA within
    :data:`MAX_THREADS` threads and a multiple of 32; 0 if none does."""
    vc = c // 8
    return next((vc * r for r in range(MAX_THREADS // vc, 0, -1) if vc * r % 32 == 0), 0)


def takes(x: torch.Tensor, groups: int) -> bool:
    """Whether the kernel takes ``x``: 4-D bf16 channels-last off the CPU,
    C a multiple of 8 and of ``groups``, every 8 channels in at most two
    groups, a CTA of whole warps, at most :data:`ROUNDS` groups a warp."""
    if x.dim() != 4 or x.dtype != torch.bfloat16 or x.device.type == "cpu":
        return False
    return (x.is_contiguous(memory_format=torch.channels_last)
            and _takes_channels(x.shape[1], groups))


def _smem(pixels: int, c: int, threads: int, groups: int) -> int:
    """The cluster route's shared memory: the stripe, 4 f32 sums a thread,
    7 f32 a group, the weight and the bias in f32."""
    return pixels * c * 2 + threads * 16 + 28 * groups + 8 * c


@functools.lru_cache(maxsize=None)
def plan(hw: int, c: int, groups: int) -> Plan:
    """The kernel's cut of a sample of ``hw`` pixels x ``c`` channels; it
    depends on the sample's shape alone, so a sample gives the same bits in
    any batch. A cluster takes stripes of at least :data:`STRIPE_BYTES`, up
    to :data:`MAX_CLUSTER` of them; a slab they do not hold takes the
    two-pass route, in stripes of :data:`TWO_PASS_STRIPE_BYTES`."""
    threads = _threads(c)
    row = 2 * c
    ctas = min(MAX_CLUSTER, hw, max(1, -(-hw * row // STRIPE_BYTES)))
    pixels = -(-hw // ctas)
    if _smem(pixels, c, threads, groups) <= MAX_SMEM:
        return Plan(False, -(-hw // pixels), pixels, threads)
    return two_pass_plan(hw, c)


def two_pass_plan(hw: int, c: int) -> Plan:
    """The two-pass route's cut: stripes of :data:`TWO_PASS_STRIPE_BYTES`."""
    pixels = min(hw, max(1, TWO_PASS_STRIPE_BYTES // (2 * c)))
    return Plan(True, -(-hw // pixels), pixels, _threads(c))


def _groups_view(t: torch.Tensor, groups: int) -> torch.Tensor:
    """(N, C, H, W) channels-last -> its (N, HW, G, C/G) view."""
    n, c, h, w = t.shape
    return t.permute(0, 2, 3, 1).reshape(n, h * w, groups, c // groups)


def _from_groups_view(v: torch.Tensor, shape) -> torch.Tensor:
    n, c, h, w = shape
    return v.reshape(n, h, w, c).permute(0, 3, 1, 2)


def _normalised(x, add, mean, rstd, groups: int) -> torch.Tensor:
    """(x + add - mean) * rstd in a new f32 tensor over the (N, HW, G, C/G)
    view."""
    v = _groups_view(x, groups).to(torch.float32, copy=True)
    if add is not None:
        v.add_(add.float().reshape(add.shape[0], 1, groups, -1))
    return v.sub_(mean[:, None, :, None]).mul_(rstd[:, None, :, None])


def group_norm_nhwc_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                              groups: int, eps: float, silu: bool,
                              add: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, mean, rstd): y = act(GroupNorm(x + add[:, :, None, None])) in f32,
    rounded once to x's dtype, channels-last; mean and rstd (N, G) f32."""
    v = _groups_view(x, groups).float()
    if add is not None:
        v = v + add.float().reshape(add.shape[0], 1, groups, -1)
    mean = v.mean(dim=(1, 3))
    var = (v - mean[:, None, :, None]).square().mean(dim=(1, 3))
    rstd = torch.rsqrt(var + eps)
    z = ((v - mean[:, None, :, None]) * rstd[:, None, :, None]
         * weight.float().reshape(groups, -1) + bias.float().reshape(groups, -1))
    if silu:
        z = F.silu(z)
    return _from_groups_view(z.to(x.dtype), x.shape), mean, rstd


def group_norm_nhwc_backward(g: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                             bias: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                             groups: int, silu: bool, add: Optional[torch.Tensor] = None):
    """(dx, dweight, dbias, dadd) of :func:`group_norm_nhwc_reference` at
    its saved mean and rstd, in f32 over the (N, HW, G, C/G) view (dx
    channels-last, each gradient in its input's dtype; dadd None without
    an add). With xhat the normalised input, dz the gradient at the affine
    output (through the SiLU) and, per sample and channel, S1 = sum_p dz and
    S2 = sum_p dz xhat:
    dbias = sum_n S1, dweight = sum_n S2, and
    dx = rstd (w dz - m1 - xhat m2) with m1, m2 the group means of w S1 and
    w S2 over its C/G x HW values. A slice of :data:`BACKWARD_ELEMENTS`
    elements' samples at a time bounds the f32 temporaries."""
    n, c = x.shape[:2]
    g = g.contiguous(memory_format=torch.channels_last)
    w = weight.float().reshape(groups, -1)
    b = bias.float().reshape(groups, -1)
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    dw = torch.zeros_like(w)
    db = torch.zeros_like(w)
    dadd = None if add is None else torch.empty_like(add)
    step = max(1, BACKWARD_ELEMENTS // (x[0].numel()))
    for s in range(0, n, step):
        sl = slice(s, s + step)
        r = rstd[sl, None, :, None]
        xhat = _normalised(x[sl], None if add is None else add[sl], mean[sl], rstd[sl], groups)
        dz = _groups_view(g[sl], groups).to(torch.float32, copy=True)
        if silu:  # silu'(z) = sig (1 + z (1 - sig)), z = xhat w + b
            z = torch.addcmul(b, xhat, w)
            sig = torch.sigmoid(z)
            z.sub_(z * sig).add_(1).mul_(sig)
            dz.mul_(z)
            del z, sig
        s1 = dz.sum(dim=1)  # (n, G, C/G)
        s2 = (dz * xhat).sum(dim=1)
        db += s1.sum(dim=0)
        dw += s2.sum(dim=0)
        m = xhat.shape[1] * xhat.shape[3]
        m1 = (s1 * w).sum(dim=2, keepdim=True) / m  # (n, G, 1)
        m2 = (s2 * w).sum(dim=2, keepdim=True) / m
        dz.mul_(w).sub_(m1[:, None]).sub_(xhat.mul_(m2[:, None])).mul_(r)
        del xhat
        _groups_view(dx[sl], groups).copy_(dz)
        if add is not None:
            dadd[sl] = dz.sum(dim=1).reshape(dz.shape[0], c)
    return dx, dw.reshape(c).to(weight.dtype), db.reshape(c).to(bias.dtype), dadd


def _check(x, weight, bias, add, groups: int) -> None:
    if not takes(x, groups) or not x.is_cuda:
        raise ValueError(
            f"group_norm_nhwc: the kernel takes 4-D bf16 channels-last CUDA input with C a "
            f"multiple of 8 and of the groups, 8 channels in at most two groups (got "
            f"{tuple(x.shape)} {x.dtype} on {x.device}, {groups} groups)")
    if x.data_ptr() % 16:
        raise ValueError("group_norm_nhwc: x must be 16-byte aligned")
    n, c = x.shape[:2]
    device = x.get_device()
    for name, t, numel in (("weight", weight, c), ("bias", bias, c), ("add", add, n * c)):
        if t is not None and (t.dtype is not torch.bfloat16 or t.get_device() != device
                              or t.numel() != numel or not t.is_contiguous()):
            raise ValueError(f"group_norm_nhwc: {name} must be {numel} contiguous bf16 values "
                             f"on {x.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    if add is not None and add.shape[0] != n:
        raise ValueError(f"group_norm_nhwc: add must be ({n}, {c}), got {tuple(add.shape)}")


def _group_norm_cuda(x, weight, bias, groups: int, eps: float, silu: bool, add=None,
                     stats: bool = True, pl: Optional[Plan] = None):
    """The kernel on the current stream: (y, mean, rstd), or (y, None,
    None) without ``stats`` (the cluster route then writes none). ``pl``
    replaces the shape's :func:`plan`, to time one route against the
    other."""
    _check(x, weight, bias, add, groups)
    n, c, h, w = x.shape
    pl = pl or plan(h * w, c, groups)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    partial = moments = None
    if stats or pl.two_pass:
        moments = torch.empty((2, n, groups), dtype=torch.float32, device=x.device)
    if pl.two_pass:
        partial = torch.empty((n, pl.ctas, groups, 2), dtype=torch.float32, device=x.device)
    m = 0 if moments is None else moments.data_ptr()
    lib = _build.load("group_norm_nhwc", _SIGNATURES)
    _build.check(lib.mvldm_group_norm_nhwc(
        x.data_ptr(), None if add is None else add.data_ptr(), weight.data_ptr(),
        bias.data_ptr(), y.data_ptr(), m or None, m + 4 * n * groups if m else None,
        None if partial is None else partial.data_ptr(), n, h * w, c, groups, pl.ctas,
        pl.pixels, pl.threads, float(eps), int(silu), _build.stream_ptr(x.device)),
        "mvldm_group_norm_nhwc")
    group_norm_nhwc.launches += 1
    if not stats:
        return y, None, None
    return y, moments[0], moments[1]


class _GroupNormNHWC(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, add, groups, eps, silu):
        fn = group_norm_nhwc_reference if x.device.type == "cpu" else _group_norm_cuda
        y, mean, rstd = fn(x, weight, bias, groups, eps, silu, add)
        ctx.cfg = (groups, silu)
        ctx.save_for_backward(x, weight, bias, add, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, bias, add, mean, rstd = ctx.saved_tensors
        groups, silu = ctx.cfg
        dx, dw, db, dadd = group_norm_nhwc_backward(g, x, weight, bias, mean, rstd, groups,
                                                    silu, add)
        return dx, dw, db, dadd, None, None, None


def group_norm_nhwc(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
                    eps: float, silu: bool, add: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """act(GroupNorm(x + add[:, :, None, None])), channels-last,
    differentiable. x: (N, C, H, W); add: (N, C) or None."""
    args = (x, weight, bias, add)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in args):
        return _GroupNormNHWC.apply(*args, groups, eps, silu)
    if x.device.type == "cpu":
        return group_norm_nhwc_reference(x, weight, bias, groups, eps, silu, add)[0]
    return _group_norm_cuda(x, weight, bias, groups, eps, silu, add, stats=False)[0]


group_norm_nhwc.launches = 0
