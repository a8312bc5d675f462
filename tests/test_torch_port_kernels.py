"""The port's CUDA kernels against their plain versions, on the card.

Each kernel runs on bf16 inputs and is held against its plain PyTorch
version computed in f32 on the same bf16 inputs. These tests need an
NVIDIA Hopper GPU and ``nvcc``; without a card they skip. On the GPU
machine: ``python -m pytest tests/test_torch_port_kernels.py -m cuda``.

Tolerance: a bf16 output cannot come closer to the f32 value than half a
bf16 step of itself, so that step is taken off each element's error. What
is left, the kernel's own error (it rounds P, dS, q, k, v, LN(x) and the
GEGLU activation to bf16 where the f32 plain version does not), must stay
within 5 % of the rms of what the kernel computes: the output for
attention and its gradients, and ``out - x`` for the residual blocks. The
f32 outputs (lse, dbias) have no half step to take off; the lse is also
held within 2e-2 absolute (the bf16-rounded P the forward normalises by
moves it by at most ~2^-8). The microbenchmark's f32 kernels get f32
checks: the f32 matmul within relative L2 1e-5 of the product in float64
(f32 accumulation over k <= 1024), exp within 1e-6 relative of exp in
float64 (``expf`` is within 2 ulp). The f32-dot flash is also held within
``bench_attn_micro.F32_FLASH_REL_LIMIT`` (1e-3) of the rms, the precision
its P V on both halves of p exists for (p in bf16 alone reads ~1e-2). The
f32 route's kernels (``ops/f32_route.py``) are held within relative L2
1e-5 of the plain versions in f32 (the forward also where one key is left
unmasked: that key's value to 1e-6, p = 1 split exactly into hi), and an
f32 model through them within 3e-4 of the CPU.
"""

import math

import pytest
import torch

from mvldm_tpu_torch.ops.attention import (
    attention,
    attention_bwd_reference,
    attention_reference,
    attention_reference_lse,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
)
from mvldm_tpu_torch.ops.fused_attn import (
    fused_ln_self_attention,
    fused_ln_self_attention_reference,
)
from mvldm_tpu_torch.ops import f32_route
from mvldm_tpu_torch.ops.f32_route import (
    attention_rows_f32,
    flash_attention_bwd_f32,
    flash_attention_f32,
    fused_ln_geglu_ff_f32,
    fused_ln_self_attention_f32,
    gemm_f32,
    gemm_f32_reference,
)
from mvldm_tpu_torch.ops.fused_ff import fused_ln_geglu_ff, fused_ln_geglu_ff_reference
from mvldm_tpu_torch.tools import bench_attn_micro as micro
from mvldm_tpu_torch.tools.measure import error_record

pytestmark = pytest.mark.cuda
REL_LIMIT = 0.05


def assert_kernel_close(out, ref, residual=None):
    o = out.float()
    _, e = torch.frexp(o)
    half_step = torch.where(o == 0, torch.zeros_like(o),
                            torch.ldexp(torch.ones_like(o), e - 9))
    if out.dtype == torch.float32:
        half_step = torch.zeros_like(o)
    own = ((o - ref).abs() - half_step).clamp_min(0).max().item()
    delta = ref if residual is None else ref - residual.float()
    rms = delta.square().mean().sqrt().item()
    assert torch.isfinite(o).all()
    assert own <= REL_LIMIT * rms, (own, rms)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, *shape, scale=1.0, device):
    return (torch.randn(shape, generator=gen) * scale).to(device, torch.bfloat16)


@pytest.mark.parametrize("b,h,lq,lk,d,with_bias", [
    (1, 2, 100, 300, 40, True),
    (2, 3, 64, 64, 64, False),
    (1, 2, 77, 200, 80, True),
    (1, 2, 64, 190, 160, False),
    (1, 2, 90, 150, 128, True),
    (1, 1, 130, 130, 512, False),
    (1, 5, 4096, 77, 64, False),
])
def test_flash_attention(cuda, b, h, lq, lk, d, with_bias):
    gen = torch.Generator().manual_seed(d + lq)
    q, k, v = (_randn(gen, b, h, n, d, device=cuda) for n in (lq, lk, lk))
    bias = None
    if with_bias:
        bias = torch.where(torch.rand((b, lk), generator=gen) < 0.3, -1e30, 0.0)
        bias[:, 0] = 0.0
        bias = bias.to(cuda)
    before = flash_attention.launches
    out = flash_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = attention_reference(q.float(), k.float(), v.float(), bias)
    assert_kernel_close(out, ref)


def test_flash_attention_refuses_float32(cuda):
    q = torch.randn(1, 1, 16, 32, device=cuda)
    with pytest.raises(TypeError):
        flash_attention(q, q, q)


def _attn_weights(gen, c, hd, device):
    lin = [_randn(gen, hd, c, scale=c ** -0.5, device=device) for _ in range(3)]
    wo = _randn(gen, c, hd, scale=hd ** -0.5, device=device)
    # JAX layouts (C, H*D) / (H*D, C), as transposes of torch Linear weights.
    return [w.t() for w in lin] + [wo.t()]


@pytest.mark.parametrize("n,l,c,heads,d", [(2, 100, 64, 2, 32), (2, 256, 320, 5, 64),
                                           (2, 64, 320, 8, 40)])
def test_fused_ln_self_attention(cuda, n, l, c, heads, d):
    gen = torch.Generator().manual_seed(c + l)
    x = _randn(gen, n, l, c, device=cuda)
    g = (torch.rand(c, generator=gen) + 0.5).to(cuda)
    b = (torch.randn(c, generator=gen) * 0.1).to(cuda)
    ws = _attn_weights(gen, c, heads * d, cuda)
    bo = (torch.randn(c, generator=gen) * 0.1).to(cuda)
    before = fused_ln_self_attention.launches
    out = fused_ln_self_attention(x, g, b, *ws, bo, heads, d)
    torch.cuda.synchronize()
    assert fused_ln_self_attention.launches == before + 1
    ref = fused_ln_self_attention_reference(x.float(), g, b, *(w.float() for w in ws),
                                            bo, heads, d)
    assert_kernel_close(out, ref, residual=x)


@pytest.mark.parametrize("n,l,c", [(2, 100, 64), (1, 256, 320)])
def test_fused_ln_geglu_ff(cuda, n, l, c):
    gen = torch.Generator().manual_seed(c + l)
    x = _randn(gen, n, l, c, device=cuda)
    g = (torch.rand(c, generator=gen) + 0.5).to(cuda)
    b = (torch.randn(c, generator=gen) * 0.1).to(cuda)
    w1 = _randn(gen, 8 * c, c, scale=c ** -0.5, device=cuda).t()
    b1 = (torch.randn(8 * c, generator=gen) * 0.1).to(cuda)
    w2 = _randn(gen, c, 4 * c, scale=(4 * c) ** -0.5, device=cuda).t()
    b2 = (torch.randn(c, generator=gen) * 0.1).to(cuda)
    before = fused_ln_geglu_ff.launches
    out = fused_ln_geglu_ff(x, g, b, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert fused_ln_geglu_ff.launches == before + 1
    ref = fused_ln_geglu_ff_reference(x.float(), g, b, w1.float(), b1, w2.float(), b2)
    assert_kernel_close(out, ref, residual=x)


BWD_SHAPES = [
    # (b, h, lq, lk, d, with_bias): ragged lengths at every training head dim
    (2, 2, 100, 300, 40, True),
    (1, 3, 64, 64, 64, False),
    (2, 2, 77, 200, 80, True),
    (1, 2, 130, 190, 160, True),
    (2, 1, 16, 16, 160, False),
    # the kernels' tile and ring edges: blocks of 128 rows, streamed tiles of
    # 64 (32 queries at D = 160) through a ring of 3 stages. Lk one past a
    # block, Lq over more tiles than the ring has stages, Lq != Lk, and one
    # case for each instance (D rounded up to 32, 40, 64, 80 or 160).
    (1, 2, 100, 129, 40, True),
    (1, 2, 323, 257, 64, False),
    (1, 2, 323, 150, 80, True),
    (1, 2, 200, 129, 160, True),
    (1, 3, 90, 129, 32, False),
    (1, 2, 70, 70, 48, True),
    # the joint 32x32 training attention at batch 1
    (1, 8, 5120, 5120, 40, True),
]


def _bwd_inputs(cuda, b, h, lq, lk, d, with_bias):
    gen = torch.Generator().manual_seed(d + lq + lk)
    q, k, v = (_randn(gen, b, h, n, d, device=cuda) for n in (lq, lk, lk))
    g = _randn(gen, b, h, lq, d, device=cuda)
    bias = None
    if with_bias:
        bias = torch.where(torch.rand((b, lk), generator=gen) < 0.3, -1e30, 0.0)
        bias[:, 0] = 0.0
        bias = bias.to(cuda)
    return q, k, v, g, bias


@pytest.mark.parametrize("b,h,lq,lk,d,with_bias", BWD_SHAPES)
def test_flash_attention_lse(cuda, b, h, lq, lk, d, with_bias):
    q, k, v, _, bias = _bwd_inputs(cuda, b, h, lq, lk, d, with_bias)
    out, lse = flash_attention(q, k, v, bias, return_lse=True)
    torch.cuda.synchronize()
    ref_out, ref_lse = attention_reference_lse(q.float(), k.float(), v.float(), bias)
    assert_kernel_close(out, ref_out)
    assert_kernel_close(lse, ref_lse)
    assert (lse - ref_lse).abs().max().item() <= 2e-2


def test_flash_attention_lse_refuses_head_dim_512(cuda):
    q = torch.zeros(1, 1, 16, 512, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attention(q, q, q, return_lse=True)


@pytest.mark.parametrize("b,h,lq,lk,d,with_bias", BWD_SHAPES)
def test_flash_attention_bwd_kernels(cuda, b, h, lq, lk, d, with_bias):
    q, k, v, g, bias = _bwd_inputs(cuda, b, h, lq, lk, d, with_bias)
    out, lse = flash_attention(q, k, v, bias, return_lse=True)
    before = (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches)
    dq, delta = flash_attention_bwd_dq(q, k, v, bias, out, lse, g)
    dk, dv, dbias = flash_attention_bwd_dkv(q, k, v, bias, lse, delta, g)
    torch.cuda.synchronize()
    assert (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    torch.testing.assert_close(delta, (out.float() * g.float()).sum(-1),
                               atol=1e-3, rtol=1e-3)
    ref = attention_bwd_reference(q.float(), k.float(), v.float(), bias, g.float())
    for got, want in zip((dq, dk, dv), ref[:3]):
        assert_kernel_close(got, want)
    if with_bias:
        assert_kernel_close(dbias.sum(1), ref[3])
    else:
        assert dbias is None


def test_attention_autograd_uses_bwd_kernels(cuda):
    q, k, v, g, bias = _bwd_inputs(cuda, 2, 2, 70, 70, 64, True)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    before = (flash_attention.launches, flash_attention_bwd_dq.launches,
              flash_attention_bwd_dkv.launches)
    out = attention(q, k, v, bias)
    out.backward(g)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_bwd_dq.launches,
            flash_attention_bwd_dkv.launches) == tuple(n + 1 for n in before)
    want = flash_attention_bwd(q.detach(), k.detach(), v.detach(), bias,
                               out.detach(), flash_attention(
                                   q.detach(), k.detach(), v.detach(), bias,
                                   return_lse=True)[1], g)
    for t, w in zip((q, k, v), want[:3]):
        torch.testing.assert_close(t.grad, w, atol=0, rtol=0)


def test_flash_attention_bwd_is_deterministic(cuda):
    """Two backward calls on the same inputs agree bit for bit: no atomics,
    a fixed order of every sum."""
    q, k, v, g, bias = _bwd_inputs(cuda, 2, 2, 323, 257, 40, True)
    out, lse = flash_attention(q, k, v, bias, return_lse=True)
    first = flash_attention_bwd(q, k, v, bias, out, lse, g)
    second = flash_attention_bwd(q, k, v, bias, out, lse, g)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# ------------------------------------------- attention microbenchmark kernels

@pytest.mark.parametrize("m,n,k", [(256, 128, 128), (200, 72, 40), (4096, 1024, 1024)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_micro_matmul(cuda, m, n, k, dtype):
    gen = torch.Generator().manual_seed(m + n + k)
    a = torch.randn((m, k), generator=gen).to(cuda, dtype)
    b = torch.randn((k, n), generator=gen).to(cuda, dtype)
    before = micro.matmul.launches
    out = micro.matmul(a, b)
    torch.cuda.synchronize()
    assert micro.matmul.launches == before + 1
    assert out.dtype == dtype and out.shape == (m, n)
    if dtype == torch.float32:
        ref = a.double() @ b.double()
        assert (torch.linalg.norm(out.double() - ref) / torch.linalg.norm(ref)).item() <= 1e-5
    else:
        assert_kernel_close(out, micro.matmul_reference(a.float(), b.float()))


# The probe's tile; n % 4 != 0; n < 4 (only the tail); past one wave of
# blocks (132 SMs x 8 blocks x 256 threads x 4 float4) with a tail of 3.
@pytest.mark.parametrize("shape", [(1024, 1024), (37, 5), (1,), (3,), (4097, 4099)])
def test_micro_exp(cuda, shape):
    x = torch.randn(shape, generator=torch.Generator().manual_seed(0)).to(cuda)
    before = micro.exp.launches
    out = micro.exp(x)
    torch.cuda.synchronize()
    assert micro.exp.launches == before + 1
    ref = torch.exp(x.double())
    assert ((out.double() - ref).abs() / ref).max().item() <= 1e-6


def _micro_qkv(cuda, b, h, lq, lk, d):
    gen = torch.Generator().manual_seed(d + lq + lk)
    return tuple(_randn(gen, b, h, n, d, device=cuda) for n in (lq, lk, lk))


# (lq, lk): aligned, ragged (not a multiple of the 64-row tiles), and more
# keys than queries.
MICRO_LENGTHS = [(256, 256), (200, 200), (100, 300)]


@pytest.mark.parametrize("lq,lk", MICRO_LENGTHS)
@pytest.mark.parametrize("d", [40, 80, 128, 160])
@pytest.mark.parametrize("dot_dtype", [torch.bfloat16, torch.float32])
def test_micro_flash(cuda, lq, lk, d, dot_dtype):
    q, k, v = _micro_qkv(cuda, 2, 2, lq, lk, d)
    scale = 1.0 / math.sqrt(d)
    before = micro.flash.launches
    out = micro.flash(q, k, v, scale, dot_dtype=dot_dtype)
    torch.cuda.synchronize()
    assert micro.flash.launches == before + 1
    assert_kernel_close(out, micro.flash_reference(q.float(), k.float(), v.float(), scale,
                                                   dot_dtype))


@pytest.mark.parametrize("lq,lk", MICRO_LENGTHS)
@pytest.mark.parametrize("d", [40, 80])
@pytest.mark.parametrize("do_max", [True, False, "none"])
def test_micro_fullk(cuda, lq, lk, d, do_max):
    q, k, v = _micro_qkv(cuda, 2, 2, lq, lk, d)
    scale = 1.0 / math.sqrt(d)
    before = micro.fullk.launches
    out = micro.fullk(q, k, v, scale, do_max=do_max)
    torch.cuda.synchronize()
    assert micro.fullk.launches == before + 1
    assert_kernel_close(out, micro.fullk_reference(q.float(), k.float(), v.float(), scale,
                                                   do_max))


def test_micro_attention_refuses_unserved_head_dims(cuda):
    q = torch.zeros(1, 1, 64, 128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        micro.fullk(q, q, q, 0.1)
    q = torch.zeros(1, 1, 64, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        micro.flash(q, q, q, 0.1)


# ------------------------------------- the wgmma GEMM tile and flash forward

@pytest.mark.parametrize("m,n,k", [
    (1, 8, 8),          # K = 8: one zero-filled k step
    (130, 136, 8),      # M, N one past a tile
    (257, 264, 200),    # K not a multiple of the 64-deep ring stage
    (129, 1000, 328),   # more k steps than ring stages, ragged N
    (300, 72, 1032),
    (3000, 1224, 200),  # 256-row blocks (enough of them to fill the card), ragged
])
def test_gemm_tile_edges(cuda, m, n, k):
    """The probe's plain product (A streamed, B read MN-major as (K, N))
    at ragged M, N and K, in 128-row blocks and, where they fill the card,
    256-row blocks whose output leaves through shared memory."""
    gen = torch.Generator().manual_seed(m + n + k)
    a = torch.randn((m, k), generator=gen).to(cuda, torch.bfloat16)
    b = torch.randn((k, n), generator=gen).to(cuda, torch.bfloat16)
    out = micro.matmul(a, b)
    torch.cuda.synchronize()
    assert_kernel_close(out, micro.matmul_reference(a.float(), b.float()))


def _ff_inputs(gen, n, l, c, mean, device):
    x = (torch.randn((n, l, c), generator=gen) + mean).to(device, torch.bfloat16)
    g = (torch.rand(c, generator=gen) + 0.5).to(device)
    b = (torch.randn(c, generator=gen) * 0.1).to(device)
    w1 = _randn(gen, 8 * c, c, scale=c ** -0.5, device=device).t()
    b1 = (torch.randn(8 * c, generator=gen) * 0.1).to(device)
    w2 = _randn(gen, c, 4 * c, scale=(4 * c) ** -0.5, device=device).t()
    b2 = (torch.randn(c, generator=gen) * 0.1).to(device)
    return x, g, b, w1, b1, w2, b2


@pytest.mark.parametrize("n,l,c,mean", [
    (1, 100, 72, 0.0),     # K = 72 (a ragged second 64-deep stage), N = 288, 72
    (2, 129, 320, 30.0),   # LN prologue at C = 320 with a large row mean
    (1, 200, 640, -30.0),  # C = 640: the largest resident LN(x) block
    (3, 64, 8, 0.0),       # C = 8
])
def test_fused_ff_gemm_edges(cuda, n, l, c, mean):
    gen = torch.Generator().manual_seed(c + l)
    args = _ff_inputs(gen, n, l, c, mean, cuda)
    out = fused_ln_geglu_ff(*args)
    torch.cuda.synchronize()
    x, g, b, w1, b1, w2, b2 = args
    ref = fused_ln_geglu_ff_reference(x.float(), g, b, w1.float(), b1, w2.float(), b2)
    assert_kernel_close(out, ref, residual=x)


@pytest.mark.parametrize("n,l,c,heads,d,mean", [
    (1, 100, 320, 8, 40, 0.0),    # the kAHeads gather / kEpiQkv scatter at D = 40
    (2, 130, 640, 10, 64, 30.0),  # D = 64, C = 640, large row mean
    (1, 77, 640, 8, 80, 0.0),     # D = 80, ragged L
])
def test_fused_attn_gemm_edges(cuda, n, l, c, heads, d, mean):
    gen = torch.Generator().manual_seed(c + l + d)
    x = (torch.randn((n, l, c), generator=gen) + mean).to(cuda, torch.bfloat16)
    g = (torch.rand(c, generator=gen) + 0.5).to(cuda)
    b = (torch.randn(c, generator=gen) * 0.1).to(cuda)
    ws = _attn_weights(gen, c, heads * d, cuda)
    bo = (torch.randn(c, generator=gen) * 0.1).to(cuda)
    out = fused_ln_self_attention(x, g, b, *ws, bo, heads, d)
    torch.cuda.synchronize()
    ref = fused_ln_self_attention_reference(x.float(), g, b, *(w.float() for w in ws),
                                            bo, heads, d)
    assert_kernel_close(out, ref, residual=x)


@pytest.mark.parametrize("n,l,c,heads,d", [(1, 100, 320, 8, 40), (2, 130, 640, 10, 64),
                                           (1, 77, 640, 8, 80)])
def test_gemm_launches_alone(cuda, n, l, c, heads, d):
    """Each GEMM entry on its own against its plain version: LN + QKV
    (scatter to heads), the head-merging output projection, LN + W1 with
    GEGLU (h and gate rows stacked in one B tile) and W2 with the residual
    epilogue, as kernel_compare and chip_smoke.py time them."""
    from mvldm_tpu_torch.ops import _build
    from mvldm_tpu_torch.tools import kernel_compare as kc

    gen = torch.Generator("cuda").manual_seed(c + l)
    calls = kc.attn_block_gemms("t", *kc.attn_block_inputs(gen, n, l, c, heads, d), heads, d, gen)
    calls += kc.ff_block_gemms("t", *kc.ff_block_inputs(gen, n, l, c), gen)
    for call in calls:
        call.run(_build.load(call.source, kc.SIGNATURES[call.source]))
        torch.cuda.synchronize()
        assert kc.gemm_error(call) <= REL_LIMIT, call.entry


def test_fused_blocks_refuse_wide_channels(cuda):
    gen = torch.Generator().manual_seed(0)
    args = _ff_inputs(gen, 1, 16, 648, 0.0, cuda)
    with pytest.raises(ValueError, match="C <= 640"):
        fused_ln_geglu_ff(*args)


FWD_EDGES = [
    # (b, h, lq, lk, d, bias)
    (1, 2, 1, 1, 40, False),         # L = 1
    (2, 3, 16, 16, 64, True),        # L = 16: one key tile, one warpgroup
    (1, 2, 16, 300, 160, True),      # Lq != Lk
    (1, 2, 300, 16, 80, False),
    (1, 2, 1000, 1000, 40, True),    # ragged L, one warpgroup a block
    (2, 66, 200, 200, 64, True),     # two warpgroups a block, ragged L
    (1, 8, 5120, 5120, 40, True),    # the joint 32x32 length
    (1, 2, 130, 70, 24, False),      # D rounded up to 32
    (1, 2, 70, 130, 48, True),       # D = 48 on the 64-wide instance
    (1, 2, 90, 150, 128, True),
    (2, 1, 1000, 1000, 512, True),   # the VAE head, ragged L
]


@pytest.mark.parametrize("b,h,lq,lk,d,with_bias", FWD_EDGES)
def test_flash_forward_edges(cuda, b, h, lq, lk, d, with_bias):
    gen = torch.Generator().manual_seed(d + lq + 7 * lk)
    q, k, v = (_randn(gen, b, h, n, d, device=cuda) for n in (lq, lk, lk))
    bias = None
    if with_bias:
        bias = torch.where(torch.rand((b, lk), generator=gen) < 0.3, -1e30, 0.0)
        bias[:, 0] = 0.0
        bias = bias.to(cuda)
    if d <= 160:
        out, lse = flash_attention(q, k, v, bias, return_lse=True)
        torch.cuda.synchronize()
        ref, ref_lse = attention_reference_lse(q.float(), k.float(), v.float(), bias)
        assert_kernel_close(lse, ref_lse)
        assert (lse - ref_lse).abs().max().item() <= 2e-2
    else:
        out = flash_attention(q, k, v, bias)
        torch.cuda.synchronize()
        ref = attention_reference(q.float(), k.float(), v.float(), bias)
    assert_kernel_close(out, ref)


@pytest.mark.parametrize("d", [40, 160, 512])
def test_flash_forward_all_keys_masked_but_one(cuda, d):
    """A row whose bias masks every key but one returns that key's value."""
    gen = torch.Generator().manual_seed(d)
    b, h, lq, lk = 2, 2, 70, 300
    q, k, v = (_randn(gen, b, h, n, d, device=cuda) for n in (lq, lk, lk))
    bias = torch.zeros((b, lk))
    bias[1] = -1e30
    bias[1, 217] = 0.0
    bias = bias.to(cuda)
    out = flash_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert torch.equal(out[1], v[1, :, 217:218].expand(h, lq, d))
    assert_kernel_close(out, attention_reference(q.float(), k.float(), v.float(), bias))


def test_wgmma_kernels_are_deterministic(cuda):
    """The forward (both bodies), the GEMM tile and the fused blocks agree
    bit for bit across calls: no atomics, a fixed order of every sum."""
    gen = torch.Generator().manual_seed(5)
    for b, h, l, d in ((2, 66, 200, 64), (1, 2, 300, 40), (1, 1, 200, 512)):
        q, k, v = (_randn(gen, b, h, l, d, device=cuda) for _ in range(3))
        assert torch.equal(flash_attention(q, k, v), flash_attention(q, k, v))
    a = _randn(gen, 300, 264, device=cuda)
    w = _randn(gen, 264, 136, device=cuda)
    assert torch.equal(micro.matmul(a, w), micro.matmul(a, w))
    args = _ff_inputs(gen, 2, 100, 320, 0.0, cuda)
    assert torch.equal(fused_ln_geglu_ff(*args), fused_ln_geglu_ff(*args))
    torch.cuda.synchronize()


# --------------------------- the microbenchmark's attention probes on wgmma

MICRO_EDGES = [
    # (b, h, lq, lk): L = 1 and L = 16 (one ragged key tile, the second
    # warpgroup of the block idle); ragged L = 1000; Lq != Lk both ways;
    # more keys than the ring has stages
    (1, 2, 1, 1),
    (2, 3, 16, 16),
    (1, 2, 1000, 1000),
    (1, 2, 16, 300),
    (2, 2, 300, 70),
    (1, 70, 130, 600),
]


@pytest.mark.parametrize("b,h,lq,lk", MICRO_EDGES)
@pytest.mark.parametrize("d", [40, 48, 72, 80, 128, 160])
def test_micro_flash_f32_edges(cuda, b, h, lq, lk, d):
    """The f32-dot flash body at every instance (D = 40 with the ones
    column of V, 48, 80 with D = 72 inside it, 128, 160) against the plain
    version with the unrounded p: within the 5 % check, and within
    F32_FLASH_REL_LIMIT, the precision that P V on both halves of p is
    for."""
    q, k, v = (_randn(torch.Generator().manual_seed(d + lq + 3 * lk + i), b, h, n, d,
                      device=cuda) for i, n in enumerate((lq, lk, lk)))
    scale = 1.0 / math.sqrt(d)
    out = micro.flash(q, k, v, scale)
    torch.cuda.synchronize()
    ref = micro.flash_reference(q.float(), k.float(), v.float(), scale)
    assert_kernel_close(out, ref)
    assert error_record(out, ref)["err_over_rms"] <= micro.F32_FLASH_REL_LIMIT


@pytest.mark.parametrize("b,h,lq,lk", MICRO_EDGES)
@pytest.mark.parametrize("d", [40, 48, 72, 80])
@pytest.mark.parametrize("do_max", [True, False, "none"])
def test_micro_fullk_edges(cuda, b, h, lq, lk, d, do_max):
    """fullk in its three modes (two passes with the max) at every instance."""
    q, k, v = (_randn(torch.Generator().manual_seed(d + lq + 3 * lk + i), b, h, n, d,
                      device=cuda) for i, n in enumerate((lq, lk, lk)))
    scale = 1.0 / math.sqrt(d)
    out = micro.fullk(q, k, v, scale, do_max=do_max)
    torch.cuda.synchronize()
    assert_kernel_close(out, micro.fullk_reference(q.float(), k.float(), v.float(), scale,
                                                   do_max))


def test_micro_attention_is_deterministic(cuda):
    """Both probe bodies agree bit for bit across calls: no atomics, a fixed
    order of every sum."""
    gen = torch.Generator().manual_seed(9)
    for b, h, l, d in ((2, 66, 200, 40), (1, 2, 1000, 80), (1, 2, 300, 160)):
        q, k, v = (_randn(gen, b, h, l, d, device=cuda) for _ in range(3))
        assert torch.equal(micro.flash(q, k, v, 0.1), micro.flash(q, k, v, 0.1))
        if d <= 80:
            for m in (True, False, "none"):
                assert torch.equal(micro.fullk(q, k, v, 0.1, do_max=m),
                                   micro.fullk(q, k, v, 0.1, do_max=m))
    torch.cuda.synchronize()


# --------------------------------------- the f32 route's kernels on the card

# The f32 kernels against the plain versions in f32 on the card (TF32 off):
# the same f32 arithmetic summed in another order, ~1e-6 relative over sums
# of a few hundred terms; a wrong term reads 1e-3 or more.
F32_REL_L2 = 1e-5


def _f32(gen, *shape, device, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).to(device)


def _assert_f32_close(got, want, rel=F32_REL_L2, scale=None):
    """Relative L2 within ``rel``, against ``scale`` where the reference's
    own norm is smaller (a gradient that vanishes: with one key the softmax
    has none, and the kernel returns its rounding, ~1e-7 of the others)."""
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    den = torch.linalg.norm(want.double()).item()
    if scale is not None:
        den = max(den, scale)
    err = torch.linalg.norm(got.double() - want.double()).item() / den
    assert err <= rel, err


def _f32_bias(gen, b, lk, device):
    bias = torch.where(torch.rand((b, lk), generator=gen) < 0.3, -1e30, 0.0)
    bias[:, 0] = 0.0
    return bias.to(device)


F32_ATTN_SHAPES = [
    # (b, h, lq, lk, d, bias): L = 1; one ragged tile; Lq != Lk both ways;
    # every head dim of the model (8 and 16: the tiny topology) and the VAE's 512;
    # head dims that are not multiples of 8 (12, 44: the backward pads them),
    # with Lq and Lk past whole tiles on both sides
    (1, 2, 1, 1, 8, False),
    (2, 3, 16, 16, 16, True),
    (1, 2, 100, 300, 40, True),
    (2, 2, 300, 70, 64, False),
    (1, 2, 77, 200, 80, True),
    (1, 2, 64, 190, 160, True),
    (1, 1, 130, 130, 512, False),
    (2, 3, 90, 150, 12, False),
    (1, 2, 130, 77, 44, True),
    (1, 2, 270, 300, 160, True),
]

# The main path's joint attentions (32x32, 16x16 and 8x8 latents over 5
# views) at batch 1: the long sums over 5120, 1280 and 320 keys and queries.
F32_JOINT_SHAPES = [
    (1, 8, 5120, 5120, 40, True),
    (1, 8, 1280, 1280, 80, True),
    (1, 8, 320, 320, 160, True),
]


@pytest.mark.parametrize("b,h,lq,lk,d,with_bias", F32_ATTN_SHAPES + F32_JOINT_SHAPES)
def test_f32_flash_forward(cuda, b, h, lq, lk, d, with_bias):
    gen = torch.Generator().manual_seed(d + lq + lk)
    q, k, v = (_f32(gen, b, h, n, d, device=cuda) for n in (lq, lk, lk))
    bias = _f32_bias(gen, b, lk, cuda) if with_bias else None
    before = flash_attention_f32.launches
    out, lse = flash_attention_f32(q, k, v, bias, return_lse=True)
    torch.cuda.synchronize()
    assert flash_attention_f32.launches == before + 1
    ref, ref_lse = attention_reference_lse(q, k, v, bias)
    _assert_f32_close(out, ref)
    _assert_f32_close(lse, ref_lse)


@pytest.mark.parametrize("lk", [255, 256, 257])
@pytest.mark.parametrize("d", [40, 80, 160])
def test_f32_flash_forward_around_a_chunk(cuda, lk, d):
    """Key counts either side of the 256 keys after which O leaves the
    tensor cores' accumulator: the last chunk full, one key short, and one
    key past it."""
    gen = torch.Generator().manual_seed(d + lk)
    q, k, v = (_f32(gen, 2, 2, n, d, device=cuda) for n in (130, lk, lk))
    bias = _f32_bias(gen, 2, lk, cuda)
    out, lse = flash_attention_f32(q, k, v, bias, return_lse=True)
    torch.cuda.synchronize()
    ref, ref_lse = attention_reference_lse(q, k, v, bias)
    _assert_f32_close(out, ref)
    _assert_f32_close(lse, ref_lse)


@pytest.mark.parametrize("d", [40, 160, 512])
def test_f32_flash_forward_all_keys_masked_but_one(cuda, d):
    """A row whose bias masks every key but one returns that key's value,
    and its lse is that key's logit."""
    gen = torch.Generator().manual_seed(d)
    b, h, lq, lk = 2, 2, 70, 300
    q, k, v = (_f32(gen, b, h, n, d, device=cuda) for n in (lq, lk, lk))
    bias = torch.zeros((b, lk))
    bias[1] = -1e30
    bias[1, 217] = 0.0
    bias = bias.to(cuda)
    out, lse = flash_attention_f32(q, k, v, bias, return_lse=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(out[1], v[1, :, 217:218].expand(h, lq, d), atol=1e-6, rtol=1e-6)
    ref, ref_lse = attention_reference_lse(q, k, v, bias)
    _assert_f32_close(out, ref)
    _assert_f32_close(lse, ref_lse)


@pytest.mark.parametrize("b,h,lq,lk,d,with_bias",
                         [s for s in F32_ATTN_SHAPES if s[4] <= 160] + F32_JOINT_SHAPES)
def test_f32_flash_backward(cuda, b, h, lq, lk, d, with_bias):
    gen = torch.Generator().manual_seed(d + 2 * lq + lk)
    q, k, v = (_f32(gen, b, h, n, d, device=cuda) for n in (lq, lk, lk))
    g = _f32(gen, b, h, lq, d, device=cuda)
    bias = _f32_bias(gen, b, lk, cuda) if with_bias else None
    out, lse = flash_attention_f32(q, k, v, bias, return_lse=True)
    before = flash_attention_bwd_f32.launches
    got = flash_attention_bwd_f32(q, k, v, bias, out, lse, g)
    torch.cuda.synchronize()
    assert flash_attention_bwd_f32.launches == before + 1
    want = attention_bwd_reference(q, k, v, bias, g)
    dv_norm = torch.linalg.norm(want[2].double()).item()
    for name, x, y in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert (x is None) == (y is None), name
        if y is not None:
            _assert_f32_close(x, y, scale=dv_norm if name in ("dq", "dk") else None)


@pytest.mark.parametrize("d", [12, 40, 80, 160])
def test_f32_flash_backward_without_dbias(cuda, d):
    """need_dbias=False: no bias gradient, the same dq, dk and dv."""
    gen = torch.Generator().manual_seed(d)
    q, k, v = (_f32(gen, 2, 2, n, d, device=cuda) for n in (70, 130, 130))
    g = _f32(gen, 2, 2, 70, d, device=cuda)
    bias = _f32_bias(gen, 2, 130, cuda)
    out, lse = flash_attention_f32(q, k, v, bias, return_lse=True)
    got = flash_attention_bwd_f32(q, k, v, bias, out, lse, g, need_dbias=False)
    with_db = flash_attention_bwd_f32(q, k, v, bias, out, lse, g)
    torch.cuda.synchronize()
    assert got[3] is None and with_db[3] is not None
    want = attention_bwd_reference(q, k, v, bias, g)
    for x, y, z in zip(got[:3], with_db[:3], want[:3]):
        assert torch.equal(x, y)
        _assert_f32_close(x, z)


def _f32_linear_t(gen, rows, cols, device):
    """A (rows, cols) operand as the transpose of a contiguous Linear weight."""
    return _f32(gen, cols, rows, device=device, scale=rows ** -0.5).t()


@pytest.mark.parametrize("n,l,c,heads", [(2, 100, 64, 2), (1, 256, 320, 5), (3, 16, 32, 4)])
def test_f32_fused_ln_self_attention(cuda, n, l, c, heads):
    gen = torch.Generator().manual_seed(c + l)
    x = _f32(gen, n, l, c, device=cuda)
    hd = c
    ws = [_f32_linear_t(gen, c, hd, cuda) for _ in range(3)] + [_f32_linear_t(gen, hd, c, cuda)]
    g, b, bo = (_f32(gen, c, device=cuda, scale=0.1) + (1.0 if i == 0 else 0.0)
                for i in range(3))
    before = fused_ln_self_attention_f32.launches
    out = fused_ln_self_attention_f32(x, g, b, *ws, bo, heads, hd // heads)
    torch.cuda.synchronize()
    assert fused_ln_self_attention_f32.launches == before + 1
    want = fused_ln_self_attention_reference(x, g, b, *ws, bo, heads, hd // heads)
    _assert_f32_close(out - x, want - x)


@pytest.mark.parametrize("m,c", [(100, 64), (1024, 320), (16, 32)])
def test_f32_fused_ln_geglu_ff(cuda, m, c):
    gen = torch.Generator().manual_seed(m + c)
    x = _f32(gen, 2, m, c, device=cuda)
    w1, w2 = _f32_linear_t(gen, c, 8 * c, cuda), _f32_linear_t(gen, 4 * c, c, cuda)
    g, b = _f32(gen, c, device=cuda, scale=0.1) + 1.0, _f32(gen, c, device=cuda, scale=0.1)
    b1, b2 = _f32(gen, 8 * c, device=cuda, scale=0.1), _f32(gen, c, device=cuda, scale=0.1)
    before = fused_ln_geglu_ff_f32.launches
    out = fused_ln_geglu_ff_f32(x, g, b, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert fused_ln_geglu_ff_f32.launches == before + 1
    _assert_f32_close(out - x, fused_ln_geglu_ff_reference(x, g, b, w1, b1, w2, b2) - x)


def test_f32_kernels_are_deterministic(cuda):
    """No atomics, a fixed order of every sum: bit for bit across calls (the
    flash forward and backward, the forward's GEMM-tile route at D = 512,
    and the GEMM tile with both B layouts)."""
    gen = torch.Generator().manual_seed(11)
    q, k, v, g = (_f32(gen, 2, 3, 150, 40, device=cuda) for _ in range(4))
    bias = _f32_bias(gen, 2, 150, cuda)
    out, lse = flash_attention_f32(q, k, v, bias, return_lse=True)
    again = flash_attention_f32(q, k, v, bias, return_lse=True)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    one = flash_attention_bwd_f32(q, k, v, bias, out, lse, g)
    two = flash_attention_bwd_f32(q, k, v, bias, out, lse, g)
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    q, k, v = (_f32(gen, 2, 1, 200, 512, device=cuda) for _ in range(3))
    out, lse = flash_attention_f32(q, k, v, bias[:, :1].expand(2, 200).contiguous(),
                                   return_lse=True)
    again = flash_attention_f32(q, k, v, bias[:, :1].expand(2, 200).contiguous(),
                                return_lse=True)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    a, w = _f32(gen, 300, 2600, device=cuda), _f32(gen, 200, 2600, device=cuda)
    assert torch.equal(gemm_f32(a, w), gemm_f32(a, w))
    assert torch.equal(gemm_f32(a, w.t().contiguous(), b_kn=True),
                       gemm_f32(a, w.t().contiguous(), b_kn=True))
    torch.cuda.synchronize()


# (label, m, n, k, b_kn, batch, bias, res, a_heads, out_heads): every layout
# of the GEMM tile at ragged M and N (not multiples of its 128 x 128 tile),
# and K across the sum's flush every 256 (2560, 4096), at the fused
# blocks' widths (K up to 2560 at C = 640) and past them.
F32_GEMM_CASES = [
    ("(N, K) B", 257, 300, 332, False, 0, None, False, 0, 0),
    ("(K, N) B", 257, 300, 332, True, 0, None, False, 0, 0),
    ("(N, K) B + bias + residual", 130, 36, 64, False, 0, "shared", True, 0, 0),
    ("(N, K) B, K = 2560", 200, 136, 2560, False, 0, "shared", True, 0, 0),
    ("(K, N) B, K = 4096", 300, 264, 4096, True, 0, None, False, 0, 0),
    ("batch, a bias row each", 70, 52, 48, False, 3, "per entry", False, 0, 0),
    ("batch, (K, N) B", 33, 16, 132, True, 2, "shared", False, 0, 0),
    ("head-merged A + bias + residual", 2 * 150, 320, 5 * 64, False, 0, "shared", True, 5, 0),
    ("head-split output", 3 * 100, 8 * 40, 320, False, 0, None, False, 0, 8),
]


@pytest.mark.parametrize("label,m,n,k,b_kn,batch,bias,res,a_heads,out_heads", F32_GEMM_CASES,
                         ids=[c[0] for c in F32_GEMM_CASES])
def test_f32_gemm_layouts(cuda, label, m, n, k, b_kn, batch, bias, res, a_heads, out_heads):
    """The GEMM tile against its plain version in f32 (relative L2 1e-5)."""
    gen = torch.Generator().manual_seed(m + n + k)
    lead = (batch,) if batch else ()
    a = _f32(gen, *lead, m, k, device=cuda)
    if a_heads:
        l, d = m // 2, k // a_heads
        a = a.reshape(2, l, a_heads, d).transpose(1, 2).contiguous()
    b = _f32(gen, *lead, *((k, n) if b_kn else (n, k)), device=cuda, scale=k ** -0.5)
    bv = {None: None, "shared": _f32(gen, n, device=cuda),
          "per entry": _f32(gen, batch, n, device=cuda)}[bias]
    rv = _f32(gen, m, n, device=cuda) if res else None
    l_out = m // 3 if out_heads else 0
    before = gemm_f32.launches
    got = gemm_f32(a, b, bv, rv, b_kn=b_kn, out_heads=out_heads, l=l_out)
    torch.cuda.synchronize()
    assert gemm_f32.launches == before + 1
    _assert_f32_close(got, gemm_f32_reference(a, b, bv, rv, b_kn, 1.0, out_heads, l_out))


@pytest.mark.parametrize("cap", [1 << 30, 2 * 100 * 300 * 4, 64 * 300 * 4])
def test_f32_flash_forward_route_across_chunks(cuda, cap):
    """The D = 512 forward's three launches a chunk, with one chunk, several
    chunks of heads, and each head split by query rows, against the plain
    version; each chunk launches the GEMM tile twice and the row pass once."""
    gen = torch.Generator().manual_seed(cap % 1000)
    b, h, lq, lk, d = 2, 3, 100, 299, 512
    q, k, v = (_f32(gen, b, h, n, d, device=cuda) for n in (lq, lk, lk))
    bias = _f32_bias(gen, b, lk, cuda)
    out, lse = torch.empty_like(q), torch.empty((b, h, lq), device=cuda)
    chunks = f32_route.attention_chunks(b * h, lq, lk, cap)
    before = gemm_f32.launches, attention_rows_f32.launches
    f32_route.attention_route_f32(q, k, v, bias, d ** -0.5, out, lse,
                                  f32_route.RouteLaunches(f32_route._lib()), cap)
    torch.cuda.synchronize()
    assert (gemm_f32.launches, attention_rows_f32.launches) == (
        before[0] + 2 * len(chunks), before[1] + len(chunks))
    ref, ref_lse = attention_reference_lse(q, k, v, bias)
    _assert_f32_close(out, ref)
    _assert_f32_close(lse, ref_lse)


def test_f32_paths_take_the_hand_kernels_only(cuda, monkeypatch):
    """CUDA f32 attention past head dim 160, the f32 fused blocks' GEMMs and
    the probe's f32 matmul launch the hand kernels (their counters rise) and
    reach no plain version, SDPA or cuBLAS product (each raises here)."""
    import torch.nn.functional as F

    from mvldm_tpu_torch.ops import attention as attn_mod

    def refuse(*_, **__):
        raise AssertionError("a library or plain call on the f32 card path")

    for mod, name in ((F, "scaled_dot_product_attention"), (F, "linear"), (torch, "matmul"),
                      (torch, "bmm"), (torch, "einsum"), (attn_mod, "attention_reference"),
                      (attn_mod, "attention_reference_lse"), (f32_route, "gemm_f32_reference"),
                      (f32_route, "attention_rows_reference")):
        monkeypatch.setattr(mod, name, refuse)
    gen = torch.Generator().manual_seed(3)
    counts = lambda: (gemm_f32.launches, attention_rows_f32.launches,  # noqa: E731
                      micro.matmul.f32_launches)
    before = counts()
    q, k, v = (_f32(gen, 2, 1, 130, 512, device=cuda) for _ in range(3))
    flash_attention_f32(q, k, v, return_lse=True)
    x = _f32(gen, 2, 64, 64, device=cuda)
    ws = [_f32_linear_t(gen, 64, 64, cuda) for _ in range(4)]
    vec = _f32(gen, 64, device=cuda)
    fused_ln_self_attention_f32(x, vec + 1.0, vec, *ws, vec, 2, 32)
    w1, w2 = _f32_linear_t(gen, 64, 512, cuda), _f32_linear_t(gen, 256, 64, cuda)
    fused_ln_geglu_ff_f32(x, vec + 1.0, vec, w1, _f32(gen, 512, device=cuda), w2, vec)
    micro.matmul(_f32(gen, 256, 128, device=cuda), _f32(gen, 128, 128, device=cuda))
    torch.cuda.synchronize()
    # the route: S and P V (2), the row pass (1); the blocks: 4 + 2 GEMMs
    assert tuple(a - b for a, b in zip(counts(), before)) == (2 + 4 + 2, 1, 1)


# ------------------------------------------- an f32 model through the route


def _tiny_f32_engine(device):
    """The tiny topology of ``tests/test_torch_goldens.py`` (2 stages of 32
    and 64 channels, 4 heads, a 4-level VAE of 16-32 channels) with
    ``builder.init_params``'s seeded weights, in f32 on ``device``."""
    from mvldm_tpu_torch.builder import MVLDM, init_params
    from mvldm_tpu_torch.diffusion.engine import DiffusionEngine, ModelCfg
    from mvldm_tpu_torch.diffusion.schedulers import DDIMScheduler, DDIMSchedulerKwargs
    from mvldm_tpu_torch.models.mv_attention import SpatialTransformer3DCfg
    from mvldm_tpu_torch.models.unet import MultiViewUNetCfg, UNetBackboneCfg
    from mvldm_tpu_torch.models.vae import AutoencoderCfg, AutoencoderKLCfg

    cfg = ModelCfg(
        denoiser=MultiViewUNetCfg(
            autoencoder=UNetBackboneCfg(
                down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
                block_out_channels=(32, 64), layers_per_block=1, cross_attention_dim=24,
                num_attention_heads=(4, 4), norm_num_groups=8),
            multi_view_attention=SpatialTransformer3DCfg(num_heads=4)),
        autoencoder=AutoencoderCfg(kwargs=AutoencoderKLCfg(
            block_out_channels=(16, 32, 32, 32), layers_per_block=1, norm_num_groups=8)),
        use_cfg=True, cfg_scale=3.0, use_ray_encoding=False)
    model = MVLDM(cfg)
    init_params(model, 0)
    model = model.to(device=device, dtype=torch.float32)
    scheduler = DDIMScheduler.create(
        DDIMSchedulerKwargs(clip_sample=False, prediction_type="epsilon"), num_inference_steps=4)
    return DiffusionEngine(cfg, model.denoiser, model.autoencoder, scheduler)


@pytest.fixture
def full_f32(cuda):
    """TF32 off in cuBLAS and cuDNN for the test, restored after it."""
    from mvldm_tpu_torch.tools.measure import no_tf32

    with no_tf32():
        yield cuda


def _rel_l2(got, want) -> float:
    return (torch.linalg.norm(got.cpu() - want) / torch.linalg.norm(want)).item()


def _route_counts():
    """The f32 route's counts (forward, backward, fused blocks), then the
    bf16 kernels'."""
    return (flash_attention_f32.launches, flash_attention_bwd_f32.launches,
            fused_ln_self_attention_f32.launches, fused_ln_geglu_ff_f32.launches,
            flash_attention.launches, flash_attention_bwd_dq.launches,
            fused_ln_self_attention.launches, fused_ln_geglu_ff.launches)


def test_f32_unet_forward_on_the_card(full_f32):
    """An f32 model runs on the card through the f32 route's kernels (no bf16
    kernel launches) and matches the CPU within 3e-4 relative L2, the CPU
    parity tests' tolerance: the same f32 arithmetic summed in another
    order."""
    cpu, gpu = _tiny_f32_engine("cpu"), _tiny_f32_engine(full_f32)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((2, 5, 16, 16, 11), generator=gen)
    t = torch.tensor([[0, 500, 500, 500, 500]] * 2)
    mask = torch.tensor([[True] * 5, [False] + [True] * 4])
    before = _route_counts()
    with torch.inference_mode():
        got = gpu.unet(x.to(full_f32), t.to(full_f32), view_mask=mask.to(full_f32))
        torch.cuda.synchronize()
        want = cpu.unet(x, t, view_mask=mask)
    after = _route_counts()
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert [after[i] > before[i] for i in range(4)] == [True, False, True, True], (before,
                                                                                  after)
    assert after[4:] == before[4:]
    assert _rel_l2(got, want) <= 3e-4


def test_f32_training_step_on_the_card(full_f32):
    """One f32 training step (loss, backward, SGD update of the f32
    masters) on the card, through the f32 route's forward, backward and
    fused-block kernels, against the CPU with the same injected draws: loss
    and update within 1e-3 relative (the same f32 arithmetic in another
    order through forward and backward; a wrong term reads O(1e-2))."""
    from mvldm_tpu_torch.diffusion.engine import Batch, TrainDraws
    from mvldm_tpu_torch.training import (
        OptimizerCfg,
        build_lr_schedule,
        build_optimizer,
        make_train_step,
    )
    from mvldm_tpu_torch.training.trainer import TrainState, master_params

    rng = torch.Generator().manual_seed(2)
    b, v = 1, 5
    extr = torch.eye(4).repeat(b, v, 1, 1)
    extr[:, :, 0, 3] = torch.linspace(0, 1, v)
    intr = torch.eye(3).repeat(b, v, 1, 1)
    intr[:, :, 0, 2] = intr[:, :, 1, 2] = 0.5
    batch = Batch(images=torch.rand((b, v, 64, 64, 3), generator=rng), extrinsics=extr,
                  intrinsics=intr, is_target=torch.tensor([[False, False, True, True, True]]))
    draws = TrainDraws.draw(b, v, 2, (8, 8, 4), 1000, torch.Generator().manual_seed(3))
    results = []
    for device in ("cpu", full_f32):
        engine = _tiny_f32_engine(device)
        engine.vae.requires_grad_(False)
        tx = build_optimizer(OptimizerCfg("SGD", 1.0, {}),
                             build_lr_schedule(1.0, None))
        params = master_params(engine.unet)
        before = {n: p.clone() for n, p in params.items()}
        state = TrainState(params=params, opt_state=tx.init(params), ema_params=None, step=0)
        counts = _route_counts()
        state, metrics = make_train_step(engine, tx, num_context_views=2)(state, batch, draws)
        if device != "cpu":
            torch.cuda.synchronize()
            after = _route_counts()
            assert all(a > c for a, c in zip(after[:4], counts[:4])), (counts, after)
            assert after[4:] == counts[4:]
        update = torch.cat([(state.params[n] - before[n]).flatten().cpu() for n in before])
        results.append((float(metrics["loss/diffusion"]), update))
    (cpu_loss, cpu_update), (gpu_loss, gpu_update) = results
    assert torch.isfinite(gpu_update).all() and cpu_update.abs().max() > 0
    assert abs(gpu_loss - cpu_loss) <= 1e-3 * abs(cpu_loss)
    assert _rel_l2(gpu_update, cpu_update) <= 1e-3
