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
moves it by at most ~2^-8).
"""

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
from mvldm_tpu_torch.ops.fused_ff import fused_ln_geglu_ff, fused_ln_geglu_ff_reference

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
    (1, 1, 130, 130, 512, False),
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
