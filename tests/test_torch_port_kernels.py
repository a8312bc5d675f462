"""The port's CUDA kernels against their plain versions, on the card.

Each kernel runs on bf16 inputs and is held against its plain PyTorch
version computed in f32 on the same bf16 inputs. These tests need an
NVIDIA Hopper GPU and ``nvcc``; without a card they skip. On the GPU
machine: ``python -m pytest tests/test_torch_port_kernels.py -m cuda``.

Tolerance: a bf16 output cannot come closer to the f32 value than half a
bf16 step of itself, so that step is taken off each element's error. What
is left, the kernel's own error (it rounds P, q, k, v, LN(x) and the GEGLU
activation to bf16 where the f32 plain version does not), must stay within
5 % of the rms of what the kernel computes: the output for attention, and
``out - x`` for the residual blocks.
"""

import pytest
import torch

from mvldm_tpu_torch.ops.attention import attention_reference, flash_attention
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
