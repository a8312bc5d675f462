"""The dispatchers' choice of kernels by device and dtype, on the CPU: CPU
tensors take the plain versions in every dtype; every tensor off the CPU
goes to kernel wrappers: f32 to the f32 route's (``ops/f32_route.py``),
every other dtype to the bf16 kernels', which launch for bf16 on the card
and refuse the rest. A tensor on the ``meta`` device stands in for one on
the card: it is not on the CPU, so the dispatchers route it as they would a
CUDA tensor."""

import pytest
import torch

from mvldm_tpu_torch.ops import attention as attn
from mvldm_tpu_torch.ops import f32_route, fused_attn, fused_ff


def _counts():
    return [attn.flash_attention.launches, fused_attn.fused_ln_self_attention.launches,
            fused_ff.fused_ln_geglu_ff.launches]


def _attn_args(device, dtype, grad=False, n=2, l=12, c=16, heads=2):
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen).to(device=device, dtype=dtype).requires_grad_(grad)

    x = rnd(n, l, c)
    d = c // heads
    return dict(
        attention=(rnd(n, heads, l, d), rnd(n, heads, l, d), rnd(n, heads, l, d)),
        fused_attn=(x, rnd(c), rnd(c), rnd(c, c), rnd(c, c), rnd(c, c), rnd(c, c), rnd(c),
                    heads, d),
        fused_ff=(x, rnd(c), rnd(c), rnd(c, 8 * c), rnd(8 * c), rnd(4 * c, c), rnd(c)))


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_calls_take_the_plain_versions(dtype, grad):
    """CPU calls, forward alone and through the autograd Functions, take the
    plain versions in their own dtype and launch nothing."""
    args = _attn_args("cpu", dtype, grad)
    before = _counts()
    outs = (attn.attention(*args["attention"]),
            fused_attn.fused_ln_self_attention(*args["fused_attn"]),
            fused_ff.fused_ln_geglu_ff(*args["fused_ff"]))
    assert all(o.device.type == "cpu" and o.dtype == dtype for o in outs)
    assert all(o.requires_grad == grad for o in outs)
    assert _counts() == before


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "bf16"), (torch.float16, "bf16"),
                                         (torch.float32, "f32")])
def test_every_dtype_off_the_cpu_reaches_the_kernels(dtype, route, grad, monkeypatch):
    """Every dtype off the CPU goes to kernel wrappers, forward alone and
    through the autograd Functions: f32 to the f32 route's, every other
    dtype to the bf16 kernels' (which, on the card, refuse all but bf16).
    Nothing takes a plain version there. The attention wrappers refuse a
    tensor that is not on a CUDA device; the fused blocks' wrappers are
    stubbed here: they would build the kernels."""
    reached = []

    def stub(name):
        return lambda x, *a: reached.append(name) or torch.empty_like(x)

    monkeypatch.setattr(fused_attn, "_fused_attn_cuda", stub("bf16 attn"))
    monkeypatch.setattr(fused_ff, "_fused_ff_cuda", stub("bf16 ff"))
    monkeypatch.setattr(fused_attn, "fused_ln_self_attention_f32", stub("f32 attn"))
    monkeypatch.setattr(fused_ff, "fused_ln_geglu_ff_f32", stub("f32 ff"))
    args = _attn_args("meta", dtype, grad)
    before = _counts()
    with pytest.raises(ValueError, match="must be on") as refused:
        attn.attention(*args["attention"])
    assert ("flash_attention_f32" in str(refused.value)) == (route == "f32")
    fused_attn.fused_ln_self_attention(*args["fused_attn"])
    fused_ff.fused_ln_geglu_ff(*args["fused_ff"])
    assert reached == [f"{route} attn", f"{route} ff"]
    assert _counts() == before


def _f32_counts():
    return [fn.launches for fn in f32_route.KERNELS]


@pytest.mark.parametrize("grad", [False, True])
def test_cpu_f32_calls_launch_no_f32_kernel(grad):
    """f32 CPU calls take the plain versions: the f32 route's counts stay."""
    args = _attn_args("cpu", torch.float32, grad)
    before = _f32_counts()
    attn.attention(*args["attention"])
    fused_attn.fused_ln_self_attention(*args["fused_attn"])
    fused_ff.fused_ln_geglu_ff(*args["fused_ff"])
    assert _f32_counts() == before


@pytest.mark.parametrize("wrapper,args", [
    ("flash_attention_f32", lambda t: (t(1, 2, 8, 8), t(1, 2, 8, 8), t(1, 2, 8, 8))),
    ("flash_attention_bwd_f32", lambda t: (t(1, 2, 8, 8),) * 3 + (None, t(1, 2, 8, 8),
                                                                  t(1, 2, 8), t(1, 2, 8, 8))),
    ("fused_ln_self_attention_f32", lambda t: (t(1, 8, 16), t(16), t(16), t(16, 16), t(16, 16),
                                               t(16, 16), t(16, 16), t(16), 2, 8)),
    ("fused_ln_geglu_ff_f32", lambda t: (t(1, 8, 16), t(16), t(16), t(16, 128), t(128),
                                         t(64, 16), t(16))),
    ("gemm_f32", lambda t: (t(8, 16), t(12, 16))),
    ("gemm_f32", lambda t: (t(2, 8, 16), t(2, 16, 12), t(12))),
    ("attention_rows_f32", lambda t: (t(2, 8, 16), t(2, 8), 13)),
])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_f32_wrappers_launch_on_the_card_only(wrapper, args, device):
    """The f32 route's wrappers launch for f32 tensors on a CUDA device and
    refuse any other device before any launch (no count)."""
    def t(*shape):
        return torch.zeros(shape, device=device)

    fn = getattr(f32_route, wrapper)
    before = fn.launches
    with pytest.raises(ValueError, match="must be on"):
        fn(*args(t))
    assert fn.launches == before
