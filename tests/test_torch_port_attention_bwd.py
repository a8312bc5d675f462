"""The port's attention backward against the JAX package, fp32 on CPU.

The same numpy inputs go through the port's plain versions (the lse of
``attention_reference_lse``, the chunked ``attention_bwd_reference``, and
autograd through ``attention`` and the fused LN+attention / LN+FF autograd
Functions) and through the JAX package: the Pallas kernels under the
interpreter (``flash_attention(return_lse=True)``, ``flash_attention_bwd``)
and ``jax.vjp`` of the dispatchers. Tolerances are the JAX package's own
(``tests/test_attention.py``: 1e-4 for gradients, 1e-4 for the lse; the
fused blocks' gradients 2e-4, their forward tests' 1e-4 times the extra
products of the backward).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvldm_tpu.ops.attention import attention as jax_attention
from mvldm_tpu.ops.attention import flash_attention as jax_flash
from mvldm_tpu.ops.attention import flash_attention_bwd as jax_flash_bwd
from mvldm_tpu.ops.fused_attn import fused_ln_self_attention as jax_fused_attn
from mvldm_tpu.ops.fused_ff import fused_ln_geglu_ff as jax_fused_ff
from mvldm_tpu_torch.ops import attention as port_attn
from mvldm_tpu_torch.ops.fused_attn import fused_ln_self_attention
from mvldm_tpu_torch.ops.fused_ff import fused_ln_geglu_ff
from mvldm_tpu_torch.tools import kernel_compare, measure

from tests.test_torch_port_ops import _attn_inputs, _bias, _ff_inputs, _qkv, _t

SHAPES = [(2, 2, 64, 64, 40), (1, 2, 100, 300, 64), (2, 1, 77, 130, 80), (1, 2, 40, 56, 160)]


def _grad(seed, b, h, lq, d):
    return np.random.default_rng(seed + 7).standard_normal((b, h, lq, d)).astype(np.float32)


@pytest.mark.parametrize("b,h,lq,lk,d", SHAPES)
@pytest.mark.parametrize("with_bias", [False, True])
def test_lse_vs_jax_kernel(b, h, lq, lk, d, with_bias):
    q, k, v = _qkv(lq + d, b, h, lq, lk, d)
    bias = _bias(d, b, lk) if with_bias else None
    out, lse = port_attn.attention_reference_lse(
        _t(q), _t(k), _t(v), None if bias is None else _t(bias))
    j_out, j_lse = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             None if bias is None else jnp.asarray(bias),
                             return_lse=True, interpret=True, block_q=128, block_k=128)
    assert lse.shape == (b, h, lq)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse)[..., 0], atol=1e-4)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=2e-5)


@pytest.mark.parametrize("b,h,lq,lk,d", SHAPES)
@pytest.mark.parametrize("with_bias", [False, True])
def test_plain_backward_vs_jax(b, h, lq, lk, d, with_bias):
    """dq/dk/dv/dbias of the chunked plain backward (chunks of 32 queries, so
    ragged L spans several chunks) against the interpreted Pallas backward
    and jax.vjp of the JAX dispatcher."""
    q, k, v = _qkv(lq + d, b, h, lq, lk, d)
    g = _grad(d, b, h, lq, d)
    bias = _bias(d, b, lk) if with_bias else None
    tb = None if bias is None else _t(bias)
    got = port_attn.attention_bwd_reference(_t(q), _t(k), _t(v), tb, _t(g), chunk=32)
    scale = 1.0 / np.sqrt(d)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    jb = None if bias is None else jnp.asarray(bias)
    j_out, j_lse = jax_flash(jq, jk, jv, jb, return_lse=True, interpret=True,
                             block_q=128, block_k=128)
    kern = jax_flash_bwd(jq, jk, jv, jb, j_out, j_lse, jg, scale,
                         block_q=128, block_k=128, interpret=True)
    if bias is None:
        _, vjp = jax.vjp(lambda a, b_, c: jax_attention(a, b_, c), jq, jk, jv)
        ref = (*vjp(jg), None)
    else:
        _, vjp = jax.vjp(lambda a, b_, c, e: jax_attention(a, b_, c, e), jq, jk, jv, jb)
        ref = vjp(jg)
    for i, name in enumerate(("dq", "dk", "dv")):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(kern[i]), atol=1e-4, err_msg=name)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref[i]), atol=1e-4, err_msg=name)
    if bias is None:
        assert got[3] is None and kern[3] is None
    else:
        np.testing.assert_allclose(got[3].numpy(), np.asarray(kern[3])[:, 0, :, 0], atol=1e-4)
        np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]), atol=1e-4)


@pytest.mark.parametrize("with_bias", [False, True])
def test_attention_autograd_vs_jax_vjp(with_bias):
    """Autograd through the port's dispatcher (its autograd Function on the
    CPU) against jax.vjp of the JAX dispatcher, bias gradient included."""
    b, h, lq, lk, d = 2, 2, 48, 80, 40
    q, k, v = _qkv(3, b, h, lq, lk, d)
    g = _grad(3, b, h, lq, d)
    bias = _bias(3, b, lk) if with_bias else np.zeros((b, lk), np.float32)
    ts = [_t(a).requires_grad_() for a in (q, k, v, bias)]
    out = port_attn.attention(*ts)
    out.backward(_t(g))
    _, vjp = jax.vjp(lambda *a: jax_attention(*a), *(jnp.asarray(a) for a in (q, k, v, bias)))
    for t, want in zip(ts, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("heads,d,l", [(4, 8, 48), (2, 40, 64)])
def test_fused_attention_grads_vs_jax(heads, d, l):
    x, ln_s, ln_b, ws, bo = _attn_inputs(l=l, heads=heads, d=d)
    args = [x, ln_s, ln_b, *ws, bo]
    g = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)
    ts = [_t(a).requires_grad_() for a in args]
    y = fused_ln_self_attention(*ts, heads, d)
    y.backward(_t(g))
    _, vjp = jax.vjp(lambda *a: jax_fused_attn(*a, heads, d), *(jnp.asarray(a) for a in args))
    for i, (t, want) in enumerate(zip(ts, vjp(jnp.asarray(g)))):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4,
                                   err_msg=f"input {i}")


@pytest.mark.parametrize("c,l", [(32, 64), (40, 16)])
def test_fused_ff_grads_vs_jax(c, l):
    args = list(_ff_inputs(l=l, c=c))
    g = np.random.default_rng(2).standard_normal(args[0].shape).astype(np.float32)
    ts = [_t(a).requires_grad_() for a in args]
    y = fused_ln_geglu_ff(*ts)
    y.backward(_t(g))
    _, vjp = jax.vjp(lambda *a: jax_fused_ff(*a), *(jnp.asarray(a) for a in args))
    for i, (t, want) in enumerate(zip(ts, vjp(jnp.asarray(g)))):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4,
                                   err_msg=f"input {i}")


def test_no_grad_path_is_forward_only():
    """Without gradients to record, the dispatchers run the plain forward
    (no autograd Function, no lse), as sampling does."""
    q, k, v = (_t(a) for a in _qkv(0, 1, 2, 16, 24, 8))
    with torch.no_grad():
        out = port_attn.attention(q.requires_grad_(), k, v)
    assert out.grad_fn is None
    assert torch.equal(out, port_attn.attention_reference(q.detach(), k, v))


@pytest.mark.parametrize("which", ["dq", "dkv"])
def test_bwd_kernel_wrappers_refuse_cpu_tensors(monkeypatch, which):
    """The kernel wrappers take CUDA tensors only: on CPU tensors they raise
    before building or loading a library, with no hidden fallback to the
    plain backward."""
    def no_build(*args, **kwargs):
        raise AssertionError("a kernel library was built or loaded")

    monkeypatch.setattr(port_attn._build, "load", no_build)
    monkeypatch.setattr(port_attn._build, "build", no_build)
    q, k, v = (_t(a).to(torch.bfloat16) for a in _qkv(0, 1, 2, 16, 24, 8))
    g = torch.zeros_like(q)
    lse = torch.zeros(q.shape[:3])
    before = (port_attn.flash_attention_bwd_dq.launches,
              port_attn.flash_attention_bwd_dkv.launches)
    with pytest.raises(ValueError, match="must be on"):
        if which == "dq":
            port_attn.flash_attention_bwd_dq(q, k, v, None, q, lse, g)
        else:
            port_attn.flash_attention_bwd_dkv(q, k, v, None, lse, lse, g)
    assert (port_attn.flash_attention_bwd_dq.launches,
            port_attn.flash_attention_bwd_dkv.launches) == before


def test_bwd_compare_tool_needs_a_card(capsys):
    """The one-call comparison of two backward builds exits non-zero, with
    no result line, where there is no CUDA device."""
    assert kernel_compare.main(["--other", "."]) == 2
    assert capsys.readouterr().out == ""


def test_bwd_compare_tool_covers_the_training_shapes():
    """Its shapes are every attention of a training step: the joint one at
    each resolution with the view bias, the two per-frame ones without."""
    shapes = kernel_compare.TRAIN_SHAPES
    assert len({label for label, *_ in shapes}) == len(shapes) == 12
    for label, b, h, l, d, with_bias in shapes:
        assert with_bias == label.startswith("joint")
        if with_bias:
            assert b == 2 and l % 5 == 0  # 2 examples x 5 views
        else:
            assert b == 10  # 2 examples x 5 frames
        assert d in (40, 64, 80, 160)


@pytest.mark.parametrize("n_exp,mhz,n_sms,want_ms", [
    (2 * 8 * 5120 * 5120, 1980.0, 132, 0.10029996939),
    (16 * 132 * 1000, 1000.0, 132, 1e-3),
    (16 * 114 * 1000, 1000.0, 114, 1e-3),
])
def test_exp_floor(n_exp, mhz, n_sms, want_ms):
    """16 exp2 a clock on each of the card's SMs."""
    assert measure.exp_floor_ms(n_exp, mhz, n_sms) == pytest.approx(want_ms, rel=1e-9)


def test_error_record_of_a_residual_block():
    """The rms is taken of what the block adds to its residual, and the own
    error is charged against that."""
    x = torch.ones(4)
    ref = x + torch.tensor([0.1, -0.1, 0.1, -0.1])
    rec = measure.error_record(ref + torch.tensor([0.0, 0.0, 0.0, 0.01]), ref, x)
    assert rec["rms_computed"] == pytest.approx(0.1)
    assert rec["kernel_err"] == pytest.approx(0.01, abs=1e-6)
    assert rec["err_over_rms"] == pytest.approx(0.1, rel=1e-4)
    assert measure.error_record(ref, ref)["err_over_rms"] == 0.0


def test_own_error_takes_off_half_a_bf16_step():
    """A bf16 output is charged only what lies past half a bf16 step of
    itself; an f32 output is charged its whole error."""
    ref = torch.tensor([1.0, -3.0, 0.0, 100.0])
    step = torch.tensor([2.0 ** -8, 2.0 ** -7, 0.0, 2.0 ** -2])  # half steps at 1, 3, 0, 100
    within = (ref + step).to(torch.bfloat16)
    assert measure.own_error(within, ref) == 0.0
    off = ref.clone()
    off[3] += 1.0
    assert measure.own_error(off.to(torch.bfloat16), ref) == pytest.approx(1.0 - 2.0 ** -2)
    assert measure.own_error(off, ref) == 1.0
