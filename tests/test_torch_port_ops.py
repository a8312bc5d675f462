"""Port ops (mvldm_tpu_torch/ops) against the JAX package, fp32 on CPU.

The same numpy inputs go through the port's plain versions and through the
JAX functions: the plain jnp paths (``mha_reference``, ``_attn_jnp``,
``_ff_jnp``) and the Pallas kernels under the interpreter. Tolerances are
the JAX package's own kernel-test tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvldm_tpu.ops.attention import NEG_INF as JAX_NEG_INF
from mvldm_tpu.ops.attention import flash_attention as jax_flash
from mvldm_tpu.ops.attention import mha_reference
from mvldm_tpu.ops.fused_attn import _attn_jnp, _attn_pallas, pad_heads
from mvldm_tpu.ops.fused_ff import _ff_jnp, _ff_pallas
from mvldm_tpu_torch.models import layers as port_layers
from mvldm_tpu_torch.ops import attention as port_attn
from mvldm_tpu_torch.ops.fused_attn import (
    fused_ln_self_attention,
    fused_ln_self_attention_reference,
)
from mvldm_tpu_torch.ops.fused_ff import fused_ln_geglu_ff, fused_ln_geglu_ff_reference


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _qkv(seed, b, h, lq, lk, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, lq, d)).astype(np.float32),
            rng.standard_normal((b, h, lk, d)).astype(np.float32),
            rng.standard_normal((b, h, lk, d)).astype(np.float32))


def _bias(seed, b, lk):
    rng = np.random.default_rng(seed + 100)
    bias = np.where(rng.random((b, lk)) < 0.3, port_attn.NEG_INF, 0.0).astype(np.float32)
    bias[:, 0] = 0.0  # every row keeps a key
    return bias


def test_neg_inf_matches():
    assert port_attn.NEG_INF == JAX_NEG_INF


@pytest.mark.parametrize("d", [40, 64, 80, 160, 512])
@pytest.mark.parametrize("lq,lk", [(64, 64), (100, 300)])
@pytest.mark.parametrize("with_bias", [False, True])
def test_attention_reference_vs_jax(d, lq, lk, with_bias):
    q, k, v = _qkv(d + lq, 2, 2, lq, lk, d)
    bias = _bias(d, 2, lk) if with_bias else None
    got = port_attn.attention_reference(_t(q), _t(k), _t(v),
                                        None if bias is None else _t(bias)).numpy()
    jb = None if bias is None else jnp.asarray(bias)
    ref = np.asarray(mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jb))
    np.testing.assert_allclose(got, ref, atol=2e-5)
    pallas = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jb,
                                  interpret=True, block_q=128, block_k=128))
    np.testing.assert_allclose(got, pallas, atol=2e-5)


@pytest.mark.parametrize("lq,lk", [(64, 64), (100, 300)])
@pytest.mark.parametrize("with_bias", [False, True])
def test_attention_lse_vs_jax_vae_head(lq, lk, with_bias):
    """The lse at the VAE's single 512-wide head (``attention_reference_lse``,
    which the f32 kernels are held to) against the interpreted Pallas
    kernel's ``return_lse``; the narrower heads are held in
    ``tests/test_torch_port_attention_bwd.py``."""
    q, k, v = _qkv(512 + lq, 2, 1, lq, lk, 512)
    bias = _bias(512, 2, lk) if with_bias else None
    out, lse = port_attn.attention_reference_lse(_t(q), _t(k), _t(v),
                                                 None if bias is None else _t(bias))
    jb = None if bias is None else jnp.asarray(bias)
    j_out, j_lse = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jb,
                             return_lse=True, interpret=True, block_q=128, block_k=128)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse)[..., 0], atol=1e-4)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=2e-5)


def test_attention_dispatch_cpu_is_plain():
    q, k, v = _qkv(0, 1, 2, 16, 24, 8)
    before = port_attn.flash_attention.launches
    out = port_attn.attention(_t(q), _t(k), _t(v))
    ref = port_attn.attention_reference(_t(q), _t(k), _t(v))
    assert torch.equal(out, ref)
    assert port_attn.flash_attention.launches == before


def _attn_inputs(n=2, l=48, c=32, heads=4, d=8, seed=0):
    rng = np.random.default_rng(seed)
    inner = heads * d
    x = rng.standard_normal((n, l, c)).astype(np.float32)
    ln_s = (rng.random(c) + 0.5).astype(np.float32)
    ln_b = (rng.standard_normal(c) * 0.1).astype(np.float32)
    ws = [(rng.standard_normal(s) * 0.1).astype(np.float32)
          for s in ((c, inner), (c, inner), (c, inner), (inner, c))]
    bo = (rng.standard_normal(c) * 0.01).astype(np.float32)
    return x, ln_s, ln_b, ws, bo


@pytest.mark.parametrize("heads,d,l", [(4, 8, 48), (2, 40, 64), (1, 64, 16)])
def test_fused_attention_vs_jax(heads, d, l):
    x, ln_s, ln_b, (wq, wk, wv, wo), bo = _attn_inputs(l=l, heads=heads, d=d)
    got = fused_ln_self_attention(_t(x), _t(ln_s), _t(ln_b), _t(wq), _t(wk), _t(wv),
                                  _t(wo), _t(bo), heads, d).numpy()
    padded = [pad_heads(jnp.asarray(w), heads, d, axis=1) for w in (wq, wk, wv)]
    padded.append(pad_heads(jnp.asarray(wo), heads, d, axis=0))
    args = (jnp.asarray(x), jnp.asarray(ln_s), jnp.asarray(ln_b), *padded, jnp.asarray(bo))
    ref = np.asarray(_attn_jnp(*args, num_heads=heads, head_dim=d))
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    pallas = np.asarray(_attn_pallas(*args, num_heads=heads, head_dim=d, interpret=True))
    np.testing.assert_allclose(got, pallas, atol=1e-4, rtol=1e-4)


def test_decomposed_self_attn_block_matches_fused(monkeypatch):
    """The decomposed path (taken above the channel gate) computes the same
    function as the fused plain version."""
    heads, d = 4, 8
    c = heads * d
    attn = port_layers.CrossAttention(c, c, heads, d)
    norm = torch.nn.LayerNorm(c, eps=port_layers.LN_EPS)
    with torch.no_grad():
        for p in list(attn.parameters()) + list(norm.parameters()):
            p.copy_(torch.randn(p.shape) * 0.2)
    x = torch.randn(3, 20, c)
    with torch.no_grad():
        fused = port_layers.self_attn_block(x, norm, attn)
        monkeypatch.setattr(port_layers, "use_fused", lambda c, dtype: False)
        decomposed = port_layers.self_attn_block(x, norm, attn)
    torch.testing.assert_close(decomposed, fused, atol=1e-5, rtol=1e-5)


def _ff_inputs(n=2, l=64, c=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, l, c)).astype(np.float32)
    ln_s = (rng.random(c) + 0.5).astype(np.float32)
    ln_b = (rng.standard_normal(c) * 0.1).astype(np.float32)
    w1 = (rng.standard_normal((c, 8 * c)) * 0.1).astype(np.float32)
    b1 = (rng.standard_normal(8 * c) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((4 * c, c)) * 0.1).astype(np.float32)
    b2 = (rng.standard_normal(c) * 0.1).astype(np.float32)
    return x, ln_s, ln_b, w1, b1, w2, b2


@pytest.mark.parametrize("c,l", [(32, 64), (40, 16)])
def test_fused_ff_vs_jax(c, l):
    args = _ff_inputs(l=l, c=c)
    got = fused_ln_geglu_ff(*(_t(a) for a in args)).numpy()
    assert torch.equal(torch.from_numpy(got),
                       fused_ln_geglu_ff_reference(*(_t(a) for a in args)))
    jargs = [jnp.asarray(a) for a in args]
    np.testing.assert_allclose(got, np.asarray(_ff_jnp(*jargs)), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, np.asarray(_ff_pallas(*jargs, interpret=True)),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("c,l", [(32, 64), (40, 16)])
def test_decomposed_ff_block_vs_jax(monkeypatch, c, l):
    """The decomposed FF (taken above the channel gate) against ``_ff_jnp``."""
    x, ln_s, ln_b, w1, b1, w2, b2 = args = _ff_inputs(l=l, c=c)
    ff = port_layers.FeedForward(c)
    norm = torch.nn.LayerNorm(c, eps=port_layers.LN_EPS)
    with torch.no_grad():
        norm.weight.copy_(_t(ln_s))
        norm.bias.copy_(_t(ln_b))
        ff.net[0].proj.weight.copy_(_t(w1).t())
        ff.net[0].proj.bias.copy_(_t(b1))
        ff.net[2].weight.copy_(_t(w2).t())
        ff.net[2].bias.copy_(_t(b2))
        monkeypatch.setattr(port_layers, "use_fused", lambda c, dtype: False)
        got = port_layers.ff_block(_t(x), norm, ff).numpy()
    ref = np.asarray(_ff_jnp(*(jnp.asarray(a) for a in args)))
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def test_fused_attention_cpu_is_plain():
    x, ln_s, ln_b, ws, bo = _attn_inputs()
    args = (_t(x), _t(ln_s), _t(ln_b), *(_t(w) for w in ws), _t(bo), 4, 8)
    before = fused_ln_self_attention.launches
    assert torch.equal(fused_ln_self_attention(*args),
                       fused_ln_self_attention_reference(*args))
    assert fused_ln_self_attention.launches == before
