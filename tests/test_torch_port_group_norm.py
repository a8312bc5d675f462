"""The channels-last GroupNorm (``ops/group_norm.py``) and the UNets'
channels-last layout.

On the CPU, in f32 at tiny widths:

* the plain NHWC version against the JAX package's ``GroupNorm``, with and
  without the SiLU, and with the time-embedding add against a JAX add then
  norm;
* its backward against autograd through ``F.group_norm`` (and ``F.silu``),
  whole and a slice of samples at a time;
* the kernel's plan at every UNet and VAE shape: what a cluster's shared
  memory holds, no empty stripe;
* the routing: what the kernel takes, and ``GroupNorm``'s spans;
* every ``Conv2d`` and ``GroupNorm`` input of the st3d, standard and MVDream
  UNets is channels-last, and after a backward every parameter's gradient
  is contiguous.

On the card (``-m cuda``, skipped without one): the kernel against the
plain version at the UNets' and the VAE's shapes. This module imports JAX
only inside the CPU tests, so the card runs it with ``--noconftest``:
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_port_group_norm.py -m cuda``.
"""

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from mvldm_tpu_torch.models import layers
from mvldm_tpu_torch.ops import group_norm as gn
from mvldm_tpu_torch.utils import profiling

# The f32 plain version against JAX's f32 GroupNorm: the same statistics,
# summed in another order.
ATOL = 2e-5


def _inputs(n=2, c=48, h=3, w=5, groups=4, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32) * 2 + 0.5
    weight = rng.standard_normal(c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    add = rng.standard_normal((n, c)).astype(np.float32)
    to = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
    return x, weight, bias, add, to(x).permute(0, 3, 1, 2), to(weight), to(bias), to(add)


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("with_add", [False, True])
def test_plain_version_against_jax(silu, with_add):
    import jax.numpy as jnp

    from mvldm_tpu.models.layers import GroupNorm as JaxGroupNorm

    groups, eps = 4, 1e-5
    x, weight, bias, add, tx, tw, tb, tadd = _inputs(groups=groups)
    assert tx.is_contiguous(memory_format=torch.channels_last)
    params = {"params": {"GroupNorm_0": {"scale": jnp.asarray(weight), "bias": jnp.asarray(bias)}}}
    jx = jnp.asarray(x) + (jnp.asarray(add)[:, None, None, :] if with_add else 0)
    want = np.asarray(JaxGroupNorm(groups, eps, act="silu" if silu else None).apply(params, jx))
    y, mean, rstd = gn.group_norm_nhwc_reference(tx, tw, tb, groups, eps, silu,
                                                 tadd if with_add else None)
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert mean.shape == rstd.shape == (2, groups)
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(), want, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("slice_elements", [None, 200])
@pytest.mark.parametrize("silu,with_add", [(False, False), (True, False), (True, True)])
def test_backward_against_autograd(monkeypatch, silu, with_add, slice_elements):
    """dx, dweight, dbias and dadd of the entry against autograd through the
    stock chain, in float64 (the plain backward computes in f32)."""
    if slice_elements:
        monkeypatch.setattr(gn, "BACKWARD_ELEMENTS", slice_elements)
    *_, tx, tw, tb, tadd = _inputs(n=3, dtype=torch.float64)
    inputs = [t.requires_grad_() for t in (tx, tw, tb) + ((tadd,) if with_add else ())]
    groups, eps = 4, 1e-6
    y = gn.group_norm_nhwc(tx, tw, tb, groups, eps, silu, tadd if with_add else None)
    stock = F.group_norm(tx + tadd[:, :, None, None] if with_add else tx, groups, tw, tb, eps)
    stock = F.silu(stock) if silu else stock
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    got = torch.autograd.grad(y, inputs, g)
    want = torch.autograd.grad(stock, inputs, g)
    assert got[0].is_contiguous(memory_format=torch.channels_last)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, rtol=1e-5)


# (hw, channels) of every GroupNorm of the SD2.1 UNet at 256 px and of the
# SD2.1 VAE's decoder and encoder at 256 px.
UNET_SHAPES = [(hw, c) for hw in (1024, 256, 64, 16)
               for c in (320, 640, 960, 1280, 1920, 2560)]
VAE_SHAPES = [(65536, 128), (65536, 256), (16384, 256), (16384, 512), (4096, 512),
              (1024, 512)]
# (hw, c, n): the UNet's shapes at a single view, a 10-view launch and an
# 80-view fill; the VAE's at one frame and ten.
CARD_CASES = ([(hw, c, n) for hw, c in UNET_SHAPES for n in (1, 10, 80)]
              + [(hw, c, n) for hw, c in VAE_SHAPES for n in (1, 10)])


@pytest.mark.parametrize("hw,c", UNET_SHAPES + VAE_SHAPES)
def test_plan_fits_the_kernel(hw, c):
    pl = gn.plan(hw, c, 32)
    assert pl.threads % (c // 8) == 0 and pl.threads % 32 == 0
    assert pl.threads <= gn.MAX_THREADS
    assert pl.ctas * pl.pixels >= hw > (pl.ctas - 1) * pl.pixels  # no empty stripe
    if not pl.two_pass:
        assert pl.ctas <= gn.MAX_CLUSTER
        assert gn._smem(pl.pixels, c, pl.threads, 32) <= gn.MAX_SMEM
    # Slabs up to 640 x 32 x 32 (1.3 MB) take the cluster route; of the
    # UNet's GroupNorms only 960 x 32 x 32 (one a call) is larger.
    if (hw, c) in UNET_SHAPES:
        assert pl.two_pass == (hw * c >= 1024 * 960)
    # The two-pass route takes every shape too (chip_smoke.py times it
    # against the cluster route).
    tp = gn.two_pass_plan(hw, c)
    assert tp.two_pass and tp.threads == pl.threads
    assert tp.ctas * tp.pixels >= hw > (tp.ctas - 1) * tp.pixels
    assert pl == tp or not pl.two_pass


def test_kernel_takes_bf16_channels_last_off_the_cpu():
    x = torch.empty((2, 64, 4, 4), dtype=torch.bfloat16, device="meta")
    cl = x.to(memory_format=torch.channels_last)
    assert gn.takes(cl, 8) and not gn.takes(x, 8)
    assert not gn.takes(cl, 32)  # 2 channels a group: 8 channels span 4 groups
    assert not gn.takes(cl.float(), 8)
    assert not gn.takes(torch.empty((2, 64, 4, 4), dtype=torch.bfloat16).to(
        memory_format=torch.channels_last), 8)
    assert not gn.takes(torch.empty((2, 20, 4, 4), dtype=torch.bfloat16, device="meta").to(
        memory_format=torch.channels_last), 4)  # C % 8
    assert not gn._spans_two_groups(80, 16) and gn._spans_two_groups(128, 32)


def test_group_norm_module_routes_and_spans():
    """On the CPU the module takes the stock chain, ``add`` included, and
    says so on the ``ops.group_norm`` span; a bf16 input on the card's
    stand-in device goes to the kernel's wrapper, which raises on NCHW
    rather than fall back to the stock chain."""
    norm = layers.GroupNorm(4, 48, 1e-5, act="silu")
    nn.init.normal_(norm.weight)
    *_, tx, _, _, tadd = _inputs()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        profiling.reset()
        y = norm(tx, tadd)
    want = F.silu(F.group_norm(tx + tadd[:, :, None, None], 4, norm.weight, norm.bias, 1e-5))
    torch.testing.assert_close(y, want, rtol=0, atol=0)
    assert profiling.snapshot()["spans"]["ops.group_norm"]["count"] == 1
    ranges = [e for e in prof.events() if e.name == profiling.PREFIX + "ops.group_norm"]
    assert len(ranges) == 1
    meta = tx.to("meta", torch.bfloat16)
    norm = norm.to(torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        norm(meta)
    with pytest.raises(ValueError, match="channels-last"):
        norm(meta.contiguous())


def _tiny_unets():
    from mvldm_tpu_torch.models.mv_attention import SpatialTransformer3DCfg
    from mvldm_tpu_torch.models.mvdream import MVDreamUNet, MVDreamUNetCfg
    from mvldm_tpu_torch.models.standard_transformer import CrossAttentionCfg
    from mvldm_tpu_torch.models.unet import MultiViewUNet, MultiViewUNetCfg, UNetBackboneCfg

    backbone = UNetBackboneCfg(
        down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
        up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), block_out_channels=(32, 64),
        layers_per_block=1, cross_attention_dim=24, num_attention_heads=(4, 4),
        norm_num_groups=8)
    st3d = MultiViewUNet(MultiViewUNetCfg(
        autoencoder=backbone, multi_view_attention=SpatialTransformer3DCfg(num_heads=4)),
        in_channels=7)
    standard = MultiViewUNet(MultiViewUNetCfg(
        autoencoder=backbone, multi_view_attention=CrossAttentionCfg(num_heads=4, pos_enc=True)),
        in_channels=7)
    mvdream = MVDreamUNet(MVDreamUNetCfg(
        model_channels=32, channel_mult=(1, 2), attention_resolutions=(1, 2), num_res_blocks=1,
        num_head_channels=16, context_dim=24))
    gen = torch.Generator().manual_seed(0)
    lat = lambda c: torch.randn((1, 3, 8, 8, c), generator=gen)  # noqa: E731
    t = torch.tensor([500])
    return {
        "st3d": (st3d, lambda m: m(lat(7), t)),
        "standard": (standard, lambda m: m(lat(7), t)),
        "mvdream": (mvdream, lambda m: m(lat(4), t, torch.randn((1, 5, 24), generator=gen),
                                         torch.randn((1, 3, 16), generator=gen))),
    }


@pytest.mark.parametrize("name", ["st3d", "standard", "mvdream"])
def test_unet_feature_maps_stay_channels_last(name):
    torch.manual_seed(0)
    model, run = _tiny_unets()[name]
    seen = []

    def hook(module, args):
        seen.append((type(module).__name__,
                     args[0].is_contiguous(memory_format=torch.channels_last)))

    for m in model.modules():
        if isinstance(m, (nn.Conv2d, layers.GroupNorm)):
            m.register_forward_pre_hook(hook)
    out = run(model)
    assert out.is_contiguous()
    kinds = {k for k, _ in seen}
    assert kinds == {"Conv2d", "GroupNorm"}
    assert all(ok for _, ok in seen), [k for k, ok in seen if not ok]
    out.square().mean().backward()
    grads = [(n, p.grad) for n, p in model.named_parameters() if p.grad is not None]
    assert grads and all(g.is_contiguous() for _, g in grads), \
        [n for n, g in grads if not g.is_contiguous()]


# ---------------------------------------------------------------- the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _card_inputs(n, c, hw, groups, device, seed):
    gen = torch.Generator().manual_seed(seed)
    side = int(round(hw ** 0.5))
    x = (torch.randn((n, side, side, c), generator=gen) * 1.5 + 0.3).to(device, torch.bfloat16)
    weight = (torch.randn(c, generator=gen) * 0.5 + 1).to(device, torch.bfloat16)
    bias = (torch.randn(c, generator=gen) * 0.5).to(device, torch.bfloat16)
    add = torch.randn((n, c), generator=gen).to(device, torch.bfloat16)
    return x.permute(0, 3, 1, 2), weight, bias, add


def _assert_close_bf16(out, ref):
    """A bf16 output against the f32 value: within half a bf16 step of the
    output, and 1e-3 of the rms beyond it (the kernel sums in another order
    and folds the affine map into one product)."""
    o = out.float()
    _, e = torch.frexp(o)
    half_step = torch.where(o == 0, torch.zeros_like(o), torch.ldexp(torch.ones_like(o), e - 9))
    err = ((o - ref).abs() - half_step).clamp_min(0).max().item()
    assert torch.isfinite(o).all()
    assert err <= 1e-3 * ref.square().mean().sqrt().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("hw,c,n", CARD_CASES)
def test_kernel_against_plain(cuda, hw, c, n):
    x, weight, bias, add = _card_inputs(n, c, hw, 32, cuda, seed=hw + c + n)
    for silu, a in ((True, add if hw <= 1024 else None), (False, None)):
        before = gn.group_norm_nhwc.launches
        y, mean, rstd = gn._group_norm_cuda(x, weight, bias, 32, 1e-5, silu, a)
        torch.cuda.synchronize()
        assert gn.group_norm_nhwc.launches == before + 1
        with torch.inference_mode():  # the sampling path's launch: no mean and rstd
            assert torch.equal(gn.group_norm_nhwc(x, weight, bias, 32, 1e-5, silu, a), y)
        ref, ref_mean, ref_rstd = gn.group_norm_nhwc_reference(
            x.float(), weight.float(), bias.float(), 32, 1e-5, silu, None if a is None else a.float())
        assert y.is_contiguous(memory_format=torch.channels_last)
        torch.testing.assert_close(mean, ref_mean, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(rstd, ref_rstd, rtol=1e-4, atol=0)
        _assert_close_bf16(y, ref)


@pytest.mark.cuda
def test_kernel_gives_a_sample_the_same_bits_in_any_batch(cuda):
    x, weight, bias, add = _card_inputs(10, 320, 1024, 32, cuda, seed=3)
    whole = gn._group_norm_cuda(x, weight, bias, 32, 1e-5, True, add)[0]
    one = gn._group_norm_cuda(x[3:4], weight, bias, 32, 1e-5, True, add[3:4])[0]
    assert torch.equal(whole[3:4], one)


@pytest.mark.cuda
def test_kernel_backward_against_plain_autograd(cuda):
    x, weight, bias, add = _card_inputs(4, 640, 256, 32, cuda, seed=5)
    ins = [t.clone().requires_grad_() for t in (x, weight, bias, add)]
    ins[0] = ins[0].detach().to(memory_format=torch.channels_last).requires_grad_()
    y = gn.group_norm_nhwc(*ins[:3], 32, 1e-5, True, ins[3])
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(2)).to(cuda, torch.bfloat16)
    got = torch.autograd.grad(y, ins, g)
    ref = [t.detach().float().requires_grad_() for t in ins]
    stock = F.silu(F.group_norm(ref[0] + ref[3][:, :, None, None], 32, ref[1], ref[2], 1e-5))
    want = torch.autograd.grad(stock, ref, g.float())
    for a, b in zip(got, want):
        rel = (a.float() - b).norm() / b.norm()
        assert rel < 2e-2, rel.item()
