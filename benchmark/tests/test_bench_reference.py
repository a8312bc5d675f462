"""The plain reference agrees with the port on the CPU at the ``tiny``
experiment, in float32, with the benchmark's seeded weights: the UNet with
each cross-view block, the VAE, a training loss and its gradients. Only
this file imports both. And the FLOP count, taken on the reference, does
not depend on which attention path the port takes."""

import pytest
import torch

from benchmark import weights
from benchmark.flops import Counter
from benchmark.reference import sampling, training
from benchmark.reference.model import Model
from conftest import SEED, tiny_config


def built(config):
    from benchmark.program import System

    with torch.device("meta"):
        shapes = weights.spec(Model(config["model"]).named_parameters())
    ref = Model(config["model"])
    made = weights.make(shapes, SEED, "cpu", torch.float32)
    ref.load_state_dict(made)
    return System(config, shapes, SEED, "cpu").engine, ref


@pytest.mark.parametrize("name", ["mvldm-sd21-st3d", "mvldm-sd21-standard"])
def test_unet_and_vae_agree(name):
    engine, ref = built(tiny_config(name))
    gen = torch.Generator().manual_seed(1)
    b, v, hw = 2, 3, 8
    x = torch.randn(b, v, hw, hw, 11, generator=gen)
    t = torch.randint(0, 1000, (b, v), generator=gen)
    mask = torch.tensor([[True, True, True], [False, True, True]])
    with torch.no_grad():
        got = engine.unet(x, t, view_mask=mask)
        want = ref.denoiser(x, t, mask)
        assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)
        img = torch.rand(2, 64, 64, 3, generator=gen) * 2 - 1
        moments = torch.cat([engine.vae.encode(img).mean, engine.vae.encode(img).logvar], -1)
        want_m = ref.autoencoder.moments(img)
        assert torch.allclose(moments[..., :4], want_m[..., :4], rtol=1e-4, atol=1e-4)
        z = torch.randn(2, 8, 8, 4, generator=gen)
        assert torch.allclose(engine.vae.decode(z), ref.autoencoder.decode(z),
                              rtol=1e-4, atol=1e-4)


def test_training_loss_and_gradients_agree():
    from mvldm_tpu_torch.diffusion.engine import Batch, TrainDraws

    config = tiny_config()
    engine, ref = built(config)
    gen = torch.Generator().manual_seed(2)
    b, v = 2, 5
    images = torch.rand(b, v, 64, 64, 3, generator=gen)
    extr = torch.eye(4).repeat(b, v, 1, 1)
    extr[:, :, 0, 3] = torch.linspace(0, 1, v)
    intr = torch.eye(3).repeat(b, v, 1, 1)
    intr[:, :, :2, 2] = 0.5
    d = TrainDraws.draw(b, v, 2, (8, 8, 4), 1000, gen)
    loss, _ = engine.training_loss(Batch(images, extr, intr, torch.ones(b, v, dtype=torch.bool)),
                                   2, d)
    loss.backward()
    ddim = sampling.DDIM.from_cfg(config["model"]["scheduler"])
    want = training.loss(ref, ddim, images, extr, intr, 2,
                         {k: getattr(d, k) for k in d.__dataclass_fields__})
    want.backward()
    assert abs(loss.item() - want.item()) <= 1e-5 * abs(want.item())
    port = dict(engine.unet.named_parameters())
    for name, p in ref.denoiser.named_parameters():
        got, want = port[name].grad, p.grad
        got = torch.zeros_like(p) if got is None else got
        want = torch.zeros_like(p) if want is None else want
        assert torch.allclose(got, want, rtol=1e-3, atol=1e-6), name


def test_flop_count_is_the_same_whichever_attention_the_port_takes(monkeypatch):
    """The count is taken on the reference on the meta device, so rerouting
    the port's attention (fused kernels on or off) leaves it as it was."""
    import mvldm_tpu_torch.models.layers as layers

    config = tiny_config()
    before = Counter(config).unet(2, 3, 8)
    monkeypatch.setattr(layers, "use_fused", lambda c, dtype: False)
    after = Counter(config).unet(2, 3, 8)
    assert before == after > 0
    # Two views attend jointly, so a scene of two costs more than two of one.
    assert Counter(config).unet(1, 2, 8) > 2 * Counter(config).unet(1, 1, 8)


def test_the_fp8_control_rounds_in_the_forward_only():
    """A gradient passes the control's rounding unrounded: gradients of
    ~1e-7 neither flush to zero nor come back on the e4m3 grid."""
    from benchmark.reference.numerics import to_e4m3

    x = torch.randn(64, generator=torch.Generator().manual_seed(SEED), requires_grad=True)
    y = to_e4m3(x)
    assert 0 < (y - x).abs().max() < 0.1 * x.abs().max()
    grad = torch.linspace(1e-7, 3e-7, 64)
    y.backward(grad)
    assert torch.equal(x.grad, grad)
