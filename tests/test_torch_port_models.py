"""Port models (mvldm_tpu_torch/models) against the JAX package, fp32 CPU.

One synthetic reference Lightning checkpoint (random weights, real key
layout, tests/test_torch_goldens.py's tiny topology) loads into the port
with ``load_state_dict`` and into the JAX package through
``convert_mvldm_checkpoint``; the same numpy inputs go through both.
"""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvldm_tpu.models.layers import Transformer2D as JaxTransformer2D
from mvldm_tpu.models.mv_attention import SpatialTransformer3D as JaxST3D
from mvldm_tpu.models.mv_attention import SpatialTransformer3DCfg as JaxST3DCfg
from mvldm_tpu.models.unet import MultiViewUNet as JaxUNet
from mvldm_tpu.models.unet import MultiViewUNetCfg as JaxUNetCfg
from mvldm_tpu.models.vae import AutoencoderKL as JaxVAE
from mvldm_tpu_torch.builder import MVLDM
from mvldm_tpu_torch.diffusion.engine import ModelCfg
from mvldm_tpu_torch.models.mv_attention import SpatialTransformer3DCfg
from mvldm_tpu_torch.models.unet import MultiViewUNetCfg, UNetBackboneCfg
from mvldm_tpu_torch.models.vae import AutoencoderCfg, AutoencoderKLCfg

from tests.test_torch_goldens import (  # noqa: F401  (module-scoped fixture)
    BACKBONE,
    IN_CH,
    MV_HEADS,
    OUT_CH,
    VAE_CFG,
    checkpoint,
)

IGNORED = re.compile(r"^denoiser\.unet\.up_blocks\.\d+\.attentions\.")


def port_model_cfg(**overrides) -> ModelCfg:
    """The tiny topology as the port's ModelCfg."""
    return ModelCfg(
        denoiser=MultiViewUNetCfg(
            autoencoder=UNetBackboneCfg(**dataclasses.asdict(BACKBONE)),
            multi_view_attention=SpatialTransformer3DCfg(num_heads=MV_HEADS),
        ),
        autoencoder=AutoencoderCfg(kwargs=AutoencoderKLCfg(**dataclasses.asdict(VAE_CFG))),
        use_cfg=True,
        cfg_scale=3.0,
        use_ray_encoding=False,
        **overrides,
    )


def load_port_model(ckpt, **overrides) -> MVLDM:
    """The tiny port model with the checkpoint loaded (up-block SD attentions
    are unused by the live path and not part of the model)."""
    model = MVLDM(port_model_cfg(**overrides))
    sd = {k: v for k, v in ckpt.items() if not IGNORED.match(k)}
    model.load_state_dict(sd, strict=True)
    return model.eval()


def jax_unet_cfg():
    return JaxUNetCfg(autoencoder=BACKBONE,
                      multi_view_attention=JaxST3DCfg(num_heads=MV_HEADS))


def _np(x):
    return np.asarray(x, dtype=np.float32)


@pytest.fixture(scope="module")
def port(checkpoint):  # noqa: F811
    return load_port_model(checkpoint[0])


def test_spatial_transformer_3d_view_mask(checkpoint, port):  # noqa: F811
    _, params = checkpoint
    c = BACKBONE.block_out_channels[0]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 8, 8, c)).astype(np.float32)
    mask = np.asarray([[True, True, True], [False, True, True]])
    ref = JaxST3D(JaxST3DCfg(num_heads=MV_HEADS), groups=BACKBONE.norm_num_groups).apply(
        {"params": params["unet"]["down_0_cross_view"]}, jnp.asarray(x),
        view_mask=jnp.asarray(mask))
    with torch.no_grad():
        got = port.denoiser.cross_attn_blocks_encoder[0](
            torch.from_numpy(x), view_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=1e-4)


def test_transformer_2d(checkpoint, port):  # noqa: F811
    _, params = checkpoint
    c = BACKBONE.block_out_channels[0]
    heads = BACKBONE.num_attention_heads[0]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 8, c)).astype(np.float32)
    ref = JaxTransformer2D(heads, c // heads, BACKBONE.cross_attention_dim,
                           groups=BACKBONE.norm_num_groups).apply(
        {"params": params["unet"]["down_0_attn_0"]}, jnp.asarray(x), None)
    with torch.no_grad():
        got = port.denoiser.unet.down_blocks[0].attentions[0](
            torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=1e-4)


def test_full_unet_batched_cfg_with_mask(checkpoint, port):  # noqa: F811
    """Two CFG rows x 3 views, per-view timesteps, the unconditional row's
    context view masked out of every cross-view attention."""
    _, params = checkpoint
    b, v, hw = 2, 3, 16
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((b, v, hw, hw, IN_CH)) * 0.5).astype(np.float32)
    t = np.asarray([[0, 250, 999], [0, 250, 999]])
    mask = np.asarray([[True, True, True], [False, True, True]])
    ref = JaxUNet(jax_unet_cfg(), in_channels=IN_CH, out_channels=OUT_CH).apply(
        {"params": params["unet"]}, jnp.asarray(x), jnp.asarray(t),
        view_mask=jnp.asarray(mask))
    with torch.no_grad():
        got = port.denoiser(torch.from_numpy(x), torch.from_numpy(t),
                            view_mask=torch.from_numpy(mask))
    assert got.shape == (b, v, hw, hw, OUT_CH)
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=3e-4)


def test_vae_encode_moments(checkpoint, port):  # noqa: F811
    _, params = checkpoint
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 64, 64, 3)) * 0.5).astype(np.float32)
    dist = JaxVAE(VAE_CFG).apply({"params": params["vae"]}, jnp.asarray(x),
                                 method=JaxVAE.encode)
    with torch.no_grad():
        got = port.autoencoder.encode(torch.from_numpy(x))
    np.testing.assert_allclose(got.mean.numpy(), _np(dist.mean), atol=3e-4)
    np.testing.assert_allclose(got.logvar.numpy(), _np(dist.logvar), atol=3e-4)


def test_vae_decode(checkpoint, port):  # noqa: F811
    _, params = checkpoint
    rng = np.random.default_rng(5)
    z = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ref = JaxVAE(VAE_CFG).apply({"params": params["vae"]}, jnp.asarray(z),
                                method=JaxVAE.decode)
    with torch.no_grad():
        got = port.autoencoder.decode(torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=3e-4)
