"""The port's standard cross-view block (``multi_view_attention: standard``)
against the JAX module, fp32 on CPU: the block alone with its Flax
parameters carried across by ``jax_to_torch_state_dict``, for each of
downscale 1 and 2, position encoding on and off, with a view mask; then a
tiny UNet built with ``name: standard`` through the DDIM loop."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvldm_tpu.diffusion.engine import DiffusionEngine as JaxEngine
from mvldm_tpu.diffusion.engine import ModelCfg as JaxModelCfg
from mvldm_tpu.diffusion.schedulers import DDIMScheduler as JaxDDIM
from mvldm_tpu.diffusion.schedulers import DDIMSchedulerKwargs as JaxDDIMKw
from mvldm_tpu.models.standard_transformer import CrossAttentionCfg as JaxStdCfg
from mvldm_tpu.models.standard_transformer import StandardTransformer as JaxStd
from mvldm_tpu.models.standard_transformer import position_embedding_sine as jax_pos
from mvldm_tpu.models.unet import MultiViewUNet as JaxUNet
from mvldm_tpu.models.unet import MultiViewUNetCfg as JaxUNetCfg
from mvldm_tpu.models.vae import AutoencoderCfg as JaxAECfg
from mvldm_tpu_torch.builder import MVLDM
from mvldm_tpu_torch.diffusion.engine import DiffusionEngine
from mvldm_tpu_torch.diffusion.schedulers import DDIMScheduler, DDIMSchedulerKwargs
from mvldm_tpu_torch.models.standard_transformer import (
    CrossAttentionCfg,
    StandardTransformer,
    position_embedding_sine,
)
from mvldm_tpu_torch.utils.weight_convert import jax_to_torch_state_dict

from tests.test_sampling_goldens import B, HL, STEPS, V_C, V_T, scene_cameras
from tests.test_torch_goldens import BACKBONE, IN_CH, OUT_CH, VAE_CFG
from tests.test_torch_port_models import port_model_cfg

PREFIX = "denoiser.cross_attn_blocks_encoder.0."


def block_state_dict(params) -> dict:
    """The block's Flax tree, named as the UNet's first encoder cross-view
    block so the converter's rules apply, with that prefix taken off."""
    sd = jax_to_torch_state_dict({"unet": {"down_0_cross_view": params}})
    assert all(k.startswith(PREFIX) for k in sd)
    return {k[len(PREFIX):]: v for k, v in sd.items()}


def test_position_embedding_matches_jax():
    np.testing.assert_array_equal(position_embedding_sine(5, 7, 16), jax_pos(5, 7, 16))


@pytest.mark.parametrize("downscale", [1, 2])
@pytest.mark.parametrize("pos_enc", [False, True])
def test_block_matches_jax(downscale, pos_enc):
    b, v, h, w, c = 2, 3, 8, 8, 32
    kw = dict(num_heads=4, num_layers=2, downscale=downscale, pos_enc=pos_enc,
              d_mlp_multiplier=2)
    rng = np.random.default_rng(downscale + 2 * pos_enc)
    x = rng.normal(size=(b, v, h, w, c)).astype(np.float32)
    mask = np.array([[True, True, True], [False, True, True]])
    jax_block = JaxStd(JaxStdCfg(**kw))
    params = jax_block.init(jax.random.PRNGKey(downscale), jnp.asarray(x))["params"]
    ref = np.asarray(jax_block.apply({"params": params}, jnp.asarray(x),
                                     view_mask=jnp.asarray(mask)))

    block = StandardTransformer(CrossAttentionCfg(**kw), c)
    block.load_state_dict(block_state_dict(params), strict=True)
    with torch.no_grad():
        got = block(torch.from_numpy(x), view_mask=torch.from_numpy(mask)).numpy()
    assert np.abs(ref).mean() > 1e-2
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    # The mask matters: the first row's context view feeds its targets.
    with torch.no_grad():
        unmasked = block(torch.from_numpy(x)).numpy()
    assert np.abs(unmasked[1] - got[1]).max() > 1e-3
    np.testing.assert_allclose(unmasked[0], got[0], rtol=2e-5, atol=2e-5)


def test_unet_ddim_loop_matches_jax():
    """A tiny UNet with ``name: standard`` cross-view blocks: Flax-initialised
    parameters carried across, the same injected noise and context latents."""
    std = dict(num_heads=4, downscale=1)
    jax_unet_cfg = JaxUNetCfg(autoencoder=BACKBONE, multi_view_attention=JaxStdCfg(**std))
    jax_unet = JaxUNet(jax_unet_cfg, in_channels=IN_CH, out_channels=OUT_CH)
    x0 = jnp.zeros((1, 2, HL, HL, IN_CH))
    params = jax.jit(jax_unet.init)(jax.random.PRNGKey(3), x0,
                                    jnp.zeros((1, 2), jnp.int32))["params"]
    jax_cfg = JaxModelCfg(denoiser=jax_unet_cfg, autoencoder=JaxAECfg(kwargs=VAE_CFG),
                          use_cfg=True, cfg_scale=3.0, use_ray_encoding=False)
    jax_engine = JaxEngine(jax_cfg, jax_unet, None,
                           JaxDDIM.create(JaxDDIMKw(clip_sample=False), STEPS),
                           cfg_mode="batched")

    cfg = port_model_cfg()
    cfg.denoiser = dataclasses.replace(cfg.denoiser, multi_view_attention=CrossAttentionCfg(**std))
    model = MVLDM(cfg)
    sd = jax_to_torch_state_dict({"unet": params})
    model.denoiser.load_state_dict({k[len("denoiser."):]: v for k, v in sd.items()},
                                   strict=True)
    assert isinstance(model.denoiser.cross_attn_blocks_mid[0], StandardTransformer)
    engine = DiffusionEngine(cfg, model.denoiser.eval(), model.autoencoder,
                             DDIMScheduler.create(DDIMSchedulerKwargs(clip_sample=False), STEPS),
                             cfg_mode="batched")

    extr, intr = scene_cameras()
    rng = np.random.default_rng(5)
    ctx = rng.normal(size=(B, V_C, HL, HL, 4)).astype(np.float32)
    noise = rng.normal(size=(B, V_T, HL, HL, 4)).astype(np.float32)
    ref = np.asarray(jax.jit(jax_engine.sample_latents, static_argnames=("num_target_views",))(
        params, jnp.asarray(ctx), jnp.asarray(extr), jnp.asarray(intr),
        num_target_views=V_T, rng=jax.random.PRNGKey(0), initial_noise=jnp.asarray(noise)))
    got = engine.sample_latents(torch.from_numpy(ctx), torch.from_numpy(extr),
                                torch.from_numpy(intr), V_T,
                                initial_noise=torch.from_numpy(noise)).numpy()
    assert np.abs(ref).mean() > 1e-2
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)
