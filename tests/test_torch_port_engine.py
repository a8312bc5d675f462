"""The port's sampling engine, geometry and ray encodings against the JAX
package, fp32 on CPU: a full tiny DDIM loop with injected noise and context
latents in batched and sequential CFG, and the ray channels of every
encoding option."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvldm_tpu.diffusion.engine import ModelCfg as JaxModelCfg
from mvldm_tpu.geometry.camera_utils import absolute_to_relative_camera as jax_rel
from mvldm_tpu.geometry.projection import get_world_rays as jax_rays
from mvldm_tpu.geometry.projection import sample_image_grid as jax_grid
from mvldm_tpu_torch.diffusion.engine import DiffusionEngine, ModelCfg, unet_in_channels
from mvldm_tpu_torch.diffusion.schedulers import DDIMScheduler, DDIMSchedulerKwargs
from mvldm_tpu_torch.geometry.camera_utils import absolute_to_relative_camera
from mvldm_tpu_torch.geometry.projection import get_world_rays, sample_image_grid

from tests.test_sampling_goldens import B, HL, STEPS, V_C, V_T, build_engine, scene_cameras
from tests.test_torch_goldens import IN_CH, checkpoint  # noqa: F401
from tests.test_torch_port_models import load_port_model, port_model_cfg


def port_engine(ckpt, cfg_mode: str, steps: int = STEPS) -> DiffusionEngine:
    model = load_port_model(ckpt)
    scheduler = DDIMScheduler.create(DDIMSchedulerKwargs(clip_sample=False),
                                     num_inference_steps=steps)
    cfg = port_model_cfg()
    assert unet_in_channels(cfg) == IN_CH
    return DiffusionEngine(cfg, model.denoiser, model.autoencoder, scheduler,
                           cfg_mode=cfg_mode)


@pytest.mark.parametrize("cfg_mode", ["sequential", "batched"])
def test_ddim_loop_matches_jax_engine(checkpoint, cfg_mode):  # noqa: F811
    ckpt, params = checkpoint
    extr, intr = scene_cameras()
    rng = np.random.default_rng(11)
    ctx_latents = rng.normal(size=(B, V_C, HL, HL, 4)).astype(np.float32)
    noise = rng.normal(size=(B, V_T, HL, HL, 4)).astype(np.float32)

    jax_engine = build_engine(cfg_mode)
    ref = np.asarray(jax.jit(jax_engine.sample_latents,
                             static_argnames=("num_target_views",))(
        params["unet"], jnp.asarray(ctx_latents), jnp.asarray(extr),
        jnp.asarray(intr), num_target_views=V_T, rng=jax.random.PRNGKey(0),
        initial_noise=jnp.asarray(noise)))

    got = port_engine(ckpt, cfg_mode).sample_latents(
        torch.from_numpy(ctx_latents), torch.from_numpy(extr), torch.from_numpy(intr),
        V_T, initial_noise=torch.from_numpy(noise)).numpy()
    assert got.shape == ref.shape == (B, V_T, HL, HL, 4)
    assert np.abs(ref).mean() > 1e-2
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)


def test_auto_cfg_threshold(checkpoint):  # noqa: F811
    engine = port_engine(checkpoint[0], "auto")
    assert engine._resolve_cfg_mode(2) == "batched"
    assert engine._resolve_cfg_mode(3) == "sequential"


@pytest.mark.parametrize("option", ["raw", "octaves", "srt", "plucker"])
def test_ray_encode_matches_jax(checkpoint, option):  # noqa: F811
    from mvldm_tpu.diffusion.engine import DiffusionEngine as JaxEngine

    kw = dict(use_ray_encoding=option == "octaves", srt_ray_encoding=option == "srt",
              use_plucker=option == "plucker")
    engine = port_engine(checkpoint[0], "auto")
    engine.cfg = ModelCfg(**kw)
    jax_engine = JaxEngine(JaxModelCfg(**kw), None, None, None)
    rng = np.random.default_rng(3)
    extr, intr = scene_cameras()
    extr[..., :3, 3] += rng.normal(size=extr[..., :3, 3].shape).astype(np.float32) * 0.3
    ref = np.asarray(jax_engine.ray_encode(jnp.asarray(extr), jnp.asarray(intr), (4, 6)))
    got = engine.ray_encode(torch.from_numpy(extr), torch.from_numpy(intr), (4, 6)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5)


def test_geometry_matches_jax():
    rng = np.random.default_rng(0)
    xy_t, idx_t = sample_image_grid((3, 5))
    xy_j, idx_j = jax_grid((3, 5))
    np.testing.assert_allclose(xy_t.numpy(), np.asarray(xy_j), atol=1e-7)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    q, _ = np.linalg.qr(rng.normal(size=(2, 4, 3, 3)))
    extr = np.tile(np.eye(4), (2, 4, 1, 1))
    extr[..., :3, :3] = q
    extr[..., :3, 3] = rng.normal(size=(2, 4, 3))
    extr = extr.astype(np.float32)
    intr = np.tile(np.eye(3, dtype=np.float32), (2, 4, 1, 1))
    intr[..., 0, 0], intr[..., 1, 1], intr[..., :2, 2] = 0.9, 1.2, 0.5
    pts = rng.random((2, 4, 7, 2)).astype(np.float32)
    o_t, d_t = get_world_rays(torch.from_numpy(pts), torch.from_numpy(extr)[:, :, None],
                              torch.from_numpy(intr)[:, :, None])
    o_j, d_j = jax_rays(jnp.asarray(pts), jnp.asarray(extr)[:, :, None],
                        jnp.asarray(intr)[:, :, None])
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-6)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-5)
    for index in (0, 2):
        np.testing.assert_allclose(
            absolute_to_relative_camera(torch.from_numpy(extr), index).numpy(),
            np.asarray(jax_rel(jnp.asarray(extr), index)), atol=2e-5)
