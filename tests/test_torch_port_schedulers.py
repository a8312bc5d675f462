"""The port's schedulers: DDIM against the hard-coded goldens of
tests/test_schedulers.py (float64 closed forms, derived independently of
either implementation), and DDIM, DDPM and the registry against the JAX
package."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mvldm_tpu.diffusion.schedulers import DDIMScheduler as JaxDDIM
from mvldm_tpu.diffusion.schedulers import DDIMSchedulerKwargs as JaxKw
from mvldm_tpu_torch.diffusion.schedulers import DDIMScheduler, DDIMSchedulerKwargs
from mvldm_tpu.diffusion.schedulers import DDPMScheduler as JaxDDPM
from mvldm_tpu.diffusion.schedulers import DDPMSchedulerKwargs as JaxDDPMKw
from mvldm_tpu.diffusion.schedulers import SchedulerCfg as JaxSchedulerCfg
from mvldm_tpu.diffusion.schedulers import get_scheduler as jax_get_scheduler
from mvldm_tpu_torch.diffusion.schedulers import (
    DDPMScheduler,
    DDPMSchedulerKwargs,
    SchedulerCfg,
    get_scheduler,
)

LIVE_KW = DDIMSchedulerKwargs(clip_sample=False, prediction_type="epsilon")


@pytest.fixture
def sched():
    return DDIMScheduler.create(LIVE_KW, num_inference_steps=25)


def test_alpha_bar_literals(sched):
    abar = sched.alphas_cumprod.double().numpy()
    np.testing.assert_allclose(abar[0], 0.9999, rtol=1e-6)
    np.testing.assert_allclose(abar[1], 0.9997800920720721, rtol=1e-6)
    np.testing.assert_allclose(abar[500], 0.07779665836502386, rtol=1e-5)
    np.testing.assert_allclose(abar[999], 4.0358297653756754e-05, rtol=1e-4)
    assert sched.final_alpha_cumprod == 1.0


def test_leading_timesteps_25_literal(sched):
    assert sched.timesteps().tolist() == list(range(960, -1, -40))


def test_ddim_step_literal(sched):
    prev = sched.step(torch.full((1, 2, 2, 1), 0.5), 960, torch.full((1, 2, 2, 1), 1.0))
    np.testing.assert_allclose(prev.numpy(), 1.2313372821957966, rtol=2e-4)


def test_ddim_final_step_literal(sched):
    prev = sched.step(torch.full((3,), 0.5), 0, torch.full((3,), 1.0))
    np.testing.assert_allclose(prev.numpy(), 0.9950497537315612, rtol=1e-5)


def test_add_noise_literal(sched):
    out = sched.add_noise(torch.ones(1, 4), torch.full((1, 4), 0.5), torch.tensor([500]))
    np.testing.assert_allclose(out.numpy(), 0.7590776178948713, rtol=1e-5)


@pytest.mark.parametrize("t", [960, 480, 40, 0])
def test_step_matches_jax(sched, t):
    rng = np.random.default_rng(t)
    x = rng.standard_normal((2, 3, 4, 4, 4)).astype(np.float32)
    eps = rng.standard_normal((2, 3, 4, 4, 4)).astype(np.float32)
    jax_sched = JaxDDIM.create(JaxKw(clip_sample=False), num_inference_steps=25)
    ref = np.asarray(jax_sched.step(jnp.asarray(eps), t, jnp.asarray(x)))
    got = sched.step(torch.from_numpy(eps), t, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------------- DDPM

CONFIGS = Path(__file__).resolve().parent.parent / "configs" / "model" / "scheduler"


@pytest.mark.parametrize("variance_type,clip", [
    ("fixed_small", False), ("fixed_small_log", False), ("fixed_large", False),
    ("fixed_small", True)])
@pytest.mark.parametrize("t", [999, 500, 100, 0])
def test_ddpm_step_matches_jax(variance_type, clip, t):
    kw = dict(variance_type=variance_type, clip_sample=clip)
    jax_sched = JaxDDPM.create(JaxDDPMKw(**kw), num_inference_steps=10)
    sched = DDPMScheduler.create(DDPMSchedulerKwargs(**kw), num_inference_steps=10)
    rng = np.random.default_rng(t)
    x = rng.standard_normal((2, 3, 4, 4, 4)).astype(np.float32)
    eps = rng.standard_normal((2, 3, 4, 4, 4)).astype(np.float32)
    key = jax.random.PRNGKey(t)
    z = np.array(jax.random.normal(key, x.shape, dtype=jnp.float32))
    for noise, jax_key in ((z, key), (None, None)):
        ref = np.asarray(jax_sched.step(jnp.asarray(eps), t, jnp.asarray(x), rng=jax_key))
        got = sched.step(torch.from_numpy(eps), t, torch.from_numpy(x),
                         noise=None if noise is None else torch.from_numpy(noise)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    if clip and t > 100:  # pred_x0 past the clip range: clipping changed the step
        unclipped = DDPMScheduler.create(DDPMSchedulerKwargs(variance_type=variance_type,
                                                             clip_sample=False), 10)
        assert not torch.allclose(unclipped.step(torch.from_numpy(eps), t, torch.from_numpy(x)),
                                  sched.step(torch.from_numpy(eps), t, torch.from_numpy(x)))


@pytest.mark.parametrize("steps", [1000, 50, 10])
def test_ddpm_timesteps_match_jax(steps):
    jax_sched = JaxDDPM.create(JaxDDPMKw(), num_inference_steps=1000)
    sched = DDPMScheduler.create(DDPMSchedulerKwargs(), num_inference_steps=1000)
    want = jax_sched.with_num_inference_steps(steps).timesteps()
    assert sched.with_num_inference_steps(steps).timesteps().tolist() == want.tolist()
    assert sched.timesteps(steps).tolist() == want.tolist()


@pytest.mark.parametrize("kind", ["ddim", "ddpm"])
def test_add_noise_and_velocity_match_jax(kind):
    if kind == "ddim":
        jax_sched, sched = JaxDDIM.create(JaxKw()), DDIMScheduler.create(DDIMSchedulerKwargs())
    else:
        jax_sched, sched = JaxDDPM.create(JaxDDPMKw()), DDPMScheduler.create(DDPMSchedulerKwargs())
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 2, 4, 4)).astype(np.float32)
    n = rng.standard_normal((3, 2, 4, 4)).astype(np.float32)
    t = np.array([999, 400, 0])
    for name in ("add_noise", "get_velocity"):
        ref = np.asarray(getattr(jax_sched, name)(jnp.asarray(x), jnp.asarray(n), jnp.asarray(t)))
        got = getattr(sched, name)(torch.from_numpy(x), torch.from_numpy(n),
                                   torch.from_numpy(t)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["ddim", "ddpm"])
def test_get_scheduler_on_the_configs(name):
    raw = yaml.safe_load((CONFIGS / f"{name}.yaml").read_text())
    ref = jax_get_scheduler(JaxSchedulerCfg(**raw))
    got = get_scheduler(SchedulerCfg(**raw))
    assert type(got).__name__ == type(ref).__name__
    np.testing.assert_array_equal(got.alphas_cumprod.numpy(), np.asarray(ref.alphas_cumprod))
    for field in ("num_train_timesteps", "prediction_type", "clip_sample", "clip_sample_range",
                  "steps_offset", "num_inference_steps", "init_noise_sigma"):
        assert getattr(got, field) == getattr(ref, field), field
    assert got.timesteps().tolist() == ref.timesteps().tolist()
    if name == "ddpm":
        assert got.variance_type == ref.variance_type == "fixed_small"
        np.testing.assert_array_equal(got.betas.numpy(), np.asarray(ref.betas))
    else:
        assert got.final_alpha_cumprod == float(ref.final_alpha_cumprod)
