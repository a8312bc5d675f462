"""The port's DDIM scheduler against the hard-coded goldens of
tests/test_schedulers.py (float64 closed forms, derived independently of
either implementation) and against the JAX scheduler."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvldm_tpu.diffusion.schedulers import DDIMScheduler as JaxDDIM
from mvldm_tpu.diffusion.schedulers import DDIMSchedulerKwargs as JaxKw
from mvldm_tpu_torch.diffusion.schedulers import DDIMScheduler, DDIMSchedulerKwargs

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
