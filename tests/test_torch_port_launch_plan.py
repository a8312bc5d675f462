"""The forward-kernel launch counts that ``chip_smoke.py`` requires of its
sampling runs, counted again on the CPU: the engine each run's config
builds, on the meta device in bf16 (shapes only, routed as on the card),
with the three forward wrappers stubbed by counters, runs the run's
dispatch. A run's count is affine in the step count, so it is counted at 1
and 2 steps and taken to the run's steps."""

import numpy as np
import pytest
import torch

import chip_smoke
from mvldm_tpu_torch import builder, config
from mvldm_tpu_torch.diffusion.video_sampling import SceneViews, VideoSampler
from mvldm_tpu_torch.models import layers
from mvldm_tpu_torch.ops import attention as attn

NAMES = ("flash_attention", "fused_ln_self_attention", "fused_ln_geglu_ff")


@pytest.fixture
def counters(monkeypatch):
    counts = dict.fromkeys(NAMES, 0)

    def stub(name):
        def launch(x, *args, **kwargs):
            counts[name] += 1
            return torch.empty_like(x)
        return launch

    monkeypatch.setattr(attn, "flash_attention", stub("flash_attention"))
    monkeypatch.setattr(layers, "fused_ln_self_attention", stub("fused_ln_self_attention"))
    monkeypatch.setattr(layers, "fused_ln_geglu_ff", stub("fused_ln_geglu_ff"))
    return counts


def scene(n_target: int, first_id: int):
    n = n_target + 1
    images = np.random.default_rng(first_id).integers(0, 255, (n, 256, 256, 3), np.uint8)
    extr = np.repeat(np.eye(4, dtype=np.float32)[None], n, axis=0)
    extr[:, 0, 3] = np.linspace(0, 2, n)
    intr = np.repeat(np.eye(3, dtype=np.float32)[None], n, axis=0)
    intr[:, :2, 2] = 0.5
    ids = np.arange(first_id, first_id + n)
    return (SceneViews(images[:1], extr[:1], intr[:1], ids[:1]),
            SceneViews(images[1:], extr[1:], intr[1:], ids[1:]))


# run: (config overrides, steps, mode, scenes, frames of a scene, feedthrough)
RUNS = {
    "anchored": ([], 25, "anchored", 2, 8, False),
    "autoregressive": ([], 25, "autoregressive", 1, 7, False),
    "autoregressive_feedthrough": ([], 25, "autoregressive", 1, 7, True),
    "ddpm": (["model/scheduler=ddpm"], 10, "anchored", 1, 4, False),
    "standard": (["model/denoiser/multi_view_attention=standard"], 25, "anchored", 1, 4, False),
    "main_path": ([], 25, "anchored", 1, 16, False),
}


def count(counters, overrides, steps, mode, n_scenes, frames, feed) -> dict:
    cfg = config.load_typed_root_config(config.compose(
        ["+experiment=baseline", *overrides, f"model.scheduler.num_inference_steps={steps}"]))
    engine = builder.build_engine(cfg, "meta")
    assert engine.dtype == torch.bfloat16
    sampler = VideoSampler(engine, ar_latent_feedthrough=feed)
    for name in NAMES:
        counters[name] = 0
    getattr(sampler, f"dispatch_{mode}_many")(
        [scene(frames, 100 * i) for i in range(n_scenes)], None)
    return dict(counters)


@pytest.mark.parametrize("run", list(RUNS))
def test_chip_smoke_launch_counts_are_the_plans(counters, run):
    overrides, steps, mode, n_scenes, frames, feed = RUNS[run]
    one = count(counters, overrides, 1, mode, n_scenes, frames, feed)
    two = count(counters, overrides, 2, mode, n_scenes, frames, feed)
    plan = {k: one[k] + (steps - 1) * (two[k] - one[k]) for k in NAMES}
    want = chip_smoke.SCENE_LAUNCHES if run == "main_path" else chip_smoke.CLI_LAUNCHES[run]
    assert plan == want
