"""The port's anchored video sampler must run the JAX sampler's launch plan.

The JAX ``VideoSampler`` is recorded with its device launches stubbed out
(the plan is host-side logic); the port runs for real on the tiny model.
Every frame id is written into its camera's intrinsics skew entry, so each
launch's context and target frames can be read back from the intrinsics it
was given. Per launch the plans must agree on (kind, context frames, target
frames, relative-pose index, v_t, context-table indices), and the pending
(row, scene, frame) lists that ``gather`` reads must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvldm_tpu.diffusion.video_sampling import SceneViews as JaxScene
from mvldm_tpu.diffusion.video_sampling import VideoSampler as JaxSampler
from mvldm_tpu_torch.diffusion.video_sampling import SceneViews, VideoSampler

from tests.test_torch_goldens import checkpoint  # noqa: F401
from tests.test_torch_port_engine import port_engine

HW = 32


def make_scene(n_target: int):
    rng = np.random.default_rng(0)
    n = n_target + 1
    images = rng.uniform(size=(n, HW, HW, 3)).astype(np.float32)
    extr = np.repeat(np.eye(4, dtype=np.float32)[None], n, axis=0)
    extr[:, 0, 3] = np.linspace(0, 1, n)
    intr = np.repeat(np.eye(3, dtype=np.float32)[None], n, axis=0)
    intr[:, 0, 2] = intr[:, 1, 2] = 0.5
    intr[:, 0, 1] = np.arange(n) * 1e-3  # frame id in the skew entry
    return (images[:1], extr[:1], intr[:1], np.arange(1)), \
        (images[1:], extr[1:], intr[1:], np.arange(1, n))


def _ids(intr) -> list:
    return np.rint(np.asarray(intr)[..., 0, 1] * 1000).astype(int).tolist()


def record_jax(monkeypatch, ctx, tgt, num_anchors, max_groups):
    plan = []
    orig = JaxSampler._make_launch

    def make_launch(self, tgt_extr, tgt_intr, mesh):
        launch = orig(self, tgt_extr, tgt_intr, mesh)

        def rec(ctx_imgs, c_extr, c_intr, pos_padded, rel_index, v_t, k):
            plan.append(("launch", np.asarray(pos_padded).tolist(), rel_index, v_t))
            return launch(ctx_imgs, c_extr, c_intr, pos_padded, rel_index, v_t, k)

        return rec

    monkeypatch.setattr(JaxSampler, "_make_launch", make_launch)
    sampler = JaxSampler(None, None, None, num_anchors_views=num_anchors,
                         max_parallel_groups=max_groups)

    def sample(unet_params, vae_params, ctx_u8, extr, intr, num_target_views, rng):
        plan.append(("anchor", _ids(intr), num_target_views))
        return jnp.zeros((ctx_u8.shape[0], num_target_views, HW, HW, 3), jnp.uint8)

    def sample_indexed(unet_params, vae_params, tables, ctx_idx, extr, intr,
                       num_target_views, rng):
        plan.append(("fill", np.asarray(ctx_idx).tolist(), _ids(intr), num_target_views))
        s, g = ctx_idx.shape[:2]
        return jnp.zeros((s * g, num_target_views, HW, HW, 3), jnp.uint8)

    sampler._sample = sample
    sampler._sample_indexed_scenes = sample_indexed
    pending = sampler.dispatch_anchored(JaxScene(*ctx), JaxScene(*tgt),
                                       rng=jax.random.PRNGKey(0))
    return plan, [rows for _, rows in pending]


def record_port(monkeypatch, engine, ctx, tgt, num_anchors, max_groups):
    plan = []
    orig_make = VideoSampler._make_launch
    orig_sample = VideoSampler._sample
    orig_indexed = VideoSampler._sample_indexed_scenes

    def make_launch(self, tgt_extr, tgt_intr):
        launch = orig_make(self, tgt_extr, tgt_intr)

        def rec(ctx_imgs, c_extr, c_intr, pos_padded, rel_index, v_t, generator):
            plan.append(("launch", np.asarray(pos_padded).tolist(), rel_index, v_t))
            return launch(ctx_imgs, c_extr, c_intr, pos_padded, rel_index, v_t, generator)

        return rec

    def sample(self, ctx_u8, extr, intr, num_target_views, generator):
        plan.append(("anchor", _ids(intr), num_target_views))
        return orig_sample(self, ctx_u8, extr, intr, num_target_views, generator)

    def sample_indexed(self, tables, ctx_idx, extr, intr, num_target_views, generator):
        plan.append(("fill", ctx_idx.tolist(), _ids(intr), num_target_views))
        return orig_indexed(self, tables, ctx_idx, extr, intr, num_target_views, generator)

    monkeypatch.setattr(VideoSampler, "_make_launch", make_launch)
    monkeypatch.setattr(VideoSampler, "_sample", sample)
    monkeypatch.setattr(VideoSampler, "_sample_indexed_scenes", sample_indexed)
    sampler = VideoSampler(engine, num_anchors_views=num_anchors,
                           max_parallel_groups=max_groups)
    pending = sampler.dispatch_anchored(SceneViews(*ctx), SceneViews(*tgt),
                                        torch.Generator().manual_seed(0))
    return plan, [rows for _, rows in pending], VideoSampler.gather(pending)


@pytest.mark.parametrize("n_target,num_anchors,max_groups", [(11, 4, 2), (17, 8, 16)])
def test_anchored_plan_matches_jax(monkeypatch, checkpoint, n_target, num_anchors,  # noqa: F811
                                   max_groups):
    ctx, tgt = make_scene(n_target)
    jax_plan, jax_rows = record_jax(monkeypatch, ctx, tgt, num_anchors, max_groups)
    engine = port_engine(checkpoint[0], "auto", steps=2)
    plan, rows, frames = record_port(monkeypatch, engine, ctx, tgt, num_anchors,
                                     max_groups)
    assert any(p[0] == "fill" for p in plan)
    assert plan == jax_plan
    assert rows == jax_rows
    assert sorted(frames) == list(range(1, n_target + 1))
    for img in frames.values():
        assert img.shape == (HW, HW, 3) and img.dtype == np.uint8
