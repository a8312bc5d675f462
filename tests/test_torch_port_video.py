"""The port's video sampler must run the JAX sampler's launch plan, anchored
and autoregressive.

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


def make_scene(n_target: int, first_id: int = 0):
    rng = np.random.default_rng(first_id)
    n = n_target + 1
    ids = np.arange(first_id, first_id + n)
    images = rng.uniform(size=(n, HW, HW, 3)).astype(np.float32)
    extr = np.repeat(np.eye(4, dtype=np.float32)[None], n, axis=0)
    extr[:, 0, 3] = np.linspace(0, 1, n)
    intr = np.repeat(np.eye(3, dtype=np.float32)[None], n, axis=0)
    intr[:, 0, 2] = intr[:, 1, 2] = 0.5
    intr[:, 0, 1] = ids * 1e-3  # frame id in the skew entry
    return (images[:1], extr[:1], intr[:1], ids[:1]), \
        (images[1:], extr[1:], intr[1:], ids[1:])


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


HL = HW // 8


def record_jax_ar(monkeypatch, scenes, num_anchors, limit, feed, single):
    """The JAX autoregressive plan with every device call stubbed."""
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
                         ar_latent_feedthrough=feed)

    def sample(unet_params, vae_params, ctx_u8, extr, intr, num_target_views, rng):
        plan.append(("sample", _ids(intr), num_target_views))
        return jnp.zeros((ctx_u8.shape[0], num_target_views, HW, HW, 3), jnp.uint8)

    def encode(vae_params, ctx_u8, rng):
        plan.append(("encode", tuple(ctx_u8.shape)))
        return jnp.zeros(ctx_u8.shape[:2] + (HL, HL, 4), jnp.float32)

    def sample_latents(unet_params, ctx_lat, extr, intr, num_target_views, rng):
        plan.append(("latents", _ids(intr), num_target_views, ctx_lat.shape[1]))
        return jnp.zeros((ctx_lat.shape[0], num_target_views, HL, HL, 4), jnp.float32)

    def decode(vae_params, latents):
        plan.append(("decode", tuple(latents.shape)))
        return jnp.zeros(latents.shape[:2] + (HW, HW, 3), jnp.uint8)

    sampler._sample, sampler._encode_ctx = sample, encode
    sampler._sample_latents, sampler._decode_u8 = sample_latents, decode
    if single:
        pending = sampler.dispatch_autoregressive(
            JaxScene(*scenes[0][0]), JaxScene(*scenes[0][1]), jax.random.PRNGKey(0),
            limit_frames=limit)
    else:
        pending = sampler.dispatch_autoregressive_many(
            [(JaxScene(*c), JaxScene(*t)) for c, t in scenes], jax.random.PRNGKey(0),
            limit_frames=limit)
    return plan, [rows for _, rows in pending]


def record_port_ar(monkeypatch, engine, scenes, num_anchors, limit, feed, single):
    plan = []
    orig_make = VideoSampler._make_launch
    orig = {name: getattr(VideoSampler, name)
            for name in ("_sample", "_encode_ctx", "_sample_latents", "_decode_u8")}

    def make_launch(self, tgt_extr, tgt_intr):
        launch = orig_make(self, tgt_extr, tgt_intr)

        def rec(ctx_imgs, c_extr, c_intr, pos_padded, rel_index, v_t, generator):
            plan.append(("launch", np.asarray(pos_padded).tolist(), rel_index, v_t))
            return launch(ctx_imgs, c_extr, c_intr, pos_padded, rel_index, v_t, generator)

        return rec

    def sample(self, ctx_u8, extr, intr, v_t, generator):
        plan.append(("sample", _ids(intr), v_t))
        return orig["_sample"](self, ctx_u8, extr, intr, v_t, generator)

    def encode(self, ctx_u8, generator):
        plan.append(("encode", tuple(ctx_u8.shape)))
        return orig["_encode_ctx"](self, ctx_u8, generator)

    def sample_latents(self, ctx_lat, extr, intr, v_t, generator):
        plan.append(("latents", _ids(intr), v_t, ctx_lat.shape[1]))
        return orig["_sample_latents"](self, ctx_lat, extr, intr, v_t, generator)

    def decode(self, latents):
        plan.append(("decode", tuple(latents.shape)))
        return orig["_decode_u8"](self, latents)

    monkeypatch.setattr(VideoSampler, "_make_launch", make_launch)
    for name, fn in (("_sample", sample), ("_encode_ctx", encode),
                     ("_sample_latents", sample_latents), ("_decode_u8", decode)):
        monkeypatch.setattr(VideoSampler, name, fn)
    sampler = VideoSampler(engine, num_anchors_views=num_anchors,
                           ar_latent_feedthrough=feed)
    gen = torch.Generator().manual_seed(0)
    if single:
        pending = sampler.dispatch_autoregressive(
            SceneViews(*scenes[0][0]), SceneViews(*scenes[0][1]), gen, limit_frames=limit)
        frames = [VideoSampler.gather(pending)]
    else:
        pending = sampler.dispatch_autoregressive_many(
            [(SceneViews(*c), SceneViews(*t)) for c, t in scenes], gen, limit_frames=limit)
        frames = VideoSampler.gather_many(pending, len(scenes))
    return plan, [rows for _, rows in pending], frames


@pytest.mark.parametrize("limit", [4, 7, 11])
@pytest.mark.parametrize("n_scenes,feed,single", [
    (1, False, True), (1, False, False), (2, False, False),
    (1, True, False), (2, True, False)])
def test_autoregressive_plan_matches_jax(monkeypatch, checkpoint, limit, n_scenes,  # noqa: F811
                                         feed, single):
    scenes = [make_scene(12, first_id=100 * i) for i in range(n_scenes)]
    jax_plan, jax_rows = record_jax_ar(monkeypatch, scenes, 4, limit, feed, single)
    engine = port_engine(checkpoint[0], "auto", steps=1)
    plan, rows, frames = record_port_ar(monkeypatch, engine, scenes, 4, limit, feed, single)
    assert plan == jax_plan
    assert rows == jax_rows
    kinds = {p[0] for p in plan}
    assert kinds == ({"encode", "latents", "decode"} if feed
                     else {"sample"} if single else {"launch", "sample"})
    for i, scene_frames in enumerate(frames):
        assert sorted(scene_frames) == list(range(100 * i + 1, 100 * i + 1 + limit))
        for img in scene_frames.values():
            assert img.shape == (HW, HW, 3) and img.dtype == np.uint8


def test_single_scene_autoregressive_equals_scene_batch(checkpoint):  # noqa: F811
    """At S = 1 the scene-batched chain makes the single-scene chain's
    launches with the same draws: the same frames, bit for bit."""
    engine = port_engine(checkpoint[0], "auto", steps=1)
    ctx, tgt = make_scene(7)
    sampler = VideoSampler(engine)
    one = sampler.sample_autoregressive(SceneViews(*ctx), SceneViews(*tgt),
                                        torch.Generator().manual_seed(3))
    [many] = sampler.sample_autoregressive_many([(SceneViews(*ctx), SceneViews(*tgt))],
                                                torch.Generator().manual_seed(3))
    assert sorted(one) == sorted(many) == list(range(1, 8))
    for f in one:
        np.testing.assert_array_equal(one[f], many[f])
