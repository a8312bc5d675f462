"""The port's latent cache (``data/latent_cache.py``,
``scripts/precompute_latents.py`` and the dataset's latent path) against the
JAX package's, fp32 on CPU.

* A cache written by either package reads in the other: the arrays bitwise,
  ``meta.json`` key for key.
* ``precompute_latents`` on the same weights (the tiny VAE of
  ``tests/test_torch_goldens.py``, loaded from one reference ``.ckpt``):
  every moment within one float16 step of the JAX package's, the step taken
  at the value or at 1/64 of the array's rms, whichever is larger (near
  zero the two f32 encodes differ by ~1e-7, more than a subnormal step).
* The train stage's latent examples (the flip draw, the reflected
  extrinsics, the crop shim's intrinsics) bitwise equal to the JAX
  dataset's, draw for draw, on either package's cache; val and test ignore
  the cache.
* The training loss on cached moments: equal to the image path's with the
  encoder's moments (1e-6), and within 1e-5 of the JAX loss on the same
  cached moments and draws.
* The CLI: ``precompute_latents`` then ``main mode=train
  dataset.latent_cache=...`` for two steps.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvldm_tpu.config import CheckpointingCfg as JaxCheckpointingCfg
from mvldm_tpu.config import DatasetCfg as JaxDatasetCfg
from mvldm_tpu.data import dataset_re10k as jax_ds
from mvldm_tpu.data import latent_cache as jax_cache
from mvldm_tpu.data import view_samplers as jax_vs
from mvldm_tpu.diffusion.engine import Batch as JaxBatch
from mvldm_tpu.diffusion.engine import ModelCfg as JaxModelCfg
from mvldm_tpu.models.vae import AutoencoderCfg as JaxAutoencoderCfg
from mvldm_tpu.scripts import precompute_latents as jax_pre
from mvldm_tpu_torch.config import CheckpointingCfg, DatasetCfg
from mvldm_tpu_torch.data import dataset_re10k, latent_cache, view_samplers
from mvldm_tpu_torch.data.shims import crop_shim_intrinsics, rescale_and_crop
from mvldm_tpu_torch.diffusion.engine import ModelCfg
from mvldm_tpu_torch.models.vae import AutoencoderCfg, AutoencoderKLCfg
from mvldm_tpu_torch.scripts import main as main_script
from mvldm_tpu_torch.scripts import precompute_latents

from synthetic_data import write_synthetic_dataset
from tests.test_sampling_goldens import build_engine
from tests.test_torch_goldens import VAE_CFG
from tests.test_torch_goldens import checkpoint  # noqa: F401  (module-scoped fixture)
from tests.test_torch_port_data import assert_same
from tests.test_torch_port_train_cli import TINY
from tests.test_torch_port_training import (
    HL,
    V,
    V_C,
    draws_from_key,
    make_arrays,
    port_batch,
    port_train_engine,
)

IMAGE_SHAPE = (64, 64)
PORT_VAE = AutoencoderKLCfg(**dataclasses.asdict(VAE_CFG))


@pytest.fixture(scope="module")
def caches(checkpoint, tmp_path_factory):  # noqa: F811
    """A synthetic dataset and its cache from each package, both encoded
    from one reference ``.ckpt`` (the JAX loader is handed the fixture's
    conversion, which carries the tiny topology)."""
    ckpt, params = checkpoint
    root = write_synthetic_dataset(tmp_path_factory.mktemp("re10k"), frames_per_scene=10)
    ckpt_path = tmp_path_factory.mktemp("ckpt") / "tiny.ckpt"
    torch.save({"state_dict": ckpt}, ckpt_path)
    out = {"jax": tmp_path_factory.mktemp("jax_latents"),
           "port": tmp_path_factory.mktemp("port_latents")}

    import mvldm_tpu.training.checkpoint as jax_ckpt

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_ckpt, "load_torch_checkpoint_params", lambda path: params)
        jax_pre.run(jax_pre.PrecomputeLatentsCfg(
            dataset=JaxDatasetCfg(root=root, image_shape=list(IMAGE_SHAPE)),
            model=JaxModelCfg(autoencoder=JaxAutoencoderCfg(kwargs=VAE_CFG)),
            checkpointing=JaxCheckpointingCfg(load=str(ckpt_path)),
            out=out["jax"], encode_batch=4))
    precompute_latents.run(precompute_latents.PrecomputeLatentsCfg(
        dataset=DatasetCfg(root=root, image_shape=IMAGE_SHAPE),
        model=ModelCfg(autoencoder=AutoencoderCfg(kwargs=PORT_VAE)),
        checkpointing=CheckpointingCfg(load=str(ckpt_path)),
        out=out["port"], encode_batch=4), device="cpu")
    return root, out, str(ckpt_path)


def test_caches_cross_between_the_packages(tmp_path):
    """Moments written by one package's writer read bitwise through the
    other's reader, and both writers' files hold the same arrays and
    meta."""
    rng = np.random.default_rng(0)
    scenes = {f"scene{i}": rng.normal(size=(5, 2, 4, 4, 8)).astype(np.float32) for i in range(2)}
    idx = np.array([4, 0, 2])
    dirs = {}
    for name, mod in (("jax", jax_cache), ("port", latent_cache)):
        dirs[name] = tmp_path / name
        mod.write_chunk_cache(mod.cache_file(dirs[name], "train", "000000"), scenes)
        mod.write_meta(dirs[name], "train", (32, 32), 4, 2, "ckpt:x.ckpt dtype:float32")
    for writer, reader_mod in (("jax", latent_cache), ("port", jax_cache)):
        reader = reader_mod.LatentCacheReader(dirs[writer], "train", image_shape=(32, 32))
        for scene, m in scenes.items():
            for flip in (False, True):
                got = reader.lookup("000000", scene, idx, flip)
                want = m.astype(np.float16)[idx, int(flip)].astype(np.float32)
                assert got.dtype == np.float32
                np.testing.assert_array_equal(got, want)
        assert reader.lookup("000000", "absent", idx, False) is None
    a, b = (np.load(dirs[n] / "train" / "000000.npz") for n in ("jax", "port"))
    assert a.files == b.files
    for k in a.files:
        assert a[k].dtype == b[k].dtype == np.float16
        np.testing.assert_array_equal(a[k], b[k])
    meta = [json.loads((dirs[n] / "train" / "meta.json").read_text()) for n in ("jax", "port")]
    assert meta[0] == meta[1]


def test_reader_refusals_match_jax(tmp_path):
    for mod in (jax_cache, latent_cache):
        with pytest.raises(FileNotFoundError, match="meta.json"):
            mod.LatentCacheReader(tmp_path / mod.__name__, "train")
    latent_cache.write_meta(tmp_path, "train", (32, 32), 4, 1, "f")
    with pytest.raises(ValueError, match="image_shape"):
        latent_cache.LatentCacheReader(tmp_path, "train", image_shape=(64, 64))
    reader = latent_cache.LatentCacheReader(tmp_path, "train", image_shape=(32, 32))
    latent_cache.write_chunk_cache(latent_cache.cache_file(tmp_path, "train", "c"),
                                   {"s": np.zeros((2, 1, 4, 4, 8), np.float32)})
    with pytest.raises(ValueError, match="without flip"):
        reader.lookup("c", "s", np.array([0]), True)
    with pytest.raises(FileNotFoundError, match="missing"):
        reader.lookup("other", "s", np.array([0]), False)


def test_precompute_moments_within_one_f16_step_of_jax(caches):
    root, out, ckpt_path = caches
    meta = [json.loads((out[n] / "train" / "meta.json").read_text()) for n in ("jax", "port")]
    assert meta[0] == meta[1] == {"image_shape": list(IMAGE_SHAPE), "latent_channels": 4,
                                  "n_flips": 2,
                                  "vae_fingerprint": f"ckpt:{ckpt_path} dtype:float32"}
    for stem in ("000000",):
        a, b = (np.load(out[n] / "train" / f"{stem}.npz") for n in ("jax", "port"))
        assert sorted(a.files) == sorted(b.files) and a.files
        for k in a.files:
            assert a[k].shape == b[k].shape == (10, 2, 8, 8, 8) and b[k].dtype == np.float16
            rms = np.sqrt(np.mean(a[k].astype(np.float32) ** 2))
            step = np.spacing(np.maximum(np.maximum(np.abs(a[k]), np.abs(b[k])),
                                         np.float16(rms / 64))).astype(np.float32)
            assert np.all(np.abs(a[k].astype(np.float32) - b[k].astype(np.float32)) <= step), k
            assert not np.array_equal(b[k][:, 0], b[k][:, 1])  # the flip is its own encode
    # The moments are those of the crop-shimmed pixels, flipped for index 1.
    assert sorted(p.name for p in (out["port"] / "train").iterdir()) == ["000000.npz",
                                                                          "meta.json"]


def _datasets(root, cache, stage, seed=3, **kw):
    out = []
    for mod, vs, cfg_cls in ((dataset_re10k, view_samplers, dataset_re10k.DatasetRE10kCfg),
                             (jax_ds, jax_vs, jax_ds.DatasetRE10kCfg)):
        rng = np.random.default_rng(seed)
        sampler = vs.get_view_sampler(vs.ViewSamplerBoundedCfg(
            num_context_views=2, num_target_views=3, min_distance_between_context_views=3,
            max_distance_between_context_views=8), stage, False, False, None, rng=rng)
        cfg = cfg_cls(root=root, image_shape=IMAGE_SHAPE, latent_cache=cache, **kw)
        out.append(list(mod.DatasetRE10k(cfg, stage, sampler, rng=rng)))
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_latent_examples_match_jax(caches, writer):
    """The train stage's latent examples through both datasets on one cache,
    draw for draw: moments, flip, reflected extrinsics and intrinsics."""
    root, out, _ = caches
    for seed in (3, 4, 5):
        ours, theirs = _datasets(root, out[writer], "train", seed, augment=True,
                                 random_transform_extrinsics=True)
        assert ours and all(e.context.image is None for e in ours)
        assert ours[0].context.latent_moments.shape == (2, 8, 8, 8)
        assert_same(ours, theirs)


def test_latent_examples_are_the_image_paths_encoded(caches):
    """With the augmentation on, each latent example carries the image
    path's extrinsics and intrinsics (same seed, the same flip draw) and
    moments within one float16 step of encoding the image path's pixels,
    flipped when they are."""
    root, out, ckpt_path = caches
    cfg = precompute_latents.PrecomputeLatentsCfg(
        model=ModelCfg(autoencoder=AutoencoderCfg(kwargs=PORT_VAE)),
        checkpointing=CheckpointingCfg(load=ckpt_path))
    vae = precompute_latents.build_vae(cfg, "cpu", torch.float32)
    for seed in (3, 4, 5):
        lat, _ = _datasets(root, out["port"], "train", seed, augment=True)
        img, _ = _datasets(root, None, "train", seed, augment=True)
        assert len(lat) == len(img) > 0
        for a, b in zip(lat, img):
            for va, vb in ((a.context, b.context), (a.target, b.target)):
                np.testing.assert_array_equal(va.extrinsics, vb.extrinsics)
                np.testing.assert_allclose(va.intrinsics, vb.intrinsics, rtol=1e-6)
                with torch.no_grad():
                    dist = vae.encode(torch.from_numpy(vb.image) * 2.0 - 1.0)
                want = torch.cat([dist.mean, dist.logvar], -1).half().numpy()
                rms = np.sqrt(np.mean(want.astype(np.float32) ** 2))
                step = np.spacing(np.maximum(np.abs(want), np.float16(rms / 64))
                                  ).astype(np.float32)
                assert np.all(np.abs(va.latent_moments - want) <= step)
    intr = np.tile(np.eye(3, dtype=np.float32), (2, 1, 1))
    intr[:, 0, 0], intr[:, 1, 1] = 0.9, 1.6
    _, want = rescale_and_crop(np.zeros((2, 360, 640, 3), np.float32), intr, IMAGE_SHAPE)
    np.testing.assert_array_equal(crop_shim_intrinsics(intr, (360, 640), IMAGE_SHAPE), want)


@pytest.mark.parametrize("stage", ["val", "test"])
def test_val_and_test_ignore_the_cache(caches, stage):
    root, out, _ = caches
    with_cache, _ = _datasets(root, out["port"], stage)
    without, theirs = _datasets(root, None, stage)
    assert with_cache[0].context.image.shape == (2, *IMAGE_SHAPE, 3)
    assert_same(with_cache, without)
    assert_same(with_cache, theirs)


def test_training_loss_on_cached_moments(checkpoint):  # noqa: F811
    """Exact encoder moments give the image path's loss (1e-6); float16
    cached moments give the JAX loss on the same moments and draws within
    1e-5 (f32 on both sides)."""
    arrays = make_arrays()
    key = jax.random.PRNGKey(1)
    draws = draws_from_key(key)
    engine = port_train_engine(checkpoint[0])
    b = arrays[0].shape[0]
    with torch.no_grad():
        flat = torch.from_numpy(arrays[0]).reshape(b * V, *arrays[0].shape[2:]) * 2.0 - 1.0
        dist = engine.vae.encode(flat)
        exact = torch.cat([dist.mean, dist.logvar], dim=-1).reshape(b, V, HL, HL, 8)
        image_loss, _ = engine.training_loss(port_batch(arrays), V_C, draws)
        cached = exact.half().float()
        losses = [engine.training_loss(dataclasses.replace(
            port_batch(arrays), images=None, latent_moments=m), V_C, draws)[0].item()
            for m in (exact, cached)]
    assert losses[0] == pytest.approx(image_loss.item(), rel=1e-6)

    _, params = checkpoint
    jax_engine = build_engine("auto")
    jax_batch = JaxBatch(images=None, extrinsics=jnp.asarray(arrays[1]),
                         intrinsics=jnp.asarray(arrays[2]), is_target=jnp.asarray(arrays[3]),
                         latent_moments=jnp.asarray(cached.numpy()))
    want, _ = jax_engine.training_loss(params["unet"], params["vae"], jax_batch, key, V_C)
    assert losses[1] == pytest.approx(float(want), rel=1e-5)


def test_precompute_then_train_through_the_cli(tmp_path):
    root = write_synthetic_dataset(tmp_path / "re10k", frames_per_scene=24)
    out = tmp_path / "latents"
    precompute_latents.main([
        f"dataset.root={root}", f"out={out}", "dataset.image_shape=[32,32]",
        "encode_batch=16", "allow_init_vae=true",
        "model.autoencoder.kwargs.block_out_channels=[8,8,16,16]",
        "model.autoencoder.kwargs.layers_per_block=1",
        "model.autoencoder.kwargs.norm_num_groups=4"], device="cpu")
    meta = json.loads((out / "train" / "meta.json").read_text())
    assert meta["vae_fingerprint"].startswith("random-init(seed=0, mvldm_tpu_torch)")
    assert not (out / "test").exists()  # stages: [train]
    with pytest.raises(SystemExit, match="No VAE weights"):
        precompute_latents.main([f"dataset.root={root}", f"out={tmp_path / 'x'}"],
                                device="cpu")

    run = tmp_path / "run"
    main_script.main(TINY + [f"dataset.root={root}", f"output_dir={run}", "mode=train",
                             f"dataset.latent_cache={out}", "trainer.max_steps=2",
                             "dataset.augment=true"], device="cpu")
    records = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert records[-1]["step"] == 2 and np.isfinite(records[-1]["loss/diffusion"])
