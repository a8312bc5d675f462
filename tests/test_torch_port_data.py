"""The port's data pipeline against the JAX package's on the synthetic RE10K
dataset of tests/synthetic_data.py: chunks, every view sampler, the shims,
``DatasetRE10k`` / ``DatasetRE10kV2`` examples and collated batches must be
exactly equal for the same seed, in the test and train stages."""

import dataclasses
import json

import numpy as np
import pytest

from mvldm_tpu.data import chunk_reader as jax_chunks
from mvldm_tpu.data import dataset_re10k as jax_ds
from mvldm_tpu.data import loader as jax_loader
from mvldm_tpu.data import view_samplers as jax_vs
from mvldm_tpu.data.dataset_re10kv2 import DatasetRE10kV2 as JaxV2
from mvldm_tpu.data.shims import apply_random_transform_shim as jax_random_transform
from mvldm_tpu.data.types import Example as JaxExample
from mvldm_tpu.data.types import Views as JaxViews
from mvldm_tpu_torch.data import chunk_reader, dataset_re10k, loader, view_samplers
from mvldm_tpu_torch.data.dataset_re10kv2 import DatasetRE10kV2
from mvldm_tpu_torch.data.shims import apply_random_transform_shim
from mvldm_tpu_torch.data.types import Example, Views

from synthetic_data import write_synthetic_dataset

N_FRAMES = 30


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = write_synthetic_dataset(tmp_path_factory.mktemp("re10k"),
                                   frames_per_scene=N_FRAMES)
    index = {"scenetest0000": {"context": [0, 9], "target": [1, 4, 7]},
             "scenetest0001": {"context": [2, 12], "target": [3, 5, 11]},
             "missing": None}
    (root / "eval_index.json").write_text(json.dumps(index))
    return root


def assert_same(a, b, path="root"):
    """Deep equality of examples / batches: arrays bit for bit, dataclasses
    field by field."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, (path, a, b)


def test_load_chunk_and_decode_match_jax(data_root):
    path = data_root / "test" / "000000.torch"
    ours, theirs = chunk_reader.load_chunk(path), jax_chunks.load_chunk(path)
    assert [s["key"] for s in ours] == [s["key"] for s in theirs] == [
        "scenetest0000", "scenetest0001"]
    for a, b in zip(ours, theirs):
        assert_same(a["cameras"], b["cameras"])
        assert len(a["images"]) == len(b["images"]) == N_FRAMES
        for i in (0, 17):
            assert_same(chunk_reader.decode_jpeg_bytes(a["images"][i]),
                        jax_chunks.decode_jpeg_bytes(b["images"][i]))
        assert_same(chunk_reader.convert_poses(a["cameras"]),
                    jax_chunks.convert_poses(b["cameras"]))


def test_save_chunk_round_trip(tmp_path, data_root):
    scenes = chunk_reader.load_chunk(data_root / "test" / "000000.torch")
    chunk_reader.save_chunk(scenes, tmp_path / "copy.torch")
    back = jax_chunks.load_chunk(tmp_path / "copy.torch")
    for a, b in zip(scenes, back):
        assert a["key"] == b["key"]
        assert_same(a["cameras"], b["cameras"])
        assert [bytes(np.asarray(x)) for x in a["images"]] == \
            [bytes(np.asarray(x)) for x in b["images"]]


SAMPLERS = [
    ("bounded", dict(num_context_views=2, num_target_views=3,
                     min_distance_between_context_views=5,
                     max_distance_between_context_views=15,
                     max_distance_to_context_views=2)),
    ("bounded", dict(num_context_views=2, num_target_views=2, context_gap_warm_up_steps=100,
                     target_gap_warm_up_steps=50, min_distance_between_context_views=4,
                     max_distance_between_context_views=20,
                     initial_max_distance_between_context_views=6,
                     max_distance_to_context_views=3)),
    ("arbitrary", dict(num_context_views=2, num_target_views=3)),
    ("arbitrary", dict(num_context_views=2, num_target_views=1, context_views=[3, 8],
                       target_views=[5])),
    ("random", dict(num_context_views=2, num_target_views=4)),
    ("all", dict()),
    ("evaluation", dict()),
]
CFG_CLASS = {"bounded": "ViewSamplerBoundedCfg", "arbitrary": "ViewSamplerArbitraryCfg",
             "random": "ViewSamplerRandomCfg", "all": "ViewSamplerAllCfg",
             "evaluation": "ViewSamplerEvaluationCfg"}


def sampler_cfgs(name, kw, data_root):
    if name == "evaluation":
        kw = dict(index_path=data_root / "eval_index.json")
    return (getattr(view_samplers, CFG_CLASS[name])(**kw),
            getattr(jax_vs, CFG_CLASS[name])(**kw))


@pytest.mark.parametrize("stage", ["train", "test"])
@pytest.mark.parametrize("circular", [False, True])
@pytest.mark.parametrize("name,kw", SAMPLERS)
def test_view_samplers_match_jax(data_root, name, kw, stage, circular):
    ours_cfg, jax_cfg = sampler_cfgs(name, kw, data_root)
    ours_step, jax_step = view_samplers.StepTracker(30), jax_vs.StepTracker(30)
    ours = view_samplers.get_view_sampler(ours_cfg, stage, False, circular, ours_step,
                                          rng=np.random.default_rng(5))
    theirs = jax_vs.get_view_sampler(jax_cfg, stage, False, circular, jax_step,
                                     rng=np.random.default_rng(5))
    assert (ours.num_context_views, ours.num_target_views) == \
        (theirs.num_context_views, theirs.num_target_views)
    scenes = ["scenetest0000", "scenetest0001"]
    for i in range(12):
        if i == 6:
            ours_step.set_step(1000)
            jax_step.set_step(1000)
        scene = scenes[i % 2]
        try:
            want = theirs.sample(scene, N_FRAMES)
        except ValueError:
            with pytest.raises(ValueError):
                ours.sample(scene, N_FRAMES)
            continue
        assert_same(ours.sample(scene, N_FRAMES), want)


def test_random_transform_shim_matches_jax():
    rng = np.random.default_rng(0)
    views = dict(image=rng.uniform(size=(2, 4, 4, 3)).astype(np.float32),
                 extrinsics=np.tile(np.eye(4, dtype=np.float32), (2, 1, 1)),
                 intrinsics=np.tile(np.eye(3, dtype=np.float32), (2, 1, 1)),
                 near=np.ones(2, np.float32), far=np.ones(2, np.float32), index=np.arange(2))
    ours = apply_random_transform_shim(Example("s", Views(**views), Views(**views)),
                                       eps=0.5, rng=np.random.default_rng(3))
    theirs = jax_random_transform(JaxExample("s", JaxViews(**views), JaxViews(**views)),
                                  eps=0.5, rng=np.random.default_rng(3))
    assert_same(ours, theirs)
    assert not np.allclose(ours.context.extrinsics, views["extrinsics"])


def dataset_cfgs(data_root, **kw):
    return (dataset_re10k.DatasetRE10kCfg(root=data_root, image_shape=(64, 64), **kw),
            jax_ds.DatasetRE10kCfg(root=data_root, image_shape=(64, 64), **kw))


BOUNDED = dict(num_context_views=2, num_target_views=3, min_distance_between_context_views=5,
               max_distance_between_context_views=15)


@pytest.mark.parametrize("stage,kw", [
    ("test", {}),
    ("train", dict(augment=True, random_transform_extrinsics=True)),
    ("val", dict(overfit_to_scene=["scenetest0001"]))])
def test_dataset_re10k_matches_jax(data_root, stage, kw):
    ours_cfg, jax_cfg = dataset_cfgs(data_root, **kw)
    examples = []
    for mod, vs, cfg in ((dataset_re10k, view_samplers, ours_cfg), (jax_ds, jax_vs, jax_cfg)):
        rng = np.random.default_rng(7)
        sampler = vs.get_view_sampler(vs.ViewSamplerBoundedCfg(**BOUNDED), stage,
                                      cfg.overfit_to_scene is not None, False, None, rng=rng)
        ds = mod.DatasetRE10k(cfg, stage, sampler, rng=rng)
        examples.append(list(ds))
        assert len(ds) == len(ds.chunks)
    ours, theirs = examples
    assert len(ours) == (1 if "overfit_to_scene" in kw else 2)
    assert_same(ours, theirs)
    assert ours[0].context.image.shape == (2, 64, 64, 3)


def test_dataset_re10k_refuses_the_latent_cache(data_root):
    """The train stage reads ``dataset.latent_cache`` and refuses a
    directory that holds no cache; val and test ignore it, as in JAX."""
    cfg = dataset_re10k.DatasetRE10kCfg(root=data_root, latent_cache=data_root)
    for stage in ("train", "val", "test"):
        sampler = view_samplers.ViewSamplerAll(view_samplers.ViewSamplerAllCfg(), stage,
                                               False, False, None)
        if stage == "train":
            with pytest.raises(FileNotFoundError, match="meta.json"):
                dataset_re10k.DatasetRE10k(cfg, stage, sampler)
        else:
            assert dataset_re10k.DatasetRE10k(cfg, stage, sampler)._latents is None


def test_dataset_re10k_v2_matches_jax(data_root):
    ours_cfg, jax_cfg = dataset_cfgs(data_root, name="re10k_non_iter")
    eval_kw = dict(index_path=data_root / "eval_index.json")
    ours = DatasetRE10kV2(ours_cfg, "test", view_samplers.ViewSamplerEvaluation(
        view_samplers.ViewSamplerEvaluationCfg(**eval_kw), "test", False, False, None))
    theirs = JaxV2(jax_cfg, "test", jax_vs.ViewSamplerEvaluation(
        jax_vs.ViewSamplerEvaluationCfg(**eval_kw), "test", False, False, None))
    assert ours.scenes == theirs.scenes == ["scenetest0000", "scenetest0001"]
    assert_same(ours[1], theirs[1])
    assert_same(list(ours), list(theirs))
    np.testing.assert_array_equal(ours[0].target.index, [1, 4, 7])


def loader_cfgs(num_workers):
    stage = dict(num_workers=num_workers, batch_size=2, seed=3)
    return (loader.DataLoaderCfg(train=loader.DataLoaderStageCfg(**stage),
                                 test=loader.DataLoaderStageCfg(**{**stage, "batch_size": 1})),
            jax_loader.DataLoaderCfg(train=jax_loader.DataLoaderStageCfg(**stage),
                                     test=jax_loader.DataLoaderStageCfg(
                                         **{**stage, "batch_size": 1})))


@pytest.mark.parametrize("stage,num_workers", [("test", 1), ("train", 1), ("train", 2)])
def test_data_module_batches_match_jax(data_root, stage, num_workers):
    ours_cfg, jax_cfg = dataset_cfgs(data_root, augment=stage == "train")
    ours_dl, jax_dl = loader_cfgs(num_workers)
    batches = []
    for mod, vs, cfg, dl in ((loader, view_samplers, ours_cfg, ours_dl),
                             (jax_loader, jax_vs, jax_cfg, jax_dl)):
        dm = mod.DataModule(cfg, vs.ViewSamplerBoundedCfg(**BOUNDED), dl, vs.StepTracker())
        it = dm.test_dataloader() if stage == "test" else dm.train_dataloader()
        try:
            batches.append([next(it) for _ in range(2 if stage == "test" else 3)])
        finally:
            it.close()
    ours, theirs = batches
    assert_same(ours, theirs)
    assert ours[0]["context"]["image"].shape[0] == (1 if stage == "test" else 2)


def test_collate_matches_jax(data_root):
    ours_cfg, jax_cfg = dataset_cfgs(data_root)
    rng = np.random.default_rng(1)
    sampler = view_samplers.get_view_sampler(view_samplers.ViewSamplerBoundedCfg(**BOUNDED),
                                             "test", False, False, None, rng=rng)
    examples = list(dataset_re10k.DatasetRE10k(ours_cfg, "test", sampler, rng=rng))
    jax_examples = [JaxExample(e.scene, JaxViews(**vars(e.context)), JaxViews(**vars(e.target)))
                    for e in examples]
    assert_same(loader.collate(examples), jax_loader.collate(jax_examples))


def test_process_index_without_distributed():
    assert loader.process_index_and_count() == (0, 1)
