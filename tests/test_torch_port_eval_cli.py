"""The port's evaluation CLIs (``scripts/generate_gt``,
``generate_gt_image_directory``, ``compute_metrics`` and ``compute_fid``)
against the JAX CLIs on the same PNG trees, on CPU.

* ``generate_gt`` and ``generate_gt_image_directory`` write the JAX CLIs'
  file trees, pixel for pixel.
* ``compute_metrics`` (Hydra over the test datamodule, and the argparse
  directory form) and ``compute_fid`` (both forms) write the JAX CLIs' JSON
  trees: the same keys at every level (``scores[metric][scene][method]``
  for the per-scene file); PSNR, SSIM and LPIPS within 1e-5 relative,
  DISTS within 1e-6 absolute (it is 1 minus a sum near 1 in f32, so its
  rounding is absolute: ~2e-7 seen on a DISTS of 5e-3), the VGG-feature FID
  within 1e-4 relative (a Frechet distance of 3 to 6 samples in 512
  dimensions goes through the regularised square root, which amplifies the
  features' 1e-6) and KID within 1e-5 absolute (a difference of f32 kernel
  means of order 1: ~5e-7 seen on a KID of -2e-3).
* The VAE-feature fallbacks under ``--allow-init-vae`` carry the JAX keys
  (``lpips_vaefeat_randominit``, ``fid_vaefeat_randominit``); their values
  differ, as the port's seeded init is not the JAX package's.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from mvldm_tpu.scripts import compute_fid as jax_compute_fid
from mvldm_tpu.scripts import compute_metrics as jax_compute_metrics
from mvldm_tpu.scripts import generate_gt as jax_generate_gt
from mvldm_tpu.scripts import generate_gt_image_directory as jax_generate_gt_dir
from mvldm_tpu_torch.scripts import (
    compute_fid,
    compute_metrics,
    generate_gt,
    generate_gt_image_directory,
)
from mvldm_tpu_torch.utils.image_io import load_image, save_image

from synthetic_data import write_synthetic_dataset
from tests.test_metric_goldens import he_vgg_npz

EXACT = ("psnr", "ssim", "lpips", "num_scenes")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A synthetic dataset, its evaluation index, the GT trees of both
    packages and a noisy render tree of the GT."""
    tmp = tmp_path_factory.mktemp("eval")
    root = write_synthetic_dataset(tmp / "re10k", frames_per_scene=12)
    index = {"scenetest0000": {"context": [0], "target": [1, 2, 3]},
             "scenetest0001": {"context": [0], "target": [2, 4, 6]}}
    index_path = tmp / "eval_index.json"
    index_path.write_text(json.dumps(index))
    gt_args = [f"dataset.root={root}", "dataset/view_sampler=evaluation",
               f"dataset.view_sampler.index_path={index_path}", "dataset.image_shape=[64,64]",
               "trainer.limit_test_batches=2"]
    trees = {}
    for name, gt, gt_dir in (("port", generate_gt, generate_gt_image_directory),
                             ("jax", jax_generate_gt, jax_generate_gt_dir)):
        gt.main(gt_args + [f"output_dir={tmp / name / 'gt'}"])
        gt_dir.main(gt_args + [f"output_dir={tmp / name / 'gt_images'}"])
        trees[name] = tmp / name
    renders = tmp / "renders"
    rng = np.random.default_rng(0)
    for png in sorted((tmp / "jax" / "gt").rglob("*.png")):
        img = load_image(png)
        noisy = np.clip(img + 0.05 * rng.normal(size=img.shape), 0, 1).astype(np.float32)
        save_image(noisy, renders / png.parent.name / "color" / png.name)
    weights = he_vgg_npz(tmp / "vgg.npz")
    return dict(root=root, index_path=index_path, trees=trees, renders=renders,
                weights=weights, tmp=tmp)


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): p for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("tree", ["gt", "gt_images"])
def test_gt_trees_match_jax(setup, tree):
    ours, theirs = (_files(setup["trees"][n] / tree) for n in ("port", "jax"))
    assert sorted(ours) == sorted(theirs)
    assert len(ours) == 6  # 2 scenes x 3 targets
    if tree == "gt":
        assert "scenetest0000/000001.png" in ours
    else:
        assert "scenetest0001_000006.png" in ours
    for k in ours:
        np.testing.assert_array_equal(load_image(ours[k]), load_image(theirs[k]))


def _assert_same_json(got, want, path="root"):
    assert type(got) is type(want) or isinstance(got, (int, float)), path
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_same_json(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, str):
        assert got == want, path
    else:
        key = path.split(".")[-1] if path.count(".") < 3 else path.split(".")[1]
        if key == "dists" or key.startswith("kid"):
            assert got == pytest.approx(want, rel=0, abs=1e-6 if key == "dists" else 1e-5), path
            return
        rtol = 1e-5 if any(key.startswith(m) for m in EXACT) else 1e-4
        assert got == pytest.approx(want, rel=rtol, abs=1e-7), path


def _hydra_args(setup, out: Path, *extra):
    return ["+evaluation=re10k_video", f"dataset.root={setup['root']}",
            f"dataset.view_sampler.index_path={setup['index_path']}",
            "dataset.image_shape=[64,64]",
            f"evaluation.methods=[{{name: ours, key: ours, path: {setup['renders']}}}]",
            f"output_metrics_path={out / 'metrics.json'}",
            f"per_scene_metrics_path={out / 'per_scene.json'}",
            f"output_fid_path={out / 'fid.json'}", "limit_test_batches=2", *extra]


def test_compute_metrics_hydra_matches_jax(setup):
    """The JSON trees, and the side-by-side grids (GT | method, labelled,
    bordered) pixel for pixel, with their animation."""
    outs = {n: setup["tmp"] / f"hydra_{n}" for n in ("port", "jax")}
    extra = [f"lpips_weights={setup['weights']}", "evaluation.animate_side_by_side=true"]
    compute_metrics.main(_hydra_args(setup, outs["port"], *extra,
                                     f"evaluation.side_by_side_path={outs['port'] / 'sbs'}"),
                         device="cpu")
    jax_compute_metrics.main(_hydra_args(setup, outs["jax"], *extra,
                                         f"evaluation.side_by_side_path={outs['jax'] / 'sbs'}"))
    for name in ("metrics.json", "per_scene.json"):
        got, want = (json.loads((outs[n] / name).read_text()) for n in ("port", "jax"))
        _assert_same_json(got, want)
    grids = {n: {k: v for k, v in _files(outs[n] / "sbs").items() if k.endswith(".png")}
             for n in ("port", "jax")}
    assert sorted(grids["port"]) == sorted(grids["jax"]) and len(grids["port"]) == 6
    for k, path in grids["port"].items():
        np.testing.assert_array_equal(load_image(path), load_image(grids["jax"][k]))
    assert len(list((outs["port"] / "sbs" / "videos").glob("*.mp4"))) == 2
    got = json.loads((outs["port"] / "metrics.json").read_text())["ours"]
    assert {"psnr", "ssim", "lpips", "dists", "fid_vgg"} <= set(got)
    assert got["num_scenes"] == 2
    per_scene = json.loads((outs["port"] / "per_scene.json").read_text())
    assert set(per_scene["psnr"]) == {"scenetest0000", "scenetest0001"}


def test_compute_metrics_argparse_matches_jax(setup):
    outs = {n: setup["tmp"] / f"argparse_{n}.json" for n in ("port", "jax")}
    for name, mod in (("port", compute_metrics), ("jax", jax_compute_metrics)):
        argv = ["--gt-dir", str(setup["trees"]["jax"] / "gt"),
                "--method", f"ours={setup['renders']}", "--output", str(outs[name]),
                "--lpips-weights", str(setup["weights"])]
        mod.main(argv, device="cpu") if name == "port" else mod.main(argv)
    got, want = (json.loads(outs[n].read_text()) for n in ("port", "jax"))
    _assert_same_json(got, want)
    assert set(got["ours"]) == {"psnr", "ssim", "lpips", "dists", "num_scenes"}


def test_vae_fallback_keys_match_jax(setup):
    """No VGG weights, ``--allow-init-vae``: the fallbacks' keys, finite."""
    outs = {n: setup["tmp"] / f"vaefeat_{n}" for n in ("port", "jax")}
    argv = lambda n: ["--gt-dir", str(setup["trees"]["jax"] / "gt"),  # noqa: E731
                      "--method", f"ours={setup['renders']}",
                      "--output", str(outs[n] / "metrics.json"), "--allow-init-vae",
                      "--lpips-weights", str(setup["tmp"] / "absent.npz")]
    compute_metrics.main(argv("port"), device="cpu")
    jax_compute_metrics.main(argv("jax"))
    got, want = (json.loads((outs[n] / "metrics.json").read_text()) for n in ("port", "jax"))
    assert sorted(got["ours"]) == sorted(want["ours"])
    assert "lpips_vaefeat_randominit" in got["ours"]
    assert np.isfinite(got["ours"]["lpips_vaefeat_randominit"])
    fid_argv = lambda n: ["--dir-a", str(setup["renders"]),  # noqa: E731
                          "--dir-b", str(setup["trees"]["jax"] / "gt_images"),
                          "--output", str(outs[n] / "fid.json"), "--allow-init-vae",
                          "--lpips-weights", str(setup["tmp"] / "absent.npz"),
                          "--inception-weights", str(setup["tmp"] / "absent.npz")]
    compute_fid.main(fid_argv("port"), device="cpu")
    jax_compute_fid.main(fid_argv("jax"))
    got, want = (json.loads((outs[n] / "fid.json").read_text()) for n in ("port", "jax"))
    assert sorted(got) == sorted(want)
    assert got["extractor"] == want["extractor"] == "vaefeat_randominit"
    assert got["num_a"] == want["num_a"] == 6 and np.isfinite(got["fid"])


@pytest.mark.parametrize("form", ["argparse", "hydra"])
def test_compute_fid_matches_jax(setup, form):
    out = {n: setup["tmp"] / f"fid_{form}_{n}" for n in ("port", "jax")}
    for name, mod in (("port", compute_fid), ("jax", jax_compute_fid)):
        if form == "argparse":
            argv = ["--dir-a", str(setup["renders"]),
                    "--dir-b", str(setup["trees"][name] / "gt_images"),
                    "--output", str(out[name] / "fid.json"),
                    "--lpips-weights", str(setup["weights"])]
        else:
            argv = _hydra_args(setup, out[name], f"lpips_weights={setup['weights']}",
                               f"fid_gt_dir={setup['trees'][name] / 'gt_images'}")
        mod.main(argv, device="cpu") if name == "port" else mod.main(argv)
    got, want = (json.loads((out[n] / "fid.json").read_text()) for n in ("port", "jax"))
    _assert_same_json(got, want)
    keys = {"fid", "kid", "num_a", "num_b", "extractor"} if form == "argparse" else {
        "fid_vgg_ours", "kid_vgg_ours"}
    assert set(got) == keys


def test_cli_refusals(setup, tmp_path):
    with pytest.raises(SystemExit, match="methods is empty"):
        compute_metrics.main(["+evaluation=re10k_video"], device="cpu")
    with pytest.raises(SystemExit, match="No feature extractor"):
        compute_fid.main(["--dir-a", str(tmp_path), "--dir-b", str(tmp_path),
                          "--lpips-weights", str(tmp_path / "absent.npz"),
                          "--inception-weights", str(tmp_path / "absent.npz")], device="cpu")
