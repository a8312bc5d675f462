"""Metric computation over generated / GT image trees (counterpart of
``mvldm_tpu/evaluation/metric_computer.py``).

The reference's post-hoc metric pipeline (``metric_computer.py`` +
``gt_saver.py`` + ``compute_metrics.py``): generated PNGs per method /
scene / frame are compared against ground truth, per-scene metrics
accumulate into running means, results dump to JSON in the layout
``scores[metric][scene][method_key]``. PSNR, SSIM, LPIPS, DISTS, the VAE
feature distance and the FID extractors run on ``device`` (the CLIs put
them on the card); LPIPS / DISTS / Inception need converted weights and are
skipped (DISTS loudly) without them. The evaluation config dataclasses,
MVC and MVSSIM stubs included, are the JAX package's, copied.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Union

import numpy as np
import torch

from ..utils.image_io import load_image, save_image
from .metrics import compute_psnr, compute_ssim, get_dists, get_lpips


@dataclass
class MethodCfg:
    """Reference ``evaluation_cfg.py:6-9``."""

    name: str
    key: str
    path: Path


@dataclass
class ModalityCfg:
    """Reference ``evaluation_cfg.py:13-15``."""

    name: str
    key: str


@dataclass
class SceneCfg:
    """A highlighted scene (reference ``evaluation_cfg.py:19-22``)."""

    scene: str
    context_index: List[int] = field(default_factory=list)
    target_index: Union[int, List[int]] = field(default_factory=list)


@dataclass
class MVCCfg:
    """MET3R multi-view-consistency knobs; cfg-surface parity with the
    reference's stub (``evaluation_cfg.py:24-31`` — the metric itself lives
    in the external MET3R package, which the reference never invokes from
    this repo either)."""

    subsample_or_initxy1: int = 8
    corres_weighting: bool = False
    conf_weighting: bool = True
    confidence_key: str = "conf"
    reduction: Optional[str] = "mean"
    return_matches: bool = False


@dataclass
class MVSSIMCfg:
    """Reference ``evaluation_cfg.py:33-40`` (MVC + intrinsics flag)."""

    subsample_or_initxy1: int = 8
    corres_weighting: bool = False
    conf_weighting: bool = True
    confidence_key: str = "conf"
    reduction: Optional[str] = "mean"
    return_matches: bool = False
    compute_intrinsics: bool = False


@dataclass
class EvaluationCfg:
    """Reference ``evaluation_cfg.py:42-47``, merged with the MVC/MVSSIM
    evaluation stub fields (``evaluation_cfg.py:49-69``) so the
    ``re10k_extra_mvc`` / ``re10k_extra_mvssim`` protocol yamls compose."""

    methods: List[MethodCfg]
    side_by_side_path: Optional[Path] = None
    animate_side_by_side: bool = False
    highlighted: List[SceneCfg] = field(default_factory=list)
    modalities: Optional[List[ModalityCfg]] = None
    # MET3R/MASt3R weights path; config-surface parity with the reference's
    # evaluation yamls (unused unless MVC metrics are computed).
    weights: Optional[str] = None
    # MVC/MVSSIM evaluation stubs (reference MVCEvaluationCfg /
    # MVSSIMEvaluationCfg): parsed and carried, computed by the external
    # MET3R tooling.
    types: str = "fixed"  # "fixed" | "pairwise"
    img_size: int = 224
    output_path: Optional[Path] = None
    mvc_cfg: Optional[MVCCfg] = None
    mvssim_cfg: Optional[MVSSIMCfg] = None
    gt_directory: Optional[Path] = None
    gap: int = 1
    nchuncks: int = 20


class MetricComputer:
    """Walks ``<gt_dir>/<scene>/*.png`` against each method's
    ``<method_path>/<scene>/color/*.png`` (:meth:`compute`), or the test
    batches of a datamodule against the same trees
    (:meth:`compute_over_dataset`). ``vae`` is an ``AutoencoderKL`` for the
    VAE-feature fallbacks (``fid.resolve_vae_params``), keyed with
    ``vae_feature_key``."""

    def __init__(self, cfg: EvaluationCfg, gt_dir: Optional[Path] = None,
                 lpips_weights: Optional[Path] = None,
                 vae=None, vae_feature_key: str = "vaefeat",
                 inception_weights: Optional[Path] = None, device="cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.gt_dir = Path(gt_dir) if gt_dir is not None else None
        self.lpips, self.dists = (None if m is None else m.to(self.device)
                                  for m in (get_lpips(lpips_weights), get_dists(lpips_weights)))
        from .fid import vgg_feature_extractor
        from .inception import inception_feature_extractor

        # Standard Inception-FID when converted FID-Inception weights exist
        # (the reference's torchmetrics extractor, metric_computer.py:22) —
        # keyed plain "fid" because these ARE comparable to published
        # numbers; the substitutes below carry their extractor in the key.
        self.fid_extractor = inception_feature_extractor(inception_weights, self.device)
        self.fid_key = "fid"
        if self.fid_extractor is None:
            self.fid_extractor = vgg_feature_extractor(lpips_weights, self.device)
            self.fid_key = "fid_vgg"
        # Learned-feature fallback when no VGG weights exist: the SD-VAE
        # encoder (shipped with the model checkpoint) supplies a perceptual
        # distance (lpips_vaefeat*) and a Frechet distance (fid_vaefeat*).
        # Keys carry the extractor name so scores are never mistaken for
        # published LPIPS / Inception-FID numbers.
        self.vaefeat = None
        self.vaefeat_key = f"lpips_{vae_feature_key}"
        if vae is not None:
            from .fid import vae_feature_extractor
            from .metrics import VAEFeatureDistance

            if self.lpips is None:
                self.vaefeat = VAEFeatureDistance(vae)
            if self.fid_extractor is None:
                self.fid_extractor = vae_feature_extractor(vae)
                self.fid_key = f"fid_{vae_feature_key}"
        # Per-scene scores, reference layout (metric_computer.py:26):
        # scores[metric][scene][method_key] = value.
        self.scores: Dict[str, Dict[str, Dict[str, float]]] = {}
        self._running: Dict[str, float] = {}
        self._running_steps = 0

    def _scene_frames(self, scene_dir: Path) -> Dict[int, Path]:
        return {int(p.stem): p for p in sorted(scene_dir.glob("*.png"))}

    def _image_metrics(self, gt: np.ndarray, pred: np.ndarray) -> Dict[str, float]:
        """PSNR, SSIM and the perceptual distances over matched (n, h, w, 3)
        stacks, each the mean over the frames."""
        x = torch.as_tensor(gt, dtype=torch.float32, device=self.device)
        y = torch.as_tensor(pred, dtype=torch.float32, device=self.device)
        metrics = {
            "psnr": float(compute_psnr(x, y).mean()),
            "ssim": float(compute_ssim(x, y).mean()),
        }
        if self.lpips is not None:
            metrics["lpips"] = float(self.lpips(x, y).mean())
        if self.dists is not None:
            metrics["dists"] = float(self.dists(x, y).mean())
        if self.vaefeat is not None:
            metrics[self.vaefeat_key] = float(self.vaefeat(x, y).mean())
        return metrics

    def compute(self) -> Dict[str, Dict[str, float]]:
        sums: Dict[str, Dict[str, float]] = {m.key: {} for m in self.cfg.methods}
        counts: Dict[str, int] = {m.key: 0 for m in self.cfg.methods}

        scenes = sorted(p.name for p in self.gt_dir.iterdir() if p.is_dir())
        for scene in scenes:
            gt_frames = self._scene_frames(self.gt_dir / scene)
            if not gt_frames:
                continue
            for method in self.cfg.methods:
                scene_dir = Path(method.path) / scene / "color"
                if not scene_dir.is_dir():
                    continue
                pred_frames = self._scene_frames(scene_dir)
                common = sorted(set(gt_frames) & set(pred_frames))
                if not common:
                    continue
                try:
                    gt = np.stack([load_image(gt_frames[i]) for i in common])
                    pred = np.stack([load_image(pred_frames[i]) for i in common])
                except Exception as e:
                    print(f"Skipping {scene}/{method.key}: {e}")
                    continue
                metrics = self._image_metrics(gt, pred)
                acc = sums[method.key]
                for k, v in metrics.items():
                    acc[k] = acc.get(k, 0.0) + v
                counts[method.key] += 1
                print(f"{scene} {method.key}: "
                      + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))

        results = {}
        for method in self.cfg.methods:
            n = max(counts[method.key], 1)
            results[method.key] = {k: v / n for k, v in sums[method.key].items()}
            results[method.key]["num_scenes"] = counts[method.key]
        return results

    # ------------------------------------------------- dataset-driven loop

    def _frame_metrics(self, gt: np.ndarray, pred: np.ndarray) -> Dict[str, float]:
        """All available metrics over matched (n, h, w, 3) stacks."""
        metrics = self._image_metrics(gt, pred)
        if self.fid_extractor is not None and len(gt) >= 2:
            # Per-scene FID, like the reference's update/compute/reset cycle
            # (metric_computer.py:65-68); self.fid_key names the extractor.
            from .fid import frechet_distance

            metrics[self.fid_key] = frechet_distance(
                self.fid_extractor(gt), self.fid_extractor(pred))
        return metrics

    def _record(self, scene: str, key: str, metrics: Dict[str, float]) -> None:
        for metric, value in metrics.items():
            self.scores.setdefault(metric, {}).setdefault(scene, {})[key] = value

    def _print_running(self, metrics: Dict[str, float]) -> None:
        """Running-mean preview table (reference
        ``print_preview_metrics:125-146``)."""
        if not self._running:
            self._running = dict(metrics)
        else:
            s = self._running_steps
            for k, v in metrics.items():
                prev = self._running.get(k, v)
                self._running[k] = (s * prev + v) / (s + 1)
        self._running_steps += 1

        metric_names = ["psnr", "lpips", "dists", "ssim", self.fid_key]
        headers = ["Method", "PSNR (dB)", "LPIPS", "DISTS", "SSIM",
                   "FID(VGG)" if self.fid_key == "fid_vgg" else "FID(VAE)"]
        if self.vaefeat is not None:
            metric_names.insert(2, self.vaefeat_key)
            headers.insert(3, "LPIPS(VAE)")
        table = []
        for method in self.cfg.methods:
            row = [
                f"{self._running[f'{m}_{method.key}']:.3f}"
                if f"{m}_{method.key}" in self._running else "-"
                for m in metric_names
            ]
            table.append((method.key, *row))
        widths = [max(len(str(r[i])) for r in [headers] + table) for i in range(len(headers))]
        for r in [headers] + table:
            print("  ".join(str(c).ljust(w) for c, w in zip(r, widths)))

    def compute_over_dataset(
        self,
        batches: Iterable[dict],
        limit_test_batches: Optional[int] = None,
    ) -> Dict[str, Dict[str, float]]:
        """Reference ``MetricComputer.test_step`` (metric_computer.py:27-123):
        iterate test batches (GT from the datamodule), load each method's
        rendered frames from ``<path>/<scene>/color/<index>.png``, compute
        per-scene metrics, keep running means + per-scene ``self.scores``,
        optionally write side-by-side grids."""
        sums: Dict[str, Dict[str, float]] = {m.key: {} for m in self.cfg.methods}
        counts: Dict[str, int] = {m.key: 0 for m in self.cfg.methods}

        for batch_idx, batch in enumerate(batches):
            if limit_test_batches is not None and batch_idx >= limit_test_batches:
                break
            scenes = batch["scene"]
            gt_images = np.asarray(batch["target"]["image"])  # (b, v, h, w, 3)
            indices = np.asarray(batch["target"]["index"])    # (b, v)
            b = len(scenes)

            all_images: Dict[str, list] = {}
            batch_metrics: Dict[str, float] = {}
            for method in self.cfg.methods:
                loaded = []
                try:
                    for j in range(b):
                        loaded.append(np.stack([
                            load_image(Path(method.path) / scenes[j] / "color"
                                       / f"{int(idx):0>6}.png")
                            for idx in indices[j]
                        ]))
                except (FileNotFoundError, OSError) as e:
                    # Skip scenes with missing renders, like the reference's
                    # try/except (metric_computer.py:43-55) — but say why.
                    print(f'Skipping "{scenes}" for {method.key}: {e}')
                    continue
                all_images[method.key] = loaded
                for j in range(b):
                    metrics = self._frame_metrics(gt_images[j], loaded[j])
                    self._record(scenes[j], method.key, metrics)
                    for k, v in metrics.items():
                        acc = sums[method.key]
                        acc[k] = acc.get(k, 0.0) + v
                        # Per-BATCH mean for the preview table.
                        bk = f"{k}_{method.key}"
                        batch_metrics[bk] = batch_metrics.get(bk, 0.0) + v / b
                    counts[method.key] += 1
            if batch_metrics:
                self._print_running(batch_metrics)

            if self.cfg.side_by_side_path is not None and all_images:
                self._save_side_by_side(batch_idx, batch, all_images)

        results = {}
        for method in self.cfg.methods:
            n = max(counts[method.key], 1)
            results[method.key] = {k: v / n for k, v in sums[method.key].items()}
            results[method.key]["num_scenes"] = counts[method.key]
        return results

    def _save_side_by_side(self, batch_idx: int, batch: dict,
                           all_images: Dict[str, list]) -> None:
        """GT | method1 | method2 … rows (reference metric_computer.py:90-123)."""
        from ..visualization.annotation import add_label
        from ..visualization.layout import add_border, hcat

        scenes = batch["scene"]
        gt_images = np.asarray(batch["target"]["image"])
        indices = np.asarray(batch["target"]["index"])
        scene_key = f"{batch_idx:0>6}_{scenes[0]}"
        out_dir = Path(self.cfg.side_by_side_path) / scene_key
        frames = []
        for i in range(gt_images.shape[1]):
            row = [add_label(gt_images[0, i], "Ground Truth")]
            for method in self.cfg.methods:
                if method.key in all_images:
                    row.append(add_label(all_images[method.key][0][i], method.name))
            grid = add_border(hcat(*row))
            save_image(grid, out_dir / f"{int(indices[0, i]):0>6}.png")
            frames.append(grid)
        if self.cfg.animate_side_by_side:
            from ..utils.image_io import save_video

            videos_dir = Path(self.cfg.side_by_side_path) / "videos"
            save_video(frames, videos_dir / f"{scene_key}.mp4", fps=30)


class GTSaver:
    """Dump ground-truth target frames as PNGs (reference
    ``gt_saver.py:10-79``; first ``limit_frames`` targets per scene)."""

    def __init__(self, output_dir: Path, limit_frames: int = 80):
        self.output_dir = Path(output_dir)
        self.limit_frames = limit_frames

    def save_batch(self, batch_np: dict) -> None:
        for i, scene in enumerate(batch_np["scene"]):
            images = batch_np["target"]["image"][i][: self.limit_frames]
            indices = batch_np["target"]["index"][i][: self.limit_frames]
            for idx, image in zip(indices, images):
                save_image(np.asarray(image), self.output_dir / scene / f"{int(idx):0>6}.png")


def save_metrics_json(results: Dict, path: Path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(results, indent=2))
