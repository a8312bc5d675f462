"""Metric computation entry point (counterpart of
``mvldm_tpu/scripts/compute_metrics.py``; reference
``src/scripts/compute_metrics.py:34-52``), on the card.

Hydra-style surface (the reference's documented CLI):

    python -m mvldm_tpu_torch.scripts.compute_metrics +evaluation=re10k_video \\
        dataset.root=<path> \\
        'evaluation.methods=[{name: ours, key: ours, path: outputs/test}]'

GT comes from the test datamodule (evaluation view sampler over the video
index), methods' renders from ``<path>/<scene>/color/<index>.png``; dumps
``output_metrics_path`` + ``per_scene_metrics_path``.

Argparse sugar (directory-vs-directory, no dataset required):

    python -m mvldm_tpu_torch.scripts.compute_metrics \\
        --gt-dir outputs/gt --method ours=outputs/run1/video \\
        --output outputs/metrics.json

Without converted VGG weights, ``--vae-checkpoint`` (or ``vae_checkpoint=``)
emits the SD-VAE-feature fallbacks ``lpips_vaefeat`` / ``fid_vaefeat`` — see
``evaluation/fid.resolve_vae_params``. Without a card it exits non-zero;
from Python, ``main(argv, device="cpu")`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from ..config import DatasetCfg, compose, from_dict, set_cfg
from ..data.loader import DataLoaderCfg
from ..evaluation.fid import resolve_vae_params
from ..evaluation.metric_computer import (
    EvaluationCfg,
    MethodCfg,
    MetricComputer,
    save_metrics_json,
)
from .main import resolve_device


@dataclass
class ComputeMetricsCfg:
    """Reference ``compute_metrics.py:24-32`` RootCfg."""

    evaluation: EvaluationCfg
    dataset: DatasetCfg = field(default_factory=DatasetCfg)
    data_loader: DataLoaderCfg = field(default_factory=DataLoaderCfg)
    seed: int = 0
    output_metrics_path: Path = Path("outputs/evaluation_metrics.json")
    per_scene_metrics_path: Path = Path("outputs/per_scene_metrics.json")
    output_fid_path: Path = Path("outputs/fid.json")
    fid_gt_dir: Path = Path("gt_images")
    limit_test_batches: Optional[int] = 32
    lpips_weights: Optional[Path] = None
    # Converted FID-Inception weights; assets/inception_fid.npz is probed
    # when unset.
    inception_weights: Optional[Path] = None
    # FID fallback extractors (scripts/compute_fid.py): SD-VAE encoder
    # features from the reference torch checkpoint, or the port's seed-0
    # VAE init (smoke tests / relative comparisons only).
    vae_checkpoint: Optional[Path] = None
    allow_init_vae: bool = False


def load_compute_metrics_cfg(overrides) -> ComputeMetricsCfg:
    cfg_dict = compose(overrides, main_name="compute_metrics")
    set_cfg(cfg_dict)
    return from_dict(ComputeMetricsCfg, cfg_dict, "root")


def _print_results(results) -> None:
    for key, metrics in results.items():
        print(f"  {key}: " + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))


def run_hydra(overrides, device) -> None:
    from ..data.view_samplers import StepTracker
    from .main import build_data_module

    cfg = load_compute_metrics_cfg(overrides)
    if not cfg.evaluation.methods:
        raise SystemExit(
            "evaluation.methods is empty — pass e.g. "
            "'evaluation.methods=[{name: ours, key: ours, path: outputs/test}]'"
        )
    vae, vae_key = resolve_vae_params(cfg.vae_checkpoint, cfg.allow_init_vae, device)
    computer = MetricComputer(
        cfg.evaluation, lpips_weights=cfg.lpips_weights, vae=vae,
        vae_feature_key=vae_key or "vaefeat", inception_weights=cfg.inception_weights,
        device=device,
    )
    loader = build_data_module(cfg, StepTracker()).test_dataloader()
    try:
        results = computer.compute_over_dataset(loader, cfg.limit_test_batches)
    finally:
        loader.close()
    save_metrics_json(results, cfg.output_metrics_path)
    save_metrics_json(computer.scores, cfg.per_scene_metrics_path)
    print(f"\nResults -> {cfg.output_metrics_path}")
    print(f"Per-scene -> {cfg.per_scene_metrics_path}")
    _print_results(results)


def run_argparse(argv, device) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--gt-dir", type=Path, required=True)
    parser.add_argument("--method", action="append", required=True,
                        help="key=path pairs; repeatable")
    parser.add_argument("--output", type=Path, default=Path("outputs/metrics.json"))
    parser.add_argument("--lpips-weights", type=Path, default=None)
    parser.add_argument("--inception-weights", type=Path, default=None,
                        help="converted FID-Inception npz (utils/inception_convert.py)")
    parser.add_argument("--vae-checkpoint", type=Path, default=None)
    parser.add_argument("--allow-init-vae", action="store_true")
    args = parser.parse_args(argv)

    methods = []
    for spec in args.method:
        key, _, path = spec.partition("=")
        methods.append(MethodCfg(name=key, key=key, path=Path(path)))

    vae, vae_key = resolve_vae_params(args.vae_checkpoint, args.allow_init_vae, device)
    computer = MetricComputer(
        EvaluationCfg(methods=methods), args.gt_dir, args.lpips_weights, vae=vae,
        vae_feature_key=vae_key or "vaefeat", inception_weights=args.inception_weights,
        device=device,
    )
    results = computer.compute()
    save_metrics_json(results, args.output)
    print(f"\nResults -> {args.output}")
    _print_results(results)


def main(argv=None, device=None) -> None:
    """``device`` is "cuda" when None; the tests pass "cpu"."""
    device = resolve_device(device)
    argv = list(argv if argv is not None else sys.argv[1:])
    if any(a.startswith("--") for a in argv):
        run_argparse(argv, device)
    else:
        run_hydra(argv, device)


if __name__ == "__main__":
    main()
