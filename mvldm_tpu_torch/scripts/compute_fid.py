"""FID/KID computation (counterpart of ``mvldm_tpu/scripts/compute_fid.py``;
reference ``src/scripts/compute_fid.py``), on the card.

Hydra-style surface (per-method directories vs the flat GT image directory,
reference ``compute_fid.py:43-50``):

    python -m mvldm_tpu_torch.scripts.compute_fid +evaluation=re10k_video \\
        'evaluation.methods=[{name: ours, key: ours, path: outputs/test}]' \\
        fid_gt_dir=gt_images

Argparse sugar (directory vs directory):

    python -m mvldm_tpu_torch.scripts.compute_fid --dir-a outputs/run1/video \\
        --dir-b outputs/gt --output outputs/fid.json

Feature extractor resolution (loudest capability first; non-Inception
substitutes carry the extractor in the result keys so their scores are
never mistaken for Inception-FID):

1. ``fid_inception_*`` — STANDARD Inception-FID (pool3-2048, FID
   convention) when ``assets/inception_fid.npz`` or ``--inception-weights``
   exists.
2. ``fid_vgg_*`` — the LPIPS VGG16 trunk, when converted weights exist.
3. ``fid_vaefeat_*`` — SD-VAE encoder latents (``--vae-checkpoint`` /
   ``vae_checkpoint=`` pointing at the reference torch ``.ckpt``).
4. ``fid_vaefeat_randominit_*`` — ``--allow-init-vae`` /
   ``allow_init_vae=true``: the port's seed-0 VAE init (a fixed random
   projection). For smoke tests and relative comparisons only.

Without a card it exits non-zero; from Python, ``main(argv, device="cpu")``
asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Callable, Optional, Tuple

from ..evaluation.fid import (
    fid_between_dirs,
    resolve_vae_params,
    vae_feature_extractor,
    vgg_feature_extractor,
)
from ..evaluation.inception import inception_feature_extractor
from .main import resolve_device


def resolve_extractor(
    lpips_weights: Optional[Path],
    vae_checkpoint: Optional[Path],
    allow_init_vae: bool,
    inception_weights: Optional[Path] = None,
    device="cpu",
) -> Tuple[Callable, str]:
    """(extractor, key_prefix) per the module-docstring resolution order."""
    extractor = inception_feature_extractor(inception_weights, device)
    if extractor is not None:
        print("FID extractor: InceptionV3 pool3 (FID convention) — "
              "comparable to published FID/KID")
        return extractor, "inception"
    extractor = vgg_feature_extractor(lpips_weights, device)
    if extractor is not None:
        return extractor, "vgg"
    vae, suffix = resolve_vae_params(vae_checkpoint, allow_init_vae, device)
    if vae is not None:
        return vae_feature_extractor(vae), suffix
    raise SystemExit(
        "No feature extractor available: convert FID-Inception weights "
        "(utils/inception_convert.py) or LPIPS weights "
        "(utils/lpips_convert.py), or pass --vae-checkpoint <torch .ckpt> "
        "or --allow-init-vae / allow_init_vae=true."
    )


def run_hydra(overrides, device) -> None:
    from .compute_metrics import load_compute_metrics_cfg

    cfg = load_compute_metrics_cfg(overrides)
    if not cfg.evaluation.methods:
        raise SystemExit(
            "evaluation.methods is empty — pass e.g. "
            "'evaluation.methods=[{name: ours, key: ours, path: outputs/test}]'"
        )
    extractor, prefix = resolve_extractor(cfg.lpips_weights, cfg.vae_checkpoint,
                                          cfg.allow_init_vae, cfg.inception_weights, device)
    fids = {}
    for method in cfg.evaluation.methods:
        r = fid_between_dirs(method.path, cfg.fid_gt_dir, extractor)
        # Keyed like the reference's cleanfid output (fid/kidclean_<key>),
        # labeled by the extractor.
        fids[f"fid_{prefix}_{method.key}"] = r["fid"]
        fids[f"kid_{prefix}_{method.key}"] = r["kid"]
    cfg.output_fid_path.parent.mkdir(parents=True, exist_ok=True)
    cfg.output_fid_path.write_text(json.dumps(fids, indent=2))
    print(json.dumps(fids, indent=2))


def run_argparse(argv, device) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dir-a", type=Path, required=True)
    parser.add_argument("--dir-b", type=Path, required=True)
    parser.add_argument("--output", type=Path, default=Path("outputs/fid.json"))
    parser.add_argument("--lpips-weights", type=Path, default=None)
    parser.add_argument("--inception-weights", type=Path, default=None,
                        help="converted FID-Inception npz (utils/inception_convert.py); "
                        "default assets/inception_fid.npz when present")
    parser.add_argument("--vae-checkpoint", type=Path, default=None)
    parser.add_argument("--allow-init-vae", action="store_true")
    args = parser.parse_args(argv)

    extractor, prefix = resolve_extractor(args.lpips_weights, args.vae_checkpoint,
                                          args.allow_init_vae, args.inception_weights, device)
    results = fid_between_dirs(args.dir_a, args.dir_b, extractor)
    results["extractor"] = prefix
    args.output.parent.mkdir(parents=True, exist_ok=True)
    args.output.write_text(json.dumps(results, indent=2))
    print(json.dumps(results, indent=2))


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
