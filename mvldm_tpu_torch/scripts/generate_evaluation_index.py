"""Evaluation-index generation (reference
``src/scripts/generate_evaluation_index.py``, video branch):

    python -m mvldm_tpu_torch.scripts.generate_evaluation_index \\
        --dataset-root <path> --output outputs/re10k_video.json \\
        --min-frames 150


The port's copy of ``mvldm_tpu/scripts/generate_evaluation_index.py`` (plain numpy and the
port's chunk reader; the JSON it writes is the JAX module's, byte for byte)."""

from __future__ import annotations

import argparse
from pathlib import Path

from ..evaluation.evaluation_index_generator import generate_video_index


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset-root", type=Path, required=True)
    parser.add_argument("--output", type=Path, required=True)
    parser.add_argument("--min-frames", type=int, default=150)
    parser.add_argument("--stage", default="test")
    args = parser.parse_args(argv)

    index = generate_video_index(
        args.dataset_root, args.output, args.min_frames, args.stage
    )
    n_valid = sum(1 for v in index.values() if v is not None)
    print(f"Wrote {args.output}: {n_valid}/{len(index)} scenes indexed")


if __name__ == "__main__":
    main()
