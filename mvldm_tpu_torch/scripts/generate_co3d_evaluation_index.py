"""CO3D evaluation-index generation CLI (reference
``src/scripts/generate_co3d_evaluation_index.py``, which wraps the generator
in a Lightning test loop; here it is a plain chunk walk):

    python -m mvldm_tpu_torch.scripts.generate_co3d_evaluation_index \\
        --dataset-root datasets/co3d_hydrant \\
        --output-path outputs/co3d_hydrant_intra \\
        [--extra] [--num-context-pairs 4] [--num-targets 3] \\
        [--min-distance 10] [--max-distance 50] [--seed 0]

``--extra`` selects targets OUTSIDE the context interval (the reference's
``intra_context=False`` branch, ``co3d_evaluation_index_generator.py:60-77``);
the default is the intra protocol. Output:
``<output-path>/evaluation_index.json`` in the view-sampler-evaluation
format.


The port's copy of ``mvldm_tpu/scripts/generate_co3d_evaluation_index.py`` (plain numpy and the
port's chunk reader; the JSON it writes is the JAX module's, byte for byte)."""

from __future__ import annotations

import argparse
from pathlib import Path

from ..evaluation.co3d_evaluation_index_generator import (
    CO3DEvaluationIndexGenerator,
    CO3DEvaluationIndexGeneratorCfg,
)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset-root", type=Path, required=True)
    parser.add_argument("--output-path", type=Path, required=True)
    parser.add_argument("--stage", default="test")
    parser.add_argument("--extra", action="store_true",
                        help="targets outside the context interval")
    parser.add_argument("--num-context-pairs", type=int, default=4)
    parser.add_argument("--num-targets", type=int, default=3)
    parser.add_argument("--min-distance", type=int, default=10)
    parser.add_argument("--max-distance", type=int, default=50)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    from ..data.chunk_reader import load_chunk

    cfg = CO3DEvaluationIndexGeneratorCfg(
        num_context_pairs_per_scene=args.num_context_pairs,
        num_target_views=args.num_targets,
        min_context_distance=args.min_distance,
        max_context_distance=args.max_distance,
        output_path=args.output_path,
        seed=args.seed,
        intra_context=not args.extra,
    )
    generator = CO3DEvaluationIndexGenerator(cfg)

    stage_dir = Path(args.dataset_root) / args.stage
    n_scenes = 0
    for chunk_path in sorted(stage_dir.glob("*.torch")):
        for example in load_chunk(chunk_path):
            generator.process_scene(
                example["key"], int(example["cameras"].shape[0])
            )
            n_scenes += 1
    generator.save_index()
    n_entries = sum(len(v) for v in generator.index.values())
    print(
        f"Wrote {cfg.output_path / 'evaluation_index.json'}: "
        f"{n_entries} entries over {n_scenes} scenes"
    )


if __name__ == "__main__":
    main()
