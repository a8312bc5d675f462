"""Ground-truth dumping entry point (counterpart of
``mvldm_tpu/scripts/generate_gt.py``; reference ``src/scripts/generate_gt.py``):
writes target frames as PNG trees ``<output_dir>/<scene>/<index>.png`` for
the metric pipeline. Host work only (data and PNGs); no card needed.

    python -m mvldm_tpu_torch.scripts.generate_gt +experiment=baseline mode=test \\
        dataset.root=<path> output_dir=outputs/gt
"""

from __future__ import annotations

import sys
from pathlib import Path

from ..config import compose, load_typed_root_config, set_cfg
from ..data.view_samplers import StepTracker
from ..evaluation.metric_computer import GTSaver
from .main import build_data_module


def load_test_cfg(argv):
    """The root config of ``argv``, ``mode=test`` unless it says otherwise."""
    overrides = list(argv if argv is not None else sys.argv[1:])
    if not any(o.startswith("mode=") for o in overrides):
        overrides.append("mode=test")
    cfg_dict = compose(overrides)
    set_cfg(cfg_dict)
    return load_typed_root_config(cfg_dict)


def gt_batches(cfg):
    """The test loader's batches, at most ``trainer.limit_test_batches``;
    the loader is closed after them."""
    loader = build_data_module(cfg, StepTracker()).test_dataloader()
    try:
        for n, batch in enumerate(loader):
            if cfg.trainer.limit_test_batches and n >= cfg.trainer.limit_test_batches:
                break
            yield batch
    finally:
        loader.close()


def main(argv=None) -> None:
    cfg = load_test_cfg(argv)
    saver = GTSaver(Path(cfg.output_dir), limit_frames=cfg.test.limit_frames or 80)
    for batch in gt_batches(cfg):
        saver.save_batch(batch)
        print(f"Saved GT for {batch['scene']}")


if __name__ == "__main__":
    main()
