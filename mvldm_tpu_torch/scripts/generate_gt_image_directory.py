"""Flat ground-truth image directory for directory-vs-directory FID
(counterpart of ``mvldm_tpu/scripts/generate_gt_image_directory.py``;
reference ``src/scripts/generate_gt_image_directory.py``): every target
frame saved as ``<scene>_<index>.png`` in one directory. Host work only.

    python -m mvldm_tpu_torch.scripts.generate_gt_image_directory \\
        +experiment=baseline dataset.root=<path> output_dir=outputs/gt_images
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..utils.image_io import save_image
from .generate_gt import gt_batches, load_test_cfg


def main(argv=None) -> None:
    cfg = load_test_cfg(argv)
    out = Path(cfg.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    limit = cfg.test.limit_frames or 80
    for batch in gt_batches(cfg):
        for i, scene in enumerate(batch["scene"]):
            images = batch["target"]["image"][i][:limit]
            indices = batch["target"]["index"][i][:limit]
            for idx, image in zip(indices, images):
                save_image(np.asarray(image), out / f"{scene}_{int(idx):0>6}.png")
        print(f"Saved {batch['scene']}")


if __name__ == "__main__":
    main()
