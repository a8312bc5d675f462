"""Sampling entry point (counterpart of ``mvldm_tpu/scripts/generate_mvldm.py``,
after reference ``src/scripts/generate_mvldm.py:24-92``):

    python -m mvldm_tpu_torch.scripts.generate_mvldm +experiment=baseline \\
        checkpointing.load=<ckpt> dataset.root=<path> \\
        scene_id=<int-or-hash> test.sampling_mode=anchored test.limit_frames=80

``scene_id`` selects one scene: an integer indexes the evaluation-index
scene list; a string is the scene hash directly. Either maps into
``dataset.overfit_to_scene``. It runs on the card and exits non-zero
without one.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

from ..config import compose, load_typed_root_config, set_cfg
from .main import resolve_device, run_test


def resolve_scene_id(cfg_dict: dict) -> None:
    scene_id = cfg_dict.get("scene_id")
    if scene_id is None:
        return
    if isinstance(scene_id, int):
        sampler = cfg_dict["dataset"]["view_sampler"]
        index_path = Path(sampler.get("index_path", "assets/evaluation_index/re10k_video.json"))
        with open(index_path) as f:
            scenes = [k for k, v in json.load(f).items() if v is not None]
        scene = scenes[scene_id]
    else:
        scene = str(scene_id)
    cfg_dict["dataset"]["overfit_to_scene"] = [scene]
    print(f"Sampling scene: {scene}")


def main(argv=None, device=None) -> None:
    """``device`` is "cuda" when None; the tests pass "cpu"."""
    device = resolve_device(device)
    overrides = list(argv if argv is not None else sys.argv[1:])
    if not any(o.startswith("mode=") for o in overrides):
        overrides.append("mode=test")
    cfg_dict = compose(overrides)
    resolve_scene_id(cfg_dict)
    set_cfg(cfg_dict)
    run_test(load_typed_root_config(cfg_dict), device)


if __name__ == "__main__":
    main()
