"""Map-style RE10K dataset ("re10k_non_iter"; counterpart of
``mvldm_tpu/data/dataset_re10kv2.py``).

Re-creates reference ``src/dataset/dataset_re10kv2.py:34-188``: instead of
streaming chunks, it indexes only the scenes listed in the evaluation index
(via ``<stage>/index.json``) and loads one scene per ``__getitem__`` — the
access pattern used for targeted evaluation runs.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from .chunk_reader import convert_poses, load_chunk
from .dataset_re10k import DatasetRE10k, DatasetRE10kCfg, _fov_degrees
from .types import Example, Stage
from .view_samplers import ViewSampler, ViewSamplerEvaluation


class DatasetRE10kV2(DatasetRE10k):
    """Random-access variant. Scene list = evaluation-index scenes present in
    the stage's ``index.json`` (or ``overfit_to_scene``)."""

    def __init__(
        self,
        cfg: DatasetRE10kCfg,
        stage: Stage,
        view_sampler: ViewSampler,
        rng: Optional[np.random.Generator] = None,
        **kwargs,
    ):
        super().__init__(cfg, stage, view_sampler, rng=rng, **kwargs)
        root = Path(cfg.root) / self.data_stage
        with open(root / "index.json") as f:
            self.scene_to_chunk: Dict[str, str] = json.load(f)

        if cfg.overfit_to_scene is not None:
            self.scenes: List[str] = list(cfg.overfit_to_scene)
        elif isinstance(view_sampler, ViewSamplerEvaluation):
            self.scenes = [
                s for s in view_sampler.index if s in self.scene_to_chunk
            ]
        else:
            self.scenes = sorted(self.scene_to_chunk)
        self._root = root
        self._chunk_cache: Dict[str, list] = {}

    def _load_scene(self, scene: str) -> dict:
        chunk_name = self.scene_to_chunk[scene]
        if chunk_name not in self._chunk_cache:
            self._chunk_cache.clear()  # keep at most one chunk resident
            self._chunk_cache[chunk_name] = load_chunk(self._root / chunk_name)
        for example in self._chunk_cache[chunk_name]:
            if example["key"] == scene:
                return example
        raise KeyError(f"Scene {scene} not found in chunk {chunk_name}")

    def __len__(self) -> int:
        return len(self.scenes)

    def __getitem__(self, idx: int) -> Example:
        scene = self.scenes[idx]
        example = self._load_scene(scene)
        extrinsics, intrinsics = convert_poses(example["cameras"])
        num_views = extrinsics.shape[0]
        if (_fov_degrees(intrinsics) > self.cfg.max_fov).any():
            raise ValueError(f"Scene {scene} exceeds max FOV")
        [view_index] = self.view_sampler.sample(scene, num_views)
        result = self._build_example(scene, example, extrinsics, intrinsics, view_index)
        if result is None:
            raise ValueError(f"Scene {scene} failed example construction")
        return result

    def __iter__(self):
        for i in range(len(self)):
            try:
                yield self[i]
            except ValueError:
                continue
