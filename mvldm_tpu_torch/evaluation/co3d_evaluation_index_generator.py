"""CO3D evaluation-index generation.

Re-creates reference ``src/evaluation/co3d_evaluation_index_generator.py:16-116``
as a plain numpy routine (the reference wraps it in a Lightning test loop):
per scene, sample random context frames, pair each with a partner at a
random signed offset within [min, max] distance (circular indexing), then
pick random target views — inside the context interval (``intra_context``)
or outside it.


The port's copy of ``mvldm_tpu/evaluation/co3d_evaluation_index_generator.py`` (plain numpy and the
port's chunk reader; the JSON it writes is the JAX module's, byte for byte)."""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np


@dataclass
class IndexEntry:
    """Reference ``evaluation/types.py:5-7``."""

    context: Tuple[int, ...]
    target: Tuple[int, ...]


@dataclass
class CO3DEvaluationIndexGeneratorCfg:
    num_context_pairs_per_scene: int = 4
    num_target_views: int = 3
    min_context_distance: int = 10
    max_context_distance: int = 50
    output_path: Path = Path("outputs/co3d_evaluation_index")
    save_previews: bool = False
    seed: int = 0
    intra_context: bool = True


class CO3DEvaluationIndexGenerator:
    def __init__(self, cfg: CO3DEvaluationIndexGeneratorCfg):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.index: Dict[str, List[IndexEntry]] = {}

    def process_scene(self, scene: str, num_views: int) -> List[IndexEntry]:
        cfg = self.cfg
        v = num_views
        context_indices = self.rng.permutation(v)[: cfg.num_context_pairs_per_scene]

        offsets = np.arange(cfg.min_context_distance, cfg.max_context_distance)
        offsets = np.concatenate([-offsets, offsets])
        chosen = self.rng.integers(0, len(offsets), size=len(context_indices))
        partners = context_indices + offsets[chosen]

        pairs = np.sort(np.stack([context_indices, partners], axis=1), axis=1)

        views: List[IndexEntry] = []
        for left, right in pairs:
            if cfg.intra_context:
                candidates = np.arange(left, right + 1)
            else:
                if left < 0 and right < v:
                    candidates = np.arange(right + 1, left % v)
                elif left >= 0 and right < v:
                    candidates = np.concatenate(
                        [np.arange(0, left), np.arange(right, v)]
                    )
                elif left >= 0 and right >= v:
                    candidates = np.arange(right % v + 1, left)
                else:
                    raise ValueError("Impossible context pair")
            if len(candidates) < cfg.num_target_views:
                continue
            targets = self.rng.permutation(candidates)[: cfg.num_target_views]
            targets = np.sort(targets) % v
            views.append(
                IndexEntry(
                    context=(int(left % v), int(right % v)),
                    target=tuple(int(t) for t in targets),
                )
            )
        self.index[scene] = views
        return views

    def save_index(self) -> None:
        self.cfg.output_path.mkdir(exist_ok=True, parents=True)
        path = self.cfg.output_path / "evaluation_index.json"
        with path.open("w") as f:
            json.dump(
                {k: [asdict(e) for e in views] for k, views in self.index.items()},
                f,
            )
