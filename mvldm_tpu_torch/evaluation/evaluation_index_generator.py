"""Evaluation-index generation.

Re-creates the live branch of the reference's
``EvaluationIndexGenerator`` (``evaluation_index_generator.py:34-179``): the
``all=True`` video path emitting ``{scene: {"context": [0], "target":
[1..N]}}`` for scenes with more than ``min_frames`` frames — the branch that
produced ``assets/evaluation_index/re10k_video.json``. (The overlap-driven
context-pair search is dead in the reference snapshot — it imports the
missing ``geometry.epipolar_lines`` module, SURVEY.md §2.3 — so only the
video branch is rebuilt.)

The port's copy of ``mvldm_tpu/evaluation/evaluation_index_generator.py`` (plain numpy and the
port's chunk reader; the JSON it writes is the JAX module's, byte for byte)."""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict



@dataclass
class EvaluationIndexGeneratorCfg:
    num_target_views: int = 3
    min_frames: int = 150
    output_path: Path = Path("outputs/evaluation_index")


def generate_video_index(
    dataset_root: Path,
    output_path: Path,
    min_frames: int = 150,
    stage: str = "test",
) -> Dict[str, dict]:
    """Scan chunks and emit the video evaluation index (context = frame 0,
    targets = all remaining frames) for scenes longer than ``min_frames``
    (reference ``evaluation_index_generator.py:55-62``)."""
    from ..data.chunk_reader import load_chunk

    index: Dict[str, dict] = {}
    stage_dir = Path(dataset_root) / stage
    for chunk_path in sorted(stage_dir.glob("*.torch")):
        for example in load_chunk(chunk_path):
            n = example["cameras"].shape[0]
            if n <= min_frames:
                index[example["key"]] = None
                continue
            index[example["key"]] = {
                "context": [0],
                "target": list(range(1, n)),
            }
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    output_path.write_text(json.dumps(index))
    return index
