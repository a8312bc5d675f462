"""The one generator of inputs: it reads a traffic mix's parameters
(``traffic/<name>.json``) and makes, from the run's seed, the scenes, the
novel-view requests or the training batches that the mix describes.

A mix's ``kind`` names the loop that drives it, ``kinds/<kind>.py``:

* ``scenes``: closed loop, one client, scenes of 1 context + ``targets``
  frames, ``scene_batch`` scenes a dispatch;
* ``requests``: closed loop, one client, requests of 1 context +
  n targets, n taken from ``targets`` in blocks that each hold every
  size once, in an order drawn from the seed;
* ``train``: training micro-batches of ``batch_size`` examples, each
  ``context_views`` + ``target_views`` views.

Every seed gets the same sizes; the seed draws pixels, the jitter of the
camera path and the order of request sizes. Seeds may be any whole number
below 2**63.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"
KINDS_DIR = Path(__file__).resolve().parent / "kinds"


def load(name: str) -> Dict:
    path = TRAFFIC_DIR / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no traffic mix {name!r} ({path} is missing)")
    mix = json.loads(path.read_text())
    kind = mix.get("kind")
    if not isinstance(kind, str) or not (KINDS_DIR / f"{kind}.py").is_file():
        raise ValueError(f"traffic mix {name!r}: no loop for its kind {kind!r} "
                         f"(kinds/<kind>.py)")
    return mix


def rng(seed: int, *stream: int) -> np.random.Generator:
    """The generator of one stream (a scene, a request, a batch) of a run."""
    return np.random.default_rng([x % (1 << 63) for x in (seed, *stream)])


@dataclass
class Views:
    """A scene's frames on the host: 1 context, then the targets."""

    images: np.ndarray      # (n, hw, hw, 3) float32 in [0, 1)
    extrinsics: np.ndarray  # (n, 4, 4) camera to world
    intrinsics: np.ndarray  # (n, 3, 3) normalised


def make_scene(n_targets: int, hw: int, path: Dict, gen: np.random.Generator) -> Views:
    """One context + ``n_targets`` frames on a forward-translating camera
    path with random pixels; copied from ``chip_smoke.py``'s ``make_scene``,
    with a seeded jitter of the path's positions added."""
    n = n_targets + 1
    images = gen.random((n, hw, hw, 3), dtype=np.float32)
    extr = np.repeat(np.eye(4, dtype=np.float32)[None], n, axis=0)
    extr[:, 0, 3] = np.linspace(0, path["x_travel"], n)
    extr[:, 2, 3] = np.linspace(0, path["z_travel"], n)
    extr[:, :3, 3] += gen.uniform(-path["jitter"], path["jitter"], (n, 3)).astype(np.float32)
    intr = np.repeat(np.eye(3, dtype=np.float32)[None], n, axis=0)
    intr[:, 0, 0] = path["fx"]
    intr[:, 1, 1] = path["fy"]
    intr[:, 0, 2] = intr[:, 1, 2] = 0.5
    return Views(images, extr, intr)


def request_sizes(mix: Dict, seed: int, count: int) -> List[int]:
    """The target counts of the first ``count`` requests: blocks that each
    hold every size of ``mix["targets"]`` once, each block in an order
    drawn from the seed."""
    sizes = list(mix["targets"])
    out: List[int] = []
    block = 0
    while len(out) < count:
        out.extend(int(s) for s in rng(seed, 1 << 20, block).permutation(sizes))
        block += 1
    return out[:count]


@dataclass
class TrainBatch:
    """One micro-batch on the host, in the layout of the program's Batch."""

    images: np.ndarray      # (b, v, hw, hw, 3) float32 in [0, 1)
    extrinsics: np.ndarray  # (b, v, 4, 4)
    intrinsics: np.ndarray  # (b, v, 3, 3)
    num_context: int


def make_train_batch(mix: Dict, seed: int, step: int) -> TrainBatch:
    """Micro-batch ``step``: uniform random pixels, cameras translating
    along x with a seeded jitter; copied from the program's
    ``builder.make_train_batch``, with a stream of its own for every step
    so that no two micro-batches share rows."""
    gen = rng(seed, 2 << 20, step)
    b, v_c = mix["batch_size"], mix["context_views"]
    v, hw = v_c + mix["target_views"], mix["hw"]
    images = gen.random((b, v, hw, hw, 3), dtype=np.float32)
    extr = np.repeat(np.eye(4, dtype=np.float32)[None, None], b, axis=0).repeat(v, axis=1)
    extr[:, :, 0, 3] = np.linspace(0, 1, v, dtype=np.float32)
    extr[:, :, :3, 3] += gen.uniform(-mix["jitter"], mix["jitter"], (b, v, 3)).astype(np.float32)
    intr = np.repeat(np.eye(3, dtype=np.float32)[None, None], b, axis=0).repeat(v, axis=1)
    intr[:, :, 0, 2] = intr[:, :, 1, 2] = 0.5
    return TrainBatch(images, extr, intr, v_c)
