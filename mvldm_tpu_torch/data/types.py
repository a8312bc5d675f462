"""Host-side data types (numpy; counterpart of ``mvldm_tpu/data/types.py``,
after reference ``src/dataset/types.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal, Optional

import numpy as np

Stage = Literal["train", "val", "test"]


@dataclass
class ViewIndex:
    """Context/target frame indices for one example (reference
    ``view_sampler/view_sampler.py:21-27``)."""

    context: np.ndarray
    target: Optional[np.ndarray]


@dataclass
class Views:
    """One role's views: images (v, h, w, 3) float32 in [0,1]; extrinsics
    (v, 4, 4) c2w; intrinsics (v, 3, 3) normalized; near/far (v,); index (v,).

    ``latent_moments`` (v, h/8, w/8, 2c) float32 replaces ``image`` when the
    dataset serves precomputed VAE posteriors (``data/latent_cache.py``);
    exactly one of the two is set on the training path."""

    image: Optional[np.ndarray]
    extrinsics: np.ndarray
    intrinsics: np.ndarray
    near: np.ndarray
    far: np.ndarray
    index: np.ndarray
    latent_moments: Optional[np.ndarray] = None


@dataclass
class Example:
    scene: str
    context: Views
    target: Optional[Views] = None
