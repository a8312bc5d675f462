"""Precomputed VAE-latent cache for training (counterpart of
``mvldm_tpu/data/latent_cache.py``, with its on-disk format byte for byte:
a cache written by either package reads in the other).

The VAE is frozen during training, so its encode is a pure function of the
(crop-shimmed) frame. ``scripts/precompute_latents.py`` encodes every frame
once and stores the posterior *moments* (mean ‖ logvar, f16); training then
draws a fresh latent sample ``z = mean + std · ε`` per step from the cached
``DiagonalGaussian`` (``engine.training_loss``), so its semantics equal
per-step encoding. Both x-flip variants of each frame are cached (an
encoder is not flip-equivariant); pose-only shims compose with the cache
unchanged.

Layout: one ``.npz`` per source chunk, same stem, under
``<cache_root>/<data_stage>/``; each scene key maps to an
``(n_frames, n_flips, h/8, w/8, 2·latent_channels)`` float16 array with
``n_flips`` ∈ {1, 2} (index 0 = original, 1 = x-flipped). ``meta.json``
records the image shape and VAE config fingerprint so a stale cache fails
loudly instead of silently training on mismatched latents.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

META_NAME = "meta.json"


def cache_file(cache_root: Path, stage: str, chunk_stem: str) -> Path:
    return Path(cache_root) / stage / f"{chunk_stem}.npz"


def write_chunk_cache(path: Path, scenes: Dict[str, np.ndarray]) -> None:
    """Write one chunk's scene -> moments arrays (compressed npz)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {}
    for scene, moments in scenes.items():
        assert moments.ndim == 5, moments.shape  # (n, flips, h, w, 2c)
        arrays[scene] = np.asarray(moments, dtype=np.float16)
    np.savez_compressed(path, **arrays)


def write_meta(
    cache_root: Path,
    stage: str,
    image_shape: Tuple[int, int],
    latent_channels: int,
    n_flips: int,
    vae_fingerprint: str,
) -> None:
    root = Path(cache_root) / stage
    root.mkdir(parents=True, exist_ok=True)
    with open(root / META_NAME, "w") as f:
        json.dump(
            {
                "image_shape": list(image_shape),
                "latent_channels": latent_channels,
                "n_flips": n_flips,
                "vae_fingerprint": vae_fingerprint,
            },
            f,
        )


class LatentCacheReader:
    """Per-dataset-stream reader with a one-chunk memo (streams iterate chunk
    by chunk, so a single-entry memo gives O(1) amortized npz opens)."""

    def __init__(self, cache_root: Path, stage: str,
                 image_shape: Optional[Tuple[int, int]] = None):
        self.root = Path(cache_root) / stage
        self.stage = stage
        meta_path = self.root / META_NAME
        if not meta_path.exists():
            raise FileNotFoundError(
                f"Latent cache {self.root} has no {META_NAME}; run "
                "python -m mvldm_tpu_torch.scripts.precompute_latents first."
            )
        with open(meta_path) as f:
            self.meta = json.load(f)
        if image_shape is not None and list(image_shape) != list(
            self.meta["image_shape"]
        ):
            raise ValueError(
                f"Latent cache {self.root} was precomputed at image_shape="
                f"{self.meta['image_shape']}, dataset wants {list(image_shape)};"
                " re-run precompute_latents."
            )
        self.n_flips = int(self.meta["n_flips"])
        self._memo_stem: Optional[str] = None
        self._memo: Optional[np.lib.npyio.NpzFile] = None

    def _chunk(self, chunk_stem: str):
        if self._memo_stem != chunk_stem:
            path = self.root / f"{chunk_stem}.npz"
            if not path.exists():
                raise FileNotFoundError(
                    f"Latent cache file {path} is missing; the cache is stale "
                    "or incomplete — re-run precompute_latents."
                )
            if self._memo is not None:
                self._memo.close()
            self._memo = np.load(path)
            self._memo_stem = chunk_stem
        return self._memo

    def lookup(
        self, chunk_stem: str, scene: str, indices: np.ndarray, flip: bool
    ) -> Optional[np.ndarray]:
        """(v, h/8, w/8, 2c) float32 moments for the given frames, or None if
        the scene was skipped at precompute time (bad frames)."""
        chunk = self._chunk(chunk_stem)
        if scene not in chunk.files:
            return None
        moments = chunk[scene]  # (n, flips, h, w, 2c) f16
        if flip and self.n_flips < 2:
            raise ValueError(
                f"Latent cache {self.root} was precomputed without flip "
                "variants but dataset.augment is on; re-run "
                "precompute_latents (it caches both flips by default)."
            )
        sel = moments[np.asarray(indices, dtype=np.int64), 1 if flip else 0]
        return np.ascontiguousarray(sel, dtype=np.float32)
