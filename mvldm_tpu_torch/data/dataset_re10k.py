"""RealEstate10K chunked dataset (counterpart of
``mvldm_tpu/data/dataset_re10k.py``, draw for draw).

Numpy re-creation of the reference's ``DatasetRE10k``
(``src/dataset/dataset_re10k.py``): iterates pixelSplat-format ``.torch``
chunks, converts poses, filters wide-FOV scenes, samples view indices,
rescales the world to baseline 1, decodes JPEGs, applies shims, and yields
crop-shimmed :class:`Example` records in NHWC. With ``dataset.latent_cache``
the train stage serves the cached VAE posterior moments instead of images
(``data/latent_cache.py``); val and test ignore it, as in the JAX package.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, List, Literal, Optional, Tuple

import numpy as np

from .chunk_reader import convert_poses, decode_jpeg_bytes, load_chunk
from .latent_cache import LatentCacheReader
from .shims import (
    apply_augmentation_shim,
    apply_crop_shim,
    apply_random_transform_shim,
    crop_shim_intrinsics,
    reflect_extrinsics,
)
from .types import Example, Stage, ViewIndex, Views
from .view_samplers import ViewSampler, ViewSamplerEvaluation


def _fov_degrees(intrinsics: np.ndarray) -> np.ndarray:
    """Host-side FOV check (reference ``projection.py:234-248`` usage at
    ``dataset_re10k.py:112``)."""
    inv = np.linalg.inv(intrinsics)

    def unit(vec):
        v = np.einsum("bij,j->bi", inv, np.asarray(vec, dtype=np.float32))
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    fov_x = np.arccos(np.sum(unit([0, 0.5, 1]) * unit([1, 0.5, 1]), axis=-1))
    fov_y = np.arccos(np.sum(unit([0.5, 0, 1]) * unit([0.5, 1, 1]), axis=-1))
    return np.rad2deg(np.stack([fov_x, fov_y], axis=-1))


@dataclass
class DatasetRE10kCfg:
    """Mirrors reference ``DatasetCfgCommon`` + ``DatasetRE10kCfg``."""

    name: Literal["re10k", "re10k_non_iter"] = "re10k"
    root: Optional[Path] = None
    image_shape: Tuple[int, int] = (256, 256)
    background_color: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    cameras_are_circular: bool = False
    overfit_to_scene: Optional[List[str]] = None
    augment: bool = False
    random_transform_extrinsics: bool = False
    make_baseline_1: bool = True
    baseline_epsilon: float = 1e-3
    max_fov: float = 100.0
    # Precomputed VAE-latent cache root (data/latent_cache.py). When set,
    # the TRAIN stage yields latent posterior moments instead of decoded
    # images — no JPEG decode, no LANCZOS resize, no per-step VAE encode.
    latent_cache: Optional[Path] = None


class DatasetRE10k:
    """Iterable over :class:`Example`. ``worker_index``/``num_workers``
    replicate the reference's test-stage chunk striping
    (``dataset_re10k.py:87-92``)."""

    near: float = 0.1
    far: float = 1000.0

    def __init__(
        self,
        cfg: DatasetRE10kCfg,
        stage: Stage,
        view_sampler: ViewSampler,
        force_shuffle: bool = False,
        rng: Optional[np.random.Generator] = None,
        worker_index: int = 0,
        num_workers: int = 1,
    ):
        self.cfg = cfg
        self.stage = stage
        self.view_sampler = view_sampler
        self.force_shuffle = force_shuffle
        self.rng = rng or np.random.default_rng()
        self.worker_index = worker_index
        self.num_workers = num_workers

        if cfg.root is None:
            raise ValueError(
                "Dataset root is not defined; pass dataset.root=<path>."
            )
        self._latents: Optional[LatentCacheReader] = None
        if cfg.latent_cache is not None and stage == "train":
            self._latents = LatentCacheReader(
                cfg.latent_cache, self.data_stage,
                image_shape=tuple(cfg.image_shape),
            )
        root = Path(cfg.root) / self.data_stage
        self.chunks: List[Path] = sorted(
            p for p in root.iterdir() if p.suffix == ".torch"
        )
        if cfg.overfit_to_scene is not None:
            with open(root / "index.json") as f:
                index = json.load(f)
            self.chunks = [root / index[name] for name in cfg.overfit_to_scene]

    @property
    def data_stage(self) -> Stage:
        if self.cfg.overfit_to_scene is not None:
            return "test"
        if self.stage == "val":
            return "test"
        return self.stage

    def _get_bound(self, value: float, n: int, scale: float) -> np.ndarray:
        return np.full((n,), value / scale, dtype=np.float32)

    def __iter__(self) -> Iterator[Example]:
        chunks = list(self.chunks)
        if self.stage in ("train", "val") or self.force_shuffle:
            chunks = [chunks[i] for i in self.rng.permutation(len(chunks))]
        if self.stage == "test" and self.num_workers > 1:
            chunks = [
                c for i, c in enumerate(chunks) if i % self.num_workers == self.worker_index
            ]

        for chunk_path in chunks:
            chunk = load_chunk(chunk_path)
            if self.cfg.overfit_to_scene is not None:
                chunk = [x for x in chunk if x["key"] in self.cfg.overfit_to_scene]
            if self.stage in ("train", "val", "test"):
                chunk = [chunk[i] for i in self.rng.permutation(len(chunk))]

            for example in chunk:
                extrinsics, intrinsics = convert_poses(example["cameras"])
                scene = example["key"]
                num_views = extrinsics.shape[0]

                if (_fov_degrees(intrinsics) > self.cfg.max_fov).any():
                    continue

                try:
                    view_indices = self.view_sampler.sample(scene, num_views)
                except ValueError:
                    continue  # not enough frames

                for view_index in view_indices:
                    result = self._build_example(
                        scene, example, extrinsics, intrinsics, view_index,
                        chunk_stem=chunk_path.stem,
                    )
                    if result is not None:
                        yield result

    def _build_example(
        self,
        scene: str,
        example: dict,
        extrinsics: np.ndarray,
        intrinsics: np.ndarray,
        view_index: ViewIndex,
        chunk_stem: str = "",
    ) -> Optional[Example]:
        extrinsics = extrinsics.copy()

        # Resize the world so the context baseline is 1
        # (reference dataset_re10k.py:126-137).
        context_extrinsics = extrinsics[view_index.context]
        if context_extrinsics.shape[0] == 2 and self.cfg.make_baseline_1:
            a, b = context_extrinsics[:, :3, 3]
            scale = float(np.linalg.norm(a - b))
            if scale < self.cfg.baseline_epsilon:
                print(f"Skipped {scene} because of insufficient baseline {scale:.6f}")
                return None
            extrinsics[:, :3, 3] /= scale
        else:
            scale = 1.0

        if self._latents is not None:
            return self._build_latent_example(
                scene, extrinsics, intrinsics, view_index, chunk_stem, scale
            )

        views = {}
        for role, indices in (("context", view_index.context),
                              ("target", view_index.target)):
            if indices is None:
                continue
            images = np.stack(
                [decode_jpeg_bytes(example["images"][int(i)]) for i in indices]
            )
            if images.shape[1:] != (360, 640, 3):
                print(
                    f"Skipped bad example {scene}. "
                    f"{role.capitalize()} shape was {images.shape}."
                )
                return None
            views[role] = Views(
                image=images,
                extrinsics=extrinsics[indices],
                intrinsics=intrinsics[indices],
                near=self._get_bound(self.near, len(indices), scale),
                far=self._get_bound(self.far, len(indices), scale),
                index=np.asarray(indices, dtype=np.int64),
            )

        ex = Example(scene=scene, context=views["context"],
                     target=views.get("target"))
        if self.stage == "train" and self.cfg.augment:
            ex = apply_augmentation_shim(ex, self.rng)
        if self.stage in ("train", "val") and self.cfg.random_transform_extrinsics:
            ex = apply_random_transform_shim(ex, rng=self.rng)
        return apply_crop_shim(ex, tuple(self.cfg.image_shape))

    # The reference's RE10K chunks always hold 360x640 frames (shape guard
    # above / reference dataset_re10k.py:149); precompute_latents enforces
    # the same guard, so the latent path can fix up intrinsics without pixels.
    SOURCE_SHAPE = (360, 640)

    def _build_latent_example(
        self,
        scene: str,
        extrinsics: np.ndarray,
        intrinsics: np.ndarray,
        view_index: ViewIndex,
        chunk_stem: str,
        scale: float,
    ) -> Optional[Example]:
        """Latent-cache twin of the image path: serves precomputed VAE
        posterior moments and applies only the pose-side shims — the flip
        augmentation picks the flipped-pixels latent variant (an encoder is
        not flip-equivariant) plus the same extrinsics reflection, and the
        crop shim reduces to its intrinsics fix-up."""
        flip = False
        if self.stage == "train" and self.cfg.augment:
            # Same draw semantics as apply_augmentation_shim: keep when
            # rng.random() < 0.5, reflect otherwise.
            flip = not (self.rng.random() < 0.5)
        if flip:
            extrinsics = reflect_extrinsics(extrinsics)

        views = {}
        for role, indices in (("context", view_index.context),
                              ("target", view_index.target)):
            if indices is None:
                continue
            moments = self._latents.lookup(chunk_stem, scene, indices, flip)
            if moments is None:
                print(f"Skipped {scene}: not in the latent cache.")
                return None
            views[role] = Views(
                image=None,
                latent_moments=moments,
                extrinsics=extrinsics[indices],
                intrinsics=crop_shim_intrinsics(
                    intrinsics[indices], self.SOURCE_SHAPE,
                    tuple(self.cfg.image_shape),
                ),
                near=self._get_bound(self.near, len(indices), scale),
                far=self._get_bound(self.far, len(indices), scale),
                index=np.asarray(indices, dtype=np.int64),
            )

        ex = Example(scene=scene, context=views["context"],
                     target=views.get("target"))
        if self.cfg.random_transform_extrinsics:
            ex = apply_random_transform_shim(ex, rng=self.rng)
        return ex

    def __len__(self) -> int:
        if isinstance(self.view_sampler, ViewSamplerEvaluation):
            return self.view_sampler.total_samples
        return len(self.chunks)
