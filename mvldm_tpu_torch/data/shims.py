"""Data shims: crop/rescale, reflection augmentation, random SE(3) transform
(counterpart of ``mvldm_tpu/data/shims.py``, draw for draw).

Numpy/PIL ports of reference ``src/dataset/shims/`` with identical intrinsics
bookkeeping. The crop shim's PIL LANCZOS resampling is kept bit-compatible
with the reference (same uint8 round-trip, same resize call) because PSNR
comparisons drift otherwise (SURVEY.md §7 hard part 6).
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional, Tuple

import numpy as np

from .types import Example, Views


def rescale(image: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """(h, w, 3) float in [0,1] -> LANCZOS-resized float (reference
    ``crop_shim.py:11-28``, including the uint8 round-trip)."""
    from PIL import Image

    h, w = shape
    image_u8 = np.clip(image * 255.0, 0, 255).astype(np.uint8)
    resized = Image.fromarray(image_u8).resize((w, h), Image.LANCZOS)
    return np.asarray(resized, dtype=np.float32) / 255.0


def center_crop(
    images: np.ndarray, intrinsics: np.ndarray, shape: Tuple[int, int]
) -> tuple[np.ndarray, np.ndarray]:
    """(v, h, w, 3) + (v, 3, 3) -> cropped + intrinsics fix-up (reference
    ``crop_shim.py:31-55``)."""
    *_, h_in, w_in, _ = images.shape
    h_out, w_out = shape
    row = (h_in - h_out) // 2
    col = (w_in - w_out) // 2
    images = images[..., row : row + h_out, col : col + w_out, :]
    intrinsics = intrinsics.copy()
    intrinsics[..., 0, 0] *= w_in / w_out  # fx
    intrinsics[..., 1, 1] *= h_in / h_out  # fy
    return images, intrinsics


def rescale_and_crop(
    images: np.ndarray, intrinsics: np.ndarray, shape: Tuple[int, int]
) -> tuple[np.ndarray, np.ndarray]:
    """Reference ``crop_shim.py:58-83``: scale to cover, then center crop."""
    *_, h_in, w_in, _ = images.shape
    h_out, w_out = shape
    assert h_out <= h_in and w_out <= w_in

    scale_factor = max(h_out / h_in, w_out / w_in)
    h_scaled = round(h_in * scale_factor)
    w_scaled = round(w_in * scale_factor)
    assert h_scaled == h_out or w_scaled == w_out

    scaled = np.stack([rescale(im, (h_scaled, w_scaled)) for im in images])
    return center_crop(scaled, intrinsics, shape)


def crop_shim_intrinsics(
    intrinsics: np.ndarray, in_shape: Tuple[int, int], out_shape: Tuple[int, int]
) -> np.ndarray:
    """The intrinsics side of :func:`rescale_and_crop` alone — a pure
    function of the input/output shapes (scale-to-cover then center-crop),
    used by the latent-cache path where no pixels exist to resize."""
    h_in, w_in = in_shape
    h_out, w_out = out_shape
    assert h_out <= h_in and w_out <= w_in
    scale_factor = max(h_out / h_in, w_out / w_in)
    h_scaled = round(h_in * scale_factor)
    w_scaled = round(w_in * scale_factor)
    assert h_scaled == h_out or w_scaled == w_out
    intrinsics = intrinsics.copy()
    intrinsics[..., 0, 0] *= w_scaled / w_out
    intrinsics[..., 1, 1] *= h_scaled / h_out
    return intrinsics


def apply_crop_shim_to_views(views: Views, shape: Tuple[int, int]) -> Views:
    images, intrinsics = rescale_and_crop(views.image, views.intrinsics, shape)
    return replace(views, image=images, intrinsics=intrinsics)


def apply_crop_shim(example: Example, shape: Tuple[int, int]) -> Example:
    """Reference ``crop_shim.py:86-92``."""
    return Example(
        scene=example.scene,
        context=apply_crop_shim_to_views(example.context, shape),
        target=(
            apply_crop_shim_to_views(example.target, shape)
            if example.target is not None
            else None
        ),
    )


def reflect_extrinsics(extrinsics: np.ndarray) -> np.ndarray:
    """Reference ``augmentation_shim.py:8-14``: conjugate by diag(-1,1,1,1)."""
    reflect = np.eye(4, dtype=np.float32)
    reflect[0, 0] = -1
    return reflect @ extrinsics @ reflect


def _reflect_views(views: Views) -> Views:
    return replace(
        views,
        image=views.image[..., :, ::-1, :].copy(),
        extrinsics=reflect_extrinsics(views.extrinsics),
    )


def apply_augmentation_shim(
    example: Example, rng: Optional[np.random.Generator] = None
) -> Example:
    """50% x-reflection of images + extrinsics (reference
    ``augmentation_shim.py:24-36``)."""
    rng = rng or np.random.default_rng()
    if rng.random() < 0.5:
        return example
    return Example(
        scene=example.scene,
        context=_reflect_views(example.context),
        target=(
            _reflect_views(example.target) if example.target is not None else None
        ),
    )


def _sample_isotropic_rotation(
    eps: float, rng: np.random.Generator
) -> np.ndarray:
    """Sample from an isotropic Gaussian on SO(3) with concentration ``eps``
    (reference ``IsotropicGaussianSO3``, ``rotation_utils.py``; series-
    expansion density with inverse-CDF angle sampling)."""
    from ..utils.rotation_utils import IsotropicGaussianSO3

    return IsotropicGaussianSO3(eps).sample(rng, 1)[0].astype(np.float32)


def apply_random_transform_shim(
    example: Example,
    eps: float = 1.0,
    translation_scale: float = 1.0,
    rng: Optional[np.random.Generator] = None,
) -> Example:
    """Random global SE(3) applied to all extrinsics (reference
    ``random_transform_shim.py:8-69``; off in the live baseline)."""
    rng = rng or np.random.default_rng()
    tform = np.eye(4, dtype=np.float32)
    tform[:3, :3] = _sample_isotropic_rotation(eps, rng)
    tform[:3, 3] = rng.normal(scale=translation_scale, size=3)

    def tfm(views: Views) -> Views:
        return replace(
            views, extrinsics=(tform @ views.extrinsics).astype(np.float32)
        )

    return Example(
        scene=example.scene,
        context=tfm(example.context),
        target=tfm(example.target) if example.target is not None else None,
    )
