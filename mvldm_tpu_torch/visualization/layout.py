"""Image layout helpers (counterpart of ``mvldm_tpu/visualization/layout.py``;
reference ``src/visualization/layout.py``): hcat / vcat / add_border over
float HWC numpy images."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def _pad_to(image: np.ndarray, h: int, w: int, value: float = 1.0) -> np.ndarray:
    ih, iw = image.shape[:2]
    out = np.full((h, w, image.shape[2]), value, dtype=image.dtype)
    top = (h - ih) // 2
    left = (w - iw) // 2
    out[top : top + ih, left : left + iw] = image
    return out


def hcat(*images: np.ndarray, gap: int = 8, gap_color: float = 1.0) -> np.ndarray:
    """Concatenate horizontally, centering shorter images."""
    images = [np.asarray(im) for im in images]
    h = max(im.shape[0] for im in images)
    padded = [_pad_to(im, h, im.shape[1], gap_color) for im in images]
    spacer = np.full((h, gap, images[0].shape[2]), gap_color, dtype=images[0].dtype)
    parts = []
    for i, im in enumerate(padded):
        if i:
            parts.append(spacer)
        parts.append(im)
    return np.concatenate(parts, axis=1)


def vcat(*images: np.ndarray, gap: int = 8, gap_color: float = 1.0) -> np.ndarray:
    """Concatenate vertically, centering narrower images."""
    images = [np.asarray(im) for im in images]
    w = max(im.shape[1] for im in images)
    padded = [_pad_to(im, im.shape[0], w, gap_color) for im in images]
    spacer = np.full((gap, w, images[0].shape[2]), gap_color, dtype=images[0].dtype)
    parts = []
    for i, im in enumerate(padded):
        if i:
            parts.append(spacer)
        parts.append(im)
    return np.concatenate(parts, axis=0)


def add_border(
    image: np.ndarray, border: int = 8, color: float = 1.0
) -> np.ndarray:
    h, w, c = image.shape
    out = np.full((h + 2 * border, w + 2 * border, c), color, dtype=image.dtype)
    out[border : border + h, border : border + w] = image
    return out
