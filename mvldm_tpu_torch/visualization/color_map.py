"""Scalar -> color mapping and the validation histogram (counterpart of
``mvldm_tpu/visualization/color_map.py``; reference
``src/visualization/color_map.py`` and ``src/misc/image_io.py``).

:func:`get_hist_image` draws with numpy and Pillow: matplotlib, with which
the JAX package draws it, is not installed where the port runs on the card.
It keeps the JAX figure's bins (``numpy.histogram``, as ``Axes.hist``
computes them), size and title. :func:`apply_color_map` reads matplotlib's
colormaps, as the JAX package does, and is not on the training or
validation path.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

HIST_COLOR = (31, 119, 180)  # matplotlib's first default color, #1f77b4
# The plot area inside a size x size figure: left, top, right, bottom margins.
HIST_MARGINS = (44, 30, 12, 30)


def apply_color_map(values: np.ndarray, cmap: str = "inferno") -> np.ndarray:
    """(…,) scalars in [0, 1] -> (…, 3) RGB."""
    import matplotlib

    cm = matplotlib.colormaps[cmap]
    return np.asarray(cm(np.clip(values, 0.0, 1.0)))[..., :3].astype(np.float32)


def apply_depth_color_map(depth: np.ndarray, cmap: str = "turbo") -> np.ndarray:
    """Normalize a depth map then color it (reference color_map usage)."""
    lo, hi = float(depth.min()), float(depth.max())
    norm = (depth - lo) / max(hi - lo, 1e-8)
    return apply_color_map(norm, cmap)


def hist_counts(values: np.ndarray, bins: int = 100) -> Tuple[np.ndarray, np.ndarray]:
    """(counts, edges) of the flattened values over their range: what
    ``Axes.hist(values, bins=bins)`` counts."""
    return np.histogram(np.asarray(values).reshape(-1), bins=bins)


def get_hist_image(
    values: np.ndarray, bins: int = 100, title: str = "", size: int = 400
) -> np.ndarray:
    """Histogram of tensor values rendered to a (size, size, 3) float image
    in [0, 1] (reference ``image_io.py:get_hist_image``; used by the
    validation histograms): one bar a bin, scaled to the largest count with
    matplotlib's 5 % headroom, in a framed plot area with the value range
    and the largest count as labels and the title centred above."""
    from PIL import Image, ImageDraw

    counts, edges = hist_counts(values, bins)
    img = Image.new("RGB", (size, size), (255, 255, 255))
    draw = ImageDraw.Draw(img)
    m_left, m_top, m_right, m_bottom = HIST_MARGINS
    left, top, right, bottom = m_left, m_top, size - m_right, size - m_bottom
    peak = max(int(counts.max()), 1) * 1.05
    width = (right - left) / bins
    for i, c in enumerate(counts):
        if c:
            height = round((bottom - top) * c / peak)
            x0 = left + round(i * width)
            x1 = max(left + round((i + 1) * width) - 1, x0)
            draw.rectangle([x0, bottom - height, x1, bottom], fill=HIST_COLOR)
    draw.rectangle([left, top, right, bottom], outline=(0, 0, 0))
    draw.text((left, bottom + 6), f"{edges[0]:.3g}", fill=(0, 0, 0))
    hi = f"{edges[-1]:.3g}"
    draw.text((right - draw.textlength(hi), bottom + 6), hi, fill=(0, 0, 0))
    draw.text((4, top), str(int(counts.max())), fill=(0, 0, 0))
    draw.text(((size - draw.textlength(title)) / 2, 8), title, fill=(0, 0, 0))
    return np.asarray(img, dtype=np.float32) / 255.0
