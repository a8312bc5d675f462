"""Camera-frustum wireframe rendering (counterpart of
``mvldm_tpu/visualization/cameras.py``).

Re-creates the output of the reference's camera visualization
(``src/visualization/drawing/cameras.py:14-195`` +
``validation_in_3d.py:21-44`` used by ``validation_step``): orthographic
wireframe views of the batch's camera frusta. The reference renders lines
with a differentiable torch rasterizer; visualization does not need
gradients, so this uses a numpy line rasterizer with distance-based
anti-aliasing — same images, none of the autograd machinery.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

# A small categorical palette (reference visualization/colors.py).
DISTINCT_COLORS = np.asarray(
    [
        (0.9, 0.2, 0.2),
        (0.2, 0.6, 0.9),
        (0.2, 0.8, 0.3),
        (0.9, 0.7, 0.1),
        (0.7, 0.3, 0.8),
        (0.9, 0.5, 0.2),
        (0.3, 0.8, 0.8),
        (0.8, 0.3, 0.5),
    ],
    dtype=np.float32,
)


def frustum_segments(
    extrinsics: np.ndarray,
    intrinsics: np.ndarray,
    frustum_scale: float = 0.15,
) -> np.ndarray:
    """One camera -> (16, 2, 3) world-space line segments (4 image-plane
    edges, 4 rays to the center, 4 up-triangle edges omitted for parity with
    the minimal frustum of the reference)."""
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    # Normalized image corners -> camera rays at depth = frustum_scale.
    corners_px = np.asarray(
        [[0, 0], [1, 0], [1, 1], [0, 1]], dtype=np.float32
    )
    xs = (corners_px[:, 0] - cx) / fx
    ys = (corners_px[:, 1] - cy) / fy
    corners_cam = np.stack(
        [xs, ys, np.ones(4, dtype=np.float32)], axis=-1
    ) * frustum_scale
    corners_h = np.concatenate([corners_cam, np.ones((4, 1))], axis=-1)
    corners_world = (extrinsics @ corners_h.T).T[:, :3]
    center = extrinsics[:3, 3]

    segs = []
    for i in range(4):
        segs.append([corners_world[i], corners_world[(i + 1) % 4]])
        segs.append([center, corners_world[i]])
    return np.asarray(segs, dtype=np.float32)


def _rasterize_lines(
    segments_2d: np.ndarray,
    colors: np.ndarray,
    resolution: int,
    width: float = 1.2,
) -> np.ndarray:
    """(n, 2, 2) pixel-space segments -> (res, res, 3) white-background image
    with anti-aliased lines."""
    img = np.ones((resolution, resolution, 3), dtype=np.float32)
    yy, xx = np.meshgrid(
        np.arange(resolution, dtype=np.float32),
        np.arange(resolution, dtype=np.float32),
        indexing="ij",
    )
    for seg, color in zip(segments_2d, colors):
        (x0, y0), (x1, y1) = seg
        lo_x, hi_x = sorted((x0, x1))
        lo_y, hi_y = sorted((y0, y1))
        pad = width + 2
        x_min = max(int(lo_x - pad), 0)
        x_max = min(int(hi_x + pad) + 1, resolution)
        y_min = max(int(lo_y - pad), 0)
        y_max = min(int(hi_y + pad) + 1, resolution)
        if x_min >= x_max or y_min >= y_max:
            continue
        px = xx[y_min:y_max, x_min:x_max]
        py = yy[y_min:y_max, x_min:x_max]
        dx, dy = x1 - x0, y1 - y0
        norm2 = dx * dx + dy * dy + 1e-12
        t = np.clip(((px - x0) * dx + (py - y0) * dy) / norm2, 0.0, 1.0)
        dist = np.sqrt((px - (x0 + t * dx)) ** 2 + (py - (y0 + t * dy)) ** 2)
        alpha = np.clip(1.0 - (dist - width / 2), 0.0, 1.0)[..., None]
        region = img[y_min:y_max, x_min:x_max]
        img[y_min:y_max, x_min:x_max] = (
            region * (1 - alpha) + np.asarray(color) * alpha
        )
    return img


def draw_cameras(
    resolution: int,
    extrinsics: np.ndarray,
    intrinsics: np.ndarray,
    colors: np.ndarray | None = None,
    frustum_scale: float | None = None,
    margin: float = 0.1,
) -> List[np.ndarray]:
    """Render the camera set from the three axis-aligned orthographic views
    (the reference's ``render_cameras`` output shape: a list of images)."""
    n = extrinsics.shape[0]
    if colors is None:
        colors = DISTINCT_COLORS[np.arange(n) % len(DISTINCT_COLORS)]

    centers = extrinsics[:, :3, 3]
    extent = float(np.max(np.ptp(centers, axis=0))) if n > 1 else 1.0
    extent = max(extent, 1e-2)
    if frustum_scale is None:
        frustum_scale = 0.25 * extent

    all_segs = []
    seg_colors = []
    for i in range(n):
        segs = frustum_segments(extrinsics[i], intrinsics[i], frustum_scale)
        all_segs.append(segs)
        seg_colors.append(np.repeat(colors[i][None], len(segs), axis=0))
    segs = np.concatenate(all_segs)  # (m, 2, 3)
    seg_colors = np.concatenate(seg_colors)

    lo = segs.reshape(-1, 3).min(axis=0)
    hi = segs.reshape(-1, 3).max(axis=0)
    span = np.maximum(hi - lo, 1e-6)
    center = (hi + lo) / 2
    half = float(span.max()) * (0.5 + margin)

    images = []
    for axes in ((0, 1), (0, 2), (2, 1)):  # xy, xz, zy projections
        pts = (segs[..., axes] - center[list(axes)]) / (2 * half) + 0.5
        pix = pts * (resolution - 1)
        images.append(_rasterize_lines(pix, seg_colors, resolution))
    return images
