"""Differentiable line and point rendering in torch (counterpart of
``mvldm_tpu/visualization/drawing.py``; reference
``src/visualization/drawing/{lines,points,rendering}.py``): anti-aliased
lines and points composited by their distance falloff, differentiable with
respect to endpoints and colors.

Coordinates are normalized (0..1, x right, y down) like the reference's
"relative" coordinate system (``drawing/coordinate_conversion.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..geometry.projection import project


def _pixel_grid(shape: Tuple[int, int], like: torch.Tensor) -> torch.Tensor:
    h, w = shape
    ys = (torch.arange(h, dtype=like.dtype, device=like.device) + 0.5) / h
    xs = (torch.arange(w, dtype=like.dtype, device=like.device) + 0.5) / w
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)  # (h, w, 2), xy order


def render_lines(
    image: torch.Tensor,
    start: torch.Tensor,
    end: torch.Tensor,
    color: torch.Tensor,
    width: float = 0.004,
) -> torch.Tensor:
    """Composite anti-aliased line segments onto (h, w, 3).

    start/end: (n, 2) normalized xy; color: (n, 3) or (3,); width in
    normalized units."""
    h, w, _ = image.shape
    grid = _pixel_grid((h, w), image)
    color = torch.as_tensor(color, dtype=image.dtype, device=image.device)
    color = color.expand(start.shape[0], 3)

    d = end - start  # (n, 2)
    norm2 = (d * d).sum(dim=-1) + 1e-12
    rel = grid[:, :, None, :] - start[None, None]  # (h, w, n, 2)
    t = torch.clamp((rel * d[None, None]).sum(dim=-1) / norm2, 0.0, 1.0)
    closest = start[None, None] + t[..., None] * d[None, None]
    dist = torch.linalg.vector_norm(grid[:, :, None, :] - closest, dim=-1)

    feather = 1.0 / max(h, w)
    alpha = torch.clamp((width / 2 + feather - dist) / feather, 0.0, 1.0)

    out = image
    # Iterative over-composite keeps the draw order, as the reference does.
    for i in range(start.shape[0]):
        a = alpha[..., i:i + 1]
        out = out * (1 - a) + color[i] * a
    return out


def render_points(
    image: torch.Tensor,
    points: torch.Tensor,
    color: torch.Tensor,
    radius: float = 0.006,
) -> torch.Tensor:
    """Composite anti-aliased discs onto (h, w, 3). points: (n, 2)."""
    h, w, _ = image.shape
    grid = _pixel_grid((h, w), image)
    color = torch.as_tensor(color, dtype=image.dtype, device=image.device)
    color = color.expand(points.shape[0], 3)
    dist = torch.linalg.vector_norm(grid[:, :, None, :] - points[None, None], dim=-1)
    feather = 1.0 / max(h, w)
    alpha = torch.clamp((radius + feather - dist) / feather, 0.0, 1.0)
    out = image
    for i in range(points.shape[0]):
        a = alpha[..., i:i + 1]
        out = out * (1 - a) + color[i] * a
    return out


def project_points(
    points_world: torch.Tensor, extrinsics: torch.Tensor, intrinsics: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """World points -> normalized image xy and whether each lies in front of
    the camera."""
    return project(points_world, extrinsics, intrinsics)
