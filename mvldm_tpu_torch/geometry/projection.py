"""Camera projection math (counterpart of
``mvldm_tpu/geometry/projection.py``, the parts the sampling path uses):
pixel-grid sampling and world rays from normalized OpenCV-style intrinsics
and camera-to-world extrinsics. Shape-polymorphic over leading dims."""

from __future__ import annotations

from typing import Tuple

import torch


def homogenize_points(points: torch.Tensor) -> torch.Tensor:
    """(..., xyz) -> (..., xyz1)."""
    return torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)


def homogenize_vectors(vectors: torch.Tensor) -> torch.Tensor:
    """(..., xyz) -> (..., xyz0)."""
    return torch.cat([vectors, torch.zeros_like(vectors[..., :1])], dim=-1)


def transform_rigid(coords: torch.Tensor, transformation: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", transformation, coords)


def unproject(coordinates: torch.Tensor, z: torch.Tensor,
              intrinsics: torch.Tensor) -> torch.Tensor:
    """Normalized 2D camera coordinates at depth ``z`` -> camera space."""
    coordinates = homogenize_points(coordinates)
    directions = torch.einsum("...ij,...j->...i", torch.linalg.inv(intrinsics),
                              coordinates)
    return directions * z[..., None]


def get_world_rays(coordinates: torch.Tensor, extrinsics: torch.Tensor,
                   intrinsics: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalized pixel coordinates -> (ray origins, unit ray directions) in
    world space."""
    directions = unproject(coordinates, torch.ones_like(coordinates[..., 0]),
                           intrinsics)
    directions = directions / torch.linalg.norm(directions, dim=-1, keepdim=True)
    directions = transform_rigid(homogenize_vectors(directions), extrinsics)[..., :-1]
    origins = extrinsics[..., :-1, -1].expand(directions.shape)
    return origins, directions


def sample_image_grid(shape: Tuple[int, ...], dtype: torch.dtype = torch.float32,
                      device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixel-center normalized (x, y) coordinates in (0, 1) and integer
    (row, col) indices for an image grid."""
    indices = [torch.arange(n, device=device) for n in shape]
    stacked = torch.stack(torch.meshgrid(*indices, indexing="ij"), dim=-1)
    coords = [((idx + 0.5) / n).to(dtype) for idx, n in zip(indices, shape)]
    coords = torch.stack(torch.meshgrid(*reversed(coords), indexing="xy"), dim=-1)
    return coords, stacked
