"""Pose utilities (counterpart of ``mvldm_tpu/geometry/camera_utils.py``)."""

from __future__ import annotations

import torch


def absolute_to_relative_camera(tform: torch.Tensor, index: int) -> torch.Tensor:
    """Express all c2w poses (..., v, 4, 4) relative to the pose at view
    ``index``: inv(tform[..., index]) @ tform."""
    return torch.linalg.inv(tform[..., [index], :, :]) @ tform
