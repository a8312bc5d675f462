"""Pose utilities (counterpart of ``mvldm_tpu/geometry/camera_utils.py``)."""

from __future__ import annotations

from typing import Union

import torch

from ..utils.profiling import sync


def absolute_to_relative_camera(tform: torch.Tensor,
                                index: Union[int, torch.Tensor]) -> torch.Tensor:
    """Express c2w poses relative to a reference view: inv(ref) @ tform.

    ``index`` is an ``int`` (the same view for every leading index of a
    (..., v, 4, 4) ``tform``) or a (b,) integer tensor naming one view per
    example of a (b, v, 4, 4) ``tform``, the JAX loss's ``vmap`` over
    ``rel_index`` written out. An ``int`` index selects by a list, which is
    uploaded: a pageable copy (``sync.pose_index``)."""
    if isinstance(index, int):
        with sync("pose_index"):
            ref = tform[..., [index], :, :]
        return torch.linalg.inv(ref) @ tform
    ref = tform[torch.arange(tform.shape[0], device=tform.device), index.to(tform.device)]
    return torch.linalg.inv(ref)[:, None] @ tform
