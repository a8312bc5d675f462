"""Validation-time 3D camera rendering (counterpart of
``mvldm_tpu/visualization/validation_in_3d.py``; reference
``src/visualization/validation_in_3d.py:21-44``): frustum wireframes of the
batch's context + target cameras, one image per orthographic view."""

from __future__ import annotations

from typing import List

import numpy as np

from .cameras import DISTINCT_COLORS, draw_cameras


def render_cameras(batch: dict, resolution: int) -> List[np.ndarray]:
    """batch: the collated dict ({context,target}{extrinsics,intrinsics}).
    Context cameras draw in the first palette color, targets in the second."""
    ctx_e = np.asarray(batch["context"]["extrinsics"][0])
    ctx_i = np.asarray(batch["context"]["intrinsics"][0])
    extr = ctx_e
    intr = ctx_i
    colors = np.repeat(DISTINCT_COLORS[0][None], len(ctx_e), axis=0)
    if "target" in batch:
        tgt_e = np.asarray(batch["target"]["extrinsics"][0])
        tgt_i = np.asarray(batch["target"]["intrinsics"][0])
        extr = np.concatenate([ctx_e, tgt_e])
        intr = np.concatenate([ctx_i, tgt_i])
        colors = np.concatenate(
            [colors, np.repeat(DISTINCT_COLORS[1][None], len(tgt_e), axis=0)]
        )
    return draw_cameras(resolution, extr, intr, colors)
