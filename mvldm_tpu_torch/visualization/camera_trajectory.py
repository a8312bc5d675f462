"""Camera trajectory generation (counterpart of
``mvldm_tpu/visualization/camera_trajectory.py``; reference
``src/visualization/camera_trajectory/``): pose interpolation (slerp +
lerp), wobble, and spin paths for novel-view rendering."""

from __future__ import annotations

import numpy as np

from ..utils.rotation_utils import matrix_to_quaternion, quaternion_to_matrix


def _slerp(q0: np.ndarray, q1: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Spherical interpolation of unit quaternions; t in [0, 1], (n,)."""
    dot = float(np.dot(q0, q1))
    if dot < 0:
        q1 = -q1
        dot = -dot
    dot = min(dot, 1.0)
    theta = np.arccos(dot)
    if theta < 1e-6:
        out = q0[None] + t[:, None] * (q1 - q0)[None]
        return out / np.linalg.norm(out, axis=-1, keepdims=True)
    s = np.sin(theta)
    return (
        np.sin((1 - t))[:, None] * 0.0
        + (np.sin((1 - t) * theta) / s)[:, None] * q0[None]
        + (np.sin(t * theta) / s)[:, None] * q1[None]
    )


def interpolate_pose(
    initial: np.ndarray, final: np.ndarray, t: np.ndarray
) -> np.ndarray:
    """Interpolate between two c2w poses (reference
    ``camera_trajectory/interpolation.py``); returns (n, 4, 4)."""
    t = np.asarray(t, dtype=np.float64)
    q0 = matrix_to_quaternion(initial[:3, :3].astype(np.float64))
    q1 = matrix_to_quaternion(final[:3, :3].astype(np.float64))
    rot = quaternion_to_matrix(_slerp(q0, q1, t))
    trans = (1 - t)[:, None] * initial[:3, 3] + t[:, None] * final[:3, 3]
    out = np.broadcast_to(np.eye(4), (len(t), 4, 4)).copy()
    out[:, :3, :3] = rot
    out[:, :3, 3] = trans
    return out.astype(np.float32)


def generate_wobble(
    extrinsics: np.ndarray, radius: float, num_frames: int = 60
) -> np.ndarray:
    """Circular in-plane wobble around a base pose (reference
    ``camera_trajectory/wobble.py``); returns (num_frames, 4, 4)."""
    t = np.linspace(0, 1, num_frames, endpoint=False)
    tf = np.broadcast_to(np.eye(4), (num_frames, 4, 4)).copy()
    tf[:, 0, 3] = np.sin(2 * np.pi * t) * radius
    tf[:, 1, 3] = -np.cos(2 * np.pi * t) * radius + radius
    return (extrinsics[None] @ tf).astype(np.float32)


def generate_spin(
    num_frames: int,
    elevation_deg: float,
    radius: float,
) -> np.ndarray:
    """Orbit around the origin at a fixed elevation (reference
    ``camera_trajectory/spin.py``); returns c2w (num_frames, 4, 4), cameras
    looking at the origin, +y down (OpenCV convention)."""
    azimuth = np.linspace(0, 2 * np.pi, num_frames, endpoint=False)
    elevation = np.deg2rad(elevation_deg)
    eyes = np.stack(
        [
            radius * np.cos(elevation) * np.sin(azimuth),
            -radius * np.sin(elevation) * np.ones_like(azimuth),
            -radius * np.cos(elevation) * np.cos(azimuth),
        ],
        axis=-1,
    )
    poses = []
    for eye in eyes:
        forward = -eye / np.linalg.norm(eye)  # look at origin
        right = np.cross(np.asarray([0.0, 1.0, 0.0]), forward)
        right = right / np.linalg.norm(right)
        down = np.cross(forward, right)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 0] = right
        pose[:3, 1] = down
        pose[:3, 2] = forward
        pose[:3, 3] = eye
        poses.append(pose)
    return np.stack(poses)
